"""PyTorch port: the staging leg's LZ frames against ``utils/codec.py``.

The port always compresses with the native LZ codec; where the JAX
package loads its own native library its frames are the same bytes, and
each package decodes the other's frames (zlib frames of a native-less
JAX host too). Malformed frames raise ``ValueError``.
"""

import zlib

import numpy as np
import pytest

from parameter_server_tpu.cpp import native as jnative
from parameter_server_tpu.utils import codec as jcodec
from parameter_server_tpu_torch.utils import codec as tcodec


def _payloads():
    rng = np.random.default_rng(0)
    return {
        "empty": b"",
        "one": b"x",
        "zeros": bytes(100_000),
        "words": np.repeat(rng.integers(0, 1 << 20, 4000), 7).astype(np.uint32).tobytes(),
        "noise": rng.integers(0, 256, 50_000).astype(np.uint8).tobytes(),
        "text": b"the reference parameter server " * 500,
    }


@pytest.mark.parametrize("name", sorted(_payloads()))
def test_frames_match_jax_and_round_trip(name):
    data = _payloads()[name]
    frame = tcodec.compress(data)
    if jnative() is not None:  # the JAX package built its native library
        assert frame == jcodec.compress(data)
    assert tcodec.decompress(frame) == data
    assert tcodec.decompress(frame, expected_size=len(data)) == data
    assert jcodec.decompress(frame) == data
    assert frame[0] in (0, 1) and len(frame) <= len(data) + 1
    if name in ("zeros", "words", "text"):
        assert frame[0] == 1 and len(frame) < len(data) // 2


def test_reads_zlib_frames_and_refuses_malformed():
    data = b"abc" * 1000
    assert tcodec.decompress(bytes([2]) + zlib.compress(data, 1)) == data
    with pytest.raises(ValueError, match="empty"):
        tcodec.decompress(b"")
    with pytest.raises(ValueError, match="unknown codec tag"):
        tcodec.decompress(bytes([9, 1, 2]))
    with pytest.raises(ValueError, match="truncated"):
        tcodec.decompress(bytes([2]) + zlib.compress(data, 1)[:-4])
    with pytest.raises(ValueError, match="max_size"):
        tcodec.decompress(tcodec.compress(bytes(100_000)), max_size=1000)
    with pytest.raises(ValueError, match="malformed"):
        tcodec.decompress(bytes([1, 0xF0, 0xFF, 0xFF, 0xFF]))
