"""PyTorch port: ``utils/bitpack.py`` against the JAX package's.

The host half (numpy, and the native ``ps_pack_bits`` /
``ps_hash_slots_packbits`` from 4096 values on) writes the JAX package's
bytes; the device half (torch, uint32 words held in int64) unpacks what
the JAX package unpacks, including values that straddle two words and
lengths that are no multiple of the bit period. Exact everywhere.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.utils import bitpack as jbp
from parameter_server_tpu_torch import native
from parameter_server_tpu_torch.utils import bitpack as tbp


@pytest.mark.parametrize("num_slots,sentinel", [(1, False), (2, False), (1 << 22, False),
                                                (1 << 22, True), (1000, True), (1 << 30, False)])
def test_sizes_match_jax(num_slots, sentinel):
    bits = tbp.slot_bits(num_slots, sentinel)
    assert bits == jbp.slot_bits(num_slots, sentinel)
    for n in (0, 1, 31, 4097):
        assert tbp.packed_nbytes(n, bits) == jbp.packed_nbytes(n, bits)
        assert tbp.packed_nwords(n, bits) == jbp.packed_nwords(n, bits)


@pytest.mark.parametrize("bits", [1, 5, 8, 17, 22, 26, 31])
@pytest.mark.parametrize("n", [3, 4095, 4096, 20_001])
def test_pack_matches_jax_and_the_plain_pack(bits, n):
    vals = np.random.default_rng(bits + n).integers(0, 1 << bits, n).astype(np.int32)
    got = tbp.pack_bits(vals, bits)
    assert got.tobytes() == jbp.pack_bits(vals, bits).tobytes() == tbp.pack_bits_np(vals, bits).tobytes()
    words = tbp.stream_to_words(got, n, bits)
    assert words.dtype == np.dtype("<u4") and words.size == tbp.packed_nwords(n, bits)
    assert words.tobytes() == jbp.stream_to_words(got, n, bits).tobytes()


@pytest.mark.parametrize("n", [100, 5000])
@pytest.mark.parametrize("num_slots", [1 << 22, 1000003])
def test_hash_slots_packed_matches_jax(n, num_slots):
    keys = np.random.default_rng(n).integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    bits = tbp.slot_bits(num_slots)
    want = jbp.hash_slots_packed(keys, num_slots, bits)
    assert tbp.hash_slots_packed(keys, num_slots, bits).tobytes() == want.tobytes()
    out = np.empty(tbp.packed_nbytes(n, bits), np.uint8)
    assert tbp.hash_slots_packed(keys, num_slots, bits, out=out) is out
    assert out.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="contiguous uint8"):
        tbp.hash_slots_packed(keys, num_slots, bits, out=np.empty(3, np.uint8))


@pytest.mark.parametrize("bits", [3, 7, 11, 22, 23, 30])
@pytest.mark.parametrize("n", [1, 32, 33, 1001])
def test_unpack_matches_jax_across_word_boundaries(bits, n):
    vals = np.random.default_rng(bits * n).integers(0, 1 << bits, n).astype(np.int32)
    words = tbp.stream_to_words(tbp.pack_bits(vals, bits), n, bits)
    straddle = [(i * bits) % 32 + bits > 32 for i in range(n)]
    for w in (torch.from_numpy(words.view(np.int32)), torch.from_numpy(words.copy())):
        got = tbp.unpack_bits(w, n, bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), vals)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jbp.unpack_bits(jnp.asarray(words), n, bits)))
    if bits in (11, 22, 23, 30) and n > 32:
        assert any(straddle)


def test_words_hold_uint32_in_int64():
    w = np.array([0xFFFFFFFF, 0x80000000, 1], "<u4")
    got = tbp.words_i64(torch.from_numpy(w.view(np.int32)))
    assert got.dtype == torch.int64 and got.tolist() == [0xFFFFFFFF, 0x80000000, 1]


def test_unpack_sign_bits_matches_jax():
    yb = np.random.default_rng(3).integers(0, 256, 40).astype(np.uint8)
    for n in (1, 8, 9, 320):
        np.testing.assert_array_equal(tbp.unpack_sign_bits(torch.from_numpy(yb), n).numpy(),
                                      np.asarray(jbp.unpack_sign_bits(jnp.asarray(yb), n)))


def test_native_bindings_are_declared():
    """The port declares the wire functions' C signatures itself."""
    lib = native.library()
    for name in ("ps_pack_bits", "ps_hash_slots_packbits", "ps_stream_encode",
                 "ps_lz_max_compressed", "ps_lz_compress", "ps_lz_decompress"):
        argtypes, restype = native.SIGNATURES[name]
        assert getattr(lib, name).argtypes == argtypes and getattr(lib, name).restype == restype
    v = np.arange(64, dtype=np.int32)
    out = np.zeros(tbp.packed_nbytes(64, 7), np.uint8)
    lib.ps_pack_bits(v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), 64, 7,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert out.tobytes() == tbp.pack_bits_np(v, 7).tobytes()
