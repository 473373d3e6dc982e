"""Byte codec of the staging leg (the reference's snappy compression).

Counterpart of ``parameter_server_tpu/utils/codec.py``: self-describing
frames of one header byte, ``0x00`` raw, ``0x01`` the native LZ block
(``ps_lz_*`` in ``native/psnative.cc``), ``0x02`` zlib. The port always
compresses with the native LZ codec (its library always builds; a build
that fails raises), so its frames are the JAX package's frames wherever
that package loads its own native library. An incompressible payload
rides raw. :func:`decompress` also reads the JAX package's zlib frames.
"""

from __future__ import annotations

import ctypes
import zlib

import numpy as np

from .. import native

_RAW = 0x00
_LZ = 0x01
_ZLIB = 0x02
_U8P = ctypes.POINTER(ctypes.c_uint8)


def compress(data: bytes) -> bytes:
    """``data`` in one frame: LZ, or raw where LZ does not shrink it."""
    n = len(data)
    if n == 0:
        return bytes([_RAW])
    lib = native.library()
    src = np.frombuffer(data, np.uint8)
    cap = int(lib.ps_lz_max_compressed(n))
    dst = np.empty(cap, np.uint8)
    got = lib.ps_lz_compress(src.ctypes.data_as(_U8P), n, dst.ctypes.data_as(_U8P), cap)
    if 0 <= got < n:
        return bytes([_LZ]) + dst[:got].tobytes()
    return bytes([_RAW]) + data


def decompress(frame: bytes, max_size: int = 1 << 31, expected_size: int = None) -> bytes:
    """Decode a frame of :func:`compress` (or of the JAX package's).
    Raises ``ValueError`` on a malformed frame or one that decodes past
    ``max_size``. ``expected_size``, when the caller knows the decoded
    size, sizes the output in one pass."""
    if len(frame) < 1:
        raise ValueError("empty codec frame")
    tag, body = frame[0], frame[1:]
    if tag == _RAW:
        return bytes(body)
    if tag == _ZLIB:
        try:
            d = zlib.decompressobj()
            out = d.decompress(body, max_size)
            if d.unconsumed_tail:
                raise ValueError("zlib frame output exceeds max_size")
            if not d.eof:
                raise ValueError("truncated zlib frame")
            if d.unused_data:
                raise ValueError("trailing garbage after zlib frame")
            return out
        except zlib.error as e:
            raise ValueError(f"bad zlib frame: {e}") from e
    if tag == _LZ:
        lib = native.library()
        src = np.frombuffer(body, np.uint8)
        cap = min(max(64, int(expected_size)), max_size) if expected_size is not None \
            else max(64, 4 * len(body))
        while True:
            dst = np.empty(cap, np.uint8)
            got = lib.ps_lz_decompress(src.ctypes.data_as(_U8P), len(body),
                                       dst.ctypes.data_as(_U8P), cap)
            if got >= 0:
                return dst[:got].tobytes()
            if got == -1:
                raise ValueError("malformed LZ frame")
            if cap >= max_size:  # -2: the output needs more room
                raise ValueError("LZ frame output exceeds max_size")
            cap = min(cap * 4, max_size)
    raise ValueError(f"unknown codec tag {tag}")
