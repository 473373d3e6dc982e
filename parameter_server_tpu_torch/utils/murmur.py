"""64-bit mixing hash of feature keys into table slots (numpy), and
MurmurHash3 x64-128 of byte strings.

Counterpart of ``parameter_server_tpu/utils/murmur.py``: the same
splitmix64-style finalizer, so a key lands in the same slot in both
packages, and the same MurmurHash3 the criteo parser keys categorical
tokens with. ``hash_slots`` takes one pass of the port's native library
(``ps_hash_slots``) for 4096 keys or more, the NumPy finalizer below
that: the same slots either way.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def murmur64_np(keys: np.ndarray, seed: np.uint64 = np.uint64(0)) -> np.ndarray:
    """Vectorized 64-bit finalizer hash over a uint64 array."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = keys + seed + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * _M1
        z = (z ^ (z >> np.uint64(27))) * _M2
        return z ^ (z >> np.uint64(31))


def hash_slots(keys: np.ndarray, num_slots: int, seed: int = 0) -> np.ndarray:
    """Hash keys into ``[0, num_slots)`` as int32."""
    keys = np.asarray(keys)
    if keys.dtype == np.int64 and keys.flags.c_contiguous:
        keys = keys.view(np.uint64)  # same bits, no copy
    else:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
    if keys.size >= 4096:
        out = np.empty(keys.size, np.int32)
        native.library().ps_hash_slots(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), keys.size,
            seed, num_slots, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out.reshape(keys.shape)
    h = murmur64_np(keys, np.uint64(seed))
    if num_slots & (num_slots - 1) == 0:
        return (h & np.uint64(num_slots - 1)).astype(np.int32)
    return (h % np.uint64(num_slots)).astype(np.int32)


_M64 = (1 << 64) - 1


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _M64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _M64
    k ^= k >> 33
    return k


def murmur3_x64_128(data: bytes, seed: int = 0) -> tuple:
    """MurmurHash3 x64 128-bit of ``data``: the reference's
    util/murmurhash3.cc (criteo categorical keys are ``h[0] ^ h[1]``
    with seed 512927377)."""
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = seed & _M64
    n = len(data)
    nblocks = n // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16 : i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8 : i * 16 + 16], "little")
        k1 = _rotl64((k1 * c1) & _M64, 31)
        h1 ^= (k1 * c2) & _M64
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64
        k2 = _rotl64((k2 * c2) & _M64, 33)
        h2 ^= (k2 * c1) & _M64
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64
    tail = data[nblocks * 16 :]
    if len(tail) > 8:
        k2 = _rotl64((int.from_bytes(tail[8:], "little") * c2) & _M64, 33)
        h2 ^= (k2 * c1) & _M64
    if tail:
        k1 = _rotl64((int.from_bytes(tail[:8], "little") * c1) & _M64, 31)
        h1 ^= (k1 * c2) & _M64
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    return h1, h2
