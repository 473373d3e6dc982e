"""64-bit mixing hash of feature keys into table slots (numpy).

Counterpart of ``parameter_server_tpu/utils/murmur.py``: the same
splitmix64-style finalizer, so a key lands in the same slot in both
packages. NumPy only; no native library.
"""

from __future__ import annotations

import numpy as np

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
    h = murmur64_np(keys, np.uint64(seed))
    if num_slots & (num_slots - 1) == 0:
        return (h & np.uint64(num_slots - 1)).astype(np.int32)
    return (h % np.uint64(num_slots)).astype(np.int32)
