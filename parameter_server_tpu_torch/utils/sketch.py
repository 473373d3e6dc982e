"""Count-min sketch of feature-key frequencies (host, numpy).

Counterpart of ``CountMin`` in ``parameter_server_tpu/utils/sketch.py``:
the same double-hashed positions and saturating counters, so the
tail-feature filter keeps the same keys in both packages.
"""

from __future__ import annotations

import numpy as np

from .murmur import murmur64_np


def _hashes(keys: np.ndarray, num_hash: int, mod: int, seed0: int = 0x9E3779B9) -> np.ndarray:
    """[num_hash, n] hashed positions via double hashing (Kirsch–Mitzenmacher)."""
    keys = np.asarray(keys, dtype=np.uint64)
    h1 = murmur64_np(keys, np.uint64(seed0))
    h2 = murmur64_np(keys, np.uint64(0xC2B2AE3D27D4EB4F)) | np.uint64(1)
    i = np.arange(num_hash, dtype=np.uint64)[:, None]
    return ((h1[None, :] + i * h2[None, :]) % np.uint64(mod)).astype(np.int64)


class CountMin:
    """Count-min sketch with saturating uint32 counters: ``insert(keys,
    counts)`` adds capped counts, ``query`` returns the minimum over the
    hash rows (an upper-biased frequency estimate)."""

    def __init__(self, n: int = 1 << 20, k: int = 2, cap: int = 255):
        self.n = int(n)
        self.k = int(k)
        self.cap = int(cap)
        self.data = np.zeros((self.k, self.n), dtype=np.uint32)

    def insert(self, keys: np.ndarray, counts=1) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        counts = np.broadcast_to(np.asarray(counts, dtype=np.uint32), keys.shape)
        pos = _hashes(keys, self.k, self.n)
        for r in range(self.k):
            # scatter-add (np.add.at folds duplicate positions), then
            # saturate only the touched buckets
            row = self.data[r]
            np.add.at(row, pos[r], counts)
            row[pos[r]] = np.minimum(row[pos[r]], self.cap)

    def query(self, keys: np.ndarray) -> np.ndarray:
        pos = _hashes(np.asarray(keys, dtype=np.uint64), self.k, self.n)
        est = self.data[0][pos[0]]
        for r in range(1, self.k):
            est = np.minimum(est, self.data[r][pos[r]])
        return est

    def clear(self) -> None:
        self.data.fill(0)
