"""Probabilistic sketches of feature keys (host, native): a bloom
filter and a count-min sketch of frequencies.

Counterpart of ``BloomFilter`` and ``CountMin`` in
``parameter_server_tpu/utils/sketch.py``: the same double-hashed
positions (and, for the count-min, saturating counters), so the
tail-feature filter keeps the same keys in both packages and a bloom
filter sets the same bits.
:class:`DecayCountMin` is the key-heat sketch of the learning plane
(``telemetry/learning.py``), as in the JAX package. The positions, the
inserts and the queries run in the port's native library (``ps_cm_*``),
as do the key heat's run count and its per-shard fold
(:func:`unique_counts`, :func:`add_by_range`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native

_U32_MAX = (1 << 32) - 1


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _positions(keys: np.ndarray, num_hash: int, mod: int) -> np.ndarray:
    """[num_hash, n] hashed positions via double hashing (Kirsch–Mitzenmacher)."""
    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64).reshape(-1))
    pos = np.empty((num_hash, keys.size), np.uint32)
    native.library().ps_cm_positions(_p(keys, ctypes.c_uint64), keys.size, num_hash, mod,
                                      _p(pos, ctypes.c_uint32))
    return pos


class BloomFilter:
    """A bloom filter of ``num_bits`` bits and ``num_hash`` hash
    positions a key (the reference's ``bloom_filter.h``): no false
    negatives; ``query`` may say yes to a key never inserted."""

    def __init__(self, num_bits: int = 1 << 20, num_hash: int = 2):
        if not 0 < num_bits <= 1 << 32:
            raise ValueError(f"a bloom filter holds 1 to 2^32 bits, not {num_bits}")
        self.num_bits = int(num_bits)
        self.num_hash = int(num_hash)
        self.bits = np.zeros(self.num_bits, dtype=bool)

    def insert(self, keys: np.ndarray) -> None:
        self.bits[_positions(keys, self.num_hash, self.num_bits).reshape(-1)] = True

    def query(self, keys: np.ndarray) -> np.ndarray:
        """Whether each key may have been inserted."""
        return self.bits[_positions(keys, self.num_hash, self.num_bits)].all(axis=0)

    def __contains__(self, key: int) -> bool:
        return bool(self.query(np.asarray([key]))[0])


class CountMin:
    """Count-min sketch with saturating uint32 counters: ``insert(keys,
    counts)`` adds capped counts, ``query`` returns the minimum over the
    hash rows (an upper-biased frequency estimate)."""

    def __init__(self, n: int = 1 << 20, k: int = 2, cap: int = 255):
        if not 0 < n <= 1 << 32:
            raise ValueError(f"a count-min row holds 1 to 2^32 counters, not {n}")
        self.n = int(n)
        self.k = int(k)
        self.cap = int(cap)
        self.data = np.zeros((self.k, self.n), dtype=np.uint32)

    def insert(self, keys: np.ndarray, counts=1) -> None:
        self.insert_at(self.positions(keys), counts)

    def query(self, keys: np.ndarray) -> np.ndarray:
        return self.query_at(self.positions(keys))

    def positions(self, keys: np.ndarray) -> np.ndarray:
        """The keys' [k, n] hashed positions (depends on no count: any
        thread may compute them)."""
        return _positions(keys, self.k, self.n)

    def insert_at(self, pos: np.ndarray, counts=1) -> None:
        """:meth:`insert` of the keys at ``pos``: row by row, the counts
        added modulo 2^32 (a uint32 scatter-add), then the touched buckets
        saturated."""
        counts = np.ascontiguousarray(
            np.broadcast_to(np.asarray(counts, dtype=np.uint32), pos.shape[1:]))
        native.library().ps_cm_insert(_p(pos, ctypes.c_uint32), _p(counts, ctypes.c_uint32),
                                      pos.shape[1], self.k, self.n, min(self.cap, _U32_MAX),
                                      _p(self.data, ctypes.c_uint32))

    def query_at(self, pos: np.ndarray) -> np.ndarray:
        """:meth:`query` of the keys at ``pos``."""
        est = np.empty(pos.shape[1], np.uint32)
        native.library().ps_cm_query(_p(pos, ctypes.c_uint32), pos.shape[1], self.k, self.n,
                                     _p(self.data, ctypes.c_uint32), _p(est, ctypes.c_uint32))
        return est

    def clear(self) -> None:
        self.data.fill(0)


class DecayCountMin(CountMin):
    """Count-min with windowed exponential decay — the key-heat sketch
    of the learning truth plane (telemetry/learning.py).

    Same CM machinery the ingest tail filter rides, but the counters
    track the RECENT stream instead of lifetime totals: ``decay()``
    halves every counter, so calling it once per window gives every
    observation a half-life of one window. Heat ranking only needs
    relative magnitudes, so the integer floor-halving bias (a stuck 1
    decays to 0) is immaterial — and exactly what lets a cold key fall
    out of the top-k. The cap is raised from the tail filter's 255
    (there the question is "below freq?"; here hot keys must keep
    separating long past 255).
    """

    def __init__(self, n: int = 1 << 16, k: int = 2, cap: int = 1 << 30):
        super().__init__(n=n, k=k, cap=cap)

    def decay(self) -> None:
        """Advance one window: halve every counter in place."""
        self.data >>= 1


def unique_counts(values: np.ndarray):
    """``np.unique(values, return_counts=True)`` of integers in
    ``[0, 2^32)``: NumPy's sort, then the runs counted natively. The
    sorted distinct values come back as uint32, their counts as int64."""
    v = np.sort(np.asarray(values).reshape(-1).astype(np.uint32))
    counts = np.empty(v.size, np.int64)
    u = native.library().ps_runs_u32(_p(v, ctypes.c_uint32), v.size, _p(v, ctypes.c_uint32),
                                     _p(counts, ctypes.c_int64))
    return v[:u].copy(), counts[:u].copy()


def add_by_range(out: np.ndarray, starts: np.ndarray, sorted_values: np.ndarray,
                 counts: np.ndarray) -> None:
    """``np.add.at(out, np.searchsorted(starts, sorted_values, "right") - 1,
    counts)`` for ascending uint32 values and ascending int64 ``starts``
    from 0: each count added in turn to the float64 total of its range."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    values = np.ascontiguousarray(sorted_values, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    if out.dtype != np.float64 or not out.flags.c_contiguous:
        raise ValueError("add_by_range adds into a contiguous float64 array")
    native.library().ps_add_by_range(_p(values, ctypes.c_uint32), _p(counts, ctypes.c_int64),
                                     values.size, _p(starts, ctypes.c_int64), starts.size,
                                     _p(out, ctypes.c_double))
