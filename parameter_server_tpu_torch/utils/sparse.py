"""Sparse example batches (host side, numpy).

Counterpart of ``parameter_server_tpu/utils/sparse.py``: the CSR
minibatch the worker preps, plus the synthetic generator the benchmark
and tests draw from. Same arrays, same random stream for a given seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SparseBatch:
    """A minibatch of sparse examples: labels ``y`` [n] in {-1, +1} and
    an ``n x p`` CSR feature matrix. ``values=None`` marks binary
    features."""

    y: np.ndarray  # [n] float32
    indptr: np.ndarray  # [n+1] int64
    indices: np.ndarray  # [nnz] int64 feature keys
    values: Optional[np.ndarray] = None  # [nnz] float32, None if binary
    num_cols: Optional[int] = None
    # per-entry feature-group ids (the reference Example proto's Slot.id),
    # as the text parsers emit them; None when the source has none
    slot_ids: Optional[np.ndarray] = None  # [nnz] int32

    @property
    def n(self) -> int:
        return len(self.y)

    @property
    def nnz(self) -> int:
        return len(self.indices)

    @property
    def binary(self) -> bool:
        return self.values is None

    @property
    def cols(self) -> int:
        """``num_cols``, else one past the largest key."""
        if self.num_cols is not None:
            return self.num_cols
        return int(self.indices.max()) + 1 if self.nnz else 0

    def row_ids(self) -> np.ndarray:
        """Expand indptr to per-nnz row ids (COO rows)."""
        return np.repeat(
            np.arange(self.n, dtype=np.int32), np.diff(self.indptr).astype(np.int64)
        )

    def value_array(self) -> np.ndarray:
        if self.values is not None:
            return self.values
        return np.ones(self.nnz, dtype=np.float32)

    def slice_rows(self, begin: int, end: int) -> "SparseBatch":
        lo, hi = self.indptr[begin], self.indptr[end]
        return SparseBatch(
            y=self.y[begin:end],
            indptr=(self.indptr[begin : end + 1] - lo),
            indices=self.indices[lo:hi],
            values=None if self.binary else self.values[lo:hi],
            num_cols=self.num_cols,
            slot_ids=None if self.slot_ids is None else self.slot_ids[lo:hi],
        )


def random_sparse(
    n: int,
    p: int,
    nnz_per_row: int,
    seed: int = 0,
    binary: bool = False,
    w_true: Optional[np.ndarray] = None,
) -> SparseBatch:
    """Synthetic sparse logistic data; the same draws, in the same
    order, as the JAX package's generator for the same seed."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, p, size=(n, nnz_per_row), dtype=np.int64)
    vals = (
        np.ones((n, nnz_per_row), dtype=np.float32)
        if binary
        else rng.normal(size=(n, nnz_per_row)).astype(np.float32)
    )
    if w_true is None:
        w_true = (rng.normal(size=p) * (rng.random(p) < 0.1)).astype(np.float32)
    logits = (vals * w_true[idx]).sum(axis=1)
    yprob = 1.0 / (1.0 + np.exp(-logits))
    y = np.where(rng.random(n) < yprob, 1.0, -1.0).astype(np.float32)
    indptr = np.arange(0, (n + 1) * nnz_per_row, nnz_per_row, dtype=np.int64)
    return SparseBatch(
        y=y,
        indptr=indptr,
        indices=idx.reshape(-1),
        values=None if binary else vals.reshape(-1),
        num_cols=p,
    )
