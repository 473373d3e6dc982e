"""Sparse example batches (host side, numpy).

Counterpart of ``parameter_server_tpu/utils/sparse.py``: the CSR
minibatch the worker preps, its dense and column-major (CSC) views for
block coordinate descent, its padded COO form (:class:`PaddedBatch`),
plus the synthetic generator the benchmark and tests draw from. Same arrays, same random stream for a given seed.
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

    def to_dense(self) -> np.ndarray:
        """The ``n x cols`` float32 matrix; repeated (row, key) entries add."""
        out = np.zeros((self.n, self.cols), dtype=np.float32)
        np.add.at(out, (self.row_ids(), self.indices.astype(np.int64)), self.value_array())
        return out

    def to_csc(self) -> "SparseCols":
        """Column-major view for block coordinate descent: entries ordered
        by key with a stable sort (within a column, in row order)."""
        order = np.argsort(self.indices, kind="stable")
        cols = self.indices[order]
        rows = self.row_ids()[order]
        vals = None if self.binary else self.values[order]
        p = self.cols
        colptr = np.zeros(p + 1, dtype=np.int64)
        # a count a column, then the prefix sum: np.add.at's result, faster
        colptr[1:] = np.bincount(cols.astype(np.int64), minlength=p)[:p]
        np.cumsum(colptr, out=colptr)
        return SparseCols(
            colptr=colptr, row_ids=rows.astype(np.int32), values=vals, num_rows=self.n
        )

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

    def pad_device(self, nnz_pad: int, rows_pad: Optional[int] = None,
                   pad_col: Optional[int] = None) -> "PaddedBatch":
        """COO arrays padded to ``nnz_pad`` entries and ``rows_pad`` rows
        (host numpy; the JAX package's static-shape device encoding).
        Padding entries sit in row 0 at the sentinel column ``pad_col``
        (``cols`` by default, one column past the keys) with value 0, so
        they add nothing to any row; ``row_mask`` marks the real rows."""
        if rows_pad is None:
            rows_pad = self.n
        if self.nnz > nnz_pad:
            raise ValueError(f"nnz {self.nnz} exceeds budget {nnz_pad}")
        if self.n > rows_pad:
            raise ValueError(f"rows {self.n} exceed budget {rows_pad}")
        if pad_col is None:
            pad_col = self.cols
        rows = np.zeros(nnz_pad, dtype=np.int32)
        cols = np.full(nnz_pad, pad_col, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=np.float32)
        rows[: self.nnz] = self.row_ids()
        cols[: self.nnz] = self.indices
        vals[: self.nnz] = self.value_array()
        y = np.zeros(rows_pad, dtype=np.float32)
        y[: self.n] = self.y
        mask = np.zeros(rows_pad, dtype=np.float32)
        mask[: self.n] = 1.0
        return PaddedBatch(y=y, rows=rows, cols=cols, vals=vals, row_mask=mask)


@dataclasses.dataclass
class SparseCols:
    """CSC view: the row ids and values of each column, column after
    column (``colptr`` delimits them)."""

    colptr: np.ndarray  # [p+1] int64
    row_ids: np.ndarray  # [nnz] int32
    values: Optional[np.ndarray]  # [nnz] float32, None if binary
    num_rows: int

    @property
    def cols(self) -> int:
        return len(self.colptr) - 1

    def col(self, j: int):
        lo, hi = self.colptr[j], self.colptr[j + 1]
        v = None if self.values is None else self.values[lo:hi]
        return self.row_ids[lo:hi], v


@dataclasses.dataclass
class PaddedBatch:
    """A SparseBatch as static-shape COO arrays (:meth:`SparseBatch.pad_device`)."""

    y: np.ndarray  # [rows_pad]
    rows: np.ndarray  # [nnz_pad] int32
    cols: np.ndarray  # [nnz_pad] int32; padding at the sentinel column
    vals: np.ndarray  # [nnz_pad] float32; padding 0
    row_mask: np.ndarray  # [rows_pad] float32, 1 for a real example

    @property
    def rows_pad(self) -> int:
        return len(self.y)

    @property
    def nnz_pad(self) -> int:
        return len(self.rows)


def from_dense(x: np.ndarray, y: np.ndarray) -> SparseBatch:
    """The CSR batch of a dense ``n x p`` matrix's nonzero entries."""
    n, p = x.shape
    indptr = [0]
    indices = []
    values = []
    for i in range(n):
        (nz,) = np.nonzero(x[i])
        indices.append(nz)
        values.append(x[i, nz])
        indptr.append(indptr[-1] + len(nz))
    return SparseBatch(
        y=y.astype(np.float32),
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=np.concatenate(indices).astype(np.int64) if indices else np.zeros(0, np.int64),
        values=np.concatenate(values).astype(np.float32) if values else np.zeros(0, np.float32),
        num_cols=p,
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
