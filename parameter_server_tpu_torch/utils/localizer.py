"""Key localization for the tail filter (host, numpy).

Counterpart of ``count_uniq_keys``, ``remap`` and
``Localizer.count_uniq_index`` / ``remap_index`` in
``parameter_server_tpu/utils/localizer.py`` (with ``match_positions`` of
``utils/ordered_match.py``): the sorted unique keys of a batch with
their capped counts, then the batch rewritten to positions in a kept
subset of those keys, entries of dropped keys removed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .ordered_match import match_positions
from .sparse import SparseBatch


def count_uniq_keys(batch: SparseBatch, cap: int = 255) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted unique feature keys of ``batch`` and their appearance
    counts, capped at ``cap`` (the reference's uint8 counters)."""
    keys, counts = np.unique(batch.indices, return_counts=True)
    return keys, np.minimum(counts, cap).astype(np.uint32)


def remap(batch: SparseBatch, keep_keys: np.ndarray) -> SparseBatch:
    """``batch`` with each key replaced by its position in sorted
    ``keep_keys``; entries of other keys are dropped."""
    hit, new_idx = match_positions(keep_keys, batch.indices)
    new_counts = np.zeros(batch.n, dtype=np.int64)
    np.add.at(new_counts, batch.row_ids()[hit], 1)
    indptr = np.zeros(batch.n + 1, dtype=np.int64)
    np.cumsum(new_counts, out=indptr[1:])
    return SparseBatch(
        y=batch.y,
        indptr=indptr,
        indices=new_idx.astype(np.int64),
        values=None if batch.binary else batch.values[hit],
        num_cols=len(keep_keys),
        slot_ids=None if batch.slot_ids is None else batch.slot_ids[hit],
    )


class Localizer:
    """The reference's two-call protocol: :meth:`count_uniq_index`, then
    :meth:`remap_index` with the keys to keep."""

    def __init__(self) -> None:
        self._keys: Optional[np.ndarray] = None
        self._inverse: Optional[np.ndarray] = None
        self._batch: Optional[SparseBatch] = None

    def count_uniq_index(self, batch: SparseBatch, cap: int = 255):
        """Sorted unique keys of ``batch`` and their appearance counts,
        capped at ``cap`` (the reference's uint8 counters)."""
        self._batch = batch
        keys, inverse, counts = np.unique(
            batch.indices, return_inverse=True, return_counts=True
        )
        self._keys = keys
        self._inverse = inverse
        return keys, np.minimum(counts, cap).astype(np.uint32)

    def remap_index(self, keep_keys: np.ndarray) -> SparseBatch:
        """The batch with each entry's key replaced by its position in
        sorted ``keep_keys``; entries of other keys are dropped."""
        if self._batch is None:
            raise RuntimeError("call count_uniq_index first")
        batch = self._batch
        keep = np.asarray(keep_keys, dtype=np.int64)
        # match the (sorted, unique) keys, then push hits through the inverse
        hit_u, pos_u = match_positions(keep, self._keys)
        dest = np.full(len(self._keys), -1, np.int64)
        dest[hit_u] = pos_u
        per_entry = dest[self._inverse]
        hit = per_entry >= 0
        new_counts = np.bincount(batch.row_ids()[hit], minlength=batch.n).astype(np.int64)
        indptr = np.zeros(batch.n + 1, dtype=np.int64)
        np.cumsum(new_counts, out=indptr[1:])
        return SparseBatch(
            y=batch.y,
            indptr=indptr,
            indices=per_entry[hit],
            values=None if batch.binary else batch.values[hit],
            num_cols=len(keep),
            slot_ids=None if batch.slot_ids is None else batch.slot_ids[hit],
        )
