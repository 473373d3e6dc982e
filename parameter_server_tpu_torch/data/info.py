"""Per-slot statistics of a batch.

Counterpart of ``parameter_server_tpu/data/info.py`` (the reference's
``info_parser``): for each slot its key range, entry count and example
count, and the batch's example count, as an ``ExampleInfo``.
"""

from __future__ import annotations

import numpy as np

from ..utils.sparse import SparseBatch
from .example import ExampleInfo, SlotInfo
from .text_parser import SLOT_SPACE


def info_from_batch(batch: SparseBatch, split_slots: bool = True) -> ExampleInfo:
    """Slots come from the batch's slot ids, else from the key striping
    (``key // 2^52``); ``split_slots=False`` puts every entry in slot 0.
    ``max_key`` is one past the largest key."""
    info = ExampleInfo(num_ex=batch.n)
    if batch.nnz == 0:
        return info
    if split_slots and batch.slot_ids is not None:
        slot_of = batch.slot_ids.astype(np.int64)
    elif split_slots:
        slot_of = (batch.indices // SLOT_SPACE).astype(np.int64)
    else:
        slot_of = np.zeros(batch.nnz, np.int64)
    rows = batch.row_ids()
    for sid in np.unique(slot_of):
        sel = slot_of == sid
        keys = batch.indices[sel]
        info.slot.append(SlotInfo(
            id=int(sid),
            format="sparse_binary" if batch.binary else "sparse",
            min_key=int(keys.min()),
            max_key=int(keys.max()) + 1,
            nnz_ele=int(sel.sum()),
            nnz_ex=int(len(np.unique(rows[sel]))),
        ))
    return info
