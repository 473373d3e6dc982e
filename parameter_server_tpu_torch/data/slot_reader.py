"""Feature-group (slot) column cache.

Counterpart of ``parameter_server_tpu/data/slot_reader.py`` (the
reference's ``slot_reader``): read every file once, split the entries by
slot (the parsers' slot ids, else the key striping ``key // 2^52``) and
keep each slot's rows as a CSR batch, optionally cached as ``.npz``
under a directory, so a block coordinate-descent learner can load one
feature group at a time. Also fills an ``ExampleInfo``.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.sparse import SparseBatch
from .example import ExampleInfo, SlotInfo
from .stream_reader import StreamReader
from .text_parser import SLOT_SPACE


class SlotReader:
    def __init__(self, files: Optional[List[str]] = None, data_format: str = "libsvm",
                 cache_dir: Optional[str] = None):
        self.files = files or []
        self.format = data_format
        self.cache_dir = cache_dir
        self.info = ExampleInfo()
        self._slots: Dict[int, SparseBatch] = {}
        self._labels: Optional[np.ndarray] = None

    def _cache_path(self, slot_id: int) -> Optional[str]:
        if not self.cache_dir:
            return None
        os.makedirs(self.cache_dir, exist_ok=True)
        # a digest that is the same in every process (hash() is salted)
        key = "|".join(self.files) + f"|{self.format}|{slot_id}"
        tag = hashlib.sha1(key.encode()).hexdigest()[:8]
        return os.path.join(self.cache_dir, f"slot_{slot_id}_{tag}.npz")

    def read(self) -> ExampleInfo:
        """Read all files, split them by slot and fill ``info``."""
        batch = StreamReader(self.files, self.format).read_all()
        if batch is None:
            return self.info
        self._labels = batch.y
        if batch.slot_ids is not None:
            slot_of = batch.slot_ids.astype(np.int64)
        else:
            slot_of = (batch.indices // SLOT_SPACE).astype(np.int64)
        self.info = ExampleInfo(num_ex=batch.n)
        rows = batch.row_ids()
        vals = batch.value_array()
        for sid in np.unique(slot_of):
            sel = slot_of == sid
            keys = batch.indices[sel]
            sub_rows = rows[sel]
            counts = np.zeros(batch.n, np.int64)
            np.add.at(counts, sub_rows, 1)
            indptr = np.zeros(batch.n + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            order = np.argsort(sub_rows, kind="stable")
            sub = SparseBatch(y=batch.y, indptr=indptr, indices=keys[order],
                              values=vals[sel][order])
            self._slots[int(sid)] = sub
            self.info.slot.append(SlotInfo(
                id=int(sid), format="sparse", min_key=int(keys.min()),
                max_key=int(keys.max()) + 1, nnz_ele=int(sel.sum()),
                nnz_ex=int((counts > 0).sum()),
            ))
            path = self._cache_path(int(sid))
            if path:
                np.savez_compressed(path, y=sub.y, indptr=sub.indptr, indices=sub.indices,
                                    values=sub.values)
        self.info.slot.sort(key=lambda s: s.id)
        return self.info

    def slot(self, slot_id: int) -> Optional[SparseBatch]:
        """The CSR batch of one slot's entries, from memory or the cache."""
        if slot_id in self._slots:
            return self._slots[slot_id]
        path = self._cache_path(slot_id)
        if path and os.path.exists(path):
            z = np.load(path)
            return SparseBatch(y=z["y"], indptr=z["indptr"], indices=z["indices"],
                               values=z["values"])
        return None

    def clear(self, slot_id: int) -> None:
        self._slots.pop(slot_id, None)

    @property
    def labels(self) -> Optional[np.ndarray]:
        return self._labels
