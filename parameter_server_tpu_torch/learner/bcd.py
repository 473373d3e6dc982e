"""Block coordinate descent framework (host side, numpy).

Counterpart of ``parameter_server_tpu/learner/bcd.py`` (the reference's
``src/learner/bcd.{h,cc}``): the scheduler stages that come before the
block updates.

- ``load_data``: read every training file into one ``SparseBatch``; with
  ``cache_dir`` through the ``SlotReader`` (each feature group cached on
  disk and localized into its own column segment).
- ``set_data``: key localization (the reference's PreprocessData key
  union); where the batch carries slot ids, the columns are laid out
  slot-major, so every feature group owns a contiguous column range.
- ``divide_feature_blocks``: a group whose features are correlated
  (nonzeros a row > 1) gets ``ceil(nnz_per_row * feature_block_ratio)``
  blocks, any other group one; the blocks even-divide the group's range.

The same blocks, layouts and printed progress lines as the JAX package
on the same data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..data.stream_reader import StreamReader
from ..system.customer import App
from ..utils.localizer import Localizer
from ..utils.range import Range
from ..utils.sparse import SparseBatch


@dataclasses.dataclass
class BCDProgress:
    """The reference's learner/proto/bcd.proto BCDProgress."""

    objective: float = 0.0
    relative_obj: float = 0.0
    violation: float = 0.0
    nnz_w: int = 0
    nnz_active_set: int = 0
    busy_time: float = 0.0
    total_time: float = 0.0

    def merge(self, other: "BCDProgress") -> None:
        self.objective += other.objective
        self.violation = max(self.violation, other.violation)
        self.nnz_w += other.nnz_w
        self.nnz_active_set += other.nnz_active_set
        self.busy_time += other.busy_time


@dataclasses.dataclass
class FeatureBlock:
    """One update unit: a feature group and its block's column range."""

    group: int
    col_range: Range


class BCDScheduler(App):
    def __init__(self, bcd_conf, name: str = "bcd_scheduler"):
        super().__init__(name=name)
        self.bcd_conf = bcd_conf
        self.g_progress: Dict[int, BCDProgress] = {}
        self.fea_blk: List[FeatureBlock] = []
        self.blk_order: List[int] = []
        self.global_keys: Optional[np.ndarray] = None
        self.data: Optional[SparseBatch] = None  # localized, cols = len(global_keys)
        # slot-major layout: each column's group id, each group's columns
        self.col_slots: Optional[np.ndarray] = None  # [cols] int32
        self.slot_ranges: Dict[int, Range] = {}
        self.info = None  # ExampleInfo: each group's nonzero counts

    def load_data(self, files: List[str], data_format: str = "libsvm",
                  cache_dir: Optional[str] = None) -> SparseBatch:
        """Read and localize the training data: with ``cache_dir`` through
        the ``SlotReader``, else in one streaming read."""
        if cache_dir is not None:
            return self.load_via_slot_reader(files, data_format, cache_dir)
        batch = StreamReader(files, data_format).read_all()
        if batch is None:
            raise ValueError(f"no data in {files}")
        return self.set_data(batch)

    def load_via_slot_reader(self, files: List[str], data_format: str,
                             cache_dir: Optional[str] = None) -> SparseBatch:
        """Read once, split by feature group, then localize each group into
        its own contiguous column segment (slot-major layout)."""
        from ..data.slot_reader import SlotReader

        self._reset_slot_state()
        sr = SlotReader(files, data_format, cache_dir=cache_dir)
        self.info = sr.read()
        labels = sr.labels
        if labels is None:
            raise ValueError(f"no data in {files}")
        n = len(labels)
        col_off = 0
        keys_parts, slot_parts = [], []
        rows_parts, cols_parts, vals_parts = [], [], []
        for s in self.info.slot:
            sub = sr.slot(s.id)
            if sub is None or sub.nnz == 0:
                continue
            uniq = np.unique(sub.indices)
            local = np.searchsorted(uniq, sub.indices)
            keys_parts.append(uniq)
            slot_parts.append(np.full(len(uniq), s.id, np.int32))
            rows_parts.append(sub.row_ids())
            cols_parts.append(local.astype(np.int64) + col_off)
            vals_parts.append(sub.value_array())
            self.slot_ranges[s.id] = Range(col_off, col_off + len(uniq))
            col_off += len(uniq)
            sr.clear(s.id)
        self.global_keys = np.concatenate(keys_parts) if keys_parts else np.zeros(0, np.int64)
        self.col_slots = np.concatenate(slot_parts) if slot_parts else np.zeros(0, np.int32)
        rows = np.concatenate(rows_parts) if rows_parts else np.zeros(0, np.int32)
        cols = np.concatenate(cols_parts) if cols_parts else np.zeros(0, np.int64)
        vals = np.concatenate(vals_parts) if vals_parts else np.zeros(0, np.float32)
        order = np.argsort(rows, kind="stable")
        counts = np.bincount(rows, minlength=n).astype(np.int64)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        self.data = SparseBatch(y=np.asarray(labels, np.float32), indptr=indptr,
                                indices=cols[order], values=vals[order], num_cols=col_off)
        return self.data

    def set_data(self, batch: SparseBatch) -> SparseBatch:
        """Key localization. When the batch carries per-entry slot ids, the
        columns are permuted to slot-major order (keys stay sorted within
        a slot)."""
        self._reset_slot_state()
        loc = Localizer()
        keys, _ = loc.count_uniq_index(batch)
        localized = loc.remap_index(keys)
        if batch.slot_ids is not None and batch.nnz:
            col_slot = np.zeros(len(keys), np.int32)
            col_slot[localized.indices] = batch.slot_ids
            order = np.argsort(col_slot, kind="stable")
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            localized = SparseBatch(y=localized.y, indptr=localized.indptr,
                                    indices=inv[localized.indices], values=localized.values,
                                    num_cols=localized.num_cols)
            self.global_keys = keys[order]
            self.col_slots = col_slot[order]
            self._fill_slot_ranges()
            from ..data.info import info_from_batch

            self.info = info_from_batch(batch)
        else:
            self.global_keys = keys
            self.col_slots = None
        self.data = localized
        return self.data

    def _reset_slot_state(self) -> None:
        """New data inherits nothing of the previous dataset's slot layout
        (stale ranges would mis-divide the new feature blocks)."""
        self.slot_ranges = {}
        self.col_slots = None
        self.info = None

    def _fill_slot_ranges(self) -> None:
        self.slot_ranges = {}
        if self.col_slots is None or not len(self.col_slots):
            return
        bounds = np.flatnonzero(np.diff(self.col_slots)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(self.col_slots)]])
        for lo, hi in zip(starts, ends):
            self.slot_ranges[int(self.col_slots[lo])] = Range(int(lo), int(hi))

    def divide_feature_blocks(self, num_groups: int = 1) -> List[FeatureBlock]:
        """The reference's DivideFeatureBlocks. Without slot structure,
        ``round(ratio * num_groups)`` even blocks over all columns (one
        when the ratio is 0)."""
        assert self.data is not None, "load data first"
        ratio = max(self.bcd_conf.feature_block_ratio, 0)
        self.fea_blk = []
        if self.info is not None and self.slot_ranges:
            # the reference skips slot 0, where its Example proto keeps the
            # label; the parsers here never put labels in slots, so group 0
            # (terafea, adfea, ps files) is a feature group like any other
            by_id = {s.id: s for s in self.info.slot}
            for sid in sorted(self.slot_ranges):
                crange = self.slot_ranges[sid]
                s = by_id.get(sid)
                nblk = 1
                if s is not None and s.nnz_ex > 0:
                    nnz_per_row = s.nnz_ele / s.nnz_ex
                    if nnz_per_row > 1 + 1e-6 and ratio > 0:
                        nblk = max(1, int(np.ceil(nnz_per_row * ratio)))
                nblk = min(nblk, max(1, crange.size()))
                for i in range(nblk):
                    blk = crange.even_divide(nblk, i)
                    if blk.size() > 0:
                        self.fea_blk.append(FeatureBlock(group=sid, col_range=blk))
        else:
            f = self.data.cols
            nblk = max(1, int(round(ratio * num_groups))) if ratio > 0 else 1
            nblk = min(nblk, max(1, f))
            full = Range(0, f)
            self.fea_blk = [FeatureBlock(group=0, col_range=full.even_divide(nblk, i))
                            for i in range(nblk)]
        self.blk_order = list(range(len(self.fea_blk)))
        return self.fea_blk

    def merge_progress(self, iteration: int, prog: BCDProgress) -> None:
        cur = self.g_progress.get(iteration)
        if cur is None:
            self.g_progress[iteration] = prog
        else:
            cur.merge(prog)

    def show_progress(self, iteration: int) -> str:
        """The progress line of a pass, as the JAX package prints it."""
        p = self.g_progress.get(iteration, BCDProgress())
        return (
            f"iter {iteration:3d}: objv {p.objective:.6e} "
            f"rel {p.relative_obj:.2e} |w|0 {p.nnz_w} "
            f"active {p.nnz_active_set} vio {p.violation:.2e}"
        )
