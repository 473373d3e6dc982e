"""Sparse value filter (the reference's ``src/filter/sparse_filter.h``).

Copy of ``parameter_server_tpu/filter/sparse.py``. Encode replaces each
float array by its nonzero entries and their positions; decode restores
the dense array. A marked entry (NaN, the reference's ``kMark``: "skip
this coordinate", which darlin's KKT filter sets) counts as nonzero and
survives the round trip. Non-float arrays pass through.
"""

from __future__ import annotations

import numpy as np

from ..system.message import FilterSpec, Message
from .base import Filter, register

# the reference marks with a fixed NaN payload (sparse_filter.h kMark)
MARK = np.float32(np.nan)


def mark(arr: np.ndarray, idx) -> None:
    arr[idx] = MARK


def marked(arr: np.ndarray) -> np.ndarray:
    return np.isnan(arr)


@register
class SparseFilter(Filter):
    TYPE = "sparse"

    def encode(self, msg: Message, spec: FilterSpec) -> Message:
        meta = []
        out = []
        for v in msg.values:
            if v.dtype.kind != "f":
                out.append(v)
                meta.append(None)
                continue
            nz = np.flatnonzero((v != 0) | np.isnan(v))
            meta.append((len(v), nz.astype(np.int32)))
            out.append(v[nz])
        spec.extra["meta"] = meta
        msg.values = out
        return msg

    def decode(self, msg: Message, spec: FilterSpec) -> Message:
        meta = spec.extra.get("meta")
        if meta is None:
            return msg
        out = []
        for v, m in zip(msg.values, meta):
            if m is None:
                out.append(v)
                continue
            size, nz = m
            dense = np.zeros(size, dtype=v.dtype)
            dense[nz] = v
            out.append(dense)
        msg.values = out
        return msg
