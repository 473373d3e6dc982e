"""Example and slot statistics, and a batch's binary record payload.

Counterpart of ``parameter_server_tpu/data/example.py``: ``SlotInfo`` and
``ExampleInfo`` (the reference's ``example.proto`` messages of those
names) and the compact payload ``batch_to_bytes`` / ``batch_from_bytes``
that ``format: RECORD`` files hold, one batch a record, byte for byte
the JAX package's.

Payload: ``b"PSB1"``, then ``n``, ``nnz`` and a flags word as int64 LE
(bit 0: binary, no values; bit 1: slot ids follow), then y (float32),
indptr (int64), indices (int64), values (float32, unless binary) and
slot ids (int32, if flagged).
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Dict, List

import numpy as np

from ..utils.sparse import SparseBatch

_MAGIC = b"PSB1"


@dataclasses.dataclass
class SlotInfo:
    id: int = 0
    format: str = "sparse"  # dense | sparse | sparse_binary
    min_key: int = (1 << 64) - 1
    max_key: int = 0
    nnz_ele: int = 0
    nnz_ex: int = 0


@dataclasses.dataclass
class ExampleInfo:
    slot: List[SlotInfo] = dataclasses.field(default_factory=list)
    num_ex: int = 0

    def merge(self, other: "ExampleInfo") -> None:
        """Add ``other``'s counts: key ranges widen, counts add, slots
        new to this one are copied in; slots stay sorted by id."""
        self.num_ex += other.num_ex
        by_id: Dict[int, SlotInfo] = {s.id: s for s in self.slot}
        for s in other.slot:
            if s.id in by_id:
                d = by_id[s.id]
                d.min_key = min(d.min_key, s.min_key)
                d.max_key = max(d.max_key, s.max_key)
                d.nnz_ele += s.nnz_ele
                d.nnz_ex += s.nnz_ex
            else:
                self.slot.append(dataclasses.replace(s))
        self.slot.sort(key=lambda s: s.id)


def batch_to_bytes(batch: SparseBatch) -> bytes:
    buf = io.BytesIO()
    buf.write(_MAGIC)
    flags = (1 if batch.binary else 0) | (2 if batch.slot_ids is not None else 0)
    buf.write(struct.pack("<qqq", batch.n, batch.nnz, flags))
    buf.write(batch.y.astype(np.float32).tobytes())
    buf.write(batch.indptr.astype(np.int64).tobytes())
    buf.write(batch.indices.astype(np.int64).tobytes())
    if not batch.binary:
        buf.write(batch.values.astype(np.float32).tobytes())
    if batch.slot_ids is not None:
        buf.write(batch.slot_ids.astype(np.int32).tobytes())
    return buf.getvalue()


def batch_from_bytes(data: bytes) -> SparseBatch:
    if data[:4] != _MAGIC:
        raise IOError("bad batch magic")
    n, nnz, flags = struct.unpack_from("<qqq", data, 4)
    off = 4 + 24
    y = np.frombuffer(data, np.float32, n, off).copy()
    off += 4 * n
    indptr = np.frombuffer(data, np.int64, n + 1, off).copy()
    off += 8 * (n + 1)
    indices = np.frombuffer(data, np.int64, nnz, off).copy()
    off += 8 * nnz
    values = None
    if not flags & 1:
        values = np.frombuffer(data, np.float32, nnz, off).copy()
        off += 4 * nnz
    slot_ids = np.frombuffer(data, np.int32, nnz, off).copy() if flags & 2 else None
    return SparseBatch(y=y, indptr=indptr, indices=indices, values=values, slot_ids=slot_ids)
