"""The reference's binary data format: protobuf ``Example`` records.

Counterpart of ``parameter_server_tpu/data/ref_interop.py``, decoded and
encoded by hand, with no protobuf runtime:

* framing (the reference's ``util/recordio.h``): each record is
  ``[magic int32 LE = 0x3ed7230a][payload size uint32 LE][payload]``;
* payload: a serialized ``PS.Example`` (``data/proto/example.proto``)::

      message Slot    { optional int32 id = 1;
                        repeated uint64 key = 2 [packed=true];
                        repeated float  val = 3 [packed=true]; }
      message Example { repeated Slot slot = 1; }

* convention (the reference's text parsers): slot 0 carries the label
  as ``val[0]`` and no keys; feature slots (id >= 1) carry their keys,
  with ``val`` absent for binary features and parallel to ``key``
  otherwise;
* an optional ``<name>.info`` sidecar holds an ``ExampleInfo`` in
  protobuf ASCII text format.

Decoding accepts the packed and the unpacked encodings of the repeated
fields, as any compliant proto parser must. A conf's ``format: PROTO``
reads these files (``StreamReader`` format ``ref_record``).
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..utils import file as psfile
from ..utils.sparse import SparseBatch
from .example import ExampleInfo, SlotInfo

#: ref src/util/recordio.h kMagicNumber
REF_MAGIC = 0x3ED7230A
_MAGIC_BYTES = struct.pack("<i", REF_MAGIC)

# SlotInfo.Format enum values (ref example.proto)
_FORMAT_FROM_ENUM = {1: "dense", 2: "sparse", 3: "sparse_binary"}


# ---------------------------------------------------------------------------
# proto wire primitives
# ---------------------------------------------------------------------------

def _read_uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            # a maximal 10-byte varint carries up to 70 payload bits;
            # compliant proto parsers truncate them to 64
            return result & 0xFFFFFFFFFFFFFFFF, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 64 bits")


def _write_uvarint(out: bytearray, value: int) -> None:
    value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) for a message's bytes.

    value is an int for varint/fixed wire types and a memoryview for
    length-delimited fields. Unknown wire types raise (the schema is
    frozen; anything else means the input is not a PS proto)."""
    view = memoryview(buf)
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_uvarint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_uvarint(buf, pos)
            yield field, wt, val
        elif wt == 2:  # length-delimited
            ln, pos = _read_uvarint(buf, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            yield field, wt, view[pos:pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            if pos + 4 > n:
                raise ValueError("truncated fixed32")
            yield field, wt, struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wt == 1:  # fixed64
            if pos + 8 > n:
                raise ValueError("truncated fixed64")
            yield field, wt, struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")


def _decode_packed_uvarints(view) -> List[int]:
    buf = bytes(view)
    out: List[int] = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_uvarint(buf, pos)
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# Slot / Example
# ---------------------------------------------------------------------------

def decode_slot(buf) -> Tuple[int, np.ndarray, Optional[np.ndarray]]:
    """``PS.Slot`` bytes -> (id, keys uint64[], vals float32[] | None)."""
    slot_id = 0
    keys: List[int] = []
    vals: Optional[List[float]] = None
    for field, wt, val in _iter_fields(bytes(buf)):
        if field == 1 and wt == 0:
            slot_id = int(np.int32(np.uint32(val & 0xFFFFFFFF)))
        elif field == 2 and wt == 2:  # packed keys
            keys.extend(_decode_packed_uvarints(val))
        elif field == 2 and wt == 0:  # unpacked key
            keys.append(val)
        elif field == 3 and wt == 2:  # packed vals
            arr = np.frombuffer(bytes(val), dtype="<f4")
            vals = (vals or []) + arr.tolist()
        elif field == 3 and wt == 5:  # unpacked val
            vals = (vals or [])
            vals.append(struct.unpack("<f", struct.pack("<I", val))[0])
        # unknown fields are skipped by _iter_fields' framing
    return (
        slot_id,
        np.asarray(keys, dtype=np.uint64),
        None if vals is None else np.asarray(vals, dtype=np.float32),
    )


def encode_slot(slot_id: int, keys, vals=None) -> bytes:
    out = bytearray()
    _write_uvarint(out, (1 << 3) | 0)  # id: field 1, varint
    _write_uvarint(out, int(slot_id) & 0xFFFFFFFF)
    keys = np.asarray(keys, dtype=np.uint64)
    if keys.size:
        packed = bytearray()
        for k in keys.tolist():
            _write_uvarint(packed, k)
        _write_uvarint(out, (2 << 3) | 2)  # key: field 2, packed
        _write_uvarint(out, len(packed))
        out += packed
    if vals is not None:
        v = np.asarray(vals, dtype="<f4").tobytes()
        _write_uvarint(out, (3 << 3) | 2)  # val: field 3, packed
        _write_uvarint(out, len(v))
        out += v
    return bytes(out)


def decode_example(buf) -> List[Tuple[int, np.ndarray, Optional[np.ndarray]]]:
    """``PS.Example`` bytes -> list of decoded slots (see decode_slot)."""
    slots = []
    for field, wt, val in _iter_fields(bytes(buf)):
        if field == 1 and wt == 2:
            slots.append(decode_slot(val))
    return slots


def encode_example(slots) -> bytes:
    """Inverse of :func:`decode_example`: slots is an iterable of
    (id, keys, vals-or-None)."""
    out = bytearray()
    for slot_id, keys, vals in slots:
        body = encode_slot(slot_id, keys, vals)
        _write_uvarint(out, (1 << 3) | 2)  # slot: field 1
        _write_uvarint(out, len(body))
        out += body
    return bytes(out)


# ---------------------------------------------------------------------------
# recordio framing (ref src/util/recordio.h)
# ---------------------------------------------------------------------------

def iter_ref_records(path: str) -> Iterator[bytes]:
    """Yield the raw record payloads of a reference recordio file
    (gzipped if its name ends in ``.gz``)."""
    with psfile.open_read(path, "rb") as f:
        while True:
            head = f.read(8)
            if not head:
                return
            if len(head) < 8:
                raise ValueError(f"{path}: truncated record header")
            magic, size = struct.unpack("<iI", head)
            if magic != REF_MAGIC:
                raise ValueError(
                    f"{path}: bad magic 0x{magic & 0xFFFFFFFF:08x} "
                    f"(want 0x{REF_MAGIC:08x}) — not a reference recordio"
                )
            payload = f.read(size)
            if len(payload) < size:
                raise ValueError(f"{path}: truncated record payload")
            yield payload


def write_ref_records(path: str, payloads: Iterable[bytes]) -> int:
    """Write payloads with the reference framing; returns record count."""
    n = 0
    with open(path, "wb") as f:
        for p in payloads:
            f.write(_MAGIC_BYTES)
            f.write(struct.pack("<I", len(p)))
            f.write(p)
            n += 1
    return n


# ---------------------------------------------------------------------------
# Example stream <-> SparseBatch
# ---------------------------------------------------------------------------

#: one decoded Example as a row: (label, slot-key chunks, slot-val
#: chunks (None where the slot was binary), slot-id chunks)
Row = Tuple[float, List[np.ndarray], List[Optional[np.ndarray]], List[np.ndarray]]


def example_slots_to_row(slots) -> Row:
    """Decoded Example slots -> a row tuple for :func:`rows_to_batch`.

    Label = slot 0's ``val[0]`` (0.0 if absent); feature slots keep
    their global uint64 keys and per-entry slot ids."""
    label = 0.0
    key_chunks: List[np.ndarray] = []
    val_chunks: List[Optional[np.ndarray]] = []
    slot_chunks: List[np.ndarray] = []
    for slot_id, keys, vals in slots:
        if slot_id == 0:
            if vals is not None and vals.size:
                label = float(vals[0])
            continue
        key_chunks.append(keys)
        val_chunks.append(vals)
        slot_chunks.append(np.full(keys.size, slot_id, dtype=np.int32))
    return label, key_chunks, val_chunks, slot_chunks


def rows_to_batch(rows: List[Row]) -> SparseBatch:
    """Assemble decoded rows into one SparseBatch. ``values`` is None
    (binary) when NO slot in the batch carries vals, else missing vals
    default to 1.0 (the reference's binary()/values duality,
    sparse_matrix.h)."""
    ys = [r[0] for r in rows]
    indptr = np.zeros(len(rows) + 1, np.int64)
    key_chunks: List[np.ndarray] = []
    val_chunks: List[Optional[np.ndarray]] = []
    slot_chunks: List[np.ndarray] = []
    for i, (_, kc, vc, sc) in enumerate(rows):
        indptr[i + 1] = indptr[i] + sum(k.size for k in kc)
        key_chunks += kc
        val_chunks += vc
        slot_chunks += sc
    any_vals = any(v is not None for v in val_chunks)
    if any_vals:
        values = np.concatenate(
            [
                v if v is not None else np.ones(k.size, np.float32)
                for k, v in zip(key_chunks, val_chunks)
            ]
        ) if key_chunks else np.zeros(0, np.float32)
    else:
        values = None
    indices = (
        np.concatenate(key_chunks).view(np.int64)
        if key_chunks else np.zeros(0, np.int64)
    )
    return SparseBatch(
        y=np.asarray(ys, dtype=np.float32),
        indptr=indptr,
        indices=indices,
        values=values,
        slot_ids=(
            np.concatenate(slot_chunks)
            if slot_chunks else np.zeros(0, np.int32)
        ),
    )


def read_ref_batch(
    path: str, max_examples: Optional[int] = None
) -> SparseBatch:
    """Read a reference ``Example`` recordio file into one SparseBatch
    (see :func:`example_slots_to_row` for the slot conventions)."""
    rows: List[Row] = []
    for payload in iter_ref_records(path):
        if max_examples is not None and len(rows) >= max_examples:
            break
        rows.append(example_slots_to_row(decode_example(payload)))
    return rows_to_batch(rows)


def batch_to_ref_payloads(batch: SparseBatch) -> Iterator[bytes]:
    """SparseBatch -> one ``Example`` payload per row (slot 0 = label,
    features grouped by slot id; binary batches emit keys only)."""
    slot_ids = batch.slot_ids
    idx = batch.indices.view(np.uint64)
    for r in range(batch.n):
        lo, hi = int(batch.indptr[r]), int(batch.indptr[r + 1])
        slots = [(0, np.zeros(0, np.uint64),
                  np.asarray([batch.y[r]], np.float32))]
        row_slots = (
            slot_ids[lo:hi] if slot_ids is not None
            else np.ones(hi - lo, np.int32)
        )
        for sid in np.unique(row_slots):
            sel = np.flatnonzero(row_slots == sid) + lo
            vals = None if batch.values is None else batch.values[sel]
            slots.append((int(sid), idx[sel], vals))
        yield encode_example(slots)


def write_ref_batch(path: str, batch: SparseBatch) -> int:
    """Write a SparseBatch as reference ``Example`` records. Returns
    the record count — one per example."""
    return write_ref_records(path, batch_to_ref_payloads(batch))


# ---------------------------------------------------------------------------
# ExampleInfo ASCII sidecar (ref text2proto.h writeProtoToASCIIFile)
# ---------------------------------------------------------------------------

def parse_info_ascii(text: str) -> ExampleInfo:
    """Parse an ``ExampleInfo`` written in protobuf ASCII text format::

        slot {
          format: SPARSE_BINARY
          id: 1
          min_key: 5
          ...
        }
        num_ex: 100

    Only this frozen grammar (nested ``slot`` blocks + scalar fields)
    is accepted — it is what the reference emits for ``.info`` files."""
    info = ExampleInfo()
    cur: Optional[SlotInfo] = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("slot") and line.endswith("{"):
            cur = SlotInfo()
            continue
        if line == "}":
            if cur is not None:
                info.slot.append(cur)
            cur = None
            continue
        if ":" not in line:
            raise ValueError(f"unparseable .info line: {raw!r}")
        key, val = (t.strip() for t in line.split(":", 1))
        if cur is None:
            if key == "num_ex":
                info.num_ex = int(val)
            continue  # unknown top-level scalars are ignorable
        if key == "format":
            cur.format = (
                _FORMAT_FROM_ENUM[int(val)] if val.isdigit()
                else val.lower()
            )
        elif key == "id":
            cur.id = int(val)
        elif key in ("min_key", "max_key", "nnz_ele", "nnz_ex"):
            setattr(cur, key, int(val))
    info.slot.sort(key=lambda s: s.id)
    return info


def format_info_ascii(info: ExampleInfo) -> str:
    """Inverse of :func:`parse_info_ascii` (reference-compatible)."""
    lines = []
    for s in info.slot:
        lines += [
            "slot {",
            f"  format: {s.format.upper()}",
            f"  id: {s.id}",
            f"  min_key: {s.min_key}",
            f"  max_key: {s.max_key}",
            f"  nnz_ele: {s.nnz_ele}",
            f"  nnz_ex: {s.nnz_ex}",
            "}",
        ]
    lines.append(f"num_ex: {info.num_ex}")
    return "\n".join(lines) + "\n"
