"""Encoded host-to-device wires: the host encoders and the upload cache.

Counterpart of the exact, stream and staging parts of
``parameter_server_tpu/learner/wire.py``. The prep stage emits encoded
batch buffers, the step decodes them on the card (``ops/wire_codec.py``)
and only the encoded bytes cross PCIe:

- :func:`encode_exact`: a ``PreppedBatch`` on the compact exact wire.
  ``ucols`` bit-packed at ceil(log2 U) bits; the sorted ``uslots`` as a
  u16 gap stream (or packed words where a gap does not fit); the mask
  as a live-row count, the COO rows as features a row, binary values
  elided, ±1 labels as sign bits. Each elision is checked on the batch;
  outside its domain the encoder returns None and the raw wire ships.
  ``"exact"`` is lossless; ``"int8"``/``"u16"``/``"bf16"`` also narrow a
  valued batch's values. The encoders are copies of the JAX package's
  and give its bytes.
- the stream wire (:func:`derive_stream_statics`,
  :func:`encode_stream_shard`): lanes of small vocabulary ship a sorted
  table a lane plus packed codes, the others raw bits; the statics are
  derived once, from the first batch.
- :class:`UploadCache`: a leaf whose bytes the card already holds is not
  copied again (a CRC32C signature routes, a byte compare decides).
- :func:`compress_batch` / :func:`decompress_batch`: the LZ frames of
  the staging leg (``wire_compress="lz"``), made on the prep pool and
  decoded on the uploader's thread.
- :func:`wire_filter_specs` and :class:`MessageWireCodec`: the host
  message filter chain of the reference's working order (key caching,
  fixed-point, compression) over a key array and its value arrays, one
  stateful chain a direction.

The encoders are stateless (they run on the prep pool); the cache is
single-owner (the uploader's thread).

The ``ps_wire_*`` counters (:func:`wire_instruments`) record each
encode's time and bytes, the bytes the encodings, the upload cache and
the LZ frames save, and the cache's hits and misses; with a span sink
installed an exact-wire encode is one ``wire.encode`` span.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..filter.fixing_float import quantize
from ..ops import wire_codec as wc
from ..ops.kv_ops import slot_sentinel
from ..utils import codec, crc32c
from ..utils.bitpack import pack_bits, packed_nwords, slot_bits, stream_to_words
from ..system.message import FilterSpec, Message, Task
from ..utils.murmur import hash_slots

MAX_SIG_LEN = 2048  # bytes of a leaf's signature (the key-caching filter's budget)
_QUANT_MODES = {"int8": (np.uint8, 1), "u16": (np.uint16, 2)}
WIRE_ENCODE_MODES = ("", "exact", "int8", "u16", "bf16")


def static(default):
    """A dataclass field that is a shape parameter of the batch, not an
    array to upload."""
    return dataclasses.field(default=default, metadata=dict(static=True))


def array_fields(batch) -> List[str]:
    """The names of a batch's array fields that hold arrays (static
    fields and ``None`` left out): what an upload copies."""
    return [f.name for f in dataclasses.fields(batch)
            if not f.metadata.get("static") and getattr(batch, f.name) is not None]


def replace_arrays(batch, arrays: dict):
    """A copy of ``batch`` with the given array fields replaced."""
    return dataclasses.replace(batch, **arrays)


def wire_instruments():
    """ps_wire_* instruments against the process registry, or None while
    telemetry is disabled (cached per registry: the encode runs once a
    batch on every prep-pool worker)."""
    from ..telemetry.instruments import cached_wire_instruments

    return cached_wire_instruments()


def batch_nbytes(batch) -> int:
    """Bytes of a batch's arrays: what crosses the link uploaded whole."""
    return int(sum(getattr(batch, n).nbytes for n in array_fields(batch)))


def tree_nbytes(tree) -> int:
    """Host bytes of a (possibly encoded) batch, or of a list, tuple or
    dict of them: what would cross the link uploaded as it is. A batch
    counts its array fields (:func:`batch_nbytes`); a bare array its
    bytes; anything else nothing."""
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(tree_nbytes(t) for t in tree.values())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return batch_nbytes(tree)
    return int(getattr(tree, "nbytes", 0))


# -- the compact exact wire --


@dataclasses.dataclass
class EncodedExactBatch:
    """A PreppedBatch on the compact wire (arrays [D, ...] per data
    shard). ``y``: sign bits (uint8 [D, ceil(R/8)]) when ``y_sign``,
    else float32 [D, R]; ``uslots``: u16 gaps when ``uslots_delta``,
    else uint32 words; ``vals``: None for binary batches, f32, u8/u16
    codes with ``vals_lo``/``vals_hi``, or bf16 (its uint16 bits)."""

    y: np.ndarray
    counts: np.ndarray  # [D] int32 live rows
    row_counts: np.ndarray  # [D, R] u8/u16 features a row
    nnz: np.ndarray  # [D] int32 live COO entries
    ucols_words: np.ndarray  # [D, W] uint32
    uslots: np.ndarray
    n_uniq: np.ndarray  # [D] int32
    vals: Optional[np.ndarray]
    vals_lo: Optional[np.ndarray]
    vals_hi: Optional[np.ndarray]
    rows_pad: int = static(0)
    nnz_pad: int = static(0)
    uniq_pad: int = static(0)
    ucols_bits: int = static(0)
    uslots_bits: int = static(0)
    y_sign: bool = static(False)
    uslots_delta: bool = static(True)
    vals_mode: str = static("binary")

    @property
    def num_examples(self) -> int:
        return int(self.counts.sum())

    def static_key(self) -> tuple:
        return (self.rows_pad, self.nnz_pad, self.uniq_pad, self.ucols_bits,
                self.uslots_bits, self.y_sign, self.uslots_delta, self.vals_mode)


@dataclasses.dataclass
class EncodedExactSuperBatch(EncodedExactBatch):
    """T stacked EncodedExactBatches (arrays [T, D, ...]): one
    submission decodes and runs T ministeps."""

    @property
    def steps(self) -> int:
        return int(self.counts.shape[0])


def stack_encoded_batches(parts: List[EncodedExactBatch]) -> EncodedExactSuperBatch:
    """Stack T encoded minibatches; their statics must agree."""
    if not parts:
        raise ValueError("empty superbatch")
    key = parts[0].static_key()
    if any(p.static_key() != key for p in parts):
        raise ValueError("encoded superbatch needs uniform static encoding parameters")
    fields = {f.name: (getattr(parts[0], f.name) if f.metadata.get("static") else
                       None if getattr(parts[0], f.name) is None else
                       np.stack([getattr(p, f.name) for p in parts]))
              for f in dataclasses.fields(EncodedExactBatch)}
    return EncodedExactSuperBatch(**fields)


def _derived_nnz(p) -> np.ndarray:
    """Live COO entries a shard: one past the last entry where rows,
    ucols or vals is nonzero (prep zero-pads all three)."""
    live = (np.asarray(p.rows) != 0) | (np.asarray(p.ucols) != 0) | (np.asarray(p.vals) != 0)
    nz = p.rows.shape[1]
    rev = live[:, ::-1]
    return np.where(rev.any(axis=1), nz - rev.argmax(axis=1), 0).astype(np.int32)


def _quantize_vals(vals: np.ndarray, nnz: np.ndarray, mode: str):
    """Fixed-point codes of each shard's live values, the rounding
    seeded from the shard's own bytes (so any prep worker, in any order,
    gives the same codes)."""
    dt, num_bytes = _QUANT_MODES[mode]
    q = np.zeros(vals.shape, dtype=dt)
    lo = np.zeros(vals.shape[0], np.float32)
    hi = np.ones(vals.shape[0], np.float32)
    for d in range(vals.shape[0]):
        n = int(nnz[d])
        if n == 0:
            continue
        rng = np.random.default_rng(crc32c.value(vals[d, :n].tobytes()))
        q[d, :n], lo[d], hi[d] = quantize(vals[d, :n], num_bytes, rng)
    return q, lo, hi


def _bf16_bits(vals: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest even), as uint16 bits."""
    return torch.from_numpy(np.ascontiguousarray(vals)).to(torch.bfloat16) \
        .view(torch.int16).numpy().view(np.uint16)


def encode_exact(prepped, num_slots: int, mode: str = "exact") -> Optional[EncodedExactBatch]:
    """A PreppedBatch on the compact wire, or None where the batch lies
    outside an encoding's domain (the raw wire ships). With a span sink
    installed the encode is one ``wire.encode`` span carrying the active
    flow id."""
    from ..telemetry import spans as telemetry_spans

    if telemetry_spans.get_sink() is None:
        return _encode_exact_impl(prepped, num_slots, mode)
    with telemetry_spans.span("wire.encode", mode=mode):
        return _encode_exact_impl(prepped, num_slots, mode)


def _encode_exact_impl(prepped, num_slots: int, mode: str) -> Optional[EncodedExactBatch]:
    from ..apps.linear.async_sgd import PreppedBatch

    if not isinstance(prepped, PreppedBatch):
        return None
    if mode not in WIRE_ENCODE_MODES or mode == "":
        raise ValueError(f"unknown wire_encode mode {mode!r}; expected one of "
                         f"{WIRE_ENCODE_MODES[1:]}")
    tel = wire_instruments()
    t0 = time.perf_counter()
    y, mask, rows, ucols, vals, uslots, umask = (
        np.asarray(getattr(prepped, n)) for n in
        ("y", "mask", "rows", "ucols", "vals", "uslots", "umask"))
    d_shards, rows_pad = y.shape
    nnz_pad = rows.shape[1]
    uniq_pad = uslots.shape[1]
    sentinel = slot_sentinel(num_slots)

    counts = mask.sum(axis=1).astype(np.int32)
    if not (mask == (np.arange(rows_pad) < counts[:, None])).all():
        return None
    n_uniq = umask.sum(axis=1).astype(np.int32)
    if not (umask == (np.arange(uniq_pad) < n_uniq[:, None])).all():
        return None
    nnz = _derived_nnz(prepped)
    live = np.arange(nnz_pad) < nnz[:, None]
    row_counts = np.zeros((d_shards, rows_pad), np.int64)
    for d in range(d_shards):
        if nnz[d] and rows[d, : nnz[d]].min() < 0:
            return None
        rc = np.bincount(rows[d, : nnz[d]], minlength=rows_pad)
        if rc.size > rows_pad:
            return None
        row_counts[d, : rc.size] = rc
        if not (rows[d, : nnz[d]] == np.repeat(np.arange(rows_pad), row_counts[d])).all():
            return None
    rc_dtype = np.uint8 if row_counts.max(initial=0) < 256 else np.uint16
    if row_counts.max(initial=0) >= (1 << 16):
        return None

    ucols_bits = slot_bits(uniq_pad)
    if (ucols < 0).any() or (ucols >= uniq_pad).any():
        return None
    if (~live & (ucols != 0)).any():
        return None
    ucols_words = np.stack([stream_to_words(pack_bits(ucols[d], ucols_bits), nnz_pad, ucols_bits)
                            for d in range(d_shards)])

    if sentinel < 0 or num_slots >= (1 << 31):
        return None  # 2^31 tables use the -1 sentinel: the raw wire
    uslots_bits = slot_bits(num_slots, sentinel=True)
    ok_sorted = True
    deltas = np.zeros((d_shards, uniq_pad), np.int64)
    for d in range(d_shards):
        u = n_uniq[d]
        seg = uslots[d, :u].astype(np.int64)
        if (uslots[d, u:] != sentinel).any():
            return None
        if (seg < 0).any() or (seg >= num_slots).any():
            return None
        if u and ok_sorted:
            dd = np.diff(seg, prepend=0)
            if (dd[1:] <= 0).any() or dd.max(initial=0) >= (1 << 16):
                ok_sorted = False
            else:
                deltas[d, :u] = dd
    if ok_sorted:
        uslots_enc, uslots_delta = deltas.astype(np.uint16), True
    else:
        uslots_enc = np.stack([stream_to_words(pack_bits(uslots[d], uslots_bits), uniq_pad,
                                               uslots_bits) for d in range(d_shards)])
        uslots_delta = False

    y_sign = bool((np.abs(y) == mask).all())
    y_enc = np.stack([np.packbits(y[d] > 0, bitorder="little") for d in range(d_shards)]) \
        if y_sign else y

    vals_lo = vals_hi = None
    if bool((vals == live.astype(np.float32)).all()):
        vals_enc, vals_mode = None, "binary"
    elif mode == "exact":
        vals_enc, vals_mode = vals, "f32"
    elif mode == "bf16":
        vals_enc, vals_mode = _bf16_bits(vals), "bf16"
    else:
        vals_enc, vals_lo, vals_hi = _quantize_vals(vals, nnz, mode)
        vals_mode = mode
    out = EncodedExactBatch(
        y=y_enc, counts=counts, row_counts=row_counts.astype(rc_dtype), nnz=nnz,
        ucols_words=ucols_words, uslots=uslots_enc, n_uniq=n_uniq, vals=vals_enc,
        vals_lo=vals_lo, vals_hi=vals_hi, rows_pad=rows_pad, nnz_pad=nnz_pad,
        uniq_pad=uniq_pad, ucols_bits=ucols_bits, uslots_bits=uslots_bits, y_sign=y_sign,
        uslots_delta=uslots_delta, vals_mode=vals_mode,
    )
    if tel is not None:
        enc_b, raw_b = batch_nbytes(out), batch_nbytes(prepped)
        tel["encode_seconds"].observe(time.perf_counter() - t0)
        tel["bytes"].labels(encoding=mode).inc(enc_b)
        tel["saved_bytes"].labels(reason="encoding").inc(max(0, raw_b - enc_b))
    return out


def _leaf(enc, name: str, index):
    v = getattr(enc, name)
    return None if v is None else v[index]


def decode_exact_shard(enc, num_slots: int, index=0) -> Tuple[torch.Tensor, ...]:
    """One data shard of an encoded batch (tensors, on their device) ->
    ``(y, mask, rows, ucols, vals, uslots, umask)`` of the raw wire.
    ``index``: the shard, or ``(t, shard)`` of a superbatch."""
    y_e, count, row_counts, nnz, ucw, usl, n_uniq, vals, vlo, vhi = (
        _leaf(enc, n, index) for n in ("y", "counts", "row_counts", "nnz", "ucols_words",
                                       "uslots", "n_uniq", "vals", "vals_lo", "vals_hi"))
    y = wc.decode_sign_labels(y_e, count, enc.rows_pad) if enc.y_sign else y_e
    mask = wc.decode_mask(count, enc.rows_pad)
    rows = wc.decode_row_ids(row_counts, nnz, enc.nnz_pad)
    ucols = wc.decode_bitstream(ucw, enc.nnz_pad, enc.ucols_bits)
    ucols = torch.where(torch.arange(enc.nnz_pad, device=ucols.device) < nnz, ucols, 0)
    if enc.uslots_delta:
        uslots = wc.decode_sorted_deltas(usl, n_uniq, slot_sentinel(num_slots))
    else:
        uslots = wc.decode_bitstream(usl, enc.uniq_pad, enc.uslots_bits)
    umask = wc.decode_mask(n_uniq, enc.uniq_pad)
    if enc.vals_mode == "binary":
        v = wc.decode_binary_vals(nnz, enc.nnz_pad)
    elif enc.vals_mode == "f32":
        v = vals
    elif enc.vals_mode == "bf16":
        v = wc.decode_bf16(vals)
    else:
        # past nnz a dequantized zero code is not 0.0: mask it back
        v = torch.where(torch.arange(enc.nnz_pad, device=nnz.device) < nnz,
                        wc.decode_fixed_point(vals, vlo, vhi, _QUANT_MODES[enc.vals_mode][1]),
                        0.0)
    return y, mask, rows, ucols, v, uslots, umask


def as_tensors(batch, device="cpu"):
    """A batch with its numpy arrays as tensors (uint32 and uint16 as
    their int32 and int16 views, which every decoder takes)."""
    def tensor(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype == np.uint16:
            a = a.view(np.int16)
        if not a.flags.writeable:  # a decoded frame's buffer
            a = a.copy()
        return torch.from_numpy(a).to(device)

    return replace_arrays(batch, {n: tensor(getattr(batch, n)) for n in array_fields(batch)})


def decode_exact_host(enc: EncodedExactBatch, num_slots: int) -> tuple:
    """Every shard decoded on the CPU, stacked like the raw
    PreppedBatch's ``(y, mask, rows, ucols, vals, uslots, umask)``."""
    if isinstance(enc, EncodedExactSuperBatch):
        raise ValueError("the host decode takes one minibatch; index T first")
    t = as_tensors(enc)
    parts = [tuple(x.numpy() for x in decode_exact_shard(t, num_slots, d))
             for d in range(enc.counts.shape[0])]
    return tuple(np.stack(x) for x in zip(*parts))


# -- the stream-once lane-dictionary wire --


@dataclasses.dataclass
class EncodedEllStreamBatch:
    """An ELL batch on the lane-dictionary wire (arrays [D, ...]):
    ``raw_words`` the raw lanes' bits row by row, ``code_words`` the
    dictionary lanes' codes, ``table_words`` the lanes' sorted tables,
    ``lane_starts`` their offsets."""

    y_bits: np.ndarray
    counts: np.ndarray
    raw_words: np.ndarray
    code_words: np.ndarray
    table_words: np.ndarray
    lane_starts: np.ndarray
    n_uniq: np.ndarray
    rows: int = static(0)
    lanes: int = static(0)
    dict_lanes: tuple = static(())
    code_bits: int = static(0)
    dict_pad: int = static(0)
    raw_bits: int = static(0)

    @property
    def num_examples(self) -> int:
        return int(self.counts.sum())

    def static_key(self) -> tuple:
        return (self.rows, self.lanes, self.dict_lanes, self.code_bits, self.dict_pad,
                self.raw_bits)


@dataclasses.dataclass
class EncodedEllStreamSuperBatch(EncodedEllStreamBatch):
    """T stacked stream-wire minibatches (arrays [T, D, ...])."""

    @property
    def steps(self) -> int:
        return int(self.counts.shape[0])


_STREAM_ARRAYS = ("y_bits", "counts", "raw_words", "code_words", "table_words",
                  "lane_starts", "n_uniq")


def stack_stream_batches(parts: List[EncodedEllStreamBatch]) -> EncodedEllStreamSuperBatch:
    if not parts:
        raise ValueError("empty superbatch")
    key = parts[0].static_key()
    if any(p.static_key() != key for p in parts):
        raise ValueError("stream superbatch needs uniform static encoding parameters")
    p0 = parts[0]
    return EncodedEllStreamSuperBatch(
        **{f: np.stack([getattr(p, f) for p in parts]) for f in _STREAM_ARRAYS},
        rows=p0.rows, lanes=p0.lanes, dict_lanes=p0.dict_lanes, code_bits=p0.code_bits,
        dict_pad=p0.dict_pad, raw_bits=p0.raw_bits,
    )


@dataclasses.dataclass(frozen=True)
class StreamStatics:
    """The stream wire's fixed parameters, derived from the first batch."""

    lanes: int
    dict_lanes: tuple
    code_bits: int
    dict_pad: int
    raw_bits: int


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(max(1, n)) - 1).bit_length()


def _lane_code_bits(n_uniq: int) -> int:
    """A lane's code width: its vocabulary plus 25%, to a power of two."""
    return max(1, (_pow2ceil(n_uniq + (n_uniq >> 2)) - 1).bit_length())


def derive_stream_statics(keys: np.ndarray, lanes: int, hash_num_slots: int,
                          num_slots: int) -> Optional[StreamStatics]:
    """The statics from one batch's keys (uniform rows of ``lanes``), or
    None where no lane's dictionary wins over its raw bits. A lane takes
    the dictionary when its codes save more bits than its padded table
    costs; the whole split must also win at the shared code width."""
    k = np.ascontiguousarray(keys, dtype=np.uint64).ravel()
    if lanes <= 0 or k.size == 0 or k.size % lanes:
        return None
    raw_bits = slot_bits(num_slots)
    cols = hash_slots(k, hash_num_slots).reshape(-1, lanes)
    n_rows = cols.shape[0]
    lane_u = [int(len(np.unique(cols[:, j]))) for j in range(lanes)]
    dict_lanes = tuple(
        j for j in range(lanes)
        if n_rows * (raw_bits - _lane_code_bits(lane_u[j]))
        > _pow2ceil(lane_u[j] + (lane_u[j] >> 2)) * raw_bits
    )
    if not dict_lanes:
        return None
    code_bits = max(_lane_code_bits(lane_u[j]) for j in dict_lanes)
    total = sum(lane_u[j] for j in dict_lanes)
    dict_pad = _pow2ceil(total + (total >> 2))
    saved_bits = n_rows * len(dict_lanes) * (raw_bits - code_bits)
    if saved_bits <= dict_pad * raw_bits + 32 * len(dict_lanes):
        return None
    return StreamStatics(lanes=lanes, dict_lanes=dict_lanes, code_bits=code_bits,
                         dict_pad=dict_pad, raw_bits=raw_bits)


def encode_stream_shard_ref(slots: np.ndarray, nsub: int, rows_pad: int, st: StreamStatics):
    """The plain numpy encode of one shard's slot matrix (the native
    ``ps_stream_encode``'s reference): ``(raw_words, code_words,
    table_words, lane_starts, n_uniq)``, or None outside the statics."""
    n_dict = len(st.dict_lanes)
    n_raw = st.lanes - n_dict
    cols = slots.reshape(nsub, st.lanes)
    dict_set = frozenset(st.dict_lanes)
    raw_lanes = [j for j in range(st.lanes) if j not in dict_set]
    tables = []
    lane_starts = np.zeros(n_dict, np.int32)
    codes = np.empty((nsub, n_dict), np.int32)
    total = 0
    for i, j in enumerate(st.dict_lanes):
        u, inv = np.unique(cols[:, j], return_inverse=True)
        if len(u) > (1 << st.code_bits) or total + len(u) > st.dict_pad:
            return None
        lane_starts[i] = total
        total += len(u)
        tables.append(u.astype(np.int32, copy=False))
        codes[:, i] = inv.reshape(-1)
    raw_vals = cols[:, raw_lanes].reshape(-1) if n_raw else np.zeros(0, np.int32)
    table_vals = np.concatenate(tables) if tables else np.zeros(0, np.int32)
    return (
        stream_to_words(pack_bits(raw_vals, st.raw_bits), rows_pad * n_raw, st.raw_bits),
        stream_to_words(pack_bits(codes.reshape(-1), st.code_bits), rows_pad * n_dict,
                        st.code_bits),
        stream_to_words(pack_bits(table_vals, st.raw_bits), st.dict_pad, st.raw_bits),
        lane_starts, np.int32(total),
    )


def encode_stream_shard(keys: np.ndarray, nsub: int, rows_pad: int, hash_num_slots: int,
                        st: StreamStatics, seed: int = 0):
    """Hash -> per-lane unique -> remap -> pack over one shard's keys in
    one native pass (``ps_stream_encode``); below 4096 keys the plain
    numpy encode, which gives the same bytes. Returns ``(raw_words,
    code_words, table_words, lane_starts, n_uniq)``, or None where the
    shard does not fit the statics."""
    import ctypes

    k = np.ascontiguousarray(keys, dtype=np.uint64).ravel()
    if k.size != nsub * st.lanes:
        raise ValueError(f"{k.size} keys for {nsub} rows of {st.lanes} lanes")
    if k.size < 4096:
        return encode_stream_shard_ref(hash_slots(k, hash_num_slots, seed), nsub, rows_pad, st)
    n_dict = len(st.dict_lanes)
    n_raw = st.lanes - n_dict
    dict_mask = np.zeros(st.lanes, np.uint8)
    dict_mask[list(st.dict_lanes)] = 1
    # zeroed whole buffers: the packers write only the live prefix
    raw_buf = np.zeros(packed_nwords(rows_pad * n_raw, st.raw_bits) * 4, np.uint8)
    code_buf = np.zeros(packed_nwords(rows_pad * n_dict, st.code_bits) * 4, np.uint8)
    table_buf = np.zeros(packed_nwords(st.dict_pad, st.raw_bits) * 4, np.uint8)
    starts = np.zeros(n_dict + 1, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    got = native.library().ps_stream_encode(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), nsub, st.lanes, seed,
        hash_num_slots, dict_mask.ctypes.data_as(u8p), st.raw_bits, st.code_bits,
        st.dict_pad, starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        raw_buf.ctypes.data_as(u8p), code_buf.ctypes.data_as(u8p),
        table_buf.ctypes.data_as(u8p),
    )
    if got < 0:
        return None
    return (raw_buf.view("<u4"), code_buf.view("<u4"), table_buf.view("<u4"),
            starts[:n_dict].copy(), np.int32(got))


def decode_stream_shard(enc, index=0, order=None):
    """One shard of a stream-wire batch (tensors) -> ``(y, mask,
    slots[rows, lanes])``; ``order`` as ``wire_codec.decode_stream_slots``
    takes it."""
    y = wc.decode_sign_labels(enc.y_bits[index], enc.counts[index], enc.rows)
    mask = wc.decode_mask(enc.counts[index], enc.rows)
    slots = wc.decode_stream_slots(
        enc.raw_words[index], enc.code_words[index], enc.table_words[index],
        enc.lane_starts[index], rows=enc.rows, lanes=enc.lanes, dict_lanes=enc.dict_lanes,
        code_bits=enc.code_bits, dict_pad=enc.dict_pad, raw_bits=enc.raw_bits, order=order,
    )
    return y, mask, slots


# -- the upload key cache --


class UploadCache:
    """Key caching on the host-to-device leg: an array leaf whose bytes
    the card already holds reuses that device tensor. A leaf is found by
    its CRC32C signature, shape and dtype, and reused only if its bytes
    equal the retained host copy. Least recently used leaves go first
    once the retained bytes pass ``max_bytes``; leaves under
    ``min_leaf_bytes`` always upload.

    ``upload(batch)`` uploads a batch whose arrays are only the leaves
    that missed; the cache fills in the rest and carries ``ready`` over.
    Single-owner: the first calling thread owns it, any other raises."""

    def __init__(self, upload: Callable, max_bytes: int = 64 << 20,
                 min_leaf_bytes: int = 4096):
        self._upload = upload
        self._max_bytes = int(max_bytes)
        self._min_leaf_bytes = int(min_leaf_bytes)
        self._cache: "OrderedDict[tuple, list]" = OrderedDict()
        self._bytes = 0
        self._owner: Optional[int] = None
        self.hits = 0
        self.misses = 0
        self.saved_bytes = 0
        self._tel = wire_instruments()

    def _assert_owner(self) -> None:
        me = threading.get_ident()
        if self._owner is None:
            self._owner = me
        elif self._owner != me:
            raise RuntimeError(f"UploadCache is single-owner (thread {self._owner}); "
                               f"called from {me}")

    @staticmethod
    def _sig(arr: np.ndarray) -> tuple:
        return crc32c.array_signature(arr, MAX_SIG_LEN), arr.shape, arr.dtype.str

    def __call__(self, batch):
        self._assert_owner()
        batch = maybe_decompress(batch)
        hits, misses = {}, {}
        for name in array_fields(batch):
            arr = np.ascontiguousarray(getattr(batch, name))
            if arr.nbytes < self._min_leaf_bytes:
                misses[name] = (arr, None)
                continue
            sig = self._sig(arr)
            entry = self._cache.get(sig)
            if entry is not None and np.array_equal(entry[0], arr):
                self._cache.move_to_end(sig)
                self.hits += 1
                self.saved_bytes += arr.nbytes
                hits[name] = entry[1]
                if self._tel is not None:
                    self._tel["cache_hits"].inc()
                    self._tel["saved_bytes"].labels(reason="cache_hit").inc(arr.nbytes)
            else:
                self.misses += 1
                misses[name] = (arr, sig)
                if self._tel is not None:
                    self._tel["cache_misses"].inc()
        blank = {f.name: None for f in dataclasses.fields(batch) if not f.metadata.get("static")}
        staged = self._upload(replace_arrays(batch, {**blank, **{n: a for n, (a, _) in misses.items()}}))
        for name, (arr, sig) in misses.items():
            if sig is None:
                continue
            dev = getattr(staged, name)
            old = self._cache.pop(sig, None)
            if old is not None:
                self._bytes -= old[0].nbytes
            self._cache[sig] = [arr.copy(), dev]
            self._bytes += arr.nbytes
            while self._bytes > self._max_bytes and len(self._cache) > 1:
                _, (gone, _dev) = self._cache.popitem(last=False)
                self._bytes -= gone.nbytes
        out = replace_arrays(staged, hits)
        ready = getattr(staged, "ready", None)
        if ready is not None:
            out.ready = ready
        return out

    @property
    def hit_share(self) -> float:
        return self.hits / max(1, self.hits + self.misses)


# -- LZ frames on the staging leg --


class CompressedBatch:
    """A prepped batch with its arrays in codec frames (the staging leg
    from the prep pool to the uploader); :func:`decompress_batch`
    restores it bit for bit. ``encoding`` names the wire it carries
    (``raw``, ``bits``, ``exact``, ``stream``; empty when not given)."""

    __slots__ = ("frames", "meta", "template", "n", "raw_nbytes", "wire_nbytes", "encoding")

    def __init__(self, frames, meta, template, n, raw_nbytes, wire_nbytes, encoding=""):
        self.frames = frames  # name -> frame
        self.meta = meta  # name -> (dtype str, shape)
        self.template = template  # the batch with its arrays set to None
        self.n = n
        self.raw_nbytes = raw_nbytes
        self.wire_nbytes = wire_nbytes
        self.encoding = encoding

    @property
    def num_examples(self) -> int:
        return int(self.n)


def compress_batch(prepped, encoding: str = "") -> CompressedBatch:
    """Each array of a prepped batch in one LZ frame (stateless: runs on
    the prep pool). An incompressible array rides raw in its frame. With
    ``encoding`` (the wire's name) the staged bytes count under
    ``ps_wire_bytes_total{encoding="<name>+lz"}``."""
    frames, meta = {}, {}
    raw = wire = 0
    for name in array_fields(prepped):
        arr = np.ascontiguousarray(getattr(prepped, name))
        frames[name] = codec.compress(arr.tobytes())
        meta[name] = (arr.dtype.str, arr.shape)
        raw += arr.nbytes
        wire += len(frames[name])
    template = replace_arrays(prepped, {n: None for n in frames})
    tel = wire_instruments()
    if tel is not None:
        if encoding:
            tel["bytes"].labels(encoding=f"{encoding}+lz").inc(wire)
        tel["saved_bytes"].labels(reason="compression").inc(max(0, raw - wire))
    return CompressedBatch(frames, meta, template, getattr(prepped, "num_examples", 0), raw, wire,
                           encoding)


def decompress_batch(cb: CompressedBatch):
    arrays = {}
    for name, frame in cb.frames.items():
        dtype, shape = cb.meta[name]
        dt = np.dtype(dtype)
        raw = codec.decompress(frame, expected_size=dt.itemsize * int(np.prod(shape, dtype=np.int64)))
        arrays[name] = np.frombuffer(raw, dtype=dt).reshape(shape)
    return replace_arrays(cb.template, arrays)


def maybe_decompress(item):
    return decompress_batch(item) if isinstance(item, CompressedBatch) else item


# -- the host message filter chain --


def wire_filter_specs(num_bytes: int = 0) -> List[FilterSpec]:
    """The chain in the reference's working order (the example and CTR
    confs; ``Van::Send`` applies it in list order, ``Recv`` in reverse):
    key caching, then fixed-point (``num_bytes`` 0 turns it off), then
    compression. Values are quantized before the byte codec sees them
    (the codec emits uint8 frames, which fixing_float would pass)."""
    return [
        FilterSpec(type="key_caching"),
        FilterSpec(type="fixing_float", num_bytes=num_bytes),
        FilterSpec(type="compressing"),
    ]


class MessageWireCodec:
    """The host filter chain over a batch's keys and values, as the JAX
    package's: one stateful chain a direction (ref RemoteNode), so a key
    array sent again crosses as its signature only."""

    def __init__(self, num_bytes: int = 0, channel: int = 0):
        from ..filter.base import FilterChain

        self._encode_chain = FilterChain()
        self._decode_chain = FilterChain()
        self._num_bytes = num_bytes
        self._channel = channel

    def encode(self, key: Optional[np.ndarray], values: List[np.ndarray]) -> Message:
        msg = Message(task=Task(key_channel=self._channel))
        msg.task.filters = wire_filter_specs(self._num_bytes)
        msg.key = key
        msg.values = list(values)
        return self._encode_chain.encode(msg)

    def decode(self, msg: Message) -> Tuple[Optional[np.ndarray], List[np.ndarray]]:
        out = self._decode_chain.decode(msg)
        return out.key, list(out.values)
