"""Online sparse logistic regression with FTRL — the main path.

Counterpart of ``parameter_server_tpu/apps/linear/async_sgd.py`` on one
device. The host preps each minibatch exactly as the JAX worker does
(same numpy arrays, same padding); a step then pulls the weights of the
batch's slots, computes Xw and the row gradient with segment sums
(deterministic: ``ops/segment_sum.py``, a CUDA kernel on the card), and
runs the FTRL update: ``update="sparse"`` through the fused sparse
kernel over the batch's deduplicated slots, ``update="dense"`` through
the whole-table kernel. With one data shard and one server shard every
collective of the JAX step is the identity.

**Over a mesh** (``AsyncSGDWorker(conf, mesh=...)``, or the started
postoffice's mesh; ``parallel/mesh.py``): one rank a ``(data, server)``
position, every rank running this same program on the same stream. Rank
``(d, s)`` holds server shard ``s`` of the state and keeps data row
``d`` of each prepped minibatch, and the JAX step's collectives run one
for one: the pulled weights are assembled with ``psum`` over the server
axis; the sparse update's per-unique-slot gradient, or the dense
update's shard gradient (through the push wire, the FIXING_FLOAT filter
quantizing each data rank's own contribution with seed ``seed * 1000003
+ d``), is summed with ``psum`` over the data axis. The metrics fold as
the JAX step folds them (objective and counts over data; the pushed
gradient's norm over server then data; the update's over server and the
weights' over data on the dense route), the scalars of each axis packed
into one tensor and one collective a launch, the per-example aux
all-gathered over data. Every wire and feature runs over a mesh: the
exact wire, raw or encoded (sparse update), the hashed wire and the ELL
wires (i32, u24, bits and stream, one launch or a ``steps_per_launch``
scan; dense update), the neighbour replica, the KKT filter (its z
assembled over the server axis like the weights) and adaptive τ. Every
rank preps the global minibatch, so it makes the encode decision on the
global batch and keeps its own data row, and the stream wire's lane
split, derived from the first batch of the common stream, is checked to
agree over the data axis on the first step. With the host drop set,
the encoded wire or adaptive τ, each launch's host decisions (the wire
and its encoding, τ and the snapshot, the drop set's version and
digest, a requested reaction) are agreed over the mesh on the dispatch
thread, in step order (``parallel/distributed.agree_on``): a
disagreement raises on every rank at that launch, and a launch whose
decisions changed holds its batch to the row again.

The dense update carries the filtered wire of the reference's confs:
a FIXING_FLOAT push filter quantizes the shard gradient to 1 or 2 bytes
(``ops/quantize.py``, a CUDA kernel on the card) and hands the update an
explicit ``touched`` mask; a FIXING_FLOAT pull filter quantizes the
derived weights; ADD_NOISE perturbs either side. Bounded delay τ > 0
computes gradients on a weight snapshot refreshed every τ ministeps.

The rest of the JAX step is here too. The KKT filter
(``ops/significance.py``) sits between push and update in the sparse
step and leaves suppressed rows bit-untouched; adaptive τ
(``learner/consistency.py``) moves the live bounded delay under the
configured cap. The encoded wires ship only encoded bytes and decode on
the step's device: the compact exact wire (``wire_encode``), and with
``ell_lanes`` the ELL wires (i32, u24, bits, stream), whose gradient
scatter is the same stable sort and segment-sum kernel as the hashed
step's, so their state is bit-identical to it.

The host side runs as the JAX worker's does. The worker is an
``ISGDCompNode`` (``learner/sgd.py``): a ``Customer`` whose executor's
dispatch thread runs the steps, at most τ + 1 in flight; seeds and the
snapshot schedule are fixed on the submitting thread, in submission
order, so every path gives the same trajectory.
``train(pipelined=True)`` (the default for T > 1) reads and filters on a
feeder thread, preps on an ordered pool of workers and uploads on a
:class:`DeviceUploader` thread: host arrays are copied into pinned
staging buffers and sent on a side CUDA stream, which the step's stream
waits on. The pipelined state is bit-identical to the serial one.

Telemetry, as in the JAX worker (all decided at construction while
``telemetry.registry.enabled()``): each step builder's variants
(``<name>.snap``, ``.snap_donate``, ``.delay``) are entry points of the
device inventory (``telemetry/device.py``), the FTRL update path and
rows a ministep count in ``ps_ftrl_*``, collected examples in
``app_examples_total``, and the learning plane (``telemetry/learning.py``)
folds realized staleness, key heat (on :class:`KeyHeatFeed` threads, off
the feeder's path) and the steps' convergence side outputs; the uploader
stage counts its batches, examples and bytes and carries each batch's
flow id to its step.

The ongoing server replica (``num_replicas > 0``): every
``replica_every`` ministeps the step copies the state into a replica,
on the executor after the update, on the step's stream (the FTRL
kernels update ``z`` and √n in place, so the replica is a copy, never an
alias). The JAX worker rolls the table by a shard's width, so server
shard ``s``'s copy lives on shard ``s + 1``; on a mesh each rank sends
its shard to its server neighbour (``parallel/mesh.py::shift``, a ring
over the server group on the dispatch thread, in step order) and keeps
the copy of shard ``s - 1``. With one server shard the roll is the
identity, so the mirror is the whole state.
:meth:`AsyncSGDWorker.wipe_server_shard` zeroes a shard's rows (a
replacement that starts empty) and
:meth:`AsyncSGDWorker.recover_server_shard` restores them from the
replica, at most ``replica_every`` ministeps stale (on a mesh the
neighbour sends its copy back, and the shard's ranks install it); both
run through the executor, in order with the steps, and on a mesh every
rank calls them.

:class:`AsyncSGDScheduler` is the JAX package's scheduler: the workload
pool and the monitor that prints the progress table. Attached to it
(:meth:`AsyncSGDWorker.attach_monitor`), the worker reports each
collect's progress, on the collecting thread, once the step's metrics
are on the host; the step itself does not change.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve
from ...convert import shard_state, state_from_jax, state_to_numpy
from ...learner import wire
from ...learner.consistency import ConsistencyRuntime
from ...learner.ingest import IngestPipeline
from ...learner.sgd import ISGDCompNode, ISGDScheduler, SGDProgress
from ...parallel import distributed as pdist
from ...parallel import mesh as meshlib
from ...parallel.mesh import DATA_AXIS, SERVER_AXIS, psum
from ...ops import quantize as qops
from ...ops import wire_codec as wc
from ...ops.ftrl_sparse import resolve_update_path
from ...ops.kv_ops import localize, slot_sentinel, valid_slots
from ...ops.significance import SignificanceSpec, kkt_mask
from ...ops.segment_sum import segment_sum as _segment_sum
from ...parameter.parameter import KeyDirectory, pad_slots, server_shard_rows
from ...telemetry import device as device_tel
from ...telemetry import registry as telemetry_registry
from ...telemetry import spans as telemetry_spans
from ...utils import evaluation
from ...utils import file as psfile
from ...utils.bitpack import (
    hash_slots_packed,
    packed_nwords,
    slot_bits,
    unpack_bits,
    unpack_sign_bits,
)
from ...utils.concurrent import iter_on_thread
from ...utils.localizer import Localizer
from ...utils.sparse import SparseBatch
from .config import Config, SGDConfig
from .learning_rate import LearningRate
from .loss import create_loss
from .penalty import create_penalty
from .updaters import apply_state_rows, create_updater

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class PreppedBatch:
    """Static-shape localized minibatch, per data shard (leading dim D):
    numpy after prep, tensors after :meth:`AsyncSGDWorker.upload`."""

    y: np.ndarray  # [D, R] float32
    mask: np.ndarray  # [D, R] float32
    rows: np.ndarray  # [D, NZ] int32
    ucols: np.ndarray  # [D, NZ] int32 — index into uslots
    vals: np.ndarray  # [D, NZ] float32
    uslots: np.ndarray  # [D, U] int32 slot ids (sentinel = num_slots)
    umask: np.ndarray  # [D, U] float32

    @property
    def num_examples(self) -> int:
        return int(self.mask.sum())


@dataclasses.dataclass
class PreppedSuperBatch:
    """T stacked PreppedBatches (fields [T, D, ...]): one submission
    runs T sequential ministeps."""

    y: np.ndarray
    mask: np.ndarray
    rows: np.ndarray
    ucols: np.ndarray
    vals: np.ndarray
    uslots: np.ndarray
    umask: np.ndarray

    @property
    def steps(self) -> int:
        return int(self.y.shape[0])

    @property
    def num_examples(self) -> int:
        return int(self.mask.sum())


@dataclasses.dataclass
class HashedBatch:
    """Per-entry slot ids, no deduplication (the dense update's prep)."""

    y: np.ndarray  # [D, R]
    mask: np.ndarray  # [D, R]
    rows: np.ndarray  # [D, NZ] int32
    slots: np.ndarray  # [D, NZ] int32 (sentinel = num_slots for padding)
    vals: np.ndarray  # [D, NZ] float32

    @property
    def num_examples(self) -> int:
        return int(self.mask.sum())


def prep_batch(batch: SparseBatch, directory, num_shards: int, rows_pad: int,
               nnz_pad: int, uniq_pad: int, num_slots: int) -> PreppedBatch:
    """Host-side localize and pad, a :class:`Localizer` a data shard (the
    reference's ``MinibatchReader::Read`` tail, sgd.h:117-135): each
    shard's unique keys, its entries remapped to them, the keys mapped
    to table slots."""
    shards = []
    per = -(-batch.n // num_shards)
    for d in range(num_shards):
        sub = batch.slice_rows(min(d * per, batch.n), min((d + 1) * per, batch.n))
        loc = Localizer()
        keys, _ = loc.count_uniq_index(sub)
        local = loc.remap_index(keys)
        if local.nnz > nnz_pad or len(keys) > uniq_pad or local.n > rows_pad:
            raise ValueError(
                f"batch exceeds padding: nnz {local.nnz}>{nnz_pad} or "
                f"uniq {len(keys)}>{uniq_pad} or rows {local.n}>{rows_pad}"
            )
        y = np.zeros(rows_pad, np.float32)
        y[: local.n] = local.y
        mask = np.zeros(rows_pad, np.float32)
        mask[: local.n] = 1.0
        rows = np.zeros(nnz_pad, np.int32)
        ucols = np.zeros(nnz_pad, np.int32)
        vals = np.zeros(nnz_pad, np.float32)
        rows[: local.nnz] = local.row_ids()
        ucols[: local.nnz] = local.indices
        vals[: local.nnz] = local.value_array()
        uslots = np.full(uniq_pad, slot_sentinel(num_slots), np.int32)
        umask = np.zeros(uniq_pad, np.float32)
        uslots[: len(keys)] = directory.slots(keys)
        umask[: len(keys)] = 1.0
        shards.append((y, mask, rows, ucols, vals, uslots, umask))
    return PreppedBatch(*(np.stack(x) for x in zip(*shards)))


def prep_batch_shared(batch: SparseBatch, directory, num_shards: int,
                      rows_pad: int, nnz_pad: int, uniq_pad: int,
                      num_slots: int) -> PreppedBatch:
    """Globally-deduped prep for the sparse update: ONE slot-unique
    table for the whole minibatch, shared by every data shard. Dedup is
    at SLOT level (after the hash): keys colliding into one slot must
    have their gradients summed before the nonlinear update."""
    # the inverse of the one sort is each entry's key column: the same
    # ids a searchsorted into keys_all gives, without a second pass of
    # random lookups (the larger part of prep at the headline size)
    keys_all, entry_key = np.unique(np.asarray(batch.indices), return_inverse=True)
    slots_of_key = directory.slots(keys_all)
    uniq_slots, key_to_ucol = np.unique(slots_of_key, return_inverse=True)
    u = len(uniq_slots)
    if u > uniq_pad:
        raise ValueError(f"batch exceeds padding: uniq {u}>{uniq_pad}")
    uslots = np.full(uniq_pad, slot_sentinel(num_slots), np.int32)
    uslots[:u] = uniq_slots
    umask = np.zeros(uniq_pad, np.float32)
    umask[:u] = 1.0
    key_to_ucol = key_to_ucol.astype(np.int32)

    shards = []
    per = -(-batch.n // num_shards)
    for d in range(num_shards):
        lo_r = min(d * per, batch.n)
        hi_r = min((d + 1) * per, batch.n)
        lo, hi = batch.indptr[lo_r], batch.indptr[hi_r]
        nsub, nnz = hi_r - lo_r, hi - lo
        if nnz > nnz_pad or nsub > rows_pad:
            raise ValueError(
                f"batch exceeds padding: nnz {nnz}>{nnz_pad} or "
                f"rows {nsub}>{rows_pad}"
            )
        y = np.zeros(rows_pad, np.float32)
        y[:nsub] = batch.y[lo_r:hi_r]
        mask = np.zeros(rows_pad, np.float32)
        mask[:nsub] = 1.0
        counts = np.diff(batch.indptr[lo_r : hi_r + 1])
        rows = np.zeros(nnz_pad, np.int32)
        rows[:nnz] = np.repeat(np.arange(nsub, dtype=np.int32), counts)
        ucols = np.zeros(nnz_pad, np.int32)
        ucols[:nnz] = key_to_ucol[entry_key[lo:hi]]
        vals = np.zeros(nnz_pad, np.float32)
        vals[:nnz] = batch.values[lo:hi] if not batch.binary else 1.0
        shards.append((y, mask, rows, ucols, vals, uslots, umask))
    return PreppedBatch(*(np.stack(x) for x in zip(*shards)))


def stack_prepped_batches(batches: List[PreppedBatch]) -> PreppedSuperBatch:
    """Stack T prepped minibatches along a new leading T axis."""
    if not batches:
        raise ValueError("empty superbatch")
    return PreppedSuperBatch(
        *(
            np.stack([getattr(b, f.name) for b in batches])
            for f in dataclasses.fields(PreppedBatch)
        )
    )


def prep_batch_hashed(batch: SparseBatch, directory, num_shards: int,
                      rows_pad: int, nnz_pad: int,
                      num_slots: int) -> HashedBatch:
    """Vectorized hash + pad prep (no sort, no dedup)."""
    shards = []
    per = -(-batch.n // num_shards)
    for d in range(num_shards):
        lo_r, hi_r = min(d * per, batch.n), min((d + 1) * per, batch.n)
        lo, hi = batch.indptr[lo_r], batch.indptr[hi_r]
        nsub = hi_r - lo_r
        nnz = hi - lo
        if nnz > nnz_pad or nsub > rows_pad:
            raise ValueError(f"batch exceeds padding: {nnz}>{nnz_pad} or {nsub}>{rows_pad}")
        y = np.zeros(rows_pad, np.float32)
        y[:nsub] = batch.y[lo_r:hi_r]
        mask = np.zeros(rows_pad, np.float32)
        mask[:nsub] = 1.0
        counts = np.diff(batch.indptr[lo_r : hi_r + 1])
        rows = np.zeros(nnz_pad, np.int32)
        rows[:nnz] = np.repeat(np.arange(nsub, dtype=np.int32), counts)
        slots = np.full(nnz_pad, slot_sentinel(num_slots), np.int32)
        slots[:nnz] = directory.slots(batch.indices[lo:hi])
        vals = np.zeros(nnz_pad, np.float32)
        vals[:nnz] = batch.values[lo:hi] if not batch.binary else 1.0
        shards.append((y, mask, rows, slots, vals))
    return HashedBatch(*(np.stack(x) for x in zip(*shards)))


@dataclasses.dataclass
class ELLBatch:
    """ELL row blocks: each row owns ``K`` feature lanes, ``slots[r, k]``
    (sentinel ``num_slots`` where a row has fewer features) and ``vals``
    (None for binary features)."""

    y: np.ndarray  # [D, R]
    mask: np.ndarray  # [D, R] float32
    slots: np.ndarray  # [D, R, K] int32
    vals: Optional[np.ndarray]  # [D, R, K] float32 or None

    @property
    def num_examples(self) -> int:
        return int(self.mask.sum())


@dataclasses.dataclass
class ELLPackedBatch:
    """ELLBatch with 3-byte little-endian slot ids and a uint8 mask."""

    y: np.ndarray  # [D, R] float32
    mask: np.ndarray  # [D, R] uint8
    slots_u24: np.ndarray  # [D, R, K, 3] uint8
    vals: Optional[np.ndarray]

    @property
    def num_examples(self) -> int:
        return int(self.mask.sum())


@dataclasses.dataclass
class ELLBitsBatch:
    """The minimal ELL wire (hashed keys, binary features, uniform rows,
    ±1 labels): ceil(log2 S)-bit slot ids, sign-bit labels, a live-row
    count for the mask. ``rows`` is the row padding R."""

    y_bits: np.ndarray  # [D, ceil(R/8)] uint8
    counts: np.ndarray  # [D] int32
    slots_words: np.ndarray  # [D, W] uint32
    rows: int = wire.static(0)

    @property
    def num_examples(self) -> int:
        return int(self.counts.sum())


@dataclasses.dataclass
class ELLBitsSuperBatch(ELLBitsBatch):
    """T stacked ELLBitsBatches (arrays [T, D, ...])."""

    @property
    def steps(self) -> int:
        return int(self.counts.shape[0])


def stack_bits_batches(parts: List[ELLBitsBatch]) -> ELLBitsSuperBatch:
    rows = parts[0].rows
    if any(p.rows != rows for p in parts):
        raise ValueError("a bits superbatch needs one row padding")
    return ELLBitsSuperBatch(
        y_bits=np.stack([p.y_bits for p in parts]),
        counts=np.stack([p.counts for p in parts]),
        slots_words=np.stack([p.slots_words for p in parts]),
        rows=rows,
    )


def pack_u24(idx: np.ndarray) -> np.ndarray:
    """int32 [...] -> uint8 [..., 3] little-endian (values < 2^24)."""
    flat = np.ascontiguousarray(idx, dtype="<u4")
    return flat.view(np.uint8).reshape(*idx.shape, 4)[..., :3].copy()


# the inverse of pack_u24, on the step's device (the JAX package's name)
unpack_u24 = wc.decode_u24


def _lane_positions(counts: np.ndarray, lanes: int) -> np.ndarray:
    """Each entry's lane within its row; -1 past the lane budget."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    return np.where(pos < lanes, pos, -1)


def prep_batch_ell(batch: SparseBatch, directory, num_shards: int, rows_pad: int,
                   lanes: int, num_slots: int, pack: bool = False):
    """A CSR batch in ELL lanes (``pack``: 3-byte slot ids). A row wider
    than ``lanes`` raises: packing would drop features (the worker's
    prep checks first and takes the hashed path instead)."""
    widths = np.diff(batch.indptr)
    max_row = int(widths.max()) if batch.n else 0
    if max_row > lanes:
        dropped = int(np.maximum(widths - lanes, 0).sum())
        raise ValueError(
            f"ELL lane budget {lanes} < widest row {max_row}: packing would "
            f"silently drop {dropped} features; raise ell_lanes or use the "
            "hashed COO path"
        )
    shards = []
    per = -(-batch.n // num_shards)
    binary = batch.binary
    for d in range(num_shards):
        lo_r, hi_r = min(d * per, batch.n), min((d + 1) * per, batch.n)
        nsub = hi_r - lo_r
        y = np.zeros(rows_pad, np.float32)
        y[:nsub] = batch.y[lo_r:hi_r]
        mask = np.zeros(rows_pad, np.float32)
        mask[:nsub] = 1.0
        counts = np.diff(batch.indptr[lo_r: hi_r + 1]).astype(np.int64)
        seg = slice(batch.indptr[lo_r], batch.indptr[hi_r])
        slot_ids = directory.slots(batch.indices[seg])
        slots = np.full((rows_pad, lanes), slot_sentinel(num_slots), np.int32)
        vals = None if binary else np.zeros((rows_pad, lanes), np.float32)
        if nsub and bool((counts == lanes).all()):
            slots[:nsub] = slot_ids.reshape(nsub, lanes)  # uniform rows: a reshape
            if not binary:
                vals[:nsub] = batch.values[seg].reshape(nsub, lanes)
        else:
            lane_idx = _lane_positions(counts, lanes)
            keep = lane_idx >= 0
            flat_rows = np.repeat(np.arange(nsub), counts)[keep]
            slots[flat_rows, lane_idx[keep]] = slot_ids[keep]
            if not binary:
                vals[flat_rows, lane_idx[keep]] = batch.values[seg][keep]
        shards.append((y, mask, slots, vals))
    ys, masks, slotss, valss = (np.stack(x) if x[0] is not None else None for x in zip(*shards))
    if pack:
        if num_slots >= (1 << 24):
            raise ValueError("the u24 wire needs num_slots < 2^24")
        return ELLPackedBatch(y=ys, mask=masks.astype(np.uint8), slots_u24=pack_u24(slotss),
                              vals=valss)
    return ELLBatch(y=ys, mask=masks, slots=slotss, vals=valss)


def prep_batch_ell_bits(batch: SparseBatch, directory, num_shards: int, rows_pad: int,
                        lanes: int, num_slots: int) -> Optional[ELLBitsBatch]:
    """The bits wire: hash -> slot -> bitstream in one native pass a
    shard, labels as sign bits, the mask as a row count. None unless the
    batch is binary, its rows uniform and its labels ±1 (the caller then
    takes the u24 wire)."""
    if not (batch.binary and directory.hashed):
        return None
    if not (np.diff(batch.indptr) == lanes).all():
        return None
    if not (np.abs(batch.y) == 1).all():
        return None
    bits = slot_bits(num_slots)
    per = -(-batch.n // num_shards)
    nwords = packed_nwords(rows_pad * lanes, bits)
    y_nbytes = (rows_pad + 7) // 8
    # every live byte is written by the pack; the bits of padding rows
    # decode to slots whose gradient the row mask zeroes
    slots_words = np.zeros((num_shards, nwords), "<u4")
    y_bits = np.zeros((num_shards, y_nbytes), np.uint8)
    counts = np.zeros((num_shards,), np.int32)
    for d in range(num_shards):
        lo_r, hi_r = min(d * per, batch.n), min((d + 1) * per, batch.n)
        nsub = hi_r - lo_r
        if nsub > rows_pad:
            raise ValueError(f"batch exceeds padding: {nsub}>{rows_pad}")
        seg = slice(batch.indptr[lo_r], batch.indptr[hi_r])
        nbytes = (nsub * lanes * bits + 7) // 8
        # the hash modulus is the directory's configured slot count
        hash_slots_packed(batch.indices[seg], directory.num_slots, bits,
                          out=slots_words[d].view(np.uint8)[:nbytes])
        yb = np.packbits(batch.y[lo_r:hi_r] > 0, bitorder="little")
        y_bits[d, : yb.size] = yb
        counts[d] = nsub
    return ELLBitsBatch(y_bits=y_bits, counts=counts, slots_words=slots_words, rows=rows_pad)


def prep_batch_ell_stream(batch: SparseBatch, directory, num_shards: int, rows_pad: int,
                          lanes: int, num_slots: int, statics):
    """The lane-dictionary wire (``learner/wire.encode_stream_shard``
    a shard), on the bits wire's domain and within the pinned
    ``statics``; None otherwise (the caller takes the bits wire). Each
    fallback counts by reason in ``ps_wire_fallbacks_total``; an encode
    counts its time and bytes, and the bytes it saves against the bits
    wire at the same shape."""
    tel = wire.wire_instruments()

    def fallback(reason: str):
        if tel is not None:
            tel["fallbacks"].labels(reason=reason).inc()
        return None

    if statics is None or not (batch.binary and directory.hashed) or statics.lanes != lanes:
        return fallback("domain")
    if not (np.diff(batch.indptr) == lanes).all():
        return fallback("ragged")
    if not (np.abs(batch.y) == 1).all():
        return fallback("labels")
    t0 = time.perf_counter()
    per = -(-batch.n // num_shards)
    y_bits = np.zeros((num_shards, (rows_pad + 7) // 8), np.uint8)
    counts = np.zeros((num_shards,), np.int32)
    lane_starts = np.zeros((num_shards, len(statics.dict_lanes)), np.int32)
    n_uniq = np.zeros((num_shards,), np.int32)
    raw_ws, code_ws, table_ws = [], [], []
    for d in range(num_shards):
        lo_r, hi_r = min(d * per, batch.n), min((d + 1) * per, batch.n)
        nsub = hi_r - lo_r
        if nsub > rows_pad:
            raise ValueError(f"batch exceeds padding: {nsub}>{rows_pad}")
        seg = slice(batch.indptr[lo_r], batch.indptr[hi_r])
        got = wire.encode_stream_shard(batch.indices[seg], nsub, rows_pad,
                                       directory.num_slots, statics)
        if got is None:  # the shard outgrew the pinned statics
            return fallback("statics_overflow")
        raw_w, code_w, table_w, lane_starts[d], n_uniq[d] = got
        raw_ws.append(raw_w)
        code_ws.append(code_w)
        table_ws.append(table_w)
        yb = np.packbits(batch.y[lo_r:hi_r] > 0, bitorder="little")
        y_bits[d, : yb.size] = yb
        counts[d] = nsub
    out = wire.EncodedEllStreamBatch(
        y_bits=y_bits, counts=counts, raw_words=np.stack(raw_ws), code_words=np.stack(code_ws),
        table_words=np.stack(table_ws), lane_starts=lane_starts, n_uniq=n_uniq, rows=rows_pad,
        lanes=lanes, dict_lanes=statics.dict_lanes, code_bits=statics.code_bits,
        dict_pad=statics.dict_pad, raw_bits=statics.raw_bits,
    )
    if tel is not None:
        enc_b = wire.batch_nbytes(out)
        # the raw alternative these bytes displace: the bits wire at the
        # same shape
        bits_b = num_shards * (packed_nwords(rows_pad * lanes, statics.raw_bits) * 4
                               + y_bits.shape[1] + 4)
        tel["encode_seconds"].observe(time.perf_counter() - t0)
        tel["bytes"].labels(encoding="stream").inc(enc_b)
        tel["saved_bytes"].labels(reason="encoding").inc(max(0, bits_b - enc_b))
    return out


def _fit_rows(leaf: np.ndarray, rows: int) -> np.ndarray:
    """A state leaf cut or zero-extended to ``rows`` rows (scalars whole):
    a table saved at another padding."""
    if leaf.ndim == 0 or leaf.shape[0] == rows:
        return leaf
    out = np.zeros((rows,) + leaf.shape[1:], leaf.dtype)
    m = min(rows, leaf.shape[0])
    out[:m] = leaf[:m]
    return out


def _gather_state(state, idx):
    """Rows ``idx`` of every 1-D state leaf; scalars pass through."""
    return {k: (v.index_select(0, idx) if v.dim() >= 1 else v) for k, v in state.items()}


def _progress_metrics(loss, y, xw, mask, with_aux: bool) -> Dict[str, torch.Tensor]:
    """SGDProgress scalars (padding rows masked out); the per-example
    xw/y/mask aux feeds the host-side AUC. This rank's values: on a mesh
    :func:`_fold_over_mesh` folds them by :data:`_FOLD_DENSE` /
    :data:`_FOLD_SPARSE`."""
    metrics = {
        "objective": (loss.row_loss(y, xw) * mask).sum(),
        "num_ex": mask.sum(),
        "correct": (((xw > 0) == (y > 0)) * mask).sum(),
    }
    if with_aux:
        metrics["xw"] = xw[None]
        metrics["y"] = y[None]
        metrics["mask"] = mask[None]
    return metrics


def _convergence_metrics(metrics, g_push, update, w_used):
    """Squared L2 norms of the pushed gradient, the update handed to the
    updater and the weights the step consumed."""
    metrics["grad_sq"] = torch.square(g_push).sum()
    metrics["update_sq"] = torch.square(update).sum()
    metrics["weight_sq"] = torch.square(w_used).sum()
    return metrics


_AUX = ("xw", "y", "mask")
_PROGRESS = {"objective": (DATA_AXIS,), "num_ex": (DATA_AXIS,), "correct": (DATA_AXIS,)}
#: which mesh axes each metric sums over (the JAX step's psums): on the
#: dense route the pushed gradient is ownership-masked, one server shard
#: an entry (server, then data); the update is a shard vector replicated
#: over data (server); the weights are server-assembled (data)
_FOLD_DENSE = {**_PROGRESS, "grad_sq": (SERVER_AXIS, DATA_AXIS), "update_sq": (SERVER_AXIS,),
               "weight_sq": (DATA_AXIS,)}
#: the sparse route's update and weights are already global vectors
_FOLD_SPARSE = {**_PROGRESS, "grad_sq": (DATA_AXIS,)}


def _fold_over_mesh(per_step: List[Dict[str, torch.Tensor]], fold: Dict[str, tuple],
                    mesh) -> List[Dict[str, torch.Tensor]]:
    """The JAX step's metric psums for a launch's ministeps: each axis's
    scalars, over every ministep, packed into one ``[T, n]`` tensor and
    one ``psum`` (the elementwise sum gives the bits of one psum a
    scalar), the server axis first; the per-example aux all-gathered
    over data in one call (``[D, R]`` a ministep). The identity with no
    mesh."""
    if mesh is None:
        return per_step
    out = [dict(m) for m in per_step]
    for axis in (SERVER_AXIS, DATA_AXIS):
        names = [k for k in per_step[0] if axis in fold.get(k, ())]
        if not names or mesh.shape[axis] == 1:
            continue
        packed = torch.stack([torch.stack([m[k] for k in names]) for m in out])
        packed = psum(packed, axis, mesh)
        for t, m in enumerate(out):
            m.update(zip(names, packed[t]))
    aux = [k for k in _AUX if k in per_step[0]]
    if aux and mesh.shape[DATA_AXIS] > 1:
        # [T, n_aux, R] from each data rank, gathered to [D, T, n_aux, R]
        mine = torch.stack([torch.cat([m[k] for k in aux]) for m in out])
        every = meshlib.all_gather(mine, DATA_AXIS, mesh, tiled=False)
        for t, m in enumerate(out):
            m.update((k, every[:, t, i]) for i, k in enumerate(aux))
    return out


def mix_seed(seed: int, mul: int, index: int = 0) -> int:
    """``seed * mul + index`` in wrapping 32-bit arithmetic: the JAX
    production wire's per-shard quantization seed (``mul`` 1000003 for
    the push with the data shard's index, 999983 for the pull with the
    server shard's; both indices are 0 on one card)."""
    return (int(seed) * mul + index) & _M32


_PUSH_SEED_MUL, _PULL_SEED_MUL = 1000003, 999983
_PUSH_NOISE_SALT, _PULL_NOISE_SALT = 0xA015E, 0xA015F


def _coords(mesh) -> Tuple[int, int]:
    """This rank's ``(data, server)`` coordinates, ``(0, 0)`` with no mesh."""
    return (0, 0) if mesh is None else mesh.coords


def _make_perturb(noise, salt: int, mesh=None):
    """ADD_NOISE wire op: N(mean, std) on nonzero entries, or None when
    disabled. A mean-only filter (std=0, mean!=0) still applies, adding
    the constant. The draws come from a ``torch.Generator`` seeded from
    (salt, seed, this rank's mesh position), each rank its own stream as
    the JAX wire folds in both axis indices; it cannot match
    ``jax.random.normal``."""
    if noise is None:
        return None
    mean, std = float(noise[0]), float(noise[1])
    if mean == 0.0 and std <= 0.0:
        return None
    d, s = _coords(mesh)
    position = 0 if mesh is None else d * mesh.shape[SERVER_AXIS] + s

    def perturb(g, seed):
        gen = torch.Generator(device=g.device)
        gen.manual_seed(((salt << 32) | (int(seed) & _M32)) + (position << 52))
        n = mean + std * torch.randn(g.shape, generator=gen, device=g.device, dtype=g.dtype)
        return torch.where(g != 0, g + n, g)

    return perturb


def _make_push_filter(push_quant: int, noise=None, mesh=None):
    """This data rank's contribution to the push, ``(g_shard, seed) ->
    g``: optionally ADD_NOISE, then, with ``push_quant`` bytes, the
    FIXING_FLOAT push filter: the shard gradient is stochastically
    rounded to fixed point with its own [min, max] scale (seed ``seed *
    1000003 + d``, ``d`` the data rank) and decoded; entries that were
    zero stay exactly zero (absent keys get no quantization noise)."""
    perturb = _make_perturb(noise, _PUSH_NOISE_SALT, mesh)
    if not push_quant:
        return (lambda g, seed: g) if perturb is None else perturb
    d, _ = _coords(mesh)

    def encode(g, seed):
        if perturb is not None:
            g = perturb(g, seed)  # ADD_NOISE rides the wire before quantize
        q, lo, hi = qops.quantize(g, mix_seed(seed, _PUSH_SEED_MUL, d), num_bytes=push_quant)
        return torch.where(g != 0, qops.dequantize(q, lo, hi, push_quant), 0.0)

    return encode


def make_push_reduce(push_quant: int, noise=None, mesh=None):
    """The push wire, ``(g_shard, seed) -> g``: each data rank's filtered
    contribution (:func:`_make_push_filter`), summed over the data axis
    (``psum``; the identity with one data rank)."""
    encode = _make_push_filter(push_quant, noise, mesh)
    if mesh is None:
        return encode
    return lambda g, seed: psum(encode(g, seed), DATA_AXIS, mesh)


def make_push_touched(push_quant: int, noise=None, mesh=None):
    """``(g_shard, seed) -> (reduced g, touched)``. Without quantization
    the reduced gradient's support is membership (``touched=None``: the
    FTRL kernel derives it in place). Under a quantized push, rounding
    zeroes small gradients, so membership is taken before quantization
    as an explicit mask; over the data axis it is the psum of the data
    ranks' support masks, packed with the gradient into one collective
    (two rows, each summed elementwise: the bits of two psums)."""
    if not push_quant:
        push_reduce = make_push_reduce(push_quant, noise=noise, mesh=mesh)
        return lambda g_shard, seed: (push_reduce(g_shard, seed), None)
    encode = _make_push_filter(push_quant, noise, mesh)
    if mesh is None or mesh.shape[DATA_AXIS] == 1:
        return lambda g_shard, seed: (encode(g_shard, seed), g_shard != 0)

    def run(g_shard, seed):
        both = torch.stack([encode(g_shard, seed), (g_shard != 0).to(torch.float32)])
        both = psum(both, DATA_AXIS, mesh)
        return both[0], both[1] > 0

    return run


def make_pull_lookup(updater, pull_quant: int, noise=None, mesh=None):
    """The pull wire, as ``(derive, lookup)``: ``derive(pulled, seed)``
    once per step gives the representation the step gathers from,
    ``lookup(rep, rel, ok)`` the flat f32 weights at ``rel``, zero where
    ``ok`` is False.

    Unfiltered, weights are derived from the GATHERED rows:
    ``updater.weights`` is elementwise, so this equals gathering the
    derived table bit for bit, without a table-sized pass. With a
    FIXING_FLOAT pull filter the whole table's weights are derived and
    stochastically rounded to ``pull_quant`` bytes (exact zeros stay
    zero), and the step gathers the dequantized weights: every
    ``pull_gather`` value takes this wide gather (the JAX package's
    narrow gather of codes is bit-equal to it). ADD_NOISE perturbs the
    derived weights. On a mesh each server shard derives and rounds its
    own weights (seed ``seed * 999983 + s``) and the lookup is this
    shard's part; the caller assembles it over the server axis."""
    perturb = _make_perturb(noise, _PULL_NOISE_SALT, mesh)
    _, s_index = _coords(mesh)
    if not pull_quant and perturb is None:
        def lookup_rows(pulled, rel, ok):
            return torch.where(ok, updater.weights(_gather_state(pulled, rel)), 0.0)

        return (lambda pulled, seed: pulled), lookup_rows

    def wide_lookup(w, rel, ok):
        return torch.where(ok, w.index_select(0, rel), 0.0)

    if not pull_quant:
        return (lambda pulled, seed: perturb(updater.weights(pulled), seed)), wide_lookup

    def quantized(pulled, seed):
        w = updater.weights(pulled)
        if perturb is not None:
            w = perturb(w, seed)
        q, lo, hi = qops.quantize(w, mix_seed(seed, _PULL_SEED_MUL, s_index),
                                  num_bytes=pull_quant)
        return w, q, lo, hi

    def derive_wide(pulled, seed):
        w, q, lo, hi = quantized(pulled, seed)
        return torch.where(w != 0, qops.dequantize(q, lo, hi, pull_quant), 0.0)

    return derive_wide, wide_lookup


_SUPPORTED_FILTERS = (
    "fixing_float", "key_caching", "sparse", "compressing", "add_noise",
)


def _add_noise_params(filters):
    """(mean, std) of an ADD_NOISE entry in a conf filter list (dicts, as
    ``parse_conf`` gives them), or None."""
    for f in filters or ():
        if str(f.get("type", "")).lower() == "add_noise":
            return float(f.get("mean") or 0.0), float(f.get("std") or 0.0)
    return None


def _fixing_float_bytes(filters, where: str) -> int:
    """num_bytes of a FIXING_FLOAT entry in a conf filter list (0 = none),
    validated. KEY_CACHING, SPARSE and COMPRESSING need no device work in
    the fused step; other types are warned about and not applied."""
    nb = 0
    for f in filters or ():
        ftype = str(f.get("type", "")).lower()
        if ftype == "fixing_float":
            nb = int(f.get("num_bytes") or 1)
            if nb not in (1, 2):
                raise ValueError(
                    f"{where} FIXING_FLOAT num_bytes must be 1 or 2, got {nb}"
                )
        elif ftype not in _SUPPORTED_FILTERS:
            logging.getLogger(__name__).warning(
                "%s filter %r is not applied by the fused async-SGD step",
                where, ftype,
            )
    return nb


def sparse_update_min_slots() -> int:
    """``update="auto"`` flip point, in shard slots: the dense sweep
    below it, the sparse row update at and above it."""
    return 1 << 30


def _mesh_or_none(mesh):
    """The mesh a step runs its collectives over: None for no mesh or a
    ``1 x 1`` one (every collective the identity)."""
    return None if mesh is None or mesh.size == 1 else mesh


def _make_exact_mini_step(updater, loss, shard: int, with_aux: bool, update: str,
                          push_quant: int = 0, pull_quant: int = 0,
                          push_noise=None, pull_noise=None, pull_narrow=False,
                          significance: Optional[SignificanceSpec] = None, mesh=None):
    """One ministep over the exact (host-dedup) wire:
    ``(live, pulled, seed, y, mask, rows, ucols, vals, uslots, umask) ->
    metrics``, updating ``live`` in place. ``update="sparse"`` applies
    the update to the batch's deduplicated slots only and composes with
    the unfiltered wire only; ``update="dense"`` scatters the gradient
    into a shard-sized vector, passes it through the push wire and
    sweeps the whole shard.

    ``significance`` (sparse only): the KKT filter between push and
    update. Suppressed slots get a zero gradient and ``ok & keep`` keeps
    the update off their rows, which stay bit-untouched; the metrics
    gain ``kkt_slots`` and ``kkt_suppressed``, and with feedback the
    per-slot ``kkt_keep`` and ``kkt_uslots``. None runs the unfiltered
    step.

    ``mesh``: ``shard`` is this rank's server shard; the weights (and
    the KKT filter's z) are assembled over the server axis and the
    gradient summed over the data axis (the sparse update's unique-slot
    vector, which prep makes the same on every data rank, or the dense
    update's shard vector through the push wire). The metrics are this
    rank's (``mini_step.fold``); the KKT filter's are global vectors,
    the same on every rank after the psums, and fold over nothing."""
    mesh = _mesh_or_none(mesh)
    if significance is not None and update != "sparse":
        raise ValueError(
            "the KKT significance filter composes with update='sparse' "
            "only (its mask is defined on the globally-deduped unique-"
            "slot vectors)"
        )
    if update == "sparse":
        if push_quant or pull_quant or push_noise or pull_noise:
            raise ValueError(
                "update='sparse' composes with the exact (unfiltered) "
                "wire only; quantized/noisy filters need update='dense'"
            )
        if pull_narrow:
            raise ValueError(
                "update='sparse' does not implement pull_gather='narrow' "
                "(narrow modifies the quantized pull, which sparse mode "
                "rejects); use pull_gather='auto'/'wide'"
            )
    elif update != "dense":
        raise ValueError(f"unknown update mode {update!r}")
    push_touched = make_push_touched(push_quant, noise=push_noise, mesh=mesh)
    pull_derive, pull_lookup = make_pull_lookup(updater, pull_quant, noise=pull_noise, mesh=mesh)

    def mini_step(live, pulled, seed, y, mask, rows, ucols, vals, uslots, umask):
        rel, ok = localize(uslots, shard, mesh)
        w_u = pull_lookup(pull_derive(pulled, seed), rel, ok)
        if mesh is not None:
            w_u = psum(w_u, SERVER_AXIS, mesh)
        w_u = w_u * umask
        # rows are in CSR order with the padding (row 0, value 0) at the
        # end: each row's nonzero entries lie in one run, so no sort
        xw = _segment_sum(vals * w_u.index_select(0, ucols), rows, y.shape[0], presorted=True)
        gr = loss.row_grad(y, xw) * mask
        g_u = _segment_sum(vals * gr.index_select(0, rows), ucols, uslots.shape[0])
        g_u = g_u * umask
        metrics = _progress_metrics(loss, y, xw, mask, with_aux)
        if update == "sparse":
            g_pushed, ok_upd = g_u, ok
            if mesh is not None:
                # every data rank carries the same global uslots: the
                # gradient merge is an elementwise psum of the U-vector
                g_u = psum(g_u, DATA_AXIS, mesh)
            if significance is not None:
                # the slot's z lives on one server shard: assembled as w_u
                # was, one more server psum of a U-vector
                z_u = torch.where(ok, pulled["z"].index_select(0, rel), 0.0)
                if mesh is not None:
                    z_u = psum(z_u, SERVER_AXIS, mesh)
                z_u = z_u * umask
                keep, suppressed = kkt_mask(z_u, g_u, w_u, umask, seed, spec=significance)
                g_u = torch.where(keep, g_u, 0.0)
                ok_upd = ok & keep
            apply_state_rows(updater, live, rel, ok_upd, g_u, seed=seed)
            _convergence_metrics(metrics, g_pushed, g_u, w_u)
            if significance is not None:
                metrics["kkt_slots"] = (umask > 0).to(torch.float32).sum()
                metrics["kkt_suppressed"] = suppressed
                if significance.feedback:
                    metrics["kkt_keep"] = keep
                    metrics["kkt_uslots"] = uslots
            return metrics
        g_push = torch.where(ok, g_u, 0.0)
        # rel runs over the sorted unique slots, then the padding (clipped
        # onto the last slot, value 0): one entry a slot, so no sort. The
        # padding goes to slot 0, where it forms a run of zeros of its own,
        # which the kernel skips; on the last slot it would lengthen that
        # slot's run by the whole padding, a serial walk on the card.
        g_shard = _segment_sum(g_push, torch.where(ok, rel, 0), shard, presorted=True)
        g_shard, touched = push_touched(g_shard, seed)
        updater.apply(live, g_shard, touched, seed=seed)
        return _convergence_metrics(metrics, g_push, g_shard, w_u)

    mini_step.fold = _FOLD_SPARSE if update == "sparse" else _FOLD_DENSE
    return mini_step


def _fold_metrics(per_step: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Scan fold: scalars sum over the ministeps; the per-example aux
    stays stacked per ministep ([T, D, R])."""
    return {
        k: (torch.stack([m[k] for m in per_step]).sum(0) if per_step[0][k].dim() == 0
            else torch.stack([m[k] for m in per_step]))
        for k in per_step[0]
    }


def _one_step(mini_step, decode, mesh=None):
    """``step(live, pulled, batch, seed) -> metrics`` over one minibatch:
    ``decode(batch, index)`` gives the ministep's arrays of data shard
    ``index`` (a rank of a mesh holds its own row only, at index 0); the
    metrics folded over the mesh."""
    mesh = _mesh_or_none(mesh)

    def step(live, pulled, batch, seed=0):
        m = mini_step(live, pulled, seed, *decode(batch, 0))
        return _fold_over_mesh([m], mini_step.fold, mesh)[0]

    return step


def _scan_step(mini_step, decode, mesh=None):
    """T ministeps of a superbatch in one submission, weights advancing
    every ministep (staleness 0; the pulled snapshot is not read);
    ministep i uses seed + i. The metrics fold over the mesh once a
    launch."""
    mesh = _mesh_or_none(mesh)

    def step(live, pulled, batch, seed=0):
        del pulled
        per_step = [mini_step(live, live, (seed + i) & _M32, *decode(batch, (i, 0)))
                    for i in range(batch.steps)]
        return _fold_metrics(_fold_over_mesh(per_step, mini_step.fold, mesh))

    return step


_EXACT = ("y", "mask", "rows", "ucols", "vals", "uslots", "umask")


def _raw_exact(batch, index):
    return tuple(getattr(batch, n)[index] for n in _EXACT)


def _shard(num_slots: int, mesh) -> int:
    """The slots of one server shard of a ``num_slots`` table."""
    return num_slots // (1 if mesh is None else meshlib.num_servers(mesh))


def make_train_step(updater, loss, num_slots: int, with_aux: bool = True,
                    update: str = "dense", significance=None, mesh=None, **wire_kw):
    """Exact-wire step over one PreppedBatch:
    ``step(live, pulled, batch, seed) -> metrics``, ``live`` updated in
    place. ``wire_kw``: the filter settings of :func:`_make_exact_mini_step`
    (``push_quant``, ``pull_quant``, ``push_noise``, ``pull_noise``,
    ``pull_narrow``). ``mesh``: ``live`` and ``pulled`` are this rank's
    server shard and ``batch`` its data row."""
    mini_step = _make_exact_mini_step(updater, loss, _shard(num_slots, mesh), with_aux, update,
                                      significance=significance, mesh=mesh, **wire_kw)
    return _one_step(mini_step, _raw_exact, mesh)


def make_train_step_scan(updater, loss, num_slots: int, with_aux: bool = True,
                         update: str = "dense", significance=None, mesh=None, **wire_kw):
    """T ministeps over a PreppedSuperBatch in one submission. The KKT
    filter keeps its mask and drops the per-slot feedback, which the
    fold would sum over ministeps."""
    if significance is not None:
        significance = significance.without_feedback()
    mini_step = _make_exact_mini_step(updater, loss, _shard(num_slots, mesh), with_aux, update,
                                      significance=significance, mesh=mesh, **wire_kw)
    return _scan_step(mini_step, _raw_exact, mesh)


def make_train_step_encoded(updater, loss, num_slots: int, with_aux: bool = True,
                            update: str = "dense", significance=None, mesh=None, **wire_kw):
    """The exact step over an EncodedExactBatch: the encoded arrays are
    decoded on the step's device (``learner/wire.decode_exact_shard``),
    then the same ministep as :func:`make_train_step` runs, so the state
    is bit-identical to the raw wire's (``mesh``: as
    :func:`make_train_step`; the rank decodes its own data row)."""
    mini_step = _make_exact_mini_step(updater, loss, _shard(num_slots, mesh), with_aux, update,
                                      significance=significance, mesh=mesh, **wire_kw)
    return _one_step(mini_step, lambda b, i: wire.decode_exact_shard(b, num_slots, i), mesh)


def make_train_step_encoded_scan(updater, loss, num_slots: int, with_aux: bool = True,
                                 update: str = "dense", significance=None, mesh=None,
                                 **wire_kw):
    """T encoded ministeps a submission, each decoded as it runs."""
    if significance is not None:
        significance = significance.without_feedback()
    mini_step = _make_exact_mini_step(updater, loss, _shard(num_slots, mesh), with_aux, update,
                                      significance=significance, mesh=mesh, **wire_kw)
    return _scan_step(mini_step, lambda b, i: wire.decode_exact_shard(b, num_slots, i), mesh)


def _make_entry_mini_step(updater, loss, shard: int, num_slots: int, with_aux: bool,
                          push_quant: int = 0, pull_quant: int = 0, push_noise=None,
                          pull_noise=None, pull_narrow=False, mesh=None):
    """One dense-update ministep over per-entry slot ids, the body of
    the hashed COO step and of every ELL wire:
    ``(live, pulled, seed, y, mask, rows, slots, vals, valid) -> metrics``.
    ``rows`` holds each entry's row in CSR order (the ELL lanes row by
    row), ``vals`` None for binary entries, ``valid`` None or the mask
    of entries that carry a feature. Gather the weights at each slot
    through the pull wire, sum Xw by row, add the entries' gradients
    into a shard-sized vector (a stable sort by slot, then each slot's
    sum in entry order: the same bits run to run and on the CPU), pass
    it through the push wire and sweep the whole shard. ``mesh``: the
    weights are assembled over the server axis, the push wire sums over
    the data axis."""
    del pull_narrow  # every pull gathers wide
    mesh = _mesh_or_none(mesh)
    push_touched = make_push_touched(push_quant, noise=push_noise, mesh=mesh)
    pull_derive, pull_lookup = make_pull_lookup(updater, pull_quant, noise=pull_noise, mesh=mesh)

    def mini_step(live, pulled, seed, y, mask, rows, slots, vals, valid):
        rel, ok = localize(slots, shard, mesh)
        # sentinel/padding slots are owned by no shard: weight 0
        w_e = pull_lookup(pull_derive(pulled, seed), rel, ok)
        if mesh is not None:
            w_e = psum(w_e, SERVER_AXIS, mesh)
        xw = _segment_sum(w_e if vals is None else vals * w_e, rows, y.shape[0], presorted=True)
        gr = loss.row_grad(y, xw) * mask
        g_e = gr.index_select(0, rows)
        if vals is not None:
            g_e = vals * g_e
        if valid is not None:
            g_e = torch.where(valid, g_e, 0.0)
        g_push = torch.where(ok, g_e, 0.0)
        g_shard = _segment_sum(g_push, rel, shard)
        g_shard, touched = push_touched(g_shard, seed)
        updater.apply(live, g_shard, touched, seed=seed)
        metrics = _progress_metrics(loss, y, xw, mask, with_aux)
        return _convergence_metrics(metrics, g_push, g_shard, w_e * mask.index_select(0, rows))

    mini_step.fold = _FOLD_DENSE
    return mini_step


def make_train_step_hashed(updater, loss, num_slots: int, with_aux: bool = True, mesh=None,
                           **wire_kw):
    """Per-entry step (hashed prep, dense update) over a HashedBatch
    (``mesh``: as :func:`make_train_step`)."""
    mini_step = _make_entry_mini_step(updater, loss, _shard(num_slots, mesh), num_slots,
                                      with_aux, mesh=mesh, **wire_kw)

    def decode(b, i):
        return b.y[i], b.mask[i], b.rows[i], b.slots[i], b.vals[i], None

    return _one_step(mini_step, decode, mesh)


def _lane_rows(rows: int, lanes: int, device) -> torch.Tensor:
    """Each ELL entry's row, row by row: ``repeat(arange(rows), lanes)``."""
    return torch.arange(rows, dtype=torch.int32, device=device).repeat_interleave(lanes)


def make_train_step_ell(updater, loss, num_slots: int, binary: bool, with_aux: bool = True,
                        packed: bool = False, mesh=None, **wire_kw):
    """The step over an ELLBatch (``packed``: an ELLPackedBatch, its
    3-byte ids and uint8 mask decoded on the device): Xw by row over the
    lanes, the entries' gradients into the shard (``mesh``: as
    :func:`make_train_step`; every ELL step the same)."""
    mini_step = _make_entry_mini_step(updater, loss, _shard(num_slots, mesh), num_slots,
                                      with_aux, mesh=mesh, **wire_kw)

    def decode(b, i):
        slots = wc.decode_u24(b.slots_u24[i]) if packed else b.slots[i]
        mask = b.mask[i].to(torch.float32)
        r, k = slots.shape
        flat = slots.reshape(-1)
        vals = None if binary else b.vals[i].reshape(-1)
        valid = valid_slots(flat, num_slots) if binary else vals != 0
        return b.y[i], mask, _lane_rows(r, k, flat.device), flat, vals, valid

    return _one_step(mini_step, decode, mesh)


def _uniform_ell(y, mask, slots):
    """A uniform-row binary ELL ministep's arguments: every lane of a
    live row is a feature, and the row mask zeroes the padding rows."""
    r, k = slots.shape
    flat = slots.reshape(-1)
    return y, mask, _lane_rows(r, k, flat.device), flat, None, None


def _bits_decode(num_slots: int, lanes: int):
    bits = slot_bits(num_slots)

    def decode(b, i):
        # the labels of padding rows decode too; the row mask gates them
        y = unpack_sign_bits(b.y_bits[i], b.rows)
        mask = wc.decode_mask(b.counts[i], b.rows)
        slots = unpack_bits(b.slots_words[i], b.rows * lanes, bits).reshape(b.rows, lanes)
        return _uniform_ell(y, mask, slots)

    return decode


def make_train_step_ell_bits(updater, loss, num_slots: int, lanes: int,
                             with_aux: bool = True, mesh=None, **wire_kw):
    """The step over an ELLBitsBatch: slot ids, labels and the mask
    decoded on the device from the packed wire."""
    mini_step = _make_entry_mini_step(updater, loss, _shard(num_slots, mesh), num_slots,
                                      with_aux, mesh=mesh, **wire_kw)
    return _one_step(mini_step, _bits_decode(num_slots, lanes), mesh)


def make_train_step_ell_bits_scan(updater, loss, num_slots: int, lanes: int,
                                  with_aux: bool = True, mesh=None, **wire_kw):
    """T bits-wire ministeps a submission."""
    mini_step = _make_entry_mini_step(updater, loss, _shard(num_slots, mesh), num_slots,
                                      with_aux, mesh=mesh, **wire_kw)
    return _scan_step(mini_step, _bits_decode(num_slots, lanes), mesh)


def _stream_decoder():
    """The stream wire's decode; the lane order tensor is made once a
    lane split and device, not a host copy a step."""
    orders = {}

    def decode(b, i):
        key = (b.dict_lanes, b.lanes, b.y_bits.device)
        if key not in orders:
            orders[key] = wc.lane_order(b.dict_lanes, b.lanes, b.y_bits.device)
        return _uniform_ell(*wire.decode_stream_shard(b, i, orders[key]))

    return decode


def make_train_step_ell_stream(updater, loss, num_slots: int, with_aux: bool = True, mesh=None,
                               **wire_kw):
    """The step over an EncodedEllStreamBatch: dictionary lanes decode
    as table gathers, raw lanes from their bitstream, on the device."""
    mini_step = _make_entry_mini_step(updater, loss, _shard(num_slots, mesh), num_slots,
                                      with_aux, mesh=mesh, **wire_kw)
    return _one_step(mini_step, _stream_decoder(), mesh)


def make_train_step_ell_stream_scan(updater, loss, num_slots: int, with_aux: bool = True,
                                    mesh=None, **wire_kw):
    """T stream-wire ministeps a submission."""
    mini_step = _make_entry_mini_step(updater, loss, _shard(num_slots, mesh), num_slots,
                                      with_aux, mesh=mesh, **wire_kw)
    return _scan_step(mini_step, _stream_decoder(), mesh)


_SUPERBATCHES = (PreppedSuperBatch, ELLBitsSuperBatch, wire.EncodedExactSuperBatch,
                 wire.EncodedEllStreamSuperBatch)


def _stack(prepped: list, update_mode: str):
    """T prepped minibatches as one superbatch, or None where they do
    not stack: all on the bits wire, all on the stream wire with one set
    of statics, or (sparse update only) all on the raw or the encoded
    exact wire with one encoding."""
    kinds = {type(p) for p in prepped}
    if len(kinds) != 1:
        return None
    kind = kinds.pop()
    if kind is ELLBitsBatch:
        return stack_bits_batches(prepped)
    if kind is wire.EncodedEllStreamBatch and len({p.static_key() for p in prepped}) == 1:
        return wire.stack_stream_batches(prepped)
    if update_mode != "sparse":
        return None
    if kind is PreppedBatch:
        return stack_prepped_batches(prepped)
    if kind is wire.EncodedExactBatch and len({p.static_key() for p in prepped}) == 1:
        return wire.stack_encoded_batches(prepped)
    return None


_ALIGN = 64  # bytes: each array of a staged batch starts on this boundary
_SAVE_CHUNK = 1 << 26  # slots whose weights save_model derives at once


def _wire_encoding_name(prepped) -> str:
    """The wire a prepped batch rides, as the staging leg's telemetry
    label names it (``ps_wire_bytes_total{encoding="<name>+lz"}``)."""
    if isinstance(prepped, (wire.EncodedEllStreamBatch, wire.EncodedEllStreamSuperBatch)):
        return "stream"
    if isinstance(prepped, (wire.EncodedExactBatch, wire.EncodedExactSuperBatch)):
        return "exact"
    if isinstance(prepped, (ELLBitsBatch, ELLBitsSuperBatch)):
        return "bits"
    return "raw"


class PinnedStaging:
    """Host → device copies of prepped batches through pinned memory.

    ``depth`` pinned staging buffers are used in turn. A batch's arrays
    are copied into the next buffer, which then goes to the device in ONE
    non-blocking copy on the given stream; each array becomes a view of
    the device copy, and the batch carries the copy's event as
    ``ready``. A buffer is written again only after the event of the last
    copy out of it has completed. The device memory was allocated on the
    copy's stream: a step on another stream waits on ``ready`` and calls
    ``record_stream`` (:meth:`AsyncSGDWorker._submit_prepped`).

    One thread copies at a time (the caller's, or the pipelined train's
    uploader). ``copy_times``, when set to a list, receives ``(stream,
    start, end)`` timing events of every copy."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device = device
        self.depth = depth
        self.buffers: List[Optional[torch.Tensor]] = [None] * depth
        self._copied: List[Optional[torch.cuda.Event]] = [None] * depth
        self._next = 0
        self.copy_times: Optional[list] = None
        self.copied_bytes = 0  # bytes of arrays sent to the card

    def copy(self, prepped, stream: "torch.cuda.Stream"):
        arrays = [(name, _wire_view(getattr(prepped, name))) for name in wire.array_fields(prepped)]
        offsets, total = [], 0
        for _, a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        total = max(total, _ALIGN)  # an all-cached batch still records its event
        i = self._next
        self._next = (i + 1) % self.depth
        if self._copied[i] is not None:
            self._copied[i].synchronize()  # the last copy out of buffer i is done
        buf = self.buffers[i]
        if buf is None or buf.numel() < total:
            buf = self.buffers[i] = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        host = buf.numpy()
        for (_, a), off in zip(arrays, offsets):
            host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        self.copied_bytes += sum(a.nbytes for _, a in arrays)
        timed = self.copy_times is not None
        with torch.cuda.stream(stream):
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            dev = buf[:total].to(self.device, non_blocking=True)
            done = torch.cuda.Event(enable_timing=timed)
            done.record(stream)
        self._copied[i] = done
        if timed:
            self.copy_times.append((stream, start, done))
        out = wire.replace_arrays(prepped, {
            name: dev[off:off + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
            for (name, a), off in zip(arrays, offsets)
        })
        out.ready = done  # not a field: the device arrays' copy event
        return out


def _wire_view(a) -> np.ndarray:
    """A host array as the tensor dtype it travels as: uint32 and uint16
    as their int32 and int16 views (the decoders read either)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype == np.uint16:
        return a.view(np.int16)
    return a


def _host_bytes(prepped) -> int:
    """Bytes of a host-prepped batch's arrays (what an upload copies; a
    batch in LZ frames counts its arrays as decoded)."""
    if isinstance(prepped, wire.CompressedBatch):
        return int(prepped.raw_nbytes)
    return wire.batch_nbytes(prepped) if dataclasses.is_dataclass(prepped) else 0


def _step_cost(route: str):
    """The least bytes of a linear step on ``route`` (``"sparse"`` or
    ``"dense"``), for the roofline gauges, counted as
    ``benchmarks/ftrl_bytes.py`` counts an update: every array of the
    batch read once, and the optimizer state's row of a slot (z and √n
    for FTRL) read once and written once at every slot the route updates.
    The sparse route updates each ministep's unique slots: the card counts
    them from the batch (``umask``, or ``n_uniq`` on the encoded wire),
    and the count is read once the call is done. The dense route sweeps
    every slot of the table. No FLOP count is declared."""

    def cost(live_state, pull_state, batch, seed=0):
        rows = [t for t in live_state.values() if t.dim() == 1]
        row_bytes = 2.0 * sum(t.element_size() for t in rows)  # read + written
        nbytes = float(wire.batch_nbytes(batch))
        if route != "sparse":
            return {"bytes_accessed": nbytes + row_bytes * rows[0].numel()}
        n_uniq = getattr(batch, "n_uniq", None)
        live = n_uniq.sum() if n_uniq is not None else torch.count_nonzero(batch.umask)
        return {"bytes_accessed": live * row_bytes + nbytes}

    return cost


#: inventory names of the step builders (the JAX package's names)
_STEP_NAMES = {
    "exact": "step_exact", "exact_scan": "step_exact_scan",
    "exact_enc": "step_encoded", "exact_enc_scan": "step_encoded_scan",
    "hashed": "step_hashed", "ell": "step_ell",
    "ell_bits": "step_ell_bits", "ell_bits_scan": "step_ell_bits_scan",
    "ell_stream": "step_ell_stream", "ell_stream_scan": "step_ell_stream_scan",
}


def _step_variants(step_impl, name: str, route: str):
    """Wrap ``step(live, pulled, batch, seed)`` into the device inventory
    under ``<name>.<variant>``, as the JAX package's donation variants
    are: ``snap`` (the pulled state is the live one), ``snap_donate``
    (that, at τ = 0, not adaptive) and ``delay`` (a step on an older
    snapshot). PyTorch donates nothing, so the variants run the same
    function; the names keep the inventories of the two packages
    comparable. Returns ``step(live, pulled, batch, seed=0,
    variant="delay")``."""
    cost = _step_cost(route)
    fns = {v: device_tel.instrument(f"{name}.{v}", step_impl, cost=cost)
           for v in ("snap", "snap_donate", "delay")}

    def step(live_state, pull_state, batch, seed=0, variant="delay"):
        return fns[variant](live_state, pull_state, batch, seed)

    return step


class KeyHeatFeed:
    """The learning plane's key heat on threads of its own, two stages in
    a row: the first hashes each noted batch's keys to table slots and
    prepares them (``KeyHeat.prepare``: distinct slots, counts, sketch
    positions; no state read), the second folds them into the plane's
    sketch (``LearningPlane.fold_heat``). Each stage takes the batches one
    after another in the order they were noted, so the sketch ends
    bit-equal to noting them on the noting thread, which only enqueues.
    ``depth`` bounds the batches waiting at each stage (a full queue
    blocks the stage before it). ``close()`` waits for every noted batch,
    joins the threads and re-raises the first error of either."""

    _END = object()

    def __init__(self, plane, directory, depth: int = 8):
        import queue
        import threading

        self._keys: "queue.Queue" = queue.Queue(depth)
        self._prepared: "queue.Queue" = queue.Queue(depth)
        self._errors: List[BaseException] = []
        stages = ((self._keys, lambda keys: plane.heat.prepare(directory.slots(keys)),
                   self._prepared.put),
                  (self._prepared, plane.fold_heat, None))
        self._threads = [threading.Thread(target=self._run, args=stage, daemon=True,
                                          name=f"key_heat_{i}")
                         for i, stage in enumerate(stages)]
        for t in self._threads:
            t.start()

    def _run(self, source, fn, sink) -> None:
        while True:
            item = source.get()
            if item is not self._END and not self._errors:
                try:
                    out = fn(item)
                    if sink is not None:
                        sink(out)
                except BaseException as e:  # re-raised by close()
                    self._errors.append(e)
            if item is self._END:
                if sink is not None:
                    sink(self._END)
                return

    def note(self, keys: np.ndarray) -> None:
        self._keys.put(keys)

    def close(self) -> None:
        self._keys.put(self._END)
        for t in self._threads:
            t.join()
        if self._errors:
            raise self._errors[0]


class _GroupGate:
    """The pipelined train's turn for preps under the host drop set:
    :meth:`wait_for` (the prep thread) returns once :meth:`advance` (the
    submitting thread, after a group's submissions and collects) has
    run ``g`` times; :meth:`abort` releases a waiter of a train that
    ends first, which then raises. No clock: a condition."""

    def __init__(self) -> None:
        import threading

        self._cv = threading.Condition()
        self._done = 0  # guarded by _cv
        self._aborted = False  # guarded by _cv

    def wait_for(self, g: int) -> None:
        with self._cv:
            while self._done < g and not self._aborted:
                self._cv.wait()
            if self._aborted:
                raise RuntimeError("the train ended before this group's turn")

    def advance(self) -> None:
        with self._cv:
            self._done += 1
            self._cv.notify_all()

    def abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._cv.notify_all()


class DeviceUploader:
    """The double-buffered host → device stage of the pipelined train:
    ``upload_fn`` (the worker's upload on its side stream) runs for batch
    t+1 on this stage's thread while step t runs. ``depth`` bounds the
    uploaded batches not yet taken by the consumer (2: one being copied,
    one waiting). An exception of the thread re-raises at the consumer;
    ``close()`` stops and joins the thread."""

    def __init__(self, source, upload_fn, depth: int = 2):
        import collections

        from ...learner.ingest import pipeline_instruments

        tel = pipeline_instruments()
        # each staged batch's flow id, in FIFO order: the consumer pops
        # one an item (iter_on_thread keeps the order), so the step's
        # submission runs under the batch's flow
        self._flows: "collections.deque" = collections.deque()

        def uploaded():
            for prepped, n in source:
                t0 = time.perf_counter()
                fid = telemetry_spans.current_flow()
                if tel is not None:
                    tel["batches"].labels(pipeline="device_uploader").inc()
                    tel["examples"].labels(pipeline="device_uploader").inc(
                        int(getattr(prepped, "num_examples", 0)))
                # bytes served from the device-resident cache never
                # cross the link: uploaded_bytes stays the realized traffic
                saved0 = int(getattr(upload_fn, "saved_bytes", 0))
                if telemetry_spans.get_sink() is not None:
                    with telemetry_spans.flow_scope(fid):
                        with telemetry_spans.span("ingest.upload", pipeline="device_uploader"):
                            staged = upload_fn(prepped)
                else:
                    staged = upload_fn(prepped)
                if tel is not None:
                    hit_bytes = int(getattr(upload_fn, "saved_bytes", 0)) - saved0
                    tel["uploaded_bytes"].inc(max(0, _host_bytes(prepped) - hit_bytes))
                    tel["stage_seconds"].labels(stage="upload").observe(
                        time.perf_counter() - t0)
                self._flows.append(fid)
                yield staged, n

        # depth - 1 in the queue and one held by the consumer
        self._it = iter_on_thread(uploaded(), maxsize=max(1, depth - 1))

    def next_flow(self):
        """The flow id of the batch the consumer took last (None when
        tracing is off)."""
        try:
            return self._flows.popleft()
        except IndexError:
            return None

    def __iter__(self):
        return self._it

    def close(self) -> None:
        self._it.close()


class AsyncSGDWorker(ISGDCompNode):
    """The linear worker on one device, an :class:`ISGDCompNode` (so an
    ``App``, a ``Customer`` registered with the postoffice's manager, and
    ``Checkpointable``): preps minibatches on the host, runs the fused
    worker+server step on ``device``, evaluates and answers pulls from
    the trained table. ``device=None`` is the started postoffice's
    device, else the card (raises when there is none). Steps run on the
    customer's executor, at most τ + 1 in flight (``max_delay`` = τ):
    :meth:`process_minibatch` and :meth:`submit_group` return executor
    timestamps, :meth:`collect` waits for one and folds its metrics,
    :meth:`submit_wait` runs a prepped batch and returns its metrics.
    With τ > 0, gradients are computed on a weight snapshot refreshed
    every τ ministeps, on the JAX worker's schedule (fixed by submission
    order), so the trajectory equals the JAX worker's;
    ``last_staleness`` is the realized staleness of the latest
    submission, in ministeps. Reading the table (weights, pulls,
    evaluation, snapshots) first waits for the steps in flight.
    :meth:`checkpoint` / :meth:`checkpoint_async` save
    :meth:`state_host` (the state and the seed counter) and
    :meth:`restore` brings both back, so resumed training replays bit
    for bit.

    ``mesh`` (default: the started postoffice's): on a mesh of several
    ranks this worker is one rank of the JAX mesh worker (the module's
    docstring). Every rank of the mesh makes the same calls in the same
    order: the steps, and :meth:`weights_dense`, :meth:`pull`,
    :meth:`predict`, :meth:`evaluate`, which assemble the table over the
    server axis, and :meth:`save_model` (each rank of data row 0 writes
    its own shard's file). The state (``state``, :meth:`state_host`, checkpoints) is
    this rank's server shard; ``convert.shard_state`` and
    ``convert.unshard_state`` move it to and from whole tables."""

    mesh = None  # the mesh the steps' collectives run over (None: one card)

    def __init__(self, conf: Config, device=None, name: str = "async_sgd_worker", mesh=None):
        super().__init__(name=name)
        if mesh is None and self.po.started:
            mesh = self.po.mesh
        self.mesh = _mesh_or_none(mesh)
        if self.mesh is not None:
            device = self.mesh.device
        elif device is None and self.po.started:
            device = self.po.device
        self.device = resolve(device)
        self.conf = conf
        sgd = conf.async_sgd or SGDConfig()
        sgd.validate()
        self.sgd = sgd
        self.loss = create_loss(conf.loss.type)
        self.penalty = create_penalty(conf.penalty.type, conf.penalty.lambda_)
        self.lr = LearningRate(
            conf.learning_rate.type, conf.learning_rate.alpha, conf.learning_rate.beta
        )
        self.updater = create_updater(
            sgd.algo, sgd.ada_grad, self.lr, self.penalty,
            ftrl_state_dtype=sgd.ftrl_state_dtype,
        )
        if sgd.wire not in ("", "i32", "u24", "bits", "stream"):
            raise ValueError(
                f"unknown SGDConfig.wire {sgd.wire!r}; expected "
                "'i32', 'u24', 'bits', 'stream', or '' (legacy "
                "wire_u24 flag)"
            )
        if sgd.wire_compress not in ("", "lz"):
            raise ValueError(
                f"unknown SGDConfig.wire_compress {sgd.wire_compress!r}; "
                "expected '' or 'lz'"
            )
        if sgd.wire_encode not in wire.WIRE_ENCODE_MODES:
            raise ValueError(
                f"unknown SGDConfig.wire_encode {sgd.wire_encode!r}; "
                f"expected one of {wire.WIRE_ENCODE_MODES}"
            )
        if sgd.wire_cache_mb < 0:
            raise ValueError(
                f"SGDConfig.wire_cache_mb must be >= 0, got {sgd.wire_cache_mb}"
            )
        # FIXING_FLOAT push/pull filters -> the n-byte quantized wire of
        # the dense step; ADD_NOISE -> the perturbation on either side
        self._wire = dict(
            push_quant=_fixing_float_bytes(sgd.push_filter, "push_filter"),
            pull_quant=_fixing_float_bytes(sgd.pull_filter, "pull_filter"),
            push_noise=_add_noise_params(sgd.push_filter),
            pull_noise=_add_noise_params(sgd.pull_filter),
            pull_narrow=sgd.pull_gather == "narrow",  # "auto" is wide
        )
        n_server = 1 if self.mesh is None else meshlib.num_servers(self.mesh)
        self.num_slots = pad_slots(sgd.num_slots, n_server)
        #: this rank's rows of the table: its server shard
        self.shard_rows = self.num_slots // n_server
        self._update_mode = self._resolve_update_mode(sgd)
        # which FTRL update the steps run: a CUDA kernel or the plain version
        self.update_path = resolve_update_path(
            self._update_mode, on_cuda=self.device.type == "cuda"
        )
        # the hash modulus is the CONFIGURED slot count, not the padded
        # table size (the JAX worker's rule)
        self.directory = KeyDirectory(sgd.num_slots, hashed=True)
        self.state = self.updater.init(self.shard_rows, self.device)
        self._steps: Dict[Tuple, object] = {}
        self._seed_counter = 0
        self._pads: Optional[Tuple[int, int, int]] = None
        self._pull_state = self._snapshot()
        self._steps_since_snapshot = 0
        self.last_staleness = 0
        # the ongoing replica: refreshed every replica_every ministeps on
        # the executor (None until the first step, or after a load)
        self._replica_state: Optional[Dict[str, torch.Tensor]] = None
        self._steps_since_replica = 0
        self.progress = SGDProgress()
        # at most τ + 1 steps in flight on the customer's executor (τ = 0
        # still lets the next step be submitted while one runs; 0 would
        # leave it unbounded)
        self.executor.max_in_flight = max(0, sgd.max_delay) + 1
        weakref.finalize(self, self.executor.stop)
        # the pinned buffers of the uploads to the card
        self.staging = PinnedStaging(self.device) if self.device.type == "cuda" else None
        self._side_stream = None
        self._stream_statics = None
        self._stream_statics_set = False
        self.upload_cache: Optional[wire.UploadCache] = None  # the last pipelined train's
        # the live bounded delay: max_delay is its cap (adaptive τ moves it)
        self._effective_tau = max(0, sgd.max_delay)
        self._significance = None
        if sgd.kkt_filter:
            if self._update_mode != "sparse":
                raise ValueError(
                    "SGDConfig.kkt_filter requires update='sparse' (the "
                    "mask is defined on the globally-deduped unique-slot "
                    f"vectors); resolved update mode is {self._update_mode!r}"
                )
            if sgd.algo != "ftrl" or getattr(self.penalty, "lambda1", 0.0) <= 0.0:
                raise ValueError(
                    "SGDConfig.kkt_filter derives its threshold from the "
                    "FTRL proximal dead zone: algo='ftrl' and an L1 "
                    "penalty (lambda1 > 0) are required"
                )
            if sgd.kkt_drop_after > 0 and sgd.ingest_workers != 1:
                raise ValueError(
                    "SGDConfig.kkt_drop_after > 0 (host-side key drop) "
                    "requires the serial prep path: set ingest_workers=1"
                )
            self._significance = SignificanceSpec(
                l1=float(self.penalty.lambda1), margin=float(sgd.kkt_margin),
                escape=float(sgd.kkt_escape), feedback=sgd.kkt_drop_after > 0,
            )
        # learning truth plane (telemetry/learning.py): realized
        # staleness per submission, key heat by server key range,
        # convergence metering in collect(); bound to the registry of now
        if telemetry_registry.enabled():
            from ...telemetry import learning as learning_mod

            self._learning = learning_mod.plane(
                self.name, num_slots=self.num_slots, num_shards=n_server,
                max_delay=max(0, sgd.max_delay),
            )
        self._heat_counter = 0  # feeder/trainer thread only
        self._heat_feed: Optional[KeyHeatFeed] = None  # set for a train or a minibatch
        self._row_checked = self.mesh is None  # dispatch thread only
        self._snapshot_ts: Optional[int] = None  # submit thread only
        if sgd.tau_adaptive or sgd.kkt_filter:
            self._consistency = ConsistencyRuntime.from_config(self, sgd)
        #: the host drop set's feedback is on (the KKT filter's tracker
        #: keeps a drop set)
        self._drop_feedback = bool(sgd.kkt_filter and sgd.kkt_drop_after > 0)
        #: the drop set's stamp the next submission's batch was prepped
        #: under (submit thread only)
        self._prep_drop_stamp = (0, 0)
        #: on a mesh, the host decisions a launch depends on (the drop
        #: set, the encode decision, τ and a reaction) are agreed over the
        #: mesh at every launch (:meth:`_launch_signature`)
        self._agree_launches = self.mesh is not None and (
            self._drop_feedback or bool(sgd.wire_encode) or sgd.tau_adaptive)
        self._last_signature: Optional[tuple] = None  # dispatch thread only

    def _drop_stamp(self) -> tuple:
        """The drop set's ``(version, digest)`` now ((0, 0) without one)."""
        if not self._drop_feedback:
            return (0, 0)
        return self._consistency.tracker.stamp()

    @staticmethod
    def _launch_signature(prepped, tau: int, do_snapshot: bool, drop_stamp: tuple) -> tuple:
        """What a launch's host side decided, as ints: the wire and its
        encoding (an encoded batch's statics), the live τ and the snapshot
        decision, the drop set's version and digest its batch was prepped
        under."""
        static = prepped.static_key() if hasattr(prepped, "static_key") else ()
        kind = pdist.digest_ints(type(prepped).__name__, static)
        return (kind, int(tau), int(do_snapshot), int(drop_stamp[0]), int(drop_stamp[1]))

    _SIGNATURE_NAMES = ("the wire and its encoding", "τ", "the snapshot decision",
                        "the drop set's version", "the drop set's digest")

    def set_effective_tau(self, tau: int) -> int:
        """Move the live bounded delay τ between submissions (adaptive
        τ's actuator), clamped to ``[0, max_delay]``: the configured
        value stays the cap, so the executor (at most ``max_delay + 1``
        steps in flight) is never rebuilt. τ only schedules the snapshot
        refreshes of the next submissions."""
        tau = int(min(max(0, self.sgd.max_delay), max(0, int(tau))))
        self._effective_tau = tau
        if self._learning is not None:
            self._learning.set_tau(tau)
        return tau

    def _note_heat(self, batch: SparseBatch) -> None:
        """Key-heat feed of the learning plane: this batch's keys hashed
        to table slots and folded into the worker's windowed count sketch
        and per-shard shares, every ``plane.heat_every`` batches, on the
        :class:`KeyHeatFeed` threads of the running train or minibatch.
        Called only from the feeder or trainer thread, in stream order."""
        lp = self._learning
        if lp is None or not batch.n:
            return
        self._heat_counter += 1
        if self._heat_counter % lp.heat_every:
            return
        self._heat_feed.note(np.asarray(batch.indices))

    @contextlib.contextmanager
    def _key_heat(self):
        """A :class:`KeyHeatFeed` for the body's notes (none while
        telemetry is off), closed when the body ends: every batch it
        noted is then in the sketch. An error of the body wins over one
        of the feed."""
        if self._learning is None:
            yield
            return
        self._heat_feed = feed = KeyHeatFeed(self._learning, self.directory)
        try:
            yield
        except BaseException:
            with contextlib.suppress(BaseException):
                feed.close()
            raise
        else:
            feed.close()
        finally:
            self._heat_feed = None

    def _note_ftrl_dispatch(self, prepped, n_steps: int) -> None:
        """FTRL update-path accounting (``ps_ftrl_rows_total`` /
        ``ps_ftrl_update_path_total``): the path this worker's steps
        take (``cuda_sparse``, ``cuda_dense`` or ``torch_ref``) and the
        state rows a ministep moves. No-op for other updaters and while
        telemetry is off."""
        from ...telemetry.instruments import cached_ftrl_instruments
        from .updaters import FTRLUpdater

        tel = cached_ftrl_instruments()
        if tel is None:
            return
        if not (isinstance(self.updater, FTRLUpdater)
                and self.updater.lr.type == LearningRate.DECAY):
            return
        if self._update_mode == "sparse":
            uslots = getattr(prepped, "uslots", None)
            rows = int(getattr(prepped, "uniq_pad", 0)
                       or (uslots.shape[-1] if uslots is not None else 0))
        else:
            rows = self.shard_rows
        tel["path"].labels(path=self.update_path).inc(n_steps)
        tel["rows"].inc(rows * n_steps)

    def _snapshot(self):
        """The weight snapshot steps pull from: the live tensors at τ = 0
        (a step gathers before it updates), a copy at τ > 0 (steps update
        the live tensors in place while the snapshot must stay put)."""
        if self.sgd.max_delay <= 0:
            return self.state
        return {k: v.clone() for k, v in self.state.items()}

    def _resolve_update_mode(self, sgd) -> str:
        """``"auto"`` flips to sparse at big tables unless a push/pull
        filter is set (filters are defined on dense shard vectors); an
        explicit ``"sparse"`` with filters raises when its step is built."""
        if sgd.update != "auto":
            return sgd.update
        w = self._wire
        filtered = bool(w["push_quant"] or w["pull_quant"] or w["push_noise"] or w["pull_noise"])
        if self.shard_rows >= sparse_update_min_slots() and not filtered:
            return "sparse"
        return "dense"

    @property
    def num_data(self) -> int:
        """Data rows a minibatch splits into: the mesh's data axis."""
        return 1 if self.mesh is None else meshlib.num_workers(self.mesh)

    def _padding(self, batch: SparseBatch) -> Tuple[int, int, int]:
        """Static shapes, pinned from the first batch as the JAX worker
        pins them: rows per data shard, and a shard's nnz with 25%
        headroom rounded up to 4096. A later batch that outgrows an
        auto-sized pad grows it (the JAX worker raises there): eager
        PyTorch keeps no compiled shape, and a tail-filtered stream keeps
        more keys in its later minibatches than in its first. On a mesh
        every rank sees the same stream, so every rank pads alike.
        Padding entries change no result."""
        d = self.num_data
        per = -(-batch.n // d)
        rows = self.sgd.rows_pad or per
        shard_nnz = max(int(batch.indptr[min((i + 1) * per, batch.n)]
                            - batch.indptr[min(i * per, batch.n)]) for i in range(d))
        nnz = self.sgd.nnz_pad or max(4096, -(-int(-(-batch.nnz // d) * 1.25) // 4096) * 4096)
        if self._pads is None:
            self._pads = (rows, nnz, nnz)
        else:
            r, z, _ = self._pads
            r = rows if per > r and not self.sgd.rows_pad else r
            z = nnz if shard_nnz > z and not self.sgd.nnz_pad else z
            self._pads = (r, z, z)
        if shard_nnz > self._pads[1] and not self.sgd.nnz_pad:
            # a data row denser than the mean: its own size, with the headroom
            z = max(4096, -(-int(shard_nnz * 1.25) // 4096) * 4096)
            self._pads = (self._pads[0], z, z)
        return self._pads

    def prep(self, batch: SparseBatch, device_put: bool = True, pads=None):
        """Localize + pad a batch: the deduplicated exact wire for the
        sparse update (unique width padded to a multiple of 1024; the
        compact encoding with ``wire_encode``), else an ELL wire with
        ``ell_lanes``, else the hashed per-entry wire. ``pads``: the
        padding :meth:`_padding` gave this batch in stream order (a prep
        worker of the pipeline must not decide it); decided here if
        None. The KKT drop set filters the batch first."""
        if self._consistency is not None:
            batch = self._consistency.filter_batch(batch, self.directory)
        rows_pad, nnz_pad, _ = pads or self._padding(batch)
        d = self.num_data
        if self._update_mode == "sparse":
            uniq = min(nnz_pad * d, self.num_slots)
            uniq = -(-uniq // 1024) * 1024
            out = self._maybe_encode(prep_batch_shared(
                batch, self.directory, d, rows_pad, nnz_pad, uniq, self.num_slots
            ))
        else:
            out = self._prep_dense(batch, rows_pad, nnz_pad)
        if self.mesh is not None:
            out = pdist.local_from_global(self.mesh, out)  # this rank's data row
        return self.upload(out) if device_put else out

    def _prep_dense(self, batch: SparseBatch, rows_pad: int, nnz_pad: int):
        """The dense update's wires: with ``ell_lanes``, the stream, bits,
        u24 or i32 ELL wire (each falling back to the next where the batch
        lies outside its domain; a row wider than the lanes takes the
        hashed wire), else the hashed per-entry wire."""
        lanes = self.sgd.ell_lanes
        if lanes > 0 and batch.n and int(np.diff(batch.indptr).max()) <= lanes:
            kind = self.sgd.wire or ("u24" if self.sgd.wire_u24 else "i32")
            out = None
            d = self.num_data  # every data row's shard; prep keeps this rank's
            if kind == "stream":
                out = prep_batch_ell_stream(batch, self.directory, d, rows_pad, lanes,
                                            self.num_slots, self._get_stream_statics(batch))
                kind = "bits" if out is None else kind
            if out is None and kind == "bits":
                out = prep_batch_ell_bits(batch, self.directory, d, rows_pad, lanes,
                                          self.num_slots)
                kind = "u24" if out is None else kind
            if out is None:
                out = prep_batch_ell(batch, self.directory, d, rows_pad, lanes, self.num_slots,
                                     pack=kind == "u24" and self.num_slots < (1 << 24))
            return out
        return prep_batch_hashed(batch, self.directory, self.num_data, rows_pad, nnz_pad,
                                 self.num_slots)

    def _maybe_encode(self, out):
        """The compact exact wire with ``wire_encode`` (stateless: runs
        on the prep pool); the raw wire where the batch lies outside the
        encoding's domain."""
        if not self.sgd.wire_encode:
            return out
        enc = wire.encode_exact(out, self.num_slots, mode=self.sgd.wire_encode)
        return out if enc is None else enc

    def _get_stream_statics(self, batch: SparseBatch):
        """The stream wire's statics, derived from the first batch of
        uniform binary rows and then pinned (on the feeder, before the
        prep pool sees a batch). None: no lane split wins on this data,
        and the run stays on the bits wire."""
        if not self._stream_statics_set:
            counts = np.diff(batch.indptr)
            if batch.binary and batch.n and (counts == self.sgd.ell_lanes).all():
                self._stream_statics = wire.derive_stream_statics(
                    batch.indices, self.sgd.ell_lanes, self.directory.num_slots,
                    self.num_slots)
                self._stream_statics_set = True
        return self._stream_statics

    def upload(self, prepped, stream=None):
        """Host arrays -> tensors on the worker's device (int32 ids stay
        int32: every gather and segment sum here takes them as they are;
        uint32 words and uint16 codes travel as their int32 and int16
        views; a CompressedBatch is decoded first).
        To the card through pinned staging buffers, on ``stream`` (the
        caller's current stream by default), never from pageable memory;
        the result carries the copy's event as ``ready``. On the CPU the
        tensors share the arrays' memory."""
        prepped = wire.maybe_decompress(prepped)  # the staging leg's LZ frames
        names = wire.array_fields(prepped)
        if names and isinstance(getattr(prepped, names[0]), torch.Tensor):
            return prepped
        if self.device.type != "cuda":
            return wire.as_tensors(prepped, self.device)
        return self.staging.copy(prepped, stream or torch.cuda.current_stream(self.device))

    @property
    def upload_stream(self):
        """The side CUDA stream of the pipelined train's uploads."""
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        return self._side_stream

    def _get_step(self, prepped, with_aux: bool):
        """The step for a prepped batch's wire, built once a wire and
        static shape. The KKT filter rides the exact wires' steps."""
        exact = dict(update=self._update_mode, significance=self._significance, mesh=self.mesh,
                     **self._wire)
        lanes = self.sgd.ell_lanes
        if isinstance(prepped, wire.EncodedEllStreamSuperBatch):
            key, build = ("ell_stream_scan", with_aux), lambda: make_train_step_ell_stream_scan(
                self.updater, self.loss, self.num_slots, with_aux, mesh=self.mesh, **self._wire)
        elif isinstance(prepped, wire.EncodedEllStreamBatch):
            key, build = ("ell_stream", with_aux), lambda: make_train_step_ell_stream(
                self.updater, self.loss, self.num_slots, with_aux, mesh=self.mesh, **self._wire)
        elif isinstance(prepped, wire.EncodedExactSuperBatch):
            key, build = ("exact_enc_scan", with_aux), lambda: make_train_step_encoded_scan(
                self.updater, self.loss, self.num_slots, with_aux, **exact)
        elif isinstance(prepped, wire.EncodedExactBatch):
            key, build = ("exact_enc", with_aux), lambda: make_train_step_encoded(
                self.updater, self.loss, self.num_slots, with_aux, **exact)
        elif isinstance(prepped, PreppedSuperBatch):
            key, build = ("exact_scan", with_aux), lambda: make_train_step_scan(
                self.updater, self.loss, self.num_slots, with_aux, **exact)
        elif isinstance(prepped, ELLBitsSuperBatch):
            key, build = ("ell_bits_scan", with_aux), lambda: make_train_step_ell_bits_scan(
                self.updater, self.loss, self.num_slots, lanes, with_aux, mesh=self.mesh,
                **self._wire)
        elif isinstance(prepped, ELLBitsBatch):
            key, build = ("ell_bits", with_aux), lambda: make_train_step_ell_bits(
                self.updater, self.loss, self.num_slots, lanes, with_aux, mesh=self.mesh,
                **self._wire)
        elif isinstance(prepped, (ELLBatch, ELLPackedBatch)):
            packed, binary = isinstance(prepped, ELLPackedBatch), prepped.vals is None
            key, build = ("ell", packed, binary, with_aux), lambda: make_train_step_ell(
                self.updater, self.loss, self.num_slots, binary, with_aux, packed=packed,
                mesh=self.mesh, **self._wire)
        elif isinstance(prepped, HashedBatch):
            key, build = ("hashed", with_aux), lambda: make_train_step_hashed(
                self.updater, self.loss, self.num_slots, with_aux, mesh=self.mesh, **self._wire)
        else:
            key, build = ("exact", with_aux), lambda: make_train_step(
                self.updater, self.loss, self.num_slots, with_aux, **exact)
        if key not in self._steps:
            route = self._update_mode if key[0].startswith("exact") else "dense"
            self._steps[key] = _step_variants(build(), _STEP_NAMES[key[0]], route)
        return self._steps[key]

    def _submit_prepped(self, prepped, with_aux: bool = True) -> int:
        """Submit one step (or one T-step superbatch) on a prepped batch
        to the executor; returns its timestamp. Seeds follow the JAX
        worker: the counter advances by the ministep count and the
        launch's first ministep gets ``counter - (n_steps - 1)``.

        The bounded-delay schedule is the JAX worker's and is fixed here,
        on the submitting thread: a submission takes a fresh weight
        snapshot when the live τ is 0 or when τ ministeps have run since
        the last one, and otherwise computes on the last snapshot. The snapshot
        itself is taken when the step runs, on the dispatch thread, where
        the state advances in submission order. At τ = 0 it is the live
        tensors (the step gathers before it updates); at τ > 0 a copy.
        The first τ ministeps pull the state the worker started from (or
        loaded). On the card the step's stream first waits for the
        batch's upload."""
        prepped = self.upload(prepped)
        n_steps = prepped.steps if isinstance(prepped, _SUPERBATCHES) else 1
        tau = self._effective_tau
        do_snapshot = tau == 0 or self._steps_since_snapshot >= tau
        self.last_staleness = 0 if do_snapshot else self._steps_since_snapshot
        if do_snapshot:
            self._steps_since_snapshot = 0
        step_fn = self._get_step(prepped, with_aux)
        self._seed_counter += n_steps
        seed = (self._seed_counter - (n_steps - 1)) & _M32
        # the inventory name of this call, as the JAX worker chooses among
        # its donation variants: the pulled state is the live one until a
        # step has run since the last snapshot (or since the start)
        if self._steps_since_snapshot:
            variant = "delay"
        else:
            variant = "snap_donate" if tau <= 0 and not self.sgd.tau_adaptive else "snap"
        self._steps_since_snapshot += n_steps
        ready = getattr(prepped, "ready", None)
        signature = (self._launch_signature(prepped, tau, do_snapshot, self._prep_drop_stamp)
                     if self._agree_launches else None)
        runtime = self._consistency

        def run():
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for name in wire.array_fields(prepped):
                    # allocated on the upload's stream, read on this one
                    getattr(prepped, name).record_stream(stream)
            react = False
            if signature is not None:
                # one decision for the whole mesh, in step order: the
                # launch's host decisions agree on every rank (or every
                # rank raises), and a reaction any rank asked for runs on
                # every rank at this launch's collect
                asked = (runtime.take_request()
                         if runtime is not None and runtime.controller is not None else None)
                react = pdist.agree_on(self.mesh, signature, self._SIGNATURE_NAMES,
                                       flag=asked is not None)
                if react:
                    runtime.note_agreed(asked)
                if signature != self._last_signature:
                    # a new drop set, encoding or τ: hold the batch itself
                    # to the row once more
                    self._row_checked = False
                self._last_signature = signature
            if not self._row_checked:
                # the ranks of this data row fed the same batch, and every
                # data row holds the same global unique slots of the sparse
                # update (collectives: here, on the dispatch thread, in step
                # order)
                shared = prepped.uslots if self._update_mode == "sparse" else None
                if isinstance(prepped, wire.EncodedEllStreamBatch):
                    # the stream wire's lanes: one split on every rank
                    shared = np.asarray([prepped.rows, prepped.lanes, prepped.code_bits,
                                         prepped.dict_pad, prepped.raw_bits,
                                         *prepped.dict_lanes], np.int64)
                pdist.assert_row_agrees(self.mesh, prepped, shared=shared)
                self._row_checked = True
            if do_snapshot:
                self._pull_state = self._snapshot()
            metrics = step_fn(self.state, self._pull_state, prepped, seed, variant)
            if react:
                metrics["consistency_react"] = torch.ones((), device=self.device)
            if self.sgd.num_replicas > 0:
                self._steps_since_replica += n_steps
                if (self._replica_state is None
                        or self._steps_since_replica >= self.sgd.replica_every):
                    self._steps_since_replica = 0
                    self._refresh_replica()
            return metrics

        self._note_ftrl_dispatch(prepped, n_steps)
        ts = self.executor.submit(run)
        if self._learning is not None:
            # logical-clock stamp: the executor timestamp of the
            # snapshot-taking submission vs this one
            if do_snapshot or self._snapshot_ts is None:
                self._snapshot_ts = ts
            self._learning.note_submit(self.last_staleness, n_steps=n_steps,
                                       clock_lag=ts - self._snapshot_ts, tau=tau)
        return ts

    def submit_wait(self, prepped, with_aux: bool = True) -> Dict[str, torch.Tensor]:
        """Run one step (or one T-step superbatch) on a prepped batch and
        wait for it; returns its metrics as tensors on the device (the
        port's blocking submit: ``submit`` is ``Customer.submit``)."""
        return self.executor.wait(self._submit_prepped(prepped, with_aux=with_aux))

    def process_minibatch(self, batch: SparseBatch, report: bool = True,
                          with_aux: bool = True) -> int:
        """Pull → gradient → push for one minibatch, submitted without
        waiting; returns the step's executor timestamp (fold its metrics
        into ``progress`` with :meth:`collect`, or read them with
        :meth:`wait`). ``report`` is the JAX worker's signature: every
        :meth:`collect` reports."""
        del report
        with self._key_heat():
            self._note_heat(batch)
            self._prep_drop_stamp = self._drop_stamp()
            return self._submit_prepped(self.prep(batch, device_put=False), with_aux=with_aux)

    def submit_superbatch(self, batches: List[SparseBatch], with_aux: bool = False):
        """Prep + stack T minibatches and run them as one submission: the
        bits or stream wire, or the exact wire (raw or encoded) in sparse
        mode, where the superstep runs every ministep on the live state.
        A dense-mode exact group raises: it runs per minibatch. Waits for
        the launch and returns its metrics."""
        self._prep_drop_stamp = self._drop_stamp()
        prepped = [self.prep(b, device_put=False) for b in batches]
        stacked = _stack(prepped, self._update_mode)
        if stacked is None:
            raise ValueError(
                "superbatch needs the bits wire (hashed directory, binary "
                "uniform-row batches) or the exact wire in sparse-update "
                "mode (dense-mode exact groups run per-minibatch: the scan "
                "would bypass snapshot/filter semantics); got a "
                "mixed/fallback encoding or a dense-mode exact group"
            )
        return self.submit_wait(stacked, with_aux=with_aux)

    def submit_group(self, batches: List[SparseBatch],
                     with_aux: bool = True) -> List[Tuple[int, int]]:
        """The training loop's tolerant grouping: one T-step superbatch
        where the group stacks, else one step a minibatch. Returns
        ``[(timestamp, n_ministeps), ...]``, so a caller bounds the work
        in flight in ministeps."""
        self._prep_drop_stamp = self._drop_stamp()
        parts = self._prep_group([(b, self._padding(b)) for b in batches])
        return [(self._submit_prepped(p, with_aux=with_aux), n) for p, n in parts]

    def _prep_group(self, group) -> List[Tuple[object, int]]:
        """Host side of one launch group, ``[(batch, pads)]`` (safe on a
        pipeline thread): one T-step superbatch where the group stacks
        (:func:`_stack`), else one part a minibatch. With
        ``wire_compress`` each part's arrays go into LZ frames here, on
        the pool; the uploader decodes them. Returns ``[(host_prepped,
        n_ministeps)]``."""
        prepped = [self.prep(b, device_put=False, pads=pads) for b, pads in group]
        stacked = _stack(prepped, self._update_mode) if len(prepped) > 1 else None
        parts = [(stacked, len(prepped))] if stacked is not None else [(p, 1) for p in prepped]
        if self.sgd.wire_compress:
            parts = [(wire.compress_batch(p, encoding=_wire_encoding_name(p)), n)
                     for p, n in parts]
        return parts

    def ingest_workers(self) -> int:
        """Prep-pool width of the pipelined train: ``SGDConfig.ingest_workers``
        when set, else the host's cores less one, at most 4 (the feeder
        and the submitting thread keep a core)."""
        if self.sgd.ingest_workers > 0:
            return self.sgd.ingest_workers
        return max(1, min(4, (os.cpu_count() or 2) - 1))

    def train(self, batches: Iterable[SparseBatch], pipelined: Optional[bool] = None) -> SGDProgress:
        """A pass over minibatches: groups of ``steps_per_launch`` (T) run
        as one superbatch in sparse mode, one minibatch at a time in dense
        mode. Same submission order and seeds as the JAX worker.

        ``pipelined`` (default: T > 1) moves grouping and the padding
        decision onto a feeder thread, prep onto an ordered pool of
        :meth:`ingest_workers` threads and the upload onto a
        :class:`DeviceUploader` thread and side stream, so they overlap
        the steps. Submission stays on this thread, in order: the
        trajectory is bit-identical to the serial path's."""
        T = max(1, self.sgd.steps_per_launch)
        if pipelined is None:
            pipelined = T > 1
        try:
            with self._key_heat():
                return self._train_impl(iter(batches), T, pipelined)
        except BaseException:
            # leave no step of this pass running on the dispatch thread
            with contextlib.suppress(Exception):
                self.executor.wait_all(pop=False)
            raise

    def _train_impl(self, batches, T: int, pipelined: bool) -> SGDProgress:
        pending: List[Tuple[int, int]] = []  # (timestamp, ministeps)
        # collect in MINISTEPS (the metrics' memory grows with them),
        # always leaving at least one whole launch in flight
        bound = max(T, self.sgd.max_delay + 1)

        def collect_over_bound():
            while sum(n for _, n in pending) > bound:
                self.collect(pending.pop(0)[0])

        def groups():
            group = []
            for batch in batches:
                # the stream wire's statics are decided here, in stream
                # order, before a prep worker sees the batch
                if self.sgd.wire == "stream" and not self._stream_statics_set:
                    self._get_stream_statics(batch)
                # key heat is noted in stream order here (the feeder when
                # pipelined) and folded on the feed's own thread
                self._note_heat(batch)
                group.append(batch)
                if len(group) >= T:
                    yield group
                    group = []
            if group:
                yield group

        if pipelined:
            workers = self.ingest_workers()
            # with the host drop set, group g is prepped once this thread
            # has submitted group g - 1 and collected what the serial path
            # collects after it: the drop set a prep sees is the serial
            # path's, on every rank alike, whatever the threads' timing
            gate = _GroupGate() if self._drop_feedback else None

            def padded_groups():
                # the padding too is decided on the feeder, in stream order
                for g, group in enumerate(groups()):
                    yield g, [(b, self._padding(b)) for b in group]

            def prep_group(item):
                g, group = item
                if gate is not None:
                    gate.wait_for(g)
                return self._prep_group(group)

            # each staged group holds T prepped batches: the window also
            # bounds the host memory
            pipe = IngestPipeline(padded_groups(), prep_fn=prep_group, workers=workers,
                                  capacity=2 * workers, name="train_ingest").start()

            def parts():
                # each part with its ministeps and whether it ends its group
                for group_parts in pipe:
                    for i, (p, n) in enumerate(group_parts):
                        yield p, (n, i == len(group_parts) - 1)

            stream = self.upload_stream if self.device.type == "cuda" else None

            def upload_fn(p):
                return self.upload(p, stream)

            if self.sgd.wire_cache_mb > 0:
                # stateful: lives on the uploader's one thread
                upload_fn = self.upload_cache = wire.UploadCache(
                    upload_fn, max_bytes=self.sgd.wire_cache_mb << 20)
            uploader = DeviceUploader(parts(), upload_fn, depth=2)
            self._prep_drop_stamp = self._drop_stamp()
            try:
                for staged, (n, last) in uploader:
                    # submitted under the batch's flow id, so the
                    # executor.step span correlates back through upload,
                    # prep and read in the timeline
                    with telemetry_spans.flow_scope(uploader.next_flow()):
                        pending.append((self._submit_prepped(staged, with_aux=True), n))
                    collect_over_bound()
                    if last:
                        # the next group is prepped under the drop set now
                        self._prep_drop_stamp = self._drop_stamp()
                        if gate is not None:
                            gate.advance()
            finally:
                if gate is not None:
                    gate.abort()  # a prep waiting for a group that never comes
                # the uploader first: no thread is left inside a copy
                uploader.close()
                pipe.close()
        else:
            for group in groups():
                pending.extend(self.submit_group(group, with_aux=True))
                collect_over_bound()
        for ts, _ in pending:
            self.collect(ts)
        return self.progress

    def _drain(self) -> None:
        """Wait for every step in flight, leaving its metrics to collect."""
        self.executor.wait_all(pop=False)

    # -- the ongoing server replica --

    def _refresh_replica(self) -> None:
        """Copy the state into the replica (dispatch thread, after a
        step, on its stream). On a mesh of several server shards each
        rank's shard goes to its server neighbour (a ring: the JAX
        worker's roll by a shard's width); with one, the buffers are
        reused once they exist."""
        if self._server_shards() > 1:
            self._replica_state = {
                k: meshlib.shift(v, SERVER_AXIS, self.mesh, 1) if v.dim() >= 1 else v.clone()
                for k, v in self.state.items()}
            return
        rep = self._replica_state
        if rep is None:
            self._replica_state = {k: v.clone() for k, v in self.state.items()}
        else:
            for k, v in self.state.items():
                rep[k].copy_(v)

    def _server_shards(self) -> int:
        return 1 if self.mesh is None else meshlib.num_servers(self.mesh)

    def recover_server_shard(self, shard: int) -> bool:
        """Rebuild a dead server shard's slot rows from the replica (ref
        Parameter::Recover), at most ``replica_every`` ministeps stale;
        False when no replica was taken. Submitted through the executor,
        in order with the steps in flight; the pull snapshot re-anchors
        on the restored state. On a mesh every rank calls it: the
        neighbour holding the shard's copy sends it back over the server
        ring, and the shard's ranks install it."""
        if self._replica_state is None:
            return False
        rows = server_shard_rows(shard, self.num_slots)  # one server shard

        def do_recover():
            for k, v in self.state.items():
                if v.dim() < 1:
                    continue
                if self._server_shards() > 1:
                    back = meshlib.shift(self._replica_state[k], SERVER_AXIS, self.mesh, -1)
                    if self.mesh.server_index == shard:
                        v.copy_(back)
                else:
                    v[rows].copy_(self._replica_state[k][rows])
            self._pull_state = self._snapshot()
            return True

        return bool(self.executor.wait(self.executor.submit(do_recover)))

    def wipe_server_shard(self, shard: int) -> None:
        """Zero a server shard's slot rows, as a replacement server that
        boots empty would hold them, through the executor (on a mesh, on
        the shard's ranks; every rank calls it)."""
        rows = server_shard_rows(shard, self.num_slots)

        def do_wipe():
            sharded = self._server_shards() > 1
            if not sharded or self.mesh.server_index == shard:
                for v in self.state.values():
                    if v.dim() >= 1:
                        (v if sharded else v[rows]).zero_()
            self._pull_state = self._snapshot()

        self.executor.wait(self.executor.submit(do_wipe))

    def replica_host(self) -> Optional[dict]:
        """This rank's replica as host arrays (the copy of server shard
        ``s - 1`` on a mesh, of the whole state with one shard), or None
        before the first refresh."""
        self._drain()
        return None if self._replica_state is None else state_to_numpy(self._replica_state)

    # -- serving the trained table --

    def _whole(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole table from this rank's server shard (a collective over
        the server axis on a mesh)."""
        if self.mesh is None:
            return shard
        return meshlib.all_gather(shard, SERVER_AXIS, self.mesh)

    def weights_dense(self) -> np.ndarray:
        """The whole weight vector, derived from the optimizer state (on
        a mesh, assembled over the server axis: every rank calls it)."""
        self._drain()
        return self._whole(self.updater.weights(self.state)).cpu().numpy()

    def _slot_weights(self, slots: torch.Tensor) -> torch.Tensor:
        self._drain()
        rel, ok = localize(slots, self.shard_rows, self.mesh)
        w = torch.where(ok, self.updater.weights(_gather_state(self.state, rel)), 0.0)
        return w if self.mesh is None else psum(w, SERVER_AXIS, self.mesh)

    def pull(self, keys: np.ndarray) -> np.ndarray:
        """Weights of the given feature keys (a pull from the table)."""
        slots = torch.as_tensor(self.directory.slots(keys)).to(self.device)
        return self._slot_weights(slots).cpu().numpy()

    def predict(self, batch: SparseBatch) -> np.ndarray:
        """Margins Xw of a batch under the current weights."""
        slots = torch.as_tensor(self.directory.slots(batch.indices)).to(self.device)
        vals = torch.as_tensor(batch.value_array()).to(self.device)
        rows = torch.as_tensor(batch.row_ids()).to(self.device)
        xw = _segment_sum(vals * self._slot_weights(slots), rows, batch.n, presorted=True)  # CSR rows
        return xw.cpu().numpy()

    def evaluate(self, batch: SparseBatch) -> Dict[str, float]:
        """Validation metrics on a batch."""
        xw = self.predict(batch)
        return {
            "auc": evaluation.auc(batch.y, xw),
            "accuracy": evaluation.accuracy(batch.y, xw),
            "logloss": evaluation.logloss(batch.y, xw),
        }

    def save_model(self, path: str) -> List[str]:
        """Nonzero weights as ``slot\\tweight`` text, one file a server
        shard, ``{path}_S{s}`` (one, ``_S0``, with no mesh), as the JAX
        worker writes them. The directory is hashed, so the keys are
        table slots, under a ``#hashed <num_slots>`` header that tells a
        reader to route lookups through the same hash. On a mesh every
        rank calls it: the ranks of data row 0 each write their own
        shard's file, and no rank returns before every file is whole."""
        self._drain()
        if self.mesh is None:
            return [self._write_shard(f"{path}_S0", 0)]
        written = [f"{path}_S{s}" for s in range(meshlib.num_servers(self.mesh))]
        if self.mesh.data_index == 0:
            s = self.mesh.server_index
            self._write_shard(written[s], s * self.shard_rows)
        done = torch.zeros(1, device=self.device)
        psum(psum(done, SERVER_AXIS, self.mesh), DATA_AXIS, self.mesh)
        return written

    def _write_shard(self, spath: str, first: int) -> str:
        """This rank's shard's nonzero weights, its row ``i`` as slot
        ``first + i``. The nonzeros are found where the table lies, a
        chunk of slots at a time (the weights are elementwise): a
        2^30-slot table sends only its nonzero weights to the host, with
        a chunk's temporaries."""
        rows = min(self.shard_rows, self.num_slots - first)
        with psfile.open_write(spath) as f:
            f.write(f"#hashed\t{self.directory.num_slots}\n")
            for lo in range(0, rows, _SAVE_CHUNK):
                hi = min(lo + _SAVE_CHUNK, rows)
                w = self.updater.weights({k: (v[lo:hi] if v.dim() >= 1 else v)
                                          for k, v in self.state.items()})
                nz = torch.nonzero(w).reshape(-1)
                weights = w.index_select(0, nz).cpu().tolist()
                slots = (nz + (first + lo)).cpu().tolist()
                f.writelines(f"{i}\t{v!r}\n" for i, v in zip(slots, weights))
        return spath

    # -- state snapshot / restore (the JAX worker's state_host format) --

    def state_host(self) -> dict:
        self._drain()
        return {
            "state": state_to_numpy(self.state),
            "seed_counter": np.int64(self._seed_counter),
        }

    def load_state_host(self, snap: dict) -> None:
        """Install a host snapshot (this port's or the JAX worker's);
        only dead padding is trimmed or zero-extended. Leaves take this
        worker's dtypes (a bf16 leaf widened to f32 by ``state_to_numpy``
        narrows back exactly)."""
        self._drain()
        self._install(state_from_jax(snap["state"], self.device), snap["seed_counter"])

    # checkpoint_async: inherited from Checkpointable on one card (state_host
    # drains and carries the seed counter)

    def _whole_host(self) -> dict:
        """The whole state and the seed counter, as host arrays: the
        state gathered over the server axis (a collective on the calling
        thread, after a drain, so no step's collective runs beside it)."""
        self._drain()
        whole = {k: meshlib.all_gather(v, SERVER_AXIS, self.mesh) if v.dim() >= 1 else v
                 for k, v in self.state.items()}
        return {"state": state_to_numpy(whole), "seed_counter": np.int64(self._seed_counter)}

    def _mesh_barrier(self) -> None:
        """Every rank of the mesh past this point (a psum of each axis)."""
        done = torch.ones((), device=self.device)
        psum(psum(done, SERVER_AXIS, self.mesh), DATA_AXIS, self.mesh)

    def checkpoint(self, manager, step: int) -> str:
        """Save step ``step``: :meth:`state_host` on one card; on a mesh
        the whole state, as the JAX mesh worker checkpoints it (gathered
        over the server axis, written by rank 0, every rank returning once
        the file is whole), so that a mesh of another shape or the JAX
        package restores it. Every rank of a mesh calls it."""
        if self.mesh is None:
            return super().checkpoint(manager, step)
        tree = self._whole_host()
        path = manager._step_dir(step)
        if self.mesh.rank == 0:
            manager.save(step, tree)
        self._mesh_barrier()
        return path

    def checkpoint_async(self, manager, step: int) -> str:
        """As :meth:`checkpoint`, the disk write on a thread. On a mesh
        the drain and the gather stay on the calling thread, in the
        ranks' shared order of collectives; rank 0 takes owned host
        copies and writes them on a thread (the same arrays as
        :meth:`checkpoint`'s), and every rank returns without waiting for
        the write. Rank 0's next ``checkpoint`` waits for it, and so does
        every rank's :meth:`restore` (rank 0 finishes the write, then the
        ranks meet)."""
        if self.mesh is None:
            return super().checkpoint_async(manager, step)
        tree = self._whole_host()
        path = manager._step_dir(step)
        if self.mesh.rank == 0:
            manager.save_async(step, tree)
        return path

    def restore(self, manager, step: Optional[int] = None) -> int:
        """Restore the state and the seed counter from the latest (or
        the given) checkpoint of ``manager`` (a
        :class:`~...parameter.replica.CheckpointManager`, the JAX
        package's npz format) and return its step. The leaves are fitted
        to this worker's padding and dtypes; training resumed from here
        replays bit for bit, its seed stream (the quantization noise)
        included. On a mesh the checkpoint holds the whole state (taken
        at any server count, or by the JAX package): every rank reads it
        and installs its own shard."""
        self._drain()
        if self.mesh is not None:
            # a write in flight (rank 0's checkpoint_async) lands first
            manager.wait()
            self._mesh_barrier()
        if step is None:
            step = manager.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {manager.directory}")
        if self.mesh is None:
            tree = manager.restore(step, like={"state": self.state,
                                               "seed_counter": np.int64(0)})
            self._install(tree["state"], tree["seed_counter"])
            return step
        like = {k: np.zeros((1,) * v.dim(), np.float32) for k, v in self.state.items()}
        tree = manager.restore(step, like={"state": like, "seed_counter": np.int64(0)})
        whole = {k: _fit_rows(np.asarray(v), self.num_slots) for k, v in tree["state"].items()}
        shard = shard_state(whole, meshlib.num_servers(self.mesh), self.mesh.server_index,
                            self.device)
        self._install(shard, tree["seed_counter"])
        return step

    def _install(self, state: Dict[str, torch.Tensor], seed_counter) -> None:
        """Make ``state`` (tensors on this device) the worker's, fitted
        to its padding and dtypes; the pull snapshot re-anchors and the
        seed counter comes back. The steps in flight have drained."""
        for k, leaf in state.items():
            leaf = state[k] = leaf.to(self.state[k].dtype)
            if leaf.dim() >= 1 and leaf.shape[0] != self.shard_rows:
                fitted = torch.zeros(self.shard_rows, dtype=leaf.dtype, device=leaf.device)
                m = min(self.shard_rows, leaf.shape[0])
                fitted[:m] = leaf[:m]
                state[k] = fitted
        self.state = state
        self._pull_state = self._snapshot()
        self._steps_since_snapshot = 0
        self._replica_state = None  # the replica of the old state goes
        self._seed_counter = int(seed_counter)

    def remove(self) -> None:
        """Stop the executor (the step running completes, the steps not
        started are dropped) and leave the postoffice's manager."""
        self.executor.stop()
        super().remove()


class AsyncSGDScheduler(ISGDScheduler):
    """Workload dispatch and the progress table (ref AsyncSGDScheduler):
    each ``training_data`` file pattern is one workload a pass, for
    ``num_data_pass`` passes, each pass's patterns shuffled by Python's
    ``random`` (the JAX scheduler's pool)."""

    def __init__(self, conf: Config, name: str = "async_sgd_scheduler"):
        from ...learner.workload_pool import Workload, WorkloadPool

        sgd = conf.async_sgd or SGDConfig()
        load = Workload(files=list(conf.training_data.file), replica=sgd.num_data_pass,
                        shuffle=True)
        super().__init__(workload_pool=WorkloadPool(load), name=name)
        self.conf = conf
