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

The host side runs as the JAX worker's does. Steps run on an
:class:`~...system.executor.Executor`'s dispatch thread, at most τ + 1
in flight; seeds and the snapshot schedule are fixed on the submitting
thread, in submission order, so every path gives the same trajectory.
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

Not ported yet (``SGDConfig.validate`` raises ``NotImplementedError``):
server replicas; multi-GPU.
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
from ...convert import state_from_jax, state_to_numpy
from ...learner import wire
from ...learner.consistency import ConsistencyRuntime
from ...learner.ingest import IngestPipeline
from ...learner.sgd import SGDProgress
from ...ops import quantize as qops
from ...ops import wire_codec as wc
from ...ops.ftrl_sparse import resolve_update_path
from ...ops.kv_ops import localize, slot_sentinel, valid_slots
from ...ops.significance import SignificanceSpec, kkt_mask
from ...ops.segment_sum import segment_sum as _segment_sum
from ...parameter.parameter import KeyDirectory, pad_slots
from ...system.executor import Executor
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


def _gather_state(state, idx):
    """Rows ``idx`` of every 1-D state leaf; scalars pass through."""
    return {k: (v.index_select(0, idx) if v.dim() >= 1 else v) for k, v in state.items()}


def _progress_metrics(loss, y, xw, mask, with_aux: bool) -> Dict[str, torch.Tensor]:
    """SGDProgress scalars (padding rows masked out); the per-example
    xw/y/mask aux feeds the host-side AUC."""
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


def mix_seed(seed: int, mul: int, index: int = 0) -> int:
    """``seed * mul + index`` in wrapping 32-bit arithmetic: the JAX
    production wire's per-shard quantization seed (``mul`` 1000003 for
    the push with the data shard's index, 999983 for the pull with the
    server shard's; both indices are 0 on one card)."""
    return (int(seed) * mul + index) & _M32


_PUSH_SEED_MUL, _PULL_SEED_MUL = 1000003, 999983
_PUSH_NOISE_SALT, _PULL_NOISE_SALT = 0xA015E, 0xA015F


def _make_perturb(noise, salt: int):
    """ADD_NOISE wire op: N(mean, std) on nonzero entries, or None when
    disabled. A mean-only filter (std=0, mean!=0) still applies, adding
    the constant. The draws come from a ``torch.Generator`` seeded from
    (salt, seed); its stream cannot match ``jax.random.normal``."""
    if noise is None:
        return None
    mean, std = float(noise[0]), float(noise[1])
    if mean == 0.0 and std <= 0.0:
        return None

    def perturb(g, seed):
        gen = torch.Generator(device=g.device)
        gen.manual_seed((salt << 32) | (int(seed) & _M32))
        n = mean + std * torch.randn(g.shape, generator=gen, device=g.device, dtype=g.dtype)
        return torch.where(g != 0, g + n, g)

    return perturb


def make_push_reduce(push_quant: int, noise=None):
    """The push wire, ``(g_shard, seed) -> g``: optionally ADD_NOISE,
    then, with ``push_quant`` bytes, the FIXING_FLOAT push filter: the
    shard gradient is stochastically rounded to fixed point with its own
    [min, max] scale and decoded; entries that were zero stay exactly
    zero (absent keys get no quantization noise). The cross-worker sum
    of the JAX wire is the identity on one card."""
    perturb = _make_perturb(noise, _PUSH_NOISE_SALT)
    if not push_quant:
        return (lambda g, seed: g) if perturb is None else perturb

    def reduce(g, seed):
        if perturb is not None:
            g = perturb(g, seed)  # ADD_NOISE rides the wire before quantize
        q, lo, hi = qops.quantize(g, mix_seed(seed, _PUSH_SEED_MUL), num_bytes=push_quant)
        return torch.where(g != 0, qops.dequantize(q, lo, hi, push_quant), 0.0)

    return reduce


def make_push_touched(push_quant: int, noise=None):
    """``(g_shard, seed) -> (reduced g, touched)``. Without quantization
    the reduced gradient's support is membership (``touched=None``: the
    FTRL kernel derives it in place). Under a quantized push, rounding
    zeroes small gradients, so membership is taken before quantization
    as an explicit mask."""
    push_reduce = make_push_reduce(push_quant, noise=noise)
    if not push_quant:
        return lambda g_shard, seed: (push_reduce(g_shard, seed), None)
    return lambda g_shard, seed: (push_reduce(g_shard, seed), g_shard != 0)


def make_pull_lookup(updater, pull_quant: int, noise=None):
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
    derived weights."""
    perturb = _make_perturb(noise, _PULL_NOISE_SALT)
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
        q, lo, hi = qops.quantize(w, mix_seed(seed, _PULL_SEED_MUL), num_bytes=pull_quant)
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


def _make_exact_mini_step(updater, loss, shard: int, with_aux: bool, update: str,
                          push_quant: int = 0, pull_quant: int = 0,
                          push_noise=None, pull_noise=None, pull_narrow=False,
                          significance: Optional[SignificanceSpec] = None):
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
    step."""
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
    push_touched = make_push_touched(push_quant, noise=push_noise)
    pull_derive, pull_lookup = make_pull_lookup(updater, pull_quant, noise=pull_noise)

    def mini_step(live, pulled, seed, y, mask, rows, ucols, vals, uslots, umask):
        rel, ok = localize(uslots, shard)
        w_u = pull_lookup(pull_derive(pulled, seed), rel, ok) * umask
        # rows are in CSR order with the padding (row 0, value 0) at the
        # end: each row's nonzero entries lie in one run, so no sort
        xw = _segment_sum(vals * w_u.index_select(0, ucols), rows, y.shape[0], presorted=True)
        gr = loss.row_grad(y, xw) * mask
        g_u = _segment_sum(vals * gr.index_select(0, rows), ucols, uslots.shape[0])
        g_u = g_u * umask
        metrics = _progress_metrics(loss, y, xw, mask, with_aux)
        if update == "sparse":
            g_pushed, ok_upd = g_u, ok
            if significance is not None:
                z_u = torch.where(ok, pulled["z"].index_select(0, rel), 0.0) * umask
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

    return mini_step


def _fold_metrics(per_step: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Scan fold: scalars sum over the ministeps; the per-example aux
    stays stacked per ministep ([T, D, R])."""
    return {
        k: (torch.stack([m[k] for m in per_step]).sum(0) if per_step[0][k].dim() == 0
            else torch.stack([m[k] for m in per_step]))
        for k in per_step[0]
    }


def _one_step(mini_step, decode):
    """``step(live, pulled, batch, seed) -> metrics`` over one minibatch:
    ``decode(batch, index)`` gives the ministep's arrays of data shard
    ``index``."""

    def step(live, pulled, batch, seed=0):
        return mini_step(live, pulled, seed, *decode(batch, 0))

    return step


def _scan_step(mini_step, decode):
    """T ministeps of a superbatch in one submission, weights advancing
    every ministep (staleness 0; the pulled snapshot is not read);
    ministep i uses seed + i."""

    def step(live, pulled, batch, seed=0):
        del pulled
        return _fold_metrics([mini_step(live, live, (seed + i) & _M32, *decode(batch, (i, 0)))
                              for i in range(batch.steps)])

    return step


_EXACT = ("y", "mask", "rows", "ucols", "vals", "uslots", "umask")


def _raw_exact(batch, index):
    return tuple(getattr(batch, n)[index] for n in _EXACT)


def make_train_step(updater, loss, num_slots: int, with_aux: bool = True,
                    update: str = "dense", significance=None, **wire_kw):
    """Exact-wire step over one PreppedBatch:
    ``step(live, pulled, batch, seed) -> metrics``, ``live`` updated in
    place. ``wire_kw``: the filter settings of :func:`_make_exact_mini_step`
    (``push_quant``, ``pull_quant``, ``push_noise``, ``pull_noise``,
    ``pull_narrow``)."""
    return _one_step(_make_exact_mini_step(updater, loss, num_slots, with_aux, update,
                                           significance=significance, **wire_kw), _raw_exact)


def make_train_step_scan(updater, loss, num_slots: int, with_aux: bool = True,
                         update: str = "dense", significance=None, **wire_kw):
    """T ministeps over a PreppedSuperBatch in one submission. The KKT
    filter keeps its mask and drops the per-slot feedback, which the
    fold would sum over ministeps."""
    if significance is not None:
        significance = significance.without_feedback()
    return _scan_step(_make_exact_mini_step(updater, loss, num_slots, with_aux, update,
                                            significance=significance, **wire_kw), _raw_exact)


def make_train_step_encoded(updater, loss, num_slots: int, with_aux: bool = True,
                            update: str = "dense", significance=None, **wire_kw):
    """The exact step over an EncodedExactBatch: the encoded arrays are
    decoded on the step's device (``learner/wire.decode_exact_shard``),
    then the same ministep as :func:`make_train_step` runs, so the state
    is bit-identical to the raw wire's."""
    mini_step = _make_exact_mini_step(updater, loss, num_slots, with_aux, update,
                                      significance=significance, **wire_kw)
    return _one_step(mini_step, lambda b, i: wire.decode_exact_shard(b, num_slots, i))


def make_train_step_encoded_scan(updater, loss, num_slots: int, with_aux: bool = True,
                                 update: str = "dense", significance=None, **wire_kw):
    """T encoded ministeps a submission, each decoded as it runs."""
    if significance is not None:
        significance = significance.without_feedback()
    mini_step = _make_exact_mini_step(updater, loss, num_slots, with_aux, update,
                                      significance=significance, **wire_kw)
    return _scan_step(mini_step, lambda b, i: wire.decode_exact_shard(b, num_slots, i))


def _make_entry_mini_step(updater, loss, shard: int, num_slots: int, with_aux: bool,
                          push_quant: int = 0, pull_quant: int = 0, push_noise=None,
                          pull_noise=None, pull_narrow=False):
    """One dense-update ministep over per-entry slot ids, the body of
    the hashed COO step and of every ELL wire:
    ``(live, pulled, seed, y, mask, rows, slots, vals, valid) -> metrics``.
    ``rows`` holds each entry's row in CSR order (the ELL lanes row by
    row), ``vals`` None for binary entries, ``valid`` None or the mask
    of entries that carry a feature. Gather the weights at each slot
    through the pull wire, sum Xw by row, add the entries' gradients
    into a shard-sized vector (a stable sort by slot, then each slot's
    sum in entry order: the same bits run to run and on the CPU), pass
    it through the push wire and sweep the whole shard."""
    del pull_narrow  # every pull gathers wide
    push_touched = make_push_touched(push_quant, noise=push_noise)
    pull_derive, pull_lookup = make_pull_lookup(updater, pull_quant, noise=pull_noise)

    def mini_step(live, pulled, seed, y, mask, rows, slots, vals, valid):
        rel, ok = localize(slots, shard)
        # sentinel/padding slots are owned by no shard: weight 0
        w_e = pull_lookup(pull_derive(pulled, seed), rel, ok)
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

    return mini_step


def make_train_step_hashed(updater, loss, num_slots: int, with_aux: bool = True, **wire_kw):
    """Per-entry step (hashed prep, dense update) over a HashedBatch."""
    mini_step = _make_entry_mini_step(updater, loss, num_slots, num_slots, with_aux, **wire_kw)

    def decode(b, i):
        return b.y[i], b.mask[i], b.rows[i], b.slots[i], b.vals[i], None

    return _one_step(mini_step, decode)


def _lane_rows(rows: int, lanes: int, device) -> torch.Tensor:
    """Each ELL entry's row, row by row: ``repeat(arange(rows), lanes)``."""
    return torch.arange(rows, dtype=torch.int32, device=device).repeat_interleave(lanes)


def make_train_step_ell(updater, loss, num_slots: int, binary: bool, with_aux: bool = True,
                        packed: bool = False, **wire_kw):
    """The step over an ELLBatch (``packed``: an ELLPackedBatch, its
    3-byte ids and uint8 mask decoded on the device): Xw by row over the
    lanes, the entries' gradients into the shard."""
    mini_step = _make_entry_mini_step(updater, loss, num_slots, num_slots, with_aux, **wire_kw)

    def decode(b, i):
        slots = wc.decode_u24(b.slots_u24[i]) if packed else b.slots[i]
        mask = b.mask[i].to(torch.float32)
        r, k = slots.shape
        flat = slots.reshape(-1)
        vals = None if binary else b.vals[i].reshape(-1)
        valid = valid_slots(flat, num_slots) if binary else vals != 0
        return b.y[i], mask, _lane_rows(r, k, flat.device), flat, vals, valid

    return _one_step(mini_step, decode)


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
                             with_aux: bool = True, **wire_kw):
    """The step over an ELLBitsBatch: slot ids, labels and the mask
    decoded on the device from the packed wire."""
    mini_step = _make_entry_mini_step(updater, loss, num_slots, num_slots, with_aux, **wire_kw)
    return _one_step(mini_step, _bits_decode(num_slots, lanes))


def make_train_step_ell_bits_scan(updater, loss, num_slots: int, lanes: int,
                                  with_aux: bool = True, **wire_kw):
    """T bits-wire ministeps a submission."""
    mini_step = _make_entry_mini_step(updater, loss, num_slots, num_slots, with_aux, **wire_kw)
    return _scan_step(mini_step, _bits_decode(num_slots, lanes))


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


def make_train_step_ell_stream(updater, loss, num_slots: int, with_aux: bool = True, **wire_kw):
    """The step over an EncodedEllStreamBatch: dictionary lanes decode
    as table gathers, raw lanes from their bitstream, on the device."""
    mini_step = _make_entry_mini_step(updater, loss, num_slots, num_slots, with_aux, **wire_kw)
    return _one_step(mini_step, _stream_decoder())


def make_train_step_ell_stream_scan(updater, loss, num_slots: int, with_aux: bool = True,
                                    **wire_kw):
    """T stream-wire ministeps a submission."""
    mini_step = _make_entry_mini_step(updater, loss, num_slots, num_slots, with_aux, **wire_kw)
    return _scan_step(mini_step, _stream_decoder())


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


class AsyncSGDWorker:
    """The linear worker on one device: preps minibatches on the host,
    runs the fused worker+server step on ``device`` (CUDA by default;
    raises when there is none and no device is given), evaluates and
    answers pulls from the trained table. Steps run on an executor's
    dispatch thread, at most τ + 1 in flight (``max_delay`` = τ);
    :meth:`submit` waits for its step, :meth:`train` collects steps by
    timestamp. With τ > 0, gradients are computed on a weight snapshot
    refreshed every τ ministeps, on the JAX worker's schedule (fixed by
    submission order), so the trajectory equals the JAX worker's;
    ``last_staleness`` is the realized staleness of the latest
    submission, in ministeps. Reading the table (weights, pulls,
    evaluation, snapshots) first waits for the steps in flight."""

    def __init__(self, conf: Config, device=None, name: str = "async_sgd_worker"):
        self.name = name
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
        self.num_slots = pad_slots(sgd.num_slots, 1)
        self._update_mode = self._resolve_update_mode(sgd)
        # which FTRL update the steps run: a CUDA kernel or the plain version
        self.update_path = resolve_update_path(
            self._update_mode, on_cuda=self.device.type == "cuda"
        )
        # the hash modulus is the CONFIGURED slot count, not the padded
        # table size (the JAX worker's rule)
        self.directory = KeyDirectory(sgd.num_slots, hashed=True)
        self.state = self.updater.init(self.num_slots, self.device)
        self._steps: Dict[Tuple, object] = {}
        self._seed_counter = 0
        self._pads: Optional[Tuple[int, int, int]] = None
        self._pull_state = self._snapshot()
        self._steps_since_snapshot = 0
        self.last_staleness = 0
        self.progress = SGDProgress()
        # at most τ + 1 steps in flight (τ = 0 still lets the next step
        # be submitted while one runs)
        self.executor = Executor(name, max_in_flight=max(0, sgd.max_delay) + 1)
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
        self._learning = None
        self._examples_counter = None
        if telemetry_registry.enabled():
            from ...telemetry import learning as learning_mod
            from ...telemetry.instruments import app_instruments

            self._learning = learning_mod.plane(
                self.name, num_slots=self.num_slots, num_shards=1,
                max_delay=max(0, sgd.max_delay),
            )
            self._examples_counter = app_instruments(
                telemetry_registry.default_registry())["examples"]
        self._heat_counter = 0  # feeder/trainer thread only
        self._heat_feed: Optional[KeyHeatFeed] = None  # set for a train or a minibatch
        self._snapshot_ts: Optional[int] = None  # submit thread only
        self._consistency = None
        if sgd.tau_adaptive or sgd.kkt_filter:
            self._consistency = ConsistencyRuntime.from_config(self, sgd)

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
            rows = self.num_slots
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
        if self.num_slots >= sparse_update_min_slots() and not filtered:
            return "sparse"
        return "dense"

    def _padding(self, batch: SparseBatch) -> Tuple[int, int, int]:
        """Static shapes, pinned from the first batch as the JAX worker
        pins them: rows per shard, and nnz with 25% headroom rounded up
        to 4096. A later batch that outgrows an auto-sized pad grows it
        (the JAX worker raises there): eager PyTorch keeps no compiled
        shape, and a tail-filtered stream keeps more keys in its later
        minibatches than in its first. Padding entries change no result."""
        rows = self.sgd.rows_pad or batch.n
        nnz = self.sgd.nnz_pad or max(4096, -(-int(batch.nnz * 1.25) // 4096) * 4096)
        if self._pads is None:
            self._pads = (rows, nnz, nnz)
        else:
            r, z, _ = self._pads
            r = rows if batch.n > r and not self.sgd.rows_pad else r
            z = nnz if batch.nnz > z and not self.sgd.nnz_pad else z
            self._pads = (r, z, z)
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
        if self._update_mode == "sparse":
            uniq = min(nnz_pad, self.num_slots)
            uniq = -(-uniq // 1024) * 1024
            out = self._maybe_encode(prep_batch_shared(
                batch, self.directory, 1, rows_pad, nnz_pad, uniq, self.num_slots
            ))
        else:
            out = self._prep_dense(batch, rows_pad, nnz_pad)
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
            if kind == "stream":
                out = prep_batch_ell_stream(batch, self.directory, 1, rows_pad, lanes,
                                            self.num_slots, self._get_stream_statics(batch))
                kind = "bits" if out is None else kind
            if out is None and kind == "bits":
                out = prep_batch_ell_bits(batch, self.directory, 1, rows_pad, lanes,
                                          self.num_slots)
                kind = "u24" if out is None else kind
            if out is None:
                out = prep_batch_ell(batch, self.directory, 1, rows_pad, lanes, self.num_slots,
                                     pack=kind == "u24" and self.num_slots < (1 << 24))
            return out
        return prep_batch_hashed(batch, self.directory, 1, rows_pad, nnz_pad, self.num_slots)

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
        exact = dict(update=self._update_mode, significance=self._significance, **self._wire)
        lanes = self.sgd.ell_lanes
        if isinstance(prepped, wire.EncodedEllStreamSuperBatch):
            key, build = ("ell_stream_scan", with_aux), lambda: make_train_step_ell_stream_scan(
                self.updater, self.loss, self.num_slots, with_aux, **self._wire)
        elif isinstance(prepped, wire.EncodedEllStreamBatch):
            key, build = ("ell_stream", with_aux), lambda: make_train_step_ell_stream(
                self.updater, self.loss, self.num_slots, with_aux, **self._wire)
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
                self.updater, self.loss, self.num_slots, lanes, with_aux, **self._wire)
        elif isinstance(prepped, ELLBitsBatch):
            key, build = ("ell_bits", with_aux), lambda: make_train_step_ell_bits(
                self.updater, self.loss, self.num_slots, lanes, with_aux, **self._wire)
        elif isinstance(prepped, (ELLBatch, ELLPackedBatch)):
            packed, binary = isinstance(prepped, ELLPackedBatch), prepped.vals is None
            key, build = ("ell", packed, binary, with_aux), lambda: make_train_step_ell(
                self.updater, self.loss, self.num_slots, binary, with_aux, packed=packed,
                **self._wire)
        elif isinstance(prepped, HashedBatch):
            key, build = ("hashed", with_aux), lambda: make_train_step_hashed(
                self.updater, self.loss, self.num_slots, with_aux, **self._wire)
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

        def run():
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for name in wire.array_fields(prepped):
                    # allocated on the upload's stream, read on this one
                    getattr(prepped, name).record_stream(stream)
            if do_snapshot:
                self._pull_state = self._snapshot()
            return step_fn(self.state, self._pull_state, prepped, seed, variant)

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

    def submit(self, prepped, with_aux: bool = True) -> Dict[str, torch.Tensor]:
        """Run one step (or one T-step superbatch) on a prepped batch and
        wait for it; returns its metrics as tensors on the device."""
        return self.executor.wait(self._submit_prepped(prepped, with_aux=with_aux))

    def process_minibatch(self, batch: SparseBatch, with_aux: bool = True):
        """Pull → gradient → push for one minibatch; returns its metrics
        (fold them into ``progress`` with :meth:`collect`)."""
        with self._key_heat():
            self._note_heat(batch)
            return self.submit(self.prep(batch, device_put=False), with_aux=with_aux)

    def submit_superbatch(self, batches: List[SparseBatch], with_aux: bool = False):
        """Prep + stack T minibatches and run them as one submission: the
        bits or stream wire, or the exact wire (raw or encoded) in sparse
        mode, where the superstep runs every ministep on the live state.
        A dense-mode exact group raises: it runs per minibatch."""
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
        return self.submit(stacked, with_aux=with_aux)

    def collect(self, metrics) -> SGDProgress:
        """Fold a submission's metrics (or its executor timestamp, waited
        for here) into ``progress`` (host sync). The wait beats the
        worker's heartbeat and counts as its busy time on the dashboard
        while the postoffice's aux runtime runs."""
        if isinstance(metrics, int):
            from ...system.postoffice import Postoffice

            po = Postoffice._instance  # never create the singleton here
            hb = None
            if po is not None:
                po.beat(self.name)  # liveness signal
                hb = po.aux.info(self.name) if po.aux is not None else None
            if hb is not None:
                hb.start_timer()
            metrics = self.executor.wait(metrics)
            if hb is not None:
                hb.stop_timer()
        if self._examples_counter is not None:
            self._examples_counter.inc(int(metrics["num_ex"]))
        if self._learning is not None:
            # the step's own num_ex and convergence side outputs
            self._learning.note_step(metrics)
        if self._consistency is not None:
            # KKT counts and the drop set, then the τ controller (which
            # may back off the rate and roll the state back)
            self._consistency.on_collect(metrics)
        num_ex = float(metrics["num_ex"])
        prog = SGDProgress(
            objective=[float(metrics["objective"])],
            num_examples_processed=int(num_ex),
            accuracy=[float(metrics["correct"]) / max(1.0, num_ex)],
        )
        if "xw" in metrics:
            y = metrics["y"].cpu().numpy()
            xw = metrics["xw"].cpu().numpy()
            mask = metrics["mask"].cpu().numpy()
            if xw.ndim == 2:  # one minibatch: [D, R]
                y, xw, mask = y[None], xw[None], mask[None]
            prog.auc = [
                evaluation.auc(y[t].ravel()[mask[t].ravel() > 0],
                               xw[t].ravel()[mask[t].ravel() > 0])
                for t in range(xw.shape[0])
            ]
        self.progress.merge(prog)
        return prog

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
            parts = [(wire.compress_batch(p), n) for p, n in parts]
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

        def submit_parts(parts):
            for prepped, n in parts:
                pending.append((self._submit_prepped(prepped, with_aux=True), n))
                while sum(n for _, n in pending) > bound:
                    self.collect(pending.pop(0)[0])

        def groups():
            group = []
            for batch in batches:
                # the padding (and the stream wire's statics) are decided
                # here, in stream order, before a prep worker sees the batch
                if self.sgd.wire == "stream" and not self._stream_statics_set:
                    self._get_stream_statics(batch)
                # key heat is noted in stream order here (the feeder when
                # pipelined) and folded on the feed's own thread
                self._note_heat(batch)
                group.append((batch, self._padding(batch)))
                if len(group) >= T:
                    yield group
                    group = []
            if group:
                yield group

        if pipelined:
            workers = self.ingest_workers()
            # each staged group holds T prepped batches: the window also
            # bounds the host memory
            pipe = IngestPipeline(groups(), prep_fn=self._prep_group, workers=workers,
                                  capacity=2 * workers, name="train_ingest").start()

            def parts():
                for group_parts in pipe:
                    yield from group_parts

            stream = self.upload_stream if self.device.type == "cuda" else None

            def upload_fn(p):
                return self.upload(p, stream)

            if self.sgd.wire_cache_mb > 0:
                # stateful: lives on the uploader's one thread
                upload_fn = self.upload_cache = wire.UploadCache(
                    upload_fn, max_bytes=self.sgd.wire_cache_mb << 20)
            uploader = DeviceUploader(parts(), upload_fn, depth=2)
            try:
                for staged, n in uploader:
                    # submitted under the batch's flow id, so the
                    # executor.step span correlates back through upload,
                    # prep and read in the timeline
                    with telemetry_spans.flow_scope(uploader.next_flow()):
                        submit_parts([(staged, n)])
            finally:
                # the uploader first: no thread is left inside a copy
                uploader.close()
                pipe.close()
        else:
            for group in groups():
                submit_parts(self._prep_group(group))
        for ts, _ in pending:
            self.collect(ts)
        return self.progress

    def _drain(self) -> None:
        """Wait for every step in flight, leaving its metrics to collect."""
        self.executor.wait_all(pop=False)

    # -- serving the trained table --

    def weights_dense(self) -> np.ndarray:
        """The whole weight vector, derived from the optimizer state."""
        self._drain()
        return self.updater.weights(self.state).cpu().numpy()

    def _slot_weights(self, slots: torch.Tensor) -> torch.Tensor:
        self._drain()
        ok = slots < self.num_slots
        w = self.updater.weights(
            _gather_state(self.state, torch.clamp(slots, 0, self.num_slots - 1))
        )
        return torch.where(ok, w, 0.0)

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
        """Nonzero weights as ``slot\\tweight`` text in one file,
        ``{path}_S0`` (the JAX worker writes one file per server shard;
        here there is one shard). The directory is hashed, so the keys
        are table slots, under a ``#hashed <num_slots>`` header that
        tells a reader to route lookups through the same hash."""
        self._drain()
        # the nonzeros are found where the table lies, a chunk of slots at
        # a time (the weights are elementwise): a 2^30-slot table sends
        # only its nonzero weights to the host, with a chunk's temporaries
        spath = f"{path}_S0"
        with psfile.open_write(spath) as f:
            f.write(f"#hashed\t{self.directory.num_slots}\n")
            for lo in range(0, self.num_slots, _SAVE_CHUNK):
                w = self.updater.weights({k: (v[lo:lo + _SAVE_CHUNK] if v.dim() >= 1 else v)
                                          for k, v in self.state.items()})
                nz = torch.nonzero(w).reshape(-1)
                weights = w.index_select(0, nz).cpu().tolist()
                f.writelines(f"{i}\t{v!r}\n" for i, v in zip((nz + lo).cpu().tolist(), weights))
        return [spath]

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
        state = state_from_jax(snap["state"], self.device)
        for k, leaf in state.items():
            leaf = state[k] = leaf.to(self.state[k].dtype)
            if leaf.dim() >= 1 and leaf.shape[0] != self.num_slots:
                fitted = torch.zeros(self.num_slots, dtype=leaf.dtype, device=leaf.device)
                m = min(self.num_slots, leaf.shape[0])
                fitted[:m] = leaf[:m]
                state[k] = fitted
        self.state = state
        self._pull_state = self._snapshot()
        self._steps_since_snapshot = 0
        self._seed_counter = int(snap["seed_counter"])
