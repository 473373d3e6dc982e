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

The host side runs as the JAX worker's does. Steps run on an
:class:`~...system.executor.Executor`'s dispatch thread, at most τ + 1
in flight; seeds and the snapshot schedule are fixed on the submitting
thread, in submission order, so every path gives the same trajectory.
``train(pipelined=True)`` (the default for T > 1) reads and filters on a
feeder thread, preps on an ordered pool of workers and uploads on a
:class:`DeviceUploader` thread: host arrays are copied into pinned
staging buffers and sent on a side CUDA stream, which the step's stream
waits on. The pipelined state is bit-identical to the serial one.

Not ported yet (``SGDConfig.validate`` raises ``NotImplementedError``):
the ELL/bits/stream and encoded wires, the KKT filter and adaptive τ,
replicas and multi-GPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve
from ...convert import state_from_jax, state_to_numpy
from ...learner.ingest import IngestPipeline
from ...learner.sgd import SGDProgress
from ...ops import quantize as qops
from ...ops.ftrl_sparse import resolve_update_path
from ...ops.kv_ops import localize, slot_sentinel
from ...ops.segment_sum import segment_sum as _segment_sum
from ...parameter.parameter import KeyDirectory, pad_slots
from ...system.executor import Executor
from ...utils import evaluation
from ...utils import file as psfile
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


def _gather_codes(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``q[idx]`` for uint8/uint16 codes (uint16 gathers through its
    int16 view: PyTorch's CPU gather does not take uint16)."""
    if q.dtype == torch.uint16:
        return q.view(torch.int16).index_select(0, idx).view(torch.uint16)
    return q.index_select(0, idx)


def make_pull_lookup(updater, pull_quant: int, noise=None, narrow: bool = False):
    """The pull wire, as ``(derive, lookup)``: ``derive(pulled, seed)``
    once per step gives the representation the step gathers from,
    ``lookup(rep, rel, ok)`` the flat f32 weights at ``rel``, zero where
    ``ok`` is False.

    Unfiltered, weights are derived from the GATHERED rows:
    ``updater.weights`` is elementwise, so this equals gathering the
    derived table bit for bit, without a table-sized pass. With a
    FIXING_FLOAT pull filter the whole table's weights are derived and
    stochastically rounded to ``pull_quant`` bytes (exact zeros stay
    zero); ``narrow`` gathers the codes plus a zero mask and dequantizes
    after the gather, bit-equal to the wide gather of dequantized
    weights (``pull_gather="auto"`` is wide, as in the JAX package).
    ADD_NOISE perturbs the derived weights."""
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

    if narrow:
        def derive_narrow(pulled, seed):
            w, q, lo, hi = quantized(pulled, seed)
            return q, w != 0, lo, hi

        def narrow_lookup(rep, rel, ok):
            q, nz, lo, hi = rep
            dec = qops.dequantize(_gather_codes(q, rel), lo, hi, pull_quant)
            return torch.where(ok & nz.index_select(0, rel), dec, 0.0)

        return derive_narrow, narrow_lookup

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
                          push_noise=None, pull_noise=None, pull_narrow=False):
    """One ministep over the exact (host-dedup) wire:
    ``(live, pulled, seed, y, mask, rows, ucols, vals, uslots, umask) ->
    metrics``, updating ``live`` in place. ``update="sparse"`` applies
    the update to the batch's deduplicated slots only and composes with
    the unfiltered wire only; ``update="dense"`` scatters the gradient
    into a shard-sized vector, passes it through the push wire and
    sweeps the whole shard."""
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
    pull_derive, pull_lookup = make_pull_lookup(
        updater, pull_quant, noise=pull_noise, narrow=pull_narrow
    )

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
            apply_state_rows(updater, live, rel, ok, g_u, seed=seed)
            return _convergence_metrics(metrics, g_u, g_u, w_u)
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


def make_train_step(updater, loss, num_slots: int, with_aux: bool = True,
                    update: str = "dense", **wire):
    """Exact-wire step over one PreppedBatch:
    ``step(live, pulled, batch, seed) -> metrics``, ``live`` updated in
    place. ``wire``: the filter settings of :func:`_make_exact_mini_step`
    (``push_quant``, ``pull_quant``, ``push_noise``, ``pull_noise``,
    ``pull_narrow``)."""
    mini_step = _make_exact_mini_step(updater, loss, num_slots, with_aux, update, **wire)

    def step(live, pulled, batch, seed=0):
        return mini_step(
            live, pulled, seed, batch.y[0], batch.mask[0], batch.rows[0],
            batch.ucols[0], batch.vals[0], batch.uslots[0], batch.umask[0],
        )

    return step


def make_train_step_scan(updater, loss, num_slots: int, with_aux: bool = True,
                         update: str = "dense", **wire):
    """T ministeps over a PreppedSuperBatch in one submission, weights
    advancing every ministep (staleness 0); ministep i uses seed + i."""
    mini_step = _make_exact_mini_step(updater, loss, num_slots, with_aux, update, **wire)

    def step(live, pulled, batch, seed=0):
        del pulled  # staleness 0 inside the superstep
        per_step = [
            mini_step(
                live, live, (seed + i) & _M32, batch.y[i, 0], batch.mask[i, 0],
                batch.rows[i, 0], batch.ucols[i, 0], batch.vals[i, 0],
                batch.uslots[i, 0], batch.umask[i, 0],
            )
            for i in range(batch.steps)
        ]
        return _fold_metrics(per_step)

    return step


def make_train_step_hashed(updater, loss, num_slots: int, with_aux: bool = True,
                           push_quant: int = 0, pull_quant: int = 0,
                           push_noise=None, pull_noise=None, pull_narrow=False):
    """Per-entry step (hashed prep, dense update): gather the weight at
    each nnz slot through the pull wire, segment-sum Xw by row,
    scatter-add the per-entry gradients into a shard-sized vector
    (duplicates fold there), pass it through the push wire and sweep the
    whole shard with the dense update."""
    shard = num_slots
    push_touched = make_push_touched(push_quant, noise=push_noise)
    pull_derive, pull_lookup = make_pull_lookup(
        updater, pull_quant, noise=pull_noise, narrow=pull_narrow
    )

    def step(live, pulled, batch, seed=0):
        y, mask, rows, slots, vals = (
            batch.y[0], batch.mask[0], batch.rows[0], batch.slots[0], batch.vals[0],
        )
        rel, ok = localize(slots, shard)
        # sentinel/padding slots are owned by no shard: weight 0, and
        # their vals are 0, so they vanish from Xw and g
        w_e = pull_lookup(pull_derive(pulled, seed), rel, ok)
        # rows in CSR order, the padding (row 0, value 0) at the end: no sort
        xw = _segment_sum(vals * w_e, rows, y.shape[0], presorted=True)
        gr = loss.row_grad(y, xw) * mask
        g_e = vals * gr.index_select(0, rows)
        g_push = torch.where(ok, g_e, 0.0)
        g_shard = _segment_sum(g_push, rel, shard)
        g_shard, touched = push_touched(g_shard, seed)
        updater.apply(live, g_shard, touched, seed=seed)
        metrics = _progress_metrics(loss, y, xw, mask, with_aux)
        return _convergence_metrics(metrics, g_push, g_shard, w_e)

    return step


_ALIGN = 64  # bytes: each array of a staged batch starts on this boundary


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

    def copy(self, prepped, stream: "torch.cuda.Stream"):
        arrays = [(f.name, np.ascontiguousarray(getattr(prepped, f.name)))
                  for f in dataclasses.fields(prepped)]
        offsets, total = [], 0
        for _, a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
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
        out = type(prepped)(**{
            name: dev[off:off + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
            for (name, a), off in zip(arrays, offsets)
        })
        out.ready = done  # not a field: the device arrays' copy event
        return out


class DeviceUploader:
    """The double-buffered host → device stage of the pipelined train:
    ``upload_fn`` (the worker's upload on its side stream) runs for batch
    t+1 on this stage's thread while step t runs. ``depth`` bounds the
    uploaded batches not yet taken by the consumer (2: one being copied,
    one waiting). An exception of the thread re-raises at the consumer;
    ``close()`` stops and joins the thread."""

    def __init__(self, source, upload_fn, depth: int = 2):
        def uploaded():
            for prepped, n in source:
                yield upload_fn(prepped), n

        # depth - 1 in the queue and one held by the consumer
        self._it = iter_on_thread(uploaded(), maxsize=max(1, depth - 1))

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
        sparse update (unique width padded to a multiple of 1024), the
        hashed per-entry wire for the dense one. ``pads``: the padding
        :meth:`_padding` gave this batch in stream order (a prep worker
        of the pipeline must not decide it); decided here if None."""
        rows_pad, nnz_pad, _ = pads or self._padding(batch)
        if self._update_mode == "sparse":
            uniq = min(nnz_pad, self.num_slots)
            uniq = -(-uniq // 1024) * 1024
            out = prep_batch_shared(
                batch, self.directory, 1, rows_pad, nnz_pad, uniq, self.num_slots
            )
        else:
            out = prep_batch_hashed(
                batch, self.directory, 1, rows_pad, nnz_pad, self.num_slots
            )
        return self.upload(out) if device_put else out

    def upload(self, prepped, stream=None):
        """Host arrays -> tensors on the worker's device (int32 ids stay
        int32: every gather and segment sum here takes them as they are).
        To the card through pinned staging buffers, on ``stream`` (the
        caller's current stream by default), never from pageable memory;
        the result carries the copy's event as ``ready``. On the CPU the
        tensors share the arrays' memory."""
        if isinstance(getattr(prepped, "y", None), torch.Tensor):
            return prepped
        if self.device.type != "cuda":
            return type(prepped)(
                **{f.name: torch.as_tensor(getattr(prepped, f.name)).to(self.device)
                   for f in dataclasses.fields(prepped)}
            )
        return self.staging.copy(prepped, stream or torch.cuda.current_stream(self.device))

    @property
    def upload_stream(self):
        """The side CUDA stream of the pipelined train's uploads."""
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        return self._side_stream

    def _get_step(self, prepped, with_aux: bool):
        if isinstance(prepped, PreppedSuperBatch):
            key, build = ("exact_scan", self._update_mode, with_aux), make_train_step_scan
        elif isinstance(prepped, HashedBatch):
            key, build = ("hashed", with_aux), make_train_step_hashed
        else:
            key, build = ("exact", self._update_mode, with_aux), make_train_step
        if key not in self._steps:
            mode = {} if build is make_train_step_hashed else {"update": self._update_mode}
            self._steps[key] = build(
                self.updater, self.loss, self.num_slots, with_aux, **mode, **self._wire
            )
        return self._steps[key]

    def _submit_prepped(self, prepped, with_aux: bool = True) -> int:
        """Submit one step (or one T-step superbatch) on a prepped batch
        to the executor; returns its timestamp. Seeds follow the JAX
        worker: the counter advances by the ministep count and the
        launch's first ministep gets ``counter - (n_steps - 1)``.

        The bounded-delay schedule is the JAX worker's and is fixed here,
        on the submitting thread: a submission takes a fresh weight
        snapshot when τ = 0 or when τ ministeps have run since the last
        one, and otherwise computes on the last snapshot. The snapshot
        itself is taken when the step runs, on the dispatch thread, where
        the state advances in submission order. At τ = 0 it is the live
        tensors (the step gathers before it updates); at τ > 0 a copy.
        The first τ ministeps pull the state the worker started from (or
        loaded). On the card the step's stream first waits for the
        batch's upload."""
        prepped = self.upload(prepped)
        n_steps = prepped.steps if isinstance(prepped, PreppedSuperBatch) else 1
        tau = max(0, self.sgd.max_delay)
        do_snapshot = tau == 0 or self._steps_since_snapshot >= tau
        self.last_staleness = 0 if do_snapshot else self._steps_since_snapshot
        if do_snapshot:
            self._steps_since_snapshot = 0
        step_fn = self._get_step(prepped, with_aux)
        self._seed_counter += n_steps
        seed = (self._seed_counter - (n_steps - 1)) & _M32
        self._steps_since_snapshot += n_steps
        ready = getattr(prepped, "ready", None)

        def run():
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for f in dataclasses.fields(prepped):
                    # allocated on the upload's stream, read on this one
                    getattr(prepped, f.name).record_stream(stream)
            if do_snapshot:
                self._pull_state = self._snapshot()
            return step_fn(self.state, self._pull_state, prepped, seed)

        return self.executor.submit(run)

    def submit(self, prepped, with_aux: bool = True) -> Dict[str, torch.Tensor]:
        """Run one step (or one T-step superbatch) on a prepped batch and
        wait for it; returns its metrics as tensors on the device."""
        return self.executor.wait(self._submit_prepped(prepped, with_aux=with_aux))

    def process_minibatch(self, batch: SparseBatch, with_aux: bool = True):
        """Pull → gradient → push for one minibatch; returns its metrics
        (fold them into ``progress`` with :meth:`collect`)."""
        return self.submit(self.prep(batch, device_put=False), with_aux=with_aux)

    def submit_superbatch(self, batches: List[SparseBatch], with_aux: bool = False):
        """Prep + stack T minibatches and run them as one submission.
        Sparse update only: the superstep runs every ministep on the
        live state, which is the sparse mode's contract."""
        if self._update_mode != "sparse":
            raise ValueError(
                "superbatch needs update='sparse' (dense-mode groups run "
                "per minibatch)"
            )
        prepped = [self.prep(b, device_put=False) for b in batches]
        return self.submit(stack_prepped_batches(prepped), with_aux=with_aux)

    def collect(self, metrics) -> SGDProgress:
        """Fold a submission's metrics (or its executor timestamp, waited
        for here) into ``progress`` (host sync)."""
        if isinstance(metrics, int):
            metrics = self.executor.wait(metrics)
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
        pipeline thread): one T-step superbatch in sparse mode, else one
        part a minibatch (dense groups run per minibatch: a superstep
        would bypass the snapshot schedule and the wire's filters).
        Returns ``[(host_prepped, n_ministeps)]``."""
        prepped = [self.prep(b, device_put=False, pads=pads) for b, pads in group]
        if len(prepped) > 1 and self._update_mode == "sparse":
            return [(stack_prepped_batches(prepped), len(prepped))]
        return [(p, 1) for p in prepped]

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
                # the padding is decided here, in stream order, before a
                # prep worker sees the batch
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
            uploader = DeviceUploader(parts(), lambda p: self.upload(p, stream), depth=2)
            try:
                for staged, n in uploader:
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
        w = self.weights_dense()
        nz = np.flatnonzero(w)
        spath = f"{path}_S0"
        with psfile.open_write(spath) as f:
            f.write(f"#hashed\t{self.directory.num_slots}\n")
            f.writelines(f"{i}\t{v!r}\n" for i, v in zip(nz.tolist(), w[nz].tolist()))
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
