"""Online sparse logistic regression with FTRL — the main path.

Counterpart of ``parameter_server_tpu/apps/linear/async_sgd.py`` on one
device. The host preps each minibatch exactly as the JAX worker does
(same numpy arrays, same padding); a step then pulls the weights of the
batch's slots, computes Xw and the row gradient with segment sums, and
runs the FTRL update: ``update="sparse"`` through the fused sparse
kernel over the batch's deduplicated slots, ``update="dense"`` through
the whole-table kernel. With one data shard and one server shard every
collective of the JAX step is the identity.

Not ported yet (``SGDConfig.validate`` raises ``NotImplementedError``):
bounded delay τ > 0 and the threaded executor, the ELL/bits/stream and
encoded wires, push/pull filters, the KKT filter and adaptive τ,
replicas and multi-GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve
from ...convert import state_from_jax, state_to_numpy
from ...learner.sgd import SGDProgress
from ...ops.ftrl_sparse import resolve_update_path
from ...ops.kv_ops import localize, slot_sentinel
from ...parameter.parameter import KeyDirectory, pad_slots
from ...utils import evaluation
from ...utils.sparse import SparseBatch
from .config import Config
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


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    return torch.zeros(num_segments, dtype=data.dtype, device=data.device).index_add_(
        0, segment_ids, data
    )


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


def sparse_update_min_slots() -> int:
    """``update="auto"`` flip point, in shard slots: the dense sweep
    below it, the sparse row update at and above it."""
    return 1 << 30


def _make_exact_mini_step(updater, loss, shard: int, with_aux: bool, update: str):
    """One ministep over the exact (host-dedup) wire:
    ``(live, pulled, seed, y, mask, rows, ucols, vals, uslots, umask) ->
    metrics``, updating ``live`` in place. ``update="sparse"`` applies
    the update to the batch's deduplicated slots only;
    ``update="dense"`` scatters the gradient into a shard-sized vector
    and sweeps the whole shard."""
    if update not in ("sparse", "dense"):
        raise ValueError(f"unknown update mode {update!r}")

    def mini_step(live, pulled, seed, y, mask, rows, ucols, vals, uslots, umask):
        rel, ok = localize(uslots, shard)
        # derive weights from the GATHERED rows: updater.weights is
        # elementwise, so gather-then-derive equals derive-then-gather
        w_own = torch.where(ok, updater.weights(_gather_state(pulled, rel)), 0.0)
        w_u = w_own * umask
        xw = _segment_sum(vals * w_u.index_select(0, ucols), rows, y.shape[0])
        gr = loss.row_grad(y, xw) * mask
        g_u = _segment_sum(vals * gr.index_select(0, rows), ucols, uslots.shape[0])
        g_u = g_u * umask
        metrics = _progress_metrics(loss, y, xw, mask, with_aux)
        if update == "sparse":
            apply_state_rows(updater, live, rel, ok, g_u, seed=seed)
            return _convergence_metrics(metrics, g_u, g_u, w_u)
        g_push = torch.where(ok, g_u, 0.0)
        g_shard = _segment_sum(g_push, rel, shard)
        updater.apply(live, g_shard, None, seed=seed)
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
                    update: str = "dense"):
    """Exact-wire step over one PreppedBatch:
    ``step(live, pulled, batch, seed) -> metrics``, ``live`` updated in
    place."""
    mini_step = _make_exact_mini_step(updater, loss, num_slots, with_aux, update)

    def step(live, pulled, batch, seed=0):
        return mini_step(
            live, pulled, seed, batch.y[0], batch.mask[0], batch.rows[0],
            batch.ucols[0], batch.vals[0], batch.uslots[0], batch.umask[0],
        )

    return step


def make_train_step_scan(updater, loss, num_slots: int, with_aux: bool = True,
                         update: str = "dense"):
    """T ministeps over a PreppedSuperBatch in one submission, weights
    advancing every ministep (staleness 0); ministep i uses seed + i."""
    mini_step = _make_exact_mini_step(updater, loss, num_slots, with_aux, update)

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


def make_train_step_hashed(updater, loss, num_slots: int, with_aux: bool = True):
    """Per-entry step (hashed prep, dense update): gather the weight at
    each nnz slot, segment-sum Xw by row, scatter-add the per-entry
    gradients into a shard-sized vector (duplicates fold there) and
    sweep the whole shard with the dense update."""
    shard = num_slots

    def step(live, pulled, batch, seed=0):
        y, mask, rows, slots, vals = (
            batch.y[0], batch.mask[0], batch.rows[0], batch.slots[0], batch.vals[0],
        )
        rel, ok = localize(slots, shard)
        w_e = torch.where(ok, updater.weights(_gather_state(pulled, rel)), 0.0)
        xw = _segment_sum(vals * w_e, rows, y.shape[0])
        gr = loss.row_grad(y, xw) * mask
        g_e = vals * gr.index_select(0, rows)
        g_push = torch.where(ok, g_e, 0.0)
        g_shard = _segment_sum(g_push, rel, shard)
        updater.apply(live, g_shard, None, seed=seed)
        metrics = _progress_metrics(loss, y, xw, mask, with_aux)
        return _convergence_metrics(metrics, g_push, g_shard, w_e)

    return step


class AsyncSGDWorker:
    """The linear worker on one device: preps minibatches on the host,
    runs the fused worker+server step on ``device`` (CUDA by default;
    raises when there is none and no device is given), evaluates and
    answers pulls from the trained table. Synchronous: every submission
    has finished updating the state when it returns (τ = 0)."""

    def __init__(self, conf: Config, device=None, name: str = "async_sgd_worker"):
        self.name = name
        self.device = resolve(device)
        self.conf = conf
        sgd = conf.async_sgd
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
        self.progress = SGDProgress()

    def _resolve_update_mode(self, sgd) -> str:
        if sgd.update == "auto":
            return "sparse" if self.num_slots >= sparse_update_min_slots() else "dense"
        return sgd.update

    def _padding(self, batch: SparseBatch) -> Tuple[int, int, int]:
        """Static shapes, pinned from the first batch: rows per shard,
        and nnz with 25% headroom rounded up to 4096."""
        if self._pads is None:
            d = 1
            rows = self.sgd.rows_pad or -(-batch.n // d)
            per_nnz = -(-batch.nnz // d)
            nnz = self.sgd.nnz_pad or max(4096, -(-int(per_nnz * 1.25) // 4096) * 4096)
            self._pads = (rows, nnz, nnz)
        return self._pads

    def prep(self, batch: SparseBatch, device_put: bool = True):
        """Localize + pad a batch: the deduplicated exact wire for the
        sparse update (unique width padded to a multiple of 1024), the
        hashed per-entry wire for the dense one."""
        rows_pad, nnz_pad, _ = self._padding(batch)
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

    def upload(self, prepped):
        """Host arrays -> tensors on the worker's device (int32 ids stay
        int32: every gather and segment sum here takes them as they are)."""
        if isinstance(getattr(prepped, "y", None), torch.Tensor):
            return prepped
        return type(prepped)(
            **{
                f.name: torch.as_tensor(getattr(prepped, f.name)).to(self.device)
                for f in dataclasses.fields(prepped)
            }
        )

    def _get_step(self, prepped, with_aux: bool):
        if isinstance(prepped, PreppedSuperBatch):
            key = ("exact_scan", self._update_mode, with_aux)
            build = lambda: make_train_step_scan(  # noqa: E731
                self.updater, self.loss, self.num_slots, with_aux, self._update_mode
            )
        elif isinstance(prepped, HashedBatch):
            key = ("hashed", with_aux)
            build = lambda: make_train_step_hashed(  # noqa: E731
                self.updater, self.loss, self.num_slots, with_aux
            )
        else:
            key = ("exact", self._update_mode, with_aux)
            build = lambda: make_train_step(  # noqa: E731
                self.updater, self.loss, self.num_slots, with_aux, self._update_mode
            )
        if key not in self._steps:
            self._steps[key] = build()
        return self._steps[key]

    def submit(self, prepped, with_aux: bool = True) -> Dict[str, torch.Tensor]:
        """Run one step (or one T-step superbatch) on a prepped batch;
        returns its metrics as tensors on the device. Seeds follow the
        JAX worker: the counter advances by the ministep count and the
        launch's first ministep gets ``counter - (n_steps - 1)``."""
        prepped = self.upload(prepped)
        n_steps = prepped.steps if isinstance(prepped, PreppedSuperBatch) else 1
        step_fn = self._get_step(prepped, with_aux)
        self._seed_counter += n_steps
        seed = (self._seed_counter - (n_steps - 1)) & _M32
        return step_fn(self.state, self.state, prepped, seed)

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

    def collect(self, metrics: Dict[str, torch.Tensor]) -> SGDProgress:
        """Fold a submission's metrics into ``progress`` (host sync)."""
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

    def train(self, batches: Iterable[SparseBatch]) -> SGDProgress:
        """A pass over minibatches: groups of ``steps_per_launch`` run as
        one superbatch in sparse mode, one minibatch at a time in dense
        mode. Same submission order and seeds as the JAX worker."""
        T = max(1, self.sgd.steps_per_launch)
        group: List[SparseBatch] = []

        def flush():
            if len(group) > 1 and self._update_mode == "sparse":
                self.collect(self.submit_superbatch(list(group), with_aux=True))
            else:
                for b in group:
                    self.collect(self.process_minibatch(b))
            group.clear()

        for batch in batches:
            group.append(batch)
            if len(group) >= T:
                flush()
        flush()
        return self.progress

    # -- serving the trained table --

    def weights_dense(self) -> np.ndarray:
        """The whole weight vector, derived from the optimizer state."""
        return self.updater.weights(self.state).cpu().numpy()

    def _slot_weights(self, slots: torch.Tensor) -> torch.Tensor:
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
        xw = _segment_sum(vals * self._slot_weights(slots), rows, batch.n)
        return xw.cpu().numpy()

    def evaluate(self, batch: SparseBatch) -> Dict[str, float]:
        """Validation metrics on a batch."""
        xw = self.predict(batch)
        return {
            "auc": evaluation.auc(batch.y, xw),
            "accuracy": evaluation.accuracy(batch.y, xw),
            "logloss": evaluation.logloss(batch.y, xw),
        }

    # -- state snapshot / restore (the JAX worker's state_host format) --

    def state_host(self) -> dict:
        return {
            "state": state_to_numpy(self.state),
            "seed_counter": np.int64(self._seed_counter),
        }

    def load_state_host(self, snap: dict) -> None:
        """Install a host snapshot (this port's or the JAX worker's);
        only dead padding is trimmed or zero-extended. Leaves take this
        worker's dtypes (a bf16 leaf widened to f32 by ``state_to_numpy``
        narrows back exactly)."""
        state = state_from_jax(snap["state"], self.device)
        for k, leaf in state.items():
            leaf = state[k] = leaf.to(self.state[k].dtype)
            if leaf.dim() >= 1 and leaf.shape[0] != self.num_slots:
                fitted = torch.zeros(self.num_slots, dtype=leaf.dtype, device=leaf.device)
                m = min(self.num_slots, leaf.shape[0])
                fitted[:m] = leaf[:m]
                state[k] = fitted
        self.state = state
        self._seed_counter = int(snap["seed_counter"])
