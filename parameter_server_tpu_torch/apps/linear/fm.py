"""Factorization machine on one card.

Counterpart of ``parameter_server_tpu/apps/linear/fm.py``. Model (binary
features, the CTR case):

    f(x) = b + sum_i w_i + 0.5 * (||sum_i v_i||^2 - sum_i ||v_i||^2)

over the active slots i of a row, the O(nnz * k) identity for the
pairwise term. ``w`` ([slots]) and ``V`` ([slots, k]) are one server
shard on the card; with one data shard and one server shard the JAX
step's ``psum``s are the identity. Every parameter updates with AdaGrad
and the proximal elastic-net step on ``w`` (``V`` at ``v_lr_scale``
times the rate, no L1), only where ``touched = g_w != 0``.

The per-entry gradients go into ``g_w [S]`` and ``g_v [S, k]`` by
``ops/kv_ops.py::scatter_sum``: entry order, as XLA's scatter adds on
the CPU; on the card the ``segment_sum`` kernel over ``slot * k + col``
(one launch for each of the two), never ``index_add_``'s atomics. The update then
rewrites the whole table (``where(touched, ...)`` over S x (2 + 2k)
floats), as the JAX step does.

The wire is async_sgd's ELL row-block format (``prep_batch_ell``):
uniform lanes, hashed directory with the configured modulus, binary
features. ``predict_margin`` is the JAX worker's host forward in float64.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ... import convert
from ...device import resolve
from ...learner.sgd import ISGDCompNode, SGDProgress
from ...ops.kv_ops import localize, scatter_sum, valid_slots
from ...parameter.parameter import KeyDirectory, pad_slots, server_shard_rows
from ...system.message import Task
from ...utils import evaluation
from ...utils.sparse import SparseBatch
from .async_sgd import _progress_metrics
from .config import Config
from .learning_rate import LearningRate
from .loss import create_loss
from .penalty import create_penalty


def pull_rows(table: torch.Tensor, rel: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """``where(ok, table[rel], 0)``: the rows of the owned ids."""
    rows = table.index_select(0, rel)
    return torch.where(ok.reshape((-1,) + (1,) * (rows.dim() - 1)), rows, 0.0)


def adagrad(lr: LearningRate, param, ss, g, scale: float = 1.0):
    """AdaGrad without the proximal step: ``(param - eta * g, ss + g * g)``."""
    ss = ss + g * g
    eta = lr.eval(torch.sqrt(ss))
    if scale != 1.0:
        eta = scale * eta
    return param - eta * g, ss


def update_table(table, g_w, g_v, touched, lr: LearningRate, penalty, v_lr_scale: float = 1.0):
    """The whole-table update of both workers: AdaGrad with the proximal
    step on ``w``, AdaGrad on ``V`` at ``v_lr_scale`` times the rate (no
    L1), written where ``touched`` and the old value elsewhere, over all
    S x (2 + 2k) floats. Returns the new ``{w, w_ss, v, v_ss}``."""
    w_ss = table["w_ss"] + g_w * g_w
    eta_w = lr.eval(torch.sqrt(w_ss))
    w_new = penalty.proximal(table["w"] - eta_w * g_w, eta_w)
    v_new, v_ss = adagrad(lr, table["v"], table["v_ss"], g_v, v_lr_scale)
    t2 = touched[:, None]
    return {
        "w": torch.where(touched, w_new, table["w"]),
        "w_ss": torch.where(touched, w_ss, table["w_ss"]),
        "v": torch.where(t2, v_new, table["v"]),
        "v_ss": torch.where(t2, v_ss, table["v_ss"]),
    }


def make_fm_step(num_slots: int, k: int, loss, penalty, lr: LearningRate, v_lr_scale: float,
                 with_aux: bool = True):
    """The FM step over one ELL batch (binary): ``step(state, y [R],
    mask [R], slots [R, K]) -> (new_state, metrics)``. Pulls w and V at
    the batch's slots (sentinel lanes masked by ``live``), forward by
    the pairwise identity, scatters per-entry gradients, AdaGrad on
    both tables and the bias."""

    def step(state, y, mask, slots):
        r, lanes = slots.shape
        rel, ok = localize(slots.reshape(-1), num_slots)
        live = valid_slots(slots, num_slots).to(torch.float32)
        w_e = pull_rows(state["w"], rel, ok).reshape(r, lanes) * live
        v_e = pull_rows(state["v"], rel, ok).reshape(r, lanes, k) * live[..., None]

        s = v_e.sum(1)  # [R, k]
        pair = 0.5 * ((s * s).sum(1) - (v_e * v_e).sum((1, 2)))
        xw = state["b"] + w_e.sum(1) + pair
        gr = loss.row_grad(y, xw) * mask

        lanes_live = (live.reshape(-1) > 0) & ok
        gw_flat = gr[:, None].expand(r, lanes).reshape(-1)
        gv_flat = (gr[:, None, None] * (s[:, None, :] - v_e)).reshape(-1, k)
        g_w = scatter_sum(num_slots, rel, torch.where(lanes_live, gw_flat, 0.0)[:, None])[:, 0]
        g_v = scatter_sum(num_slots, rel, torch.where(lanes_live[:, None], gv_flat, 0.0))
        touched = g_w != 0  # the embeddings ride the linear support
        b, b_ss = adagrad(lr, state["b"], state["b_ss"], gr.sum())
        new_state = dict(update_table(state, g_w, g_v, touched, lr, penalty, v_lr_scale),
                         b=b, b_ss=b_ss)
        return new_state, _progress_metrics(loss, y, xw, mask, with_aux)

    return step


def fit_rows(leaf: np.ndarray, num_slots: int) -> np.ndarray:
    """A table leaf cut or zero-padded to ``num_slots`` rows (a snapshot
    of another table size, as the JAX workers' ``load_state_host``)."""
    leaf = np.asarray(leaf)
    if leaf.ndim == 0 or leaf.shape[0] == num_slots:
        return leaf
    if leaf.shape[0] > num_slots:
        return leaf[:num_slots]
    pad = np.zeros((num_slots - leaf.shape[0],) + leaf.shape[1:], leaf.dtype)
    return np.concatenate([leaf, pad])


class ELLWorker(ISGDCompNode):
    """What the FM and wide&deep workers share: the conf, the directory,
    the V init, the step's submission and the snapshot hooks. Steps run
    on the customer's executor, in submission order."""

    def __init__(self, conf: Config, k: int, device, seed: int, v_init_std: float, name: str):
        super().__init__(name=name)
        if device is None and self.po.started:
            device = self.po.device
        self.device = resolve(device)
        sgd = conf.async_sgd
        if sgd is None or sgd.ell_lanes <= 0:
            raise ValueError(f"{type(self).__name__} needs an async_sgd conf with ell_lanes "
                             "(uniform ELL rows)")
        self.sgd = sgd
        self.k = int(k)
        self.loss = create_loss(conf.loss.type)
        self.penalty = create_penalty(conf.penalty.type, conf.penalty.lambda_)
        self.lr = LearningRate(conf.learning_rate.type, conf.learning_rate.alpha,
                               conf.learning_rate.beta)
        self.num_slots = pad_slots(sgd.num_slots, 1)
        # the hash modulus is the CONFIGURED slot count (the JAX rule)
        self.directory = KeyDirectory(sgd.num_slots, hashed=True)
        self._rows_pad = None
        self.progress = SGDProgress()
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        n = self.num_slots
        self._table = {
            "w": torch.zeros(n, device=self.device),
            "w_ss": torch.zeros(n, device=self.device),
            "v": v_init_std * torch.randn((n, self.k), generator=gen, device=self.device),
            "v_ss": torch.zeros((n, self.k), device=self.device),
        }

    def upload(self, batch: SparseBatch):
        """The batch's ELL arrays (one data shard) on the card."""
        p = self._prep_ell(batch)
        return tuple(torch.from_numpy(a[0]).to(self.device) for a in (p.y, p.mask, p.slots))

    def process_minibatch(self, batch: SparseBatch) -> int:
        """Submit one step on ``batch``; returns its executor timestamp
        (fold its metrics into ``progress`` with :meth:`collect`)."""
        y, mask, slots = self.upload(batch)

        def run():
            self.state, metrics = self._step(self.state, y, mask, slots)
            return metrics

        return self.submit(run, Task())

    def state_host(self) -> dict:
        """Host snapshot (numpy copies) once the steps in flight are done:
        the JAX worker's ``{"state": ...}`` tree."""
        self.executor.wait_all(pop=False)
        return {"state": convert.tree_to_numpy(self.state)}

    def _wiped_table(self, shard: int) -> Dict[str, torch.Tensor]:
        """The table's leaves with server shard ``shard``'s rows zeroed
        (one shard holds every row), once the steps in flight are done."""
        rows = server_shard_rows(shard, self.num_slots)  # one server shard
        self.executor.wait_all(pop=False)
        out = {}
        for name, leaf in self.table().items():
            leaf = leaf.clone()
            leaf[rows] = 0.0
            out[name] = leaf
        return out

    def recover_server_shard(self, shard: int) -> bool:
        """No ongoing replica here (checkpoints give durability): a
        recovery reports failure, as the JAX workers' does."""
        del shard
        return False

    def _host_table(self):
        self.executor.wait_all(pop=False)
        t = self.table()
        return (t["w"].cpu().numpy().astype(np.float64), t["v"].cpu().numpy().astype(np.float64),
                float(self.state["b"]))

    def evaluate(self, batch: SparseBatch) -> Dict[str, float]:
        xw = self.predict_margin(batch)
        y = batch.y
        ll = float(np.mean(np.logaddexp(0.0, -y * xw)))
        return {"auc": evaluation.auc(y, xw), "logloss": ll}


class FMWorker(ELLWorker):
    """Async FM trainer on one card: ``process_minibatch`` / ``collect`` /
    ``train`` / ``evaluate`` / ``predict_margin`` / ``state_host`` /
    ``load_state_host``. ``device=None`` is the card (raises without
    one)."""

    def __init__(self, conf: Config, k: int = 8, device=None, v_init_std: float = 0.01,
                 v_lr_scale: float = 1.0, seed: int = 0, name: str = "fm_worker"):
        super().__init__(conf, k, device, seed, v_init_std, name)
        scalar = torch.zeros((), device=self.device)
        self.state = dict(self._table, b=scalar, b_ss=scalar.clone())
        del self._table
        self._step = make_fm_step(self.num_slots, self.k, self.loss, self.penalty, self.lr,
                                  v_lr_scale)

    def table(self) -> Dict[str, torch.Tensor]:
        return {name: self.state[name] for name in ("w", "w_ss", "v", "v_ss")}

    def wipe_server_shard(self, shard: int) -> None:
        """Zero a dead server shard's rows of w, V and their AdaGrad sums
        (a replacement that boots empty); the bias stays."""
        self.state = dict(self.state, **self._wiped_table(shard))

    def load_state_host(self, snap: dict) -> None:
        st = {name: fit_rows(leaf, self.num_slots) for name, leaf in snap["state"].items()}
        self.executor.wait_all(pop=False)
        self.state = convert.tree_from_numpy(st, self.device)

    def predict_margin(self, batch: SparseBatch) -> np.ndarray:
        """Host forward in float64 (the evaluation path): per-row sums by
        ``np.add.reduceat``, O(nnz * k). Reads one state version: the
        steps in flight finish first."""
        w, v, b = self._host_table()
        if batch.n == 0:
            return np.zeros(0, np.float32)
        slots = self.directory.slots(batch.indices)
        counts = np.diff(batch.indptr)
        seg = batch.indptr[:-1].astype(np.int64)
        # reduceat misbehaves on empty segments (repeated offsets): those
        # rows are set to the bias afterwards
        safe_seg = np.minimum(seg, max(batch.nnz - 1, 0))
        vs = v[slots]  # [nnz, k]
        sum_w = np.add.reduceat(w[slots], safe_seg) if batch.nnz else np.zeros(batch.n)
        sum_v = (np.add.reduceat(vs, safe_seg, axis=0) if batch.nnz
                 else np.zeros((batch.n, v.shape[1])))
        sum_v2 = (np.add.reduceat((vs * vs).sum(axis=1), safe_seg) if batch.nnz
                  else np.zeros(batch.n))
        out = b + sum_w + 0.5 * ((sum_v * sum_v).sum(axis=1) - sum_v2)
        out = np.where(counts > 0, out, b)
        return out.astype(np.float32)
