"""Factorization machine on one card, or over a (data, server) mesh.

Counterpart of ``parameter_server_tpu/apps/linear/fm.py``. Model (binary
features, the CTR case):

    f(x) = b + sum_i w_i + 0.5 * (||sum_i v_i||^2 - sum_i ||v_i||^2)

over the active slots i of a row, the O(nnz * k) identity for the
pairwise term. ``w`` ([slots]) and ``V`` ([slots, k]) are one server
shard on the card; with one data shard and one server shard the JAX
step's ``psum``s are the identity. Every parameter updates with AdaGrad
and the proximal elastic-net step on ``w`` (``V`` at ``v_lr_scale``
times the rate, no L1), only where ``touched = g_w != 0``.

**Over a mesh** (``FMWorker(conf, mesh=...)``, or the started
postoffice's mesh; ``parallel/mesh.py``), as the JAX worker's
``shard_map`` body: rank ``(d, s)`` holds server shard ``s`` of ``w``
and ``V`` (its key range, ``num_slots / S`` rows) and keeps data row
``d`` of each ELL batch. A pull is a masked gather of the owned rows
and a ``psum`` over the server axis; the entries' gradients are added
into the owned shard and summed over the data axis, with the bias's;
the metrics fold over data as the linear worker's. Each rank draws the
whole ``V`` from the seed, as one card does (its configured rows; the
mesh's padding rows, which no key hashes to, are zero), and keeps its
rows, so a ``1 x S`` run from seed ``s`` starts where the one-card run
does.
Every rank of the mesh makes the same calls on the same stream.

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
from ...parallel import mesh as meshlib
from ...parallel.mesh import DATA_AXIS, SERVER_AXIS, psum
from ...parameter.parameter import KeyDirectory, pad_slots
from ...system.message import Task
from ...utils import evaluation
from ...utils.sparse import SparseBatch
from .async_sgd import _PROGRESS, _fold_over_mesh, _mesh_or_none, _progress_metrics, _shard
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


def pull_over_mesh(table: Dict[str, torch.Tensor], rel: torch.Tensor, ok: torch.Tensor,
                   mesh) -> tuple:
    """``w`` and ``V`` at the entries, ``[n]`` and ``[n, k]``: the owned
    rows, summed over the server axis on a mesh (one ``psum`` of both)."""
    w_e, v_e = pull_rows(table["w"], rel, ok), pull_rows(table["v"], rel, ok)
    if mesh is None:
        return w_e, v_e
    both = psum(torch.cat([w_e[:, None], v_e], 1), SERVER_AXIS, mesh)
    return both[:, 0], both[:, 1:]


def sum_over_data(mesh, *grads: torch.Tensor) -> list:
    """``grads`` summed over the data axis (one ``psum`` of them all),
    as they are with no mesh."""
    if mesh is None or mesh.shape[DATA_AXIS] == 1:
        return list(grads)
    flat = psum(torch.cat([g.reshape(-1) for g in grads]), DATA_AXIS, mesh)
    out, lo = [], 0
    for g in grads:
        out.append(flat[lo:lo + g.numel()].view_as(g))
        lo += g.numel()
    return out


def make_fm_step(num_slots: int, k: int, loss, penalty, lr: LearningRate, v_lr_scale: float,
                 with_aux: bool = True, mesh=None):
    """The FM step over one ELL batch (binary): ``step(state, y [R],
    mask [R], slots [R, K]) -> (new_state, metrics)``. Pulls w and V at
    the batch's slots (sentinel lanes masked by ``live``), forward by
    the pairwise identity, scatters per-entry gradients, AdaGrad on
    both tables and the bias. ``mesh``: ``state`` is this rank's server
    shard and the batch its data row (the module's docstring)."""
    mesh = _mesh_or_none(mesh)
    shard = _shard(num_slots, mesh)

    def step(state, y, mask, slots):
        r, lanes = slots.shape
        rel, ok = localize(slots.reshape(-1), shard, mesh)
        live = valid_slots(slots, num_slots).to(torch.float32)
        w_e, v_e = pull_over_mesh(state, rel, ok, mesh)
        w_e = w_e.reshape(r, lanes) * live
        v_e = v_e.reshape(r, lanes, k) * live[..., None]

        s = v_e.sum(1)  # [R, k]
        pair = 0.5 * ((s * s).sum(1) - (v_e * v_e).sum((1, 2)))
        xw = state["b"] + w_e.sum(1) + pair
        gr = loss.row_grad(y, xw) * mask

        lanes_live = (live.reshape(-1) > 0) & ok
        gw_flat = gr[:, None].expand(r, lanes).reshape(-1)
        gv_flat = (gr[:, None, None] * (s[:, None, :] - v_e)).reshape(-1, k)
        g_w = scatter_sum(shard, rel, torch.where(lanes_live, gw_flat, 0.0)[:, None])[:, 0]
        g_v = scatter_sum(shard, rel, torch.where(lanes_live[:, None], gv_flat, 0.0))
        g_w, g_v, g_b = sum_over_data(mesh, g_w, g_v, gr.sum())
        touched = g_w != 0  # the embeddings ride the linear support
        b, b_ss = adagrad(lr, state["b"], state["b_ss"], g_b)
        new_state = dict(update_table(state, g_w, g_v, touched, lr, penalty, v_lr_scale),
                         b=b, b_ss=b_ss)
        metrics = _progress_metrics(loss, y, xw, mask, with_aux)
        return new_state, _fold_over_mesh([metrics], _PROGRESS, mesh)[0]

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
    the V init, the mesh, the step's submission and the snapshot hooks.
    Steps run on the customer's executor, in submission order. On a mesh
    :meth:`state_host` / :meth:`load_state_host` give and take this
    rank's server shard (``convert.shard_state`` / ``unshard_state``
    join and cut the whole); :meth:`predict_margin` and
    :meth:`evaluate` gather the whole table, every rank calling them."""

    def __init__(self, conf: Config, k: int, device, seed: int, v_init_std: float, name: str,
                 mesh=None):
        super().__init__(name=name)
        if mesh is None and self.po.started:
            mesh = self.po.mesh
        #: the mesh the table and the batch are sharded over (None: one card)
        self.mesh = _mesh_or_none(mesh)
        if self.mesh is not None:
            device = self.mesh.device
        elif device is None and self.po.started:
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
        n_server = 1 if self.mesh is None else meshlib.num_servers(self.mesh)
        self.num_slots = pad_slots(sgd.num_slots, n_server)
        #: this rank's rows of the table: its server shard
        self.shard_rows = self.num_slots // n_server
        # the hash modulus is the CONFIGURED slot count (the JAX rule)
        self.directory = KeyDirectory(sgd.num_slots, hashed=True)
        self._rows_pad = None
        self.progress = SGDProgress()
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        n, lo = self.shard_rows, self._row0()
        # the draw of one card (its configured rows: the mesh's padding
        # rows, which no key hashes to, stay zero), this rank's rows kept
        drawn = v_init_std * torch.randn((sgd.num_slots, self.k), generator=gen,
                                         device=self.device)
        v = torch.zeros((n, self.k), device=self.device)
        v[: max(0, min(n, sgd.num_slots - lo))] = drawn[lo:lo + n]
        del drawn
        self._table = {
            "w": torch.zeros(n, device=self.device),
            "w_ss": torch.zeros(n, device=self.device),
            "v": v,
            "v_ss": torch.zeros((n, self.k), device=self.device),
        }

    def _row0(self) -> int:
        """The first table row this rank holds."""
        return 0 if self.mesh is None else self.mesh.server_index * self.shard_rows

    def upload(self, batch: SparseBatch):
        """This rank's data row of the batch's ELL arrays on the card."""
        p = self._prep_ell(batch)
        d = 0 if self.mesh is None else self.mesh.data_index
        return tuple(torch.from_numpy(a[d]).to(self.device) for a in (p.y, p.mask, p.slots))

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
        the JAX worker's ``{"state": ...}`` tree (on a mesh, this rank's
        server shard of the table)."""
        self.executor.wait_all(pop=False)
        return {"state": convert.tree_to_numpy(self.state)}

    def _wiped_table(self, shard: int) -> Dict[str, torch.Tensor]:
        """The table's leaves with server shard ``shard``'s rows zeroed
        (on a mesh the ranks of that shard zero all theirs), once the
        steps in flight are done."""
        self.executor.wait_all(pop=False)
        mine = shard == 0 if self.mesh is None else shard == self.mesh.server_index
        return {name: torch.zeros_like(leaf) if mine else leaf
                for name, leaf in self.table().items()}

    def recover_server_shard(self, shard: int) -> bool:
        """No ongoing replica here (checkpoints give durability): a
        recovery reports failure, as the JAX workers' does."""
        del shard
        return False

    def _host_table(self):
        """The whole ``w`` and ``V`` in float64 and the bias, on the host
        (on a mesh gathered over the server axis: every rank calls it)."""
        self.executor.wait_all(pop=False)
        t = self.table()
        w, v = t["w"], t["v"]
        if self.mesh is not None and meshlib.num_servers(self.mesh) > 1:
            side = self.mesh.side
            w = meshlib.all_gather(w, SERVER_AXIS, side)
            v = meshlib.all_gather(v, SERVER_AXIS, side)
        return (w.cpu().numpy().astype(np.float64), v.cpu().numpy().astype(np.float64),
                float(self.state["b"]))

    def evaluate(self, batch: SparseBatch) -> Dict[str, float]:
        xw = self.predict_margin(batch)
        y = batch.y
        ll = float(np.mean(np.logaddexp(0.0, -y * xw)))
        return {"auc": evaluation.auc(y, xw), "logloss": ll}


class FMWorker(ELLWorker):
    """Async FM trainer on one card, or over ``mesh`` (default: the
    started postoffice's): ``process_minibatch`` / ``collect`` /
    ``train`` / ``evaluate`` / ``predict_margin`` / ``state_host`` /
    ``load_state_host``. ``device=None`` is the card (raises without
    one)."""

    def __init__(self, conf: Config, k: int = 8, device=None, v_init_std: float = 0.01,
                 v_lr_scale: float = 1.0, seed: int = 0, name: str = "fm_worker", mesh=None):
        super().__init__(conf, k, device, seed, v_init_std, name, mesh=mesh)
        scalar = torch.zeros((), device=self.device)
        self.state = dict(self._table, b=scalar, b_ss=scalar.clone())
        del self._table
        self._step = make_fm_step(self.num_slots, self.k, self.loss, self.penalty, self.lr,
                                  v_lr_scale, mesh=self.mesh)

    def table(self) -> Dict[str, torch.Tensor]:
        return {name: self.state[name] for name in ("w", "w_ss", "v", "v_ss")}

    def wipe_server_shard(self, shard: int) -> None:
        """Zero a dead server shard's rows of w, V and their AdaGrad sums
        (a replacement that boots empty); the bias stays."""
        self.state = dict(self.state, **self._wiped_table(shard))

    def load_state_host(self, snap: dict) -> None:
        """Install a host snapshot (this rank's shard on a mesh); a table
        of another size is cut or zero-extended."""
        st = {name: fit_rows(leaf, self.shard_rows) for name, leaf in snap["state"].items()}
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
