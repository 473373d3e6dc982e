"""Wide & deep CTR model on one card, or over a (data, server) mesh.

Counterpart of ``parameter_server_tpu/apps/linear/deep_ctr.py``: a wide
linear term over hashed sparse features plus a deep ReLU MLP over the
concatenated per-lane embeddings,

    f(x) = b + sum_i w_i + MLP([e_1 | e_2 | ... | e_K])      e_i = V[slot_i]

with ``w`` ([slots]) and ``V`` ([slots, k]) one server shard on the card
and the MLP beside them. The deep gradients come from ``torch.autograd``
over the fused forward (the JAX step's ``jax.vjp``); the ``live`` mask
sits inside the differentiated function, so sentinel lanes get no
gradient. The per-entry gradients go into ``g_w`` and ``g_v`` by
``scatter_sum`` (the ``segment_sum`` kernel on the card, one launch
each), and everything updates with AdaGrad (the proximal L1 step
on the wide table only) where ``touched = (g_w != 0) | (|g_v|.sum(1) !=
0)``. The MLP's products are ``torch.matmul`` (the JAX package computes
them in XLA, outside any Pallas kernel), and its He init draws from
``np.random.default_rng(seed)`` as the JAX worker does, so both packages
start from the same MLP bits.

**Over a mesh** (``DeepCTRWorker(conf, mesh=...)``): the table as the FM
worker's (``fm.py``: rank ``(d, s)`` holds server shard ``s`` and data
row ``d`` of each batch; a pull sums the owned rows over the server
axis), the MLP and the bias replicated on every rank, and the wide,
deep, MLP and bias gradients summed over the data axis in one
``psum``, as the JAX step's ``psum``s give them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ... import convert
from ...ops.kv_ops import localize, scatter_sum, valid_slots
from ...utils.sparse import SparseBatch
from .async_sgd import _PROGRESS, _fold_over_mesh, _mesh_or_none, _progress_metrics, _shard
from .config import Config
from .fm import ELLWorker, adagrad, fit_rows, pull_over_mesh, sum_over_data, update_table
from .learning_rate import LearningRate


def _mlp_forward(h: torch.Tensor, mlp: List[torch.Tensor]) -> torch.Tensor:
    """ReLU MLP over [R, lanes * k] -> [R] (mirrored in numpy by
    ``predict_margin``)."""
    for i in range(len(mlp) // 2 - 1):
        h = torch.relu(h @ mlp[2 * i] + mlp[2 * i + 1])
    return (h @ mlp[-2] + mlp[-1])[:, 0]


def make_deep_ctr_step(num_slots: int, k: int, lanes: int, loss, penalty, lr: LearningRate,
                       with_aux: bool = True, mesh=None):
    """The wide&deep step over one ELL batch (binary): ``step(state, y,
    mask, slots) -> (new_state, metrics)`` (``mesh``: the module's
    docstring)."""
    mesh = _mesh_or_none(mesh)
    shard = _shard(num_slots, mesh)

    def step(state, y, mask, slots):
        r = slots.shape[0]
        rel, ok = localize(slots.reshape(-1), shard, mesh)
        table = state["table"]
        w_e, v_e = pull_over_mesh(table, rel, ok, mesh)
        w_e = w_e.reshape(r, lanes)
        v_e = v_e.reshape(r, lanes, k).requires_grad_()
        live = valid_slots(slots, num_slots).to(torch.float32)
        mlp = [p.detach().requires_grad_() for p in state["mlp"]]
        with torch.enable_grad():
            # the live mask INSIDE the differentiated function: sentinel
            # lanes' embedding gradients vanish
            e = (v_e * live[..., None]).reshape(r, lanes * k)
            xw = state["b"] + (w_e * live).sum(1) + _mlp_forward(e, mlp)
            gr = loss.row_grad(y, xw.detach()) * mask
            g_ve, *g_mlp = torch.autograd.grad(xw, [v_e] + mlp, grad_outputs=gr)
        xw = xw.detach()

        gw_flat = (gr[:, None].expand(r, lanes) * live).reshape(-1)
        g_w = scatter_sum(shard, rel, torch.where(ok, gw_flat, 0.0)[:, None])[:, 0]
        g_v = scatter_sum(shard, rel, torch.where(ok[:, None], g_ve.reshape(-1, k), 0.0))
        g_w, g_v, g_b, *g_mlp = sum_over_data(mesh, g_w, g_v, gr.sum(), *g_mlp)
        touched = (g_w != 0) | (g_v.abs().sum(1) != 0)
        mlp_new, mlp_ss = zip(*(adagrad(lr, p.detach(), s, g)
                                for p, s, g in zip(mlp, state["mlp_ss"], g_mlp)))
        b_new, b_ss = adagrad(lr, state["b"], state["b_ss"], g_b)
        new_state = {
            "table": update_table(table, g_w, g_v, touched, lr, penalty),
            "mlp": list(mlp_new),
            "mlp_ss": list(mlp_ss),
            "b": b_new,
            "b_ss": b_ss,
        }
        metrics = _progress_metrics(loss, y, xw, mask, with_aux)
        return new_state, _fold_over_mesh([metrics], _PROGRESS, mesh)[0]

    return step


class DeepCTRWorker(ELLWorker):
    """Async wide&deep trainer on one card, or over ``mesh`` (default: the
    started postoffice's), the FM worker's API (``process_minibatch`` /
    ``collect`` / ``train`` / ``evaluate`` / ``predict_margin`` /
    ``state_host`` / ``load_state_host``). ``device=None`` is the card
    (raises without one)."""

    def __init__(self, conf: Config, k: int = 8, hidden: Sequence[int] = (64, 32), device=None,
                 v_init_std: float = 0.01, seed: int = 0, name: str = "deep_ctr_worker",
                 mesh=None):
        super().__init__(conf, k, device, seed, v_init_std, name, mesh=mesh)
        self.lanes = int(self.sgd.ell_lanes)
        self.hidden = tuple(int(h) for h in hidden)
        rng = np.random.default_rng(seed)
        dims = (self.lanes * self.k,) + self.hidden + (1,)
        mlp = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            w = rng.normal(0.0, np.sqrt(2.0 / d_in), (d_in, d_out)).astype(np.float32)
            mlp += [torch.from_numpy(w).to(self.device), torch.zeros(d_out, device=self.device)]
        scalar = torch.zeros((), device=self.device)
        self.state = {"table": self._table, "mlp": mlp,
                      "mlp_ss": [torch.zeros_like(p) for p in mlp],
                      "b": scalar, "b_ss": scalar.clone()}
        del self._table
        self._step = make_deep_ctr_step(self.num_slots, self.k, self.lanes, self.loss,
                                        self.penalty, self.lr, mesh=self.mesh)

    def table(self):
        return self.state["table"]

    def wipe_server_shard(self, shard: int) -> None:
        """Zero a dead server shard's table rows; the MLP, held by every
        rank, survives a server's death."""
        self.state = dict(self.state, table=self._wiped_table(shard))

    def load_state_host(self, snap: dict) -> None:
        st = dict(snap["state"])
        st["table"] = {name: fit_rows(leaf, self.shard_rows) for name, leaf in st["table"].items()}
        self.executor.wait_all(pop=False)
        self.state = convert.tree_from_numpy(st, self.device)

    def predict_margin(self, batch: SparseBatch) -> np.ndarray:
        """Host forward in float64 (the evaluation path) in the step's
        lane layout: short rows pad with zero embeddings; a row wider
        than the lane budget raises, as the training path does."""
        w, v, b = self._host_table()
        mlp = [p.cpu().numpy().astype(np.float64) for p in self.state["mlp"]]
        if batch.n == 0:
            return np.zeros(0, np.float32)
        lanes, kk = self.lanes, self.k
        counts = np.diff(batch.indptr)
        if counts.max(initial=0) > lanes:
            raise ValueError(
                f"row with {int(counts.max())} features exceeds the ELL "
                f"lane budget ({lanes}); predict_margin refuses to drop "
                "features (same contract as the training path)"
            )
        slots = self.directory.slots(batch.indices)
        mat = np.zeros((batch.n, lanes), np.int64)  # the CSR stream as [n, lanes]
        ok = np.arange(lanes)[None, :] < counts[:, None]
        rows_idx = np.repeat(np.arange(batch.n), counts)
        lane_idx = np.arange(batch.nnz) - np.repeat(batch.indptr[:-1].astype(np.int64), counts)
        mat[rows_idx, lane_idx] = slots
        e = v[mat] * ok[..., None]  # [n, lanes, k]
        wide = (w[mat] * ok).sum(axis=1)
        h = e.reshape(batch.n, lanes * kk)
        for i in range(len(mlp) // 2 - 1):
            h = np.maximum(h @ mlp[2 * i] + mlp[2 * i + 1], 0.0)
        deep = (h @ mlp[-2] + mlp[-1])[:, 0]
        return (b + wide + deep).astype(np.float32)
