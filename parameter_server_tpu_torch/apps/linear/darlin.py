"""Darlin: delayed block proximal gradient for L1 logistic regression.

Counterpart of ``parameter_server_tpu/apps/linear/darlin.py`` (the
reference's ``src/app/linear_method/darlin.h``, its batch solver), on one
device. The same mathematics, in the same order:

- a multiplicative dual ``dual_i = exp(y_i * Xw_i)``, ``tau_i = 1/(1+dual_i)``;
- for a block's columns the gradient ``G_j = sum_i -y_i tau_i x_ij`` and the
  curvature bound ``U_j = sum_i min(tau(1-tau) e^{|x_ij| delta_j}, 1/4) x_ij^2``;
- the shrink step with trust region ``delta`` and the KKT filter: a
  coordinate at zero whose gradient lies inside ``(-lam + thr, lam - thr)``
  is suspended until the active set is reset;
- ``delta = min(delta_max, 2|d| + 0.1)``; the dual update
  ``dual_i *= exp(y_i * sum_j x_ij d_j)``;
- the scheduler: a random block order a pass (Python's ``random`` with the
  same seed, so both packages visit the blocks in the same order), block
  delay tau, KKT threshold annealing ``thr = violation / num_ex * ratio``
  and the reset-on-converge double check.

**Over a mesh** (``mesh=``, or the started postoffice's; one process a
position, ``parallel/mesh.py``): the examples are split over the data
axis as the JAX solver splits them (rows ``[d * per, (d + 1) * per)`` to
data rank ``d``, ``per = ceil(n / D)``), so each rank holds its rows'
labels, mask and dual; the model (``w``, ``delta``, the active set) is
replicated, every rank computing the same update. A block step sums G
and U over the data axis (one ``psum`` of the two stacked: the bits of
the JAX step's two). The ranks of a server column repeat its data row's
work, as the JAX step's replicated server axis does. ``evaluate`` and
``predict_margin`` gather every row's dual over the data axis (on the
caller's thread, after the pass's steps have run), and ``save_model``
writes one file a server shard, each from the rank of data row 0 that
holds it. Every rank loads and localizes the whole training set (host
work the JAX process does once), and runs the same program: the block
order comes from the same seed, and the block steps' psums run on the
executor's dispatch thread in submission order, the same on every rank.
With one rank the ``psum`` is the identity. The three sums of a block step
(G and U by column, ``X d`` by row) go through ``ops/segment_sum.py``: on
the card the hand-written ``segment_sum`` kernel adds each segment in
entry order, as XLA's CPU scatter does, so a run is bit-identical from
run to run. Each block is uploaded once, in ``init_data``, in column
order for G and U (its ids grouped, the zero padding at the tail, so the
card skips the sort) and once more in stable row order for ``X d``: a
row's entries keep their column order, so the sum by row adds the same
numbers in the same order as the sum over the column-ordered entries,
and needs no sort a step.

The block steps run on an :class:`Executor`: step ``ts`` waits for step
``ts - tau - 1``, and a step is finished only when its device work is,
so up to tau + 1 block steps are queued on the stream while the host
submits the next. The host waits once a pass.
"""

from __future__ import annotations

import dataclasses
import logging
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from ...device import resolve, scalar_like
from ...learner.bcd import BCDProgress, BCDScheduler, FeatureBlock
from ...ops.segment_sum import segment_sum
from ...parallel import mesh as meshlib
from ...parallel.mesh import DATA_AXIS
from ...system.executor import Executor, Task
from ...utils import file as psfile
from ...utils.sparse import SparseBatch
from .config import BCDConfig, Config


@dataclasses.dataclass
class ColBlock:
    """A column block's entries on the device, twice: in column (CSC)
    order for G and U, and in stable row order for ``X d``. Padding
    entries (row 0, column 0, value 0) fill the column order's tail."""

    rows: torch.Tensor  # [NZ] int32, example ids
    cols: torch.Tensor  # [NZ] int32, block-local column ids
    vals: torch.Tensor  # [NZ] float32 (0: padding)
    rows_by_row: torch.Tensor  # [NZ] int32, nondecreasing
    cols_by_row: torch.Tensor  # [NZ] int32
    vals_by_row: torch.Tensor  # [NZ] float32
    num_cols: int


def _pow2_bucket(n: int, floor: int = 1024) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def block_step(w, delta, active, dual, y, mask, blk: ColBlock, thr, lam: float, eta: float,
               delta_max: float, reset: bool = False, mesh=None):
    """One block update: ``(new_w, new_delta, new_active, new_dual,
    violation)``, all on the block's device, the violation a 0-dim tensor.
    ``thr`` is a float32 value (the JAX step takes it as ``jnp.float32``).
    The inputs are not written to. ``mesh``: ``dual``, ``y``, ``mask``
    and the block's rows are this rank's data row; G and U are summed
    over the data axis (a collective)."""
    if reset:
        active = torch.ones_like(active)
    n_cols, n_rows = blk.num_cols, dual.numel()
    tau = scalar_like(1.0, dual) / (1.0 + dual)
    tr = tau[blk.rows]
    yr = y[blk.rows]
    # G and U by column: the padding's zero values add nothing
    g_col = segment_sum(-yr * tr * blk.vals, blk.cols, n_cols, presorted=True)
    curv = torch.clamp(tr * (1 - tr) * torch.exp(blk.vals.abs() * delta[blk.cols]), max=0.25)
    u_col = segment_sum(curv * blk.vals * blk.vals, blk.cols, n_cols, presorted=True)
    if mesh is not None and mesh.shape[DATA_AXIS] > 1:
        # the gradient push: both sums in one psum over the data axis
        g_col, u_col = meshlib.psum(torch.stack([g_col, u_col]), DATA_AXIS, mesh)

    # the shrink step
    u = u_col / scalar_like(eta, u_col) + 1e-10
    g_pos = g_col + lam
    g_neg = g_col - lam
    zero_active = (w == 0) & active
    vio = torch.where(zero_active,
                      torch.where(g_pos < 0, -g_pos, torch.where(g_neg > 0, g_neg, 0.0)), 0.0)
    violation = vio.max()
    deactivate = zero_active & (g_pos > thr) & (g_neg < -thr) & (vio == 0)
    new_active = active & ~deactivate
    uw = u * w
    d_w = torch.where(g_pos <= uw, -g_pos / u, torch.where(g_neg >= uw, -g_neg / u, -w))
    d_w = torch.clamp(d_w, -delta, delta)
    d_w = torch.where(new_active, d_w, 0.0)
    new_delta = torch.where(new_active, torch.clamp(2.0 * d_w.abs() + 0.1, max=delta_max), delta)
    new_w = w + d_w

    # the dual update: dual *= exp(y * X d), X d summed by row
    xdw = segment_sum(blk.vals_by_row * d_w[blk.cols_by_row], blk.rows_by_row, n_rows,
                      presorted=True)
    new_dual = dual * torch.exp(y * xdw) * mask + (1 - mask)
    return new_w, new_delta, new_active, new_dual, violation


class DarlinSolver:
    """The worker and server of one darlin run, fused, on ``device`` (the
    CUDA device unless the caller names another), or on this rank's
    position of ``mesh`` (the module's docstring)."""

    def __init__(self, conf: Config, device=None, mesh=None):
        self.mesh = None if mesh is None or mesh.size == 1 else mesh
        if self.mesh is not None:
            device = self.mesh.device
        self.device = resolve(device)
        self.conf = conf
        self.bcd: BCDConfig = conf.darlin or BCDConfig()
        self.lam = float(conf.penalty.lambda_[0])
        self.eta = float(conf.learning_rate.alpha)
        # device state, set by init_data
        self.y: Optional[torch.Tensor] = None
        self.dual: Optional[torch.Tensor] = None
        self.row_mask: Optional[torch.Tensor] = None
        # each block's model state on the device; the host never waits on
        # it inside a pass
        self.w_blk: List[torch.Tensor] = []
        self.delta_blk: List[torch.Tensor] = []
        self.active_blk: List[torch.Tensor] = []
        self.fea_blocks: List[FeatureBlock] = []
        self.blocks: List[ColBlock] = []
        self.num_ex = 0
        self.num_cols = 0
        self.rows_per_shard = 0

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _row_range(self, n: int):
        """This rank's examples ``[lo, hi)`` and the rows a data shard
        holds (padded): all ``n`` with no mesh."""
        d = 1 if self.mesh is None else meshlib.num_workers(self.mesh)
        per = -(-n // d) if n else 0
        i = 0 if self.mesh is None else self.mesh.data_index
        return min(i * per, n), min((i + 1) * per, n), per

    def init_data(self, data: SparseBatch, fea_blocks: List[FeatureBlock]) -> None:
        """Upload this rank's rows' labels and dual (all ones), each
        block's model state and each block's entries in those rows, once."""
        n = data.n
        self.num_ex = n
        lo_r, hi_r, per = self._row_range(n)
        self.rows_per_shard = per
        y = np.zeros(per, np.float32)
        y[:hi_r - lo_r] = np.asarray(data.y, np.float32)[lo_r:hi_r]
        mask = np.zeros(per, np.float32)
        mask[:hi_r - lo_r] = 1.0
        self.y = self._put(y)
        self.row_mask = self._put(mask)
        self.dual = torch.ones(per, dtype=torch.float32, device=self.device)
        self.num_cols = data.cols
        self.fea_blocks = list(fea_blocks)
        self.w_blk, self.delta_blk, self.active_blk = [], [], []
        for blk in fea_blocks:
            c = blk.col_range.size()
            self.w_blk.append(torch.zeros(c, dtype=torch.float32, device=self.device))
            self.delta_blk.append(torch.full((c,), self.bcd.delta_init_value,
                                             dtype=torch.float32, device=self.device))
            self.active_blk.append(torch.ones(c, dtype=torch.bool, device=self.device))

        csc = data.to_csc()
        self.blocks = []
        for blk in fea_blocks:
            c0, c1 = blk.col_range.begin, blk.col_range.end
            lo, hi = int(csc.colptr[c0]), int(csc.colptr[c1])
            rows_blk = np.asarray(csc.row_ids[lo:hi])
            cols_blk = np.repeat(np.arange(c1 - c0, dtype=np.int32),
                                 np.diff(csc.colptr[c0:c1 + 1]).astype(np.int64))
            vals_blk = (np.ones(hi - lo, np.float32) if csc.values is None
                        else np.asarray(csc.values[lo:hi], np.float32))
            if self.mesh is not None:
                # this rank's rows, in the block's column order
                mine = (rows_blk >= lo_r) & (rows_blk < hi_r)
                rows_blk, cols_blk, vals_blk = rows_blk[mine] - lo_r, cols_blk[mine], vals_blk[mine]
            k = rows_blk.size
            nz_pad = _pow2_bucket(k if k else 1)
            rows = np.zeros(nz_pad, np.int32)
            cols = np.zeros(nz_pad, np.int32)
            vals = np.zeros(nz_pad, np.float32)
            rows[:k] = rows_blk
            cols[:k] = cols_blk
            vals[:k] = vals_blk
            by_row = np.argsort(rows, kind="stable")
            self.blocks.append(ColBlock(
                rows=self._put(rows), cols=self._put(cols), vals=self._put(vals),
                rows_by_row=self._put(rows[by_row]), cols_by_row=self._put(cols[by_row]),
                vals_by_row=self._put(vals[by_row]), num_cols=c1 - c0))

    def dispatch_block(self, blk_id: int, thr: float, reset: bool) -> torch.Tensor:
        """Launch one block update without waiting for it; the block's KKT
        violation comes back as a 0-dim device tensor. The new state
        replaces the block's tensors at once: consecutive steps chain
        through the dual on one stream, in submission order."""
        new_w, new_delta, new_active, new_dual, violation = block_step(
            self.w_blk[blk_id], self.delta_blk[blk_id], self.active_blk[blk_id], self.dual,
            self.y, self.row_mask, self.blocks[blk_id], float(np.float32(thr)), self.lam, self.eta,
            self.bcd.delta_max_value, reset, mesh=self.mesh)
        self.w_blk[blk_id] = new_w
        self.delta_blk[blk_id] = new_delta
        self.active_blk[blk_id] = new_active
        self.dual = new_dual
        return violation

    def update_block(self, blk_id: int, fea_blocks: List[FeatureBlock], thr: float,
                     reset: bool) -> float:
        """A block update that waits for its violation (tests, debugging)."""
        del fea_blocks  # the block layout is fixed at init_data
        return float(self.dispatch_block(blk_id, thr, reset))

    def reset_active(self) -> None:
        """Re-activate every coordinate (the reference's reset_kkt_filter)."""
        self.active_blk = [torch.ones_like(a) for a in self.active_blk]

    # -- the model state, whole or on the host --

    def state(self) -> Dict[str, object]:
        """The device state: ``{"w", "delta", "active"}`` lists of per-block
        tensors and ``"dual"`` (``convert.darlin_state_to_numpy``)."""
        return dict(w=list(self.w_blk), delta=list(self.delta_blk),
                    active=list(self.active_blk), dual=self.dual)

    def set_state(self, state: Dict[str, object]) -> None:
        """Install a state of :meth:`state`'s form (``convert.
        darlin_state_from_jax`` builds one from a JAX solver's)."""
        self.w_blk = list(state["w"])
        self.delta_blk = list(state["delta"])
        self.active_blk = list(state["active"])
        self.dual = state["dual"]

    def _assemble(self, parts: List[torch.Tensor], fill, dtype) -> np.ndarray:
        out = np.full(self.num_cols, fill, dtype)
        if parts:
            whole = torch.cat(parts).cpu().numpy()
            at = 0
            for blk in self.fea_blocks:
                c = blk.col_range.size()
                out[blk.col_range.begin:blk.col_range.end] = whole[at:at + c]
                at += c
        return out

    @property
    def w(self) -> np.ndarray:
        return self._assemble(self.w_blk, 0.0, np.float32)

    @property
    def delta(self) -> np.ndarray:
        return self._assemble(self.delta_blk, self.bcd.delta_init_value, np.float32)

    @property
    def active(self) -> np.ndarray:
        return self._assemble(self.active_blk, True, bool)

    def _every_row(self, t: torch.Tensor) -> np.ndarray:
        """A per-row tensor of every data shard, in data order, on the host
        (a gather over the data axis on a mesh: every rank calls it)."""
        if self.mesh is not None:
            t = meshlib.all_gather(t, DATA_AXIS, self.mesh)
        return t.cpu().numpy()

    def evaluate(self) -> BCDProgress:
        """The objective ``sum log(1 + 1/dual) + lam |w|_1`` on the host, in
        numpy, as the JAX package computes it (every row's dual, in data
        order)."""
        dual = self._every_row(self.dual)
        mask = self._every_row(self.row_mask) > 0
        logloss = float(np.log1p(1.0 / dual[mask]).sum())
        w = self.w
        return BCDProgress(objective=logloss + self.lam * float(np.abs(w).sum()),
                           nnz_w=int((w != 0).sum()), nnz_active_set=int(self.active.sum()))

    def predict_margin(self) -> np.ndarray:
        """Xw of the training examples, from the dual (``exp(y Xw)``)."""
        dual = self._every_row(self.dual)
        y = self._every_row(self.y)
        mask = self._every_row(self.row_mask) > 0
        return (np.log(dual[mask]) / np.where(y[mask] != 0, y[mask], 1.0)).ravel()


class DarlinScheduler(BCDScheduler):
    """The training loop (the reference's DarlinScheduler::Run)."""

    def __init__(self, conf: Config, device=None, name: str = "darlin_scheduler", mesh=None):
        super().__init__(conf.darlin or BCDConfig(), name=name)
        if mesh is None and self.po.started:
            mesh = self.po.mesh
        self.conf = conf
        # KEY_CACHING is subsumed: the blocks stay on the device across
        # passes, so keys are never sent again; any other filter would
        # change the numbers, and is not applied
        for f in (conf.darlin.comm_filter if conf.darlin else []) or []:
            ftype = str(f.get("type", "") if isinstance(f, dict) else f).lower()
            if ftype not in ("key_caching", "compressing"):
                logging.getLogger(__name__).warning(
                    "darlin comm_filter %r is not applied (blocks are device-resident; only "
                    "key_caching/compressing semantics are subsumed)", ftype)
        self.solver = DarlinSolver(conf, device=device, mesh=mesh)
        self.seed = 0
        self._converged_once = False
        # max_dispatch_window: the most steps started and unfinished at a
        # dispatch (tau + 1 once there are enough blocks; what tests read).
        # max_in_flight_observed: steps whose device work was still running
        # when the host submitted another (timing-dependent; reported)
        self.max_dispatch_window = 0
        self.max_in_flight_observed = 0

    def run_on(self, data: SparseBatch, verbose: bool = False) -> BCDProgress:
        self.set_data(data)
        return self.run_loaded(verbose=verbose)

    def run_loaded(self, verbose: bool = False) -> BCDProgress:
        """Train on the data of ``load_data`` or ``set_data``."""
        if self.conf.loss.type != "logit" or self.conf.penalty.type != "l1":
            raise ValueError("darlin trains L1-regularized logistic regression "
                             f"(loss {self.conf.loss.type}, penalty {self.conf.penalty.type})")
        if self.data is None:
            raise ValueError("load data first")
        blocks = self.divide_feature_blocks()
        self.solver.init_data(self.data, blocks)
        # step ts waits for every step up to ts - tau - 1
        tau = max(0, self.bcd_conf.max_block_delay)
        executor = Executor(name=self.name)
        rng = random.Random(self.seed)
        try:
            return self._run_passes(executor, tau, rng, verbose)
        finally:
            executor.stop()

    def _run_passes(self, executor: Executor, tau: int, rng: random.Random,
                    verbose: bool) -> BCDProgress:
        kkt_threshold = 1e20
        reset_kkt = False
        prev_objv = None
        prog = BCDProgress()
        for iteration in range(self.bcd_conf.num_data_pass):
            order = list(self.blk_order)
            if self.bcd_conf.random_feature_block_order:
                rng.shuffle(order)
            if reset_kkt:
                # the reference resets the active set of every group
                self.solver.reset_active()
                reset_kkt = False
            pass_start = executor.time()
            pending_ts = []
            for blk_id in order:
                dep = executor.time() - (tau + 1)
                task = Task(wait_time=[dep] if dep >= pass_start else [])
                ts = executor.submit(
                    lambda b=blk_id, t=kkt_threshold: self.solver.dispatch_block(b, t, reset=False),
                    task)
                pending_ts.append(ts)
                busy = sum(executor.device_busy(t) for t in pending_ts)
                self.max_in_flight_observed = max(self.max_in_flight_observed, busy)
            from ...system.postoffice import Postoffice

            po = Postoffice._instance  # never create the singleton here
            if po is not None:
                po.beat(self.name)  # liveness signal (ref heartbeat thread)
            vios = [executor.wait(t) for t in pending_ts]
            self.max_dispatch_window = max(self.max_dispatch_window,
                                           executor.max_dispatched_in_flight)
            violation = max((float(v) for v in vios if v is not None), default=0.0)
            prog = self.solver.evaluate()
            prog.violation = violation
            if prev_objv is not None and prev_objv > 0:
                prog.relative_obj = (prev_objv - prog.objective) / prev_objv
            self.merge_progress(iteration, prog)
            if verbose:
                print(self.show_progress(iteration), flush=True)
            kkt_threshold = (violation / max(1, self.solver.num_ex)
                             * self.bcd_conf.kkt_filter_threshold_ratio)
            rel = prog.relative_obj
            if prev_objv is not None and 0 <= rel <= self.bcd_conf.epsilon:
                if reset_kkt is False and self._converged_once:
                    break
                self._converged_once = True
                reset_kkt = True  # check once more with the whole active set
            else:
                self._converged_once = False
            prev_objv = prog.objective
        return prog

    def save_model(self, path: str) -> List[str]:
        """``key\\tweight`` lines of the nonzero weights in key-column
        order, one file a server shard, ``{path}_S{s}`` (the eval confs
        read ``model_S.*``), shard ``s`` the ``s``-th of the contiguous
        even division of the key columns, as the JAX scheduler writes
        them. On a mesh the rank of data row 0 holding shard ``s`` writes
        its file, and no rank returns before every file is whole."""
        keys = self.global_keys
        w = self.solver.w
        mesh = self.solver.mesh
        n_server = 1 if mesh is None else meshlib.num_servers(mesh)
        bounds = [len(keys) * s // n_server for s in range(n_server + 1)]
        written = [f"{path}_S{s}" for s in range(n_server)]
        mine = range(n_server) if mesh is None else (
            [mesh.server_index] if mesh.data_index == 0 else [])
        for s in mine:
            keep = bounds[s] + np.flatnonzero((w[bounds[s]:bounds[s + 1]] != 0)
                                              & ~np.isnan(w[bounds[s]:bounds[s + 1]]))
            with psfile.open_write(written[s]) as f:
                f.write("".join(f"{keys[i]}\t{float(w[i])!r}\n" for i in keep))
        if mesh is not None:
            done = torch.zeros(1, device=self.solver.device)
            for axis in (meshlib.SERVER_AXIS, DATA_AXIS):
                done = meshlib.psum(done, axis, mesh)
        return written
