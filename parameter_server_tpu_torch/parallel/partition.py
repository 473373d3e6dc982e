"""Declarative partitioning: regex rules → partition specs, resolved once.

Counterpart of the layout half of
``parameter_server_tpu/parallel/partition.py``: the canonical specs of
the mesh (tables by server key range, batches over the data axis,
scalars replicated), a rule table mapping tree paths to specs, and one
:class:`MeshPartitioner` a mesh. ``jax.sharding.PartitionSpec`` becomes
:class:`PartitionSpec`, a tuple of axis names (or None) a dim, and a
``NamedSharding`` becomes :class:`Sharding`, which says which rows of a
global array this rank holds.

Heat-driven repartitioning (the module's second half, host code copied
from the JAX package): :func:`plan_rebalance` turns the measured hot-slot
and load-share tables of ``telemetry/learning.py::KeyHeat`` into a
:class:`RebalancePlan` (the JAX plan, bit for bit, from the same heat),
and :class:`RebalanceController` runs one online ``KVVector.migrate``
when the ``shard_imbalance`` alert fires. On a mesh of several server
shards a rebalance is a collective: every rank of the store's data row
calls :meth:`RebalanceController.execute` once for each rebalance, and
the row adopts the plan of its server shard 0 (broadcast over the
mesh's side group), so a rank whose own heat window or alert saw the
skew a batch later still moves the same rows.
"""

from __future__ import annotations

import abc
import dataclasses
import logging
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import AXES, DATA_AXIS, SERVER_AXIS, Mesh, all_gather

_LOG = logging.getLogger(__name__)


class PartitionSpec(tuple):
    """Per-dim mesh axis names (None: not sharded), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

#: the canonical declared specs
TABLE_SPEC = P(SERVER_AXIS, None)  # [P, k] tables: rows by server key range
BATCH_SPEC = P(DATA_AXIS)          # example batches over the worker axis
REPLICATED_SPEC = P()

#: default rule table: (path regex, spec); the first match wins, fitted
#: to each leaf's rank
DEFAULT_RULES: Tuple[Tuple[str, PartitionSpec], ...] = (
    (r"(^|/)(batch|examples?|y|mask|slots|vals)($|/)", BATCH_SPEC),
    (r"(^|/)(lr|step|count|beta|alpha|lambda)($|/)", REPLICATED_SPEC),
    (r".*", TABLE_SPEC),
)


def tree_path_to_string(path: Tuple, sep: str = "/") -> str:
    """A tree path (dict keys, sequence indices, dataclass field names)
    as a ``sep``-joined name."""
    return sep.join(str(k) for k in path)


def _is_leaf(x) -> bool:
    return not (isinstance(x, (dict, list, tuple)) or
                (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def _map_with_path(f: Callable, tree: Any, path: Tuple, is_leaf) -> Any:
    if tree is None:
        return None
    if (is_leaf is not None and is_leaf(tree)) or _is_leaf(tree):
        return f(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(f, v, path + (k,), is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_map_with_path(f, v, path + (i,), is_leaf) for i, v in enumerate(tree))
    if isinstance(tree, PartitionSpec):
        return f(path, tree)
    return dataclasses.replace(tree, **{
        fl.name: _map_with_path(f, getattr(tree, fl.name), path + (fl.name,), is_leaf)
        for fl in dataclasses.fields(tree) if fl.init})


def named_tree_map(f: Callable, tree: Any, sep: str = "/", is_leaf=None) -> Any:
    """Map ``f(name, leaf)`` over a tree of dicts, lists, tuples and
    dataclasses, ``name`` the leaf's ``sep``-joined path."""
    return _map_with_path(lambda p, x: f(tree_path_to_string(p, sep=sep), x), tree, (),
                          is_leaf)


def fit_spec(spec: PartitionSpec, ndim: int) -> PartitionSpec:
    """Fit a spec to a leaf's rank: scalars are replicated, shorter specs
    get trailing None dims, longer ones are cut."""
    if ndim == 0:
        return P()
    parts = tuple(spec)[:ndim]
    return P(*(parts + (None,) * (ndim - len(parts))))


def _ndim(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.dim()
    return getattr(leaf, "ndim", np.ndim(leaf))


def match_partition_rules(rules: Sequence[Tuple[str, PartitionSpec]], tree: Any) -> Any:
    """The tree of specs ``rules`` give ``tree``'s leaves: each leaf's path
    name against the rules in order, the first hit fitted to its rank.
    No match raises."""

    def match(name: str, leaf: Any) -> PartitionSpec:
        for pattern, spec in rules:
            if re.search(pattern, name):
                return fit_spec(spec, _ndim(leaf))
        raise ValueError(
            f"no partition rule matched {name!r} — add a rule (or a catch-all) to the table")

    return named_tree_map(match, tree)


def state_partition_spec(state: Any) -> Any:
    """The updater-state spec tree: array leaves row-sharded over the
    server key ranges, scalars replicated."""
    return match_partition_rules(((r".*", TABLE_SPEC),), state)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec resolved on one rank's mesh: the part of a global array this
    rank holds (``NamedSharding``'s role)."""

    mesh: Mesh
    spec: PartitionSpec

    def local_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's slice of each dim of a global ``shape``: a dim
        sharded over an axis is cut into that axis's equal blocks, the
        rank's coordinate picking one."""
        out = []
        for dim, size in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if size % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {n} "
                                 f"shards of {axis!r}")
            i = self.mesh.coords[AXES.index(axis)]
            out.append(slice(i * (size // n), (i + 1) * (size // n)))
        return tuple(out)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(len(range(*s.indices(n))) for s, n in zip(self.local_slices(shape), shape))


class Partitioner(abc.ABC):
    """Resolve declared specs against one mesh: ``partition`` gives the
    spec tree, ``shard`` cuts a host tree to this rank's parts on its
    device, ``gather`` assembles the whole tree back (a collective),
    ``local_data`` is this rank's rows of a global batch."""

    @property
    @abc.abstractmethod
    def mesh(self) -> Mesh: ...

    @abc.abstractmethod
    def partition(self, tree: Any) -> Any:
        """Tree of fitted specs for ``tree``'s leaves."""

    def sharding(self, spec: PartitionSpec) -> Sharding:
        return Sharding(self.mesh, spec)

    def shard(self, tree: Any, specs: Any = None) -> Any:
        specs = self.partition(tree) if specs is None else specs
        flat = {}
        named_tree_map(lambda n, s: flat.__setitem__(n, s), specs,
                       is_leaf=lambda x: isinstance(x, PartitionSpec))

        def put(name, x):
            t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
            return t[self.sharding(flat[name]).local_slices(t.shape)].to(self.mesh.device)

        return named_tree_map(put, tree)

    def gather(self, tree: Any, specs: Any = None) -> Any:
        """The whole tree on the host from every rank's parts (a
        collective over the sharded axes)."""
        specs = self.partition(tree) if specs is None else specs
        flat = {}
        named_tree_map(lambda n, s: flat.__setitem__(n, s), specs,
                       is_leaf=lambda x: isinstance(x, PartitionSpec))

        def get(name, x):
            t = torch.as_tensor(x)
            for dim, axis in enumerate(flat[name]):
                if axis is not None:
                    t = all_gather(t.movedim(dim, 0).contiguous(), axis,
                                   self.mesh).movedim(0, dim)
            return t.cpu().numpy()

        return named_tree_map(get, tree)

    def local_data(self, x: np.ndarray) -> np.ndarray:
        """This rank's rows of a data-axis-sharded global batch."""
        n = self.mesh.shape[DATA_AXIS]
        if n == 1:
            return x
        per = len(x) // n
        d = self.mesh.data_index
        return x[d * per:(d + 1) * per]


class MeshPartitioner(Partitioner):
    """The rule-table partitioner every layer resolves through, one a
    mesh (:func:`for_mesh`); the canonical shardings are resolved once."""

    def __init__(self, mesh: Mesh, rules: Sequence[Tuple[str, PartitionSpec]] = DEFAULT_RULES):
        self._mesh = mesh
        self.rules = tuple(rules)
        self._table = Sharding(mesh, TABLE_SPEC)
        self._batch = Sharding(mesh, BATCH_SPEC)
        self._replicated = Sharding(mesh, REPLICATED_SPEC)

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    def partition(self, tree: Any) -> Any:
        return match_partition_rules(self.rules, tree)

    def table_sharding(self) -> Sharding:
        """[P, k] parameter tables: rows by server key range."""
        return self._table

    def batch_sharding(self) -> Sharding:
        """Example batches: rows over the data (worker) axis."""
        return self._batch

    def replicated(self) -> Sharding:
        return self._replicated

    def state_specs(self, state: Any) -> Any:
        return state_partition_spec(state)

    def layer_sharding(self, shape, partition_thr: int) -> Sharding:
        """KVLayer's placement rule: layers of ``partition_thr``+ elements
        shard their first server-divisible dim; small layers replicate
        (ref kv_layer.h partition_thr)."""
        size = int(np.prod(shape)) if len(shape) else 1
        n_server = self._mesh.shape[SERVER_AXIS]
        if size >= partition_thr:
            for dim, d in enumerate(shape):
                if d % n_server == 0:
                    spec = [None] * len(shape)
                    spec[dim] = SERVER_AXIS
                    return Sharding(self._mesh, P(*spec))
        return self._replicated


_partitioners: Dict[int, MeshPartitioner] = {}  # guarded-by: _partitioners_lock
_partitioners_lock = threading.Lock()


def for_mesh(mesh: Mesh) -> MeshPartitioner:
    """The (cached) partitioner of a mesh: its specs resolve once and
    every layer shares the instance."""
    with _partitioners_lock:
        p = _partitioners.get(id(mesh))
        if p is None or p.mesh is not mesh:
            p = _partitioners[id(mesh)] = MeshPartitioner(mesh)
        return p


# -- heat-driven repartitioning --


@dataclasses.dataclass
class RebalancePlan:
    """A slot permutation recomputed from measured load.

    ``perm`` is a bijection over the table's padded slot capacity in
    CURRENT-layout slot ids: row ``j`` moves to ``perm[j]``. ``moves``
    lists the hot slots relocated (slot, est weight, from → to shard);
    the matching cold slots travel the other way (a swap keeps every
    shard's row count static: shapes never change, only ownership).
    """

    perm: np.ndarray
    moves: List[Dict[str, Any]]
    imbalance_before: Optional[float]
    predicted_imbalance: Optional[float]

    @property
    def rows_moved(self) -> int:
        return int(np.count_nonzero(self.perm != np.arange(len(self.perm))))


def plan_rebalance(heat, num_slots: int, num_shards: int,
                   max_moves: int = 64) -> Optional[RebalancePlan]:
    """Recompute slot ownership from the measured hot-slot / load-share
    tables (``telemetry/learning.py::KeyHeat``).

    Greedy, deterministic: hottest slots first, each moved from its
    (over-mean) shard to the currently least-loaded shard by swapping
    with a cold slot there. Counts are adjusted per move so later moves
    see the earlier ones; the predicted imbalance is disclosed in the
    plan and metered as ``ps_partition_post_imbalance`` until real
    post-rebalance traffic replaces it.
    """
    if num_shards < 2:
        return None
    shares = heat.shares()
    imbalance = shares.get("imbalance")
    total = float(shares.get("total_weight") or 0.0)
    if imbalance is None or total <= 0:
        return None
    counts = np.asarray(shares["shares"], np.float64) * total
    hot = heat.top_slots()
    if not hot:
        return None
    per = num_slots // num_shards
    hot_set = {h["slot"] for h in hot}
    used_cold: set = set()
    perm = np.arange(num_slots, dtype=np.int64)
    moves: List[Dict[str, Any]] = []

    def cold_slot(shard: int) -> Optional[int]:
        # deterministic: scan the shard's range from the top, where
        # padding rows and never-hot slots live
        for s in range(per * (shard + 1) - 1, per * shard - 1, -1):
            if s not in hot_set and s not in used_cold:
                return s
        return None

    for h in sorted(hot, key=lambda d: -d["est"]):
        if len(moves) >= max_moves:
            break
        src = int(h["shard"])
        if counts[src] <= counts.mean():
            continue  # its shard is not the problem
        dst = int(np.argmin(counts))
        if dst == src:
            continue
        cold = cold_slot(dst)
        if cold is None:
            continue
        slot = int(h["slot"])
        used_cold.add(cold)
        used_cold.add(slot)  # a slot moves at most once a plan
        perm[slot], perm[cold] = perm[cold], perm[slot]
        w = float(h["est"])
        counts[src] -= w
        counts[dst] += w
        moves.append({"slot": slot, "est": w, "from_shard": src, "to_shard": dst,
                      "cold_slot": cold})
    if not moves:
        return None
    predicted = float(counts.max() / counts.mean()) if counts.mean() > 0 else None
    return RebalancePlan(perm=perm, moves=moves, imbalance_before=float(imbalance),
                         predicted_imbalance=predicted)


def _rule_threshold(default: float = 4.0) -> float:
    """The shipped ``shard_imbalance`` rule's threshold: the controller
    triggers at the level the alert pages at."""
    try:
        from ..telemetry import alerts as alerts_mod

        for rule in alerts_mod.default_rules():
            if rule.name == "shard_imbalance":
                return float(rule.threshold)
    except Exception:  # noqa: BLE001 — no rules file: the documented default
        pass
    return default


def _row_plan(plan: Optional[RebalancePlan], mesh: Optional[Mesh]) -> Optional[RebalancePlan]:
    """The plan of server shard 0 of this rank's data row, on every rank
    of the row (a broadcast over the mesh's side server group of its
    moves, from which each rank rebuilds the permutation: the swaps are
    all a plan's ``perm`` holds); ``plan`` itself off a mesh or with one
    server shard."""
    if mesh is None or mesh.shape[SERVER_AXIS] == 1:
        return plan
    import torch.distributed as dist

    box = [None if plan is None else (len(plan.perm), plan.moves, plan.imbalance_before,
                                      plan.predicted_imbalance)]
    dist.broadcast_object_list(box, src=mesh.global_rank(mesh.data_index, 0),
                               group=mesh.side.group(SERVER_AXIS))
    if box[0] is None:
        return None
    n, moves, before, predicted = box[0]
    perm = np.arange(n, dtype=np.int64)
    for m in moves:
        perm[m["slot"]], perm[m["cold_slot"]] = perm[m["cold_slot"]], perm[m["slot"]]
    return RebalancePlan(perm=perm, moves=moves, imbalance_before=before,
                         predicted_imbalance=predicted)


class RebalanceController:
    """Heat-driven live repartitioning: ``shard_imbalance`` firing →
    :func:`plan_rebalance` over the measured tables → one online
    ``KVVector.migrate`` through the consistent-snapshot, barrier and
    replay machinery: serving degrades (never errors) during the move,
    and the post-migration table is bit-identical to an undisturbed run
    (``tests/test_torch_rebalance.py`` pins both).

    Thread-safety: ``execute`` may be called from the alert manager's
    evaluation thread (via :meth:`attach`) and from drills or operators
    concurrently; one lock serializes rebalances and guards the
    history. On a mesh of several server shards ``execute`` is a
    collective of the store's data row (the module's docstring): the
    row decides on its server shard 0's reading and plan.
    """

    def __init__(self, store, heat, channel: int = 0, threshold: Optional[float] = None,
                 max_moves: int = 64):
        self.store = store
        self.heat = heat
        self.channel = int(channel)
        self.threshold = _rule_threshold() if threshold is None else float(threshold)
        self.max_moves = int(max_moves)
        self._history: List[dict] = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def _tel(self):
        from ..telemetry.instruments import cached_partition_instruments

        return cached_partition_instruments()

    def should_rebalance(self) -> bool:
        imb = self.heat.shares().get("imbalance")
        return imb is not None and imb > self.threshold

    def plan(self) -> Optional[RebalancePlan]:
        return plan_rebalance(self.heat, self.store.num_slots, self.heat.num_shards,
                              max_moves=self.max_moves)

    def execute(self, force: bool = False) -> Optional[dict]:
        """Plan and migrate once, if over threshold (or ``force``).
        Returns the rebalance record (also kept on :meth:`history`), or
        None when balance is already acceptable or no plan helps."""
        with self._lock:
            imb = self.heat.shares().get("imbalance")
            plan = None
            if force or (imb is not None and imb > self.threshold):
                plan = self.plan()
            plan = _row_plan(plan, getattr(self.store, "mesh", None))
            if plan is None or plan.rows_moved == 0:
                return None
            t0 = time.perf_counter()
            mig = self.store.migrate(plan.perm, ch=self.channel)
            dt = time.perf_counter() - t0
            # a fresh measurement window: the old window's shard counts
            # describe the OLD layout, so the post-rebalance imbalance is
            # measured again, not inherited (hot-slot ids translate)
            self.heat.rebase(plan.perm)
            tel = self._tel()
            if tel is not None:
                tel["rebalances"].inc()
                tel["rows_moved"].inc(plan.rows_moved)
                tel["migration_seconds"].observe(dt)
                if plan.predicted_imbalance is not None:
                    tel["post_imbalance"].set(plan.predicted_imbalance)
            record = {
                "rows_moved": plan.rows_moved,
                "moves": len(plan.moves),
                "migration_seconds": round(dt, 4),
                "imbalance_before": plan.imbalance_before,
                "predicted_imbalance": plan.predicted_imbalance,
                "barrier_ts": mig.get("barrier_ts"),
                "install_ts": mig.get("install_ts"),
                "replayed_pushes": mig.get("replayed"),
                "journaled_pushes": mig.get("journaled"),
                "attempts": mig.get("attempts"),
            }
            self._history.append(record)
            return record

    def refresh_post_imbalance(self) -> Optional[float]:
        """Read the re-measured (post-rebase) imbalance and publish it as
        ``ps_partition_post_imbalance``: the drill calls this after
        post-rebalance traffic has flowed."""
        imb = self.heat.shares().get("imbalance")
        tel = self._tel()
        if imb is not None and tel is not None:
            tel["post_imbalance"].set(imb)
        return imb

    def history(self) -> List[dict]:
        with self._lock:
            return list(self._history)

    def attach(self, alerts, rule: str = "shard_imbalance") -> Callable:
        """Wire the controller to an ``AlertManager``: the ``rule``'s
        transition INTO firing executes one rebalance on the evaluation
        thread (rebalances serialize on the controller lock; a failed
        migrate logs and leaves the alert to fire again)."""

        def on_event(event) -> None:
            if event.rule != rule or event.to != "firing":
                return
            try:
                self.execute()
            except Exception:  # noqa: BLE001 — the alert plane must not see it
                _LOG.exception("alert-triggered rebalance failed; table layout unchanged: the "
                               "%s alert will keep firing", rule)

        alerts.add_listener(on_event)
        return on_event
