"""Declarative partitioning: regex rules → partition specs, resolved once.

Counterpart of the layout half of
``parameter_server_tpu/parallel/partition.py``: the canonical specs of
the mesh (tables by server key range, batches over the data axis,
scalars replicated), a rule table mapping tree paths to specs, and one
:class:`MeshPartitioner` a mesh. ``jax.sharding.PartitionSpec`` becomes
:class:`PartitionSpec`, a tuple of axis names (or None) a dim, and a
``NamedSharding`` becomes :class:`Sharding`, which says which rows of a
global array this rank holds.

Heat-driven repartitioning (``RebalancePlan``, ``plan_rebalance``,
``RebalanceController``) is ROADMAP A9 slice 2.
"""

from __future__ import annotations

import abc
import dataclasses
import re
import threading
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .mesh import AXES, DATA_AXIS, SERVER_AXIS, Mesh, all_gather


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
