"""KVMap: a key-value store with user-defined entry updaters, on one card.

Counterpart of ``parameter_server_tpu/parameter/kv_map.py`` (the
reference's ``src/parameter/kv_map.h``). An entry is a vectorized
functional updater over struct-of-arrays state:

    state' = entry.update(state, agg_grads, touched)
    values = entry.get(state)

A push adds the request's rows into a ``[S, k]`` gradient in entry order
(duplicate keys summed; ``ops/kv_ops.py::scatter_sum``, the
``segment_sum`` kernel on the card, one launch a push), marks the slots
it touched, and applies the entry's update there only. ``AddEntry``
adds the rows straight into its value, in entry order
(``scatter_add_in_order``, also one launch), which is the order XLA
gives the JAX store's ``value + grad``. A pull gathers
``entry.get(state)`` at the keys' slots (zero for an unknown key of an
exact directory). Pushes and pulls are steps of the store's executor, in
timestamp order.

**Over a mesh** (``KVMap(..., mesh=...)``, or the started postoffice's
mesh; ``parallel/mesh.py``): each rank holds its server shard's rows,
``num_slots / S`` of them, as the JAX store's ``shard_map`` body does. A
push localizes the keys into the rank's shard and applies the entry
there only (the keys and values are replicated: every data rank applies
the same push, so the data rows hold the same shards); a pull gathers
the owned rows and sums them over the server axis
(``kv_ops.pull(..., batch_sharded=False)``). Every rank of the mesh
makes the same pushes and pulls with the same keys, in the same order.
``get_replica``, ``set_replica`` and ``write_to_file`` take and give the
whole table, gathered over the server axis on the caller's thread (the
mesh's side groups).

The directory rule is the JAX store's: a hashed directory hashes with
the CONFIGURED slot count (keys keep their slots when the table is
padded), an exact one maps into the PADDED capacity, so its miss
sentinel lies past the table and an unknown key is dropped.
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol

import numpy as np
import torch

from ..device import resolve
from ..ops import kv_ops
from ..parallel import mesh as meshlib
from ..ops.kv_ops import localize, scatter_add_in_order, scatter_sum
from ..system.message import Task
from ..utils import file as psfile
from .parameter import KeyDirectory, Parameter, pad_slots


class Entry(Protocol):
    """Vectorized entry semantics (ref kv_map.h KVMapEntry)."""

    def init(self, num_slots: int, k: int, device) -> Dict[str, torch.Tensor]: ...

    def update(self, state: dict, grad: torch.Tensor, touched: torch.Tensor) -> dict: ...

    def get(self, state: dict) -> torch.Tensor: ...


class AssignEntry:
    """Plain value store: a push overwrites (duplicates summed first), a
    pull reads."""

    def init(self, num_slots, k, device):
        return {"value": torch.zeros((num_slots, k), device=device)}

    def update(self, state, grad, touched):
        return {"value": torch.where(touched[:, None], grad, state["value"])}

    def get(self, state):
        return state["value"]


class AddEntry:
    """Accumulator: a push adds (the reference's aggregation server).

    ``push_rows`` adds each entry into the value in entry order,
    ``(t + a) + b``: XLA folds the JAX entry's ``value + grad`` into the
    gradient's scatter, so that is the order the JAX store adds in."""

    def init(self, num_slots, k, device):
        return {"value": torch.zeros((num_slots, k), device=device)}

    def update(self, state, grad, touched):
        return {"value": state["value"] + grad}

    def push_rows(self, state, rel, vals):
        value = state["value"].clone()
        scatter_add_in_order(value, rel, vals)
        return {"value": value}

    def get(self, state):
        return state["value"]


def touched_slots(rel: torch.Tensor, ok: torch.Tensor, num_slots: int) -> torch.Tensor:
    """``zeros(bool).at[rel].max(ok)``: every write is True, so no order
    of the writes changes it (foreign ids write a spare slot past the
    end, dropped)."""
    mark = torch.zeros(num_slots + 1, dtype=torch.bool, device=rel.device)
    mark[torch.where(ok, rel, num_slots)] = True
    return mark[:num_slots]


def make_push(entry: Entry, num_slots: int, mesh=None):
    """``push(state, slots, vals [n, k]) -> state'``: the aggregated
    gradient, the touched mask, the entry's update where touched. An
    entry with ``push_rows(state, rel, vals)`` takes the rows itself.
    ``mesh``: ``num_slots`` is this rank's shard, and the ids are
    localized into its key range."""

    def push(state, slots, vals):
        rel, ok = localize(slots, num_slots, mesh)
        vals = torch.where(ok[:, None], vals, 0.0)
        touched = touched_slots(rel, ok, num_slots)
        if hasattr(entry, "push_rows"):
            new = entry.push_rows(state, rel, vals)
        else:
            new = entry.update(state, scatter_sum(num_slots, rel, vals), touched)
        return {name: torch.where(touched.reshape((-1,) + (1,) * (leaf.dim() - 1)), leaf,
                                  state[name])
                for name, leaf in new.items()}

    return push


class KVMap(Parameter):
    """``KVMap(entry, k, num_slots, hashed, keys)`` on ``device`` (the
    started postoffice's, else the card; raises without one), or over
    ``mesh`` (default: the started postoffice's), one server shard a rank.
    ``num_server``, if given, must be the mesh's server count."""

    def __init__(self, entry: Entry, k: int = 1, num_slots: int = 1 << 20, hashed: bool = True,
                 keys: Optional[np.ndarray] = None, id: Optional[int] = None, name: str = "",
                 device=None, num_server: Optional[int] = None, mesh=None):
        super().__init__(id=id, name=name)
        if mesh is None and self.po.started:
            mesh = self.po.mesh
        if mesh is not None and mesh.size == 1:
            mesh = None  # one card: every collective is the identity
        n_server = 1 if mesh is None else meshlib.num_servers(mesh)
        if num_server is not None and num_server != n_server:
            raise ValueError(
                f"KVMap over {num_server} server shards needs a mesh with that many "
                f"(got {mesh!r}): start the postoffice on one, or pass mesh=")
        #: the mesh the table is sharded over (None: one card, the whole table)
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        elif device is None and self.po.started:
            device = self.po.device
        self.device = resolve(device)
        self.k = int(k)
        self.entry = entry
        self.num_slots = pad_slots(num_slots, n_server)
        #: this rank's rows of the table: its server shard
        self.shard_rows = self.num_slots // n_server
        is_hashed = keys is None and hashed
        self.directory = KeyDirectory(int(num_slots) if is_hashed else self.num_slots,
                                      keys=keys, hashed=is_hashed)
        self.state: Dict[str, torch.Tensor] = entry.init(self.shard_rows, self.k, self.device)
        self._push_fn = make_push(entry, self.shard_rows, mesh)

    def slots(self, keys: np.ndarray) -> torch.Tensor:
        """The keys' slot ids on the card (cached per key set)."""
        return self.directory.slots_device(keys, self.device)

    def push(self, task: Task, keys, values, callback=None) -> int:
        """Async push of ``values`` ([n, k], or flat) at ``keys``; returns
        the timestamp."""
        slots = self.slots(keys)
        vals = torch.as_tensor(np.asarray(values, np.float32)).reshape(-1, self.k).to(self.device)

        def step():
            from ..telemetry.instruments import cached_kvops_instruments

            tel = cached_kvops_instruments()
            if tel is not None:
                tel["donated_pushes"].inc()
            self.state = self._push_fn(self.state, slots, vals)
            return self.state

        return self.instrumented_submit("push", task.key_channel, len(slots), step, task,
                                        callback)

    def pull(self, task: Task, keys, callback=None) -> int:
        """Async pull of ``entry.get(state)`` at ``keys``; the result via
        :meth:`wait_pull`."""
        slots = self.slots(keys)

        def step():
            return kv_ops.pull(self.entry.get(self.state), slots, mesh=self.mesh,
                               batch_sharded=False)

        return self.instrumented_submit("pull", task.key_channel, len(slots), step, task,
                                        callback)

    def wait_pull(self, ts: int) -> torch.Tensor:
        return self.executor.wait(ts)

    def values(self, keys: np.ndarray) -> np.ndarray:
        """The current values at ``keys`` on the host (a pull, waited)."""
        return self.wait_pull(self.pull(self.request(), keys)).cpu().numpy()

    def _whole(self) -> Dict[str, torch.Tensor]:
        """The entry state's leaves, whole: on a mesh gathered over the
        server axis (the side groups: a collective of the data row), once
        the steps in flight are done."""
        self.executor.wait_all(pop=False)
        if self.mesh is None or meshlib.num_servers(self.mesh) == 1:
            return self.state
        side = self.mesh.side
        return {name: meshlib.all_gather(leaf, meshlib.SERVER_AXIS, side)
                for name, leaf in self.state.items()}

    def write_to_file(self, path: str) -> None:
        """Nonzero values as text, ``key\\tv_1\\t...\\tv_k`` (ref
        KVMap::WriteToFile), once the steps in flight are done. On a mesh
        every rank calls it: the shards are gathered and rank 0 writes."""
        state = self._whole()
        if self.mesh is not None and self.mesh.rank != 0:
            return
        vals = self.entry.get(state).cpu().numpy()
        keys = (self.directory.keys if self.directory.keys is not None
                else np.arange(self.num_slots))
        vals = vals[: len(keys)]
        nz = np.any(vals != 0, axis=1)
        with psfile.open_write(path) as f:
            for key, val in zip(np.asarray(keys)[nz], vals[nz]):
                f.write(f"{key}\t" + "\t".join(repr(float(x)) for x in val) + "\n")

    def get_replica(self) -> dict:
        """Host copies of the whole entry state once the steps in flight
        are done (on a mesh every rank calls it and gets the whole)."""
        return {name: leaf.cpu().numpy().copy() for name, leaf in self._whole().items()}

    def set_replica(self, snapshot: dict) -> None:
        """Install whole entry state (host arrays or tensors) as copies; on
        a mesh each rank takes its server shard's rows."""
        lo = 0 if self.mesh is None else self.mesh.server_index * self.shard_rows
        self.state = {name: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                                            else v)[lo:lo + self.shard_rows].to(self.device)
                      .clone()
                      for name, v in snapshot.items()}
