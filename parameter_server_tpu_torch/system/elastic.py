"""Live elasticity: node join and leave with key-range migration.

Counterpart of ``parameter_server_tpu/system/elastic.py`` (the
reference's live cluster membership, ``src/system/manager.cc``: AddNode
assigns the new server a key range and broadcasts the node set; the
dead-node flow re-assigns a dead node's work). A "node" is a position of
the ``(data, server)`` mesh, one rank a position (``parallel/mesh.py``),
so a membership change re-factors the mesh inside one world:

- **join / leave (graceful)**: snapshot the whole table to host memory
  (no files), tear the executor and the postoffice down, start the
  postoffice on the new ``data x server`` shape over a prefix of the same
  world (``Postoffice.start`` → ``make_mesh``, which every rank of the
  world enters, the idle ones too), build the worker on the new mesh and
  install the snapshot there. Key-to-slot hashing uses the CONFIGURED
  modulus, so every key keeps its slot while the per-server key ranges
  move: the reference's fixed key space with moving server ranges
  (``Range::EvenDivide``).
- **server death (crash)**: first the in-place live replica
  (``recover_server_shard``, ref Parameter::GetReplica); without one the
  dead shard's segment is lost (as in the reference) and the cluster
  shrinks around it.

**Every rank of the world runs the coordinator**, with the same calls in
the same order: a rank the mesh leaves idle holds no worker
(:attr:`ElasticCoordinator.worker` is None there), follows each resize,
and takes a role back when a resize grows the mesh over it. A shape that
needs more ranks than the world has raises ``ValueError``
(``mesh_shape``'s rule); no resize falls back to fewer ranks.

**State transfer** (gathered in the coordinator): the worker's
``state_host`` gives a rank its server shard; the ranks of data row 0
send theirs to rank 0 (``gather_object``), which joins them
(``convert.unshard_state``) and broadcasts the whole state to every rank
(``broadcast_object_list``: an idle rank that joins the new mesh needs it
too); each rank of the new mesh fits it to the new padding and installs
its shard (``convert.shard_state``). The install is the gathered bytes,
so the state after a resize is bit-equal to the state before it.

**With a live serving frontend** (:meth:`ElasticCoordinator.serve_in`,
every rank, with the order the frontend serves through): a resize asked for on rank 0
takes its place in the frontend's order (``parallel/sequence.py``), so
every rank enters it after the last call served before it (the state
gather is itself a collective of the world), the idle ranks too; each
rank then serves its new worker's store from the same point of the
order, and rank 0 rebinds its frontend to its own.

The Manager records every membership change and broadcasts add/remove
events to subscribers (ref manager.cc NodeChange), the same events the
JAX coordinator emits.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch.distributed as dist

from ..utils.range import Range
from .postoffice import Postoffice


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _from_rank0(value):
    """``value`` as rank 0 of the world holds it, on every rank."""
    if _world() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _fit_rows(leaf: np.ndarray, rows: int) -> np.ndarray:
    """A whole-table leaf trimmed or zero-extended to ``rows`` (only dead
    padding changes: the configured slots always carry over)."""
    leaf = np.asarray(leaf)
    if leaf.ndim < 1 or leaf.shape[0] == rows:
        return leaf
    if leaf.shape[0] > rows:
        return leaf[:rows]
    pad = np.zeros((rows - leaf.shape[0],) + leaf.shape[1:], leaf.dtype)
    return np.concatenate([leaf, pad])


def whole_state(worker, mesh) -> Optional[dict]:
    """The whole ``state_host`` snapshot of a (possibly sharded) worker,
    on every rank of the world (a collective of the world; ``worker`` is
    None on an idle rank). Data row 0's shards go to rank 0, which joins
    them and broadcasts the result."""
    from ..convert import unshard_state

    if _world() == 1:
        return None if worker is None else worker.state_host()
    mine = None
    if worker is not None and mesh is not None and mesh.active and mesh.data_index == 0:
        snap = worker.state_host()
        mine = (mesh.server_index, snap["state"], int(snap["seed_counter"]))
    parts = [None] * _world() if dist.get_rank() == 0 else None
    dist.gather_object(mine, parts, dst=0)
    whole = None
    if dist.get_rank() == 0:
        shards = sorted(p for p in parts if p is not None)
        if shards:
            whole = {"state": unshard_state([st for _, st, _ in shards]),
                     "seed_counter": np.int64(shards[0][2])}
    return _from_rank0(whole)


def install_whole(worker, mesh, snap: dict) -> None:
    """Install a whole ``state_host`` snapshot into ``worker``: the rank's
    server shard of it, fitted to the worker's padding."""
    from ..convert import shard_state, state_to_numpy

    n_server = 1 if mesh is None else mesh.shape["server"]
    index = 0 if mesh is None or mesh.size == 1 else mesh.server_index
    whole = {k: _fit_rows(v, worker.num_slots) for k, v in snap["state"].items()}
    shard = shard_state(whole, n_server, index, "cpu")
    worker.load_state_host({"state": state_to_numpy(shard), "seed_counter": snap["seed_counter"]})


class ElasticCoordinator:
    """Owns the Postoffice lifecycle for one elastic app node.

    ``make_worker(mesh) -> worker`` builds the app on a given mesh (called
    on the ranks the mesh holds); the worker must expose
    ``state_host`` / ``load_state_host`` and ``num_slots`` (and
    ``recover_server_shard`` / ``wipe_server_shard`` for crash recovery):
    ``AsyncSGDWorker`` does.
    """

    def __init__(self, make_worker: Callable, num_data: int, num_server: int,
                 key_space: Optional[Range] = None, device=None):
        self.make_worker = make_worker
        self.num_data = num_data
        self.num_server = num_server
        self.key_space = key_space or Range.all()
        self.device = device
        self.worker = None
        self._listeners = []
        # measured stop-the-world pauses, newest last: the old and new
        # mesh shapes and the pause in seconds (reported, not assumed away)
        self.resize_history = []
        self._order = None  # a serving order the resizes take their place in

    # -- lifecycle --

    def _start_po(self, num_data: int, num_server: int) -> Postoffice:
        return Postoffice.instance().start(num_data=num_data, num_server=num_server,
                                           key_space=self.key_space, device=self.device)

    def _build(self, po: Postoffice):
        """The worker on ``po``'s mesh, or None on a rank it leaves idle."""
        return self.make_worker(po.mesh) if po.mesh.active else None

    def start(self):
        po = Postoffice.instance()
        if not po.started:
            po = self._start_po(self.num_data, self.num_server)
        self._resubscribe(po)
        self.worker = self._build(po)
        return self.worker

    def subscribe_nodes(self, cb) -> None:
        """Node add/remove events survive mesh rebuilds (the Manager is
        recreated with the Postoffice; the coordinator re-subscribes)."""
        self._listeners.append(cb)
        po = Postoffice.instance()
        if po.started:
            po.manager.subscribe_nodes(cb)

    def _resubscribe(self, po) -> None:
        for cb in self._listeners:
            po.manager.subscribe_nodes(cb)

    def serve_in(self, order) -> None:
        """Put this coordinator's resizes in a serving ``order`` (a
        ``parallel/sequence.Order`` of the worker's ``kv``; every rank of
        the world calls this): from here on a :meth:`resize` is asked for
        on rank 0 and runs on every rank at its place in the order, after
        which the order serves the new worker's ``kv`` (None on an idle
        rank)."""
        self._order = order

        def run(**kw):
            worker = self._resize(**kw)
            order.rebind(None if worker is None else worker.kv)

        order.handle("elastic.resize", run)

    # -- membership changes (ref manager.cc AddNode / NodeDisconnected) --

    def resize(self, num_data: Optional[int] = None, num_server: Optional[int] = None,
               notify: bool = True):
        """See :meth:`_resize`. Inside a serving order that is still open
        (:meth:`serve_in`) rank 0 asks for it and every rank runs it at
        its place in the order."""
        order = self._order
        if order is not None and order.active and order.group is not None:
            order.call("elastic.resize", num_data=num_data, num_server=num_server,
                       notify=notify)
            return self.worker
        return self._resize(num_data, num_server, notify)

    def _resize(self, num_data: Optional[int] = None, num_server: Optional[int] = None,
                notify: bool = True):
        """Live migration to a new data x server split: no files, no
        training-state loss; key ranges re-divide over the new server set
        while every key keeps its hash slot. Every rank of the world calls
        it. Returns this rank's new worker (None on an idle rank).

        Node ids are mesh SLOTS (positional, "S0..Sn-1"), so the broadcast
        diff reports slot-count changes: growing emits adds for the new
        highest ranks, shrinking emits removes for the dropped ones. A
        crash names its dead node explicitly first and passes
        ``notify=False``: the survivors' renumbering is not a membership
        change."""
        new_data = self.num_data if num_data is None else num_data
        new_server = self.num_server if num_server is None else num_server
        from ..parallel.mesh import mesh_shape

        mesh_shape(_world(), new_data, new_server)  # raises before anything is torn down
        pause_t0 = time.perf_counter()  # stop-the-world begins at the snapshot
        old_po = Postoffice.instance()
        snap = whole_state(self.worker, old_po.mesh)

        old_nodes = list(old_po.manager.nodes)
        # the aux runtime (heartbeat poller, recovery handlers, per-node
        # samplers) survives the resize as the SAME live object: a cluster
        # deaf after its first membership change would never detect the
        # second death. Detach it so old_po.stop() leaves its poller alone.
        live_aux = old_po.aux
        old_po.aux = None
        # the executor's dispatch thread must not outlive the mesh it ran on
        if self.worker is not None:
            self.worker.executor.stop()
        old_po.stop()
        Postoffice.reset()
        po = self._start_po(new_data, new_server)
        if live_aux is not None:
            po.aux = live_aux
            # decommissioned slots must not later be declared dead
            new_ids = {n.id for n in po.manager.nodes}
            for n in old_nodes:
                if n.id not in new_ids:
                    live_aux.forget(n.id)
            # the pause itself is not a death: refresh the survivors'
            # last-seen so a rebuild longer than the heartbeat timeout does
            # not start a spurious death cascade at the next check
            live_aux.collector.touch_all()
        self._resubscribe(po)
        if notify:
            # the membership diff through the fresh manager: the add/remove
            # stream the reference broadcasts on NodeChange
            old_ids = {n.id for n in old_nodes}
            new_ids = {n.id for n in po.manager.nodes}
            for n in old_nodes:
                if n.id not in new_ids:
                    po.manager.broadcast("remove", n)
            for n in po.manager.nodes:
                if n.id not in old_ids:
                    po.manager.broadcast("add", n)

        old_shape = (self.num_data, self.num_server)
        self.num_data, self.num_server = new_data, new_server
        self.worker = self._build(po)
        if snap is not None and self.worker is not None:
            install_whole(self.worker, po.mesh, snap)
        pause_s = time.perf_counter() - pause_t0
        self.resize_history.append({"old": old_shape, "new": (new_data, new_server),
                                    "pause_s": round(pause_s, 3)})
        if po.aux is not None:
            po.aux.dashboard.add_event(
                f"elastic resize {old_shape[0]}x{old_shape[1]} -> {new_data}x{new_server}: "
                f"stop-the-world {pause_s:.2f}s")
        return self.worker

    def add_server(self):
        return self.resize(num_server=self.num_server + 1)

    def remove_server(self):
        assert self.num_server > 1, "cannot remove the last server"
        return self.resize(num_server=self.num_server - 1)

    def add_worker(self):
        return self.resize(num_data=self.num_data + 1)

    def remove_worker(self):
        assert self.num_data > 1, "cannot remove the last worker"
        return self.resize(num_data=self.num_data - 1)

    def attach_recovery(self, rc) -> None:
        """Drive membership from heartbeat timeouts: a RecoveryCoordinator
        server-death event becomes the manager.cc dead-node flow."""
        rc.on_server_dead(lambda nid: self.handle_server_death(int(nid[1:])))

    def handle_server_death(self, rank: int) -> str:
        """Crash path (ref manager.cc dead-node flow): in-place recovery
        from the live neighbour replica when configured; otherwise the
        segment is lost and the cluster shrinks around the dead server.
        Every rank of the world calls it; the outcome is rank 0's (whose
        worker is always on the mesh), so the idle ranks follow it.
        Returns "recovered" or "resharded"."""
        po = Postoffice.instance()
        recovered = self.worker is not None and self.worker.recover_server_shard(rank)
        if _from_rank0(bool(recovered)):
            # restored in place from the live replica: membership is
            # unchanged (same slot, same range), no event
            return "recovered"
        if self.worker is not None:
            # the shard is gone for real: drop its segment before the
            # survivors re-divide the key space
            self.worker.wipe_server_shard(rank)
        # the DEAD node's identity event; the survivors' positional
        # renumbering inside resize is suppressed (notify=False). Forget it
        # in the aux runtime explicitly: remove_node runs before resize
        # snapshots the node list, so resize's sweep would not see it, and
        # a replacement reusing the slot id could have its own death masked
        if po.aux is not None:
            po.aux.forget(f"S{rank}")
        po.manager.remove_node(f"S{rank}")
        new_server = max(1, self.num_server - 1)
        rebuilt = new_server == self.num_server  # the last server: its slot is reborn
        self._resize(num_server=new_server, notify=False)  # every rank is here already
        if rebuilt:
            # a 1-server cluster cannot shrink: the slot is rebuilt (empty),
            # and subscribers must see the replacement join or their view
            # of the membership ends at zero servers
            po2 = Postoffice.instance()
            for n in po2.manager.nodes:
                if n.id == f"S{rank}":
                    po2.manager.broadcast("add", n)
        return "resharded"
