"""The ps.h-style interface for writing parameter-server programs.

Counterpart of ``parameter_server_tpu/ps.py`` (the reference's
``src/ps.h``): a program queries its node's identity (``my_node_id``,
``is_worker``, ``my_rank``, ...), builds apps and boots or stops the
system. ``run_system`` plays ``script/local.sh`` + ``RunSystem``: it
starts the postoffice, calls the program's app factory once a node
(scheduler, servers, workers, with the role helpers answering for that
node), runs each worker app's ``run()`` on a thread of its own, then the
other apps' ``run()``. A per-thread current node makes the role helpers
answer inside each app body.

``submit`` is the reference's ``Submit(task, NodeID)``: a request to
every app of a group (a :class:`NodeGroups` id or a node id), crossing
``van.transfer`` between the sender's endpoint for the receiver and the
receiver's endpoint for the sender (each app's
:class:`~.system.remote_node.RemoteNodeTable`, so the filters of the
task's spec run on every request and its reply), the receiver's
``process_request`` run under the request's trace context, and a reply
(the receiver's own, or the system's acknowledgement) crossing back.

``start_system`` passes its counts to ``Postoffice.start``, which builds
this rank's ``(data, server)`` mesh (one process a mesh position, in a
world a launcher starts; one process alone is the ``1 x 1`` mesh of its
card) and the node table H0, S0.., W0... ``run_system`` hosts every node
of the table in each process, as the JAX package hosts them in its one
process over its device mesh:

- in a world a launcher started (``PS_COORDINATOR_ADDRESS`` et al.), of
  ``num_workers x num_servers`` ranks, each rank builds that mesh and
  hosts every node; a ``KVVector`` a server app builds is sharded over
  its server axis, and every rank runs every app, so each data row holds
  a replica of the store. The worker apps' threads submit to a store in
  one order that every rank shares (``parallel/turns.py``: their pushes
  and pulls take turns round robin, W0, W1, ...), each pull agrees the
  order so far over the server axis before its collective, and the run
  ends agreeing every store's order over the mesh: a disagreement raises
  on every rank;
- in one process, with no world, the nodes share its card (a ``1 x 1``
  mesh under the node table of ``num_servers`` servers and
  ``num_workers`` workers).

``device`` picks the card as every entry point does (the CUDA device
unless the caller names another).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Callable, List, Optional

from .system.customer import App
from .system.executor import NodeGroups
from .system.manager import Node
from .system.message import Message, Task
from .system.postoffice import Postoffice
from .telemetry import spans as telemetry_spans
from .utils.range import Range

__all__ = [
    "App",
    "NodeGroups",
    "start_system",
    "stop_system",
    "run_system",
    "submit",
    "my_app",
    "my_node",
    "my_node_id",
    "is_worker",
    "is_server",
    "is_scheduler",
    "my_key_range",
    "scheduler_id",
    "next_customer_id",
    "my_rank",
    "rank_size",
    "wait_servers_ready",
    "wait_workers_ready",
]

_tls = threading.local()


def _current_node() -> Node:
    node = getattr(_tls, "node", None)
    if node is None:
        # outside run_system the driving process acts as the scheduler,
        # as the reference's root process is node "H"
        nodes = Postoffice.instance().manager.nodes
        return nodes[0] if nodes else Node(Node.SCHEDULER, 0)
    return node


def _set_current_node(node: Optional[Node]) -> None:
    _tls.node = node


# -- the system's lifecycle (ref ps.h StartSystem/StopSystem/RunSystem) --


def start_system(num_workers: Optional[int] = None, num_servers: int = 1,
                 key_space: Optional[Range] = None, device=None) -> Postoffice:
    """Boot the postoffice: join the world (if a launcher named one), build
    this rank's mesh, pick its card and build the node table."""
    return Postoffice.instance().start(num_data=num_workers, num_server=num_servers,
                                       key_space=key_space, device=device)


def stop_system() -> None:
    _app_registry.clear()
    Postoffice.instance().stop()
    Postoffice.reset()


# the apps run_system made, for group routing (ref the manager's customer
# registry keyed by (node, customer id); one process hosts every node)
_app_registry: List[App] = []

# the RPC counter, resolved again after a Postoffice.reset swaps the
# default registry
_rpc_counter = None
_rpc_registry = None


def _count_rpc() -> None:
    global _rpc_counter, _rpc_registry
    from .telemetry import registry as telemetry_registry

    if not telemetry_registry.enabled():
        return
    reg = telemetry_registry.default_registry()
    if reg is not _rpc_registry:
        from .telemetry.instruments import app_instruments

        _rpc_counter = app_instruments(reg)["rpcs"]
        _rpc_registry = reg
    _rpc_counter.inc()


_GROUP_ROLES = {
    NodeGroups.SERVER_GROUP: {Node.SERVER},
    NodeGroups.WORKER_GROUP: {Node.WORKER},
    NodeGroups.COMP_GROUP: {Node.SERVER, Node.WORKER},
    NodeGroups.LIVE_GROUP: {Node.SCHEDULER, Node.SERVER, Node.WORKER},
}


def _group_apps(recver: str) -> List[App]:
    roles = _GROUP_ROLES.get(recver)
    out = []
    for a in _app_registry:
        node = getattr(a, "node", None)
        if node is None:
            continue
        if (roles is not None and node.role in roles) or node.id == recver:
            out.append(a)
    return out


def submit(app: App, task: Optional[Task] = None, recver: str = NodeGroups.SERVER_GROUP,
           callback: Optional[Callable[[], None]] = None) -> int:
    """Deliver a request carrying ``task`` to every app of ``recver`` (a
    NodeGroups id or a node id such as "S0"): each receiver's
    ``process_request`` runs, and a receiver that does not reply is
    acknowledged by the system (ref executor.cc). Returns the timestamp
    to ``app.wait`` on; ``callback`` runs once the last reply has landed.
    Delivery runs on the sender's executor thread: wait on the timestamp
    before relying on its effects."""
    task = dataclasses.replace(task) if task is not None else Task()
    if task.time < 0:
        task.time = app.executor.time()
    # the sender's identity, taken on the calling thread (the step runs
    # on the executor's dispatch thread)
    me = _current_node()
    _count_rpc()

    def step() -> None:
        _set_current_node(me)
        # a group includes the sender's node when its role matches (ref
        # executor.cc AddNode), so a broadcast reaches the sender too
        for target in _group_apps(recver):
            # a fresh copy a target: each encode chain writes the specs'
            # extra dicts (compression meta, key signatures)
            req = Message(task=task.fresh_copy(), sender=app.name, recver=target.node.id)
            # the wire path even to itself: the sender's endpoint for the
            # target encodes and frames, the target's endpoint for the
            # sender decodes (ref remote_node.cc, van.cc)
            req = app.po.van.transfer(app.remote_nodes.get(target.node.id),
                                      target.remote_nodes.get(app.name), req)
            # the request's trace context, active again on the receiving
            # side: one RPC is one flow across the van
            with telemetry_spans.activate_trace(getattr(req.task, "trace", None)):
                # a node's receive path is serialized (the reference runs
                # one executor thread a customer)
                with target._ps_recv_lock:
                    _set_current_node(target.node)
                    try:
                        target.process_request(req)
                    finally:
                        _set_current_node(me)
                # the acknowledgement reaches the sender under its own
                # identity
                if not getattr(req, "replied", False):
                    target.reply(req)
            # a received message counts as the node's heartbeat
            target.po.beat(target.node.id)
        if callback is not None:
            callback()

    return app.submit(step, task=task)


def _start_nodes(num_workers: Optional[int], num_servers: int, key_space: Optional[Range],
                 device) -> Postoffice:
    """Start the system whose every node this process hosts: on a mesh of
    ``num_workers x num_servers`` ranks in a launcher's world, else on
    this process's card under a node table of that many nodes."""
    from .parallel import distributed

    if distributed.initialize():
        po = start_system(num_workers, num_servers, key_space, device)
        if not po.mesh.active:
            po.stop()
            raise ValueError(
                f"rank {po.mesh.rank} is outside the {po.mesh.shape} mesh of run_system: "
                "start a world of num_workers x num_servers ranks")
        return po
    po = start_system(1, 1, key_space, device)
    po.manager.init_nodes(num_servers=num_servers, num_workers=num_workers or 1,
                          key_space=key_space or Range.all())
    return po


def run_system(create_app: Callable[[], App], num_workers: Optional[int] = None,
               num_servers: int = 1, key_space: Optional[Range] = None,
               device=None) -> List[App]:
    """Run a ps.h-style program end to end (ref RunSystem + local.sh).

    ``create_app`` is called once a node, with ``is_worker()`` /
    ``is_server()`` / ``is_scheduler()`` answering for that node (the
    reference's ``App::Create``); each worker app's ``run()`` then runs on
    its own thread, and after them the other apps' ``run()``. A worker's
    exception fails the program. Returns the apps (scheduler, servers,
    workers). In a launcher's world every rank calls it and hosts every
    node (the module's docstring)."""
    from .parallel import turns as turnslib

    po = _start_nodes(num_workers, num_servers, key_space, device)
    on_mesh = po.mesh.size > 1
    apps: List[App] = []
    order = None
    try:
        for node in po.manager.nodes:
            _set_current_node(node)
            app = create_app()
            app.node = node
            app.name = node.id  # messages name nodes by id (ref van.cc)
            # re-entrant: process_request may submit to a group holding
            # its own node
            app._ps_recv_lock = threading.RLock()
            apps.append(app)
            _app_registry.append(app)
        workers = [a for a in apps if a.node.role == Node.WORKER]
        if on_mesh:
            # the worker threads' store submissions: one order on every rank
            order = turnslib.Turns([a.node.id for a in workers])
            turnslib.activate(order)
        threads = []
        errors: List[BaseException] = []
        errors_lock = threading.Lock()
        for app in workers:

            def body(app: App = app) -> None:
                _set_current_node(app.node)
                try:
                    with (order.member(app.node.id) if order is not None
                          else contextlib.nullcontext()):
                        app.run()
                except BaseException as e:  # noqa: BLE001 — raised below
                    with errors_lock:
                        errors.append(e)

            t = threading.Thread(target=body, name=f"run_{app.node.id}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        for app in apps:
            if app.node.role != Node.WORKER:
                _set_current_node(app.node)
                app.run()
        if order is not None:
            # every store's submissions, and the turns, alike on every rank
            order.check(po.mesh)
    finally:
        if order is not None:
            turnslib.activate(None)
        # drain every app's executor before the registry goes: a broadcast
        # still queued on a dispatch thread delivers first
        unwinding = sys.exc_info()[0] is not None
        drain_errors: List[BaseException] = []
        for app in apps:
            try:
                app.executor.wait_all()
                app.executor.stop()
            except BaseException as e:  # noqa: BLE001 — raised below
                drain_errors.append(e)
        _set_current_node(None)
        stop_system()
        if drain_errors and not unwinding:
            raise drain_errors[0]
    return apps


# -- node identity (ref ps.h MyApp/MyNode/MyNodeID/IsWorker/...) --


def my_app() -> Optional[App]:
    """The app running on the current node (ref ps.h MyApp)."""
    node = getattr(_tls, "node", None)
    if node is not None:
        for a in _app_registry:
            if getattr(a, "node", None) is node:
                return a
    po = Postoffice.instance()
    for c in list(po.manager._customers.values()):
        if isinstance(c, App):
            return c
    return None


def my_node() -> Node:
    return _current_node()


def my_node_id() -> str:
    return _current_node().id


def is_worker() -> bool:
    return _current_node().role == Node.WORKER


def is_server() -> bool:
    return _current_node().role == Node.SERVER


def is_scheduler() -> bool:
    return _current_node().role == Node.SCHEDULER


def my_key_range() -> Range:
    return _current_node().key_range


def scheduler_id() -> str:
    return "H0"


def next_customer_id() -> int:
    return Postoffice.instance().manager.next_customer_id()


def my_rank() -> int:
    return _current_node().rank


def rank_size() -> int:
    """Nodes in my group (ref ps.h RankSize)."""
    role = _current_node().role
    nodes = Postoffice.instance().manager.nodes
    return max(1, sum(1 for n in nodes if n.role == role))


# -- readiness barriers (ref ps.h WaitServersReady/WaitWorkersReady): every
#    node exists once start_system returns, so they check the system is up


def wait_servers_ready() -> None:
    if not Postoffice.instance().started:
        raise RuntimeError("system not started (call start_system first)")


def wait_workers_ready() -> None:
    wait_servers_ready()
