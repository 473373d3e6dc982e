"""PyTorch port: the ps.h-style interface (``parameter_server_tpu_torch.ps``)
against the JAX package's, on the CPU.

The JAX package's ``tests/test_ps_api.py`` cases at the port's node table
of one card (H0, S0, W0): the hello-world round trip, the identity
helpers, the readiness barriers and ``scheduler_id``, the package's
exports, a worker's exception failing the program, a group broadcast
reaching its sender, a re-entrant submit. Beside them:

- the same hello program through both packages' ``run_system`` gives the
  same log of (node, kind, time, sender);
- the van's and the ``RemoteNode``s' wire byte totals agree within each
  package, and across the packages they differ by the frames' headers
  alone: a header pickles its task's module paths, and the port's
  (``parameter_server_tpu_torch.system.message``,
  ``parameter_server_tpu_torch.utils.range``) are each 6 bytes longer;
- a reply carries its task's filter specs through both apps' per-peer
  chains: the keys cross once, then as their signature;
- ``run_system`` with two servers or two workers raises naming A9.
"""

import threading

import numpy as np
import pytest

import parameter_server_tpu as jpst
import parameter_server_tpu_torch as pst
from parameter_server_tpu import ps as jps
from parameter_server_tpu.system import message as jmsg
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch import ps
from parameter_server_tpu_torch.learner.wire import wire_filter_specs
from parameter_server_tpu_torch.system import message as tmsg
from parameter_server_tpu_torch.system.message import Task
from parameter_server_tpu_torch.system.postoffice import Postoffice
from parameter_server_tpu_torch.utils.range import Range


@pytest.fixture(autouse=True)
def _fresh_system():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    ps.stop_system()
    jps.stop_system()


def hello_program(ps_mod, task_cls):
    """The hello_ps.cc program of ``tests/test_ps_api.py`` for one
    package: returns (create_app, log)."""
    log = []
    log_lock = threading.Lock()

    def record(line):
        with log_lock:
            log.append(line)

    class Server(ps_mod.App):
        def process_request(self, req):
            record((ps_mod.my_node_id(), "req", req.task.time, req.sender))

    class Worker(ps_mod.App):
        def process_response(self, res):
            record((ps_mod.my_node_id(), "res", res.task.time, res.sender))

        def run(self):
            self.wait(ps_mod.submit(self, task_cls(), ps_mod.NodeGroups.SERVER_GROUP))
            self.wait(ps_mod.submit(self, task_cls(), ps_mod.NodeGroups.SERVER_GROUP))
            done = threading.Event()

            def on_done():
                assert self.last_response() is not None
                record((ps_mod.my_node_id(), "cb", self.last_response().task.time))
                done.set()

            self.wait(ps_mod.submit(self, task_cls(), callback=on_done))
            assert done.is_set()

    def create_app():
        if ps_mod.is_worker():
            return Worker()
        if ps_mod.is_server():
            return Server()
        return ps_mod.App()

    return create_app, log


def wire_totals(apps):
    van = apps[0].po.van
    sent = sum(rn.wire_sent_bytes for a in apps for rn in a.remote_nodes.nodes())
    recv = sum(rn.wire_recv_bytes for a in apps for rn in a.remote_nodes.nodes())
    return van.wire_sent_bytes, van.wire_recv_bytes, sent, recv


def test_hello_world_roundtrip():
    create_app, log = hello_program(ps, Task)
    apps = ps.run_system(create_app, num_workers=1, num_servers=1, device="cpu")
    assert [a.node.id for a in apps] == ["H0", "S0", "W0"]
    reqs = [e for e in log if e[1] == "req"]
    ress = [e for e in log if e[1] == "res"]
    assert len(reqs) == len(ress) == 3 and len([e for e in log if e[1] == "cb"]) == 1
    assert {e[0] for e in reqs} == {"S0"} and {e[0] for e in ress} == {"W0"}
    van_sent, van_recv, rn_sent, rn_recv = wire_totals(apps)
    assert van_sent == rn_sent > 0 and van_recv == rn_recv > 0
    w = apps[2]
    assert any(rn.wire_recv_bytes > 0 for rn in w.remote_nodes.nodes())


def test_hello_log_and_wire_bytes_equal_the_jax_packages():
    create_app, log = hello_program(ps, Task)
    apps = ps.run_system(create_app, device="cpu")
    ours = wire_totals(apps)
    jcreate, jlog = hello_program(jps, jmsg.Task)
    japps = jps.run_system(jcreate, num_workers=1, num_servers=1)
    theirs = wire_totals(japps)
    assert log == jlog and len(log) == 7
    # 6 frames (3 requests, 3 replies); a frame of each package framed
    # from the same fields shows the header's difference
    frames = 6
    delta = (len(tmsg.Message(task=tmsg.Task(), sender="W0", recver="S0").to_bytes())
             - len(jmsg.Message(task=jmsg.Task(), sender="W0", recver="S0").to_bytes()))
    assert delta == 2 * len("_torch")
    assert [o - t for o, t in zip(ours, theirs)] == [frames * delta] * 4


def test_node_identity_helpers():
    seen = {}

    class Probe(ps.App):
        def __init__(self):
            super().__init__()
            seen[ps.my_node_id()] = (ps.is_scheduler(), ps.is_server(), ps.is_worker(),
                                     ps.my_rank(), ps.rank_size(), ps.my_key_range())
            assert ps.my_node() is not None

    ps.run_system(Probe, num_workers=1, num_servers=1, key_space=Range(0, 100), device="cpu")
    assert seen["H0"][:3] == (True, False, False)
    assert seen["S0"][:3] == (False, True, False)
    assert seen["W0"][:3] == (False, False, True)
    assert seen["W0"][3:5] == (0, 1) and seen["S0"][3:5] == (0, 1)
    assert seen["S0"][5] == Range(0, 100)  # one server holds the whole key space
    assert seen["W0"][5] == Range.all()


def test_my_app_answers_inside_each_app():
    mine = {}

    class Probe(ps.App):
        def run(self):
            mine[ps.my_node_id()] = ps.my_app() is self

    ps.run_system(Probe, device="cpu")
    assert mine == {"H0": True, "S0": True, "W0": True}


def test_ready_barriers_and_scheduler_id():
    ps.start_system(num_workers=1, num_servers=1, device="cpu")
    ps.wait_servers_ready()
    ps.wait_workers_ready()
    assert ps.scheduler_id() == "H0"
    assert ps.next_customer_id() >= 1
    ps.stop_system()
    with pytest.raises(RuntimeError):
        ps.wait_servers_ready()


def test_package_exports():
    assert pst.__version__ == jpst.__version__
    assert set(pst.__all__) == set(jpst.__all__)
    for name in pst.__all__:
        assert getattr(pst, name) is not None
    assert pst.ps.App is ps.App and pst.App is ps.App
    assert ps.__all__ == jps.__all__
    for name in ps.__all__:
        assert callable(getattr(ps, name)) or isinstance(getattr(ps, name), type)


def test_worker_exception_propagates():
    class Crasher(ps.App):
        def run(self):
            if ps.is_worker():
                raise RuntimeError("worker died")

    with pytest.raises(RuntimeError, match="worker died"):
        ps.run_system(Crasher, num_workers=1, num_servers=1, device="cpu")


def test_group_broadcast_delivers_to_self():
    got = []

    class Echo(ps.App):
        def process_request(self, msg):
            got.append((msg.sender, ps.my_node_id()))

        def run(self):
            if ps.my_node_id() == "W0":
                self.wait(ps.submit(self, Task(), ps.NodeGroups.LIVE_GROUP))

    ps.run_system(Echo, device="cpu")
    receivers = {r for s, r in got if s == "W0"}
    assert receivers == {"H0", "S0", "W0"}  # the sender's own node too


def test_reentrant_submit_from_process_request():
    relayed = []

    class Relay(ps.App):
        def process_request(self, msg):
            if msg.task.cmd == 1 and ps.is_scheduler():
                ps.submit(self, Task(cmd=2), ps.NodeGroups.LIVE_GROUP)
            elif msg.task.cmd == 2:
                relayed.append(ps.my_node_id())

        def run(self):
            if ps.my_node_id() == "W0":
                self.wait(ps.submit(self, Task(cmd=1), ps.scheduler_id()))

    ps.run_system(Relay, num_workers=1, num_servers=1, device="cpu")
    assert set(relayed) == {"H0", "S0", "W0"}


def test_filter_specs_ride_every_reply_through_the_peer_chains():
    """The server answers each of four requests with the same key array
    and fresh values under ``wire_filter_specs(1)`` (a pull's response):
    the worker decodes the keys each time, the values within one
    quantization step, and only the first reply carries the keys on the
    wire; the later ones their signature."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << 40, 500).astype(np.uint64))
    vals = [rng.normal(size=keys.size).astype(np.float32) for _ in range(4)]
    got, reply_bytes = [], []

    class Server(ps.App):
        def process_request(self, req):
            before = self.remote_nodes.get("W0").wire_sent_bytes
            task = Task(filters=wire_filter_specs(1))
            self.reply(req, tmsg.Message(task=task, key=keys.copy(),
                                         values=[vals[len(got)].copy()]))
            reply_bytes.append(self.remote_nodes.get("W0").wire_sent_bytes - before)

    class Worker(ps.App):
        def process_response(self, res):
            got.append((res.key, res.values[0]))

        def run(self):
            for _ in range(4):
                self.wait(ps.submit(self, Task(), ps.NodeGroups.SERVER_GROUP))

    ps.run_system(lambda: Server() if ps.is_server() else
                  (Worker() if ps.is_worker() else ps.App()), device="cpu")
    assert len(got) == 4
    for (k, v), want in zip(got, vals):
        assert np.array_equal(k, keys)
        assert np.abs(v - want).max() <= (want.max() - want.min()) / 255 * (1 + 1e-6)
    assert reply_bytes[0] - reply_bytes[1] >= keys.nbytes  # later: the signature only
    assert reply_bytes[1] == reply_bytes[2] == reply_bytes[3]


@pytest.mark.parametrize("layout", [dict(num_workers=2), dict(num_servers=2)])
def test_more_than_one_server_or_worker_raises_naming_a9(layout):
    with pytest.raises(NotImplementedError, match="A9"):
        ps.run_system(ps.App, device="cpu", **layout)
