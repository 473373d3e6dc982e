"""PyTorch port: ``ps.run_system`` over a mesh of ranks against the JAX
package's ``run_system`` over its device mesh.

The port's side runs ``tests/test_ps_api.py``'s multi-node programs at 2
workers x 2 servers in a gloo world of 4 CPU ranks (each rank hosting
every node, H0, S0, S1, W0, W1; rank functions in
``tests/torch_mesh_rest_ranks.py``) and in one process with no world;
the JAX side runs them in the test process on a 2x2 mesh of its virtual
CPU devices. A store program beside them: each worker pushes its share of
a seeded stream into the server app's ``KVVector`` (sharded over the
mesh's server axis), pulls 64 of the keys back and submits a control
task after each push.

What is held, and how tightly:

- the hello program's log by node (node, kind, timestamp, sender),
  sorted, equal to the JAX package's and the same on every rank; the
  van's totals equal to the ``RemoteNode`` counters on every rank;
- the identity helpers, the key ranges, a broadcast reaching its sender
  and a worker's exception failing the program: equal to the JAX
  package's, on every rank;
- the store: the workers' submissions take turns, W0, W1, W0, ... on
  every rank, so the table and each pull are **bit-equal** to a
  one-card store fed the same pushes and pulls in that order, on every
  rank, and equal to the JAX store on a 2x2 mesh fed the same pushes
  in that order;
- a data row whose worker pushes once more than the other row's: the
  run's closing agreement raises on every rank, naming the order of the
  store's submissions, and the world returns.
"""

import threading

import jax
import numpy as np
import pytest

from parameter_server_tpu import ps as jps
from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector
from parameter_server_tpu.system import message as jmsg
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.utils.range import Range as JRange
from parameter_server_tpu_torch import ps
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.parameter.kv_vector import KVVector
from parameter_server_tpu_torch.system.message import Task
from parameter_server_tpu_torch.system.postoffice import Postoffice
from tests import torch_mesh_rest_ranks as ranks

LAYOUT = (2, 2)  # workers x servers
SLOTS = 1 << 10


def _stream():
    rng = np.random.default_rng(0)
    return [(np.sort(rng.choice(5000, 300, replace=False)).astype(np.int64),
             rng.normal(size=(300, 1)).astype(np.float32)) for _ in range(6)]


@pytest.fixture(scope="module")
def world():
    return launch.run_world(ranks.ps_programs, 4, args=(LAYOUT, _stream(), SLOTS, 1),
                            device_type="cpu", timeout=200)


@pytest.fixture
def fresh():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    ps.stop_system()
    jps.stop_system()


def _jax_hello():
    log = []
    lock = threading.Lock()

    def record(x):
        with lock:
            log.append(x)

    apps = jps.run_system(ranks._hello(jps, jmsg.Task, record), num_workers=LAYOUT[0],
                          num_servers=LAYOUT[1])
    return sorted(log), [a.node.id for a in apps]


def test_hello_program_log_equals_the_jax_packages_on_every_rank(world, fresh):
    want, nodes = _jax_hello()
    assert len(want) == 2 * 3 * 2 * 2 + 2
    for r in world:
        h = r["hello"]
        assert h["nodes"] == nodes == ["H0", "S0", "S1", "W0", "W1"]
        assert h["log"] == [tuple(x) for x in want]
        assert h["van"] == h["remote"] and h["van"][0] > 0
        assert all(h["workers_recv"])


def test_hello_program_in_one_process_hosts_every_node(world, fresh):
    """With no world, one process hosts the 2x2 node table on its card:
    the same log as each rank's."""
    log = []
    apps = ps.run_system(ranks._hello(ps, Task, log.append), num_workers=LAYOUT[0],
                         num_servers=LAYOUT[1], device="cpu")
    assert [a.node.id for a in apps] == world[0]["hello"]["nodes"]
    assert sorted(log) == [tuple(x) for x in world[0]["hello"]["log"]]


def test_identity_broadcast_and_crash_equal_the_jax_packages(world, fresh):
    seen = {}

    class Probe(jps.App):
        def __init__(self):
            super().__init__()
            seen[jps.my_node_id()] = (jps.is_scheduler(), jps.is_server(), jps.is_worker(),
                                      jps.my_rank(), jps.rank_size(),
                                      (jps.my_key_range().begin, jps.my_key_range().end))

    jps.run_system(Probe, num_workers=LAYOUT[0], num_servers=LAYOUT[1], key_space=JRange(0, 100))
    for r in world:
        assert r["identity"] == seen
        assert r["identity"]["S1"][5] == (50, 100)
        assert r["broadcast"] == ["H0", "S0", "S1", "W0", "W1"]
        assert r["crash"] == "worker died"


def _one_card_store(stream):
    """The pushes and pulls of the store program in the turns' order (W0,
    W1, W0, ...: each worker's push, then each worker's pull), on one
    store with no mesh."""
    Postoffice.reset()
    kv = KVVector(k=1, num_slots=SLOTS, hashed=True, name="ref", device="cpu")
    try:
        nw = LAYOUT[0]
        mine = [stream[i::nw] for i in range(nw)]
        pulled = [[] for _ in range(nw)]
        for k in range(max(len(m) for m in mine)):
            for i in range(nw):
                if k < len(mine[i]):
                    keys, vals = mine[i][k]
                    kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
            for i in range(nw):
                if k < len(mine[i]):
                    keys = mine[i][k][0]
                    pulled[i].append(kv.wait_pull(kv.pull(kv.request(channel=0),
                                                          keys=keys[:64])).numpy())
        return kv.get_replica()[0], pulled
    finally:
        kv.executor.stop()
        Postoffice.reset()


def test_store_program_bit_equal_to_one_card_in_the_turns_order(world):
    table, pulled = _one_card_store(_stream())
    for r in world:
        kv = r["kv"]
        assert isinstance(kv, dict), kv
        assert kv["table"].tobytes() == table.tobytes()
        for mine, want in zip(kv["pulled"], pulled):
            assert len(mine) == len(want) == 3
            for a, b in zip(mine, want):
                assert a.tobytes() == b.tobytes()
        assert kv["van"] == kv["remote"] and kv["van"][0] > 0
        assert kv["reqs"] == sorted([("S0", "W0"), ("S1", "W0")] * 3
                                    + [("S0", "W1"), ("S1", "W1")] * 3)
    assert np.count_nonzero(table) > 0


def test_store_program_equals_the_jax_store_fed_in_the_turns_order(world, fresh):
    """The JAX ``KVVector`` on a 2x2 mesh fed the program's pushes from
    one thread in the turns' order: the same table, value for value. (Fed
    by the JAX ``run_system``'s two worker threads on a mesh of two data
    rows, the JAX table differs from its own one-thread run, and from run
    to run: ROADMAP Queue C.)"""
    stream = _stream()
    jm = jmesh.make_mesh(num_data=2, num_server=2, devices=jax.devices()[:4])
    kv = JKVVector(k=1, num_slots=SLOTS, hashed=True, name="jax_kv", mesh=jm)
    try:
        nw = LAYOUT[0]
        mine = [stream[i::nw] for i in range(nw)]
        for k in range(max(len(m) for m in mine)):
            for i in range(nw):
                if k < len(mine[i]):
                    keys, vals = mine[i][k]
                    kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
        want = np.asarray(kv.get_replica()[0])
    finally:
        kv.executor.stop()
    got = world[0]["kv"]["table"]
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)


def test_a_data_row_that_submits_more_fails_every_rank_loudly(world):
    """Data row 1's last worker pushes its first item twice: each row's
    pulls agree within the row, and the run's closing agreement over the
    mesh raises on all four ranks."""
    for r in world:
        assert isinstance(r["kv_diverged"], str)
        assert "disagree on" in r["kv_diverged"]
        assert "the order of store 'ps_kv''s submissions" in r["kv_diverged"]
