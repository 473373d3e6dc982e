"""PyTorch port: live elasticity (``system/elastic.py``'s
``ElasticCoordinator``) and the worker's neighbour replica on a mesh,
against the JAX package's coordinator.

The port's side runs in one gloo world of 8 CPU ranks
(``tests/torch_elastic_ranks.py::elastic_cases``: every rank runs the
coordinator; a mesh's idle ranks hold no worker and follow each resize);
the JAX side runs ``tests/test_elastic.py``'s scenarios in the test
process on the suite's 8 virtual CPU devices, on the same minibatches.
Tolerances, each with its reason:

- the port's weights after a resize against its weights before it:
  **bit-equal** (the state is gathered and installed as bytes; JAX's test
  allows ``atol=1e-6``); the recovered shard against the replica's copy
  and the weights before the wipe: bit-equal;
- the port against the JAX worker, trained before a resize and continued
  on the new mesh: ``TRAJ_TOL`` (``rtol=1e-5, atol=1e-6``: the one-card
  tolerance of the mesh tests (``tests/test_torch_parallel_linear.py``);
  XLA contracts ``z + g - sigma * w``
  into a fused multiply-add under jit, eager PyTorch does not);
  per-example losses relative 1e-5;
- the manager's add/remove events, the resize history's shapes, the
  example counts and the model header: equal.
"""

import tempfile

import numpy as np
import pytest

from parameter_server_tpu.apps.linear.async_sgd import AsyncSGDWorker as JWorker
from parameter_server_tpu.apps.linear.config import (Config, LearningRateConfig, PenaltyConfig,
                                                     SGDConfig)
from parameter_server_tpu.system.elastic import ElasticCoordinator as JCoordinator
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.utils import sparse as tsparse
from tests import torch_elastic_ranks as ranks
from tests.test_elastic import NUM_SLOTS, batches as jbatches, make_worker as jmake_worker

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)


def jmake_noreplica(mesh):
    conf = Config()
    conf.penalty = PenaltyConfig(type="l1", lambda_=[0.01])
    conf.learning_rate = LearningRateConfig(type="decay", alpha=0.5, beta=1.0)
    conf.async_sgd = SGDConfig(algo="ftrl", minibatch=256, num_slots=NUM_SLOTS)
    return JWorker(conf, mesh=mesh)


def _port(b):
    return tsparse.SparseBatch(y=b.y.copy(), indptr=b.indptr.copy(), indices=b.indices.copy(),
                               values=None if b.values is None else b.values.copy())


def _jco(mk, d, s, events=None):
    JPostoffice.reset()
    co = JCoordinator(mk, num_data=d, num_server=s)
    if events is not None:
        co.subscribe_nodes(lambda ev, n: events.append((ev, n.id)))
    return co, co.start()


def _jax_side(stream, extra):
    out = {}
    try:
        events = []
        co, w = _jco(jmake_worker, 2, 2, events)
        for b in stream[:3]:
            w.collect(w.process_minibatch(b))
        before = w.weights_dense()
        w = co.add_server()
        w.collect(w.process_minibatch(extra[0]))
        out["server_join"] = dict(before=before, trained=w.weights_dense(), events=events)

        co, w = _jco(jmake_worker, 2, 2)
        for b in stream[:3]:
            w.collect(w.process_minibatch(b))
        w = co.remove_server()
        w.collect(w.process_minibatch(extra[0]))
        out["server_leave"] = dict(trained=w.weights_dense())

        co, w = _jco(jmake_worker, 2, 2)
        w.collect(w.process_minibatch(stream[0]))
        w = co.add_worker()
        w.collect(w.process_minibatch(extra[1]))
        out["worker_join"] = dict(trained=w.weights_dense())

        events = []
        co, w = _jco(jmake_noreplica, 2, 2, events)
        for b in stream[:3]:
            w.collect(w.process_minibatch(b))
        co.handle_server_death(1)
        after = co.worker.weights_dense()
        co.worker.collect(co.worker.process_minibatch(extra[2]))
        out["death_no_replica"] = dict(after=after, trained=co.worker.weights_dense(),
                                       events=events)

        events = []
        co, w = _jco(jmake_noreplica, 2, 2, events)
        w.collect(w.process_minibatch(stream[0]))
        co.handle_server_death(0)
        out["middle_death"] = dict(events=events)

        events = []
        co, w = _jco(jmake_worker, 2, 2, events)
        w.collect(w.process_minibatch(stream[0]))
        w.wipe_server_shard(0)
        out["recovery_no_events"] = dict(outcome=co.handle_server_death(0), events=events)

        events = []
        co, w = _jco(jmake_noreplica, 2, 1, events)
        w.collect(w.process_minibatch(stream[0]))
        co.handle_server_death(0)
        co.worker.collect(co.worker.process_minibatch(extra[3]))
        out["single_server_death"] = dict(events=events, trained=co.worker.weights_dense())

        co, w = _jco(jmake_worker, 2, 2)
        losses = []
        it = iter(stream)
        for shape in (None, (2, 1), (3, 2)):
            if shape is not None:
                w = co.resize(num_data=shape[0], num_server=shape[1])
            for _ in range(3):
                prog = w.collect(w.process_minibatch(next(it)))
                losses.append(prog.objective[-1] / 256)
        out["streaming"] = dict(losses=losses, final=w.weights_dense(),
                                history=[(r["old"], r["new"]) for r in co.resize_history])
    finally:
        JPostoffice.reset()
    return out


@pytest.fixture(scope="module")
def runs():
    stream = jbatches(9)
    extra = [jbatches(1, seed0=s)[0] for s in (50, 60, 70, 5)]
    with tempfile.TemporaryDirectory(prefix="elastic_") as tmp:
        port = launch.run_world(ranks.elastic_cases, 8,
                                args=([_port(b) for b in stream], [_port(b) for b in extra], tmp),
                                device_type="cpu", timeout=300)
    return port, _jax_side(stream, extra)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _workers(port, case):
    """The results of the ranks that held a worker at the case's end."""
    return [r[case] for r in port if r[case].get("trained", r[case].get("after")) is not None]


# -- TestGracefulResize --


def test_server_join_migrates_key_ranges(runs):
    port, jx = runs
    recs = _workers(port, "server_join")
    assert len(recs) == 6  # 2x3 over the world of 8
    want = jx["server_join"]
    before = port[0]["server_join"]["before"]  # ranks 4 and 5 joined at the resize
    np.testing.assert_allclose(before, want["before"], **TRAJ_TOL)
    for rec in recs:
        assert rec["num_server"] == 3 and rec["shape"][0] == {"data": 2, "server": 3}
        assert rec["shard_rows"] == 334  # 1000 padded to 1002 over 3 shards
        assert np.array_equal(_bits(rec["after"][:NUM_SLOTS]), _bits(before[:NUM_SLOTS]))
        assert not rec["after"][NUM_SLOTS:].any()
        np.testing.assert_allclose(rec["trained"], want["trained"], **TRAJ_TOL)
        assert [e for e in rec["events"]] == want["events"] == [("add", "S2")]
        assert [(h["old"], h["new"]) for h in rec["history"]] == [((2, 2), (2, 3))]
    # the idle ranks followed the resize and hold no worker
    idle = [r["server_join"] for r in port if r["server_join"]["after"] is None]
    assert len(idle) == 2 and all(r["shape"][1] is None for r in idle)
    assert all(r["events"] == [("add", "S2")] for r in idle)


def test_server_leave_keeps_model(runs):
    port, jx = runs
    recs = _workers(port, "server_leave")
    assert len(recs) == 2  # 2x1
    for rec in recs:
        assert np.array_equal(_bits(rec["after"]), _bits(rec["before"]))
        np.testing.assert_allclose(rec["trained"], jx["server_leave"]["trained"], **TRAJ_TOL)


def test_worker_join_grows_data_axis(runs):
    port, jx = runs
    recs = _workers(port, "worker_join")
    assert len(recs) == 6
    before = port[0]["worker_join"]["before"]  # ranks 4 and 5 joined at the resize
    for rec in recs:
        assert rec["shape"][0] == {"data": 3, "server": 2}
        assert np.array_equal(_bits(rec["after"]), _bits(before))
        np.testing.assert_allclose(rec["trained"], jx["worker_join"]["trained"], **TRAJ_TOL)


def test_hash_slots_stable_across_resize(runs):
    recs = _workers(runs[0], "server_join")
    want = runs[0][0]["server_join"]["slots_before"]
    for rec in recs:
        np.testing.assert_array_equal(rec["slots_after"], want)


# -- TestCrashPath --


def test_death_with_replica_recovers_in_place(runs):
    """Shard 0 wiped, then recovered from the neighbour's replica: the
    recovered shard bit-equal to the replica's copy (the copy rank (d, 1)
    keeps of shard 0) and the weights bit-equal to those before the wipe."""
    port = runs[0]
    recs = [r["recover_in_place"] for r in port if r["recover_in_place"]["coords"] is not None]
    assert len(recs) == 4
    for rec in recs:
        assert rec["outcome"] == "recovered" and rec["num_server"] == 2 and rec["events"] == []
        assert np.array_equal(_bits(rec["got"]), _bits(rec["want"]))
        assert not np.array_equal(_bits(rec["wiped"]), _bits(rec["want"]))
        d, s = rec["coords"]
        holder = next(r for r in recs if r["coords"] == (d, 1 - s))
        for k in rec["post"]:
            # the holder's replica is this shard's state at the last refresh
            assert np.array_equal(rec["post"][k], holder["replica"][k]), k
            assert np.array_equal(rec["post"][k], rec["pre"][k]), k


def test_death_without_replica_resharding_loses_only_dead_range(runs):
    port, jx = runs
    recs = _workers(port, "death_no_replica")
    assert len(recs) == 2
    want = jx["death_no_replica"]
    for rec in recs:
        per = rec["per"] or NUM_SLOTS // 2
        assert rec["outcome"] == "resharded" and rec["num_server"] == 1
        assert np.array_equal(_bits(rec["after"][:per]), _bits(rec["before"][:per]))
        assert np.abs(rec["after"][per:2 * per]).sum() == 0
        assert rec["events"] == want["events"] == [("remove", "S1")]
        np.testing.assert_allclose(rec["after"], want["after"], **TRAJ_TOL)
        np.testing.assert_allclose(rec["trained"], want["trained"], **TRAJ_TOL)
    assert all(r["death_no_replica"]["outcome"] == "resharded" for r in port)


def test_heartbeat_timeout_drives_elastic_death_flow(runs):
    recs = [r["heartbeat"] for r in runs[0]]
    for rec in recs:
        assert rec["handled"] == ["S1"] and rec["num_server"] == 2
    for rec in recs[:4]:
        assert np.array_equal(_bits(rec["got"]), _bits(rec["want"]))


def test_middle_rank_death_emits_only_the_dead_node(runs):
    port, jx = runs
    for r in port:
        assert r["middle_death"]["outcome"] == "resharded"
        assert r["middle_death"]["events"] == jx["middle_death"]["events"] == [("remove", "S0")]


def test_recovery_in_place_emits_no_events(runs):
    port, jx = runs
    for r in port:
        assert r["recovery_no_events"]["outcome"] == jx["recovery_no_events"]["outcome"]
        assert r["recovery_no_events"]["events"] == jx["recovery_no_events"]["events"] == []


def test_saved_model_header_uses_configured_modulus(runs):
    headers = [r["model_header"] for r in runs[0] if r["model_header"] is not None]
    assert headers == [["#hashed", str(NUM_SLOTS)]]


def test_aux_runtime_survives_resize(runs):
    for r in runs[0]:
        rec = r["aux"]
        assert rec["same_aux"] and rec["handlers"] and rec["info"]
        assert "S0" in rec["handled"] and "S1" not in rec["handled"]
        assert rec["deaths"] == ["S0"]


def test_single_server_death_rebuilds_slot_with_add_event(runs):
    port, jx = runs
    want = jx["single_server_death"]
    for r in port:
        rec = r["single_server_death"]
        assert rec["outcome"] == "resharded" and rec["num_server"] == 1
        assert rec["events"] == want["events"] == [("remove", "S0"), ("add", "S0")]
        if rec["trained"] is not None:
            np.testing.assert_allclose(rec["trained"], want["trained"], **TRAJ_TOL)


# -- TestResizeUnderLoad --


def test_streaming_minibatches_across_resizes_loses_no_step(runs):
    """2x2 -> 2x1 -> 3x2 with minibatches streaming: every step lands,
    the table crosses both resizes bit for bit, the trajectory stays
    within TRAJ_TOL of the JAX coordinator's, and each pause is recorded
    and on the dashboard."""
    port, jx = runs
    want = jx["streaming"]
    rec = port[0]["streaming"]  # rank 0 holds a worker in every phase
    assert rec["phase_examples"] == [3 * 256] * 3
    assert len(rec["losses"]) == 9
    np.testing.assert_allclose(rec["losses"], want["losses"], rtol=1e-5)
    for before, after in rec["checks"]:
        assert np.array_equal(_bits(after[:NUM_SLOTS]), _bits(before[:NUM_SLOTS]))
    np.testing.assert_allclose(rec["final"], want["final"], **TRAJ_TOL)
    assert [(h["old"], h["new"]) for h in rec["history"]] == want["history"]
    assert all(h["pause_s"] > 0 for h in rec["history"])
    assert "elastic resize 2x2 -> 2x1: stop-the-world" in rec["report"]
    assert "elastic resize 2x1 -> 3x2" in rec["report"]
    for r in port[1:]:
        assert [(h["old"], h["new"]) for h in r["streaming"]["history"]] == want["history"]


def test_a_resize_past_the_world_raises_and_keeps_the_mesh(runs):
    """A 3x3 mesh needs 9 ranks of a world of 8: ``ValueError`` on every
    rank, before anything is torn down, never a smaller mesh."""
    for r in runs[0]:
        rec = r["too_big"]
        assert rec["err"] is not None and "needs 9 > 8" in rec["err"]
        assert rec["shape"] == (2, 2) and rec["alive"]
