"""PyTorch port: server replicas and recovery against the JAX package.

- ``ReplicaManager`` (``parameter/replica.py``): the consistent backup's
  barrier, a backup under a live push stream, the periodic loop, the
  dead-server flow through ``RecoveryCoordinator``, snapshots installed
  across the two packages, and the ``kv_store`` factory
  (``tests/test_faults.py``'s ``TestReplicaBackups``,
  ``tests/test_recovery.py``);
- the linear worker's ongoing replica (``SGDConfig.num_replicas``,
  ``replica_every``) with ``wipe_server_shard`` / ``recover_server_shard``
  (``tests/test_async_sgd.py``'s ``TestLiveReplication``), and the FM and
  wide&deep workers' wipe.

The JAX stores and workers sit on a 1x1 mesh
(``make_mesh(num_data=1, num_server=1)``), so "server shard 0" is the
whole table on both sides. Tolerances: tables of the stores are held bit
for bit (both add a slot's entries in entry order); the port's own
replica restores its own state bit for bit; the linear workers are held
to each other within ``TRAJ_TOL`` (``rtol=1e-5, atol=1e-6``), the
worker-parity tolerance of ``tests/test_torch_linear_step.py`` (XLA
fuses ``z + g - sigma * w`` into one multiply-add, eager torch does not);
the FM and wide&deep states within ``STATE_RTOL`` (1e-5) of each leaf's
scale, as ``tests/test_torch_fm.py`` holds them.
"""

import threading
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.apps.linear.deep_ctr import DeepCTRWorker as JDeep
from parameter_server_tpu.apps.linear.fm import FMWorker as JFM
from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector
from parameter_server_tpu.parameter.replica import ReplicaManager as JReplicaManager
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear.deep_ctr import DeepCTRWorker
from parameter_server_tpu_torch.apps.linear.fm import FMWorker
from parameter_server_tpu_torch.parameter import kv_store as tkv_store
from parameter_server_tpu_torch.parameter.kv_layer import KVLayer
from parameter_server_tpu_torch.parameter.kv_map import AddEntry, KVMap
from parameter_server_tpu_torch.parameter.kv_vector import KVVector
from parameter_server_tpu_torch.parameter.replica import ReplicaManager
from parameter_server_tpu_torch.system.heartbeat import HeartbeatCollector, HeartbeatReport
from parameter_server_tpu_torch.system.postoffice import Postoffice
from parameter_server_tpu_torch.system.recovery import RecoveryCoordinator
from parameter_server_tpu_torch.utils.sparse import SparseBatch

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)  # the worker-parity tolerance (module docstring)
STATE_RTOL = 1e-5
SCALE_FLOOR = 1e-2
MB, KEYS, NNZ, SLOTS = 256, 1 << 14, 39, 1 << 12


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(num_data=1, num_server=1)


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    Postoffice.reset()
    JPostoffice.reset()


# -- ReplicaManager over a KVVector --


def _store(name, hashed=True):
    return KVVector(k=2, num_slots=64, hashed=hashed, name=name, device="cpu")


def _push(kv, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 12, 16).astype(np.int64)
    vals = rng.normal(size=(16, 2)).astype(np.float32)
    ts = kv.push(kv.request(channel=0), keys=keys, values=vals)
    kv.executor.wait(ts, timeout=30)
    return ts, keys, vals


def test_barrier_separates_snapshot_from_later_pushes(mesh1):
    """Pushes before the backup are in it, later ones are not: wipe,
    recover through the executor and replay past the barrier gives the
    pre-crash table bit for bit, and the JAX store's."""
    kv = _store("bk_barrier")
    jkv = JKVVector(mesh=mesh1, k=2, num_slots=64, hashed=True, name="jbk_barrier")
    ts1, k1, v1 = _push(kv, 1)
    jkv.executor.wait(jkv.push(jkv.request(channel=0), keys=k1, values=v1))
    rm = ReplicaManager()
    meta = rm.backup_consistent(kv)
    barrier = meta["barrier"][0]
    assert meta["version"] == 1 and meta["consistent"]
    ts2, k2, v2 = _push(kv, 2)
    jkv.executor.wait(jkv.push(jkv.request(channel=0), keys=k2, values=v2))
    assert ts1 < barrier < ts2 and rm.barrier(kv.name) == {0: barrier}
    after_two = kv.table(0, copy=True).numpy()
    kv.set_table(0, kv._zeros())  # the crash: the replacement starts empty
    assert rm.recover(kv, through_executor=True)
    kv.executor.wait(kv.push(kv.request(channel=0), keys=k2, values=v2), timeout=30)
    healed = kv.table(0, copy=True).numpy()
    assert healed.tobytes() == after_two.tobytes() == np.asarray(jkv.table(0)).tobytes()
    kv.executor.stop()


def test_backup_consistent_untorn_under_live_pushes():
    """A concurrent in-place push stream cannot tear the backup: each
    snapshot holds some prefix of the pushes, the same count on every
    row (exact keys: one slot a key)."""
    kv = KVVector(k=2, num_slots=64, hashed=False, name="bk_live", device="cpu")
    keys = np.arange(16, dtype=np.int64)
    kv.set_keys(0, keys)
    ones = np.ones((16, 2), np.float32)
    kv.executor.wait(kv.push(kv.request(channel=0), keys=keys, values=ones), timeout=30)
    stop = threading.Event()
    err = []

    def pusher():
        try:
            while not stop.is_set():
                kv.executor.wait(kv.push(kv.request(channel=0), keys=keys, values=ones),
                                 timeout=30)
        except BaseException as e:
            err.append(e)

    t = threading.Thread(target=pusher)
    t.start()
    try:
        rm = ReplicaManager()
        for _ in range(5):
            rm.backup_consistent(kv)
            snap = rm._replicas[kv.name][0]
            rows = snap[kv.channel(0).directory.slots(keys)]
            assert len(np.unique(rows)) == 1, np.unique(rows)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not err
    kv.executor.stop()


def test_periodic_loop_backs_up_and_joins():
    kv = _store("bk_periodic")
    _push(kv, 3)
    rm = ReplicaManager()
    rm.start_periodic(kv, interval_s=0.03)
    with pytest.raises(RuntimeError, match="already running"):
        rm.start_periodic(kv, interval_s=0.03)
    deadline = time.time() + 10
    while time.time() < deadline:
        meta = rm.meta(kv.name)
        if meta and meta["version"] >= 2:
            break
        time.sleep(0.01)
    rm.stop_periodic()
    meta = rm.meta(kv.name)
    assert meta and meta["version"] >= 2 and meta["consistent"]
    rm.stop_periodic()  # the thread is gone: a second stop is a no-op
    assert rm.recover(kv)
    rm.drop(kv.name)
    assert rm.meta(kv.name) is None and not rm.recover(kv)
    kv.executor.stop()


def test_dead_server_recovers_a_wiped_store_from_its_replica():
    """The server-death flow: a backup, the table wiped, the heartbeat
    timeout seen by the coordinator, the handler recovers the store."""
    c = HeartbeatCollector(timeout=5.0)
    for nid in ("W0", "W1", "S0"):
        c.report(nid, HeartbeatReport(hostname=nid))
    kv = KVVector(k=1, num_slots=32, hashed=False, name="table", device="cpu")
    keys = np.array([1, 5, 9], dtype=np.int64)
    kv.set_keys(0, keys)
    kv.wait(kv.push(kv.request(channel=0), keys=keys, values=np.ones((3, 1), np.float32)))
    rm = ReplicaManager()
    rm.backup(kv)
    assert rm.meta(kv.name)["consistent"] is False
    kv.set_table(0, kv._zeros())
    recovered = []

    def recover_server(nid):
        assert rm.recover(kv)
        recovered.append(nid)

    rc = RecoveryCoordinator(c)
    rc.on_server_dead(recover_server)
    assert rc.check(now=c._last_seen["S0"] + 6) != []
    assert "S0" in recovered
    np.testing.assert_array_equal(kv.values(0, keys), np.ones((3, 1)))
    kv.executor.stop()


@pytest.mark.parametrize("consistent", [False, True])
def test_snapshot_installs_across_packages(mesh1, consistent):
    """A JAX ReplicaManager's snapshot recovers a port store, and a port
    snapshot recovers a JAX store, bit for bit (one table format: a
    channel -> host array dict in the base layout)."""
    jkv = JKVVector(mesh=mesh1, k=2, num_slots=64, hashed=True, name="xpkg")
    kv = _store("xpkg")
    for seed in (4, 5):
        _, keys, vals = _push(kv, seed)
        jkv.executor.wait(jkv.push(jkv.request(channel=0), keys=keys, values=vals))
    jrm, rm = JReplicaManager(), ReplicaManager()
    (jrm.backup_consistent if consistent else jrm.backup)(jkv)
    (rm.backup_consistent if consistent else rm.backup)(kv)
    want = kv.table(0, copy=True).numpy().tobytes()
    assert np.asarray(jkv.table(0)).tobytes() == want
    other = _store("xpkg_other")
    other.name = "xpkg"
    rm._replicas["xpkg"], jrm._replicas["xpkg"] = jrm._replicas["xpkg"], rm._replicas["xpkg"]
    assert rm.recover(other, through_executor=consistent)
    assert other.table(0, copy=True).numpy().tobytes() == want
    jkv.set_table(0, jkv._zeros())
    assert jrm.recover(jkv, through_executor=consistent)
    assert np.asarray(jkv.table(0)).tobytes() == want
    kv.executor.stop()
    other.executor.stop()


def test_kv_store_kinds():
    assert isinstance(tkv_store.kv_store("vector", k=1, num_slots=16, device="cpu"), KVVector)
    assert isinstance(tkv_store.kv_store("map", entry=AddEntry(), k=2, num_slots=16,
                                         device="cpu"), KVMap)
    assert isinstance(tkv_store.kv_store("layer", device="cpu"), KVLayer)
    with pytest.raises(ValueError, match="unknown kv store kind"):
        tkv_store.kv_store("tree")
    from parameter_server_tpu.parameter import kv_store as jkv_store

    assert tkv_store.__all__ == jkv_store.__all__


# -- the linear worker's ongoing replica --


def make_batch(seed):
    """bench.py's synthetic batch at a small size (as
    ``tests/test_torch_linear_step.py``); both packages take it."""
    b = jsparse.random_sparse(MB, KEYS, NNZ, seed=seed, binary=True)
    b.y = np.where((b.indices.reshape(MB, -1) % 1024 < 256).mean(1) > 0.24, 1.0,
                   -1.0).astype(np.float32)
    return b


def _linear_conf(mod, replicas, every, update="sparse"):
    c = mod.Config()
    c.penalty = mod.PenaltyConfig(type="l1", lambda_=[1.0])
    c.learning_rate = mod.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = mod.SGDConfig(algo="ftrl", minibatch=MB, num_slots=SLOTS, max_delay=0,
                                update=update, num_replicas=replicas, replica_every=every)
    return c


def _linear_pair(mesh, replicas=1, every=1, update="sparse"):
    jw = jsgd.AsyncSGDWorker(_linear_conf(jcfg, replicas, every, update), mesh=mesh)
    tw = tsgd.AsyncSGDWorker(_linear_conf(tcfg, replicas, every, update), device="cpu")
    return jw, tw


def _step_both(jw, tw, batch):
    jw.collect(jw.process_minibatch(batch))
    tw.collect(tw.process_minibatch(batch))


@pytest.mark.parametrize("update", ["sparse", "dense"])
@pytest.mark.parametrize("every", [1, 2])
def test_wipe_and_recover_match_jax(mesh1, every, update):
    """Port and JAX workers on the same batches, mirroring every
    ``every`` ministeps: a wipe zeroes the table on both, a recover
    restores the state of the last refresh (the port's bit for bit),
    and training on from there stays with the JAX worker."""
    jw, tw = _linear_pair(mesh1, every=every, update=update)
    per_step = []
    for i in range(4):
        _step_both(jw, tw, make_batch(i))
        per_step.append({k: v.clone() for k, v in tw.state.items()})
    # refreshes after the first ministep, then once `every` more have run:
    # at 0-based ministeps 0, 1, 2, 3 (every 1) or 0, 2 (every 2)
    last_refresh = 3 if every == 1 else 2
    np.testing.assert_allclose(tw.weights_dense(), jw.weights_dense(), **TRAJ_TOL)
    jw.wipe_server_shard(0)
    tw.wipe_server_shard(0)
    assert not np.any(tw.weights_dense()) and not np.any(jw.weights_dense())
    assert all(not torch.any(v) for v in tw.state.values())
    assert jw.recover_server_shard(0) and tw.recover_server_shard(0)
    for k, v in tw.state.items():
        assert torch.equal(v, per_step[last_refresh][k]), k
    np.testing.assert_allclose(tw.weights_dense(), jw.weights_dense(), **TRAJ_TOL)
    for i in range(4, 7):
        _step_both(jw, tw, make_batch(i))
    np.testing.assert_allclose(tw.weights_dense(), jw.weights_dense(), **TRAJ_TOL)
    # a shard past the one server holds no rows: nothing changes
    before = tw.weights_dense()
    tw.wipe_server_shard(1)
    assert tw.recover_server_shard(1)
    np.testing.assert_array_equal(tw.weights_dense(), before)


def test_staleness_bounded_not_zero(mesh1):
    """With a replica taken only at the first ministep, the recovered
    weights are the first ministep's: stale, bounded, not zeros."""
    jw, tw = _linear_pair(mesh1, every=1000)
    _step_both(jw, tw, make_batch(0))
    snap = tw.weights_dense().copy()
    for i in range(1, 4):
        _step_both(jw, tw, make_batch(i))
    assert not np.array_equal(tw.weights_dense(), snap)
    for w in (jw, tw):
        w.wipe_server_shard(0)
        assert w.recover_server_shard(0)
    np.testing.assert_array_equal(tw.weights_dense(), snap)
    np.testing.assert_allclose(tw.weights_dense(), jw.weights_dense(), **TRAJ_TOL)


def test_recovery_coordinator_drives_shard_recovery(mesh1):
    jw, tw = _linear_pair(mesh1, every=1)
    for i in range(3):
        _step_both(jw, tw, make_batch(i))
    want = tw.weights_dense().copy()
    tw.wipe_server_shard(0)
    c = HeartbeatCollector(timeout=5.0)
    c.report("S0", HeartbeatReport())
    rc = RecoveryCoordinator(c)
    rc.on_server_dead(lambda nid: tw.recover_server_shard(int(nid[1:])))
    assert rc.check(now=c._last_seen["S0"] + 6) == ["S0"]
    np.testing.assert_array_equal(tw.weights_dense(), want)
    np.testing.assert_allclose(want, jw.weights_dense(), **TRAJ_TOL)


def test_no_replica_configured_returns_false(mesh1):
    jw, tw = _linear_pair(mesh1, replicas=0)
    _step_both(jw, tw, make_batch(0))
    assert not jw.recover_server_shard(0)
    assert not tw.recover_server_shard(0)
    assert tw._replica_state is None


def test_load_state_host_drops_the_replica(mesh1):
    """As in the JAX worker: a loaded state has no replica until the next
    step mirrors it, and a bounded-delay worker pulls the recovered state."""
    jw, tw = _linear_pair(mesh1, every=1)
    _step_both(jw, tw, make_batch(0))
    assert tw._replica_state is not None
    tw.load_state_host(jw.state_host())
    assert tw._replica_state is None and not tw.recover_server_shard(0)
    tw.wait(tw.process_minibatch(make_batch(1)))
    assert tw.recover_server_shard(0)


# -- the FM and wide&deep workers --


def _ell_conf(mod):
    conf = mod.Config()
    conf.loss = mod.LossConfig(type="logit")
    conf.penalty = mod.PenaltyConfig(type="l1", lambda_=[0.01])
    conf.learning_rate = mod.LearningRateConfig(type="decay", alpha=0.5, beta=1.0)
    conf.async_sgd = mod.SGDConfig(algo="standard", minibatch=256, num_slots=257, ell_lanes=4)
    return conf


def _ell_batches(seed, n, rows=48, lanes=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        indptr = np.arange(0, rows * lanes + 1, lanes, dtype=np.int64)
        kw = dict(y=np.where(rng.random(rows) < 0.5, 1.0, -1.0).astype(np.float32),
                  indptr=indptr, indices=rng.integers(0, 1 << 40, rows * lanes), values=None)
        out.append((jsparse.SparseBatch(**kw), SparseBatch(**kw)))
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: a for k in sorted(tree) for p, a in _leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: a for i, t in enumerate(tree) for p, a in _leaves(t, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("kind", ["fm", "deep_ctr"])
def test_ell_workers_wipe_and_refuse_recovery(mesh1, kind):
    jcls, tcls, kw = {"fm": (JFM, FMWorker, dict(k=4)),
                      "deep_ctr": (JDeep, DeepCTRWorker, dict(k=4, hidden=(8,)))}[kind]
    j = jcls(_ell_conf(jcfg), mesh=mesh1, **kw)
    t = tcls(_ell_conf(tcfg), device="cpu", **kw)
    t.load_state_host(j.state_host())
    for jb, tb in _ell_batches(1, 2):
        j.collect(j.process_minibatch(jb))
        t.collect(t.process_minibatch(tb))
    before = _leaves(t.state_host()["state"])
    j.wipe_server_shard(0)
    t.wipe_server_shard(0)
    assert not j.recover_server_shard(0) and not t.recover_server_shard(0)
    ja, ta = _leaves(j.state_host()["state"]), _leaves(t.state_host()["state"])
    assert sorted(ja) == sorted(ta)
    table = {"fm": ("/w", "/w_ss", "/v", "/v_ss")}.get(kind, ("/table/w", "/table/w_ss",
                                                             "/table/v", "/table/v_ss"))
    for path in ta:
        if path in table:
            assert not np.any(ta[path]) and not np.any(ja[path]), path
        else:  # the bias (and the MLP) survive the server's death
            np.testing.assert_array_equal(ta[path], before[path], err_msg=path)
        scale = max(float(np.abs(ja[path]).max()), SCALE_FLOOR)
        assert float(np.abs(ja[path].astype(np.float64) - ta[path]).max()) <= STATE_RTOL * scale
    # the wiped workers train on
    jb, tb = _ell_batches(2, 1)[0]
    j.collect(j.process_minibatch(jb))
    t.collect(t.process_minibatch(tb))
    assert np.isfinite(t.progress.objective[-1])
