"""PyTorch port: the serving plane (admission, coalescer, read replicas,
frontend, load generator) against the JAX package, on the CPU.

The pull and predict values served, in every replica mode, are held
bit-equal to the JAX frontend's over stores filled by the same pushes
(the JAX store on a one-server mesh, so both hash to the same slots).
Timing is never asserted: the token bucket runs on an injected clock,
and the tests check what was served, shed, counted and in what order.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector
from parameter_server_tpu.serving import (
    PredictRequest as JPredictRequest,
    PullRequest as JPullRequest,
    ServeConfig as JServeConfig,
    ServeFrontend as JServeFrontend,
    TokenBucket as JTokenBucket,
    open_loop_bench as j_open_loop_bench,
)
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch.parameter.kv_vector import KVVector
from parameter_server_tpu_torch.serving import (
    AdmissionController,
    DecodeRequest,
    DegradedError,
    PredictRequest,
    PullCoalescer,
    PullRequest,
    ReadReplica,
    RejectedError,
    ServeConfig,
    ServeFrontend,
    TokenBucket,
    open_loop_bench,
)
from parameter_server_tpu_torch.serving.frontend import Ticket
from parameter_server_tpu_torch.system import faults
from parameter_server_tpu_torch.system.executor import Executor
from parameter_server_tpu_torch.system.postoffice import Postoffice

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    faults.reset()
    yield
    faults.reset()
    Postoffice.reset()
    JPostoffice.reset()


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(num_data=1, num_server=1)


def _fill(kv, seed, n_keys, key_space, k):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, key_space, n_keys))
    vals = rng.normal(size=(len(keys), k)).astype(np.float32)
    kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
    return keys


def _store(num_slots=1 << 12, k=1, seed=0, n_keys=512, key_space=1 << 20):
    kv = KVVector(k=k, num_slots=num_slots, hashed=True, name="serve_test", device="cpu")
    return kv, _fill(kv, seed, n_keys, key_space, k)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32 if a.dtype == np.float32 else np.uint64)


class TestTokenBucket:
    def test_decisions_equal_jax_on_one_clock(self):
        now = [0.0]
        rng = np.random.default_rng(0)
        ours = TokenBucket(rate=10.0, burst=5.0, clock=lambda: now[0])
        theirs = JTokenBucket(rate=10.0, burst=5.0, clock=lambda: now[0])
        for _ in range(400):
            now[0] += float(rng.exponential(0.08))
            n = float(rng.choice([1.0, 1.0, 2.0]))
            assert ours.try_acquire(n) == theirs.try_acquire(n)
            assert ours.available() == theirs.available()

    def test_burst_then_rate(self):
        now = [0.0]
        tb = TokenBucket(rate=10.0, burst=5.0, clock=lambda: now[0])
        for _ in range(5):
            assert tb.try_acquire() is None
        retry = tb.try_acquire()
        assert retry == pytest.approx(0.1)
        now[0] += 0.1
        assert tb.try_acquire() is None
        now[0] += 100.0
        assert tb.available() == 5.0  # refill caps at the burst

    def test_validation(self):
        with pytest.raises(ValueError):
            TokenBucket(rate=0, burst=1)
        with pytest.raises(ValueError):
            TokenBucket(rate=1, burst=0.5)


class TestAdmission:
    def test_rate_shed_carries_retry_after(self):
        now = [0.0]
        adm = AdmissionController(rate=2.0, burst=2.0, clock=lambda: now[0])
        adm.admit()
        adm.admit()
        with pytest.raises(RejectedError) as ei:
            adm.admit()
        assert ei.value.reason == "rate" and ei.value.retry_after_s == pytest.approx(0.5)
        now[0] += 0.5
        adm.admit()

    def test_queue_shed_on_the_executor_backlog(self):
        ex = Executor("adm-test")
        gate = threading.Event()
        adm = AdmissionController(max_queue_depth=3, depth_fn=ex.pending_count)
        ts = [ex.submit(gate.wait) for _ in range(4)]  # one runs, three pend
        deadline = time.monotonic() + 5
        while ex.pending_count() != 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        with pytest.raises(RejectedError) as ei:
            adm.admit()
        assert ei.value.reason == "queue" and ei.value.retry_after_s > 0
        gate.set()
        for t in ts:
            ex.wait(t)
        adm.admit()  # the backlog drained: the door reopens
        ex.stop()

    def test_disabled_gates_admit_everything(self):
        adm = AdmissionController()
        for _ in range(1000):
            adm.admit()


class TestCoalescer:
    def test_concurrent_pulls_match_direct_with_fewer_submits(self):
        kv, keys = _store()
        co = PullCoalescer(kv, window_s=0.005, max_requests=64)
        rng = np.random.default_rng(1)
        reqs = [rng.choice(keys, 24, replace=True) for _ in range(24)]
        results = [None] * len(reqs)
        barrier = threading.Barrier(len(reqs))

        def client(j):
            barrier.wait()
            results[j] = co.pull(reqs[j]).result(timeout=30)

        threads = [threading.Thread(target=client, args=(j,)) for j in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for j, req in enumerate(reqs):
            assert np.array_equal(results[j], kv.values(0, req))
        stats = co.stats()
        assert stats["requests"] == len(reqs)
        assert stats["submits"] < stats["requests"]  # the coalescing win
        assert stats["key_dedup_factor"] > 1.0  # overlap fetched once
        co.close()

    def test_duplicate_keys_and_failure_propagation(self):
        kv, keys = _store()
        co = PullCoalescer(kv, window_s=0.001)
        req = np.array([keys[3], keys[3], keys[5], keys[3]])
        assert np.array_equal(co.pull(req).result(timeout=30), kv.values(0, req))
        co.close()

        def bad_pull(task, keys=None, **kw):
            raise OSError("table on fire")

        kv.pull = bad_pull
        co = PullCoalescer(kv, window_s=0.01)
        t1, t2 = co.pull(keys[:4]), co.pull(keys[4:8])
        for t in (t1, t2):
            with pytest.raises(RuntimeError, match="coalesced pull failed"):
                t.result(timeout=30)
        co.close()

    def test_close_rejects_new_and_flushes_staged(self):
        kv, keys = _store()
        co = PullCoalescer(kv, window_s=30.0)  # would wait forever
        ticket = co.pull(keys[:8])
        co.close()
        assert np.array_equal(ticket.result(timeout=30), kv.values(0, keys[:8]))
        with pytest.raises(RuntimeError, match="closed"):
            co.pull(keys[:4])


def _torn_stream_check(read, kv, keys, seconds=0.5):
    """Pushes add 1 to every one of ``keys`` (distinct slots) at once;
    ``read(keys)`` must see all of them moved by the same count: a half-
    applied push would show two counts."""
    base = kv.values(0, keys)
    stop = threading.Event()
    push_err = []

    def pusher():
        try:
            while not stop.is_set():
                kv.wait(kv.push(kv.request(channel=0), keys=keys,
                                values=np.ones((len(keys), 1), np.float32)))
        except BaseException as e:
            push_err.append(e)

    t = threading.Thread(target=pusher)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # many thread switches inside each push and read
    t.start()
    seen = set()
    deadline = time.monotonic() + seconds
    try:
        while time.monotonic() < deadline:
            got = read(keys)
            steps = np.unique(np.round(got - base).astype(np.int64))
            assert len(steps) == 1, f"torn read: {steps}"
            seen.add(int(steps[0]))
    finally:
        stop.set()
        t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not t.is_alive() and not push_err
    return seen


class TestReadReplica:
    def test_snapshot_consistency_across_pushes(self):
        kv, keys = _store()
        rep = ReadReplica(kv)
        before, hit = rep.pull(keys[:16])
        assert hit.all() and np.array_equal(before, kv.values(0, keys[:16]))
        kv.wait(kv.push(kv.request(channel=0), keys=keys[:16],
                        values=np.ones((16, 1), np.float32)))
        again, _ = rep.pull(keys[:16])
        assert np.array_equal(before, again)  # the snapshot held
        assert rep.refresh() == 2
        after, _ = rep.pull(keys[:16])
        np.testing.assert_allclose(after, before + 1.0)

    @pytest.mark.parametrize("device", [False, True])
    def test_reads_never_see_a_half_applied_push(self, device):
        """The in-place hazard: pushes write the live table while
        replica reads and refreshes run; a refresh is a submitted copy
        step, so every read sees whole pushes only."""
        kv, _ = _store(num_slots=1 << 16)
        keys = np.arange(1000, 1064)
        assert len(np.unique(kv.channel(0).directory.slots(keys))) == 64
        rep = ReadReplica(kv, device=device)

        def read(ks):
            rep.refresh()
            vals, hit = rep.pull(ks)
            assert hit.all()
            return vals

        assert len(_torn_stream_check(read, kv, keys)) > 1  # pushes landed meanwhile
        kv.executor.stop()

    def test_live_pulls_never_see_a_half_applied_push(self):
        kv, _ = _store(num_slots=1 << 16)
        keys = np.arange(5000, 5064)
        co = PullCoalescer(kv, window_s=0.0005)
        _torn_stream_check(lambda ks: co.pull(ks).result(30), kv, keys)
        co.close()
        kv.executor.stop()

    def test_snapshot_step_serializes_with_pushes(self):
        kv, keys = _store()
        kv.push(kv.request(channel=0), keys=keys[:8], values=np.full((8, 1), 7.0, np.float32))
        snap = kv.executor.wait(kv.snapshot(0)).numpy()
        slots = kv.channel(0).directory.slots(keys[:8])
        assert np.array_equal(snap[slots], kv.values(0, keys[:8]))

    def test_hot_key_replica_reports_misses_per_key(self):
        kv, keys = _store()
        hot = keys[:32]
        rep = ReadReplica(kv, hot_keys=hot)
        assert rep.nbytes() < ReadReplica(kv).nbytes()  # compact
        mixed = np.concatenate([hot[:3], keys[-5:]])
        vals, hit = rep.pull(mixed)
        assert hit[:3].all() and not hit[3:].any() and (vals[3:] == 0).all()
        assert np.array_equal(vals[:3], kv.values(0, hot[:3]))

    def test_device_matches_host_full_and_hot(self):
        kv, keys = _store()
        host, dev = ReadReplica(kv), ReadReplica(kv, device=True)
        assert isinstance(dev._table, torch.Tensor) and isinstance(host._table, np.ndarray)
        for n in (1, 3, 8, 17, 100):
            vh, _ = host.pull(keys[:n])
            vd, hit = dev.pull(keys[:n])
            assert hit.all() and np.array_equal(_bits(vh), _bits(vd))
        hot = keys[:32]
        hh, hd = ReadReplica(kv, hot_keys=hot), ReadReplica(kv, hot_keys=hot, device=True)
        mixed = np.concatenate([hot[:5], keys[-3:]])
        (vh, mh), (vd, md) = hh.pull(mixed), hd.pull(mixed)
        assert np.array_equal(mh, md) and np.array_equal(vh, vd)

    def test_host_budget_fails_loudly_device_ignores_it(self):
        kv, keys = _store()
        budget = ReadReplica(kv).nbytes() // 2
        with pytest.raises(MemoryError, match="device=True"):
            ReadReplica(kv, host_budget_bytes=budget)
        dev = ReadReplica(kv, device=True, host_budget_bytes=budget)
        vals, hit = dev.pull(keys[:8])
        assert hit.all() and np.array_equal(vals, kv.values(0, keys[:8]))

    def test_refresh_fault_keeps_the_last_good_snapshot(self):
        kv, keys = _store()
        rep = ReadReplica(kv)
        before, _ = rep.pull(keys[:4])
        kv.wait(kv.push(kv.request(channel=0), keys=keys[:4], values=np.ones((4, 1), np.float32)))
        with faults.scoped("serve.refresh", kind="raise"):
            with pytest.raises(faults.FaultError):
                rep.refresh()
        assert rep.version == 1 and np.array_equal(rep.pull(keys[:4])[0], before)


def _jax_pair(mesh, seed=0, num_slots=1 << 12, n_keys=512):
    jkv = JKVVector(mesh=mesh, k=1, num_slots=num_slots, hashed=True, name="j")
    kv = KVVector(k=1, num_slots=num_slots, hashed=True, name="t", device="cpu")
    keys = _fill(jkv, seed, n_keys, 1 << 20, 1)
    _fill(kv, seed, n_keys, 1 << 20, 1)
    return jkv, kv, keys


class TestFrontend:
    @pytest.mark.parametrize("mode", ["full", "hot", "off", "fallback", "device"])
    def test_pull_and_predict_values_equal_jax(self, mesh1, mode):
        jkv, kv, keys = _jax_pair(mesh1)
        rng = np.random.default_rng(5)
        pool = [np.concatenate([rng.choice(keys, 10), rng.integers(0, 1 << 20, 6)])
                for _ in range(24)]  # known and unknown keys
        kw = dict(replica="full" if mode == "device" else mode, workers=2,
                  coalesce_window_s=0.001)
        if mode == "hot":
            kw["hot_keys"] = keys[:64]
        jfe = JServeFrontend(jkv, JServeConfig(**kw)).start()
        fe = ServeFrontend(kv, ServeConfig(replica_device=mode == "device", **kw)).start()
        try:
            for row in pool:
                want = jfe.submit(JPullRequest(keys=row)).result(30)
                got = fe.submit(PullRequest(keys=row)).result(30)
                assert np.array_equal(_bits(np.asarray(want)), _bits(got))
                indptr = np.array([0, 3, 3, 9, 16])
                want = jfe.submit(JPredictRequest(indices=row, indptr=indptr)).result(30)
                got = fe.submit(PredictRequest(indices=row, indptr=indptr)).result(30)
                assert got.dtype == np.float64 and np.array_equal(_bits(want), _bits(got))
            assert fe.stats()["completed"] == jfe.stats()["completed"] == 48
            if mode in ("off", "fallback"):
                assert fe.coalescer.stats()["requests"] == 48
        finally:
            jfe.close()
            fe.close()
        with pytest.raises(RuntimeError, match="closed"):
            fe.submit(PullRequest(keys=keys[:2]))
        kv.executor.stop()

    def test_live_pull_receives_exactly_the_missed_keys(self):
        kv, keys = _store()
        hot, cold = keys[:32], keys[-6:]
        fe = ServeFrontend(kv, ServeConfig(replica="hot", hot_keys=hot,
                                           coalesce_window_s=0.001, workers=1)).start()
        try:
            seen = []
            orig = fe._live_pull
            fe._live_pull = lambda ks: (seen.append(np.asarray(ks).copy()), orig(ks))[1]
            mixed = np.concatenate([hot[:4], cold])
            assert np.array_equal(fe.submit(PullRequest(keys=mixed)).result(30),
                                  kv.values(0, mixed))
            assert len(seen) == 1 and np.array_equal(np.sort(seen[0]), np.sort(cold))
        finally:
            fe.close()

    def test_shed_is_explicit(self):
        kv, keys = _store()
        fe = ServeFrontend(kv, ServeConfig(replica="full", workers=1, admission_rate=20,
                                           admission_burst=2, max_queue_depth=4)).start()
        try:
            fe.pause()  # nothing drains: the depth gate must shed too
            reasons = []
            ok = 0
            for _ in range(100):
                try:
                    fe.submit(PullRequest(keys=keys[:4]))
                    ok += 1
                except RejectedError as e:
                    assert e.retry_after_s >= 0
                    reasons.append(e.reason)
            assert 0 < ok <= 4 and "rate" in reasons
        finally:
            fe.resume()
            fe.close()
        assert fe.stats()["completed"] == ok

    def test_a_request_is_counted_completed_before_its_waiter_sees_it(self):
        """``stats()["completed"]`` read by a caller holding every result
        counts them all: the frontend counts a request before it hands the
        result over (the serve CLI's record and the request counter read
        it so). Each completion records the count it saw."""
        kv, keys = _store()
        fe = ServeFrontend(kv, ServeConfig(replica="full", workers=2)).start()
        seen = []
        real = Ticket._complete

        def completing(ticket, value=None, error=None):
            seen.append(fe.completed)
            real(ticket, value, error)

        Ticket._complete = completing
        try:
            tickets = [fe.submit(PullRequest(keys=keys[i:i + 4])) for i in range(20)]
            for t in tickets:
                t.result(30)
            assert fe.stats()["completed"] == 20
        finally:
            Ticket._complete = real
            fe.close()
            kv.executor.stop()
        assert len(seen) == 20 and min(seen) >= 1 and max(seen) == 20

    def test_concurrent_submits_never_exceed_depth_bound(self):
        kv, keys = _store()
        bound = 16
        fe = ServeFrontend(kv, ServeConfig(replica="full", workers=1,
                                           max_queue_depth=bound)).start()
        accepted = []
        try:
            fe.pause()

            def hammer():
                n = 0
                for _ in range(50):
                    try:
                        fe.submit(PullRequest(keys=keys[:4]))
                        n += 1
                    except RejectedError:
                        pass
                accepted.append(n)

            threads = [threading.Thread(target=hammer) for _ in range(4 * (os.cpu_count() or 2))]
            old = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)
            try:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(30)
            finally:
                sys.setswitchinterval(old)
            assert not any(t.is_alive() for t in threads)
            assert sum(accepted) == fe.depth() == bound
        finally:
            fe.resume()
            fe.close()
        assert fe.stats()["completed"] == bound and fe.depth() == 0

    def test_lanes_shed_separately(self):
        kv, keys = _store()
        gate = threading.Event()

        def slow_decode(req):
            gate.wait(30)
            return torch.as_tensor(req.prompt)

        fe = ServeFrontend(kv, ServeConfig(replica="full", workers=1, max_queue_depth=2),
                           decode_fn=slow_decode).start()
        try:
            prompt = np.zeros((1, 4), np.int64)
            dts = [fe.submit(DecodeRequest(prompt=prompt, steps=4)) for _ in range(2)]
            with pytest.raises(RejectedError) as ei:
                fe.submit(DecodeRequest(prompt=prompt, steps=4))
            assert ei.value.reason == "queue"
            # the pull lane is untouched by the decode backlog
            assert np.array_equal(fe.submit(PullRequest(keys=keys[:4])).result(30),
                                  kv.values(0, keys[:4]))
            gate.set()
            for t in dts:
                assert np.array_equal(t.result(60), prompt)  # a host array
        finally:
            gate.set()
            fe.close()

    def test_pause_quiesce_rebind_resume(self):
        kv, keys = _store(seed=0)
        kv2, _ = _store(seed=0)
        kv2.wait(kv2.push(kv2.request(channel=0), keys=keys[:4],
                          values=np.ones((4, 1), np.float32)))
        fe = ServeFrontend(kv, ServeConfig(replica="full", workers=2)).start()
        try:
            fe.pause()
            queued = [fe.submit(PullRequest(keys=keys[:4])) for _ in range(3)]
            fe.quiesce(timeout=10)
            fe.rebind(kv2)
            fe.resume()
            for t in queued:  # queued across the pause: served by the new store
                assert np.array_equal(t.result(30), kv2.values(0, keys[:4]))
        finally:
            fe.close()

    def test_door_checks(self):
        kv, keys = _store()

        def flushers():
            return sum(t.name == "serve-coalescer" for t in threading.enumerate())

        before = flushers()
        with pytest.raises(ValueError, match="hot_keys"):
            ServeFrontend(kv, ServeConfig(replica="hot"))
        with pytest.raises(ValueError, match="'off'"):
            ServeFrontend(kv, ServeConfig(replica="bogus"))
        assert flushers() == before  # a config error leaks no thread
        fe = ServeFrontend(kv, ServeConfig(replica="full")).start()
        try:
            with pytest.raises(ValueError, match="channel"):
                fe.submit(PullRequest(keys=keys[:4], channel=1))
            with pytest.raises(ValueError, match="decode_fn"):
                fe.submit(DecodeRequest(prompt=np.zeros((1, 4), np.int64), steps=4))
            with pytest.raises(ValueError, match="not both"):
                ServeFrontend(kv, decode_fn=lambda r: r, batcher=object())
        finally:
            fe.close()


class TestDegraded:
    def _fe(self, **kw):
        kv, keys = _store()
        return kv, ServeFrontend(kv, ServeConfig(workers=1, max_queue_depth=64, **kw)).start()

    def test_dead_store_degrades_to_stale_replica(self):
        kv, fe = self._fe(replica="fallback", degraded_max_staleness_s=60.0)
        try:
            keys = np.array([2, 3], np.int64)
            fresh = fe.submit(PullRequest(keys=keys)).result(30)
            with faults.scoped("serve.pull", kind="raise"):
                stale = fe.submit(PullRequest(keys=keys)).result(30)
            assert np.array_equal(stale, fresh) and fe.stats()["degraded_served"] == 1
        finally:
            fe.close()

    def test_staleness_bound_and_no_replica_are_503s(self):
        for kw, reason in ((dict(replica="fallback", degraded_max_staleness_s=-1.0), "stale"),
                           (dict(replica="off"), "no-replica")):
            kv, fe = self._fe(**kw)
            try:
                with faults.scoped("serve.pull", kind="raise"):
                    with pytest.raises(DegradedError) as ei:
                        fe.submit(PullRequest(keys=np.array([1], np.int64))).result(30)
                assert ei.value.reason == reason
            finally:
                fe.close()

    def test_hot_replica_miss_with_dead_store(self):
        kv, fe = self._fe(replica="hot", hot_keys=np.arange(8, dtype=np.int64))
        try:
            with faults.scoped("serve.pull", kind="raise"):
                out = fe.submit(PullRequest(keys=np.array([1, 2], np.int64))).result(30)
                assert out.shape == (2, 1)  # fully hot: the replica serves
                with pytest.raises(DegradedError) as ei:
                    fe.submit(PullRequest(keys=np.array([1, 40], np.int64))).result(30)
            assert ei.value.reason == "replica-miss"
        finally:
            fe.close()

    def test_shed_stays_a_429_while_the_store_is_dead(self):
        kv, fe = self._fe(replica="fallback", coalesce_window_s=0.05)
        fe.cfg.max_queue_depth = 1
        try:
            with faults.scoped("serve.pull", kind="stall", delay_s=0.2):
                first = fe.submit(PullRequest(keys=np.array([1], np.int64)))
                with pytest.raises(RejectedError) as ei:
                    for _ in range(8):
                        fe.submit(PullRequest(keys=np.array([2], np.int64)))
                assert ei.value.reason == "queue"
                first.result(30)
        finally:
            fe.close()

    def test_device_replica_over_host_budget_serves_with_zero_degraded(self):
        kv, keys = _store()
        budget = ReadReplica(kv).nbytes() // 2
        fe = ServeFrontend(kv, ServeConfig(replica="full", workers=2, replica_device=True,
                                           replica_host_budget_bytes=budget,
                                           replica_refresh_s=0.02)).start()
        try:
            for i in range(40):
                kv.push(kv.request(channel=0), keys=keys[:16], values=np.ones((16, 1), np.float32))
                got = fe.submit(PullRequest(keys=keys[:16])).result(30)
                assert got.shape == (16, 1) and np.isfinite(got).all()
            assert fe.degraded_served == 0 and fe.stats()["replica"]["device"] is True
        finally:
            fe.close()


class TestLoadgen:
    def test_record_keys_equal_jax(self, mesh1):
        jkv, kv, keys = _jax_pair(mesh1)
        fe = ServeFrontend(kv, ServeConfig(replica="full", workers=2)).start()
        jfe = JServeFrontend(jkv, JServeConfig(replica="full", workers=2)).start()
        try:
            rec = open_loop_bench(fe, lambda i: PullRequest(keys=keys[i % 32: i % 32 + 8]),
                                  rate=200, duration_s=0.3, seed=3, warmup_requests=3)
            jrec = j_open_loop_bench(jfe, lambda i: JPullRequest(keys=keys[i % 32: i % 32 + 8]),
                                     rate=200, duration_s=0.3, seed=3, warmup_requests=3)
        finally:
            fe.close()
            jfe.close()
        assert list(rec) == list(jrec) and list(rec["latency_ms"]) == list(jrec["latency_ms"])
        assert rec["n_errors"] == 0 and rec["completed"] == rec["accepted"]
        lat = rec["latency_ms"]
        assert lat["p50_ms"] <= lat["p99_ms"] <= lat["max_ms"] + 1e-9

    def test_collector_reports_server_errors_instead_of_raising(self):
        kv, keys = _store()
        fe = ServeFrontend(kv, ServeConfig(replica="off")).start()

        def bad_pull(task, keys=None, **kw):
            raise OSError("shard gone")

        kv.pull = bad_pull
        try:
            rec = open_loop_bench(fe, lambda i: PullRequest(keys=keys[:4]), rate=50,
                                  duration_s=0.3, seed=4)
        finally:
            fe.close()
        assert rec["n_errors"] == rec["accepted"] > 0 and rec["errors"]
