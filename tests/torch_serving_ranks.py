"""Rank functions of the port's serving-plane tests on a mesh: each runs in
every process of a gloo world of CPU ranks that
``parallel.launch.run_world`` starts (``tests/test_torch_serving_mesh.py``).
Imports the port only (no JAX: the ranks never load it).

Every rank runs every case in the same order. A case builds its store
on the case's mesh and a ``parallel.sequence.Order`` of it on every
rank; rank 0 runs the JAX test's body against the order (the frontend
cases each through a frontend over one order), closes it, and every
other rank follows it. Rank 0 returns
what the body saw (or the traceback of a case that raised); every rank
returns a digest of its shard of each case's table at the end, so the
test holds the ranks of each server column equal.
"""

import hashlib
import threading
import time
import traceback

import numpy as np
import torch

from parameter_server_tpu_torch.models.speculative import speculative_generate
from parameter_server_tpu_torch.models.transformer import LMConfig, init_lm, lm_generate
from parameter_server_tpu_torch.parallel import mesh as meshlib
from parameter_server_tpu_torch.parallel import sequence
from parameter_server_tpu_torch.parameter.kv_vector import KVVector
from parameter_server_tpu_torch.serving import (
    DecodeRequest,
    DegradedError,
    PredictRequest,
    PullCoalescer,
    PullRequest,
    ReadReplica,
    RejectedError,
    ServeConfig,
    ServeFrontend,
    open_loop_bench,
)
from parameter_server_tpu_torch.system import faults
from parameter_server_tpu_torch.system.elastic import ElasticCoordinator
from parameter_server_tpu_torch.system.postoffice import Postoffice

TCFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)
DCFG = dict(vocab=64, d_model=16, n_heads=1, n_layers=1, d_ff=32)
RESIZE_SLOTS = 1000  # non-pow2: the padding changes with the server count


def warm(seed=0, n_keys=512, key_space=1 << 20, k=1):
    """The JAX tests' ``_store`` push: its keys and values."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, key_space, n_keys))
    vals = rng.normal(size=(len(keys), k)).astype(np.float32)
    return keys, vals


def _store(mesh, num_slots=1 << 12, name="serve_test"):
    """The JAX tests' ``_store`` on ``mesh`` (None on a rank it leaves
    idle), filled from this thread on every rank."""
    keys, vals = warm()
    if not mesh.active:
        return None, keys
    kv = KVVector(mesh=mesh, k=1, num_slots=num_slots, hashed=True, name=name)
    kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
    return kv, keys


def _digest(kv) -> str:
    if kv is None:
        return ""
    kv.executor.wait_all(pop=False)
    return hashlib.blake2b(kv.table(0).cpu().numpy().tobytes(), digest_size=8).hexdigest()


def _count(name: str) -> float:
    snap = Postoffice.instance().metrics.snapshot()
    return sum(snap.get(name, {}).get("values", {}).values())


def _stream(store, keys, seconds, body):
    """Pushes of ones into ``keys[:64]`` from a thread for ``seconds``
    while ``body()`` runs on this one; returns the pusher's errors."""
    stop = threading.Event()
    errs = []

    def pusher():
        try:
            while not stop.is_set():
                store.wait(store.push(store.request(channel=0), keys=keys[:64],
                                      values=np.ones((64, 1), np.float32)))
        except BaseException as e:  # noqa: BLE001 — returned to the test
            errs.append(repr(e))

    t = threading.Thread(target=pusher)
    t.start()
    deadline = time.monotonic() + seconds
    n = 0
    try:
        while time.monotonic() < deadline:
            body()
            n += 1
    finally:
        stop.set()
        t.join(timeout=60)
    return errs, n


# -- TestCoalescer --


def coalescer_concurrent(order, keys):
    co = PullCoalescer(order, window_s=0.005, max_requests=64)
    rng = np.random.default_rng(1)
    reqs = [rng.choice(keys, 24, replace=True) for _ in range(24)]
    results = [None] * len(reqs)
    errors = []

    def client(j):
        try:
            results[j] = co.pull(reqs[j]).result(timeout=30)
        except BaseException as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(j,)) for j in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    direct = [order.values(0, r) for r in reqs]
    co.close()
    return dict(reqs=reqs, results=results, direct=direct, errors=errors, stats=co.stats())


def coalescer_duplicates(order, keys):
    co = PullCoalescer(order, window_s=0.001)
    req = np.array([keys[3], keys[3], keys[5], keys[3]])
    got = co.pull(req).result(timeout=30)
    co.close()
    return dict(req=req, got=got, want=order.values(0, req))


def coalescer_failure(order, keys):
    kv = order.store

    def bad_pull(task, keys=None, **kw):
        raise RuntimeError("table on fire")

    kv.pull = bad_pull
    try:
        co = PullCoalescer(order, window_s=0.001)
        t1 = co.pull(keys[:4])
        t2 = co.pull(keys[4:8])
        errs = []
        for t in (t1, t2):
            try:
                t.result(timeout=30)
                errs.append(None)
            except RuntimeError as e:
                errs.append(str(e))
        co.close()
    finally:
        del kv.pull
    return dict(errors=errs, calls_published=order.calls)


def coalescer_close(order, keys):
    co = PullCoalescer(order, window_s=30.0)
    ticket = co.pull(keys[:8])
    co.close()
    got = ticket.result(timeout=30)
    try:
        co.pull(keys[:4])
        closed = None
    except RuntimeError as e:
        closed = str(e)
    return dict(got=got, want=order.values(0, keys[:8]), closed=closed)


# -- TestReadReplica --


def replica_snapshot(order, keys):
    rep = ReadReplica(order)
    before, hit = rep.pull(keys[:16])
    want_before = order.values(0, keys[:16])
    order.wait(order.push(order.request(channel=0), keys=keys[:16],
                          values=np.ones((16, 1), np.float32)))
    again, _ = rep.pull(keys[:16])
    v1 = rep.refresh()
    after, _ = rep.pull(keys[:16])
    return dict(before=before, hit=hit, want_before=want_before, again=again, v1=v1,
                after=after, nbytes=rep.nbytes())


def replica_push_stream(order, keys, device=False):
    rep = ReadReplica(order, device=device)
    bad = []

    def read():
        vals, hit = rep.pull(keys[:32])
        if not (hit.all() and vals.shape == (32, 1)):
            bad.append(vals.shape)
        rep.refresh()

    errs, n = _stream(order, keys, 0.5, read)
    return dict(push_errors=errs, reads=n, bad=bad, device_table=isinstance(rep._table,
                                                                             torch.Tensor))


def replica_hot(order, keys):
    hot = keys[:32]
    rep = ReadReplica(order, hot_keys=hot)
    full = ReadReplica(order)
    mixed = np.concatenate([hot[:4], keys[-4:]])
    vals, hit = rep.pull(mixed)
    return dict(hot_nbytes=rep.nbytes(), full_nbytes=full.nbytes(), hit=hit, vals=vals,
                want=order.values(0, hot[:4]))


def replica_miss_counter(order, keys):
    hot = keys[:32]
    rep = ReadReplica(order, hot_keys=hot)
    misses0 = _count("ps_serve_replica_misses_total")
    hits0 = _count("ps_serve_replica_hits_total")
    mixed = np.concatenate([hot[:3], keys[-5:]])
    _, hit = rep.pull(mixed)
    return dict(hit=hit, misses=_count("ps_serve_replica_misses_total") - misses0,
                hits=_count("ps_serve_replica_hits_total") - hits0)


def snapshot_serializes(order, keys):
    order.push(order.request(channel=0), keys=keys[:8], values=np.full((8, 1), 7.0, np.float32))
    snap = order.executor.wait(order.snapshot(0)).numpy()
    slots = order.channel(0).directory.slots(keys[:8])
    return dict(got=snap[slots], want=order.values(0, keys[:8]), rows=snap.shape[0],
                num_slots=order.num_slots)


# -- TestDeviceReplica --


def device_matches_host(order, keys):
    host = ReadReplica(order)
    dev = ReadReplica(order, device=True)
    out = dict(dev_tensor=isinstance(dev._table, torch.Tensor),
               host_numpy=isinstance(host._table, np.ndarray), widths={})
    for n in (1, 3, 8, 17, 100):
        vh, _ = host.pull(keys[:n])
        vd, hit = dev.pull(keys[:n])
        out["widths"][n] = (vh, vd, hit)
    hot = keys[:32]
    hh = ReadReplica(order, hot_keys=hot)
    hd = ReadReplica(order, hot_keys=hot, device=True)
    mixed = np.concatenate([hot[:5], keys[-3:]])
    out["hot"] = (hh.pull(mixed), hd.pull(mixed))
    out["want"] = order.values(0, keys[:100])
    return out


def frontend_build_fails(order, keys):
    """Rank 0's frontend raises at its build (decode_fn and batcher both
    given); the caller closes the order, so no follower is left waiting."""
    try:
        ServeFrontend(order, ServeConfig(replica="full"), decode_fn=lambda req: req.prompt,
                      batcher=object())
        raised = None
    except ValueError as e:
        raised = str(e)
    return dict(raised=raised, calls=order.calls)


def host_budget(order, keys):
    budget = ReadReplica(order).nbytes() // 2
    try:
        ReadReplica(order, host_budget_bytes=budget)
        refused = None
    except MemoryError as e:
        refused = str(e)
    dev = ReadReplica(order, device=True, host_budget_bytes=budget)
    vals, hit = dev.pull(keys[:8])
    return dict(refused=refused, vals=vals, hit=hit, want=order.values(0, keys[:8]),
                table_bytes=2 * budget)


# -- every rank: a case's order or frontend --


def _run_order_case(out, name, kv, keys, body):
    """``body(order, keys)`` on rank 0 against a bare order every rank
    built; every other rank follows it."""
    order = sequence.Order(kv, name=name)
    if not order.leader:
        order.follow()
        return
    try:
        out[name] = body(order, keys)
    except BaseException:  # noqa: BLE001 — the test reports it
        out[name] = {"error": traceback.format_exc()}
    finally:
        order.close()


def _run_frontend_case(out, name, order, cfg, body, **kw):
    """``body(fe)`` on rank 0 against a frontend over ``order`` (which
    stays open for the next case)."""
    fe = None
    try:
        fe = ServeFrontend(order, cfg, **kw).start()
        out[name] = body(fe)
    except BaseException:  # noqa: BLE001 — the test reports it
        out[name] = {"error": traceback.format_exc()}
    finally:
        if fe is not None:
            fe.close()


def _frontend_cases(out, kv, keys):
    """Every frontend case through one order of ``kv`` that every rank
    builds: rank 0 builds each case's frontend over it in turn and closes
    it after the last, and the other ranks follow it."""
    order = sequence.Order(kv, name="frontend")
    if not order.leader:
        order.follow()
        return
    try:
        _lead_frontend_cases(out, order, keys)
    finally:
        order.close()


def _lead_frontend_cases(out, order, keys):
    cases = []

    def pull_predict(fe):
        got = fe.submit(PullRequest(keys=keys[:12])).result(30)
        pr = PredictRequest(indices=keys[:6], indptr=np.array([0, 2, 6]))
        scores = fe.submit(pr).result(30)
        snap = Postoffice.instance().metrics.snapshot()
        return dict(got=got, want=fe.store.values(0, keys[:12]), scores=scores,
                    w=fe.store.values(0, keys[:6]).ravel(),
                    telemetry=bool(snap["ps_serve_requests_total"]["values"]
                                   and snap["ps_serve_latency_seconds"]["values"]),
                    fe=fe)
    cases.append(("frontend_pull_predict", ServeConfig(replica="full", workers=2), pull_predict,
                  {}))

    def hot_fallthrough(fe):
        mixed = np.concatenate([keys[:8], keys[-8:]])
        got = fe.submit(PullRequest(keys=mixed)).result(30)
        return dict(got=got, want=fe.store.values(0, mixed),
                    live=fe.coalescer.stats()["requests"])
    cases.append(("frontend_hot_fallthrough",
                  ServeConfig(replica="hot", hot_keys=keys[:32], coalesce_window_s=0.001,
                              workers=2), hot_fallthrough, {}))

    def live_missed(fe):
        seen = []
        orig = fe._live_pull

        def spy(ks):
            seen.append(np.asarray(ks).copy())
            return orig(ks)

        fe._live_pull = spy
        mixed = np.concatenate([keys[:4], keys[-6:]])
        got = fe.submit(PullRequest(keys=mixed)).result(30)
        return dict(got=got, want=fe.store.values(0, mixed), seen=seen, cold=keys[-6:])
    cases.append(("live_pull_missed_keys",
                  ServeConfig(replica="hot", hot_keys=keys[:32], coalesce_window_s=0.001,
                              workers=1), live_missed, {}))

    def shed(fe):
        shed = ok = 0
        reasons = set()
        for _ in range(100):
            try:
                fe.submit(PullRequest(keys=keys[:4]))
                ok += 1
            except RejectedError as e:
                reasons.add(e.reason)
                shed += 1
        snap = Postoffice.instance().metrics.snapshot()
        return dict(shed=shed, ok=ok, reasons=sorted(reasons),
                    counted=sum(snap["ps_serve_shed_total"]["values"].values()))
    cases.append(("frontend_shed", ServeConfig(replica="full", workers=1, admission_rate=20,
                                               admission_burst=2, max_queue_depth=4),
                  shed, {}))

    tparams = init_lm(0, LMConfig(**TCFG), "cpu")
    dparams = init_lm(1, LMConfig(**DCFG), "cpu")

    def decode_fn(req):
        with torch.no_grad():
            return speculative_generate(tparams, LMConfig(**TCFG), dparams, LMConfig(**DCFG),
                                        req.prompt, req.steps, gamma=2)

    def decode(fe):
        prompt = np.random.default_rng(2).integers(0, 64, (2, 8)).astype(np.int32)
        served = fe.submit(DecodeRequest(prompt=prompt, steps=8)).result(300)
        with torch.no_grad():
            plain = lm_generate(tparams, torch.from_numpy(prompt).long(), LMConfig(**TCFG),
                                steps=8)
        return dict(served=np.asarray(served), plain=np.asarray(plain))
    cases.append(("frontend_decode", ServeConfig(replica="full", workers=1), decode,
                  dict(decode_fn=decode_fn)))

    gate = threading.Event()

    def slow_decode(req):
        gate.wait(30)
        return req.prompt

    def decode_backlog(fe):
        prompt = np.zeros((1, 4), np.int32)
        try:
            dts = [fe.submit(DecodeRequest(prompt=prompt, steps=4)) for _ in range(2)]
            try:
                fe.submit(DecodeRequest(prompt=prompt, steps=4))
                reason = None
            except RejectedError as e:
                reason = e.reason
            got = fe.submit(PullRequest(keys=keys[:4])).result(30)
            gate.set()
            decoded = [t.result(60) for t in dts]
        finally:
            gate.set()
        return dict(reason=reason, got=got, want=fe.store.values(0, keys[:4]),
                    decoded=decoded)
    cases.append(("decode_backlog", ServeConfig(replica="full", workers=1, max_queue_depth=2),
                  decode_backlog, dict(decode_fn=slow_decode)))

    def pull_backlog(fe):
        fe.pause()
        try:
            pts = [fe.submit(PullRequest(keys=keys[:4])) for _ in range(2)]
            try:
                fe.submit(PullRequest(keys=keys[:4]))
                reason = None
            except RejectedError as e:
                reason = e.reason
            dt = fe.submit(DecodeRequest(prompt=np.zeros((1, 4), np.int32), steps=4))
        finally:
            fe.resume()
        return dict(reason=reason, decoded=dt.result(60), pulled=[t.result(60) for t in pts],
                    want=fe.store.values(0, keys[:4]))
    cases.append(("pull_backlog", ServeConfig(replica="full", workers=1, max_queue_depth=2),
                  pull_backlog, dict(decode_fn=lambda req: req.prompt)))

    def depth_bound(fe):
        accepted = []
        fe.pause()
        try:
            def hammer():
                n = 0
                for _ in range(50):
                    try:
                        fe.submit(PullRequest(keys=keys[:4]))
                        n += 1
                    except RejectedError:
                        pass
                accepted.append(n)

            threads = [threading.Thread(target=hammer) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            depth = fe.depth()
        finally:
            fe.resume()
        return dict(accepted=sum(accepted), depth=depth)
    cases.append(("depth_bound", ServeConfig(replica="full", workers=1, max_queue_depth=16),
                  depth_bound, {}))

    def door(fe):
        msgs = []
        for req in (PullRequest(keys=keys[:4], channel=1),
                    PredictRequest(indices=keys[:4], indptr=np.array([0, 4]), channel=2),
                    DecodeRequest(prompt=np.zeros((1, 4), np.int32), steps=4)):
            try:
                fe.submit(req)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        return dict(messages=msgs)
    cases.append(("door_checks", ServeConfig(replica="full"), door, {}))

    def device_zero_degraded(fe):
        deadline = time.monotonic() + 0.5
        served = wrong = 0
        while time.monotonic() < deadline:
            got = fe.submit(PullRequest(keys=keys[:16])).result(30)
            wrong += int(not np.array_equal(got, fe.store.values(0, keys[:16])))
            served += 1
        snap = Postoffice.instance().metrics.snapshot()
        degraded = sum(snap.get("ps_serve_degraded_total", {}).get("values", {}).values())
        return dict(served=served, wrong=wrong, degraded_served=fe.degraded_served,
                    degraded=degraded, device=fe.stats()["replica"]["device"],
                    replica_device=fe.replica.device)
    budget = 4096 * 4 // 2  # half the whole table's bytes
    cases.append(("device_frontend_zero_degraded",
                  ServeConfig(replica="full", workers=2, replica_device=True,
                              replica_host_budget_bytes=budget, replica_refresh_s=0.02),
                  device_zero_degraded, {}))

    def loadgen(fe):
        rec = open_loop_bench(fe, lambda i: PullRequest(keys=keys[i % 32: i % 32 + 8]),
                              rate=200, duration_s=0.5, seed=3, warmup_requests=3)
        return dict(rec=rec)
    cases.append(("loadgen_point", ServeConfig(replica="full", workers=2), loadgen, {}))

    def pull_fault(fe):
        faults.arm("serve.pull", kind="raise", once=True)
        try:
            fe.submit(PullRequest(keys=keys[:4])).result(30)
            first = None
        except DegradedError as e:
            first = e.reason
        got = fe.submit(PullRequest(keys=keys[:4])).result(30)
        return dict(first=first, got=got, want=fe.store.values(0, keys[:4]),
                    calls=fe.order.calls)
    cases.append(("serve_pull_fault", ServeConfig(replica="off", workers=1,
                                                  coalesce_window_s=0.001),
                  pull_fault, {}))

    def deadline(fe):
        got = fe.submit(PullRequest(keys=keys[:4])).result(30)
        return dict(got=got, want=fe.store.values(0, keys[:4]),
                    degraded_served=fe.degraded_served)
    cases.append(("live_pull_deadline",
                  ServeConfig(replica="fallback", workers=1, coalesce_window_s=5.0,
                              live_pull_deadline_s=0.05), deadline, {}))

    for name, cfg, body, kw in cases:
        _run_frontend_case(out, name, order, cfg, body, **kw)
        faults.reset()
        if name == "frontend_pull_predict" and "fe" in out.get(name, {}):
            fe = out[name].pop("fe")
            try:
                fe.submit(PullRequest(keys=keys[:2]))
                out[name]["closed"] = None
            except RuntimeError as e:
                out[name]["closed"] = str(e)

    # a config error raises before the frontend starts a thread
    def flushers():
        return sum(t.name == "serve-coalescer" for t in threading.enumerate())

    before = flushers()
    errs = []
    for cfg in (ServeConfig(replica="hot"), ServeConfig(replica="bogus")):
        try:
            ServeFrontend(order, cfg)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    out["bad_replica_config"] = dict(errors=errs, leaked=flushers() - before)


def _order_disagreement(mesh, out):
    """Rank 1 folds a call rank 0 never made: every rank raises at close."""
    kv, keys = _store(mesh, name="disagree")
    order = sequence.Order(kv, name="disagree")
    raised = None
    try:
        if order.leader:
            order.values(0, keys[:4])
            order.close()
        else:
            if order.rank == 1:
                order.digest = 12345
            order.follow()
    except sequence.OrderError as e:
        raised = str(e)
    if kv is not None:
        kv.executor.stop()
    out["disagreement"] = raised


def _full_replica_1x2(out):
    """A full replica over a 1x2 mesh serves the keys of both shards."""
    mesh = meshlib.make_mesh(1, 2, device="cpu")
    kv, keys = _store(mesh, name="one_by_two")
    order = sequence.Order(kv, name="one_by_two")
    if order.leader:
        try:
            rep = ReadReplica(order)
            vals, hit = rep.pull(keys)
            slots = kv.channel(0).directory.slots(keys)
            out["full_1x2"] = dict(vals=vals, hit=hit, want=order.values(0, keys), slots=slots,
                                   shard_rows=kv.shard_rows, rows=rep._table.shape[0])
        except BaseException:  # noqa: BLE001
            out["full_1x2"] = {"error": traceback.format_exc()}
        finally:
            order.close()
    else:
        order.follow()
    if kv is not None:
        kv.executor.stop()


# -- TestServeAcrossElasticResize --


class ServeWorker:
    """The JAX test's minimal elastic worker: a hashed ``KVVector`` and
    the state hooks the coordinator drives (the configured modulus keeps
    every key's slot across server counts)."""

    def __init__(self, mesh):
        self.kv = KVVector(mesh=mesh, k=1, num_slots=RESIZE_SLOTS, hashed=True,
                           name="elastic_serve")
        self.executor = self.kv.executor
        self.num_slots = self.kv.num_slots

    def state_host(self):
        self.kv.executor.wait_all(pop=False)
        return {"state": {"table": self.kv.table(0).cpu().numpy().copy()},
                "seed_counter": np.int64(0)}

    def load_state_host(self, snap):
        self.kv.table(0).copy_(torch.from_numpy(snap["state"]["table"]))

    def recover_server_shard(self, rank):
        return False


def _serve_across_resize(co, order, keys, vals):
    """Rank 0: the JAX test's traffic through a frontend over ``order``,
    paused, resized to 2x3, rebound and resumed."""
    fe = ServeFrontend(order, ServeConfig(replica="full", workers=2, max_queue_depth=64,
                                          replica_refresh_s=0.01))
    expect = order.values(0, keys)
    fe.start()
    stop = threading.Event()
    outcomes = {"ok": 0, "shed": 0, "wrong": 0}
    errors = []

    def traffic():
        i = 0
        while not stop.is_set():
            lo = i % (len(keys) - 16)
            try:
                got = fe.submit(PullRequest(keys=keys[lo:lo + 16])).result(timeout=60)
                outcomes["ok" if np.array_equal(got, expect[lo:lo + 16]) else "wrong"] += 1
            except RejectedError:
                outcomes["shed"] += 1
            except BaseException:  # noqa: BLE001 — the contract is none
                errors.append(traceback.format_exc())
                return
            i += 1

    threads = [threading.Thread(target=traffic) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.15)
        before = dict(outcomes)
        fe.pause()
        fe.quiesce()
        w = co.resize(num_server=3)
        fe.rebind(w.kv)
        fe.resume()
        time.sleep(0.25)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        fe.close()
    return dict(before=before, outcomes=outcomes, errors=errors, expect=expect,
                after=order.values(0, keys), history=co.resize_history,
                shard_rows=w.kv.shard_rows, pushed=(keys, vals))


def _resize_case(out):
    """2x2 -> 2x3 under traffic (every rank of the world runs the
    coordinator and builds the order; the other ranks follow rank 0's,
    the idle ones only counting its calls)."""
    Postoffice.reset()
    co = ElasticCoordinator(ServeWorker, num_data=2, num_server=2)
    w = co.start()
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 16, 256))
    vals = rng.normal(size=(len(keys), 1)).astype(np.float32)
    kv = None if w is None else w.kv
    if kv is not None:
        kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
    order = sequence.Order(kv, name="resize")
    co.serve_in(order)
    if order.leader:
        try:
            out["resize"] = _serve_across_resize(co, order, keys, vals)
        except BaseException:  # noqa: BLE001 — the test reports it
            out["resize"] = {"error": traceback.format_exc()}
        finally:
            order.close()
    else:
        order.follow()
    worker = co.worker
    digest = _digest(None if worker is None else worker.kv)
    coords = Postoffice.instance().mesh.coords
    if worker is not None:
        worker.executor.stop()
    Postoffice.reset()
    return digest, coords


def serving_world():
    """Every case of ``tests/test_torch_serving_mesh.py`` on this rank:
    rank 0's observations, and every rank's shard digests."""
    torch.set_num_threads(1)
    Postoffice.reset()
    faults.reset()
    out = {}
    digests = {}
    mesh = meshlib.make_mesh(4, 2, device="cpu")
    for name, body in (("coalescer_concurrent", coalescer_concurrent),
                       ("coalescer_duplicates", coalescer_duplicates),
                       ("coalescer_failure", coalescer_failure),
                       ("coalescer_close", coalescer_close),
                       ("replica_snapshot", replica_snapshot),
                       ("replica_push_stream", replica_push_stream),
                       ("replica_hot", replica_hot),
                       ("replica_miss_counter", replica_miss_counter),
                       ("snapshot_serializes", snapshot_serializes),
                       ("device_matches_host", device_matches_host),
                       ("device_push_stream",
                        lambda o, k: replica_push_stream(o, k, device=True)),
                       ("host_budget", host_budget),
                       ("frontend_build_fails", frontend_build_fails)):
        Postoffice.reset()
        kv, keys = _store(mesh)
        _run_order_case(out, name, kv, keys, body)
        digests[name] = _digest(kv)
        kv.executor.stop()
    Postoffice.reset()
    kv, keys = _store(mesh)
    _frontend_cases(out, kv, keys)
    digests["frontend"] = _digest(kv)
    kv.executor.stop()
    Postoffice.reset()
    _order_disagreement(mesh, out)
    _full_replica_1x2(out)
    digests["resize"], resize_coords = _resize_case(out)
    rank = mesh.rank
    return dict(rank=rank, coords=mesh.coords, resize_coords=resize_coords, digests=digests,
                disagreement=out.pop("disagreement"), cases=out if rank == 0 else None)


# -- the component suite's mesh probes --


def suite_rank(names, smoke=True):
    """The component suite's ``names`` on this rank of a world (each from
    a reset process state, as ``python -m ...benchmarks`` runs them):
    this rank's records and the metric lines it printed, keyed by name."""
    from parameter_server_tpu_torch.benchmarks import REGISTRY
    from parameter_server_tpu_torch.benchmarks.__main__ import reset_process_state

    import contextlib
    import io
    import json

    torch.set_num_threads(1)
    out, lines = {}, {}
    for name in names:
        reset_process_state()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out[name] = REGISTRY[name](smoke, device="cpu")
        lines[name] = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    reset_process_state()
    return out, lines
