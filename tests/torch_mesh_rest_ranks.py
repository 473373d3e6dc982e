"""Rank functions of the port's tests of the linear app's and the ps.h
layer's last mesh features (the KKT filter, adaptive τ, the encoded
exact wire, ``checkpoint_async``, darlin, model evaluation and
``ps.run_system``): each runs in every process of a gloo world of CPU
ranks that ``parallel.launch.run_world`` starts and returns plain numpy
results for the test process to hold against the JAX package. Imports
the port only (the ranks never load JAX).
"""

import os
import zipfile

import numpy as np
import torch

from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.parallel import mesh as meshlib
from parameter_server_tpu_torch.parameter.replica import CheckpointManager
from parameter_server_tpu_torch.system.postoffice import Postoffice

MB, SLOTS = 64, 1 << 9


def conf(tau=3, **sgd):
    """``tests/test_consistency.py``'s conf: FTRL, λ1 0.1, a 2^9-slot
    table, 64-row minibatches."""
    c = tcfg.Config()
    c.penalty = tcfg.PenaltyConfig(type="l1", lambda_=[0.1])
    c.learning_rate = tcfg.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = tcfg.SGDConfig(**dict(dict(algo="ftrl", minibatch=MB, num_slots=SLOTS,
                                             max_delay=tau), **sgd))
    return c


def _state(w):
    return {k: np.asarray(v).copy() for k, v in w.state_host()["state"].items()}


def _tracker_rec(w):
    tr = w._consistency.tracker if w._consistency is not None else None
    if tr is None:
        return None
    return {"dropped": sorted(tr._dropped), "stamp": tr.stamp(), "summary": tr.summary()}


def _objectives(w):
    return [float(x) for x in w.progress.objective]


# -- the cases of one world: each builds its own mesh, a prefix of it --


def kkt_serial(w, batches):
    """Each batch submitted and collected before the next (the drop set
    after every collect); the state, the counts and the objectives."""
    per = []
    for b in batches:
        w.collect(w.process_minibatch(b))
        per.append(_tracker_rec(w))
    return {"per_collect": per, "tracker": _tracker_rec(w)}


def kkt_train(w, batches, pipelined):
    """``train`` over the batches, serial or pipelined."""
    w.train(iter(batches), pipelined=pipelined)
    return {"tracker": _tracker_rec(w)}


def tau_widen(w, batches, stable_steps):
    ctl = w._consistency.controller
    ctl.stable_steps = stable_steps
    w.train(iter(batches))
    st = w._learning.staleness_summary() if w._learning is not None else None
    return {"tau_trace": list(ctl.tau_trace), "staleness": st}


def tau_spike(w):
    """The controller alone: τ at 4, ten healthy collects, then a
    gradient norm 50 times their median."""
    ctl = w._consistency.controller
    ctl._set_tau(4, "widen")
    for _ in range(10):
        ctl.on_metrics(0.5, 1.0, False)
    alpha = float(w.lr.alpha)
    ctl.on_metrics(0.5, 50.0, False)
    return {"tau": ctl.tau, "alpha_kept": float(w.lr.alpha) == alpha,
            "episodes": list(ctl.episodes)}


def tau_react(w, first, second, after, asker):
    """Train ``first`` and ``second``, then only rank ``asker`` asks for a
    reaction (``react`` on a mesh is a request); the next launch, one
    batch of ``after``, is submitted and collected: at that collect every
    rank reacts. Then the rest of ``after`` trains."""
    ctl = w._consistency.controller
    w.train(iter(first))
    snap = {k: np.asarray(v).copy() for k, v in ctl._snapshot["state"].items()}
    alpha = float(w.lr.alpha)
    w.train(iter(second))
    moved = _state(w)
    asked = w._consistency.react("test") if w.mesh.rank == asker else "not asked"
    episodes_before = list(ctl.episodes)
    w.collect(w.process_minibatch(after[0]))
    restored = _state(w)
    out = {"asked": asked, "episodes_before": episodes_before, "episodes": list(ctl.episodes),
           "alpha_ratio": float(w.lr.alpha) / alpha, "tau": ctl.tau,
           "moved_differs": any(not np.array_equal(moved[k], snap[k]) for k in snap),
           "restored_is_snapshot": all(np.array_equal(restored[k].view(np.uint8),
                                                      snap[k].view(np.uint8)) for k in snap)}
    w.train(iter(after[1:]))
    out["tau_trace"] = list(ctl.tau_trace)
    return out


def tau_nonfinite(w, before, bad, after):
    w.train(iter(before))
    w.train(iter([bad]))
    ctl = w._consistency.controller
    episodes = [dict(e) for e in ctl.episodes]
    w.train(iter(after))
    return {"episodes": episodes, "tau_trace": list(ctl.tau_trace),
            "objective_finite": bool(np.isfinite(_objectives(w)[-3:]).all())}


def encoded_vs_raw(mesh, batches, steps):
    """The same batches on the raw and on the encoded exact wire
    (``steps`` > 1: ``submit_superbatch`` launches): states and metrics."""
    out = {}
    for name, enc in (("raw", ""), ("encoded", "exact")):
        w = tsgd.AsyncSGDWorker(conf(0, update="sparse", wire_encode=enc, steps_per_launch=steps),
                                mesh=mesh)
        try:
            metrics = []
            for lo in range(0, len(batches), steps):
                group = batches[lo:lo + steps]
                m = (w.submit_superbatch(group, with_aux=True) if steps > 1
                     else w.wait(w.process_minibatch(group[0])))
                metrics.append({k: v.numpy().copy() for k, v in m.items()})
            out[name] = {"state": _state(w), "metrics": metrics,
                         "kinds": sorted({type(p).__name__ for p in
                                          (w.prep(b, device_put=False) for b in batches)})}
        finally:
            w.remove()
    return out


def encoded_pipelined(mesh, batches, steps):
    """Pipelined ``train`` with the upload cache: the encoded wire over
    one pass of the batches, and over two passes in one ``train``
    (the cache lives for a ``train``), against the raw wire's two
    passes: the states, and each encoded run's cache hits and misses."""
    out = {}
    for name, enc, passes in (("raw", "", 2), ("encoded1", "exact", 1), ("encoded", "exact", 2)):
        w = tsgd.AsyncSGDWorker(conf(0, update="sparse", wire_encode=enc, steps_per_launch=steps,
                                     wire_cache_mb=16 if enc else 0), mesh=mesh)
        try:
            w.train(iter(list(batches) * passes), pipelined=True)
            cache = w.upload_cache
            out[name] = {"state": _state(w),
                         "hits": None if cache is None else (cache.hits, cache.misses)}
        finally:
            w.remove()
    return out


def _npz_members(path):
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def checkpoint_async_case(mesh, batches, tmp):
    """Train 3 batches, ``checkpoint_async`` into one directory and
    ``checkpoint`` into another; a fresh worker restores the async one
    and trains the rest, against the unbroken worker's rest."""
    c = conf(0, update="sparse")
    w = tsgd.AsyncSGDWorker(c, mesh=mesh)
    d_async, d_sync = os.path.join(tmp, "async"), os.path.join(tmp, "sync")
    m_async, m_sync = CheckpointManager(d_async), CheckpointManager(d_sync)
    try:
        w.train(iter(batches[:3]))
        p_async = w.checkpoint_async(m_async, 3)
        p_sync = w.checkpoint(m_sync, 3)
        w.train(iter(batches[3:]))
        unbroken = _state(w)
    finally:
        w.remove()
    fresh = tsgd.AsyncSGDWorker(c, mesh=mesh)
    try:
        step = fresh.restore(m_async)
        fresh.train(iter(batches[3:]))
        resumed = _state(fresh)
    finally:
        fresh.remove()
    out = {"step": step, "unbroken": unbroken, "resumed": resumed}
    if mesh.rank == 0:
        m_async.wait()
        out["async_members"] = _npz_members(p_async)
        out["sync_members"] = _npz_members(p_sync)
    return out


def linear_cases(cases):
    """Every case ``(kind, num_data, num_server, conf kwargs, args)`` on a
    mesh of that shape (a prefix of the world; None on the idle ranks).
    Each result carries the rank's coordinates, its shard of the state
    and the per-launch objectives."""
    results = []
    for kind, d, s, kw, args in cases:
        mesh = meshlib.make_mesh(d, s, device="cpu")
        if not mesh.active:
            results.append(None)
            continue
        Postoffice.reset()
        if kind in ("encoded_vs_raw", "encoded_pipelined", "checkpoint_async", "disagree"):
            fn = {"encoded_vs_raw": encoded_vs_raw, "encoded_pipelined": encoded_pipelined,
                  "checkpoint_async": checkpoint_async_case,
                  "disagree": disagreeing_drop_set}[kind]
            rec = {"result": fn(mesh, *args)}
        else:
            w = tsgd.AsyncSGDWorker(conf(**kw), mesh=mesh, name=f"w_{kind}")
            try:
                rec = {"kkt_serial": kkt_serial, "kkt_train": kkt_train, "tau_widen": tau_widen,
                       "tau_spike": tau_spike, "tau_react": tau_react,
                       "tau_nonfinite": tau_nonfinite}[kind](w, *args)
                rec["state"] = _state(w)
                rec["objective"] = _objectives(w)
            finally:
                w.remove()
        rec["coords"] = mesh.coords
        results.append(rec)
        Postoffice.reset()
    return results


def disagreeing_drop_set(mesh, batches):
    """A mesh whose last rank drops one more slot than the others before
    the fourth batch: that launch's agreement raises on every rank (the
    error's text comes back)."""
    w = tsgd.AsyncSGDWorker(conf(0, update="sparse", kkt_filter=True, kkt_margin=1e9,
                                 kkt_escape=0.0, kkt_drop_after=2, kkt_revisit_every=100,
                                 ingest_workers=1), mesh=mesh)
    try:
        for b in batches[:3]:
            w.collect(w.process_minibatch(b))
        tr = w._consistency.tracker
        if mesh.rank == mesh.size - 1:
            # the feedback of a slot none of the batches holds, seen as
            # suppressed twice: a drop set only this rank holds
            extra = np.asarray([SLOTS - 1], np.int32)
            tr._note_feedback(extra, np.zeros(1, bool))
            tr._note_feedback(extra, np.zeros(1, bool))
        try:
            w.collect(w.process_minibatch(batches[3]))
            return "no error"
        except ValueError as e:
            return str(e)
    finally:
        w.remove()


# -- darlin over the data axis --


def darlin_conf(lam=1.0, passes=10, ratio=4.0, tau=0, random_order=True):
    """``tests/test_torch_darlin.py``'s conf."""
    c = tcfg.Config()
    c.loss = tcfg.LossConfig(type="logit")
    c.penalty = tcfg.PenaltyConfig(type="l1", lambda_=[lam])
    c.learning_rate = tcfg.LearningRateConfig(alpha=1.0)
    c.darlin = tcfg.BCDConfig(num_data_pass=passes, feature_block_ratio=ratio, epsilon=1e-6,
                              max_block_delay=tau, random_feature_block_order=random_order)
    return c


def darlin_cases(cases, data, tmp):
    """Every case ``(num_data, num_server, tau)``: a ``DarlinScheduler``
    on a mesh of that shape (a prefix of the world) trains ``data``;
    each pass's progress, the weights, the training margins and the
    model files it saves (None on the idle ranks)."""
    from parameter_server_tpu_torch.apps.linear import darlin as tdarlin

    out = []
    for i, (d, s, tau) in enumerate(cases):
        mesh = meshlib.make_mesh(d, s, device="cpu")
        if not mesh.active:
            out.append(None)
            continue
        Postoffice.reset()
        sched = tdarlin.DarlinScheduler(darlin_conf(tau=tau), mesh=mesh)
        try:
            sched.run_on(data)
            files = sched.save_model(os.path.join(tmp, f"darlin{i}", "model"))
            rec = {"coords": mesh.coords,
                   "progress": [vars(sched.g_progress[k]) for k in sorted(sched.g_progress)],
                   "w": sched.solver.w, "margin": sched.solver.predict_margin(),
                   "files": files, "window": sched.max_dispatch_window,
                   "rows": sched.solver.rows_per_shard}
        finally:
            sched.remove()
        out.append(rec)
        Postoffice.reset()
    return out


# -- ps.h programs over a mesh (tests/test_ps_api.py's, and a store's) --


def _hello(ps, Task, record):
    class Server(ps.App):
        def process_request(self, req):
            record((ps.my_node_id(), "req", req.task.time, req.sender))

    class Worker(ps.App):
        def process_response(self, res):
            record((ps.my_node_id(), "res", res.task.time, res.sender))

        def run(self):
            for _ in range(2):
                self.wait(ps.submit(self, Task(), ps.NodeGroups.SERVER_GROUP))
            done = []

            def on_done():
                record((ps.my_node_id(), "cb", self.last_response().task.time))
                done.append(True)

            self.wait(ps.submit(self, Task(), callback=on_done))
            assert done

    def create_app():
        if ps.is_worker():
            return Worker()
        return Server() if ps.is_server() else ps.App()

    return create_app


def ps_programs(layout, kv_stream, kv_slots, diverge):
    """``tests/test_ps_api.py``'s multi-node programs through
    ``ps.run_system`` on this rank (in a world of ``num_workers x
    num_servers`` ranks, each hosting every node), and a store program:
    every worker pushes its share of ``kv_stream`` into the server app's
    ``KVVector``, pulls the keys back and submits a control task after
    each push; S0's ``run`` takes the table. ``diverge``: the data row
    of this index pushes once more (the end's agreement must raise).
    Returns each program's records, as plain data."""
    import threading

    from parameter_server_tpu_torch import ps
    from parameter_server_tpu_torch.parameter.kv_vector import KVVector
    from parameter_server_tpu_torch.system.message import Task

    nw, ns = layout
    out = {"rank": torch.distributed.get_rank()}
    lock = threading.Lock()

    # hello_ps: requests, responses and callbacks by node, and the van's
    # totals against the remote nodes' counters
    log = []

    def record(x):
        with lock:
            log.append(x)

    apps = ps.run_system(_hello(ps, Task, record), num_workers=nw, num_servers=ns, device="cpu")
    van = apps[0].po.van
    out["hello"] = {
        "log": sorted(log), "nodes": [a.node.id for a in apps],
        "van": (van.wire_sent_bytes, van.wire_recv_bytes),
        "remote": (sum(rn.wire_sent_bytes for a in apps for rn in a.remote_nodes.nodes()),
                   sum(rn.wire_recv_bytes for a in apps for rn in a.remote_nodes.nodes())),
        "workers_recv": [any(rn.wire_recv_bytes > 0 for rn in a.remote_nodes.nodes())
                         for a in apps if a.node.id.startswith("W")],
    }

    # the node-identity helpers and the key ranges
    seen = {}

    class Probe(ps.App):
        def __init__(self):
            super().__init__()
            seen[ps.my_node_id()] = (ps.is_scheduler(), ps.is_server(), ps.is_worker(),
                                     ps.my_rank(), ps.rank_size(),
                                     (ps.my_key_range().begin, ps.my_key_range().end))

    from parameter_server_tpu_torch.utils.range import Range

    ps.run_system(Probe, num_workers=nw, num_servers=ns, key_space=Range(0, 100), device="cpu")
    out["identity"] = seen

    # a broadcast reaches its sender's own node
    got = []

    class Echo(ps.App):
        def process_request(self, msg):
            got.append((msg.sender, ps.my_node_id()))

        def run(self):
            if ps.my_node_id() == "W0":
                self.wait(ps.submit(self, Task(), ps.NodeGroups.LIVE_GROUP))

    ps.run_system(Echo, num_workers=nw, num_servers=ns, device="cpu")
    out["broadcast"] = sorted({r for s, r in got if s == "W0"})

    # a worker's exception fails the program on every rank
    class Crasher(ps.App):
        def run(self):
            if ps.my_node_id() == f"W{nw - 1}":
                raise RuntimeError("worker died")

    try:
        ps.run_system(Crasher, num_workers=nw, num_servers=ns, device="cpu")
        out["crash"] = "no error"
    except RuntimeError as e:
        out["crash"] = str(e)

    out["kv"] = _kv_program(ps, KVVector, Task, nw, ns, kv_stream, kv_slots, None, lock)
    out["kv_diverged"] = _kv_program(ps, KVVector, Task, nw, ns, kv_stream, kv_slots, diverge,
                                     lock)
    return out


def _kv_program(ps, KVVector, Task, nw, ns, kv_stream, kv_slots, diverge, lock):
    """Every worker pushes its share of ``kv_stream`` (W``i`` takes items
    ``i, i + nw, ...``) into S0's ``KVVector``, pulls 64 of the keys back
    and submits a control task to the server group after each push; S0's
    ``run`` takes the whole table. ``diverge``: the last worker of the
    ranks of that data row pushes its first item once more."""
    shared, reqs = {}, []

    class KVServer(ps.App):
        def __init__(self):
            super().__init__()
            if ps.my_node_id() == "S0":
                shared["kv"] = KVVector(k=1, num_slots=kv_slots, hashed=True, name="ps_kv")

        def process_request(self, req):
            with lock:
                reqs.append((ps.my_node_id(), req.sender))

        def run(self):
            if ps.my_node_id() == "S0":
                shared["table"] = shared["kv"].get_replica()[0]

    class KVWorker(ps.App):
        def run(self):
            kv = shared["kv"]
            me = ps.my_rank()
            mine = kv_stream[me::nw]
            if diverge is not None and me == nw - 1 and \
                    torch.distributed.get_rank() // ns == diverge:
                mine = mine + mine[:1]
            pulled = []
            for keys, vals in mine:
                kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
                pulled.append(kv.wait_pull(kv.pull(kv.request(channel=0), keys=keys[:64]))
                              .numpy().copy())
                self.wait(ps.submit(self, Task(), ps.NodeGroups.SERVER_GROUP))
            shared[f"pulled_{me}"] = pulled

    def create_kv():
        if ps.is_server():
            return KVServer()
        return KVWorker() if ps.is_worker() else ps.App()

    try:
        apps = ps.run_system(create_kv, num_workers=nw, num_servers=ns, device="cpu")
        van = apps[0].po.van
        return {
            "table": shared["table"], "reqs": sorted(reqs),
            "pulled": [shared[f"pulled_{i}"] for i in range(nw)],
            "van": (van.wire_sent_bytes, van.wire_recv_bytes),
            "remote": (sum(rn.wire_sent_bytes for a in apps for rn in a.remote_nodes.nodes()),
                       sum(rn.wire_recv_bytes for a in apps for rn in a.remote_nodes.nodes())),
        }
    except ValueError as e:
        return str(e)
    finally:
        if "kv" in shared:
            shared["kv"].executor.stop()
