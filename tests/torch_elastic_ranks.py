"""Rank functions of the port's resize and repartition tests: each runs in
every process of a gloo world of CPU ranks that
``parallel.launch.run_world`` starts, and returns plain numpy and Python
results for the test process to hold against the JAX package
(``tests/test_torch_rebalance.py``, ``test_torch_elastic.py``,
``test_torch_autoscale.py``). Imports the port only (no JAX: the ranks
never load it). Every rank runs every case, in the same order: the
collectives of a case meet only when each rank makes them.
"""

import threading
import time

import numpy as np
import torch

from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.parallel import mesh as meshlib
from parameter_server_tpu_torch.parallel import partition as partlib
from parameter_server_tpu_torch.parameter.kv_vector import KVVector
from parameter_server_tpu_torch.system import faults
from parameter_server_tpu_torch.system.postoffice import Postoffice


def _hermetic():
    Postoffice.reset()
    faults.reset()


def _store(d, s, num_slots=64, k=2, hashed=True, name="reb", keys=None):
    """A fresh KVVector on a mesh of its own (None on an idle rank)."""
    mesh = meshlib.make_mesh(d, s, device="cpu")
    if not mesh.active:
        return None
    kv = KVVector(mesh=mesh, k=k, num_slots=num_slots, hashed=hashed, name=name)
    if keys is not None:
        kv.set_keys(0, keys)
    return kv


def _push_all(kv, batches):
    for keys, vals in batches:
        kv.push(kv.request(channel=0), keys=keys, values=vals)
    kv.executor.wait_all(pop=False)


def _pull(kv, keys):
    return kv.wait_pull(kv.pull(kv.request(channel=0), keys=keys)).numpy().copy()


def _done(*stores):
    for kv in stores:
        if kv is not None:
            kv.executor.stop()


# -- KVVector.migrate and the replica hooks over server shards --


def rebalance_cases(batches, batches48, perms, layouts):
    """Every KVVector case of ``tests/test_torch_rebalance.py`` on this
    rank; ``batches``: ``_batches(6)``'s (keys, values), ``batches48`` the
    controller's, ``perms``: name -> permutation, ``layouts``: the
    ``(num_data, num_server)`` of the parity case. Returns name -> the
    case's result (None on a rank the case's mesh leaves idle)."""
    out = {}
    keys40 = np.arange(40, dtype=np.int64)
    vals40 = [v for _, v in batches]

    _hermetic()
    kv = _store(4, 2, name="rej")
    errs = []
    for bad in (np.zeros(kv.num_slots, dtype=np.int64), np.arange(kv.num_slots - 1)):
        try:
            kv.migrate(bad)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    _done(kv)
    out["reject"] = errs

    for d, s in layouts:
        tables = {}
        for at in (None, 3):
            _hermetic()
            kv = _store(d, s, name=f"mig{at}")
            if kv is None:
                break
            mig = None
            for i, (keys, vals) in enumerate(batches):
                if i == at:
                    mig = kv.migrate(perms["parity"])
                kv.push(kv.request(channel=0), keys=keys, values=vals)
            kv.executor.wait_all(pop=False)
            tables[at] = kv.get_replica()[0]
            tables[f"shard{at}"] = kv.table(0).clone().numpy()
            tables[f"mig{at}"] = mig
            _done(kv)
        out[f"parity_{d}x{s}"] = tables or None

    _hermetic()
    kv = _store(4, 2, hashed=False, name="exact", keys=keys40)
    _push_all(kv, [(keys40, v) for v in vals40[:3]])
    before = _pull(kv, keys40)
    mig = kv.migrate(perms["exact"])
    after = _pull(kv, keys40)
    base = kv.get_replica()[0]
    out["exact"] = dict(before=before, after=after, attempts=mig["attempts"],
                        layout=kv.layout(0), base=base, shard=kv.table(0).clone().numpy(),
                        coords=kv.mesh.coords)
    _done(kv)

    _hermetic()
    kv = _store(4, 2, hashed=False, name="twice", keys=keys40)
    _push_all(kv, [(keys40, v) for v in vals40[:2]])
    kv.migrate(perms["one"])
    _push_all(kv, [(keys40, v) for v in vals40[2:4]])
    kv.migrate(perms["two"])
    out["composed"] = dict(table=kv.get_replica()[0], pulled=_pull(kv, keys40),
                           layout=kv.layout(0))
    _done(kv)

    _hermetic()
    kv = _store(4, 2, hashed=False, name="roundtrip", keys=keys40)
    _push_all(kv, [(keys40, v) for v in vals40[:3]])
    snap = kv.get_replica()
    kv.migrate(perms["nine"])
    kv.set_replica(snap)
    kv.executor.wait_all(pop=False)
    out["roundtrip"] = dict(snap=snap[0], table=kv.get_replica()[0], pulled=_pull(kv, keys40))
    _done(kv)

    out["journal"] = _journal_case(keys40, vals40[:4], perms["four"])
    out["serve"] = _serve_case(keys40, vals40[:2], perms["six"])
    out["recovery"] = {m: _recovery_timeline(keys40, vals40, perms["eight"], m)
                       for m in (False, True)}
    out["giveup"] = _giveup_case(batches[:1], perms["parity"])
    out["controller"] = _controller_case(batches48)
    out["noop"] = _noop_case()
    out["reshard"] = _reshard_case()
    out["consistent"] = {f"{d}x{s}": _consistent_case(d, s, batches) for d, s in layouts}
    _hermetic()
    return out


def _journal_case(keys, vals, perm):
    """A migration stalled 0.5 s at ``rebalance.migrate`` on a thread
    while the main thread pushes: journaled, replayed, the table."""
    _hermetic()
    kv = _store(4, 2, hashed=False, name="journal", keys=keys)
    _push_all(kv, [(keys, vals[0])])
    faults.arm("rebalance.migrate", kind="delay", delay_s=0.5, once=True)
    result = {}
    t = threading.Thread(target=lambda: result.update(kv.migrate(perm)))
    t.start()
    time.sleep(0.1)  # the migration reaches its stalled window
    for v in vals[1:]:
        kv.push(kv.request(channel=0), keys=keys, values=v)
    t.join(timeout=60)
    alive = t.is_alive()
    kv.executor.wait_all(pop=False)
    table = kv.get_replica()[0]
    _done(kv)
    return dict(result=result, alive=alive, table=table)


def _serve_case(keys, vals, perm, moves=6):
    """A pull stream on a thread across ``moves`` migrations on this
    thread, the first stalled 0.4 s, the others back to back (each flip a
    chance for the row's ranks to flip between different pulls). Pulls
    are collectives of the row on the executor's groups, so the stream
    stops where the row agrees to (a MAX over the row, after each pull):
    every rank makes the same number of pulls."""
    _hermetic()
    kv = _store(4, 2, hashed=False, name="serve", keys=keys)
    _push_all(kv, [(keys, v) for v in vals])
    expect = _pull(kv, keys).tobytes()
    faults.arm("rebalance.migrate", kind="delay", delay_s=0.4, once=True)
    done = threading.Event()
    stats = {"ok": 0, "failed": 0, "wrong": 0}

    def serve():
        while True:
            try:
                got = _pull(kv, keys)
                stats["ok" if got.tobytes() == expect else "wrong"] += 1
            except Exception:  # noqa: BLE001 — counted: the contract is zero
                stats["failed"] += 1
            if meshlib.agree_max(int(done.is_set()), meshlib.SERVER_AXIS, kv.mesh):
                return

    server = threading.Thread(target=serve)
    server.start()
    attempts = []
    try:
        for i in range(moves):
            attempts.append(kv.migrate(perm if i % 2 == 0 else np.argsort(perm))["attempts"])
    finally:
        done.set()
        server.join(timeout=60)
    coords = kv.mesh.coords
    _done(kv)
    return dict(attempts=attempts, alive=server.is_alive(), coords=coords, **stats)


def _recovery_timeline(keys, vals, perm, migrate):
    """The recovery drill's timeline with (or without) a migration
    stalled across the restore: backup, a push the recovery wipes, the
    restore through the executor, three acked pushes."""
    from parameter_server_tpu_torch.parameter.replica import ReplicaManager

    _hermetic()
    kv = _store(4, 2, hashed=False, name=f"rec{int(migrate)}", keys=keys)
    rm = ReplicaManager()
    _push_all(kv, [(keys, v) for v in vals[:2]])
    rm.backup_consistent(kv)
    result, t = {}, None
    if migrate:
        faults.arm("rebalance.migrate", kind="delay", delay_s=0.6, once=True)
        t = threading.Thread(target=lambda: result.update(kv.migrate(perm)))
        t.start()
        time.sleep(0.1)
    _push_all(kv, [(keys, vals[2])])
    recovered = rm.recover(kv, through_executor=True)
    for v in vals[3:6]:
        kv.push(kv.request(channel=0), keys=keys, values=v)
    if t is not None:
        t.join(timeout=60)
    kv.executor.wait_all(pop=False)
    table = kv.get_replica()[0]
    layout = kv.layout(0)
    _done(kv)
    return dict(result=result, recovered=recovered, table=table, layout=layout)


def _giveup_case(batches, perm):
    _hermetic()
    kv = _store(4, 2, name="giveup")
    _push_all(kv, batches)
    orig = kv._shard_snapshot  # the barrier of a migration

    def poisoned(ch=0, callback=None):
        kv.note_external_restore()  # every snapshot is born stale
        return orig(ch, callback)

    kv._shard_snapshot = poisoned
    try:
        kv.migrate(perm, max_attempts=2)
        err = None
    except RuntimeError as e:
        err = str(e)
    kv._shard_snapshot = orig
    kv.executor.wait_all(pop=False)
    layout = kv.layout(0)
    _done(kv)
    return dict(err=err, layout=layout)


def _controller_case(batches):
    """The alert → controller → migration arc on a 1x8 mesh: every rank
    evaluates the shipped rules at the same logical times."""
    from parameter_server_tpu_torch.telemetry import alerts as alerts_mod
    from parameter_server_tpu_torch.telemetry import registry as telemetry_registry
    from parameter_server_tpu_torch.telemetry.instruments import learning_instruments
    from parameter_server_tpu_torch.telemetry.learning import KeyHeat

    _hermetic()
    keys = np.arange(48, dtype=np.int64)
    kv = _store(1, 8, hashed=False, name="ctl", keys=keys)
    _push_all(kv, [(keys, v) for v in batches])
    heat = KeyHeat(num_slots=64, num_shards=8, top_k=16, decay_every=1 << 30)
    hot = np.arange(8)
    for _ in range(4):
        heat.note(np.repeat(hot, 25))
    imb0 = heat.shares()["imbalance"]
    ctl = partlib.RebalanceController(kv, heat)
    rec = dict(num_slots=kv.num_slots, imb0=imb0, threshold=ctl.threshold,
               should=ctl.should_rebalance())
    reg = telemetry_registry.default_registry()
    learning_instruments(reg)["shard_imbalance"].set(imb0)
    mgr = alerts_mod.AlertManager(alerts_mod.default_rules(), registry=reg)
    ctl.attach(mgr)
    rec["hist0"] = ctl.history()
    mgr.evaluate(now=0.0)
    rec["hist_pending"] = ctl.history()
    mgr.evaluate(now=6.0)
    rec["hist"] = ctl.history()
    perm = kv.layout(0)
    rec["layout"] = perm
    for _ in range(4):
        heat.note(np.repeat(perm[hot], 25))
    rec["post"] = ctl.refresh_post_imbalance()
    rec["table"] = kv.get_replica()[0]
    mgr.evaluate(now=12.0)
    rec["hist_after"] = len(ctl.history())
    _done(kv)
    return rec


def _noop_case():
    from parameter_server_tpu_torch.telemetry.learning import KeyHeat

    _hermetic()
    kv = _store(1, 8, name="noop")
    heat = KeyHeat(num_slots=kv.num_slots, num_shards=8, decay_every=1 << 30)
    heat.note(np.arange(64))
    ctl = partlib.RebalanceController(kv, heat)
    rec = dict(should=ctl.should_rebalance(), executed=ctl.execute(), layout=kv.layout(0))
    _done(kv)
    return rec


def _reshard_case():
    """``tests/test_reshard.py::test_kv_vector_reshards_2_to_4_servers``:
    a replica taken at 4x2 installs at 2x4."""
    _hermetic()
    keys = np.array([3, 17, 40, 99, 512, 1000], dtype=np.int64)
    vals = np.arange(12, dtype=np.float32).reshape(6, 2)
    a = _store(4, 2, num_slots=1024, hashed=False, name="a", keys=keys)
    a.wait(a.push(a.request(channel=0), keys=keys, values=vals))
    snap = a.get_replica()
    _done(a)
    b = _store(2, 4, num_slots=1024, hashed=False, name="b", keys=keys)
    b.set_replica(snap)
    first = b.values(0, keys)
    shard_rows = b.table(0).shape[0]
    b.wait(b.push(b.request(channel=0), keys=keys, values=vals))
    rec = dict(first=first, shard_rows=shard_rows, second=b.values(0, keys),
               num_server=meshlib.num_servers(b.mesh), snap=snap[0])
    _done(b)
    return rec


def _consistent_case(d, s, batches):
    """``get_replica_consistent`` while a thread pushes: the snapshot (every
    rank's whole table) and its barrier; then ``set_replica`` of it into a
    fresh store of the same mesh, gathered again."""
    _hermetic()
    kv = _store(d, s, name="cons")
    if kv is None:
        return None
    _push_all(kv, batches[:2])

    def stream():
        for keys, vals in batches[2:]:
            kv.push(kv.request(channel=0), keys=keys, values=vals)
            time.sleep(0.002)

    t = threading.Thread(target=stream)
    t.start()
    snap, barrier = kv.get_replica_consistent()
    t.join(timeout=60)
    kv.executor.wait_all(pop=False)
    final = kv.get_replica()[0]
    coords = kv.mesh.coords
    _done(kv)
    fresh = _store(d, s, name="cons2")
    fresh.set_replica(snap)
    back = fresh.get_replica()[0]
    _done(fresh)
    return dict(snap=snap[0], barrier=barrier[0], final=final, back=back, coords=coords)


# -- the elastic coordinator --

NUM_SLOTS = 1000  # not a power of two: the padding varies with the server count


def elastic_conf(replica: bool = True, slots: int = NUM_SLOTS):
    c = tcfg.Config()
    c.penalty = tcfg.PenaltyConfig(type="l1", lambda_=[0.01])
    c.learning_rate = tcfg.LearningRateConfig(type="decay", alpha=0.5, beta=1.0)
    c.async_sgd = tcfg.SGDConfig(algo="ftrl", minibatch=256, num_slots=slots,
                                 **(dict(num_replicas=1, replica_every=1) if replica else {}))
    return c


def make_worker(mesh):
    return tsgd.AsyncSGDWorker(elastic_conf(), mesh=mesh)


def make_worker_noreplica(mesh):
    return tsgd.AsyncSGDWorker(elastic_conf(replica=False), mesh=mesh)


def _step(w, batch):
    return w.collect(w.process_minibatch(batch))


def _weights(co):
    return None if co.worker is None else co.worker.weights_dense()


def _coordinator(mk, d, s, events=None):
    from parameter_server_tpu_torch.system.elastic import ElasticCoordinator

    _hermetic()
    co = ElasticCoordinator(mk, num_data=d, num_server=s, device="cpu")
    if events is not None:
        co.subscribe_nodes(lambda ev, n: events.append((ev, n.id)))
    co.start()
    return co


def _close(co):
    if co.worker is not None:
        co.worker.remove()
    _hermetic()


def _shape(co):
    mesh = Postoffice.instance().mesh
    return dict(mesh.shape), (None if not mesh.active else mesh.coords)


def elastic_cases(batches, extra, tmp):
    """Every case of ``tests/test_torch_elastic.py`` on this rank:
    ``batches`` the nine stream minibatches, ``extra`` the ones trained
    after a resize (seeds 50, 60, 70, 5), ``tmp`` a directory the ranks
    share. Returns name -> result."""
    out = {}

    events = []
    co = _coordinator(make_worker, 2, 2, events)
    for b in batches[:3]:
        if co.worker is not None:
            _step(co.worker, b)
    before = _weights(co)
    slots_before = None if co.worker is None else co.worker.directory.slots(
        np.array([3, 1 << 40, -5, 999999], dtype=np.int64))
    co.add_server()
    rec = dict(before=before, after=_weights(co), num_server=co.num_server, shape=_shape(co),
               shard_rows=None if co.worker is None else co.worker.shard_rows,
               slots_before=slots_before, slots_after=None if co.worker is None else
               co.worker.directory.slots(np.array([3, 1 << 40, -5, 999999], dtype=np.int64)))
    if co.worker is not None:
        _step(co.worker, extra[0])
    rec.update(trained=_weights(co), events=list(events), history=co.resize_history)
    _close(co)
    out["server_join"] = rec

    co = _coordinator(make_worker, 2, 2)
    for b in batches[:3]:
        if co.worker is not None:
            _step(co.worker, b)
    before = _weights(co)
    co.remove_server()
    rec = dict(before=before, after=_weights(co), shape=_shape(co))
    if co.worker is not None:
        _step(co.worker, extra[0])
    rec["trained"] = _weights(co)
    _close(co)
    out["server_leave"] = rec

    co = _coordinator(make_worker, 2, 2)
    if co.worker is not None:
        _step(co.worker, batches[0])
    before = _weights(co)
    co.add_worker()
    rec = dict(before=before, after=_weights(co), shape=_shape(co))
    if co.worker is not None:
        _step(co.worker, extra[1])
    rec["trained"] = _weights(co)
    _close(co)
    out["worker_join"] = rec

    events = []
    co = _coordinator(make_worker, 2, 2, events)
    for b in batches[:3]:
        if co.worker is not None:
            _step(co.worker, b)
    want = _weights(co)
    replica = None if co.worker is None else co.worker.replica_host()
    pre = None if co.worker is None else co.worker.state_host()["state"]
    if co.worker is not None:
        co.worker.wipe_server_shard(0)
    wiped = _weights(co)
    outcome = co.handle_server_death(0)
    rec = dict(want=want, wiped=wiped, outcome=outcome, got=_weights(co),
               num_server=co.num_server, events=list(events), replica=replica, pre=pre,
               coords=None if co.worker is None else co.worker.mesh.coords,
               post=None if co.worker is None else co.worker.state_host()["state"])
    _close(co)
    out["recover_in_place"] = rec

    events = []
    co = _coordinator(make_worker_noreplica, 2, 2, events)
    for b in batches[:3]:
        if co.worker is not None:
            _step(co.worker, b)
    before = _weights(co)
    per = None if co.worker is None else co.worker.num_slots // 2
    outcome = co.handle_server_death(1)
    rec = dict(before=before, per=per, outcome=outcome, num_server=co.num_server,
               after=_weights(co), events=list(events))
    if co.worker is not None:
        _step(co.worker, extra[2])
    rec["trained"] = _weights(co)
    _close(co)
    out["death_no_replica"] = rec

    out["heartbeat"] = _heartbeat_case(batches)

    events = []
    co = _coordinator(make_worker_noreplica, 2, 2, events)
    if co.worker is not None:
        _step(co.worker, batches[0])
    out["middle_death"] = dict(outcome=co.handle_server_death(0), events=list(events))
    _close(co)

    events = []
    co = _coordinator(make_worker, 2, 2, events)
    if co.worker is not None:
        _step(co.worker, batches[0])
        co.worker.wipe_server_shard(0)
    out["recovery_no_events"] = dict(outcome=co.handle_server_death(0), events=list(events))
    _close(co)

    co = _coordinator(make_worker, 2, 2)
    header = None
    if co.worker is not None:
        _step(co.worker, batches[0])
        paths = co.worker.save_model(f"{tmp}/m")
        if co.worker.mesh.coords == (0, 0):
            header = open(paths[0]).readline().split()
    out["model_header"] = header
    _close(co)

    out["aux"] = _aux_case(batches)

    events = []
    co = _coordinator(make_worker_noreplica, 2, 1, events)
    if co.worker is not None:
        _step(co.worker, batches[0])
    outcome = co.handle_server_death(0)
    rec = dict(outcome=outcome, events=list(events), num_server=co.num_server)
    if co.worker is not None:
        _step(co.worker, extra[3])
    rec["trained"] = _weights(co)
    _close(co)
    out["single_server_death"] = rec

    out["streaming"] = _streaming_case(batches)
    out["too_big"] = _too_big_case()
    return out


def _heartbeat_case(batches):
    from parameter_server_tpu_torch.system.heartbeat import HeartbeatCollector, HeartbeatReport
    from parameter_server_tpu_torch.system.recovery import RecoveryCoordinator

    co = _coordinator(make_worker, 2, 2)
    for b in batches[:3]:
        if co.worker is not None:
            _step(co.worker, b)
    want = _weights(co)
    if co.worker is not None:
        co.worker.wipe_server_shard(1)
    c = HeartbeatCollector(timeout=5.0)
    c.report("S1", HeartbeatReport())
    rc = RecoveryCoordinator(c)
    co.attach_recovery(rc)
    handled = rc.check(now=c._last_seen["S1"] + 6)
    rec = dict(want=want, handled=handled, got=_weights(co), num_server=co.num_server)
    _close(co)
    return rec


def _aux_case(batches):
    from parameter_server_tpu_torch.system.heartbeat import HeartbeatReport

    co = _coordinator(make_worker, 2, 2)
    po = Postoffice.instance()
    aux = po.start_aux(heartbeat_timeout=7.5, print_fn=lambda s: None)
    aux.register("W0")
    deaths = []
    aux.coordinator.on_server_dead(deaths.append)
    if co.worker is not None:
        _step(co.worker, batches[0])
    co.remove_server()
    po2 = Postoffice.instance()
    rec = dict(same_aux=po2.aux is aux,
               handlers=aux.coordinator._handlers["server"] == [deaths.append],
               info=po2.aux.info("W0") is not None)
    po2.beat("W0")
    aux.collector.report("S0", HeartbeatReport())
    late = aux.collector._last_seen["S0"] + 100
    rec["handled"] = list(aux.coordinator.check(now=late))
    rec["deaths"] = list(deaths)
    _close(co)
    return rec


def _streaming_case(batches):
    co = _coordinator(make_worker, 2, 2)
    po = Postoffice.instance()
    aux = po.start_aux(heartbeat_timeout=60.0, print_fn=lambda s: None)
    stream = iter(batches)
    losses, phase_examples, checks = [], [], []

    def drive(n):
        w = co.worker
        start = None if w is None else w.progress.num_examples_processed
        for _ in range(n):
            b = next(stream)
            if w is not None:
                prog = _step(w, b)
                losses.append(prog.objective[-1] / 256)
        if w is not None:
            phase_examples.append(w.progress.num_examples_processed - start)

    drive(3)
    before = _weights(co)
    co.resize(num_data=2, num_server=1)
    checks.append((before, _weights(co)))
    drive(3)
    before = _weights(co)
    co.resize(num_data=3, num_server=2)
    checks.append((before, _weights(co)))
    drive(3)
    rec = dict(losses=losses, phase_examples=phase_examples, checks=checks,
               history=co.resize_history, report=aux.dashboard.report(),
               final=_weights(co))
    _close(co)
    return rec


def _too_big_case():
    """A resize past the world raises ``ValueError`` on every rank, before
    anything is torn down; the coordinator keeps its mesh."""
    co = _coordinator(make_worker, 2, 2)
    try:
        co.resize(num_data=3, num_server=3)
        err = None
    except ValueError as e:
        err = str(e)
    rec = dict(err=err, shape=(co.num_data, co.num_server),
               alive=co.worker is None or co.worker.weights_dense() is not None)
    _close(co)
    return rec


# -- the autoscaler's default action on a real coordinator --


def autoscale_default_action():
    from parameter_server_tpu_torch.system.autoscale import AlertDrivenScaler
    from parameter_server_tpu_torch.telemetry.alerts import AlertEvent

    class Manager:
        def __init__(self):
            self.listeners = []

        def add_listener(self, fn):
            self.listeners.append(fn)

    co = _coordinator(make_worker, 2, 2)
    mgr = Manager()
    sc = AlertDrivenScaler(mgr, co, cooldown_s=0.0)
    before = co.num_data
    ev = AlertEvent(rule="serve_p99_burn", frm="inactive", to="firing", value=0.2,
                    threshold=0.05, op=">", t=0.0, severity="page")
    for fn in mgr.listeners:
        fn(ev)
    rec = dict(before=before, after=co.num_data, has_worker=co.worker is not None,
               shape=_shape(co), outcomes=[a["outcome"] for a in sc.actions()])
    _close(co)
    return rec


# -- the neighbour replica and the store's hooks on a 2x2 mesh --


def replica_and_migration_2x2(conf, batches, kv_batches, perm):
    """On a 2x2 mesh: the linear worker with the neighbour replica
    (``conf``) trained on ``batches``, its replica and state, then shard 1
    wiped and recovered; and a ``KVVector`` over the 2 server shards pushed
    ``kv_batches``, migrated by ``perm`` halfway, its replica hooks."""
    _hermetic()
    mesh = meshlib.make_mesh(2, 2, device="cpu")
    w = tsgd.AsyncSGDWorker(conf, mesh=mesh)
    no_replica = w.recover_server_shard(1)
    for b in batches:
        w.wait(w.process_minibatch(b))
    rec = dict(coords=mesh.coords, no_replica=no_replica, replica=w.replica_host(),
               state=w.state_host()["state"])
    w.wipe_server_shard(1)
    rec["wiped"] = w.state_host()["state"]
    rec["recovered"] = w.recover_server_shard(1)
    rec["after"] = w.state_host()["state"]
    w.remove()
    _hermetic()
    kv = KVVector(k=2, num_slots=64, hashed=True, name="kv22", mesh=mesh, num_server=2)
    half = len(kv_batches) // 2
    _push_all(kv, kv_batches[:half])
    rec["kv_migrate"] = kv.migrate(perm)
    _push_all(kv, kv_batches[half:])
    rec["kv_replica"] = kv.get_replica()[0]
    snap, barrier = kv.get_replica_consistent()
    rec["kv_consistent"] = snap[0]
    kv.set_replica({0: np.zeros((64, 2), np.float32)})
    rec["kv_zeroed"] = kv.get_replica()[0]
    kv.set_replica(snap)
    rec["kv_back"] = kv.get_replica()[0]
    rec["kv_shard"] = kv.table(0).clone().numpy()
    _done(kv)
    _hermetic()
    return rec
