"""Component drills of the parameter server on one card.

Counterpart of part of ``parameter_server_tpu/benchmarks/components.py``:
the kill-one-shard recovery drill (:func:`recovery_drill`) and its
batch stream (:func:`_drill_batch`). The drill's record has the JAX
record's fields under the same names; ``chip_smoke.py`` (phase 8d) runs
it on the card, the tests on the CPU.
"""

from __future__ import annotations

import numpy as np

DRILL_SEED = 7
DRILL_K = 4
DRILL_KEY_SPACE = 1 << 16
DRILL_KEYS_PER_BATCH = 64
DRILL_HB_TIMEOUT_S = 0.3
DRILL_BACKUP_INTERVAL_S = 0.04


def _drill_batch(seed: int, i: int, key_space: int, n: int, k: int):
    """Training batch ``i`` of the drill, regenerable by its index: the
    recovery handler replays acknowledged updates from their indices
    instead of journaling arrays."""
    rng = np.random.default_rng((seed << 20) + i)
    keys = rng.integers(0, key_space, n).astype(np.int64)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    return keys, vals


def drill_shape(smoke: bool) -> dict:
    """The drill's table and stream: 2^10 (smoke) or 2^12 slots, and 120
    or 240 batches. The stream outlives detection in either mode: after
    the kill at a sixth of it, 100+ batches paced at >= 4 ms exceed the
    heartbeat timeout plus a poll, so the handler finds the trainer
    alive and parks it."""
    n_batches = 120 if smoke else 240
    return dict(num_slots=1 << (10 if smoke else 12), n_batches=n_batches,
                kill_at=n_batches // 6)


def _push_and_ack(kv, i: int) -> int:
    keys, vals = _drill_batch(DRILL_SEED, i, DRILL_KEY_SPACE, DRILL_KEYS_PER_BATCH, DRILL_K)
    ts = kv.push(kv.request(channel=0), keys=keys, values=vals)
    kv.executor.wait(ts, timeout=60)
    return ts


def undisturbed_table(smoke: bool = False, device=None) -> np.ndarray:
    """The drill's reference: a fresh store fed the whole batch stream
    with no fault, its table on the host. Also warms every path the
    drill runs (push, gather, snapshot copy), so a first-call stall
    cannot eat the heartbeat margin."""
    from ..parameter.kv_vector import KVVector

    shape = drill_shape(smoke)
    kv = KVVector(k=DRILL_K, num_slots=shape["num_slots"], hashed=True, name="drill_ref",
                  device=device)
    for i in range(shape["n_batches"]):
        _push_and_ack(kv, i)
    table = kv.table(0, copy=True).cpu().numpy()
    kv.executor.stop()
    return table


def recovery_drill(smoke: bool = False, device=None, on_live=None) -> dict:
    """Kill-one-shard recovery under concurrent train and serve load.

    The script, all under live load (a paced training push stream and a
    closed-loop serving client against the same store, on ``device``,
    the card unless the caller names another):

    1. **healthy**: periodic consistent replica backups
       (``ReplicaManager.start_periodic``: snapshot steps through the
       store's executor, which in-place pushes cannot tear) while the
       trainer acknowledges pushes and serving reads live;
    2. **kill**: the backups stop, then ``S0`` dies as shards die: its
       heartbeats stop (``heartbeat.report`` silence), its table is
       wiped (the replacement starts empty), and the serving store path
       fails (``serve.pull`` / ``serve.refresh`` faults). Serving degrades
       to the stale read replica instead of failing; training keeps
       acknowledging updates, the ones the replay must not lose;
    3. **detect and recover**: the ``RecoveryCoordinator``'s poll finds
       S0 dead after the heartbeat timeout; the handler parks the
       trainer, installs the last consistent snapshot through the
       executor, replays every acknowledged push past the snapshot's
       barrier in order, re-arms the store path and resumes;
    4. **verify**: once the stream ends, the drilled table must be bit
       for bit the undisturbed run's (:func:`undisturbed_table`).

    Also measured: detection, recovery and MTTR wall times; serve
    requests completed, degraded, shed and failed; the disarmed-overhead
    pair (fault points present but disarmed against stubbed out).

    ``on_live``, if given, is called with ``"start"`` just before the
    drilled store is made and with ``"end"`` once its stream has drained
    and its table is read: between the two run only the drilled store's
    pushes and replays (no reference run, no overhead pair), so a caller
    can read counters around them.
    """
    import threading
    import time as _time

    from ..parameter.kv_vector import KVVector
    from ..parameter.replica import ReplicaManager
    from ..serving import PullRequest, RejectedError, ServeConfig, ServeFrontend
    from ..system import faults
    from ..system.heartbeat import HeartbeatCollector, HeartbeatReport
    from ..system.postoffice import Postoffice
    from ..system.recovery import RecoveryCoordinator
    from ..telemetry import alerts as alerts_mod
    from ..telemetry import blackbox
    from ..telemetry import registry as telemetry_registry

    Postoffice.reset()
    Postoffice.instance().start(device=device)
    shape = drill_shape(smoke)
    num_slots, n_batches, kill_at = shape["num_slots"], shape["n_batches"], shape["kill_at"]
    k, n_per_batch, key_space, hb_timeout = (DRILL_K, DRILL_KEYS_PER_BATCH, DRILL_KEY_SPACE,
                                             DRILL_HB_TIMEOUT_S)
    t_ref = undisturbed_table(smoke, device)

    faults.reset()
    # the flight recorder, armed for the whole drill, so the shard death
    # captures a bundle with the evidence before it; the minimum capture
    # interval is dropped so no earlier capture suppresses it. The
    # cleanup below restores exactly what the drill touched
    prev_min_interval = blackbox.set_min_interval(0.0)
    was_armed = blackbox.installed_recorder() is not None
    blackbox.arm()
    blackbox.recorder("W0").clear()
    blackbox.recorder("S0").clear()
    node_alerts = None
    if telemetry_registry.enabled():
        node_alerts = alerts_mod.AlertManager(
            [r for r in alerts_mod.default_rules() if r.name == "node_deaths"])
        node_alerts.evaluate()  # the baseline sample: a rate needs a window
    # metered update accounting: the push-key counter of the drilled store,
    # read before the store exists, so the delta is this drill's keys
    push_tel = None
    push_keys0 = 0.0
    if telemetry_registry.enabled():
        from ..telemetry.instruments import parameter_instruments

        push_tel = parameter_instruments(telemetry_registry.default_registry())["push_keys"]
        push_keys0 = push_tel.value(store="drill_live", channel=0)
    if on_live is not None:
        on_live("start")
    kv = KVVector(k=k, num_slots=num_slots, hashed=True, name="drill_live", device=device)
    rm = ReplicaManager()
    rm.backup_consistent(kv)  # a snapshot exists before any fault can land
    rm.start_periodic(kv, interval_s=DRILL_BACKUP_INTERVAL_S)

    collector = HeartbeatCollector(timeout=hb_timeout)
    # the replay is not idempotent (a partial replay retried would add
    # twice), so the handler runs exactly once and fails loudly instead
    rc = RecoveryCoordinator(collector, handler_retry=None)

    fe = ServeFrontend(
        kv,
        ServeConfig(
            replica="fallback",  # live reads first; the replica is the degraded path
            replica_refresh_s=0.15,
            live_pull_deadline_s=2.0,
            degraded_max_staleness_s=60.0,
            workers=2,
            max_queue_depth=256,
        ),
    ).start()
    rng = np.random.default_rng(DRILL_SEED + 1)
    u = rng.random((128, 16))
    pool = (u * u * u * key_space).astype(np.int64)  # hot-headed draws
    fe.submit(PullRequest(keys=pool[0])).result(30)  # warm the pull lane

    counts = {"ok": 0, "shed": 0, "failed": 0}  # written by the serve thread only
    stop_serve = threading.Event()

    def serve_loop() -> None:
        i = 0
        while not stop_serve.is_set():
            try:
                fe.submit(PullRequest(keys=pool[i % len(pool)])).result(10)
                counts["ok"] += 1
            except RejectedError:
                counts["shed"] += 1
            except Exception:  # a DegradedError or any other failure; the
                counts["failed"] += 1  # frontend counts degraded successes
            i += 1
            _time.sleep(0.002)

    acked: list = []  # (push ts, batch index); guarded-by: ack_lock
    ack_lock = threading.Lock()
    pause_req = threading.Event()
    parked = threading.Event()
    train_err: list = []

    def trainer() -> None:
        try:
            for i in range(n_batches):
                if pause_req.is_set():
                    parked.set()
                    while pause_req.is_set():
                        _time.sleep(0.002)
                    parked.clear()
                ts = _push_and_ack(kv, i)
                with ack_lock:
                    acked.append((ts, i))
                _time.sleep(0.004)  # paced: a live stream, not a burst
        except BaseException as e:  # raised after the join
            train_err.append(e)

    stop_beat = threading.Event()

    def beater() -> None:
        beats = 0
        while not stop_beat.wait(0.04):
            collector.report("S0", HeartbeatReport(hostname="S0"))
            collector.report("W0", HeartbeatReport(hostname="W0"))
            beats += 1
            if beats % 3 == 0:
                # metrics samples into the nodes' flight-recorder rings
                for nid in ("W0", "S0"):
                    rec = blackbox.recorder(nid, create=False)
                    if rec is not None:
                        rec.sample_metrics()

    t_kill = [0.0]
    t_detect = [0.0]
    t_recovered = [0.0]
    replayed = [0]
    barrier_used = [-1]
    trainer_parked = [False]

    trainer_t = threading.Thread(target=trainer, name="drill-trainer")

    def on_server_dead(nid: str) -> None:
        if t_kill[0] == 0.0:
            # a loaded host stalled the beater before the kill: a false
            # positive must not use up the exactly-once handler
            rc.revive(nid)
            return
        t_detect[0] = _time.perf_counter()
        # bounded delay: the survivors stop pushing while the shard recovers
        pause_req.set()
        while not parked.is_set() and trainer_t.is_alive():
            _time.sleep(0.002)
        trainer_parked[0] = parked.is_set()  # alive and parked, not finished
        rec_ok = rm.recover(kv, through_executor=True)
        assert rec_ok, "no replica snapshot to recover from"
        barrier = rm.barrier(kv.name).get(0, -1)
        barrier_used[0] = barrier
        with ack_lock:
            replay = [(ts, i) for ts, i in acked if ts > barrier]
        for _, i in replay:  # in the original order: the adds re-run in sequence
            _push_and_ack(kv, i)
        replayed[0] = len(replay)
        # the replacement is up: the store path and its heartbeats return
        faults.disarm("serve.pull")
        faults.disarm("serve.refresh")
        faults.disarm("heartbeat.report")
        t_recovered[0] = _time.perf_counter()
        pause_req.clear()

    rc.on_server_dead(on_server_dead)
    collector.report("S0", HeartbeatReport(hostname="S0"))
    collector.report("W0", HeartbeatReport(hostname="W0"))

    serve_t = threading.Thread(target=serve_loop, name="drill-serve")
    beat_t = threading.Thread(target=beater, name="drill-beater")
    degraded_probes = 0
    try:
        beat_t.start()
        rc.start(interval=0.03)
        trainer_t.start()
        serve_t.start()

        # phase 1 (healthy): until the kill point has been acknowledged
        while True:
            with ack_lock:
                n_acked = len(acked)
            if n_acked >= kill_at or train_err:
                break
            _time.sleep(0.005)
        if train_err:
            raise train_err[0]

        # phase 2 (kill): the dead shard's backups stop first (a crashed
        # node takes no snapshot), then at least one acknowledged update
        # must postdate the last barrier, so the replay set is not empty
        rm.stop_periodic()
        barrier_before = rm.barrier(kv.name).get(0, -1)
        replay_deadline = _time.perf_counter() + 30
        while True:
            with ack_lock:
                if any(ts > barrier_before for ts, _ in acked):
                    break
            assert trainer_t.is_alive() and _time.perf_counter() < replay_deadline, \
                "no acked update ever postdated the final backup barrier"
            _time.sleep(0.002)
        faults.arm("heartbeat.report", kind="silence", match="S0")
        faults.arm("serve.pull", kind="raise")
        faults.arm("serve.refresh", kind="raise")
        t_kill[0] = _time.perf_counter()
        # the wipe goes through the executor, in order with the pushes
        zeros = kv._zeros()
        kv.executor.wait(kv.submit(lambda: kv.set_table(0, zeros), kv.request(channel=0)),
                         timeout=60)
        # requests in the dead window are answered, stale
        for j in range(3):
            try:
                fe.submit(PullRequest(keys=pool[j])).result(10)
                degraded_probes += 1
            except Exception:
                pass

        # phase 3 runs on the coordinator's thread; phase 4: the stream ends
        deadline = _time.perf_counter() + 90
        while t_recovered[0] == 0.0 and _time.perf_counter() < deadline:
            if node_alerts is not None:
                node_alerts.evaluate()
            _time.sleep(0.005)
        assert t_recovered[0] > 0.0, "recovery never completed"
        if node_alerts is not None:
            alert_deadline = _time.perf_counter() + 10
            while ("node_deaths" not in node_alerts.firing()
                   and _time.perf_counter() < alert_deadline):
                node_alerts.evaluate()
                _time.sleep(0.01)
        trainer_t.join(timeout=120)
        assert not trainer_t.is_alive(), "trainer wedged"
        if train_err:
            raise train_err[0]
    finally:
        try:
            faults.reset()
            rm.stop_periodic()
            stop_serve.set()
            stop_beat.set()
            rc.stop()
            for t in (serve_t, beat_t, trainer_t):
                if t.ident is not None:
                    t.join(timeout=60)
            fe.close()
        finally:
            # the death's bundle by its trigger: a later capture (a
            # straggling degraded answer) may follow it
            death_bundle = next((b for b in reversed(blackbox.bundles())
                                 if b["trigger"]["kind"] == "node_death"), None)
            blackbox.set_min_interval(prev_min_interval)
            blackbox.drop_recorder("W0")
            blackbox.drop_recorder("S0")
            if not was_armed:
                blackbox.disarm()

    kv.executor.wait_all(pop=False, timeout=60)
    t_drill = kv.table(0, copy=True).cpu().numpy()
    if on_live is not None:
        on_live("end")
    fe_stats = fe.stats()
    kv.executor.stop()
    blackbox_section: dict = {"captured": death_bundle is not None}
    if death_bundle is not None:
        blackbox_section = blackbox.summarize_bundle(death_bundle)
    if node_alerts is not None:
        st = node_alerts.states().get("node_deaths")
        blackbox_section["node_deaths_alert"] = st.state_name if st is not None else "absent"
    bit_identical = (t_ref.dtype == t_drill.dtype and t_ref.shape == t_drill.shape
                     and t_ref.tobytes() == t_drill.tobytes())
    # the bit identity, metered on its own: every key acknowledged plus
    # every key replayed shows in the push-key counter of the store
    update_accounting = None
    if push_tel is not None:
        pushed = int(push_tel.value(store="drill_live", channel=0) - push_keys0)
        expected = (n_batches + replayed[0]) * n_per_batch
        update_accounting = {
            "pushed_keys_metered": pushed,
            "expected_keys": expected,
            "acked_updates": n_batches,
            "replayed_updates": replayed[0],
            "keys_per_batch": n_per_batch,
            "metered_matches": pushed == expected,
        }
        assert update_accounting["metered_matches"], update_accounting

    # -- the disarmed-overhead pair: the same push stream with the fault
    # points present but disarmed, and with check() stubbed out, in turns
    # (disarmed, stripped, stripped, disarmed) a rep, the median ratio --
    kv2 = KVVector(k=k, num_slots=1 << 10, hashed=True, name="drill_ovh", device=device)
    okeys, ovals = _drill_batch(DRILL_SEED, 0, key_space, n_per_batch, k)

    def ovh_stream(m: int = 24) -> None:
        for _ in range(m):
            kv2.executor.wait(kv2.push(kv2.request(channel=0), keys=okeys, values=ovals))

    ovh_stream()  # warm
    real_check = faults.check
    ratios = []
    reps = 3 if smoke else 5
    for _ in range(reps):
        t0 = _time.perf_counter()
        ovh_stream()
        disarmed_s = _time.perf_counter() - t0
        faults.check = lambda point, detail=None: None  # the stripped arm
        try:
            t0 = _time.perf_counter()
            ovh_stream()
            ovh_stream()
            stripped_s = (_time.perf_counter() - t0) / 2
        finally:
            faults.check = real_check
        t0 = _time.perf_counter()
        ovh_stream()
        disarmed_s = (disarmed_s + (_time.perf_counter() - t0)) / 2
        ratios.append(disarmed_s / max(stripped_s, 1e-9))
    kv2.executor.stop()
    # the disarmed check alone, in a tight loop: the cost each fault
    # point adds to a step when nothing is armed
    n_calls = 200_000
    t0 = _time.perf_counter()
    for _ in range(n_calls):
        faults.check("executor.step")
    check_ns = (_time.perf_counter() - t0) / n_calls * 1e9

    return {
        "config": {
            "n_batches": n_batches,
            "kill_at_batch": kill_at,
            "keys_per_batch": n_per_batch,
            "k": k,
            "num_slots": num_slots,
            "backup_interval_s": DRILL_BACKUP_INTERVAL_S,
            "heartbeat_timeout_s": hb_timeout,
        },
        "detection_ms": round((t_detect[0] - t_kill[0]) * 1e3, 1),
        "recovery_ms": round((t_recovered[0] - t_detect[0]) * 1e3, 1),
        "mttr_ms": round((t_recovered[0] - t_kill[0]) * 1e3, 1),
        "replayed_updates": replayed[0],
        "acked_updates": n_batches,
        "barrier_ts": barrier_used[0],
        "backup_version_used": (rm.meta(kv.name) or {}).get("version"),
        "trainer_parked": trainer_parked[0],
        "trajectory_bit_identical": bool(bit_identical),
        "update_accounting": update_accounting,
        "blackbox": blackbox_section,
        "serve": {
            "requests": counts["ok"] + counts["shed"] + counts["failed"],
            "completed_ok": counts["ok"],
            "degraded_served": fe_stats["degraded_served"],
            "degraded_probes_in_dead_window": degraded_probes,
            "shed": counts["shed"],
            "failed": counts["failed"],
        },
        "disarmed_overhead": {
            "reps": reps,
            "ratio_median": round(float(np.median(ratios)), 3),
            "check_ns_per_call": round(check_ns, 1),
        },
    }

