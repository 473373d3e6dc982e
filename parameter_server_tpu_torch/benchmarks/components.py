"""Component benchmarks of the port (see the package docstring).

Counterpart of ``parameter_server_tpu/benchmarks/components.py``: its
benchmarks that run on one card, registered under the same names, each
``fn(smoke=False, device=None)`` on ``device`` (the card unless the
caller names another; raises without one), printing the JAX
benchmark's metric lines and returning its record (``chip_smoke.py``
phase 8g reads the records). ``rebalance`` live-repartitions a table
sharded over a 1x8 mesh in a world of 8 ranks it starts, and
``network``'s in-mesh ``psum`` a world of two ranks of its own.

Names: the JAX package's arms ``xla``, ``pallas``, ``fused`` and
``flash`` are ``plain`` (the plain PyTorch version) and ``cuda`` (the
hand-written kernel) here, as are the metrics built from them; every
other metric keeps its JAX name, and where one cannot, the port's tests
(``tests/test_torch_benchmarks_cli.py::METRIC_MAP``) say why.

Times: on the card a kernel's calls are timed with
``benchmarks/timing.py::median_ms`` (CUDA events, a cold L2); a path
through the executor, the host or the copy engine with :func:`timeit` on
the host clock, each timed call waiting for the card
(``torch.cuda.synchronize``). On the CPU every time is the host clock
and the ``cuda`` arms take their kernels' plain versions (the wrappers
do so for CPU tensors), so a record says ``fused_is_fallback: true``
there, as the JAX record does off a TPU. Shares of the card's peaks
(``HBM_PEAK_GB_S``, ``FLOPS_PEAK_TFLOPS``) are null on the CPU.

Also here: the kill-one-shard recovery drill (:func:`recovery_drill`)
and its batch stream (:func:`_drill_batch`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import FLOPS_PEAK_TFLOPS, HBM_PEAK_GB_S, benchmark, peak, report, timeit

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


def _own_table(device):
    """A one-position mesh on ``device``: a store built on it holds this
    rank's whole table and its calls need no order, in a world or not."""
    from ..device import resolve
    from ..parallel import mesh as meshlib

    return meshlib.Mesh(1, 1, resolve(device))


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
                  mesh=_own_table(device), device=device)
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

    Inside a world the drill is not run across ranks: rank 0 drills a
    table of its own on a one-position mesh (``_own_table``; the JAX
    drill's table is on ``_mesh()``), its trainer, its reads, its
    server's death and recovery all in its process, and the
    ``recovery_drill`` benchmark's record carries that table's mesh,
    ``1 x 1``. The other ranks return ``{"follower": True}`` at once (their drills would only load the
    host the drill's heartbeat timing runs on).

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
    if _rank() != 0:
        return {"follower": True}
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
    kv = KVVector(k=k, num_slots=num_slots, hashed=True, name="drill_live",
                  mesh=_own_table(device), device=device)
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



# -- helpers shared by the benchmarks --


class _Lines:
    """Prints metric lines (:func:`report`) and keeps their values for
    the benchmark's record."""

    def __init__(self) -> None:
        self.values: dict = {}

    def __call__(self, metric: str, value: float, unit: str) -> None:
        report(metric, value, unit)
        self.values[metric] = float(value)


def _device(device) -> torch.device:
    """The benchmark's device: the caller's, else the card (raises
    without one)."""
    from ..device import resolve

    return resolve(device)


def _sync(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _start(device, learning: bool = False) -> torch.device:
    """A fresh postoffice started on ``device``; returns its device.

    ``learning=False`` is the JAX ``_mesh()``: the postoffice's
    auto-shaped mesh, every rank of a launcher's world on the data axis
    (``n x 1``), one card outside a world. ``learning=True`` is the JAX
    ``_learning_mesh()``: ``(n // 2) x 2`` in a world of at least 2
    ranks, else the same. A benchmark's stores and workers take the
    started postoffice's mesh; inside a world every rank runs the same
    benchmark, and rank 0 prints."""
    from ..parallel import distributed
    from ..system.postoffice import Postoffice

    Postoffice.reset()
    po = Postoffice.instance()
    if learning and distributed.initialize():
        import torch.distributed as dist

        n = dist.get_world_size()
        return po.start(num_data=n // 2, num_server=2, device=device).device
    return po.start(device=device).device


def _rank() -> int:
    """This process's rank in its world (0 outside one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _mesh_shape() -> dict:
    """The started postoffice's mesh shape, as a record carries it."""
    from ..system.postoffice import Postoffice

    return dict(Postoffice.instance().mesh.shape)


def _arm_ms(fn, dev: torch.device, n: int, budget_s: float = 90.0) -> float:
    """Milliseconds a call of ``fn``, which queues its work and does not
    wait for it: on the card the median of ``n`` calls timed with CUDA
    events on a cold L2 (``median_ms``), on the CPU :func:`timeit`."""
    if dev.type == "cuda":
        from .timing import median_ms

        return median_ms(fn, reps=n)
    return timeit(fn, n, budget_s=budget_s) * 1e3


def _calls_ms(fn, dev: torch.device, calls: int) -> float:
    """Milliseconds a call of ``fn`` over a fixed number of calls, so
    that two arms timed alike make the same updates: on the card
    ``median_ms`` over ``calls`` timed calls (after its 3 warm-up calls),
    on the CPU the mean of ``calls`` calls on the host clock."""
    if dev.type == "cuda":
        from .timing import median_ms

        return median_ms(fn, reps=calls)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def _h2d(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# -- the stores (ref src/test/kv_*_perf_ps.cc) --


@benchmark("kv_vector")
def kv_vector_perf(smoke: bool = False, device=None) -> dict:
    """Push/pull throughput of the dense table (ref
    src/test/kv_vector_perf_ps.cc) through the store's executor, the
    fused push→pull round trip against a push then a pull, and the
    table update alone: ``kv_ops.push`` (a new table each call) against
    ``kv_ops.push_donated`` (in place), quoted with the table bytes each
    in-place push does not copy. On the card a push is a ``segment_sum``
    launch."""
    from ..ops import kv_ops
    from ..parameter.kv_vector import KVVector

    dev = _start(device)
    line = _Lines()
    n_keys = 1 << (12 if smoke else 18)
    k = 4
    kv = KVVector(k=k, num_slots=2 * n_keys, hashed=True, device=dev)
    keys = np.random.default_rng(0).integers(0, 1 << 40, n_keys).astype(np.int64)
    vals = np.ones((n_keys, k), np.float32)

    def push():
        kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
        _sync(dev)

    def pull():
        kv.wait_pull(kv.pull(kv.request(channel=0), keys=keys))
        _sync(dev)

    def push_pull_fused():
        kv.wait_pull(kv.push_pull(kv.request(channel=0), keys=keys, values=vals))
        _sync(dev)

    def push_then_pull():
        push()
        pull()

    try:
        n = 3 if smoke else 10
        sec = timeit(push, n)
        line("kv_vector_push_keys_per_sec", n_keys / sec, "keys/sec")
        line("kv_vector_push_mb_per_sec", vals.nbytes / sec / 1e6, "MB/s")
        sec = timeit(pull, n)
        line("kv_vector_pull_keys_per_sec", n_keys / sec, "keys/sec")
        sec = timeit(push_pull_fused, n)
        line("kv_vector_push_pull_fused_rt_per_sec", 1.0 / sec, "rt/sec")
        sec = timeit(push_then_pull, n)
        line("kv_vector_push_then_pull_rt_per_sec", 1.0 / sec, "rt/sec")

        # the table update alone: only the copy differs between the two
        slots = kv.slots(0, keys)
        vt = _h2d(vals, dev)
        table_copy = kv.table(0, copy=True)
        box = [kv.table(0, copy=True)]

        def push_nodonate():
            kv_ops.push(table_copy, slots, vt)
            _sync(dev)

        def push_donated():
            box[0] = kv_ops.push_donated(box[0], slots, vt)
            _sync(dev)

        sec_nd = timeit(push_nodonate, n)
        line("kv_vector_push_nodonate_keys_per_sec", n_keys / sec_nd, "keys/sec")
        sec_d = timeit(push_donated, n)
        line("kv_vector_push_donated_keys_per_sec", n_keys / sec_d, "keys/sec")
        table_bytes = table_copy.numel() * table_copy.element_size()
        line("kv_vector_push_copy_bytes_avoided_per_push", float(table_bytes), "bytes")
    finally:
        kv.executor.stop()
    return {"metrics": line.values, "n_keys": n_keys, "k": k, "table_bytes": table_bytes,
            "mesh": _mesh_shape()}


@benchmark("kv_map")
def kv_map_perf(smoke: bool = False, device=None) -> dict:
    """Entry-update throughput (ref src/test/kv_map_perf_ps.cc): the
    ``AddEntry`` push over the map's state, one ``segment_sum`` launch a
    push on the card."""
    from ..parameter.kv_map import AddEntry, KVMap

    dev = _start(device)
    line = _Lines()
    n_keys = 1 << (12 if smoke else 18)
    m = KVMap(AddEntry(), k=1, num_slots=2 * n_keys, hashed=True, device=dev)
    keys = np.random.default_rng(0).integers(0, 1 << 40, n_keys).astype(np.int64)
    vals = np.ones((n_keys, 1), np.float32)

    def push():
        m.wait(m.push(m.request(), keys, vals))
        _sync(dev)

    try:
        sec = timeit(push, 3 if smoke else 10)
        line("kv_map_entry_updates_per_sec", n_keys / sec, "entries/sec")
    finally:
        m.executor.stop()
    return {"metrics": line.values, "n_keys": n_keys, "mesh": _mesh_shape()}


@benchmark("kv_layer")
def kv_layer_perf(smoke: bool = False, device=None) -> dict:
    """Dense-layer push/pull throughput (ref src/test/kv_layer_perf_ps.cc):
    the in-place updater (the default) against the copying one
    (``donate=False``), and the fused push_pull round trip. Each push
    carries the gradient from the host, as the JAX layer's does."""
    from ..parameter.kv_layer import KVLayer, SGDUpdater

    dev = _start(device)
    line = _Lines()
    shape = (256, 64) if smoke else (4096, 512)
    layer = KVLayer(partition_thr=1024, updater=SGDUpdater(lr=0.1), device=dev)
    layer.init_layer("w", shape)
    nodon = KVLayer(partition_thr=1024, updater=SGDUpdater(lr=0.1), device=dev, donate=False)
    nodon.init_layer("w", shape)
    grad = np.ones(shape, np.float32)
    nbytes = grad.nbytes

    def push():
        layer.wait(layer.push(layer.request(), "w", grad))
        _sync(dev)

    def pull():
        layer.wait_pull(layer.pull(layer.request(), "w"))
        _sync(dev)

    def push_pull_fused():
        layer.wait_pull(layer.push_pull(layer.request(), "w", grad))
        _sync(dev)

    def push_nodonate():
        nodon.wait(nodon.push(nodon.request(), "w", grad))
        _sync(dev)

    def push_then_pull():
        push()
        pull()

    try:
        n = 3 if smoke else 10
        line("kv_layer_push_mb_per_sec", nbytes / timeit(push, n) / 1e6, "MB/s")
        line("kv_layer_pull_mb_per_sec", nbytes / timeit(pull, n) / 1e6, "MB/s")
        sec = timeit(push_pull_fused, n)
        line("kv_layer_push_pull_fused_rt_per_sec", 1.0 / sec, "rt/sec")
        line("kv_layer_push_copy_bytes_avoided_per_push", float(nbytes), "bytes")
        line("kv_layer_push_nodonate_mb_per_sec", nbytes / timeit(push_nodonate, n) / 1e6, "MB/s")
        sec = timeit(push_then_pull, n)
        line("kv_layer_push_then_pull_rt_per_sec", 1.0 / sec, "rt/sec")
    finally:
        layer.executor.stop()
        nodon.executor.stop()
    return {"metrics": line.values, "shape": list(shape), "mesh": _mesh_shape()}


@benchmark("network")
def network_perf(smoke: bool = False, device=None) -> dict:
    """Copy latency and bandwidth by message size (ref
    src/test/network_perf_ps.cc): the host → card copy of a pageable
    numpy array, as ``jax.device_put`` copies one. On the CPU the copy
    is into a new host tensor. Times are in microseconds (an 8 KB copy
    rounds to 0.0 ms). Then ``network_psum_ms``, the in-mesh collective:
    a ``psum`` of the JAX benchmark's size (1 MB; 64 KB at smoke) over
    the data axis of a world of 2 ranks this benchmark starts
    (``parallel/launch.py``) on the device's type. On one card the two
    ranks share it over gloo (NCCL refuses two ranks on one card), so
    the time is gloo's through the host, not NCCL's across cards."""
    from ..parallel import launch
    from . import mesh as mesh_bench

    dev = _start(device)
    line = _Lines()
    sizes_kb = [8, 64] if smoke else [8, 64, 1024, 8192]
    for kb in sizes_kb:
        x = np.ones(kb * 1024 // 4, np.float32)

        def h2d(x=x):
            if dev.type == "cuda":
                torch.from_numpy(x).to(dev)
                torch.cuda.synchronize(dev)
            else:
                torch.from_numpy(x).clone()

        sec = timeit(h2d, 3 if smoke else 10)
        line(f"network_h2d_{kb}kb_us", sec * 1e6, "us")
        line(f"network_h2d_{kb}kb_mb_per_sec", x.nbytes / sec / 1e6, "MB/s")
    world = launch.run_world(mesh_bench.psum_ms, 2,
                             args=((64 if smoke else 1024) * 256, 5 if smoke else 20),
                             device_type=dev.type, timeout=300)
    line("network_psum_ms", world[0]["ms"], "ms")
    return {"metrics": line.values, "sizes_kb": sizes_kb, "psum": world[0]}


def _spmv(vals: torch.Tensor, ucols: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
          n: int) -> torch.Tensor:
    """Xw over a localized COO, the segment-sum formulation of the JAX
    benchmark (``segment_sum(v * w[c], r)``) through the port's
    ``ops/segment_sum.py``: the rows come in CSR order, so the card
    takes the presorted route (``segment_sum.cu``, no sort)."""
    from ..ops.segment_sum import segment_sum

    return segment_sum(vals * w.index_select(0, ucols), rows, n, presorted=True)


@benchmark("sparse_matrix")
def sparse_matrix_perf(smoke: bool = False, device=None) -> dict:
    """The host's sparse-matrix pipeline (ref src/test/sparse_matrix_perf.cc):
    key uniquification (countUniqIndex), localization, then the SpMV
    (:func:`_spmv`) on the device."""
    from ..utils.localizer import Localizer, count_uniq_keys
    from ..utils.sparse import random_sparse

    dev = _start(device)
    line = _Lines()
    n = 1 << (10 if smoke else 14)
    nnz = 64
    batch = random_sparse(n, 1 << 24, nnz, seed=0)

    sec = timeit(lambda: count_uniq_keys(batch), 3 if smoke else 10)
    line("sparse_uniq_keys_per_sec", batch.nnz / sec, "keys/sec")

    loc = Localizer()
    keys, _ = loc.count_uniq_index(batch)
    sec = timeit(lambda: loc.remap_index(keys), 3 if smoke else 10)
    line("sparse_localize_keys_per_sec", batch.nnz / sec, "keys/sec")

    local = loc.remap_index(keys)
    w = np.random.default_rng(0).normal(size=len(keys)).astype(np.float32)
    rows = local.row_ids().astype(np.int32)
    ucols = local.indices.astype(np.int64)
    vals = np.ones(local.nnz, np.float32) if local.binary else local.values.astype(np.float32)
    args = [_h2d(a, dev) for a in (vals, ucols, rows, w)]
    _spmv(*args, n)
    _sync(dev)
    ms = _arm_ms(lambda: _spmv(*args, n), dev, 5 if smoke else 20)
    line("sparse_spmv_mnnz_per_sec", batch.nnz / (ms / 1e3) / 1e6, "Mnnz/s")
    return {"metrics": line.values, "rows": n, "nnz": int(batch.nnz), "spmv_ms": ms,
            "mesh": _mesh_shape()}


# -- device benchmarks: attention, the step's phases --


@benchmark("attention")
def attention_perf(smoke: bool = False, device=None) -> dict:
    """The flash forward against the plain attention on one device (the
    per-chunk compute that ring sequence parallelism schedules): a chain
    of ``chain`` causal forwards a call, each output fed back as the next
    query so nothing is left unused, at B·H 4 × S 4096 × D 64 (smoke: S
    512, chain 2). GFLOP/s count the full 4·bh·s²·d a forward (the
    convention MFU tables use; causal needs about half).

    The plain arm (``flash_attention_ref``) runs everywhere, float32 and,
    on the card, bfloat16. On the card the ``cuda`` arms call
    ``ops/flash_attention.py::flash_attention``, which launches
    ``flash_fwd.cu`` (float32: 3xTF32 on the tensor cores; bfloat16);
    off the card there is no kernel arm, as the JAX benchmark has no
    flash arm off a TPU. Before the timing, each kernel arm's first
    forward and the plain one on the same inputs are kept in the record
    (``_first_forward``) for the caller to hold within a tolerance."""
    from ..ops import flash_attention as fa

    dev = _device(device)
    on_card = dev.type == "cuda"
    line = _Lines()
    bh, d = 4, 64
    s = 512 if smoke else 4096
    chain = 2 if smoke else 16
    rng = np.random.default_rng(0)
    q, k, v = (_h2d(rng.normal(size=(bh, s, d)).astype(np.float32), dev) for _ in range(3))
    counts = {"forwards": 0, "chain_calls": 0}

    def forward(kernel: bool, qc, kk, vv):
        if kernel:
            counts["forwards"] += 1
            return fa.flash_attention(qc, kk, vv, causal=True)
        return fa.flash_attention_ref(qc, kk, vv, causal=True)[0]

    def make_run(kernel: bool, dtype):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))

        def run():
            qc = qq
            for _ in range(chain):
                qc = forward(kernel, qc, kk, vv).to(dtype)
            if kernel:
                counts["chain_calls"] += 1
            return qc

        return run, (qq, kk, vv)

    flops = 4.0 * bh * s * s * d * chain
    n = 2 if smoke else 10
    first = {}
    with torch.no_grad():
        run, _ = make_run(False, torch.float32)
        ms = _arm_ms(run, dev, n)
        line("attention_plain_gflops", flops / (ms / 1e3) / 1e9, "GFLOP/s")
        times = {"plain_float32": ms}
        if on_card:
            for dtype, name in ((torch.float32, "cuda"), (torch.bfloat16, "cuda_bf16")):
                run, (qq, kk, vv) = make_run(True, dtype)
                first[str(dtype).split(".")[-1]] = (forward(True, qq, kk, vv),
                                                    forward(False, qq, kk, vv))
                ms = _arm_ms(run, dev, n)
                line(f"attention_{name}_gflops", flops / (ms / 1e3) / 1e9, "GFLOP/s")
                times[name] = ms
            run, _ = make_run(False, torch.bfloat16)
            ms = _arm_ms(run, dev, n)
            line("attention_plain_bf16_gflops", flops / (ms / 1e3) / 1e9, "GFLOP/s")
            times["plain_bf16"] = ms
    _sync(dev)
    return {"metrics": line.values, "shape_bh_s_d": [bh, s, d], "chain": chain,
            "ms_a_call": times, "cuda_forwards": counts["forwards"],
            "cuda_chain_calls": counts["chain_calls"], "_first_forward": first}


@benchmark("step_phases")
def step_phases_perf(smoke: bool = False, device=None) -> dict:
    """Each phase of the linear step on its own at the headline shape
    (16384 rows × 39 lanes; smoke 1024 × 8), at both headline table sizes,
    2^22 slots (the synthetic bench) and 2^26 (the real-data table):
    the bits wire's decode, the dense weights, the gather and row sum,
    the gradient by slot (the step's sorted ``segment_sum``: a stable
    sort, then ``segment_sum.cu`` on the card; the JAX phase's XLA
    scatter-add), and the FTRL update as the step runs it (in place,
    membership from the gradient's support, ``touched=None``:
    ``ftrl_dense.cu`` on the card). The phases' sum is not the fused
    step's time; it names the phase that takes it."""
    dev = _device(device)
    line = _Lines()
    rows, lanes = (1024, 8) if smoke else (16384, 39)
    out = {}
    for num_slots in ([1 << 14] if smoke else [1 << 22, 1 << 26]):
        out[num_slots] = _step_phases_at(rows, lanes, num_slots, smoke, dev, line)
    return {"metrics": line.values, "rows": rows, "lanes": lanes,
            "phase_ms": {str(k): v for k, v in out.items()}}


def _step_phases_at(rows: int, lanes: int, num_slots: int, smoke: bool, dev, line) -> dict:
    from ..apps.linear.learning_rate import LearningRate
    from ..apps.linear.penalty import ElasticNet
    from ..apps.linear.updaters import FTRLUpdater
    from ..ops.segment_sum import segment_sum
    from ..utils.bitpack import pack_bits, slot_bits, stream_to_words, unpack_bits, unpack_sign_bits

    tag = f"_s{num_slots.bit_length() - 1}"
    bits = slot_bits(num_slots)
    rng = np.random.default_rng(0)
    slots_host = rng.integers(0, num_slots, rows * lanes, np.int64)
    # the word layout the step's decode reads (uint32 words as their
    # int32 view, as an upload carries them)
    words = _h2d(stream_to_words(pack_bits(slots_host, bits), rows * lanes, bits).view(np.int32),
                 dev)
    y_bits = _h2d(np.packbits(rng.integers(0, 2, rows).astype(np.uint8)), dev)
    updater = FTRLUpdater(LearningRate(type_=LearningRate.DECAY, alpha=0.1, beta=1.0),
                          ElasticNet(1.0, 0.0))
    state = {
        "z": _h2d(rng.normal(size=num_slots).astype(np.float32), dev),
        "sqrt_n": _h2d(np.abs(rng.normal(size=num_slots)).astype(np.float32), dev),
    }
    rel = _h2d(slots_host, dev)
    gr = _h2d(rng.normal(size=rows).astype(np.float32), dev)
    grad = _h2d(rng.normal(size=num_slots).astype(np.float32), dev)
    n = 3 if smoke else 10
    ms = {}

    def timed_phase(name, fn):
        fn()  # warm, untimed
        _sync(dev)
        ms[name] = _arm_ms(fn, dev, n, budget_s=25.0)
        line(f"step_phase_{name}{tag}_ms", ms[name], "ms")

    timed_phase("decode", lambda: (unpack_bits(words, rows * lanes, bits),
                                   unpack_sign_bits(y_bits, rows)))
    timed_phase("weights_dense", lambda: updater.weights(state))
    # the gather on a precomputed dense weight vector: the dense
    # transform is its own phase above
    w_dense = updater.weights(state)
    timed_phase("gather_sum", lambda: w_dense.index_select(0, rel).reshape(rows, lanes).sum(1))
    timed_phase("scatter_add", lambda: segment_sum(
        gr[:, None].expand(rows, lanes).reshape(-1), rel, num_slots))
    # the FTRL phase as the step runs it: in place on the state
    st = {k: v.clone() for k, v in state.items()}
    timed_phase("ftrl_update", lambda: updater.apply(st, grad, None, seed=1))
    total = sum(ms.values()) / 1e3
    line(f"step_phase_sum{tag}_ms", total * 1e3, "ms")
    line(f"step_phase_sum{tag}_equiv_examples_per_sec", rows / total, "examples/sec")
    return ms


# -- host benchmarks: ingest, the wires, the executor --


def _write_synth_libsvm(path: str, rows: int, lanes: int, seed: int = 0) -> None:
    """Synthetic libsvm text: ``rows`` examples of ``lanes`` sorted
    unsigned features, ±1 labels (the Criteo-like shape the headline
    streams)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 1 << 31, (rows, lanes)), axis=1)
    labels = rng.choice((-1, 1), rows)
    with open(path, "w") as f:
        for i in range(rows):
            f.write(f"{labels[i]} " + " ".join(f"{k}:1" for k in keys[i]) + "\n")


def host_ingest_ab(smoke: bool = False, workers: "int | None" = None) -> dict:
    """Serial against pipelined host ingest (the host alone, no device).

    Both arms read the same libsvm file at the headline shape
    (16384-row × 39-lane Criteo-like batches) through the same per-shard
    ``Localizer`` prep (``prep_batch``: unique, inverse remap, pad). The
    serial arm is the reader's critical path: line parse and prep
    inline, batch by batch. The pipelined arm is the staged ingest
    plane: chunked byte parse (``StreamReader.minibatches_bytes``, raw
    chunks into the native parser on a small pool) feeding
    ``learner/ingest.py::IngestPipeline``'s ordered prep workers; the
    consumer only drains. The arms alternate, the rates aggregate every
    rep and the speedup is the median of the paired ratios."""
    import os
    import tempfile

    from ..apps.linear.async_sgd import prep_batch
    from ..data.stream_reader import StreamReader
    from ..learner.ingest import IngestPipeline
    from ..parameter.parameter import KeyDirectory

    rows_per_batch = 8192 if smoke else 16384
    n_batches = 4 if smoke else 6
    lanes = 24 if smoke else 39
    num_shards = 2
    num_slots = 1 << 22
    if workers is None:
        workers = max(2, min(4, os.cpu_count() or 2))
    directory = KeyDirectory(num_slots, hashed=True)
    rows_pad = -(-rows_per_batch // num_shards)
    nnz_pad = rows_pad * lanes

    def prep(b):
        return prep_batch(b, directory, num_shards, rows_pad, nnz_pad, nnz_pad, num_slots)

    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/ingest_ab.libsvm"
        _write_synth_libsvm(path, rows_per_batch * n_batches, lanes)

        def run_serial() -> float:
            n_ex = 0
            t0 = time.perf_counter()
            for b in StreamReader([path], "libsvm").minibatches(rows_per_batch):
                n_ex += prep(b).num_examples
            sec = time.perf_counter() - t0
            assert n_ex == rows_per_batch * n_batches, n_ex
            return sec

        def run_pipelined() -> float:
            src = StreamReader([path], "libsvm").minibatches_bytes(
                rows_per_batch, chunk_bytes=2 << 20, threads=3)
            pipe = IngestPipeline(src, prep_fn=prep, workers=workers, capacity=8,
                                  name="host_ingest_ab").start()
            n_ex = 0
            t0 = time.perf_counter()
            for p in pipe:
                n_ex += p.num_examples
            sec = time.perf_counter() - t0
            assert n_ex == rows_per_batch * n_batches, n_ex
            return sec

        run_serial()  # one shared warm pass
        reps = 5
        sers, pips = [], []
        for _ in range(reps):
            pips.append(run_pipelined())
            sers.append(run_serial())
    n_ex = rows_per_batch * n_batches * reps
    ratios = sorted(s / p for s, p in zip(sers, pips))
    return {
        "examples": n_ex,
        "minibatch": rows_per_batch,
        "lanes": lanes,
        "workers": workers,
        "reps": reps,
        "serial_examples_per_sec": round(n_ex / sum(sers), 1),
        "pipelined_examples_per_sec": round(n_ex / sum(pips), 1),
        "pipelined_speedup": round(ratios[len(ratios) // 2], 3),
    }


def _criteo_shape_batches(rows: int, lanes: int, n_batches: int, valued: bool = False,
                          seed: int = 0):
    """Batches on the headline bench's data law: 13 small-vocabulary
    integer fields and 26 power-law (cube of a uniform) categorical
    fields, keys salted by field, ±1 labels; ``valued`` adds float
    values (the quantized wire's arm)."""
    from ..utils.sparse import SparseBatch

    rng = np.random.default_rng(seed)
    n_int = min(13, lanes)
    n_cat = lanes - n_int
    out = []
    for _ in range(n_batches):
        ints = rng.integers(10, 100, size=(rows, n_int))
        u = rng.random((rows, n_cat))
        cats = (u * u * u * (1 << 24)).astype(np.int64)
        keys = np.concatenate(
            [(j << 40) | ints[:, j: j + 1] for j in range(n_int)]
            + [((100 + j) << 40) | cats[:, j: j + 1] for j in range(n_cat)],
            axis=1,
        ).astype(np.int64)
        y = rng.choice((-1.0, 1.0), rows).astype(np.float32)
        vals = (rng.random(rows * lanes) + 0.5).astype(np.float32) if valued else None
        out.append(SparseBatch(y=y, indptr=np.arange(0, rows * lanes + 1, lanes),
                               indices=keys.ravel(), values=vals))
    return out


# what an upload-cache hit ships: its crc32c signature and the shape and
# dtype that route it (filter/key_caching.py)
_SIG_BYTES = 16


def wire_ab(smoke: bool = False) -> dict:
    """Encoded against raw wires (the host alone, no device): the bytes
    each format ships a example at the headline shape, on data of the
    headline generator's law, the encode's cost and the parity bits.
    Arms: ``raw_exact`` (the exact wire's prepped arrays), ``exact``
    (``learner/wire.py::encode_exact``, its decode checked bit for bit
    each batch), ``bits`` (the ELL bits wire), ``stream`` (the lane
    dictionary, its decode checked against the hashed slots), and the
    valued stream raw against int8 fixed point. Later passes re-ship a
    batch as signatures through the upload key cache (``UploadCache``):
    ``amortized_bytes_per_example`` over the stated number of passes.
    The encode's cost is the median of back-to-back paired reps."""
    import dataclasses

    from ..apps.linear.async_sgd import (
        prep_batch_ell_bits,
        prep_batch_ell_stream,
        prep_batch_shared,
    )
    from ..learner.wire import (
        UploadCache,
        as_tensors,
        compress_batch,
        decode_exact_host,
        decode_stream_shard,
        derive_stream_statics,
        encode_exact,
        tree_nbytes,
    )
    from ..parameter.parameter import KeyDirectory
    from ..utils.murmur import hash_slots

    rows = 4096 if smoke else 16384
    lanes = 39
    n_batches = 2 if smoke else 4
    passes = 3
    num_shards = 2
    num_slots = 1 << 22
    directory = KeyDirectory(num_slots, hashed=True)
    rows_pad = rows // num_shards
    nnz_pad = rows_pad * lanes
    uniq_pad = -(-min(nnz_pad * num_shards, num_slots) // 1024) * 1024

    batches = _criteo_shape_batches(rows, lanes, n_batches)
    n_ex = rows * n_batches

    def prep(b):
        return prep_batch_shared(b, directory, num_shards, rows_pad, nnz_pad, uniq_pad, num_slots)

    raws = [prep(b) for b in batches]
    encs = [encode_exact(p, num_slots) for p in raws]
    assert all(e is not None for e in encs)
    parity = True
    for p, e in zip(raws, encs):
        for f, arr in zip(dataclasses.fields(type(p)), decode_exact_host(e, num_slots)):
            want = np.asarray(getattr(p, f.name))
            got = np.asarray(arr)
            parity &= bool(want.dtype == got.dtype and np.array_equal(want, got))
    bits = [prep_batch_ell_bits(b, directory, num_shards, rows_pad, lanes, num_slots)
            for b in batches]
    assert all(x is not None for x in bits)

    # the stream wire, statics pinned from the first batch as the worker
    # pins them, each shard's decode checked against the hashed slots
    st = derive_stream_statics(batches[0].indices, lanes, num_slots, num_slots)
    streams = [prep_batch_ell_stream(b, directory, num_shards, rows_pad, lanes, num_slots, st)
               for b in batches]
    stream_parity = st is not None and all(s is not None for s in streams)
    if stream_parity:
        for b, s in zip(batches, streams):
            per = -(-b.n // num_shards)
            t = as_tensors(s)
            for d in range(num_shards):
                lo, hi = min(d * per, b.n), min((d + 1) * per, b.n)
                seg = slice(b.indptr[lo], b.indptr[hi])
                want = hash_slots(np.ascontiguousarray(b.indices[seg], np.uint64),
                                  num_slots).reshape(hi - lo, lanes)
                y, _mask, slots = decode_stream_shard(t, d)
                stream_parity &= bool(
                    np.array_equal(slots.numpy()[: hi - lo], want)
                    and np.array_equal(y.numpy()[: hi - lo], b.y[lo:hi]))
    bpe = {
        "raw_exact": sum(tree_nbytes(p) for p in raws) / n_ex,
        "exact": sum(tree_nbytes(e) for e in encs) / n_ex,
        "bits": sum(tree_nbytes(x) for x in bits) / n_ex,
        **({"stream": sum(tree_nbytes(s) for s in streams) / n_ex} if stream_parity else {}),
    }

    # the staging leg's LZ frames (the host-to-host leg, not the copy to
    # the card), quoted apart from the bytes above
    lz_bpe = {}
    for name, parts in (("exact", encs), ("bits", bits),
                        *((("stream", streams),) if stream_parity else ())):
        lz_bpe[name] = round(sum(compress_batch(p).wire_nbytes for p in parts) / n_ex, 1)

    vbatches = _criteo_shape_batches(rows, lanes, n_batches, valued=True, seed=1)
    vraws = [prep(b) for b in vbatches]
    vencs = [encode_exact(p, num_slots, mode="int8") for p in vraws]
    assert all(e is not None for e in vencs)
    bpe["raw_valued"] = sum(tree_nbytes(p) for p in vraws) / n_ex
    bpe["int8_valued"] = sum(tree_nbytes(e) for e in vencs) / n_ex

    def amortize(parts):
        shipped = 0
        cache = UploadCache(lambda batch: batch, max_bytes=1 << 30)
        for _ in range(passes):
            for part in parts:
                b0, h0 = cache.saved_bytes, cache.hits
                cache(part)
                shipped += tree_nbytes(part) - (cache.saved_bytes - b0)
                shipped += _SIG_BYTES * (cache.hits - h0)
        return shipped / (n_ex * passes), cache

    amort_exact, cache_e = amortize(encs)
    amort_bits, cache_b = amortize(bits)

    reps = 3 if smoke else 5
    t_prep, t_enc = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        for b in batches:
            prep(b)
        t_prep.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for b in batches:
            encode_exact(prep(b), num_slots)
        t_enc.append(time.perf_counter() - t0)
    ratios = sorted(e / p for e, p in zip(t_enc, t_prep))

    raw_baseline = bpe["bits"]
    out = {
        "minibatch": rows,
        "lanes": lanes,
        "num_slots": num_slots,
        "batches": n_batches,
        "passes": passes,
        "bytes_per_example": {k: round(v, 1) for k, v in bpe.items()},
        "amortized_bytes_per_example": {"exact_cached": round(amort_exact, 1),
                                        "bits_cached": round(amort_bits, 1)},
        "raw_baseline_bytes_per_example": round(raw_baseline, 1),
        "reduction_vs_raw_baseline": {
            "lossless_default_amortized": round(raw_baseline / amort_bits, 2),
            "exact_encode_amortized": round(raw_baseline / amort_exact, 2),
            **({"stream_cache_free": round(raw_baseline / bpe["stream"], 2)}
               if stream_parity else {}),
        },
        "lz_staging_bytes_per_example": lz_bpe,
        "stream_parity_bit_identical": bool(stream_parity),
        "exact_reduction_vs_raw_exact": round(bpe["raw_exact"] / bpe["exact"], 2),
        "int8_reduction_vs_raw_valued": round(bpe["raw_valued"] / bpe["int8_valued"], 2),
        "exact_parity_bit_identical": bool(parity),
        "cache": {
            "hits": cache_e.hits + cache_b.hits,
            "misses": cache_e.misses + cache_b.misses,
            "saved_mb": round((cache_e.saved_bytes + cache_b.saved_bytes) / 1e6, 1),
        },
        "encode_over_prep_median_ratio": round(ratios[len(ratios) // 2], 3),
        "prep_examples_per_sec": round(n_ex * reps / sum(t_prep), 1),
        "prep_encode_examples_per_sec": round(n_ex * reps / sum(t_enc), 1),
    }
    out["fused_prep"] = stream_prep_ab(smoke)
    return out


def stream_prep_ab(smoke: bool = False) -> dict:
    """The native fused stream prep against the numpy path (the host
    alone): ``ps_stream_encode`` (hash, per-lane unique, remap, bit-pack
    in one C call, ``native/psnative.cc``) against
    ``learner/wire.py::encode_stream_shard_ref`` (the hash, then the numpy
    passes). Both give byte-identical buffers, checked before any time
    is quoted; the speedup is the median of back-to-back paired reps.
    The port builds its native library at its first use and raises when
    the build fails, so the native arm is always present."""
    from .. import native
    from ..learner.wire import derive_stream_statics, encode_stream_shard, encode_stream_shard_ref
    from ..utils.murmur import hash_slots

    rows = 4096 if smoke else 16384
    lanes = 39
    num_slots = 1 << 22
    b = _criteo_shape_batches(rows, lanes, 1, seed=3)[0]
    keys = np.ascontiguousarray(b.indices, np.uint64)
    st = derive_stream_statics(keys, lanes, num_slots, num_slots)
    assert st is not None, "Criteo-law data must take the lane dictionary"
    lib = native.library()
    native_ok = getattr(lib, "ps_stream_encode", None) is not None
    out = {"minibatch": rows, "lanes": lanes, "num_slots": num_slots,
           "native_available": bool(native_ok), "dict_lanes": len(st.dict_lanes)}

    def run_py():
        return encode_stream_shard_ref(hash_slots(keys, num_slots), rows, rows, st)

    def run_native():
        return encode_stream_shard(keys, rows, rows, num_slots, st)

    ref = run_py()
    assert ref is not None
    if native_ok:
        for a, c in zip(run_native(), ref):
            assert np.array_equal(np.asarray(a), np.asarray(c)), (
                "native fused prep diverged from the numpy path")

    reps = 3 if smoke else 5
    t_py, t_nat = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_py()
        t_py.append(time.perf_counter() - t0)
        if native_ok:
            t0 = time.perf_counter()
            run_native()
            t_nat.append(time.perf_counter() - t0)
    py_ms = sorted(t_py)[len(t_py) // 2] * 1e3
    out["python_ms_median"] = round(py_ms, 3)
    out["python_examples_per_sec"] = round(rows / (py_ms / 1e3), 1)
    out["reps"] = reps
    if native_ok:
        nat_ms = sorted(t_nat)[len(t_nat) // 2] * 1e3
        out["native_ms_median"] = round(nat_ms, 3)
        out["native_examples_per_sec"] = round(rows / (nat_ms / 1e3), 1)
        out["speedup_median_paired"] = round(py_ms / nat_ms, 2)
        out["parity_byte_identical"] = True
    return out


@benchmark("stream_prep")
def stream_prep_perf(smoke: bool = False, device=None) -> dict:
    """The native fused stream prep against the numpy passes it
    replaces (:func:`stream_prep_ab`), byte-identical output checked."""
    _device(device)
    line = _Lines()
    out = stream_prep_ab(smoke)
    line("stream_prep_python_examples_per_sec", out["python_examples_per_sec"], "examples/sec")
    if out["native_available"]:
        line("stream_prep_native_examples_per_sec", out["native_examples_per_sec"],
             "examples/sec")
        line("stream_prep_speedup_median_paired", out["speedup_median_paired"], "x")
    return {"metrics": line.values, **out}


@benchmark("wire")
def wire_perf(smoke: bool = False, device=None) -> dict:
    """Encoded against raw wires (:func:`wire_ab`): bytes a example and
    the encode's cost, on the host."""
    _device(device)
    line = _Lines()
    out = wire_ab(smoke)
    for k, v in out["bytes_per_example"].items():
        line(f"wire_bytes_per_example_{k}", v, "bytes")
    for k, v in out["amortized_bytes_per_example"].items():
        line(f"wire_amortized_bytes_per_example_{k}", v, f"bytes ({out['passes']} passes)")
    for k, v in out["reduction_vs_raw_baseline"].items():
        line(f"wire_{k}_reduction_vs_raw_baseline", v, "x")
    line("wire_encode_over_prep_median_ratio", out["encode_over_prep_median_ratio"], "x")
    return {"metrics": line.values, **out}


@benchmark("host_ingest")
def host_ingest_perf(smoke: bool = False, device=None) -> dict:
    """Serial against pipelined host ingest (:func:`host_ingest_ab`), on
    the host alone, as ``network`` isolates the copy."""
    _device(device)
    line = _Lines()
    out = host_ingest_ab(smoke)
    line("host_ingest_serial_examples_per_sec", out["serial_examples_per_sec"], "examples/sec")
    line("host_ingest_pipelined_examples_per_sec", out["pipelined_examples_per_sec"],
         "examples/sec")
    line("host_ingest_pipelined_speedup", out["pipelined_speedup"], "x")
    return {"metrics": line.values, **out}


@benchmark("executor")
def executor_perf(smoke: bool = False, device=None) -> dict:
    """The executor's dispatch cost on the host (the reference's
    Customer/Executor path, src/system/executor.cc): trivial steps a
    second through submit → dependency check → dispatch thread → wait,
    independent and chained. The device loops submit T minibatches at
    once because this ceiling exists."""
    from ..system.executor import Executor, Task

    _device(device)
    line = _Lines()
    n = 500 if smoke else 5000
    ex = Executor("bench")
    ex2 = Executor("bench-chain")

    def burst_independent():
        ts = [ex.submit(lambda: None) for _ in range(n)]
        ex.wait(ts[-1])
        for t in ts[:-1]:
            ex.wait(t)

    def burst_chained():
        prev = ex2.submit(lambda: None)
        for _ in range(n - 1):
            prev = ex2.submit(lambda: None, task=Task(wait_time=[prev]))
        ex2.wait(prev)

    try:
        sec = timeit(burst_independent, 1 if smoke else 3)
        line("executor_dispatch_steps_per_sec", n / sec, "steps/sec")
        sec = timeit(burst_chained, 1 if smoke else 3)
        line("executor_chained_steps_per_sec", n / sec, "steps/sec")
    finally:
        ex.stop()
        ex2.stop()
    return {"metrics": line.values, "steps": n}


# -- device benchmarks: the FTRL updates, the roofline --

FTRL_KW = dict(alpha=0.1, beta=1.0, l1=0.05, l2=0.0)


def _sparse_touch_pattern(p: int, u: int, seed: int = 0):
    """A deduplicated touch pattern for the sparse update: sorted unique
    slot ids (prep's ``np.unique`` shape) for ~7/8 of the padded width,
    the rest sentinel-style (the last slot, ``ok`` false): the localize
    contract the sparse update sees."""
    rng = np.random.default_rng(seed)
    live = rng.choice(p, min(u - u // 8, p // 2), replace=False)
    rel = np.full(u, p - 1, np.int32)
    rel[: len(live)] = np.sort(live).astype(np.int32)
    ok = np.zeros(u, bool)
    ok[: len(live)] = True
    g = rng.normal(size=u).astype(np.float32)
    return rel, ok, g, len(live)


def _state_bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def ftrl_sparse_ab(smoke: bool = False, device=None) -> dict:
    """The plain rows formulation against the ``ftrl_sparse`` kernel for
    the sparse-touched FTRL update (``update='sparse'``,
    ``ops/ftrl_sparse.py``), both in place over the same state and touch
    pattern, at P 2^22 slots and U 2^16 positions (smoke 2^18, 2^11):

    - ``plain``: ``ftrl_sparse_rows_ref`` (gather, update, scatter, as
      separate PyTorch ops);
    - ``cuda``: ``ftrl_sparse_update``, on the card one ``ftrl_sparse.cu``
      launch a call; on the CPU it takes the same plain version
      (``fused_is_fallback: true``).

    The arms alternate; each rep times a fixed number of calls of each
    (on the card ``median_ms``), the speedup is the median of the paired
    ratios. Both arms make the same calls from the same start, so their
    final z and √n must be bit-equal (``cuda_bit_equal_plain``). The
    bytes are the card's, counted from the inputs by
    ``benchmarks/ftrl_bytes.py`` (each input read once, each output
    written once, at the live positions; and the 32-byte sectors they
    touch): the bound and the achieved rate derive from them."""
    from ..ops.ftrl_sparse import ftrl_sparse_rows_ref, ftrl_sparse_update
    from . import ftrl_bytes

    dev = _device(device)
    on_card = dev.type == "cuda"
    p = 1 << (18 if smoke else 22)
    u = 1 << (11 if smoke else 16)
    rel_h, ok_h, g_h, n_live = _sparse_touch_pattern(p, u)
    rng = np.random.default_rng(1)
    z0 = rng.normal(size=p).astype(np.float32)
    n0 = np.abs(rng.normal(size=p)).astype(np.float32)
    rel, ok, g = _h2d(rel_h, dev), _h2d(ok_h, dev), _h2d(g_h, dev)
    counts = ftrl_bytes.sparse_counts(rel, ok, g, 4)
    calls = {"plain": 0, "cuda": 0}
    boxes = {name: (_h2d(z0, dev), _h2d(n0, dev)) for name in calls}

    def plain():
        calls["plain"] += 1
        ftrl_sparse_rows_ref(*boxes["plain"], rel, ok, g, **FTRL_KW)

    def cuda():
        calls["cuda"] += 1
        ftrl_sparse_update(*boxes["cuda"], rel, ok, g, **FTRL_KW)

    arms = {"plain": plain, "cuda": cuda}
    for fn in arms.values():  # warm, untimed
        fn()
    _sync(dev)
    reps = 3 if smoke else 5
    n_calls = 2 if smoke else 4
    times = {name: [] for name in arms}
    for _ in range(reps):
        for name, fn in arms.items():
            times[name].append(_calls_ms(fn, dev, n_calls))
    _sync(dev)
    ratios = sorted(x / f for x, f in zip(times["plain"], times["cuda"]))
    ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    bit_equal = calls["plain"] == calls["cuda"] and _state_bits_equal(boxes["plain"],
                                                                      boxes["cuda"])
    hbm_peak = peak(HBM_PEAK_GB_S, dev)
    gb_s = counts["bytes"] / (ms["cuda"] / 1e3) / 1e9
    bound_ms = ftrl_bytes.ms(counts["bytes"])
    return {
        "num_slots": p,
        "uniq_pad": u,
        "live_slots": n_live,
        "device": str(dev),
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "fused_is_fallback": not on_card,
        "plain_ms": round(ms["plain"], 4),
        "cuda_ms": round(ms["cuda"], 4),
        "cuda_speedup_median_paired": round(ratios[len(ratios) // 2], 3),
        "reps": reps,
        "calls_per_rep": n_calls,
        "cuda_calls": calls["cuda"],
        "plain_calls": calls["plain"],
        "cuda_bit_equal_plain": bool(bit_equal),
        "bytes_model": {
            "bytes": int(counts["bytes"]),
            "sector_bytes": int(counts["sector_bytes"]),
            "live": int(counts["members"]),
            "note": "benchmarks/ftrl_bytes.py::sparse_counts: ok at every position, g_u "
                    "where ok, rel and z, sqrt_n read and written at the live positions; "
                    "sector_bytes adds the 32-byte sectors they touch",
        },
        "bound_ms": bound_ms,
        "sector_floor_ms": ftrl_bytes.ms(counts["sector_bytes"]),
        "frac_of_bound": round(bound_ms / ms["cuda"], 4) if on_card else None,
        "hbm_gb_s": round(gb_s, 5),
        "hbm_peak_gb_s": hbm_peak,
        "frac_of_peak": round(gb_s / hbm_peak, 4) if hbm_peak else None,
    }


@benchmark("ftrl_sparse_ab")
def ftrl_sparse_perf(smoke: bool = False, device=None) -> dict:
    """The sparse-update A/B (:func:`ftrl_sparse_ab`)."""
    line = _Lines()
    out = ftrl_sparse_ab(smoke, device)
    line("ftrl_sparse_plain_ms", out["plain_ms"], "ms")
    line("ftrl_sparse_cuda_ms", out["cuda_ms"], "ms")
    line("ftrl_sparse_cuda_speedup", out["cuda_speedup_median_paired"], "x")
    # MB/s: on a loaded CPU the smoke's GB/s falls under report()'s 2
    # decimals (0.00)
    line("ftrl_sparse_cuda_hbm_mb_s", out["hbm_gb_s"] * 1e3, "MB/s")
    # `is not None`: a share that rounds to 0.0 must still be reported
    if out["frac_of_peak"] is not None:
        line("ftrl_sparse_cuda_frac_of_peak", out["frac_of_peak"], "fraction")
    return {"metrics": line.values, **out}


def _ftrl_chain_bytes(g: torch.Tensor, chain_len: int) -> int:
    """Bytes of ``chain_len`` dense updates without a mask
    (``ftrl_bytes.dense_counts``: g read, z and √n read and written at
    the members), each update counted alone."""
    from . import ftrl_bytes

    return chain_len * ftrl_bytes.dense_counts(g != 0, 4, masked=False)["bytes"]


@benchmark("ftrl_chain")
def ftrl_chain_perf(smoke: bool = False, device=None) -> dict:
    """The dense update, 8 chained in place a call: ``plain``
    (``ftrl_update_ref``) and, on the card, ``cuda`` (``ftrl_update``:
    8 ``ftrl_dense.cu`` launches a call), at the JAX package's chip sizes
    2^24, 2^26 and 2^28 slots on the card (2^28 is 3 GiB of z, √n and g),
    2^18 and 2^20 on the CPU, 2^14 at smoke. Off the card there is no
    kernel arm, as the JAX benchmark has no Pallas arm off a TPU. The
    arms alternate over a fixed number of calls each from the same start,
    so at each size their final z and √n must be bit-equal
    (``cuda_bit_equal_plain``; the kernel is built with
    ``--fmad=false``). GB/s count the card's bytes from the inputs
    (:func:`_ftrl_chain_bytes`: 20 a slot an update with every slot a
    member)."""
    from ..ops.ftrl import ftrl_update, ftrl_update_ref

    dev = _device(device)
    on_card = dev.type == "cuda"
    line = _Lines()
    chain_len = 8
    if smoke:
        sizes = (1 << 14,)
    elif on_card:
        sizes = (1 << 24, 1 << 26, 1 << 28)
    else:
        sizes = (1 << 18, 1 << 20)
    reps = 2 if smoke else 3
    n_calls = 2 if smoke else 5
    out = {}
    for p in sizes:
        tag = f"2e{p.bit_length() - 1}"
        gen = torch.Generator(device=dev)
        gen.manual_seed(p)
        z0 = torch.randn(p, generator=gen, device=dev)
        n0 = torch.randn(p, generator=gen, device=dev).abs_()
        g = torch.randn(p, generator=gen, device=dev)
        nbytes = _ftrl_chain_bytes(g, chain_len)
        arm_fns = {"plain": ftrl_update_ref}
        if on_card:
            arm_fns["cuda"] = ftrl_update
        boxes = {name: (z0.clone(), n0.clone()) for name in arm_fns}
        calls = {name: 0 for name in arm_fns}
        del z0, n0

        def chain(name):
            def run():
                calls[name] += 1
                z, n = boxes[name]
                for _ in range(chain_len):
                    arm_fns[name](z, n, g, None, **FTRL_KW)
            return run

        runs = {name: chain(name) for name in arm_fns}
        for run in runs.values():  # warm, untimed
            run()
        times = {name: [] for name in runs}
        for _ in range(reps):
            for name, run in runs.items():
                times[name].append(_calls_ms(run, dev, n_calls))
        _sync(dev)
        rec = {"bytes_a_call": nbytes, "calls": dict(calls)}
        for name in runs:
            ms = float(np.median(times[name]))
            rec[f"{name}_ms"] = ms
            line(f"ftrl_dense_{name}_{tag}_chain_ms", ms, "ms")
            line(f"ftrl_dense_{name}_{tag}_chain_per_update_ms", ms / chain_len, "ms")
            line(f"ftrl_dense_{name}_{tag}_chain_gb_s", nbytes / (ms / 1e3) / 1e9, "GB/s")
        if on_card:
            from . import ftrl_bytes

            rec["bound_ms"] = ftrl_bytes.ms(nbytes)
            rec["frac_of_bound"] = rec["bound_ms"] / rec["cuda_ms"]
            rec["cuda_bit_equal_plain"] = bool(
                calls["plain"] == calls["cuda"]
                and _state_bits_equal(boxes["plain"], boxes["cuda"]))
        out[tag] = rec
        del boxes, g
        if on_card:
            torch.cuda.empty_cache()
    return {"metrics": line.values, "chain_len": chain_len, "sizes": out}


def _flash_flops(bh: int, s: int, d: int, device) -> float:
    """FLOP of one causal attention forward as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them over the
    plain version (its two matmuls; the mask, softmax and scaling count
    nothing), on a tensor of that shape."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops.flash_attention import flash_attention_ref

    q = torch.zeros(bh, s, d, device=device)
    with FlopCounterMode(display=False) as fc:
        flash_attention_ref(q, q, q, causal=True)
    return float(fc.get_total_flops())


def flash_cost_crosscheck(smoke: bool = False, device=None) -> dict:
    """The flash forward's hand FLOP model ``4·bh·s²·d`` (the MFU
    convention) against an independent count: ``FlopCounterMode`` over
    the plain version at the same shape (:func:`_flash_flops`; XLA's cost
    analysis has no counterpart here). One timed plain forward gives the
    TFLOP/s both counts imply; the share of the card's peak only where
    the peak table knows the card (``mfu_hand`` is None on the CPU)."""
    from ..ops.flash_attention import flash_attention_ref

    dev = _device(device)
    bh, d = 4, 64
    s = 256 if smoke else 1024
    rng = np.random.default_rng(0)
    q, k, v = (_h2d(rng.normal(size=(bh, s, d)).astype(np.float32), dev) for _ in range(3))
    hand_flops = 4.0 * bh * s * s * d
    counted = _flash_flops(bh, s, d, dev)

    def fwd():
        flash_attention_ref(q, k, v, causal=True)

    fwd()  # warm, untimed
    _sync(dev)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        fwd()
    _sync(dev)
    sec = (time.perf_counter() - t0) / reps
    pk = peak(FLOPS_PEAK_TFLOPS, dev)
    out = {
        "shape_bh_s_d": [bh, s, d],
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "hand_flops": int(hand_flops),
        "hand_tflops": round(hand_flops / sec / 1e12, 5),
        "counted_flops": int(counted),
        "hand_over_counted_ratio": round(hand_flops / counted, 3) if counted else None,
        "counted_tflops": round(counted / sec / 1e12, 5),
        "counter": "torch.utils.flop_counter.FlopCounterMode over flash_attention_ref",
    }
    if pk:
        out["mfu_hand"] = round(hand_flops / sec / 1e12 / pk, 6)
        out["mfu_counted"] = round(counted / sec / 1e12 / pk, 6)
    else:
        out["mfu_hand"] = None  # no peak for this device: never faked
    return out


@benchmark("roofline")
def roofline_probe(smoke: bool = False, device=None) -> dict:
    """The device truth plane end to end (``telemetry/device.py``): two
    probes through ``DeviceInventory.instrument(..., cost=...)`` with
    every call timed (sampling 1), each call's time set against the work
    its wrap point declares:

    - ``roofline_ftrl_chain``: 8 chained dense FTRL updates in place
      (``ftrl_update``: ``ftrl_dense.cu`` on the card, the plain version
      on the CPU); its bytes from ``benchmarks/ftrl_bytes.py``
      (:func:`_ftrl_chain_bytes`), no FLOP (``FlopCounterMode`` counts
      none in it);
    - ``roofline_flash_fwd``: one causal flash forward
      (``flash_attention``: ``flash_fwd.cu`` on the card), its FLOP as
      ``FlopCounterMode`` counts them over the plain version
      (:func:`_flash_flops`), its bytes q, k, v read and the output
      written once.

    Reports the achieved MB/s and GFLOP/s of each, the shares of the
    card's peaks where the tables know the card (never on the CPU), and
    the inventory's signature count (a steady probe: one each)."""
    from ..ops.flash_attention import flash_attention
    from ..ops.ftrl import ftrl_update
    from ..telemetry import device as device_tel

    dev = _device(device)
    line = _Lines()
    inv = device_tel.DeviceInventory()
    inv.set_sampling(1)
    rng = np.random.default_rng(0)
    calls = {"ftrl": 0, "flash": 0}

    p = 1 << (14 if smoke else 20)
    g = _h2d(rng.normal(size=p).astype(np.float32), dev)
    chain_bytes = _ftrl_chain_bytes(g, 8)

    def chain(z, n, g):
        calls["ftrl"] += 1
        for _ in range(8):
            ftrl_update(z, n, g, None, **FTRL_KW)
        return z, n

    ftrl_fn = inv.instrument("roofline_ftrl_chain", chain, donate_argnums=(0, 1),
                             cost=lambda z, n, g: {"bytes_accessed": chain_bytes})
    box = [_h2d(rng.normal(size=p).astype(np.float32), dev),
           _h2d(np.abs(rng.normal(size=p)).astype(np.float32), dev)]
    for _ in range(3 if smoke else 5):
        box = list(ftrl_fn(*box, g))
    _sync(dev)

    bh, s, d = 4, 256 if smoke else 1024, 64
    q, k, v = (_h2d(rng.normal(size=(bh, s, d)).astype(np.float32), dev) for _ in range(3))
    flash_flops = _flash_flops(bh, s, d, dev)
    flash_bytes = 4 * (4 * bh * s * d) + 4 * bh * s  # q, k, v read; the output and lse written

    def flash(qq, kk, vv):
        calls["flash"] += 1
        return flash_attention(qq, kk, vv, causal=True)

    flash_fn = inv.instrument(
        "roofline_flash_fwd", flash,
        cost=lambda qq, kk, vv: {"flops": flash_flops, "bytes_accessed": flash_bytes})
    with torch.no_grad():
        for _ in range(3 if smoke else 5):
            flash_fn(q, k, v)
    _sync(dev)

    snap = inv.snapshot()
    recompiles = sum(rec["recompiles"] for rec in snap["functions"].values())
    line("roofline_functions", len(snap["functions"]), "fns")
    line("roofline_steady_recompiles_plus_one", recompiles + 1, "compiles")
    for name, rec in sorted(snap["functions"].items()):
        tl = rec.get("roofline") or {}
        if tl.get("achieved_gb_s") is not None:
            # MB/s: a probe moves a few MB a call, and on a loaded host
            # its GB/s falls under report()'s 2 decimals (0.00)
            line(f"{name}_mb_s", tl["achieved_gb_s"] * 1e3, "MB/s")
        if tl.get("achieved_tflops") is not None:
            # GFLOP/s: report()'s 2 decimals would flatten a CPU's TFLOP/s
            line(f"{name}_gflops", tl["achieved_tflops"] * 1e3, "GFLOP/s")
        if tl.get("frac_of_hbm_peak") is not None:
            line(f"{name}_hbm_peak_pct", tl["frac_of_hbm_peak"] * 100.0, "pct")
        if tl.get("mfu") is not None:
            line(f"{name}_mfu_pct", tl["mfu"] * 100.0, "pct")
    return {"metrics": line.values, "functions": snap["functions"], "calls": calls,
            "ftrl_slots": p, "flash_shape_bh_s_d": [bh, s, d]}


# -- the plane probes: serving --


def _serve_store(num_slots: int, key_space: int, device, seed: int = 0):
    """A trained-looking weight table (``KVVector`` of ``num_slots`` × 1)
    and a power-law key draw over ``key_space`` (a small hot set carries
    most of the traffic), from a pre-drawn pool so that the arrival
    thread is not throttled by its own draws."""
    from ..parameter.kv_vector import KVVector

    dev = _start(device)
    kv = KVVector(k=1, num_slots=num_slots, hashed=True, name="serve_w", device=dev)
    rng = np.random.default_rng(seed)
    warm_keys = np.unique(rng.integers(0, key_space, 4096))
    vals = rng.normal(size=(len(warm_keys), 1)).astype(np.float32)
    kv.wait(kv.push(kv.request(channel=0), keys=warm_keys, values=vals))
    u = rng.random((256, 64))
    pool = (u * u * u * key_space).astype(np.int64)

    def draw_keys(i: int, n: int = 16) -> np.ndarray:
        return pool[i % len(pool), :n]

    return kv, draw_keys


def serve_ab(smoke: bool = False, device=None) -> dict:
    """Latency-first serving: open-loop Poisson load against the request
    path (``serving/``, doc/SERVING.md), over a ``KVVector`` on the card.

    - **capacity**: closed-loop calibration of the per-request cost
      (replica-served pulls), from which the offered loads derive;
    - **points**: open loop at 0.25× and 3× capacity with admission
      control (the door sheds instead of queueing);
    - **no_admission_overload**: the same overload without admission;
    - **coalesce**: concurrent overlapping-key pulls through the live
      table (replica off): submits a request and the key dedup;
    - **decode**: the LM lane, ``speculative_generate`` on tiny
      random-init models as served ``DecodeRequest``s (prefill through
      ``flash_fwd`` on the card; the draft has one head of 16 where the
      JAX draft has two of 8, the kernel's smallest float32 head being
      16).

    Percentiles, not means: under overload a mean hides the tail the SLO
    bounds."""
    from ..models.speculative import speculative_generate
    from ..models.transformer import LMConfig, init_lm
    from ..parallel import sequence
    from ..serving import DecodeRequest, PullRequest, ServeConfig, ServeFrontend, open_loop_bench

    num_slots = 1 << (12 if smoke else 16)
    key_space = 1 << 20
    keys_per_req = 16
    kv, draw_keys = _serve_store(num_slots, key_space, device)
    dev = kv.device
    # inside a world every rank builds the order of kv's calls here; rank 0
    # serves through it and the other ranks follow its calls
    order = sequence.Order(kv, name="serve") if sequence.needed(kv) else None
    if order is not None and not order.leader:
        try:
            order.follow()
        finally:
            kv.executor.stop()
        return {"follower": True, "mesh": _mesh_shape()}
    store = kv if order is None else order

    fe = None
    try:
        fe = ServeFrontend(store, ServeConfig(replica="full", workers=2,
                                              max_queue_depth=4096)).start()
        n_cal = 60 if smoke else 300
        for i in range(10):
            fe.submit(PullRequest(keys=draw_keys(i, keys_per_req))).result(30)
        t0 = time.perf_counter()
        for i in range(n_cal):
            fe.submit(PullRequest(keys=draw_keys(i, keys_per_req))).result(30)
        closed_loop_rate = n_cal / (time.perf_counter() - t0)

        # the door admits ~0.6x the calibration and bounds the backlog
        # at a depth whose drain time is the p99 budget
        admit_rate = max(50.0, 0.6 * closed_loop_rate)
        max_depth = 32 if smoke else 64
        duration = 1.0 if smoke else 2.5
        fe.close()
        fe = ServeFrontend(store, ServeConfig(
            replica="full", workers=2, admission_rate=admit_rate,
            admission_burst=admit_rate / 10, max_queue_depth=max_depth)).start()
        points = []
        for mult in (0.25, 3.0):
            points.append(open_loop_bench(
                fe, lambda i: PullRequest(keys=draw_keys(i, keys_per_req)),
                rate=mult * closed_loop_rate, duration_s=duration, seed=int(mult * 10),
                collectors=2, warmup_requests=5,
            ) | {"offered_multiple_of_capacity": mult, "admission": "on"})
        fe.close()

        fe = ServeFrontend(store, ServeConfig(replica="full", workers=2,
                                              max_queue_depth=0)).start()
        no_adm = open_loop_bench(
            fe, lambda i: PullRequest(keys=draw_keys(i, keys_per_req)),
            rate=3.0 * closed_loop_rate, duration_s=duration, seed=30, collectors=2,
            warmup_requests=5,
        ) | {"offered_multiple_of_capacity": 3.0, "admission": "off"}
        fe.close()

        fe = ServeFrontend(store, ServeConfig(replica="off", workers=8,
                                              coalesce_window_s=0.002,
                                              max_queue_depth=4096)).start()
        n_co = 200 if smoke else 600
        tickets = [fe.submit(PullRequest(keys=draw_keys(i, keys_per_req))) for i in range(n_co)]
        for t in tickets:
            t.result(60)
        co_stats = fe.stats()["coalescer"]
        probe = np.unique(draw_keys(3, keys_per_req))
        direct = store.values(0, probe)
        served = fe.submit(PullRequest(keys=probe)).result(30)
        assert np.allclose(served, direct), "coalesced pull diverged"
        fe.close()

        tcfg = LMConfig(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)
        # one head of 16 (the JAX draft has two of 8): the float32 flash
        # kernel's smallest head is 16
        dcfg = LMConfig(vocab=64, d_model=16, n_heads=1, n_layers=1, d_ff=32)
        tparams = init_lm(0, tcfg, dev)
        dparams = init_lm(1, dcfg, dev)
        gamma = 4
        batch, prompt_len, steps = 2, 16, 8 if smoke else 16
        last_stats = {}

        def decode_fn(req: DecodeRequest):
            with torch.no_grad():
                out, st = speculative_generate(tparams, tcfg, dparams, dcfg, req.prompt,
                                               req.steps, gamma=gamma, return_stats=True)
            last_stats["rounds"] = int(st["rounds"])
            last_stats["accepted_frac"] = round(float(st["accepted_frac"]), 3)
            return out

        fe = ServeFrontend(store, ServeConfig(replica="full", workers=1, max_queue_depth=64),
                           decode_fn=decode_fn).start()
        rng = np.random.default_rng(11)

        def decode_req(i: int) -> DecodeRequest:
            return DecodeRequest(prompt=rng.integers(0, 64, (batch, prompt_len)).astype(np.int32),
                                 steps=steps)

        t0 = time.perf_counter()
        fe.submit(decode_req(0)).result(300)  # the first call, excluded
        compile_s = time.perf_counter() - t0
        n_dec = 2 if smoke else 4
        lat = []
        t0 = time.perf_counter()
        for i in range(n_dec):
            tk = fe.submit(decode_req(1 + i))
            tk.result(300)
            lat.append(tk.latency_s())
        dec_wall = time.perf_counter() - t0
        fe.close()

        return {
            "closed_loop_capacity_per_sec": round(closed_loop_rate, 1),
            "keys_per_request": keys_per_req,
            "points": points,
            "no_admission_overload": no_adm,
            "p99_overload_over_low_admitted": round(
                points[1]["latency_ms"]["p99_ms"]
                / max(1e-9, points[0]["latency_ms"]["p99_ms"]), 2),
            "p99_overload_over_low_unprotected": round(
                no_adm["latency_ms"]["p99_ms"] / max(1e-9, points[0]["latency_ms"]["p99_ms"]), 2),
            "coalesce": {"concurrent_requests": n_co, **co_stats},
            "decode": {
                "model": "byte-LM random-init (the lane's wiring and latency accounting): "
                         "target d32 2 heads 2 layers, draft d16 1 head 1 layer",
                "gamma": gamma,
                "batch": batch,
                "prompt_len": prompt_len,
                "steps": steps,
                "requests": n_dec,
                "first_call_s": round(compile_s, 2),
                "tokens_per_sec": round(n_dec * batch * steps / dec_wall, 1),
                "latency_ms": {"p50_ms": round(float(np.median(lat)) * 1e3, 1),
                               "max_ms": round(float(np.max(lat)) * 1e3, 1)},
                **last_stats,
            },
            "mesh": _mesh_shape(),
        }
    finally:
        if fe is not None:
            fe.close()
        if order is not None:
            order.close()
        kv.executor.stop()


@benchmark("serve")
def serve_perf(smoke: bool = False, device=None) -> dict:
    """The request-path serving SLO probe (:func:`serve_ab`)."""
    line = _Lines()
    out = serve_ab(smoke, device)
    if out.get("follower"):
        return out
    low, over = out["points"]
    line("serve_closed_loop_capacity", out["closed_loop_capacity_per_sec"], "requests/sec")
    line("serve_p99_low_load", low["latency_ms"]["p99_ms"], "ms")
    line("serve_p99_overload_admitted", over["latency_ms"]["p99_ms"], "ms")
    line("serve_p99_overload_unprotected",
         out["no_admission_overload"]["latency_ms"]["p99_ms"], "ms")
    line("serve_goodput_overload", over["goodput_per_sec"], "requests/sec")
    line("serve_overload_shed_frac", over["shed_frac"], "fraction")
    line("serve_coalesce_merge_factor",
         out["coalesce"]["requests"] / max(1, out["coalesce"]["submits"]), "requests/submit")
    line("serve_decode_tokens_per_sec", out["decode"]["tokens_per_sec"], "tokens/sec")
    return {"metrics": line.values, **out}


def decode_batching_ab(smoke: bool = False, device=None) -> dict:
    """Continuous-batching decode (``serving/batcher.py``): batched
    against sequential tokens/s under join and leave churn, and the
    device-resident replica serving a table larger than the host budget
    with no degraded answer.

    - **arms**: for each slot count B, the same sessions decoded one by
      one (``speculative_generate`` a request) and through
      :class:`ContinuousBatcher` (waves admitted with ``admit_many``,
      fused round blocks with ``step_block``, sessions joining as slots
      free). The arms alternate; the speedup is the median of the paired
      ratios. Every rep asserts each session's batched tokens equal to
      its own sequential run.
    - **device_replica**: a :class:`ServeFrontend` with
      ``replica_device=True`` serving a table twice its host budget (the
      host mode refuses it) through a live stream of in-place pushes: no
      degraded answer.

    ``gamma`` 2: sequential decode reads the weights a round, so the
    fewer tokens a round commits the more a batch amortizes each read."""
    from ..models.speculative import speculative_generate
    from ..models.transformer import LMConfig, init_lm
    from ..parallel import sequence
    from ..parameter.kv_vector import KVVector
    from ..serving import (
        BatcherConfig,
        ContinuousBatcher,
        DecodeRequest,
        PullRequest,
        ServeConfig,
        ServeFrontend,
    )

    dev = _start(device)
    lead = _rank() == 0  # inside a world the LM runs on rank 0 alone
    if smoke:
        tcfg = LMConfig(vocab=256, d_model=256, n_heads=4, n_layers=2, d_ff=512)
        dcfg = LMConfig(vocab=256, d_model=64, n_heads=2, n_layers=1, d_ff=128)
        arms, steps_mix, reps, sess_per_slot = (8,), (16, 24), 1, 2
    else:
        tcfg = LMConfig(vocab=256, d_model=512, n_heads=8, n_layers=2, d_ff=1024)
        dcfg = LMConfig(vocab=256, d_model=128, n_heads=2, n_layers=1, d_ff=256)
        arms, steps_mix, reps, sess_per_slot = (1, 4, 8, 16), (40, 48), 3, 6
    gamma = 2
    prompt_len = 8
    max_new = max(steps_mix)
    if lead:
        tparams = init_lm(0, tcfg, dev)
        dparams = init_lm(1, dcfg, dev)

    def mk_reqs(n: int, seed0: int = 0):
        rng = np.random.default_rng(seed0)
        return [DecodeRequest(prompt=rng.integers(0, tcfg.vocab, (1, prompt_len)).astype(np.int32),
                              steps=steps_mix[i % len(steps_mix)]) for i in range(n)]

    def run_seq(reqs):
        out = [speculative_generate(tparams, tcfg, dparams, dcfg, r.prompt, r.steps, gamma=gamma)
               .cpu().numpy() for r in reqs]
        _sync(dev)
        return out

    def run_batched(b, reqs):
        outs = {}
        pending = list(reqs)
        order = {id(r): i for i, r in enumerate(reqs)}
        for _ in range(100000):
            wave = []
            while pending and len(wave) < b.free_slots():
                wave.append((pending.pop(0), None))
            if wave:
                b.admit_many(wave)
            for h in b.step_block():
                outs[order[id(h.req)]] = h.out
            if not pending and b.active_sessions() == 0:
                _sync(dev)
                return [outs[i] for i in range(len(reqs))]
        raise AssertionError("continuous batch failed to drain")

    arm_records = []
    with torch.no_grad():
        for slots in arms if lead else ():
            b = ContinuousBatcher(tparams, tcfg, dparams, dcfg, BatcherConfig(
                slots=slots, max_prompt=prompt_len, max_new=max_new, gamma=gamma, max_block=16))
            t0 = time.perf_counter()
            b.warmup()
            run_seq(mk_reqs(len(steps_mix)))
            run_batched(b, mk_reqs(slots, seed0=999))
            warm_s = time.perf_counter() - t0
            nsess = sess_per_slot * slots
            reqs = mk_reqs(nsess)
            total_toks = sum(r.steps for r in reqs)
            ratios, seq_tps, bat_tps = [], [], []
            for _ in range(reps):
                t0 = time.perf_counter()
                seq_out = run_seq(reqs)
                t_seq = time.perf_counter() - t0
                t0 = time.perf_counter()
                bat_out = run_batched(b, reqs)
                t_bat = time.perf_counter() - t0
                for s_, c_ in zip(seq_out, bat_out):
                    np.testing.assert_array_equal(s_, c_)
                ratios.append(t_seq / t_bat)
                seq_tps.append(total_toks / t_seq)
                bat_tps.append(total_toks / t_bat)
            st = b.stats()
            arm_records.append({
                "slots": slots,
                "sessions": nsess,
                "tokens_per_session": sorted(set(steps_mix)),
                "warmup_s": round(warm_s, 1),
                "seq_tokens_per_sec": round(float(np.median(seq_tps)), 1),
                "batched_tokens_per_sec": round(float(np.median(bat_tps)), 1),
                "speedup": round(float(np.median(ratios)), 2),
                "speedup_reps": [round(r, 2) for r in ratios],
                "accepted_frac": round(st["accepted_frac"], 3),
                "parity": "token-identical per session (asserted)",
            })
            del b

    kv = KVVector(k=8, num_slots=1 << (10 if smoke else 14), hashed=True, name="serve_dev",
                  device=dev)
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 20, 512))
    vals = rng.normal(size=(len(keys), 8)).astype(np.float32)
    kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
    table_bytes = int(kv.table(0).numel() * kv.table(0).element_size())
    budget = table_bytes // 2  # the host replica mode refuses this table
    # inside a world every rank builds the order of kv's calls here; rank 0
    # serves through it and the other ranks follow its calls
    order = sequence.Order(kv, name="serve_dev") if sequence.needed(kv) else None
    if order is not None and not order.leader:
        try:
            order.follow()
        finally:
            kv.executor.stop()
        return {"follower": True, "mesh": _mesh_shape()}
    fe = None
    try:
        fe = ServeFrontend(kv if order is None else order, ServeConfig(
            replica="full", replica_device=True, replica_host_budget_bytes=budget,
            replica_refresh_s=0.02, workers=2, max_queue_depth=256)).start()
        stop = time.perf_counter() + (0.3 if smoke else 0.8)
        served = 0
        while time.perf_counter() < stop:
            # pushes change the table while reads ride the device snapshot
            fe.store.push(kv.request(channel=0), keys=keys[:64],
                          values=rng.normal(size=(64, 8)).astype(np.float32))
            fe.submit(PullRequest(keys=keys[rng.integers(0, len(keys), 16)])).result(30)
            served += 1
        degraded = fe.degraded_served
        device_mode = bool(fe.stats()["replica"]["device"])
    finally:
        if fe is not None:
            fe.close()
        if order is not None:
            order.close()
        kv.executor.stop()

    by8 = next((a for a in arm_records if a["slots"] == 8), arm_records[-1])
    return {
        "model": {
            "target": "d256 2-layer byte-LM (smoke)" if smoke else
            "d512 2-layer byte-LM (random-init; self-agreeing draft)",
            "draft": "d64 1-layer" if smoke else "d128 1-layer",
            "gamma": gamma,
            "prompt_len": prompt_len,
        },
        "reps": reps,
        "arms": arm_records,
        "speedup_at_8": by8["speedup"],
        "device_replica": {
            "table_bytes": table_bytes,
            "host_budget_bytes": budget,
            "over_budget_factor": round(table_bytes / budget, 2),
            "refresh_s": 0.02,
            "requests_served": served,
            "degraded_served": int(degraded),
            "device": device_mode,
        },
        "mesh": _mesh_shape(),
    }


@benchmark("decode_batching")
def decode_batching_perf(smoke: bool = False, device=None) -> dict:
    """Continuous-batching decode (:func:`decode_batching_ab`): batched
    against sequential tokens/s with token parity in every rep, and the
    device replica over its host budget with no degraded answer."""
    line = _Lines()
    out = decode_batching_ab(smoke, device)
    if out.get("follower"):
        return out
    by8 = next((a for a in out["arms"] if a["slots"] == 8), out["arms"][-1])
    line("decode_batched_speedup_at_8", out["speedup_at_8"], "x")
    line("decode_batched_tokens_per_sec", by8["batched_tokens_per_sec"], "tokens/sec")
    line("decode_sequential_tokens_per_sec", by8["seq_tokens_per_sec"], "tokens/sec")
    # served minus degraded: positive only while the replica answers every
    # request undegraded (a line's value must be > 0)
    dr = out["device_replica"]
    line("decode_device_replica_clean_requests", dr["requests_served"] - dr["degraded_served"],
         "requests")
    return {"metrics": line.values, **out}


# -- the plane probes: telemetry --


@benchmark("trace")
def trace_perf(smoke: bool = False, device=None) -> dict:
    """A short synthetic run's flow-correlated timeline, written as a
    Chrome trace (open it at https://ui.perfetto.dev): an
    ``IngestPipeline`` (feeder and ordered prep pool) feeding executor
    steps submitted under each batch's flow, a JSONL span sink
    installed, then the timeline written where ``PS_TRACE_OUT`` points
    (default ``<tmp>/ps_timeline_trace.json``, the JSONL beside it) and
    the critical-path analyser run over it. The lines double as liveness
    checks: no event or no correlated flow fails them."""
    import json
    import os
    import tempfile

    from ..learner.ingest import IngestPipeline
    from ..system.executor import Executor
    from ..telemetry import attribution as attribution_mod
    from ..telemetry import spans as telemetry_spans
    from ..telemetry import timeline as timeline_mod

    _device(device)
    line = _Lines()
    out_path = os.environ.get("PS_TRACE_OUT") or os.path.join(tempfile.gettempdir(),
                                                              "ps_timeline_trace.json")
    jsonl_path = out_path + ".jsonl"
    try:
        os.remove(jsonl_path)  # a fresh capture, never mixed with an earlier one
    except OSError:
        pass
    n_batches = 6 if smoke else 24
    work = np.random.default_rng(0).random(1 << (12 if smoke else 16))

    def batches():
        yield from range(n_batches)

    def prep(i):
        return float(np.sort(work).sum()) + i  # real CPU work

    prev = telemetry_spans.install_sink(telemetry_spans.JsonlSink(jsonl_path))
    t0 = time.perf_counter()
    try:
        pipe = IngestPipeline(batches(), prep_fn=prep, workers=2, name="trace").start()
        ex = Executor(name="trace_bench", telemetry=True)
        for item in pipe:
            # the pipeline keeps the batch's flow active on this thread
            ex.submit(lambda item=item: float(work[:1024].sum()) + item)
        ex.wait_all()
        ex.stop()
    finally:
        mine = telemetry_spans.install_sink(prev)
        if mine is not None and mine is not prev:
            mine.close()
    capture_s = time.perf_counter() - t0

    events = timeline_mod.load_events(jsonl_path)
    trace = timeline_mod.to_chrome_trace(events)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    summary = attribution_mod.summarize(events)
    line("trace_events_captured", len(events), "events")
    line("trace_flows_correlated", summary["flows"].get("count", 0), "flows")
    line("trace_capture_events_per_sec", len(events) / capture_s, "events/sec")
    return {"metrics": line.values, "trace_json": out_path, "trace_jsonl": jsonl_path}


@benchmark("bundle")
def bundle_probe(smoke: bool = False, device=None) -> dict:
    """A diagnostic bundle from a live mini-cluster, written where
    ``PS_BUNDLE_OUT`` points (default ``<tmp>/ps_bundle.json``): the
    flight recorder armed as a tee, per-node recorders with metric
    samples, traced work under flow scopes, an ``AuxRuntime`` with two
    registered nodes, one of which goes silent before the capture, so
    the bundle carries its staleness instead of a made-up ring."""
    import json
    import os
    import tempfile

    from ..system.aux_runtime import AuxRuntime
    from ..telemetry import blackbox
    from ..telemetry import spans as telemetry_spans

    _device(device)
    line = _Lines()
    out_path = os.environ.get("PS_BUNDLE_OUT") or os.path.join(tempfile.gettempdir(),
                                                               "ps_bundle.json")
    # set up and clean up only what this probe touches (never a global
    # blackbox.reset(): it would disarm an enclosing run's tee)
    prev_interval = blackbox.set_min_interval(0.0)
    was_armed = blackbox.installed_recorder() is not None
    aux = AuxRuntime(heartbeat_timeout=5.0, stale_after_s=0.08)
    try:
        aux.register("W0")
        aux.register("S0")
        blackbox.arm()
        for nid in ("W0", "S0"):
            blackbox.recorder(nid).clear()
            blackbox.recorder(nid).sample_metrics()
        n = 8 if smoke else 32
        work = np.random.default_rng(0).random(1 << 14)
        for i in range(n):
            with telemetry_spans.flow_scope(telemetry_spans.new_flow()):
                with telemetry_spans.span("bundle.demo", i=i):
                    float(np.sort(work).sum())
        for nid in ("W0", "S0"):
            blackbox.recorder(nid).sample_metrics()
        # S0 goes silent: only W0 reports past the staleness window
        time.sleep(0.1)
        aux.report_node("W0", wire=False)
        t0 = time.perf_counter()
        bundle = aux.bundle(trigger="manual", force=True)
        capture_ms = (time.perf_counter() - t0) * 1e3
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(bundle, f, default=str)
        summary = blackbox.summarize_bundle(bundle)
        stale_nodes = [nid for nid, d in summary["nodes"].items() if d.get("stale")]
        assert "S0" in stale_nodes, "silent node S0 not marked stale"
        assert summary["nodes"].get("W0", {}).get("events") is not None or (
            summary["nodes"].get("W0", {}).get("stale") is False
        ), "live node W0 has no ring dump"
        line("bundle_ring_nodes", len(summary["nodes"]), "nodes")
        line("bundle_stale_nodes", len(stale_nodes), "nodes")
        line("bundle_trace_events", summary["trace_events"], "events")
        line("bundle_capture_ms", capture_ms, "ms")
    finally:
        blackbox.set_min_interval(prev_interval)
        blackbox.drop_recorder("W0")
        blackbox.drop_recorder("S0")
        if not was_armed:
            blackbox.disarm()
        aux.stop()
    return {"metrics": line.values, "bundle_json": out_path, "stale_nodes": stale_nodes}


def history_ab(smoke: bool = False) -> dict:
    """The history plane's steady cost (``telemetry/history.py``): the
    same metric churn (counter bumps, gauge sets, histogram observes, a
    registry export every 50, where the fold hook rides) with a
    ``HistoryStore`` installed and without, in the order on, off, off, on
    a rep so a steady drift cancels from the paired ratio (the quoted
    median). The fold alone is also timed in a tight loop over the whole
    instrument catalog. The A/B store folds at a 10 ms base resolution,
    100× the production 1 s, so the overhead is an upper bound."""
    from ..telemetry.history import HistoryStore
    from ..telemetry.instruments import install_all
    from ..telemetry.registry import MetricsRegistry

    n = 1500 if smoke else 6000
    reps = 3 if smoke else 5

    def build(with_history: bool):
        reg = MetricsRegistry()
        cs = [reg.counter(f"ab_hist_c{i}_total", "history A/B churn", labelnames=("k",))
              for i in range(4)]
        gs = [reg.gauge(f"ab_hist_g{i}", "history A/B churn") for i in range(4)]
        hist = reg.histogram("ab_hist_lat_seconds", "history A/B churn",
                             buckets=(1e-5, 1e-4, 1e-3, 1e-2))
        if with_history:
            HistoryStore(reg, resolutions=((0.01, 600), (0.1, 720))).install()
        return reg, cs, gs, hist

    def run(world) -> None:
        reg, cs, gs, hist = world
        for i in range(n):
            cs[i & 3].labels(k=str(i & 7)).inc()
            gs[i & 3].set(float(i))
            hist.observe((i & 15) * 1e-4 + 1e-5)
            if i % 50 == 0:
                reg.export_state()  # the scrape's read: the fold hook rides it

    on, off = build(True), build(False)

    def timed(world) -> float:
        t0 = time.perf_counter()
        run(world)
        return time.perf_counter() - t0

    timed(on)
    timed(off)
    ratios, on_s, off_s = [], [], []
    for _ in range(reps):
        a1 = timed(on)
        o = (timed(off) + timed(off)) / 2
        a2 = timed(on)
        ratios.append(((a1 + a2) / 2) / max(o, 1e-9))
        on_s.append((a1 + a2) / 2)
        off_s.append(o)
    ratios.sort()
    on_s.sort()
    off_s.sort()

    cat_reg = MetricsRegistry()
    for inst in install_all(cat_reg).values():
        target = (inst.labels(**{ln: "probe" for ln in inst.labelnames})
                  if inst.labelnames else inst)
        if inst.kind == "histogram":
            target.observe(0.001)
        elif inst.kind == "gauge":
            target.set(1.0)
        else:
            target.inc()
    store = HistoryStore(cat_reg)
    m = 50 if smoke else 200
    folds = []
    for _ in range(m):
        t0 = time.perf_counter()
        store.fold(force=True)
        folds.append(time.perf_counter() - t0)
    folds.sort()
    snap = store.snapshot()
    return {
        "reps": reps,
        "steps_per_rep": n,
        "ratio_median": round(ratios[len(ratios) // 2], 3),
        "on_ms_median": round(on_s[len(on_s) // 2] * 1e3, 3),
        "off_ms_median": round(off_s[len(off_s) // 2] * 1e3, 3),
        "fold_us_median": round(folds[len(folds) // 2] * 1e6, 1),
        "fold_series": snap["series"],
        "resolutions": snap["resolutions"],
    }


@benchmark("history_ab")
def history_ab_perf(smoke: bool = False, device=None) -> dict:
    """The history plane's overhead (:func:`history_ab`)."""
    _device(device)
    line = _Lines()
    out = history_ab(smoke)
    line("history_overhead_ratio_median", out["ratio_median"], "x")
    line("history_fold_us_median", out["fold_us_median"], "us")
    line("history_fold_series", out["fold_series"], "series")
    return {"metrics": line.values, **out}


# -- the plane probes: learning, recovery, consistency --


def _divergence_drill(device=None, smoke: bool = False) -> dict:
    """A seeded divergence drill: a learning-rate blow-up (square loss,
    α 1e10, plain SGD) drives the trajectory to Inf/NaN within a few
    steps; the learning plane judges the collected steps divergent, the
    shipped ``loss_divergence`` rule walks inactive → pending → firing,
    and the firing captures a flight-recorder bundle through the alert
    trigger (the wiring ``AuxRuntime.set_alerts`` installs). A fake clock
    drives the rule."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..apps.linear.config import (
        Config,
        LearningRateConfig,
        LossConfig,
        PenaltyConfig,
        SGDConfig,
    )
    from ..telemetry import alerts as alerts_mod
    from ..telemetry import blackbox
    from ..telemetry import learning as learning_mod
    from ..utils.sparse import random_sparse

    rule = next(r for r in alerts_mod.default_rules() if r.name == "loss_divergence")
    clock = [0.0]
    mgr = alerts_mod.AlertManager([rule], clock=lambda: clock[0])
    prev_interval = blackbox.set_min_interval(0.0)
    was_armed = blackbox.installed_recorder() is not None
    blackbox.arm()
    bundles: list = []

    def on_transition(ev) -> None:
        if ev.to == "firing" and ev.rule == "loss_divergence":
            b = blackbox.trigger_bundle("alert", detail=ev.rule)
            if b is not None:
                bundles.append(b)

    mgr.add_listener(on_transition)
    conf = Config()
    conf.loss = LossConfig(type="square")
    conf.penalty = PenaltyConfig(type="l2", lambda_=[0.0])
    conf.learning_rate = LearningRateConfig(type="constant", alpha=1e10, beta=1.0)
    conf.async_sgd = SGDConfig(algo="standard", minibatch=64, num_slots=1 << 9, max_delay=0)
    worker = AsyncSGDWorker(conf, device=device, name="learning_diverge")
    states = []
    try:
        mgr.evaluate()  # the t=0 baseline sample: a rate needs a window
        states.append(mgr.states()[rule.name].state_name)
        for i in range(8 if smoke else 12):
            b = random_sparse(64, 1 << 12, 6, seed=100 + i, binary=True)
            b.y = np.where(np.arange(64) % 2 == 0, 1.0, -1.0).astype(np.float32)
            ts = worker._submit_prepped(worker.prep(b, device_put=False), with_aux=False)
            worker.collect(ts)
        plane = learning_mod.get_plane("learning_diverge")
        divergences = dict(plane.snapshot()["divergence"]) if plane else {}
        clock[0] = 5.0
        mgr.evaluate()  # pending → firing in one tick (for_s 0)
        states.append(mgr.states()[rule.name].state_name)
        fired = rule.name in mgr.firing()
        clock[0] = 5.0 + rule.window_s + 10.0  # the window slides past the burst
        mgr.evaluate()
        states.append(mgr.states()[rule.name].state_name)
    finally:
        worker.remove()
        blackbox.set_min_interval(prev_interval)
        if not was_armed:
            blackbox.disarm()
    return {
        "divergence_counts": divergences,
        "states_seen": states,
        "fired": bool(fired),
        "resolved": states[-1] in ("resolved", "inactive"),
        "bundle_captured": bool(bundles),
        "bundle_trigger": dict(bundles[0]["trigger"]) if bundles else None,
    }


def learning_truth(smoke: bool = False, device=None) -> dict:
    """The learning truth plane probe (``telemetry/learning.py``): a short
    training run at τ 3 through the collect path gives the realized
    staleness histogram and its bound verdict (``within_bound``: the
    observed maximum at most the configured ``max_delay``), the server
    shard's key-heat share with the imbalance and the hot-slot table,
    the loss and gradient trajectory from the step's side outputs, and
    the count-min heat against exact slot counts of the same stream.
    Then :func:`_divergence_drill`. On the JAX ``_learning_mesh()``
    (:func:`_start`): two server shards over the ranks of a world, one
    shard on one card outside a world."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..apps.linear.config import Config, LearningRateConfig, PenaltyConfig, SGDConfig
    from ..telemetry import learning as learning_mod
    from ..utils.sparse import random_sparse

    dev = _start(device, learning=True)
    tau = 3
    minibatch = 128
    n_batches = 24 if smoke else 48
    conf = Config()
    conf.penalty = PenaltyConfig(type="l1", lambda_=[0.1])
    conf.learning_rate = LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    conf.async_sgd = SGDConfig(algo="ftrl", minibatch=minibatch, num_slots=1 << 10,
                               max_delay=tau)
    worker = AsyncSGDWorker(conf, device=dev, name="learning_probe")

    def batch(i: int):
        b = random_sparse(minibatch, 1 << 16, 8, seed=i, binary=True)
        b.y = np.where((b.indices.reshape(minibatch, -1) % 64 < 16).mean(1) > 0.24,
                       1.0, -1.0).astype(np.float32)
        return b

    batches = [batch(i) for i in range(n_batches)]
    # exact heat over the same stream, hashed through the same directory
    exact = np.zeros(worker.num_slots, np.int64)
    for b in batches:
        np.add.at(exact, worker.directory.slots(np.asarray(b.indices)), 1)
    try:
        worker.train(iter(batches))
        plane = learning_mod.get_plane("learning_probe")
        snap = plane.snapshot()
        uniq = np.flatnonzero(exact)
        est = plane.heat.estimate(uniq)
        # no decay window elapses on a run this short: the estimates are
        # exact up to hash collisions (biased up, never down)
        parity = {
            "distinct_slots": int(uniq.size),
            "exact_match_frac": round(float(np.mean(est == exact[uniq])), 4),
            "upper_bound_frac": round(float(np.mean(est >= exact[uniq])), 4),
        }
    finally:
        worker.remove()
    return {
        "config": {"max_delay": tau, "n_batches": n_batches, "minibatch": minibatch,
                   "num_slots": worker.num_slots, "num_shards": _mesh_shape()["server"]},
        "mesh": _mesh_shape(),
        "staleness": snap["staleness"],
        "shards": snap["shards"],
        "hot_slots": snap["hot_slots"][:8],
        "examples": snap["examples"],
        "collected_steps": snap["collected_steps"],
        "trajectory_tail": snap["trajectory_tail"][-8:],
        "heat_parity": parity,
        "divergence_drill": _divergence_drill(dev, smoke),
    }


@benchmark("learning")
def learning_perf(smoke: bool = False, device=None) -> dict:
    """The learning truth plane (:func:`learning_truth`): the realized
    staleness within the configured τ, the sketch's heat never under the
    exact counts, the divergence drill firing the shipped rule with a
    bundle."""
    line = _Lines()
    out = learning_truth(smoke, device)
    st = out["staleness"]
    assert st["within_bound"], (
        f"realized staleness {st['observed_max']} breached the configured tau "
        f"{st['configured_tau']}")
    assert out["heat_parity"]["upper_bound_frac"] == 1.0, out["heat_parity"]
    drill = out["divergence_drill"]
    assert drill["fired"] and drill["bundle_captured"], drill
    # a raw observed maximum can be 0 (a line's value must be > 0): the
    # verdict, asserted above, is the headline
    line("learning_staleness_within_bound", 1.0, "bool")
    line("learning_staleness_submits", st["submits"], "submissions")
    line("learning_heat_exact_match", out["heat_parity"]["exact_match_frac"], "fraction")
    line("learning_shard_imbalance", out["shards"]["imbalance"] or 0.0, "max_over_mean")
    line("learning_examples_confirmed", out["examples"], "examples")
    return {"metrics": line.values, **out}


@benchmark("recovery_drill")
def recovery_drill_perf(smoke: bool = False, device=None) -> dict:
    """The chaos plane's headline (:func:`recovery_drill`): an injected
    shard death under live train and serve load detected, degraded
    around and recovered with no acknowledged update lost, the table bit
    for bit the undisturbed run's."""
    line = _Lines()
    device = _device(device)
    out = recovery_drill(smoke, device)
    if out.get("follower"):
        return out
    assert out["trajectory_bit_identical"], (
        "post-recovery trajectory diverged from the undisturbed run: acknowledged updates "
        "were lost")
    assert out["replayed_updates"] > 0, "drill proved nothing: no acked update postdated the barrier"
    assert out["trainer_parked"], (
        "drill proved nothing: the trainer finished before detection, so recovery never ran "
        "against live load")
    bb = out["blackbox"]
    assert bb.get("captured"), "shard death did not auto-capture a diagnostic bundle"
    assert bb["nodes"].get("S0", {}).get("stale"), "dead shard S0 is not marked stale in the bundle"
    assert not bb["nodes"].get("W0", {}).get("stale", True), (
        "surviving node W0's ring dump is missing from the bundle")
    assert bb.get("node_deaths_alert", "firing") == "firing", (
        "node_deaths alert never reached firing during the drill")
    line("recovery_detection_ms", out["detection_ms"], "ms")
    line("recovery_recovery_ms", out["recovery_ms"], "ms")
    line("recovery_mttr_ms", out["mttr_ms"], "ms")
    line("recovery_replayed_updates", out["replayed_updates"], "updates")
    line("recovery_serve_degraded", out["serve"]["degraded_served"], "requests")
    line("recovery_disarmed_overhead_ratio", out["disarmed_overhead"]["ratio_median"], "x")
    line("recovery_disarmed_check_ns", out["disarmed_overhead"]["check_ns_per_call"], "ns/call")
    line("recovery_bit_identical", 1.0, "bool")
    line("recovery_bundle_ring_nodes", len(bb.get("nodes", {})), "nodes")
    return {"metrics": line.values, **out, "mesh": dict(_own_table(device).shape)}


def _consistency_conf(tau, *, adaptive=False, kkt=False, drop_after=0):
    """One consistency arm's config. The τ arms run the stability
    frontier (standard SGD, square loss, a constant α where delayed
    gradients visibly cost accuracy); the KKT arms the FTRL + L1 workload
    the filter's threshold derives from."""
    from ..apps.linear.config import (
        Config,
        LearningRateConfig,
        LossConfig,
        PenaltyConfig,
        SGDConfig,
    )

    conf = Config()
    if kkt:
        conf.penalty = PenaltyConfig(type="l1", lambda_=[0.1])
        conf.learning_rate = LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
        conf.async_sgd = SGDConfig(
            algo="ftrl", minibatch=128, num_slots=1 << 10, max_delay=tau, update="sparse",
            tau_adaptive=adaptive, kkt_filter=True, kkt_drop_after=drop_after,
            kkt_revisit_every=8, ingest_workers=1)
    else:
        conf.loss = LossConfig(type="square")
        conf.penalty = PenaltyConfig(type="l2", lambda_=[0.0])
        conf.learning_rate = LearningRateConfig(type="constant", alpha=0.03, beta=1.0)
        conf.async_sgd = SGDConfig(algo="standard", minibatch=128, num_slots=1 << 10,
                                   max_delay=tau, tau_adaptive=adaptive)
    return conf


def _consistency_batches(n, directory, num_slots, seed0=0):
    """Planted-regression batches labelled through the same key → slot
    hash the workers use: every arm sees one learnable problem with a
    known optimum."""
    from ..utils.sparse import random_sparse

    rng = np.random.default_rng(7)
    wstar = rng.normal(size=num_slots).astype(np.float32)
    noise = np.random.default_rng(11)
    out = []
    for i in range(n):
        b = random_sparse(128, 1 << 14, 8, seed=seed0 + i, binary=True)
        slots = directory.slots(b.indices)
        rows = b.row_ids()
        xw = np.zeros(b.n, np.float32)
        np.add.at(xw, rows, wstar[np.minimum(slots, num_slots - 1)])
        b.y = (xw / 8.0 + 0.05 * noise.normal(size=b.n)).astype(np.float32)
        out.append(b)
    return out


def _final_loss(worker_name) -> float:
    from ..telemetry import learning as learning_mod

    snap = learning_mod.get_plane(worker_name).snapshot()
    tail = [p["loss"] for p in snap["trajectory_tail"][-8:] if isinstance(p["loss"], float)]
    return float(np.median(tail)) if tail else float("inf")


def _attach_pull_rtt(worker, rtt_s: float) -> None:
    """Emulate the cross-host weight-pull round trip on the submissions
    that refresh the pulled snapshot, the latency τ exists to hide; the
    record discloses it as ``emulated_pull_rtt_ms``. With one server
    shard and one worker on one host, no pull crosses a network, so the
    overlap τ > 0 buys cannot show without it. The sleep lands where a
    multi-host deployment blocks: τ 0 pays it every step, τ max every
    τ-th, the adaptive arm at its live τ; the losses stay measured."""
    orig = worker._submit_prepped

    def submit(prepped, with_aux: bool = True) -> int:
        tau = worker._effective_tau
        if tau <= 0 or worker._steps_since_snapshot >= tau:
            time.sleep(rtt_s)
        return orig(prepped, with_aux=with_aux)

    worker._submit_prepped = submit


def _consistency_divergence_drill(device, smoke: bool) -> dict:
    """A seeded divergence drill through the adaptive controller's
    reaction: a poisoned batch (infinite labels) makes one collected step
    non-finite; the learning plane judges it divergent (the shipped
    ``loss_divergence`` rule fires on the counter, fake clock), and the
    controller reacts in the same collect (τ → 0, the learning rate
    backed off, a rollback to its last healthy snapshot); then the run
    converges again on clean data. The episode lands in one
    flight-recorder bundle, the controller's own
    ``consistency_rollback`` trigger."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..telemetry import alerts as alerts_mod
    from ..telemetry import blackbox
    from ..telemetry import learning as learning_mod

    rule = next(r for r in alerts_mod.default_rules() if r.name == "loss_divergence")
    clock = [0.0]
    mgr = alerts_mod.AlertManager([rule], clock=lambda: clock[0])
    prev_interval = blackbox.set_min_interval(0.0)
    was_armed = blackbox.installed_recorder() is not None
    blackbox.arm()
    blackbox.recorder().clear()  # an earlier drill in this process stays out of this bundle
    worker = AsyncSGDWorker(_consistency_conf(4, adaptive=True), device=device,
                            name="consistency_diverge")
    n_good = 8 if smoke else 12
    # the bundles held before the drill, by identity: the store keeps the
    # last four, so once it is full a new bundle leaves its length as it was
    before = [id(b) for b in blackbox.bundles()]
    try:
        mgr.evaluate()
        batches = _consistency_batches(n_good + 4, worker.directory, worker.num_slots, seed0=300)
        losses = []
        for b in batches[:n_good]:
            worker.collect(worker._submit_prepped(worker.prep(b, device_put=False),
                                                  with_aux=False))
            losses.append(_final_loss("consistency_diverge"))
        pre_alpha = float(worker.lr.alpha)
        pre_tau = worker._consistency.controller.tau
        bad = batches[n_good]
        bad.y = np.full_like(bad.y, np.float32("inf"))
        # the reaction happens inside this collect
        worker.collect(worker._submit_prepped(worker.prep(bad, device_put=False),
                                              with_aux=False))
        clock[0] = 5.0
        mgr.evaluate()
        fired = rule.name in mgr.firing()
        post = []
        for b in batches[n_good + 1:]:
            worker.collect(worker._submit_prepped(worker.prep(b, device_put=False),
                                                  with_aux=False))
            post.append(_final_loss("consistency_diverge"))
        episodes = list(worker._consistency.controller.episodes)
        divergences = dict(learning_mod.get_plane("consistency_diverge").snapshot()["divergence"])
        rollback_bundle = next((b for b in blackbox.bundles()
                                if id(b) not in before
                                and b["trigger"]["kind"] == "consistency_rollback"), None)
    finally:
        worker.remove()
        blackbox.set_min_interval(prev_interval)
        if not was_armed:
            blackbox.disarm()
    return {
        "good_steps": n_good,
        "loss_before_poison": losses[-1] if losses else None,
        "pre_reaction": {"alpha": pre_alpha, "tau": pre_tau},
        "episodes": episodes,
        "divergence_counts": divergences,
        "alert_fired": bool(fired),
        "post_rollback_losses": [round(x, 6) for x in post],
        "reconverged": bool(post) and all(np.isfinite(post)) and post[-1] <= losses[0],
        "bundle_captured": rollback_bundle is not None,
        "bundle_trigger": dict(rollback_bundle["trigger"]) if rollback_bundle else None,
    }


def consistency_ab(smoke: bool = False, device=None) -> dict:
    """Self-driving consistency: three τ arms on one workload (the
    delayed-stability frontier: a planted regression, a constant α where
    staleness costs accuracy), back-to-back paired reps with medians:
    fixed τ 0, fixed τ max and adaptive. The frontier claim: adaptive at
    least τ 0's throughput and below τ max's final loss. Then the KKT
    significance filter off and on over the FTRL + L1 workload (its keys
    counted against ``ps_push_keys_total``, the loss change disclosed:
    the filter is lossy by design; on the card the sparse update and the
    segment sums launch ``ftrl_sparse`` and ``segment_sum``), and
    :func:`_consistency_divergence_drill`. One server shard on one card."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..telemetry import learning as learning_mod
    from ..telemetry import registry as telemetry_registry
    from ..telemetry.instruments import parameter_instruments

    dev = _start(device, learning=True)
    tau_max = 8
    n_batches = 24 if smoke else 64
    n_warm = 4
    reps = 1 if smoke else 3
    rtt_s = 0.025

    probe = AsyncSGDWorker(_consistency_conf(0), device=dev, name="consistency_probe")
    batches = _consistency_batches(n_batches, probe.directory, probe.num_slots)
    probe.remove()

    arms = {}
    arm_specs = (("tau0", 0, False), ("taumax", tau_max, False), ("adaptive", tau_max, True))
    for rep in range(reps):
        for arm_name, tau, adaptive in arm_specs:
            name = f"consistency_{arm_name}_{rep}"
            worker = AsyncSGDWorker(_consistency_conf(tau, adaptive=adaptive), device=dev,
                                    name=name)
            _attach_pull_rtt(worker, rtt_s)
            if adaptive and worker._consistency is not None:
                # the ramp scaled to the run (+1 a 2 healthy collects;
                # the production default would stay below the cap)
                worker._consistency.controller.stable_steps = 2
            try:
                worker.train(iter(batches[:n_warm]))  # warm-up
                t0 = time.perf_counter()
                worker.train(iter(batches[n_warm:]))
                dt = time.perf_counter() - t0
            finally:
                worker.remove()
            st = learning_mod.get_plane(name).snapshot()["staleness"]
            rec = arms.setdefault(arm_name, {"tau": tau, "adaptive": adaptive, "reps": [],
                                             "final_loss": None, "staleness": None})
            rec["reps"].append(round((n_batches - n_warm) * 128 / dt, 1))
            if rep == 0:
                rec["final_loss"] = round(_final_loss(name), 6)
                rec["staleness"] = st
                if adaptive and worker._consistency is not None:
                    rec["controller"] = worker._consistency.snapshot()["tau"]
    for rec in arms.values():
        rec["examples_per_s_median"] = float(np.median(rec["reps"]))

    pair_ratios = [a / b for a, b in zip(arms["adaptive"]["reps"], arms["tau0"]["reps"])]
    frontier = {
        "adaptive_vs_tau0_throughput_ratio": round(float(np.median(pair_ratios)), 4),
        "adaptive_beats_tau0_throughput": float(np.median(pair_ratios)) > 1.0,
        "adaptive_beats_taumax_loss": arms["adaptive"]["final_loss"] < arms["taumax"]["final_loss"],
        "tau0_loss": arms["tau0"]["final_loss"],
        "taumax_loss": arms["taumax"]["final_loss"],
        "adaptive_loss": arms["adaptive"]["final_loss"],
    }

    kkt_batches = _consistency_batches(12 if smoke else 32, probe.directory, probe.num_slots,
                                       seed0=100)
    for b in kkt_batches:  # classification labels for the logistic loss
        b.y = np.where(b.y > 0, 1.0, -1.0).astype(np.float32)
    kkt = {}
    for arm_name, on in (("off", False), ("on", True)):
        name = f"consistency_kkt_{arm_name}"
        conf = _consistency_conf(2, kkt=True, drop_after=3) if on else _consistency_conf(2, kkt=True)
        if not on:
            conf.async_sgd.kkt_filter = False
        worker = AsyncSGDWorker(conf, device=dev, name=name)
        # counters are process-wide a label set: reconcile the delta
        counter0 = 0.0
        if on and telemetry_registry.enabled():
            counter0 = parameter_instruments(telemetry_registry.default_registry())[
                "push_keys"].value(store=name, channel=0)
        try:
            worker.train(iter(kkt_batches))
        finally:
            worker.remove()
        entry = {"final_loss": round(_final_loss(name), 6), "update_path": worker.update_path}
        if on:
            summary = worker._consistency.tracker.summary()
            counter = None
            if telemetry_registry.enabled():
                counter = parameter_instruments(telemetry_registry.default_registry())[
                    "push_keys"].value(store=name, channel=0) - counter0
            baseline_nnz = sum(b.nnz for b in kkt_batches)
            entry.update({
                "accounting": summary,
                "push_keys_counter": counter,
                "counter_reconciled": counter is None or counter == summary["pushed"],
                "suppressed_key_frac": round(summary["suppressed"]
                                             / max(1, summary["candidates"]), 4),
                "baseline_nnz": baseline_nnz,
                "dropped_entry_frac": round(summary["dropped_entries"] / max(1, baseline_nnz), 4),
            })
        kkt[arm_name] = entry
    kkt["loss_delta"] = round(kkt["on"]["final_loss"] - kkt["off"]["final_loss"], 6)

    return {
        "workload": {
            "n_batches": n_batches,
            "warmup_batches": n_warm,
            "minibatch": 128,
            "num_slots": probe.num_slots,
            "num_shards": _mesh_shape()["server"],
            "tau_max": tau_max,
            "reps": reps,
            "emulated_pull_rtt_ms": rtt_s * 1000.0,
            "adaptive_stable_steps": 2,
            "pairing": "back-to-back a rep; verdicts are medians of per-rep paired ratios; "
                       "throughput includes the emulated pull round trip on refresh "
                       "submissions (_attach_pull_rtt), losses are measured",
        },
        "mesh": _mesh_shape(),
        "tau_arms": arms,
        "frontier": frontier,
        "significance_filter": kkt,
        "divergence_drill": _consistency_divergence_drill(dev, smoke),
    }


@benchmark("consistency")
def consistency_perf(smoke: bool = False, device=None) -> dict:
    """Self-driving consistency (:func:`consistency_ab`). The structural
    contracts hold in every mode (bounded delay in each arm, the
    controller widened τ, the KKT accounting reconciled with
    ``ps_push_keys_total``, the drill backed off, rolled back and
    converged again with the episode bundled); the frontier's wall-clock
    verdicts hold only on full runs (at smoke a throughput order is
    noise). The full record goes where ``PS_CONSISTENCY_OUT`` points
    (default ``<tmp>/ps_consistency.json``)."""
    import json
    import os
    import tempfile

    line = _Lines()
    out = consistency_ab(smoke, device)
    for arm in out["tau_arms"].values():
        assert arm["staleness"]["within_bound"], arm["staleness"]
    ctl = out["tau_arms"]["adaptive"]["controller"]
    assert max(ctl["trace"]) > ctl["trace"][0], (
        f"adaptive controller never widened tau: {ctl['trace']}")
    kkt_on = out["significance_filter"]["on"]
    assert kkt_on["accounting"]["reconciled"], kkt_on
    assert kkt_on["counter_reconciled"], kkt_on
    assert kkt_on["accounting"]["suppressed"] > 0, kkt_on
    drill = out["divergence_drill"]
    assert drill["episodes"] and drill["episodes"][0]["rolled_back"], drill
    assert drill["alert_fired"] and drill["bundle_captured"], drill
    assert drill["reconverged"], drill
    if not smoke:
        assert out["frontier"]["adaptive_beats_tau0_throughput"], out["frontier"]
        assert out["frontier"]["adaptive_beats_taumax_loss"], out["frontier"]
    line("consistency_adaptive_examples_per_s",
         out["tau_arms"]["adaptive"]["examples_per_s_median"], "examples/s")
    line("consistency_tau0_examples_per_s", out["tau_arms"]["tau0"]["examples_per_s_median"],
         "examples/s")
    line("consistency_adaptive_tau_reached", max(ctl["trace"]), "ministeps")
    line("consistency_kkt_suppressed_keys", kkt_on["accounting"]["suppressed"], "keys")
    line("consistency_drill_rollbacks", len(drill["episodes"]), "episodes")
    out_path = os.environ.get("PS_CONSISTENCY_OUT") or os.path.join(tempfile.gettempdir(),
                                                                    "ps_consistency.json")
    if _rank() == 0:  # inside a world, rank 0 writes the record
        with open(out_path, "w") as f:
            json.dump({"consistency_record": out}, f, indent=2, default=str)
    return {"metrics": line.values, **out}


# -- the heat-driven live-repartitioning drill, in a world of 8 ranks --

REBALANCE_WORLD = 8  # 1x8: the max/mean imbalance can pass the shipped 4.0 at 8 shards, not at 4
REBALANCE_WORLD_S = 900  # the drill's world's time limit: a rank that hangs fails the drill
REBALANCE_TAIL = 2  # 1/REBALANCE_TAIL of the train stream runs after the rebalance


def _rebalance_rank(smoke: bool) -> dict:
    """The drill on one rank of the world (every rank runs it; rank 0's
    record is the drill's). Collectives, and which groups carry them:
    the serve stream's pulls run on the store's executor over the mesh's
    server group, and the serve thread agrees with the row where its
    stream ends (a MAX over that group after each pull), so every rank
    makes the same pulls; the trainer's pushes run no collective; the
    controller's plan broadcast and the migration's agreement and gather
    run on the alert-evaluating main thread over the mesh's side group
    (``parallel/mesh.py``). Each rank's alert fires on its own logical
    clock (its own trainer's progress); the migration meets when the
    last rank's fires, and each rank brings its snapshot up to the row's
    latest barrier from its journal."""
    import threading

    import torch.distributed as dist

    from ..parallel import mesh as meshlib
    from ..parallel import partition as partlib
    from ..parameter.kv_vector import KVVector
    from ..system import faults
    from ..system.postoffice import Postoffice
    from ..telemetry import alerts as alerts_mod
    from ..telemetry import registry as telemetry_registry
    from ..telemetry.instruments import learning_instruments
    from ..telemetry.learning import KeyHeat

    world = dist.get_world_size()
    assert world == REBALANCE_WORLD, f"the rebalance drill needs a world of 8 ranks, got {world}"
    Postoffice.reset()
    faults.reset()

    # -- 1. mesh: the auto-shape demo and the 1x8 drill mesh, 0 idle --
    demo = meshlib.make_mesh(num_server=3)  # -> 4x2, never 3x2 with 2 idle
    assert (demo.shape[meshlib.DATA_AXIS], demo.shape[meshlib.SERVER_AXIS]) == (4, 2), demo
    mesh = meshlib.make_mesh(num_data=1, num_server=8)
    dev = mesh.device
    mesh_section = {
        "devices_total": world, "devices_used": mesh.size, "devices_idle": world - mesh.size,
        "shape": {"data": mesh.shape[meshlib.DATA_AXIS],
                  "server": mesh.shape[meshlib.SERVER_AXIS]},
        "auto_shape_demo": {"requested_server": 3,
                            "chosen": {"data": demo.shape[meshlib.DATA_AXIS],
                                       "server": demo.shape[meshlib.SERVER_AXIS]},
                            "devices_idle": world - demo.size},
    }
    assert mesh_section["devices_idle"] == 0 and mesh_section["auto_shape_demo"]["devices_idle"] == 0

    k = 4
    keys = np.arange(48, dtype=np.int64)
    hot = keys[:8]  # one server shard's key range (slots 0..7 of 64)
    n_batches = 160 if smoke else 280
    batch_n = 64

    def mk_batch(i: int):
        r = np.random.default_rng(1000 + i)
        pick_hot = r.random(batch_n) < 0.8
        ks = np.where(pick_hot, r.choice(hot, size=batch_n),
                      r.choice(keys[8:], size=batch_n)).astype(np.int64)
        return ks, r.normal(size=(batch_n, k)).astype(np.float32)

    batches = [mk_batch(i) for i in range(n_batches)]

    def new_store(name: str, m=mesh):
        if not m.active:
            return None
        kv = KVVector(mesh=m, k=k, num_slots=64, hashed=False, name=name)
        kv.set_keys(0, keys)
        return kv

    def train(kv, bs):
        if kv is None:
            return None
        for ks, vs in bs:
            kv.push(kv.request(channel=0), keys=ks, values=vs)
        kv.executor.wait_all(pop=False)
        table = kv.get_replica()[0]
        kv.executor.stop()
        return table

    # -- 2. a table over 2 server shards trains bit-identically to 1 --
    single = train(new_store("reb_1shard", meshlib.make_mesh(num_data=4, num_server=1)),
                   batches[:6])
    multi = train(new_store("reb_2shard", meshlib.make_mesh(num_data=4, num_server=2)),
                  batches[:6])
    parity_single_multi = single is not None and single.tobytes() == multi.tobytes()
    if single is not None:
        assert parity_single_multi, "2-server-shard table diverged from the single-shard run"

    # -- the undisturbed reference (and a warm-up of the migration path) --
    ref = new_store("reb_ref")
    for ks, vs in batches:
        ref.push(ref.request(channel=0), keys=ks, values=vs)
    ref.executor.wait_all(pop=False)
    ref_table = ref.get_replica()[0]
    ref.wait_pull(ref.pull(ref.request(channel=0), keys=keys))
    ref.executor.stop()
    scratch = new_store("reb_scratch")
    scratch.push(scratch.request(channel=0), keys=batches[0][0], values=batches[0][1])
    scratch.migrate(np.random.default_rng(2).permutation(64))
    scratch.wait_pull(scratch.pull(scratch.request(channel=0), keys=keys))
    scratch.executor.stop()

    # -- 3. the live phase: skewed train + serve + alert + controller --
    kv = new_store("reb_live")
    heat = KeyHeat(num_slots=kv.num_slots, num_shards=8, top_k=16, decay_every=1 << 30)
    ctl = partlib.RebalanceController(kv, heat)
    reg = telemetry_registry.default_registry()
    gauge = learning_instruments(reg)["shard_imbalance"]
    mgr = alerts_mod.AlertManager(alerts_mod.default_rules(), registry=reg)
    transitions = []
    mgr.add_listener(lambda ev: transitions.append(f"{ev.frm}->{ev.to}")
                     if ev.rule == "shard_imbalance" else None)
    # the live phase's timeline on the host clock, seconds from its start:
    # the rebalance's start and end (with the pushes acknowledged at each)
    # and the train stream's end
    timeline = {}
    execute = ctl.execute

    def timed_execute(force: bool = False):
        timeline["rebalance_start_s"] = time.perf_counter() - t_live
        timeline["acked_at_start"] = progress["acked"]
        out = execute(force)
        timeline["rebalance_end_s"] = time.perf_counter() - t_live
        timeline["acked_at_end"] = progress["acked"]
        return out

    ctl.execute = timed_execute
    ctl.attach(mgr)
    # widen the copy window so the streams demonstrably cross the move
    faults.arm("rebalance.migrate", kind="delay", delay_s=0.25, once=True)
    progress = {"t": 0.0, "acked": 0}
    serve_stats = {"ok": 0, "failed": 0}
    stop_serve = threading.Event()

    def serve():
        while True:
            try:
                kv.wait_pull(kv.pull(kv.request(channel=0), keys=keys)).cpu()
                serve_stats["ok"] += 1
            except Exception:  # noqa: BLE001 — counted: the contract is zero
                serve_stats["failed"] += 1
            if meshlib.agree_max(int(stop_serve.is_set()), meshlib.SERVER_AXIS, kv.mesh):
                return
            time.sleep(0.001)

    # the train stream's last REBALANCE_TAIL of its batches wait until
    # every rank of the row has the rebalance in its history: traffic
    # flows after the move however the host paces the threads, and the
    # re-measured imbalance has data to read
    hold_at = n_batches - n_batches // REBALANCE_TAIL
    held, release = threading.Event(), threading.Event()

    def trainer():
        for i, (ks, vs) in enumerate(batches):
            if i == hold_at:
                held.set()
                release.wait()
            kv.push(kv.request(channel=0), keys=ks, values=vs)
            progress["acked"] += 1
            heat.note(kv.channel(0).directory.slots(ks))
            imb = heat.shares().get("imbalance")
            if imb is not None:
                gauge.set(imb)
            progress["t"] = float(i + 1)  # the drill's logical clock
            time.sleep(0.002)

    serve_t = threading.Thread(target=serve, name="reb-serve")
    train_t = threading.Thread(target=trainer, name="reb-train")
    t_live = time.perf_counter()
    serve_t.start()
    train_t.start()
    # the shipped rules evaluated on the LOGICAL clock (the batch index),
    # so the for_s dwell is deterministic, not host-paced. Once this
    # rank's rebalance is done and its trainer held, the row agrees (a
    # barrier over the side group, which the migration's own collectives
    # on this thread have left) and the tail flows
    while train_t.is_alive():
        was_held = held.is_set()
        mgr.evaluate(now=progress["t"])
        if was_held and not release.is_set():
            if ctl.history():
                meshlib.agree_max(1, meshlib.SERVER_AXIS, kv.mesh.side)
            # else the alert never fired by the hold: the tail goes on,
            # and the checks below report it on every rank
            release.set()
        time.sleep(0.004)
    train_t.join()
    timeline["train_end_s"] = time.perf_counter() - t_live
    mgr.evaluate(now=progress["t"] + 6.0)  # let the alert resolve
    stop_serve.set()
    serve_t.join(timeout=REBALANCE_WORLD_S)
    kv.executor.wait_all(pop=False)

    # -- 4. verify: every rank checks, then the row agrees before the
    # next collective, so a failed check fails every rank alike --
    hist = ctl.history()
    post_imb = ctl.refresh_post_imbalance()
    rec = dict(hist[0]) if hist else {}
    failed = None
    try:
        assert len(hist) == 1, f"expected exactly one alert-triggered rebalance, got {hist}"
        assert kv.layout(0) is not None
        assert rec["journaled_pushes"] > 0 and rec["replayed_pushes"] > 0, (
            f"the move missed the live stream: nothing journaled or replayed ({rec})")
        assert post_imb is not None and post_imb < ctl.threshold, (
            f"post-rebalance imbalance {post_imb} still over {ctl.threshold} "
            f"(timeline {timeline})")
        assert serve_stats["failed"] == 0 and serve_stats["ok"] > 0, (
            f"serve stream across the migration broke: {serve_stats}")
    except AssertionError as e:
        failed = e
    if meshlib.agree_max(int(failed is not None), meshlib.SERVER_AXIS, kv.mesh.side):
        kv.executor.stop()
        raise failed or AssertionError("another rank of the row failed the drill's checks")
    live_table = kv.get_replica()[0]
    bit_identical = live_table.tobytes() == ref_table.tobytes()
    assert bit_identical, "post-migration table diverged from the undisturbed run"
    kv.executor.stop()
    faults.reset()
    Postoffice.reset()
    return {
        "mesh": mesh_section,
        "rebalance": {
            "alert": {"rule": "shard_imbalance", "threshold": ctl.threshold,
                      "transitions": transitions},
            "imbalance_before": rec["imbalance_before"],
            "predicted_imbalance": rec["predicted_imbalance"],
            "post_rebalance_imbalance": round(float(post_imb), 4),
            "rows_moved": rec["rows_moved"],
            "moves": rec["moves"],
            "migration_seconds": rec["migration_seconds"],
            "journaled_pushes": rec["journaled_pushes"],
            "replayed_pushes": rec["replayed_pushes"],
            "attempts": rec["attempts"],
            "barrier_ts": rec["barrier_ts"],
            "install_ts": rec["install_ts"],
            "acked_pushes": progress["acked"],
            "serve": {"requests": serve_stats["ok"] + serve_stats["failed"],
                      "completed_ok": serve_stats["ok"], "failed": serve_stats["failed"]},
            "sharded_vs_single_bit_identical": parity_single_multi,
            "trajectory_bit_identical": bit_identical,
            "timeline": timeline,
        },
        "device": {"backend": mesh.backend,
                   "device_kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                   else "cpu")},
    }


def rebalance_drill(smoke: bool = False, device=None) -> dict:
    """Heat-driven live repartitioning on a 1x8 mesh of ranks (the JAX
    drill on its 8 forced devices; here a world of 8 processes this call
    starts, on ``device``'s type, unless it runs inside a world of 8
    already, where each rank runs it). On one card the ranks share it
    over gloo, so nothing here measures NCCL.

    1. **mesh**: auto-shaping (num_server=3 over 8 ranks is 4x2, never
       3x2 with 2 idle) and the drill's 1x8 mesh with 0 idle;
    2. **parity**: a table over 2 server shards (4x2) trains bit-identically
       to the single-shard one (4x1);
    3. **skew → alert → rebalance**: a live train stream (80% of the keys
       on one shard) feeds ``KeyHeat``; the measured imbalance rides the
       ``ps_learning_shard_imbalance`` gauge into the SHIPPED
       ``shard_imbalance`` rule; the attached ``RebalanceController``
       plans and migrates online while a ``rebalance.migrate`` delay
       widens the journal window;
    4. **verify**: the serve stream across the move completes every
       request, post-rebalance imbalance re-measures below the threshold,
       and the final base-layout table is bit-identical to an undisturbed
       run. (The JAX drill's ``recompiles_post_warmup``, XLA's compile
       count after warm-up, has no counterpart: eager PyTorch compiles
       nothing.)

    Returns rank 0's record."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == REBALANCE_WORLD:
        return _rebalance_rank(smoke)
    from ..parallel import launch

    dev = _device(device)
    recs = launch.run_world(_rebalance_rank, REBALANCE_WORLD, args=(smoke,),
                            device_type=dev.type, timeout=REBALANCE_WORLD_S, quiet=True)
    return recs[0]


@benchmark("rebalance")
def rebalance_perf(smoke: bool = False, device=None) -> dict:
    """The heat-driven live-repartitioning drill (:func:`rebalance_drill`):
    every contract is asserted inside it; this wrapper reports the
    headline numbers and writes the whole record where
    ``PS_REBALANCE_OUT`` points (default ``<tmp>/ps_rebalance.json``)."""
    import json
    import os
    import tempfile

    line = _Lines()
    out = rebalance_drill(smoke, device)
    reb = out["rebalance"]
    line("rebalance_imbalance_before", reb["imbalance_before"], "ratio")
    line("rebalance_post_imbalance", reb["post_rebalance_imbalance"], "ratio")
    line("rebalance_rows_moved", reb["rows_moved"], "rows")
    line("rebalance_migration_seconds", reb["migration_seconds"], "s")
    line("rebalance_replayed_pushes", reb["replayed_pushes"], "pushes")
    # serve failures are asserted 0 inside the drill and kept in the
    # record; the completions (always > 0) are reported instead
    line("rebalance_serve_ok", reb["serve"]["completed_ok"], "requests")
    out_path = os.environ.get("PS_REBALANCE_OUT") or os.path.join(tempfile.gettempdir(),
                                                                  "ps_rebalance.json")
    with open(out_path, "w") as f:
        json.dump({"rebalance_record": out}, f, indent=2)
    return {"metrics": line.values, **out}
