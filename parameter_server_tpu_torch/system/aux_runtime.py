"""Production wiring of heartbeat → metrics plane → dashboard → recovery.

The reference starts these as part of every run: nodes send
HeartbeatReports on a timer (``src/system/postoffice.cc`` heartbeat
thread), the scheduler renders the dashboard (``dashboard.cc``) and its
manager reacts to dead nodes (``manager.cc`` dead-node flow). Round 1
built the pieces but never started them from a production loop; this
module is the glue the apps actually call — and, since the cluster
metrics plane, the place per-node METRIC reports are produced:
each registered node owns a private registry of ps_node_* instruments
refreshed from its HeartbeatReport, shipped over the Van's real
transfer path (serialization, filter chains, byte accounting, the
``van.transfer`` fault point) to the scheduler-side
:class:`~parameter_server_tpu_torch.telemetry.aggregate.ClusterAggregator`,
which merges everything under a ``node`` label for the exposition
endpoint (telemetry/exposition.py). The direct-call path is kept for
single-process tests (``wire=False``).

Usage (see apps/linear/main.py and tests/test_aux_integration.py):

    aux = Postoffice.instance().start_aux(heartbeat_timeout=10.0)
    aux.coordinator.on_worker_dead(pool.restore)
    aux.start(check_interval=1.0, dashboard_interval=30.0,
              metrics_interval=1.0)
    ...   # hot loops call po.beat(node_id) / aux.beat(node_id)
    aux.stop()
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..telemetry import registry as telemetry_registry
from ..telemetry.aggregate import ClusterAggregator
from .dashboard import Dashboard
from .heartbeat import (
    ClockSync,
    HeartbeatCollector,
    HeartbeatInfo,
    HeartbeatReport,
)
from .message import Command, Message, Task
from .recovery import RecoveryCoordinator

_LOG = logging.getLogger(__name__)


class AuxRuntime:
    """Heartbeat sampling + liveness + metrics plane + dashboard."""

    def __init__(
        self,
        heartbeat_timeout: float = 10.0,
        print_fn: Callable[[str], None] = print,
        node_id: Optional[str] = None,
        stale_after_s: Optional[float] = None,
    ):
        self.collector = HeartbeatCollector(timeout=heartbeat_timeout)
        # "default": the dashboard's telemetry section renders whatever
        # the process default registry holds at report time (the spine
        # every layer records into — doc/OBSERVABILITY.md)
        self.dashboard = Dashboard(registry="default")
        self.coordinator = RecoveryCoordinator(self.collector)
        # node-death bundles captured through this coordinator get the
        # full cluster context (Van-fetched rings, merged metrics,
        # alert states, clock offsets) instead of a process-local view
        self.coordinator.bundle_context = self
        self.print_fn = print_fn
        #: this PROCESS's identity on the cluster metrics plane — the
        #: node the default registry's export is reported under. One
        #: process per node in the multi-process future; "H0" (the
        #: scheduler) in today's single-process runs.
        self.node_id = node_id or os.environ.get("PS_NODE_ID", "H0")
        #: scheduler-side merge of every node's metric reports
        self.cluster = ClusterAggregator(
            stale_after_s=(
                heartbeat_timeout if stale_after_s is None else stale_after_s
            )
        )
        #: optional AlertManager (telemetry/alerts.py) — set_alerts()
        self.alerts = None
        #: per-peer clock-offset estimates from metric-report round
        #: trips (heartbeat.ClockSync) — the alignment input of the
        #: merged multi-node timeline and of every diagnostic bundle
        self.clock = ClockSync()
        #: when True (default), an alert's pending→firing transition
        #: auto-captures a diagnostic bundle (telemetry/blackbox.py —
        #: rate-limited there); the evidence is gone by the time a
        #: human reads the page, so capture rides the transition
        self.bundle_on_alerts = True
        self._last_bundle: Optional[dict] = None  # guarded-by: _bundle_lock
        self._last_bundle_t = 0.0  # guarded-by: _bundle_lock
        self._bundle_lock = threading.Lock()
        self._tel = None
        if telemetry_registry.enabled():
            from ..telemetry.instruments import heartbeat_instruments

            self._tel = heartbeat_instruments(
                telemetry_registry.default_registry()
            )
        #: scrape-time refresh floor: a /metrics GET younger than this
        #: since the last sweep serves the merged view as-is instead of
        #: re-sweeping — a tight scrape loop must not multiply message-
        #: plane traffic or tick per-node report counters (and the
        #: heartbeat.report fault point's call counter) at scrape rate
        self.scrape_refresh_min_s = 0.2
        #: window of down-sampled history each metric report carries
        #: (telemetry/history.py export_ring) — the retention the
        #: scheduler-side range queries serve for remote nodes
        self.history_ship_window_s = 600.0
        self._last_sweep = 0.0  # monotonic; single float, atomic in CPython
        # serializes the scrape-time floor check-and-sweep: N handler
        # threads scraping concurrently must collapse to ONE sweep per
        # floor window, not each pass the age check before any sweep
        # lands (the MonitorMaster.maybe_print race, same shape)
        self._sweep_lock = threading.Lock()
        self._infos: Dict[str, HeartbeatInfo] = {}  # guarded-by: _lock
        # per-node PRIVATE registries for the metrics plane:
        # node id -> (registry, instruments, last-lifetime-totals)
        self._node_regs: Dict[str, Tuple] = {}  # guarded-by: _lock
        # per-(node -> scheduler) RemoteNode endpoint pairs for the
        # metric-report wire (stateful filter chains stay per peer)
        self._wire_eps: Dict[str, Tuple] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- node-side (each logical node beats from its hot loop) --

    def register(self, node_id: str, hostname: str = "") -> HeartbeatInfo:
        """Create (or return) the node's metrics sampler and report an
        initial heartbeat AND metric report, so liveness tracking and
        cluster staleness marking both start immediately — a node that
        goes silent right after joining shows up STALE in the merged
        view, not absent from it."""
        with self._lock:
            info = self._infos.get(node_id)
            if info is None:
                import socket

                info = HeartbeatInfo(hostname=hostname or socket.gethostname())
                self._infos[node_id] = info
        # direct-path seed (wire=False): registration is local
        # bootstrap, not remote traffic — it must not tick the Van's
        # byte accounting the way timer-driven reports deliberately do
        self.report_node(node_id, wire=False)
        return info

    def beat(self, node_id: str) -> None:
        """Sample and report one heartbeat (ref postoffice.cc heartbeat
        thread body). Safe no-op for unregistered nodes."""
        with self._lock:
            info = self._infos.get(node_id)
        if info is None:
            return
        self._deliver(node_id, info.get())

    def _deliver(self, node_id: str, report: HeartbeatReport) -> bool:
        """Feed one sampled report into collector + dashboard +
        registry mirrors; returns False when the collector's armed
        ``heartbeat.report`` silence swallowed it (the node is 'dead'
        to the scheduler — nothing downstream may report on its
        behalf)."""
        before = self.collector.last_seen(node_id)
        self.collector.report(node_id, report)
        if self.collector.last_seen(node_id) == before:
            return False
        self.dashboard.add_report(node_id, report)
        if self._tel is not None:
            self._tel["reports"].labels(node=node_id).inc()
            self._tel["net_in_mb"].labels(node=node_id).set(report.net_in_mb)
            self._tel["net_out_mb"].labels(node=node_id).set(report.net_out_mb)
        # a node beating again after being declared dead is back — allow
        # future re-detection (ref manager re-adding a returned node)
        self.coordinator.revive(node_id)
        return True

    def info(self, node_id: str) -> Optional[HeartbeatInfo]:
        with self._lock:
            return self._infos.get(node_id)

    def forget(self, node_id: str) -> None:
        """Drop a decommissioned node everywhere (elastic shrink): its
        sampler, its liveness record, its metrics-plane state, and its
        dead-handled flag — so it neither false-alarms a 'death' nor
        blocks re-detection if the same slot id joins again later."""
        with self._lock:
            self._infos.pop(node_id, None)
            self._node_regs.pop(node_id, None)
            self._wire_eps.pop(node_id, None)
        self.collector.forget(node_id)
        self.cluster.forget(node_id)
        self.coordinator.revive(node_id)

    # -- the cluster metrics plane --

    def report_node(self, node_id: str, wire: Optional[bool] = None) -> bool:
        """One node's metric report: heartbeat-deliver, refresh its
        private ps_node_* registry from the sampled report, and ship
        the registry export to the aggregator — over the Van message
        plane when the system is started (``wire=None`` auto-detects;
        ``False`` forces the direct call for single-process tests).
        Returns False when the report was silenced or lost."""
        with self._lock:
            info = self._infos.get(node_id)
        if info is None:
            return False
        report = info.get()
        if not self._deliver(node_id, report):
            return False  # silenced: a crashed node reports NOTHING
        export = self._node_export(node_id, info, report)
        return self._ship(
            node_id, export, report, wire,
            history_ring=self._node_history_ring(node_id),
        )

    def report_all(self, wire: Optional[bool] = None) -> int:
        """One metrics-plane sweep: every registered node reports, plus
        the process default registry under this process's
        :attr:`node_id` (when that id is not itself a registered
        sampler). Returns how many reports landed."""
        self._last_sweep = time.monotonic()
        with self._lock:
            node_ids = list(self._infos)
        landed = sum(1 for nid in node_ids if self.report_node(nid, wire))
        if self.node_id not in node_ids:
            from .faults import check as faults_check

            if faults_check("heartbeat.report", detail=self.node_id) is None:
                if self._ship(
                    self.node_id,
                    telemetry_registry.default_registry().export_state(),
                    None,
                    wire,
                    history_ring=self._default_history_ring(),
                ):
                    landed += 1
        return landed

    def _default_history_ring(self) -> Optional[dict]:
        """The process default store's shipped ring (fold first so the
        ring covers this sweep's registry state); None on any failure —
        history must never break the metric report that carries it."""
        try:
            from ..telemetry import history as history_mod

            store = history_mod.default_store()
            store.fold()
            return store.export_ring(window_s=self.history_ship_window_s)
        except Exception:
            return None

    def _node_history_ring(self, node_id: str) -> Optional[dict]:
        """One node's shipped history ring: its private registry's
        store, merged (for THIS process's node) with the default
        store's ring the same way :meth:`_node_export` merges the
        registries themselves."""
        try:
            with self._lock:
                entry = self._node_regs.get(node_id)
            if entry is None:
                return None
            store = entry[3]
            store.fold()
            ring = store.export_ring(window_s=self.history_ship_window_s)
            if node_id == self.node_id:
                spine = self._default_history_ring()
                if spine is not None:
                    merged = dict(spine["metrics"])
                    merged.update(ring["metrics"])
                    ring = dict(spine)
                    ring["metrics"] = merged
                    ring["series"] = sum(
                        len(m["series"]) for m in merged.values()
                    )
            return ring
        except Exception:
            return None

    def _node_export(
        self, node_id: str, info: HeartbeatInfo, report: HeartbeatReport
    ) -> dict:
        """Refresh the node's private registry from its sampler and
        return the export. Counters advance by LIFETIME-total deltas so
        they stay monotone no matter how report windows interleave with
        hot-loop beats (which drain the per-report deltas)."""
        from ..telemetry.history import HistoryStore
        from ..telemetry.instruments import node_instruments
        from ..telemetry.registry import MetricsRegistry

        with self._lock:
            entry = self._node_regs.get(node_id)
            if entry is None:
                reg = MetricsRegistry()
                # each node's metrics plane gets its own ring cascade —
                # the per-node history the scheduler's fleet-wide range
                # queries serve (shipped by _node_history_ring)
                entry = self._node_regs[node_id] = (
                    reg, node_instruments(reg), {"t": None},
                    HistoryStore(reg),
                )
            reg, tel, state = entry[:3]
            now = time.monotonic()
            for key, total in (
                ("busy", info.total_busy_ms / 1e3),
                ("net_in", float(info.total_in_bytes)),
                ("net_out", float(info.total_out_bytes)),
            ):
                prev = state.get(key, 0.0)
                if total > prev:
                    tel[key].inc(total - prev)
                state[key] = max(prev, total)
            tel["heartbeats"].inc()
            tel["rss_mb"].set(report.process_rss_mb)
            tel["cpu"].set(report.process_cpu_usage)
            tel["host_cpu"].set(report.host_cpu_usage)
            tel["uptime"].set(info.uptime_s)
            if state["t"] is not None:
                tel["report_interval"].observe(now - state["t"])
            state["t"] = now
        export = reg.export_state()
        if node_id == self.node_id:
            # this process's node also carries the process-wide
            # registry (the spine every layer records into)
            merged = dict(telemetry_registry.default_registry().export_state())
            merged.update(export)
            export = merged
        return export

    def _wire_pair(self, node_id: str):
        from .remote_node import RemoteNode

        with self._lock:
            pair = self._wire_eps.get(node_id)
            if pair is None:
                pair = self._wire_eps[node_id] = (
                    RemoteNode(self.node_id),  # node's endpoint → scheduler
                    RemoteNode(node_id),       # scheduler's endpoint ← node
                )
            return pair

    def _ship(
        self,
        node_id: str,
        export: dict,
        report: Optional[HeartbeatReport],
        wire: Optional[bool],
        history_ring: Optional[dict] = None,
    ) -> bool:
        """Move one report to the aggregator — through ``van.transfer``
        (real serialization + byte accounting + the ``van.transfer``
        fault point) when the system is started, directly otherwise.
        The node's down-sampled history ring piggybacks on the same
        frame: a dropped frame loses the shipment (staleness shows it),
        never half of it."""
        payload = {"node": node_id, "metrics": export}
        if report is not None:
            payload["heartbeat"] = report
        if history_ring is not None:
            payload["history"] = history_ring
        van = None
        if wire is not False:
            from .postoffice import Postoffice

            po = Postoffice._instance  # never create the singleton here
            van = po.van if po is not None else None
        if van is not None:
            msg = Message(
                task=Task(cmd=Command.HEARTBEAT, payload=payload),
                sender=node_id,
                recver=self.node_id,
            )
            tx, rx = self._wire_pair(node_id)
            try:
                t0 = time.perf_counter()
                out = van.transfer(tx, rx, msg)
                delivery_s = time.perf_counter() - t0
            except Exception as e:  # injected drop / torn frame: the
                # report is LOST — staleness tracking is how it shows
                _LOG.debug("metric report from %s lost: %s", node_id, e)
                return False
            payload = out.task.payload
            # clock sync: the frame's trace context carries the send
            # wall time on the NODE's clock; paired with our receive
            # time + the measured delivery duration it yields one
            # offset sample (heartbeat.ClockSync — merged timelines
            # align on these). The whole measured window IS the
            # one-way delivery on this loopback leg (transfer returns
            # when the receiver has decoded), so it is passed as
            # delay_s whole — halving it would bias every offset by
            # +delay/2, which an injected van delay fault would turn
            # into a real misalignment of bundle timelines
            trace = getattr(out.task, "trace", None)
            if isinstance(trace, dict) and trace.get("t_send") is not None:
                self.clock.observe(
                    node_id, float(trace["t_send"]), time.time(),
                    delivery_s,
                )
        self.handle_metrics_message(payload)
        return True

    def handle_metrics_message(self, payload: dict) -> None:
        """Receiver side of a metric report (scheduler): merge the
        node's export; a piggybacked HeartbeatReport from a REMOTE
        process also lands in the collector/dashboard (in-process
        reports already delivered through :meth:`_deliver`)."""
        node = payload["node"]
        self.cluster.update(node, payload["metrics"])
        # history rides the same frame but folds separately: a torn /
        # partial payload without a well-formed ring drops THIS
        # shipment only — the aggregator's stored ring for the node is
        # never replaced with garbage (it goes stale by age instead)
        hist = payload.get("history")
        if isinstance(hist, dict) and isinstance(hist.get("metrics"), dict):
            self.cluster.update_history(node, hist)
        hb = payload.get("heartbeat")
        if hb is not None and self.info(node) is None:
            self.collector.report(node, hb)
            self.dashboard.add_report(node, hb)

    # -- flight-recorder rings + diagnostic bundles --

    def fetch_rings(self, wire: Optional[bool] = None) -> Dict[str, dict]:
        """One ring dump per known node, fetched over the Van message
        plane (real serialization through the restricted unpickler,
        byte accounting, the ``van.transfer`` fault point) — the metric
        report path, reused for incident evidence. Staleness semantics
        for silent nodes: a node whose metric reports are already stale
        is NOT fetched (a crashed node answers nothing — pretending to
        dump its ring would fabricate evidence), and a fetch lost on
        the wire records the loss instead of the ring. This process's
        own node dumps locally (there is no wire to itself)."""
        from ..telemetry import blackbox

        rings: Dict[str, dict] = {}
        ages = self.cluster.node_ages()
        stale = set(self.cluster.stale_nodes())
        with self._lock:
            node_ids = set(self._infos)
        node_ids.add(self.node_id)
        van = None
        if wire is not False:
            from .postoffice import Postoffice

            po = Postoffice._instance  # never create the singleton here
            van = po.van if po is not None else None
        for nid in sorted(node_ids):
            # this process's OWN node dumps locally FIRST, before any
            # staleness verdict: a stalled aux loop marks self stale —
            # exactly the wedged-process incident a bundle diagnoses —
            # but the in-memory ring needs no wire and is provably
            # alive (this code is executing); skipping it would drop
            # the prime evidence from its own capture
            if nid == self.node_id:
                rec = blackbox.recorder(nid, create=False)
                if rec is None:
                    rec = blackbox.installed_recorder()
                rings[nid] = (
                    rec.dump() if rec is not None
                    else {"absent": True,
                          "reason": "no flight recorder registered"}
                )
                continue
            if nid in stale:
                rings[nid] = {
                    "stale": True,
                    "reason": "metric reports stale — node silent",
                    "report_age_s": round(ages.get(nid, -1.0), 3),
                }
                continue
            rec = blackbox.recorder(nid, create=False)
            if rec is None:
                rings[nid] = {
                    "absent": True,
                    "reason": "no flight recorder registered",
                }
                continue
            dump = rec.dump()
            if van is None:
                rings[nid] = dump
                continue
            msg = Message(
                task=Task(
                    cmd=Command.DUMP_BLACKBOX,
                    payload={"node": nid, "dump": dump},
                ),
                sender=nid,
                recver=self.node_id,
            )
            tx, rx = self._wire_pair(nid)
            try:
                rings[nid] = van.transfer(tx, rx, msg).task.payload["dump"]
            except Exception as e:  # injected drop / torn frame
                rings[nid] = {
                    "stale": True,
                    "reason": f"ring fetch lost on the wire: {e}",
                    "report_age_s": round(ages.get(nid, -1.0), 3),
                }
        return rings

    def bundle(self, trigger: str = "scrape", force: bool = False) -> dict:
        """The /debug/bundle body: a full diagnostic bundle
        (telemetry/blackbox.capture_bundle) with this runtime's cluster
        context. ``scrape`` captures are floored at
        :attr:`scrape_refresh_min_s` like /metrics — a tight scrape
        loop (or N concurrent handler threads) serves the cached bundle
        instead of re-driving the message plane and ticking fault-point
        call counters per GET. A non-``scrape`` trigger always captures
        fresh: serving a cached bundle stamped with a different trigger
        kind would misreport why the artifact exists."""
        from ..telemetry import blackbox

        with self._bundle_lock:
            now = time.monotonic()
            if (
                not force
                and trigger == "scrape"
                and self._last_bundle is not None
                and now - self._last_bundle_t < self.scrape_refresh_min_s
            ):
                return self._last_bundle
            b = blackbox.capture_bundle(trigger=trigger, aux=self)
            self._last_bundle, self._last_bundle_t = b, now
            return b

    def metrics_text(self, refresh: bool = True) -> str:
        """The /metrics scrape body: refresh local nodes' reports (each
        passing the heartbeat fault gate — a silenced node goes stale,
        it does not freeze) and render the node-labeled merged view.
        Refreshes are floored at :attr:`scrape_refresh_min_s` so a
        tight scrape loop reads the merged view instead of re-driving
        the message plane per GET — and the floor check-and-sweep is
        ONE critical section, so N concurrent scrapers (the exposition
        server is threaded) collapse to one sweep per window instead of
        each passing the age check before any sweep lands."""
        if refresh:
            with self._sweep_lock:
                if (
                    time.monotonic() - self._last_sweep
                    >= self.scrape_refresh_min_s
                ):
                    self.report_all()
        return self.cluster.render_text()

    def health(self, now: Optional[float] = None) -> Tuple[bool, dict]:
        """The /healthz verdict: non-OK while any tracked shard is dead
        (heartbeat timeout) or its metric reports are stale. Firing
        alerts are DISCLOSED but do not flip health — an SLO breach is
        the workload's problem, not the process's."""
        dead = sorted(self.collector.dead_nodes(now))
        stale = self.cluster.stale_nodes()
        firing = sorted(self.alerts.firing()) if self.alerts is not None else []
        detail = {
            "ok": not dead and not stale,
            "node_id": self.node_id,
            "dead_nodes": dead,
            "stale_nodes": stale,
            "node_report_age_s": {
                n: round(a, 3) for n, a in sorted(self.cluster.node_ages().items())
            },
            "heartbeat_timeout_s": self.collector.timeout,
            "stale_after_s": self.cluster.stale_after_s,
            "recovery_running": self.running,
            "alerts_firing": firing,
        }
        return detail["ok"], detail

    def set_alerts(self, manager) -> None:
        """Attach an AlertManager: the aux loop evaluates it each pass,
        its transitions land in the dashboard event log, its firing
        rules show in /healthz + the dashboard's alerts section, and —
        when :attr:`bundle_on_alerts` — a pending→firing transition
        auto-captures a diagnostic bundle (the flight-recorder evidence
        of the breach, taken while it is still in the ring)."""
        self.alerts = manager
        manager.add_listener(
            lambda ev: self.dashboard.add_event(str(ev))
        )
        manager.add_listener(self._maybe_bundle_on_alert)
        self.dashboard.set_alerts(manager)

    def _maybe_bundle_on_alert(self, ev) -> None:
        """Alert-transition listener: firing → capture (rate-limited in
        blackbox; never raises — a broken capture must not stop the
        alert from delivering to other listeners)."""
        if not self.bundle_on_alerts or getattr(ev, "to", None) != "firing":
            return
        from ..telemetry import blackbox

        blackbox.trigger_bundle(
            "alert", detail=getattr(ev, "rule", ""), aux=self
        )

    # -- scheduler-side background services --

    def start(
        self,
        check_interval: float = 1.0,
        dashboard_interval: float = 0.0,
        metrics_interval: float = 0.0,
    ) -> None:
        """Start the liveness/recovery poller; ``dashboard_interval > 0``
        also prints the dashboard table on that period (ref dashboard.cc
        scheduler thread), and ``metrics_interval > 0`` runs the
        metrics-plane report sweep (ref postoffice.cc heartbeat thread:
        per-node reports over messages on a timer)."""
        if self._thread is not None:
            return
        self._stop.clear()
        last_dash = [time.monotonic()]
        last_metrics = [0.0]

        def loop() -> None:
            while not self._stop.wait(check_interval):
                self.coordinator.check()
                now = time.monotonic()
                if (
                    metrics_interval > 0
                    and now - last_metrics[0] >= metrics_interval
                ):
                    last_metrics[0] = now
                    try:
                        self.report_all()
                    except Exception:
                        _LOG.exception("metrics-plane sweep failed")
                if self.alerts is not None:
                    try:
                        # the loop IS the evaluator's schedule: its lag
                        # meta-gauge must be judged against this period
                        if self.alerts.period_s != check_interval:
                            self.alerts.period_s = check_interval
                        self.alerts.evaluate()
                    except Exception:
                        _LOG.exception("alert evaluation failed")
                if (
                    dashboard_interval > 0
                    and time.monotonic() - last_dash[0] >= dashboard_interval
                ):
                    last_dash[0] = time.monotonic()
                    self.print_fn(self.dashboard.report())

        self._thread = threading.Thread(target=loop, daemon=True, name="aux-runtime")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
        self.coordinator.stop()

    @property
    def running(self) -> bool:
        return self._thread is not None
