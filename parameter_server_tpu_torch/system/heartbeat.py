"""Heartbeats and failure detection.

Counterpart of ``src/system/heartbeat_info.{h,cc}``: each node periodically
reports host metrics (cpu, memory, traffic, busy time); the scheduler's
collector marks nodes dead when reports stop arriving — that's the failure
detection signal the manager uses to trigger workload restore
(WorkloadPool.restore) and replica recovery.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from ..utils import resource_usage
from . import faults


@dataclasses.dataclass
class HeartbeatReport:
    """ref proto/heartbeat.proto HeartbeatReport fields we can source."""

    hostname: str = ""
    seconds_since_epoch: float = 0.0
    total_time_milli: float = 0.0
    busy_time_milli: float = 0.0
    net_in_mb: float = 0.0
    net_out_mb: float = 0.0
    process_rss_mb: float = 0.0
    process_virt_mb: float = 0.0
    process_cpu_usage: float = 0.0
    host_cpu_usage: float = 0.0


class HeartbeatInfo:
    """Per-node metrics sampler (busy timer + /proc counters)."""

    def __init__(self, hostname: str = "localhost"):
        self.hostname = hostname
        self._busy_ms = 0.0  # guarded-by: _lock
        self._busy_start: Optional[float] = None  # guarded-by: _lock
        self._start = time.time()
        self._in_bytes = 0  # guarded-by: _lock
        self._out_bytes = 0  # guarded-by: _lock
        # lifetime totals: ``get()`` drains the per-report deltas above
        # (the dashboard's in(MB)/out(MB) are per-interval), so tests and
        # telemetry snapshots need a counter that never resets
        self._total_in_bytes = 0  # guarded-by: _lock
        self._total_out_bytes = 0  # guarded-by: _lock
        self._total_busy_ms = 0.0  # guarded-by: _lock
        self._last = resource_usage.sample()  # guarded-by: _lock
        self._lock = threading.Lock()

    def start_timer(self) -> None:
        with self._lock:
            self._busy_start = time.perf_counter()

    def stop_timer(self) -> None:
        with self._lock:
            if self._busy_start is not None:
                delta = (time.perf_counter() - self._busy_start) * 1e3
                self._busy_ms += delta
                self._total_busy_ms += delta
                self._busy_start = None

    def increase_in_bytes(self, delta: int) -> None:
        with self._lock:
            self._in_bytes += delta
            self._total_in_bytes += delta

    def increase_out_bytes(self, delta: int) -> None:
        with self._lock:
            self._out_bytes += delta
            self._total_out_bytes += delta

    @property
    def total_in_bytes(self) -> int:
        with self._lock:
            return self._total_in_bytes

    @property
    def total_out_bytes(self) -> int:
        with self._lock:
            return self._total_out_bytes

    @property
    def total_busy_ms(self) -> float:
        """Lifetime busy-timer milliseconds — ``get()`` drains the
        per-report delta, so the cluster metrics plane's monotone
        ps_node_busy_seconds_total counter needs this."""
        with self._lock:
            return self._total_busy_ms

    @property
    def uptime_s(self) -> float:
        return time.time() - self._start

    def get(self) -> HeartbeatReport:
        # The whole sample-and-diff runs under the lock (pslint
        # guarded-access): ``_last`` was previously read and replaced
        # OUTSIDE it, so two reporter threads could rate the same
        # window twice — or write an OLDER sample over a newer one,
        # making the next dt negative and the cpu rates garbage.
        # Sampling inside the lock serializes reporters, so successive
        # reports tile the timeline exactly once. sample() is two tiny
        # /proc reads; heartbeat cadence is seconds — contention is nil.
        with self._lock:
            cur = resource_usage.sample()
            busy = self._busy_ms
            self._busy_ms = 0.0
            in_b, self._in_bytes = self._in_bytes, 0
            out_b, self._out_bytes = self._out_bytes, 0
            last, self._last = self._last, cur
        dt = max(1e-9, cur.timestamp - last.timestamp)
        proc_cpu = (cur.cpu_seconds - last.cpu_seconds) / dt
        host_cpu = (
            (cur.host_total_cpu_seconds - last.host_total_cpu_seconds) / dt
        )
        return HeartbeatReport(
            hostname=self.hostname,
            seconds_since_epoch=cur.timestamp,
            total_time_milli=(cur.timestamp - self._start) * 1e3,
            busy_time_milli=busy,
            net_in_mb=in_b / 1e6,
            net_out_mb=out_b / 1e6,
            process_rss_mb=cur.rss_mb,
            process_virt_mb=cur.vm_mb,
            process_cpu_usage=proc_cpu,
            host_cpu_usage=host_cpu,
        )


class ClockSync:
    """Per-peer clock-offset estimation from metric-report exchanges.

    A merged multi-node timeline (telemetry/timeline.merge_node_events)
    is only readable if every node's wall clocks are aligned; real
    hosts drift. Each metric report that crosses the Van carries its
    send wall time (``Task.trace["t_send"]``, the sender's clock), the
    observer records its own receive time, and the CALLER supplies its
    best estimate of the one-way delivery delay between the two stamps
    (``delay_s``: the measured transfer duration for the in-process
    loopback leg — the whole measured window IS the delivery — or
    rtt/2 for a genuine request/response round trip). The sample is::

        offset = t_recv - delay_s - t_send    # node clock + offset
                                              #   ≈ observer clock

    and the retained estimate per peer is the sample with the SMALLEST
    observed delay (queueing inflates delay; the min-delay exchange
    bounds the error by that delay — the Cristian bound, disclosed
    alongside the estimate). In today's single-process runs offsets
    measure ~0 EVEN under injected ``van.transfer`` delay faults —
    the delay is measured, not assumed — which is the machinery's
    sanity check.
    """

    def __init__(self, keep_best: bool = True):
        self.keep_best = keep_best
        # node -> (offset_s, delay_s, n_samples)
        self._est: Dict[str, tuple] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(
        self, node_id: str, t_send: float, t_recv: float, delay_s: float
    ) -> None:
        """Fold one exchange in. Nonsensical samples (negative delay —
        a clock step mid-exchange) are dropped."""
        if delay_s < 0.0:
            return
        offset = t_recv - delay_s - t_send
        with self._lock:
            cur = self._est.get(node_id)
            n = (cur[2] + 1) if cur else 1
            if cur is None or not self.keep_best or delay_s < cur[1]:
                self._est[node_id] = (offset, delay_s, n)
            else:
                self._est[node_id] = (cur[0], cur[1], n)

    def offset(self, node_id: str) -> Optional[float]:
        """Seconds to ADD to ``node_id``'s clock to land on this
        process's clock, or None before any exchange."""
        with self._lock:
            cur = self._est.get(node_id)
            return cur[0] if cur else None

    def offsets(self) -> Dict[str, float]:
        """node id -> best offset estimate (merge_node_events shape)."""
        with self._lock:
            return {n: est[0] for n, est in self._est.items()}

    def snapshot(self) -> Dict[str, dict]:
        """Diagnostic view: offset + the delivery delay that produced
        it + sample count per peer (the delay IS the error bound)."""
        with self._lock:
            return {
                n: {
                    "offset_s": round(est[0], 6),
                    "delay_s": round(est[1], 6),
                    "error_bound_s": round(est[1], 6),
                    "samples": est[2],
                }
                for n, est in sorted(self._est.items())
            }


class HeartbeatCollector:
    """Scheduler-side liveness tracking (manager.cc heartbeat handling)."""

    def __init__(self, timeout: float = 10.0):
        self.timeout = timeout
        self._reports: Dict[str, HeartbeatReport] = {}  # guarded-by: _lock
        self._last_seen: Dict[str, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def report(self, node_id: str, hb: HeartbeatReport) -> None:
        # fault point (doc/ROBUSTNESS.md): an armed "silence" (matched
        # on the node id) drops the report BEFORE it refreshes
        # last-seen — to the collector the node simply stops reporting,
        # which is exactly what a crashed shard looks like. The node
        # itself keeps running; the recovery drill kills shards this way.
        if faults.check("heartbeat.report", detail=node_id) is not None:
            return
        with self._lock:
            self._reports[node_id] = hb
            self._last_seen[node_id] = time.time()

    def dead_nodes(self, now: Optional[float] = None) -> List[str]:
        """Nodes whose last report is older than the timeout."""
        now = now if now is not None else time.time()
        with self._lock:
            return [
                nid
                for nid, seen in self._last_seen.items()
                if now - seen > self.timeout
            ]

    def last_seen(self, node_id: str) -> Optional[float]:
        """Wall time of the node's newest *landed* report, or None.

        The metrics plane uses the before/after delta of this to learn
        whether a report it just submitted actually landed — an armed
        ``heartbeat.report`` silence drops reports inside
        :meth:`report`, and the caller must not then feed the cluster
        aggregator on the silenced node's behalf (a crashed node stops
        reporting *everything*)."""
        with self._lock:
            return self._last_seen.get(node_id)

    def forget(self, node_id: str) -> None:
        """Drop a decommissioned node from liveness tracking (elastic
        shrink: a node removed on purpose must not later 'die')."""
        with self._lock:
            self._reports.pop(node_id, None)
            self._last_seen.pop(node_id, None)

    def touch_all(self) -> None:
        """Refresh every tracked node's last-seen time: a deliberate
        cluster-wide pause (elastic resize, checkpoint restore) is not a
        death — without this, a pause longer than the timeout would make
        the next check declare every survivor dead at once."""
        now = time.time()
        with self._lock:
            for nid in self._last_seen:
                self._last_seen[nid] = now

    def reports(self) -> Dict[str, HeartbeatReport]:
        with self._lock:
            return dict(self._reports)
