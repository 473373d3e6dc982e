"""Dashboard: node metrics table (ref ``src/system/dashboard.{h,cc}``).

Renders a fixed-width table of per-node heartbeat reports, ordered
scheduler → workers → servers by rank (ref NodeIDCmp), same column spirit
as the reference's dashboard output.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..telemetry import registry as telemetry_registry
from .heartbeat import HeartbeatReport

_COLUMNS = [
    ("node", 8),
    ("total(s)", 9),
    ("busy(s)", 8),
    ("in(MB)", 8),
    ("out(MB)", 8),
    ("rss(MB)", 8),
    ("cpu%", 6),
    ("host", 10),
]


def _node_sort_key(node_id: str):
    # H (scheduler) first, then W workers, then S servers, by numeric rank
    order = {"H": 0, "W": 1, "S": 2}
    return (order.get(node_id[:1], 3), int(node_id[1:]) if node_id[1:].isdigit() else 0)


class Dashboard:
    def __init__(self, registry=None) -> None:
        # Lock: AuxRuntime.beat() feeds reports from every node's
        # reporter/hot-loop thread while the aux poller thread renders
        # report() — an unlocked dict iteration there raised
        # "dictionary changed size during iteration" under load
        # (pslint guarded-access; regression test in
        # tests/test_system_aux.py).
        self._data: Dict[str, HeartbeatReport] = {}  # guarded-by: _lock
        self._tasks: Dict[str, int] = {}  # guarded-by: _lock
        self._events: list = []  # guarded-by: _lock — cluster events (resizes, recoveries)
        self._lock = threading.Lock()
        # telemetry source for the report's metrics section: None keeps
        # the bare node table (unit-test dashboards), a MetricsRegistry
        # pins one, and "default" resolves the process default registry
        # at RENDER time so a Postoffice.reset between construction and
        # report never shows a stale spine. AuxRuntime passes "default".
        self._registry = registry
        # optional AlertManager (telemetry/alerts.py): report() renders
        # its non-inactive rules under an "alerts:" heading, and its
        # transitions already land in the event log via add_event —
        # the scheduler-side console view of an SLO breach
        self._alerts = None

    def set_alerts(self, manager) -> None:
        self._alerts = manager

    def add_report(self, node_id: str, report: HeartbeatReport) -> None:
        with self._lock:
            self._data[node_id] = report

    def add_task(self, node_id: str, task_id: int) -> None:
        with self._lock:
            self._tasks[node_id] = task_id

    def add_event(self, line: str, keep: int = 8) -> None:
        """Record a cluster event (elastic resize with its measured
        stop-the-world pause, recovery, ...) shown under the node table
        — the reference's dashboard prints NodeChange notes the same
        way (ref dashboard.cc)."""
        with self._lock:
            self._events.append(line)
            del self._events[:-keep]

    def title(self) -> str:
        return "  ".join(name.ljust(width) for name, width in _COLUMNS)

    def report(self) -> str:
        # snapshot under the lock, render outside it (rendering calls
        # into the telemetry registry, which has locks of its own —
        # keep the dashboard leaf-level in the lock order)
        with self._lock:
            data = dict(self._data)
            events = list(self._events)
        lines = [self.title()]
        for nid in sorted(data, key=_node_sort_key):
            r = data[nid]
            cells = [
                nid,
                f"{r.total_time_milli / 1e3:.1f}",
                f"{r.busy_time_milli / 1e3:.1f}",
                f"{r.net_in_mb:.1f}",
                f"{r.net_out_mb:.1f}",
                f"{r.process_rss_mb:.0f}",
                f"{100 * r.process_cpu_usage:.0f}",
                r.hostname[:10],
            ]
            lines.append(
                "  ".join(c.ljust(w) for c, (_, w) in zip(cells, _COLUMNS))
            )
        lines.extend(f"event: {e}" for e in events)
        lines.extend(self._alert_lines())
        lines.extend(self._telemetry_lines())
        return "\n".join(lines)

    def _alert_lines(self) -> list:
        if self._alerts is None:
            return []
        active = [
            f"  {name} {st.state_name}"
            + (f" value={st.value:.6g}" if st.value is not None else "")
            for name, st in sorted(self._alerts.states().items())
            if st.state_name != "inactive"
        ]
        return ["alerts:"] + active if active else []

    def _telemetry_lines(self) -> list:
        """Registry snapshot rendered for humans: one line per series,
        histograms compressed to count/avg/p50/p99. Empty when no
        registry is wired or nothing has been recorded."""
        if self._registry is None:
            return []
        reg = (
            telemetry_registry.default_registry()
            if self._registry == "default"
            else self._registry
        )
        snap = reg.snapshot()
        lines = []
        for name, entry in snap.items():  # snapshot() is name-sorted
            for labelstr, val in entry["values"].items():
                series = f"{name}{{{labelstr}}}" if labelstr else name
                if entry["type"] == "histogram":
                    if not val["count"]:
                        continue
                    lines.append(
                        f"  {series} count={val['count']} "
                        f"avg={val['avg']:.6g} p50={val['p50']:.6g} "
                        f"p99={val['p99']:.6g}"
                    )
                else:
                    lines.append(f"  {series} {val:.6g}")
        if lines:
            lines.insert(0, "telemetry:")
        return lines
