"""Cluster aggregation: node-labeled merges of registry exports.

The reference ships cluster health as a first-class feature — heartbeat
reports flow over messages into a scheduler-side dashboard and
MonitorMaster merges per-node progress on a timer (``src/system/
monitor.h`` + ``dashboard.cc``). This module is the registry-level
version of that merge: every node periodically ships its registry's
raw state (:meth:`MetricsRegistry.export_state` — plain dicts, so the
report survives the restricted wire unpickler), and the scheduler-side
:class:`ClusterAggregator` folds the exports into one view where every
series carries a ``node`` label.

Typed merge semantics (doc/OBSERVABILITY.md "Cluster metrics plane"):

- **counters sum** — each node's series is kept under its ``node``
  label AND a ``node="cluster"`` rollup carries the sum per inner
  label set;
- **gauges keep per-node series** — a point-in-time value summed
  across nodes means nothing, so gauges get no rollup;
- **histograms merge bucket-wise** — exports carry raw bucket counts
  (not percentiles), so the cluster rollup is the element-wise sum of
  bucket counts + count/sum, with min/max folded; nodes whose bucket
  bounds disagree with the first-seen declaration are a merge
  CONFLICT (counted, per-node series skipped) rather than a silent
  mis-merge.

Staleness: each node's last-report time is tracked; a node silent for
longer than ``stale_after_s`` is *marked* in the merged view
(``ps_cluster_node_up{node=...} 0`` + its report age) instead of its
last values silently freezing — the difference between "the shard is
fine" and "the scraper is reading a corpse".
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import registry as telemetry_registry
from .registry import (
    MetricsRegistry,
    _escape,
    _fmt,
    _help_line,
    _histogram_lines,
)

#: the ``node`` label value carried by merged (cluster-rollup) series —
#: reserved: a real node reporting under this id is rejected
CLUSTER_NODE = "cluster"

#: the label the aggregator prepends to every merged series
NODE_LABEL = "node"


def export_default_registry() -> Dict[str, dict]:
    """The process default registry's raw export (one node's report)."""
    return telemetry_registry.default_registry().export_state()


def _series_key(labels: Dict[str, str], labelnames: List[str]) -> Tuple[str, ...]:
    return tuple(str(labels.get(n, "")) for n in labelnames)


def _prom_labels(pairs: List[Tuple[str, str]], extra: str = "") -> str:
    parts = [f'{n}="{_escape(str(v))}"' for n, v in pairs]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _MergedHist:
    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self, nbuckets: int):
        self.buckets = [0] * nbuckets
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def fold(self, series: dict) -> None:
        for i, c in enumerate(series["buckets"]):
            self.buckets[i] += int(c)
        self.count += int(series["count"])
        self.sum += float(series["sum"])
        for attr, pick in (("min", min), ("max", max)):
            v = series.get(attr)
            if v is None:
                continue
            cur = getattr(self, attr)
            setattr(self, attr, float(v) if cur is None else pick(cur, float(v)))


class ClusterAggregator:
    """node id → latest registry export, merged under a ``node`` label.

    Thread-safe: reports arrive from the aux runtime's timer thread (or
    straight off a Van transfer) while the exposition endpoint renders.
    Rendering snapshots under the lock and formats outside it.
    """

    def __init__(
        self,
        stale_after_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.stale_after_s = float(stale_after_s)
        self._clock = clock
        self._exports: Dict[str, Dict[str, dict]] = {}  # guarded-by: _lock
        self._last_t: Dict[str, float] = {}  # guarded-by: _lock
        self._reports: Dict[str, int] = {}  # guarded-by: _lock
        # per-node down-sampled history rings (telemetry/history.py
        # export_ring shape) with their own arrival times — histories
        # are PER-NODE evidence: they are never folded into the
        # node="cluster" rollup (range queries disclose each node's
        # ring and its staleness instead)
        self._histories: Dict[str, dict] = {}  # guarded-by: _lock
        self._history_t: Dict[str, float] = {}  # guarded-by: _lock
        # distinct (node, metric) pairs ever rejected from the merge —
        # a SET so one persistently-bad export counts once, not once
        # per scrape (merged() runs at the scrape rate)
        self._conflict_keys: set = set()  # guarded-by: _lock
        self._lock = threading.Lock()

    # -- ingest --

    def update(
        self, node: str, export: Dict[str, dict], t: Optional[float] = None
    ) -> None:
        """Fold one node's report in (replaces the node's previous
        export wholesale — exports are cumulative state, not deltas)."""
        if node == CLUSTER_NODE:
            raise ValueError(
                f"node id {CLUSTER_NODE!r} is reserved for merged series"
            )
        t = self._clock() if t is None else t
        with self._lock:
            self._exports[node] = export
            self._last_t[node] = t
            self._reports[node] = self._reports.get(node, 0) + 1

    def update_history(
        self, node: str, ring: dict, t: Optional[float] = None
    ) -> None:
        """Fold one node's shipped history ring in (wholesale replace,
        like :meth:`update` — rings are self-contained dumps). A report
        frame that arrives WITHOUT a ring leaves the previous one in
        place untouched: its age keeps growing, so a torn shipment
        shows as staleness, never as a poisoned or vanished ring."""
        if node == CLUSTER_NODE:
            raise ValueError(
                f"node id {CLUSTER_NODE!r} is reserved for merged series"
            )
        t = self._clock() if t is None else t
        with self._lock:
            self._histories[node] = ring
            self._history_t[node] = t

    def history_ages(self, now: Optional[float] = None) -> Dict[str, float]:
        now = self._clock() if now is None else now
        with self._lock:
            return {n: now - t for n, t in self._history_t.items()}

    def history_query(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> dict:
        """Fleet-wide range query over the shipped per-node rings:
        node-keyed series for one metric, each node carrying its ring
        age and staleness verdict. A stale node's last ring is still
        DISCLOSED (it is evidence) but flagged — and no cross-node
        rollup exists to silently absorb it."""
        ages = self.history_ages(now)
        with self._lock:
            rings = dict(self._histories)
        out: Dict[str, dict] = {"name": name, "nodes": {}}
        for node in sorted(rings):
            ring = rings[node]
            age = ages.get(node, -1.0)
            entry: dict = {
                "age_s": round(age, 3),
                "stale": age > self.stale_after_s,
                "ring_t": ring.get("t"),
            }
            decl = ring.get("metrics", {}).get(name)
            if decl is not None:
                series = [
                    s for s in decl.get("series", ())
                    if labels is None or all(
                        str(s.get("labels", {}).get(k)) == str(v)
                        for k, v in labels.items()
                    )
                ]
                if window_s is not None and ring.get("t") is not None:
                    cutoff = float(ring["t"]) - float(window_s)
                    series = [
                        {
                            **s,
                            "points": [
                                p for p in s.get("points", ())
                                if p.get("t", 0.0) >= cutoff
                            ],
                        }
                        for s in series
                    ]
                entry["kind"] = decl.get("kind")
                entry["resolution"] = decl.get("resolution")
                entry["series"] = series
            out["nodes"][node] = entry
        return out

    def history_snapshot(self, now: Optional[float] = None) -> dict:
        """Per-node ring occupancy + staleness (/debug/snapshot)."""
        ages = self.history_ages(now)
        with self._lock:
            rings = dict(self._histories)
        return {
            "stale_after_s": self.stale_after_s,
            "nodes": {
                n: {
                    "age_s": round(ages.get(n, -1.0), 3),
                    "stale": ages.get(n, 0.0) > self.stale_after_s,
                    "series": rings[n].get("series"),
                    "window_s": rings[n].get("window_s"),
                    "metrics": len(rings[n].get("metrics", {})),
                }
                for n in sorted(rings)
            },
        }

    def forget(self, node: str) -> None:
        """Drop a decommissioned node (elastic shrink — a node removed
        on purpose must not linger as 'stale' forever)."""
        with self._lock:
            self._exports.pop(node, None)
            self._last_t.pop(node, None)
            self._reports.pop(node, None)
            self._histories.pop(node, None)
            self._history_t.pop(node, None)

    # -- staleness --

    def node_ages(self, now: Optional[float] = None) -> Dict[str, float]:
        now = self._clock() if now is None else now
        with self._lock:
            return {n: now - t for n, t in self._last_t.items()}

    def stale_nodes(self, now: Optional[float] = None) -> List[str]:
        return sorted(
            n
            for n, age in self.node_ages(now).items()
            if age > self.stale_after_s
        )

    @property
    def conflicts(self) -> int:
        """Distinct (node, metric) merge rejections seen so far."""
        with self._lock:
            return len(self._conflict_keys)

    # -- merge --

    def merged(self) -> Dict[str, dict]:
        """The cluster view in export_state shape: every series gains a
        ``node`` label; counters and histograms additionally carry a
        ``node="cluster"`` rollup series. JSON-able (/debug/snapshot)."""
        with self._lock:
            exports = {n: e for n, e in self._exports.items()}
        out: Dict[str, dict] = {}
        conflicts = set()
        for node in sorted(exports):
            for name in sorted(exports[node]):
                decl = exports[node][name]
                ref = out.get(name)
                if ref is None:
                    ref = out[name] = {
                        "type": decl["type"],
                        "help": decl.get("help", ""),
                        "labelnames": [NODE_LABEL] + list(decl["labelnames"]),
                        "series": [],
                    }
                    if decl["type"] == "histogram":
                        ref["buckets"] = list(decl["buckets"])
                elif ref["type"] != decl["type"] or (
                    decl["type"] == "histogram"
                    and list(decl["buckets"]) != ref["buckets"]
                ):
                    # a node re-declared the name with a different kind
                    # or bucket layout — merging would be a lie; count
                    # it and keep that node's series out
                    conflicts.add((node, name))
                    continue
                for s in decl["series"]:
                    labeled = dict(s)
                    labeled["labels"] = {NODE_LABEL: node, **s["labels"]}
                    ref["series"].append(labeled)
        if conflicts:
            with self._lock:
                self._conflict_keys |= conflicts
        # rollups: counters sum, histograms merge bucket-wise; gauges
        # keep per-node series only
        for name, decl in out.items():
            inner = decl["labelnames"][1:]
            if decl["type"] == "counter":
                sums: Dict[Tuple[str, ...], float] = {}
                for s in decl["series"]:
                    k = _series_key(s["labels"], inner)
                    sums[k] = sums.get(k, 0.0) + float(s["value"])
                for k in sorted(sums):
                    decl["series"].append({
                        "labels": {
                            NODE_LABEL: CLUSTER_NODE,
                            **dict(zip(inner, k)),
                        },
                        "value": sums[k],
                    })
            elif decl["type"] == "histogram":
                folds: Dict[Tuple[str, ...], _MergedHist] = {}
                for s in decl["series"]:
                    k = _series_key(s["labels"], inner)
                    h = folds.get(k)
                    if h is None:
                        h = folds[k] = _MergedHist(len(decl["buckets"]))
                    h.fold(s)
                for k in sorted(folds):
                    h = folds[k]
                    decl["series"].append({
                        "labels": {
                            NODE_LABEL: CLUSTER_NODE,
                            **dict(zip(inner, k)),
                        },
                        "buckets": list(h.buckets),
                        "count": h.count,
                        "sum": h.sum,
                        "min": h.min,
                        "max": h.max,
                    })
        return out

    # -- render --

    def _meta_registry(self, now: Optional[float] = None) -> MetricsRegistry:
        """The aggregator's own health series (ps_cluster_*), built
        against a fresh registry at render time — names declared in the
        canonical catalog (telemetry/instruments.py cluster_instruments)
        so the metrics lint covers them like every other family."""
        from .instruments import cluster_instruments

        reg = MetricsRegistry()
        tel = cluster_instruments(reg)
        ages = self.node_ages(now)
        with self._lock:
            reports = dict(self._reports)
            conflicts = len(self._conflict_keys)
        tel["nodes"].set(len(ages))
        if conflicts:
            tel["conflicts"].inc(conflicts)
        for node, age in sorted(ages.items()):
            tel["node_up"].labels(node=node).set(
                0.0 if age > self.stale_after_s else 1.0
            )
            tel["report_age"].labels(node=node).set(age)
            tel["reports"].labels(node=node).inc(reports.get(node, 0))
        return reg

    def render_text(self, now: Optional[float] = None) -> str:
        """Prometheus text of the merged, node-labeled view, prefixed by
        the aggregator's own ps_cluster_* health series (node up/age —
        the staleness marking). Merge runs FIRST so conflicts detected
        in this scrape already show in this scrape's meta block."""
        merged = self.merged()
        lines: List[str] = [self._meta_registry(now).render_text().rstrip("\n")]
        for name in sorted(merged):
            decl = merged[name]
            if decl["help"]:
                lines.append(_help_line(name, decl["help"]))
            lines.append(f"# TYPE {name} {decl['type']}")
            inner = decl["labelnames"]
            for s in decl["series"]:
                pairs = [(n, s["labels"].get(n, "")) for n in inner]
                if decl["type"] == "histogram":
                    # the ONE histogram text renderer, shared with the
                    # live registry (registry._histogram_lines) so the
                    # two /metrics producers cannot drift
                    lines.extend(_histogram_lines(
                        name,
                        lambda extra, pairs=pairs: _prom_labels(pairs, extra),
                        decl["buckets"], s["buckets"], s["count"], s["sum"],
                    ))
                else:
                    lines.append(
                        f"{name}{_prom_labels(pairs)} {_fmt(s['value'])}"
                    )
        return "\n".join(lines) + "\n"

    def snapshot(self, now: Optional[float] = None) -> dict:
        """JSON view for /debug/snapshot: node ages + staleness verdicts
        + the merged export."""
        now = self._clock() if now is None else now
        ages = self.node_ages(now)
        with self._lock:
            reports = dict(self._reports)
        return {
            "stale_after_s": self.stale_after_s,
            "nodes": {
                n: {
                    "report_age_s": round(age, 3),
                    "stale": age > self.stale_after_s,
                    "reports": reports.get(n, 0),
                }
                for n, age in sorted(ages.items())
            },
            "merge_conflicts": self.conflicts,
            "merged": self.merged(),
        }
