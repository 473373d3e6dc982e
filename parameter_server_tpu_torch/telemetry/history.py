"""The seventh plane is time: multi-resolution telemetry history.

Six planes (metrics, timeline, cluster, device, flight-recorder,
learning) answer "what is true NOW at one scrape". This module is the
retention layer behind them: an embedded, bounded, RRD-style ring
cascade (default 1s x 10m -> 10s x 2h -> 60s x 12h) fed by a registry
collector hook, so every fold of the live registry lands one typed
sample in every resolution level simultaneously.

Typed downsampling per instrument kind (doc/OBSERVABILITY.md "History
plane"):

- **counters -> rates**: each ring cell holds the counter's INCREASE
  within the cell (reset-aware: a restart contributes the post-reset
  value, never a negative delta), so per-second rates are computable at
  every resolution by ``delta / cell_width``;
- **gauges -> last/min/max**: each cell keeps the last sample plus the
  cell's min/max envelope — a spike inside a 60s cell stays visible;
- **histograms -> bucket-delta merges**: each cell holds the
  element-wise bucket-count delta (+ count/sum deltas), so windowed
  quantiles stay computable at every resolution by summing cell deltas
  and interpolating over the declared bounds.

Cardinality is capped per metric family and in total; a series past
the cap is DROPPED (once, loudly: ``ps_history_dropped_series_total``)
rather than allowed to grow the rings without bound — history can
never OOM a node.

Consumers: alert multi-window burn rates and ``trend`` drift rules
(telemetry/alerts.py) evaluate from these rings; per-node rings ride
the aux report plane into the ClusterAggregator; ``/metrics/history``
serves range queries; flight-recorder bundles embed the down-sampled
hour before their trigger (telemetry/blackbox.py).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import registry as telemetry_registry

#: default ring cascade: (cell width seconds, slots) per level — about
#: 10 minutes at 1s, 2 hours at 10s, 12 hours at 60s
DEFAULT_RESOLUTIONS: Tuple[Tuple[float, int], ...] = (
    (1.0, 600),
    (10.0, 720),
    (60.0, 720),
)

#: default per-metric / process-wide series caps (the escape valve)
MAX_SERIES_PER_METRIC = 32
MAX_SERIES_TOTAL = 1024


def _series_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labels_match(series_labels: Dict[str, str],
                  want: Optional[Dict[str, str]]) -> bool:
    """Subset match: ``want=None`` matches everything; otherwise every
    given pair must be present in the series' labels."""
    if want is None:
        return True
    return all(str(series_labels.get(k)) == str(v) for k, v in want.items())


class _Level:
    """One resolution level of one series: parallel rings indexed by
    ``epoch % slots`` with the owning epoch stored per cell, so stale
    cells (lapped by the ring) are recognized at read time instead of
    being zeroed eagerly."""

    __slots__ = ("res", "slots", "epochs", "a", "b", "c", "h")

    def __init__(self, res: float, slots: int, kind: str, nbuckets: int):
        self.res = res
        self.slots = slots
        # None = never claimed (an int sentinel like -1 would collide
        # with a real epoch under near-zero fake clocks)
        self.epochs: List[Optional[int]] = [None] * slots
        # typed payload rings:
        #   counter:   a = delta
        #   gauge:     a = last, b = min, c = max
        #   histogram: a = count delta, b = sum delta, h = bucket deltas
        self.a = [0.0] * slots
        self.b = [0.0] * slots if kind in ("gauge", "histogram") else None
        self.c = [0.0] * slots if kind == "gauge" else None
        self.h: Optional[List[Optional[List[int]]]] = (
            [None] * slots if kind == "histogram" else None
        )


class _Series:
    """One tracked (metric, label-set): the cumulative baseline used
    for delta computation plus one ring set per resolution level."""

    __slots__ = ("name", "kind", "labels", "bounds", "levels",
                 "prev_value", "prev_buckets", "prev_count", "prev_sum")

    def __init__(self, name: str, kind: str, labels: Dict[str, str],
                 bounds: Optional[List[float]],
                 resolutions: Sequence[Tuple[float, int]]):
        self.name = name
        self.kind = kind
        self.labels = dict(labels)
        self.bounds = list(bounds) if bounds is not None else None
        nb = len(self.bounds) if self.bounds is not None else 0
        self.levels = [
            _Level(res, slots, kind, nb) for res, slots in resolutions
        ]
        self.prev_value: Optional[float] = None
        self.prev_buckets: Optional[List[int]] = None
        self.prev_count = 0
        self.prev_sum = 0.0


def percentile_from_buckets(
    bounds: Sequence[float], dcounts: Sequence[float], dcount: float, q: float
) -> Optional[float]:
    """Windowed percentile from merged bucket-count deltas — the same
    bucket-edge interpolation as alerts.windowed_quantile, kept here so
    every history resolution answers quantile queries identically."""
    if dcount <= 0:
        return None
    rank = q * dcount
    cum = 0.0
    for i, c in enumerate(dcounts):
        if c <= 0:
            continue
        lo = bounds[i - 1] if i else 0.0
        if cum + c >= rank:
            frac = (rank - cum) / c
            return lo + frac * (bounds[i] - lo)
        cum += c
    return float(bounds[-1])


def theil_sen(points: Sequence[Tuple[float, float]]) -> Optional[float]:
    """Median of pairwise slopes — the robust slope estimator behind
    the ``trend`` alert kind (a single outlier cell cannot fake or
    hide a drift the way it skews a least-squares fit). O(n^2) pairs;
    callers bound n by the queried window / resolution."""
    slopes: List[float] = []
    n = len(points)
    for i in range(n):
        t0, v0 = points[i]
        for j in range(i + 1, n):
            t1, v1 = points[j]
            if t1 > t0:
                slopes.append((v1 - v0) / (t1 - t0))
    if not slopes:
        return None
    slopes.sort()
    m = len(slopes)
    mid = m // 2
    return slopes[mid] if m % 2 else 0.5 * (slopes[mid - 1] + slopes[mid])


def monotonic_fractions(values: Sequence[float]) -> Tuple[float, float]:
    """(frac_up, frac_down) over consecutive deltas — the concordance
    gate that separates a sustained ramp from noise around a level."""
    ups = downs = 0
    for a, b in zip(values, values[1:]):
        if b > a:
            ups += 1
        elif b < a:
            downs += 1
    steps = max(1, len(values) - 1)
    return ups / steps, downs / steps


def drift_check(
    samples: Sequence[Tuple[float, float]],
    baseline_frac: float = 0.3,
    tail_frac: float = 0.3,
    tol: float = 0.15,
    min_points: int = 6,
) -> dict:
    """Live steady-state drift verdict over a run's own (t, throughput)
    windows — bench_diff's idea reborn online: the tail of the run is
    judged against its post-warmup baseline, same-host same-run, so no
    cross-run capacity drift can alibi or fake the verdict. Median of
    each segment (robust to one throttled window) + the Theil-Sen
    slope as supporting evidence. ``drifting`` only flags DOWNWARD
    drift beyond ``tol`` — a run that speeds up is not a defect."""
    pts = [(float(t), float(v)) for t, v in samples]
    out: dict = {"n": len(pts), "tol": tol}
    if len(pts) < min_points:
        out["verdict"] = "insufficient-data"
        out["drifting"] = False
        return out
    pts.sort(key=lambda p: p[0])
    k_base = max(2, int(len(pts) * baseline_frac))
    k_tail = max(2, int(len(pts) * tail_frac))

    def median(vals: List[float]) -> float:
        s = sorted(vals)
        m = len(s) // 2
        return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])

    base = median([v for _, v in pts[:k_base]])
    tail = median([v for _, v in pts[-k_tail:]])
    ratio = tail / base if base > 0 else None
    out.update({
        "baseline_median": base,
        "tail_median": tail,
        "ratio": ratio,
        "slope_per_s": theil_sen(pts),
    })
    drifting = ratio is not None and ratio < 1.0 - tol
    out["drifting"] = drifting
    out["verdict"] = "drift-down" if drifting else "ok"
    return out


class HistoryStore:
    """The bounded multi-resolution store over one MetricsRegistry.

    ``install()`` registers :meth:`collect` as a registry collector, so
    every snapshot/export/render keeps the rings fresh; the aux loop
    and the alert evaluator also fold explicitly (fake-clock tests
    drive :meth:`fold` with explicit timestamps). Folding is floored at
    half the base resolution — a tight scrape loop cannot multiply the
    fold cost.
    """

    def __init__(
        self,
        registry: Optional[telemetry_registry.MetricsRegistry] = None,
        resolutions: Sequence[Tuple[float, int]] = DEFAULT_RESOLUTIONS,
        max_series_per_metric: int = MAX_SERIES_PER_METRIC,
        max_series_total: int = MAX_SERIES_TOTAL,
        clock: Callable[[], float] = time.time,
    ):
        res = sorted(
            (float(r), int(s)) for r, s in resolutions
        )
        if not res or any(r <= 0 or s <= 1 for r, s in res):
            raise ValueError(f"bad resolutions {resolutions!r}")
        self.registry = registry or telemetry_registry.default_registry()
        self.resolutions: Tuple[Tuple[float, int], ...] = tuple(res)
        self.max_series_per_metric = int(max_series_per_metric)
        self.max_series_total = int(max_series_total)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, tuple], _Series] = {}  # guarded-by: _lock
        self._per_metric: Dict[str, int] = {}  # guarded-by: _lock
        self._dropped: set = set()  # guarded-by: _lock
        self._last_fold = -float("inf")  # guarded-by: _lock
        self._folds = 0  # guarded-by: _lock
        self._tel = None
        if telemetry_registry.enabled():
            from .instruments import history_instruments

            self._tel = history_instruments(self.registry)

    # -- feed --

    def install(self) -> "HistoryStore":
        """Hook :meth:`collect` into the registry's collector list (the
        bound method is weakly referenced — keep the store alive)."""
        self.registry.add_collector(self.collect)
        return self

    def collect(self) -> None:
        """Registry collector hook: rate-limited fold at wall time."""
        self.fold()

    def fold(self, now: Optional[float] = None, force: bool = False) -> bool:
        """Fold the registry's current state into every ring level;
        returns whether a fold ran (floored at half the base
        resolution unless ``force``)."""
        now = self._clock() if now is None else float(now)
        base_res = self.resolutions[0][0]
        with self._lock:
            if not force and now - self._last_fold < 0.5 * base_res:
                return False
            prev = self._last_fold
            self._last_fold = now
        # attribute this fold's deltas to the MIDPOINT of the fold
        # interval (clamped to one base cell back): a fold landing
        # exactly on a cell boundary would otherwise write the previous
        # second's accrual into a cell with ~zero elapsed width, and
        # that cell's per-point rate would explode
        if prev == -float("inf"):
            t_attr = now
        else:
            t_attr = max((prev + now) / 2.0, now - base_res)
        t0 = time.perf_counter()
        # read WITHOUT running collectors: fold() is itself invoked as
        # one (registry.collect would recurse), and the snapshot paths
        # that want flushed producers already ran them before this hook
        export = self.registry.export_state(collect=False)
        with self._lock:
            for name in export:
                decl = export[name]
                kind = decl["type"]
                if kind not in ("counter", "gauge", "histogram"):
                    continue
                bounds = decl.get("buckets")
                for s in decl["series"]:
                    self._fold_series_locked(name, kind, bounds, s, t_attr)
            self._folds += 1
            nseries = len(self._series)
        fold_s = time.perf_counter() - t0
        if self._tel is not None:
            self._tel["fold_seconds"].observe(fold_s)
            self._tel["folds"].inc()
            self._tel["series"].set(nseries)
            last_collect = getattr(self.registry, "last_collect_s", None)
            if last_collect is not None:
                self._tel["collect_seconds"].set(last_collect)
        return True

    def _fold_series_locked(  # holds-lock: _lock (fold's export walk)
        self, name: str, kind: str, bounds, s: dict, now: float
    ) -> None:
        key = (name, _series_key(s["labels"]))
        ser = self._series.get(key)
        if ser is None:
            per = self._per_metric.get(name, 0)
            if (
                per >= self.max_series_per_metric
                or len(self._series) >= self.max_series_total
            ):
                if key not in self._dropped:
                    self._dropped.add(key)
                    if self._tel is not None:
                        self._tel["dropped"].labels(metric=name).inc()
                return
            ser = self._series[key] = _Series(
                name, kind, s["labels"], bounds, self.resolutions
            )
            self._per_metric[name] = per + 1
        if ser.kind != kind:
            return  # re-declared name: keep the original rings honest

        if kind == "counter":
            v = float(s["value"])
            prev = ser.prev_value
            # reset-aware increase (a restarted process contributes its
            # post-reset total, never a negative delta)
            delta = v if prev is None or v < prev else v - prev
            if prev is None:
                delta = 0.0  # first sight: no window to attribute to
            ser.prev_value = v
            for lv in ser.levels:
                idx, fresh = self._cell(lv, now)
                lv.a[idx] = delta if fresh else lv.a[idx] + delta
        elif kind == "gauge":
            v = float(s["value"])
            for lv in ser.levels:
                idx, fresh = self._cell(lv, now)
                lv.a[idx] = v
                if fresh:
                    lv.b[idx] = v
                    lv.c[idx] = v
                else:
                    if v < lv.b[idx]:
                        lv.b[idx] = v
                    if v > lv.c[idx]:
                        lv.c[idx] = v
        else:  # histogram
            cur_b = [int(c) for c in s["buckets"]]
            cur_n, cur_sum = int(s["count"]), float(s["sum"])
            pb = ser.prev_buckets
            if pb is None:
                db, dn, ds = None, 0, 0.0  # first sight: baseline only
            elif cur_n < ser.prev_count or len(pb) != len(cur_b):
                db, dn, ds = cur_b, cur_n, cur_sum  # reset: post-reset obs
            else:
                db = [max(0, a - b) for a, b in zip(cur_b, pb)]
                dn = cur_n - ser.prev_count
                ds = cur_sum - ser.prev_sum
            ser.prev_buckets = cur_b
            ser.prev_count, ser.prev_sum = cur_n, cur_sum
            if db is None or dn <= 0:
                return
            for lv in ser.levels:
                idx, fresh = self._cell(lv, now)
                if fresh or lv.h[idx] is None:
                    lv.h[idx] = list(db)
                    lv.a[idx] = float(dn)
                    lv.b[idx] = ds
                else:
                    cell = lv.h[idx]
                    for i, d in enumerate(db):
                        cell[i] += d
                    lv.a[idx] += float(dn)
                    lv.b[idx] += ds

    @staticmethod
    def _cell(lv: _Level, now: float) -> Tuple[int, bool]:
        """(ring index, is-a-fresh-epoch) for ``now`` at this level —
        claiming a lapped cell resets nothing eagerly; the ``fresh``
        flag tells the caller to overwrite."""
        epoch = int(now // lv.res)
        idx = epoch % lv.slots
        fresh = lv.epochs[idx] != epoch
        if fresh:
            lv.epochs[idx] = epoch
        return idx, fresh

    # -- queries --

    def _pick_level(
        self, ser: _Series, window_s: float, resolution: Optional[float]
    ) -> _Level:
        if resolution is not None:
            for lv in ser.levels:
                if lv.res >= float(resolution) - 1e-9:
                    return lv
            return ser.levels[-1]
        for lv in ser.levels:
            if lv.res * lv.slots >= window_s:
                return lv
        return ser.levels[-1]

    def _cells_in_window_locked(
        self, ser: _Series, lv: _Level, window_s: float, now: float
    ) -> List[Tuple[float, int]]:
        """[(cell start time, ring index)] for live cells inside the
        window, oldest first. The CURRENT (still-open) cell is included
        — rates over it use the elapsed fraction, not the full width."""
        e_now = int(now // lv.res)
        e_min = max(e_now - lv.slots + 1, int((now - window_s) // lv.res))
        out = []
        for epoch in range(e_min, e_now + 1):
            idx = epoch % lv.slots
            if lv.epochs[idx] == epoch:
                out.append((epoch * lv.res, idx))
        return out

    def query(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        window_s: float = 600.0,
        resolution: Optional[float] = None,
        q: Optional[float] = None,
        now: Optional[float] = None,
    ) -> dict:
        """Range query: typed points per matching series. Counters
        yield ``{t, delta, rate}``; gauges ``{t, last, min, max}``;
        histograms ``{t, count, sum, rate}`` plus ``q``'s windowed
        percentile per cell when requested."""
        now = self._clock() if now is None else float(now)
        window_s = float(window_s)
        out = {
            "name": name,
            "window_s": window_s,
            "t": now,
            "series": [],
        }
        with self._lock:
            matches = [
                ser for (n, _), ser in sorted(self._series.items())
                if n == name and _labels_match(ser.labels, labels)
            ]
            if not matches:
                out["kind"] = None
                out["resolution"] = None
                return out
            lv0 = self._pick_level(matches[0], window_s, resolution)
            out["kind"] = matches[0].kind
            out["resolution"] = lv0.res
            for ser in matches:
                lv = self._pick_level(ser, window_s, resolution)
                cells = self._cells_in_window_locked(ser, lv, window_s, now)
                pts = []
                for t_cell, idx in cells:
                    # the open cell's width is the elapsed fraction
                    width = min(lv.res, max(now - t_cell, 1e-9))
                    if ser.kind == "counter":
                        pts.append({
                            "t": t_cell,
                            "delta": lv.a[idx],
                            "rate": lv.a[idx] / width,
                        })
                    elif ser.kind == "gauge":
                        pts.append({
                            "t": t_cell,
                            "last": lv.a[idx],
                            "min": lv.b[idx],
                            "max": lv.c[idx],
                        })
                    else:
                        p = {
                            "t": t_cell,
                            "count": lv.a[idx],
                            "sum": lv.b[idx],
                            "rate": lv.a[idx] / width,
                        }
                        if q is not None and ser.bounds and lv.h[idx]:
                            p["q"] = percentile_from_buckets(
                                ser.bounds, lv.h[idx], lv.a[idx], q
                            )
                        pts.append(p)
                out["series"].append({"labels": ser.labels, "points": pts})
        return out

    def window_rate(
        self,
        name: str,
        labels: Optional[Dict[str, str]],
        window_s: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Per-second rate over the window: counter deltas (or
        histogram count deltas) summed across matching series, divided
        by the window width. None when no data landed in the window."""
        now = self._clock() if now is None else float(now)
        total = 0.0
        seen = False
        with self._lock:
            for (n, _), ser in self._series.items():
                if n != name or not _labels_match(ser.labels, labels):
                    continue
                if ser.kind == "gauge":
                    continue
                lv = self._pick_level(ser, window_s, None)
                cells = self._cells_in_window_locked(ser, lv, window_s, now)
                if cells:
                    seen = True
                total += sum(lv.a[idx] for _, idx in cells)
        if not seen:
            return None
        return total / max(window_s, 1e-9)

    def window_quantile(
        self,
        name: str,
        labels: Optional[Dict[str, str]],
        window_s: float,
        q: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Windowed percentile: histogram cell bucket-deltas merged
        across the window and across matching series."""
        now = self._clock() if now is None else float(now)
        merged: Optional[List[float]] = None
        count = 0.0
        bounds: Optional[List[float]] = None
        with self._lock:
            for (n, _), ser in self._series.items():
                if (
                    n != name
                    or ser.kind != "histogram"
                    or ser.bounds is None
                    or not _labels_match(ser.labels, labels)
                ):
                    continue
                if bounds is None:
                    bounds = ser.bounds
                    merged = [0.0] * len(bounds)
                elif ser.bounds != bounds:
                    continue  # conflicting layouts never mis-merge
                lv = self._pick_level(ser, window_s, None)
                for _, idx in self._cells_in_window_locked(
                    ser, lv, window_s, now
                ):
                    cell = lv.h[idx]
                    if cell is None:
                        continue
                    for i, c in enumerate(cell):
                        merged[i] += c
                    count += lv.a[idx]
        if bounds is None or count <= 0:
            return None
        return percentile_from_buckets(bounds, merged, count, q)

    def value_points(
        self,
        name: str,
        labels: Optional[Dict[str, str]],
        window_s: float,
        now: Optional[float] = None,
        max_points: Optional[int] = None,
    ) -> List[Tuple[float, float]]:
        """The (t, value) series a trend test runs over: gauge cells
        yield their last value; counter/histogram cells their rate —
        summed across matching series per cell start. ``max_points``
        coarsens the resolution so the window yields at most that many
        cells (the trend test's Theil-Sen is O(n^2) pairs and runs
        every evaluator tick — 600 base cells would be 180k slopes)."""
        now = self._clock() if now is None else float(now)
        res_hint = (
            window_s / max_points if max_points and max_points > 0 else None
        )
        acc: Dict[float, float] = {}
        with self._lock:
            for (n, _), ser in self._series.items():
                if n != name or not _labels_match(ser.labels, labels):
                    continue
                lv = self._pick_level(ser, window_s, res_hint)
                for t_cell, idx in self._cells_in_window_locked(
                    ser, lv, window_s, now
                ):
                    if ser.kind == "gauge":
                        v = lv.a[idx]
                    else:
                        width = min(lv.res, max(now - t_cell, 1e-9))
                        v = lv.a[idx] / width
                    acc[t_cell] = acc.get(t_cell, 0.0) + v
        return sorted(acc.items())

    def trend(
        self,
        name: str,
        labels: Optional[Dict[str, str]],
        window_s: float,
        now: Optional[float] = None,
        min_points: int = 4,
        max_points: int = 64,
    ) -> Optional[dict]:
        """Robust monotonic-slope verdict over the window: Theil-Sen
        median slope + the up/down concordance fractions, over at most
        ``max_points`` cells (coarser levels for longer windows — the
        O(n^2) slope estimator runs every evaluator tick). None when
        the window holds fewer than ``min_points`` cells — a two-point
        'trend' is a coin flip, not a leak."""
        pts = self.value_points(
            name, labels, window_s, now, max_points=max_points
        )
        if len(pts) < max(2, int(min_points)):
            return None
        slope = theil_sen(pts)
        if slope is None:
            return None
        frac_up, frac_down = monotonic_fractions([v for _, v in pts])
        return {
            "slope_per_s": slope,
            "n": len(pts),
            "frac_up": frac_up,
            "frac_down": frac_down,
            "first": pts[0][1],
            "last": pts[-1][1],
        }

    # -- shipping / disclosure --

    def export_ring(
        self,
        window_s: float = 600.0,
        resolution: Optional[float] = None,
        now: Optional[float] = None,
        max_series: int = 256,
    ) -> dict:
        """JSON-able down-sampled dump of every tracked metric over the
        window — the unit a node ships over the report plane and a
        bundle embeds. Bounded twice: the window picks one level, and
        ``max_series`` caps the payload (drop count disclosed)."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            names = sorted({n for n, _ in self._series})
        metrics: Dict[str, dict] = {}
        shipped = 0
        truncated = 0
        for name in names:
            r = self.query(
                name, None, window_s=window_s, resolution=resolution, now=now
            )
            if not r["series"]:
                continue
            if shipped + len(r["series"]) > max_series:
                truncated += len(r["series"])
                continue
            shipped += len(r["series"])
            metrics[name] = {
                "kind": r["kind"],
                "resolution": r["resolution"],
                "series": r["series"],
            }
        return {
            "t": now,
            "window_s": window_s,
            "resolutions": [list(rs) for rs in self.resolutions],
            "series": shipped,
            "series_truncated": truncated,
            "metrics": metrics,
        }

    def snapshot(self) -> dict:
        """Retention-config + occupancy disclosure (/debug/snapshot)."""
        with self._lock:
            return {
                "resolutions": [
                    {"res_s": r, "slots": s, "span_s": r * s}
                    for r, s in self.resolutions
                ],
                "series": len(self._series),
                "series_dropped": len(self._dropped),
                "max_series_per_metric": self.max_series_per_metric,
                "max_series_total": self.max_series_total,
                "folds": self._folds,
                "last_fold_t": (
                    None if self._last_fold == -float("inf")
                    else self._last_fold
                ),
            }


# -- the process default store (bound to the default registry) --

_default_lock = threading.Lock()
_default_store: Optional[HistoryStore] = None  # guarded-by: _default_lock


def default_store() -> HistoryStore:
    """The process default store over the default registry. Rebinds
    after ``Postoffice.reset()`` (a store over an orphaned registry is
    replaced), so tests stay hermetic like the registry itself."""
    reg = telemetry_registry.default_registry()
    global _default_store
    with _default_lock:
        if _default_store is None or _default_store.registry is not reg:
            _default_store = HistoryStore(reg).install()
        return _default_store


def installed_store() -> Optional[HistoryStore]:
    """The default store if one is live for the CURRENT registry —
    never creates (bundle capture must not conjure an empty history)."""
    reg = telemetry_registry.default_registry()
    with _default_lock:
        if _default_store is not None and _default_store.registry is reg:
            return _default_store
        return None


def set_default_store(store: Optional[HistoryStore]) -> Optional[HistoryStore]:
    """Swap the process default store (fake-clock drills/tests install
    a store whose clock they control); returns the previous one. Pass
    None to restore lazy binding."""
    global _default_store
    with _default_lock:
        prev, _default_store = _default_store, store
        return prev


def reset_default_store() -> None:
    with _default_lock:
        global _default_store
        _default_store = None
