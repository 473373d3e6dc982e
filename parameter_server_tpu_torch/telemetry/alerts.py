"""Live SLO alerting: declarative rules evaluated against the registry.

Admission, degraded reads and recovery made overload and failure *survivable* (admission 429s,
degraded 503s, recovery drills) but only *observable after the fact*,
by reading a bench record. This module closes the loop online: a small
Prometheus-alerting-style engine evaluates declarative threshold and
burn-rate rules on a sliding window of registry samples, walks each
rule through ``inactive → pending → firing → resolved``, exports the
state as ``ps_alert_state{rule=...}`` (0/1/2/3), and feeds every
transition to listeners (the Dashboard event log, via
``AuxRuntime.set_alerts``).

Rule kinds (``AlertRule.kind``):

- ``gauge`` — the metric's current value (max across matching series);
- ``counter_rate`` — per-second increase over the window (sum across
  matching series; counter resets clamp to no-data);
- ``ratio`` — rate(metric) / rate(sum of ``den`` metrics), e.g. the
  admission shed fraction shed/(shed+admitted);
- ``quantile`` — a WINDOWED histogram percentile from the bucket-count
  delta across the window (the registry's own percentile() is
  since-birth; alerting needs "p99 over the last 30s");
- ``burn_rate`` — ``ratio`` divided by the rule's error ``budget``:
  burn 1.0 consumes the budget exactly; sustained burn ≫ 1 pages;
- ``trend`` — a robust monotonic-slope test over a LONG window of the
  history plane (telemetry/history.py): Theil-Sen median slope gated
  by an up/down concordance fraction, for drift/leak rules (HBM
  high-water, live-buffer total, queue depth, staleness growth) that
  no instantaneous threshold can catch.

Multi-window conditions: ``counter_rate``/``ratio``/``burn_rate``/
``quantile`` rules with ``slow_window_s > 0`` evaluate from the
history plane over BOTH windows and the condition must hold on both —
the fast window catches a real overload quickly, the slow window keeps
a brief spike (shorter than the fast window's worth of budget) from
paging. Single-window rules keep the original in-process sample list.

A rule with no data (empty window, zero denominator, too few history
points) evaluates to None, which never satisfies the condition —
missing traffic resolves an alert rather than wedging it.

The default production rule set ships in ``configs/alerts/default.json``
(:func:`default_rules`); doc/OBSERVABILITY.md documents the syntax.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import registry as telemetry_registry

STATE_INACTIVE, STATE_PENDING, STATE_FIRING, STATE_RESOLVED = 0, 1, 2, 3
STATE_NAMES = {0: "inactive", 1: "pending", 2: "firing", 3: "resolved"}
KINDS = ("gauge", "counter_rate", "ratio", "quantile", "burn_rate", "trend")

#: kinds that may carry a slow window (fast+slow multi-window pairs)
_MULTI_WINDOW_KINDS = ("counter_rate", "ratio", "burn_rate", "quantile")
_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


@dataclasses.dataclass
class AlertRule:
    """One declarative rule (see module docstring for kinds)."""

    name: str
    kind: str
    metric: str
    threshold: float
    op: str = ">"
    labels: Optional[Dict[str, str]] = None  # None = all series
    den: Sequence[str] = ()      # ratio/burn_rate denominator metrics
    q: float = 0.99              # quantile kind
    budget: float = 0.0          # burn_rate error budget (fraction)
    window_s: float = 30.0       # sliding-window width (the FAST window)
    slow_window_s: float = 0.0   # > 0: multi-window pair, from history
    for_s: float = 0.0           # condition must hold this long to fire
    resolve_hold_s: float = 30.0  # how long 'resolved' shows before inactive
    min_points: int = 4          # trend: fewest history cells to judge
    monotonic_frac: float = 0.6  # trend: concordance gate (frac of steps)
    severity: str = "warn"       # page | warn (routing hint, not logic)
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"rule {self.name!r}: unknown kind {self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")
        if self.kind == "burn_rate" and self.budget <= 0:
            raise ValueError(f"rule {self.name!r}: burn_rate needs budget > 0")
        if self.kind in ("ratio", "burn_rate") and not self.den:
            raise ValueError(f"rule {self.name!r}: {self.kind} needs den=[...]")
        if not 0.0 < self.q < 1.0:
            raise ValueError(f"rule {self.name!r}: q outside (0, 1)")
        if self.slow_window_s:
            if self.kind not in _MULTI_WINDOW_KINDS:
                raise ValueError(
                    f"rule {self.name!r}: slow_window_s only applies to "
                    f"{_MULTI_WINDOW_KINDS}"
                )
            if self.slow_window_s <= self.window_s:
                raise ValueError(
                    f"rule {self.name!r}: slow_window_s "
                    f"({self.slow_window_s}) must exceed window_s "
                    f"({self.window_s})"
                )
        if self.kind == "trend":
            if self.min_points < 2:
                raise ValueError(
                    f"rule {self.name!r}: trend needs min_points >= 2"
                )
            if not 0.0 <= self.monotonic_frac <= 1.0:
                raise ValueError(
                    f"rule {self.name!r}: monotonic_frac outside [0, 1]"
                )


@dataclasses.dataclass
class AlertEvent:
    """One state transition, as delivered to listeners."""

    rule: str
    frm: str
    to: str
    value: Optional[float]
    threshold: float
    op: str
    t: float
    severity: str = "warn"

    def __str__(self) -> str:
        v = "n/a" if self.value is None else f"{self.value:.6g}"
        return (
            f"alert {self.rule}: {self.frm}->{self.to} "
            f"(value {v} {self.op} {self.threshold:g}, {self.severity})"
        )


class _RuleState:
    __slots__ = ("state", "value", "pending_since", "firing_since",
                 "resolved_at", "last_change")

    def __init__(self) -> None:
        self.state = STATE_INACTIVE
        self.value: Optional[float] = None
        self.pending_since: Optional[float] = None
        self.firing_since: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.last_change: Optional[float] = None

    @property
    def state_name(self) -> str:
        return STATE_NAMES[self.state]


# -- export readers (operate on MetricsRegistry.export_state dicts) --


def _series_matching(decl: dict, labels: Optional[Dict[str, str]]):
    for s in decl["series"]:
        if labels is None or all(
            str(s["labels"].get(k)) == str(v) for k, v in labels.items()
        ):
            yield s


def _scalar_sum(export: dict, metric: str, labels) -> Optional[float]:
    decl = export.get(metric)
    if decl is None:
        return None
    vals = [float(s["value"]) for s in _series_matching(decl, labels)]
    return sum(vals) if vals else None


def _scalar_max(export: dict, metric: str, labels) -> Optional[float]:
    decl = export.get(metric)
    if decl is None:
        return None
    vals = [float(s["value"]) for s in _series_matching(decl, labels)]
    return max(vals) if vals else None


def _hist_state(export: dict, metric: str, labels) -> Optional[Tuple[List[int], int]]:
    decl = export.get(metric)
    if decl is None or decl["type"] != "histogram":
        return None
    buckets: Optional[List[int]] = None
    count = 0
    for s in _series_matching(decl, labels):
        if buckets is None:
            buckets = [0] * len(s["buckets"])
        for i, c in enumerate(s["buckets"]):
            buckets[i] += int(c)
        count += int(s["count"])
    return None if buckets is None else (buckets, count)


def windowed_quantile(
    bounds: Sequence[float], dcounts: Sequence[int], dcount: int, q: float
) -> Optional[float]:
    """Percentile over a WINDOW of observations given the bucket-count
    delta across it. Same interpolation as the registry's percentile(),
    but bucket-edge-only (the window has no min/max): observations
    above the last finite bound clamp to it — fine for alerting, where
    the threshold sits well inside the bucket range."""
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


class AlertManager:
    """Evaluates rules against sampled registry exports.

    ``evaluate()`` is driven either by the aux runtime's poll loop
    (``AuxRuntime.set_alerts``) or by :meth:`start`'s own timer thread;
    both may coexist — evaluation is idempotent per timestamp and
    cheap (one registry export per tick).
    """

    def __init__(
        self,
        rules: Sequence[AlertRule],
        registry=None,
        clock: Callable[[], float] = time.monotonic,
        history=None,
    ):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.rules = list(rules)
        self._registry = registry  # None = resolve default at sample time
        self._clock = clock
        #: HistoryStore the trend / multi-window rules evaluate from;
        #: None resolves the process default (or lazily binds a private
        #: store when ``registry`` is private) at evaluate time
        self._history = history
        self._own_history = None
        #: expected evaluation period (seconds) — the baseline the
        #: ps_alert_eval_lag_seconds meta-gauge is judged against; set
        #: by :meth:`start` / the aux loop
        self.period_s = 1.0
        self._last_eval_t: Optional[float] = None  # guarded-by: _lock
        self._metrics = sorted(
            {r.metric for r in self.rules}
            | {m for r in self.rules for m in r.den}
        )
        # the sample list only serves single-window non-trend rules —
        # history-backed kinds must not inflate its retention
        self._window = max(
            (
                r.window_s for r in self.rules
                if r.kind != "trend" and not r.slow_window_s
            ),
            default=30.0,
        )
        self._samples: List[Tuple[float, dict]] = []  # guarded-by: _lock
        self._states: Dict[str, _RuleState] = {  # guarded-by: _lock
            r.name: _RuleState() for r in self.rules
        }
        self._events: List[AlertEvent] = []  # guarded-by: _lock
        self._listeners: List[Callable[[AlertEvent], None]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tel = None
        if telemetry_registry.enabled():
            from .instruments import alert_instruments

            self._tel = alert_instruments(
                telemetry_registry.default_registry()
            )

    def add_listener(self, fn: Callable[[AlertEvent], None]) -> None:
        self._listeners.append(fn)

    # -- sampling --

    def _sample(self) -> dict:
        reg = self._registry or telemetry_registry.default_registry()
        export = reg.export_state()
        # keep only the metrics rules reference — the deque holds
        # window_s worth of these every tick
        return {m: export[m] for m in self._metrics if m in export}

    # -- evaluation --

    def _history_store(self):
        """The HistoryStore backing trend / multi-window rules: the
        explicit one, the process default (tracks registry swaps), or a
        lazily-bound private store over an explicit private registry."""
        if self._history is not None:
            return self._history
        from . import history as history_mod

        if self._registry is None:
            return history_mod.default_store()
        if self._own_history is None:
            self._own_history = history_mod.HistoryStore(
                self._registry, clock=self._clock
            ).install()
        return self._own_history

    def evaluate(self, now: Optional[float] = None) -> List[AlertEvent]:
        """One tick: sample, compute every rule, advance state
        machines; returns (and delivers) the transitions."""
        now = self._clock() if now is None else now
        t_wall0 = time.perf_counter()
        # meta-monitoring BEFORE sampling, so the starvation rule reads
        # THIS tick's lag from this tick's own sample
        with self._lock:
            prev_t = self._last_eval_t
            self._last_eval_t = now
        if self._tel is not None and prev_t is not None:
            lag = max(0.0, (now - prev_t) - self.period_s)
            self._tel["eval_lag"].set(lag)
        # fold the history at this tick so history-backed rules see the
        # current registry state. The store folds and is queried on ITS
        # OWN clock (wall time for the process default; the evaluator's
        # clock may be monotonic — a different time base entirely), so
        # no explicit ``now`` is passed down. Fake-clock tests hand the
        # manager a HistoryStore built on the same fake clock.
        needs_history = any(
            r.kind == "trend" or r.slow_window_s for r in self.rules
        )
        if needs_history:
            try:
                self._history_store().fold()
            except Exception:
                pass  # a broken fold must not stop threshold alerting
        sample = self._sample()
        with self._lock:
            self._samples.append((now, sample))
            # drop samples older than the widest window (keep one
            # sample beyond the edge as the window's baseline)
            cutoff = now - self._window
            times = [t for t, _ in self._samples]
            keep_from = max(0, bisect.bisect_left(times, cutoff) - 1)
            del self._samples[:keep_from]
            samples = list(self._samples)
        events: List[AlertEvent] = []
        for rule in self.rules:
            value = self._compute(rule, samples, now)
            events.extend(self._advance(rule, value, now))
        for ev in events:
            with self._lock:
                self._events.append(ev)
                del self._events[:-64]
            for fn in list(self._listeners):
                try:
                    fn(ev)
                except Exception:
                    pass  # a broken listener must not stop alerting
        if self._tel is not None:
            self._tel["eval_seconds"].observe(
                time.perf_counter() - t_wall0
            )
        return events

    def _window_pair(
        self, rule: AlertRule, samples, now: float
    ) -> Optional[Tuple[Tuple[float, dict], Tuple[float, dict]]]:
        """(oldest-in-window, newest) sample pair, or None."""
        if not samples:
            return None
        cutoff = now - rule.window_s
        # baseline = the sample just BEFORE the cutoff when one exists
        # (the true window start), else the oldest sample available
        idx = 0
        for i, (t, _) in enumerate(samples):
            if t >= cutoff:
                idx = max(0, i - 1)
                break
        old = samples[idx]
        new = samples[-1]
        if new[0] <= old[0]:
            return None
        return old, new

    def _history_value(
        self, rule: AlertRule, window_s: float
    ) -> Optional[float]:
        """One window's value from the history plane (multi-window
        kinds): rates and quantiles computed from ring-cell deltas.
        Queries pass ``now=None`` so the store anchors the window on
        ITS OWN clock — the evaluator's clock may be a different time
        base (monotonic vs the default store's wall time)."""
        h = self._history_store()
        if rule.kind == "counter_rate":
            return h.window_rate(rule.metric, rule.labels, window_s)
        if rule.kind in ("ratio", "burn_rate"):
            num = h.window_rate(rule.metric, rule.labels, window_s)
            dens = [
                h.window_rate(m, rule.labels, window_s)
                for m in rule.den
            ]
            if num is None or any(d is None for d in dens):
                return None
            den = sum(dens)
            if den <= 0:
                return None
            value = num / den
            return value / rule.budget if rule.kind == "burn_rate" else value
        return h.window_quantile(
            rule.metric, rule.labels, window_s, rule.q
        )

    def _compute(
        self, rule: AlertRule, samples, now: float
    ) -> Optional[float]:
        if rule.kind == "trend":
            try:
                tr = self._history_store().trend(
                    rule.metric, rule.labels, rule.window_s,
                    min_points=rule.min_points,
                )
            except Exception:
                return None
            if tr is None:
                return None
            frac = (
                tr["frac_down"] if rule.op in ("<", "<=") else tr["frac_up"]
            )
            if frac < rule.monotonic_frac:
                return 0.0  # noise around a level, not a sustained drift
            return tr["slope_per_s"]
        if rule.slow_window_s:
            # fast AND slow must both breach: report the less-violating
            # window's value so the condition is the conjunction
            try:
                fast = self._history_value(rule, rule.window_s)
                slow = self._history_value(rule, rule.slow_window_s)
            except Exception:
                return None
            if fast is None or slow is None:
                return None
            pick = min if rule.op in (">", ">=") else max
            return pick(fast, slow)
        if rule.kind == "gauge":
            if not samples:
                return None
            return _scalar_max(samples[-1][1], rule.metric, rule.labels)
        pair = self._window_pair(rule, samples, now)
        if pair is None:
            return None
        (t0, s0), (t1, s1) = pair
        dt = t1 - t0

        def rate(metric: str) -> Optional[float]:
            v1 = _scalar_sum(s1, metric, rule.labels)
            if v1 is None:
                return None
            v0 = _scalar_sum(s0, metric, rule.labels)
            v0 = 0.0 if v0 is None else v0
            if v1 < v0:  # counter reset (registry swap): no safe delta
                return None
            return (v1 - v0) / dt

        if rule.kind == "counter_rate":
            return rate(rule.metric)
        if rule.kind in ("ratio", "burn_rate"):
            num = rate(rule.metric)
            dens = [rate(m) for m in rule.den]
            if num is None or any(d is None for d in dens):
                return None
            den = sum(dens)
            if den <= 0:
                return None
            value = num / den
            return value / rule.budget if rule.kind == "burn_rate" else value
        # quantile: bucket-count delta across the window
        h1 = _hist_state(s1, rule.metric, rule.labels)
        if h1 is None:
            return None
        h0 = _hist_state(s0, rule.metric, rule.labels)
        b0, c0 = h0 if h0 is not None else ([0] * len(h1[0]), 0)
        if len(b0) != len(h1[0]) or h1[1] < c0:
            return None  # bucket layout changed / reset
        dcounts = [a - b for a, b in zip(h1[0], b0)]
        reg = self._registry or telemetry_registry.default_registry()
        inst = reg.get(rule.metric)
        bounds = getattr(inst, "buckets", None)
        if bounds is None:
            return None
        return windowed_quantile(bounds, dcounts, h1[1] - c0, rule.q)

    def _advance(
        self, rule: AlertRule, value: Optional[float], now: float
    ) -> List[AlertEvent]:
        cond = value is not None and _OPS[rule.op](value, rule.threshold)
        events: List[AlertEvent] = []

        with self._lock:
            st = self._states[rule.name]
            st.value = value

            def goto(state: int) -> None:
                frm = st.state_name
                st.state = state
                st.last_change = now
                if state == STATE_PENDING:
                    st.pending_since = now
                elif state == STATE_FIRING:
                    st.firing_since = now
                elif state == STATE_RESOLVED:
                    st.resolved_at = now
                events.append(AlertEvent(
                    rule=rule.name, frm=frm, to=st.state_name, value=value,
                    threshold=rule.threshold, op=rule.op, t=now,
                    severity=rule.severity,
                ))

            if cond:
                if st.state in (STATE_INACTIVE, STATE_RESOLVED):
                    goto(STATE_PENDING)
                if (
                    st.state == STATE_PENDING
                    and now - st.pending_since >= rule.for_s
                ):
                    goto(STATE_FIRING)
            else:
                if st.state == STATE_FIRING:
                    goto(STATE_RESOLVED)
                elif st.state == STATE_PENDING:
                    # condition cleared before for_s elapsed: a flap,
                    # not a resolved incident
                    goto(STATE_INACTIVE)
                elif (
                    st.state == STATE_RESOLVED
                    and now - st.resolved_at >= rule.resolve_hold_s
                ):
                    goto(STATE_INACTIVE)
            state_now = st.state

        if self._tel is not None:
            self._tel["state"].labels(rule=rule.name).set(state_now)
            for ev in events:
                self._tel["transitions"].labels(
                    rule=rule.name, to=ev.to
                ).inc()
        return events

    # -- reads --

    def states(self) -> Dict[str, _RuleState]:
        with self._lock:
            return dict(self._states)

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(
                n for n, st in self._states.items()
                if st.state == STATE_FIRING
            )

    def events(self, n: int = 64) -> List[AlertEvent]:
        with self._lock:
            return list(self._events[-n:])

    def snapshot(self) -> dict:
        """JSON view for /debug/snapshot."""
        with self._lock:
            states = {
                name: {
                    "state": st.state,
                    "state_name": st.state_name,
                    "value": st.value,
                    "since": st.last_change,
                }
                for name, st in sorted(self._states.items())
            }
            events = [dataclasses.asdict(e) for e in self._events[-16:]]
        return {
            "rules": [dataclasses.asdict(r) for r in self.rules],
            "states": states,
            "recent_events": events,
        }

    # -- standalone timer (expose_cluster uses the aux loop instead) --

    def start(self, interval: float = 1.0) -> "AlertManager":
        if self._thread is not None:
            return self
        self.period_s = float(interval)
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.evaluate()
                except Exception:
                    pass  # never kill the evaluator thread

        self._thread = threading.Thread(
            target=loop, daemon=True, name="alert-evaluator"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None


# -- rule files (configs/alerts/*.json) --

_RULE_FIELDS = {f.name for f in dataclasses.fields(AlertRule)}


def load_rules(path: str) -> List[AlertRule]:
    """Parse a rule file: ``{"version": 1, "rules": [{...}, ...]}``;
    unknown keys are an error (a typo'd field must not silently relax a
    production rule)."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != 1:
        raise ValueError(f"{path}: unsupported rule-file version "
                         f"{doc.get('version')!r}")
    rules = []
    for entry in doc["rules"]:
        unknown = set(entry) - _RULE_FIELDS
        if unknown:
            raise ValueError(
                f"{path}: rule {entry.get('name', '?')!r} has unknown "
                f"fields {sorted(unknown)}"
            )
        rules.append(AlertRule(**entry))
    return rules


def default_rules_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))),
        "configs", "alerts", "default.json",
    )


def default_rules() -> List[AlertRule]:
    """The shipped production rule set (configs/alerts/default.json):
    serve p99 vs SLO, degraded-serve rate, admission shed burn rate,
    serve queue depth, recovery MTTR."""
    return load_rules(default_rules_path())
