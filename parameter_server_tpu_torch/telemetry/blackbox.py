"""Black-box flight recorder + alert-triggered diagnostic bundles.

Every observability plane built so far is either *streaming* (the JSONL
span sink — gone if nobody installed it) or *cumulative* (the metrics
registry — totals, no recent history). When an SLO alert fires or a
shard wedges, the question is always "what happened in the last few
seconds", and by the time a human attaches, that evidence is gone.
This module keeps it: a bounded in-memory ring of recent span events
plus periodic metrics-delta samples per node (the aircraft flight
recorder, :class:`FlightRecorder` — zero file IO, overhead measured
below the host noise floor by the in-record paired A/B), and a
*trigger plane* that snapshots everything into one self-contained
**diagnostic bundle** at the moment of an incident:

- alert ``pending→firing`` transitions (``AuxRuntime.set_alerts``),
- ``DegradedError`` raises on the serving path,
- a node declared dead by the RecoveryCoordinator (the drill's shard
  kill — the record attaches the bundle under ``blackbox``),
- a wedged executor ``wait`` timeout.

A bundle carries ring dumps from every node — fetched over the Van
message plane with staleness semantics for silent nodes
(``AuxRuntime.fetch_rings``) — the aggregated metrics snapshot, alert
states, executor pending/timestamps, the device-truth section, per-peer
clock offsets, the down-sampled **history hour** before the trigger
(telemetry/history.py — the installed ring exported at the coarsest
resolution covering 3600 s), and a Perfetto-ready ``trace`` (open
``bundle["trace"]`` at https://ui.perfetto.dev). It is served live at ``/debug/bundle``
(telemetry/exposition.py) and on demand via ``make bundle``.

Threading: the recorder is **lock-annotated** shared state (spans are
emitted from every pipeline thread — the stateless-or-feeder rule's
"or lock-annotated" arm); captures are rate-limited
(:func:`set_min_interval`) so a trigger storm costs one bundle, not
one per symptom, and :func:`trigger_bundle` never raises — diagnosis
must not take down the path it is diagnosing.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from . import registry as telemetry_registry
from . import spans as _spans

_LOG = logging.getLogger(__name__)

#: default ring capacity (span events per node); ~200 bytes/event in
#: practice, so the default ring tops out around half a megabyte
DEFAULT_CAPACITY = 2048
#: default metrics-delta sample capacity per node
DEFAULT_METRICS_CAPACITY = 64
#: default minimum seconds between auto-captured bundles
DEFAULT_MIN_INTERVAL_S = 30.0


def _tel():
    from .instruments import cached_blackbox_instruments

    return cached_blackbox_instruments()


def _bundle_tel():
    from .instruments import cached_bundle_instruments

    return cached_bundle_instruments()


class FlightRecorder:
    """Bounded in-memory ring of recent span events + metrics deltas.

    Appends come from every span-emitting thread (via :class:`TeeSink`)
    — one lock acquire + one deque append, no file IO ever. Eviction is
    the deque's ``maxlen``; :meth:`dump` snapshots under the lock so a
    capture never reads a torn ring.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        metrics_capacity: int = DEFAULT_METRICS_CAPACITY,
        node_id: Optional[str] = None,
    ):
        self.node_id = node_id or _spans.node_id()
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(  # guarded-by: _lock
            maxlen=self.capacity
        )
        self._events_total = 0  # guarded-by: _lock
        self._metrics: collections.deque = collections.deque(  # guarded-by: _lock
            maxlen=int(metrics_capacity)
        )
        self._metrics_total = 0  # guarded-by: _lock
        self._last_flat: Optional[Dict[str, float]] = None  # guarded-by: _lock
        self._published_events = 0  # guarded-by: _lock
        self._published_samples = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    # -- the hot path (TeeSink.emit) --

    def emit(self, event: Dict[str, Any]) -> None:
        """Absorb one span event (thread-safe; the steady-state cost
        the in-record A/B prices)."""
        with self._lock:
            self._ring.append(event)
            self._events_total += 1

    # -- metrics-delta sampling (periodic, NOT per event) --

    @staticmethod
    def _flatten(export: Dict[str, dict]) -> Dict[str, float]:
        """Registry export → flat ``name{labels}`` → cumulative value
        (counter values; histogram counts — the delta-able scalars)."""
        flat: Dict[str, float] = {}
        for name, decl in export.items():
            kind = decl.get("type")
            for s in decl.get("series", ()):
                labels = ",".join(
                    f"{k}={v}" for k, v in sorted(s.get("labels", {}).items())
                )
                key = f"{name}{{{labels}}}" if labels else name
                if kind == "counter":
                    flat[key] = float(s["value"])
                elif kind == "histogram":
                    flat[key + "_count"] = float(s["count"])
        return flat

    def sample_metrics(
        self,
        export: Optional[Dict[str, dict]] = None,
        reg=None,
        t: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Record one metrics-delta sample: counter/histogram-count
        increases since the previous sample (gauge churn is point-in-
        time noise the deltas would misrepresent; gauges live in the
        bundle's full metrics snapshot instead). Driven periodically —
        a report-timer cadence, never per event."""
        if export is None:
            export = (reg or telemetry_registry.default_registry()).export_state()
        flat = self._flatten(export)
        t = time.time() if t is None else t
        with self._lock:
            prev = self._last_flat or {}
            delta = {
                k: round(v - prev.get(k, 0.0), 6)
                for k, v in flat.items()
                if v > prev.get(k, 0.0)
            }
            self._last_flat = flat
            sample = {"t_wall": t, "delta": delta}
            self._metrics.append(sample)
            self._metrics_total += 1
        self._publish()
        return sample

    def _publish(self) -> None:
        """Push ring totals into the registry (ps_blackbox_*) — called
        from the periodic/sample/dump paths so the hot emit path never
        touches registry locks (the catalog documents the lazy
        cadence)."""
        tel = _tel()
        if tel is None:
            return
        with self._lock:
            ev_delta = self._events_total - self._published_events
            sm_delta = self._metrics_total - self._published_samples
            self._published_events = self._events_total
            self._published_samples = self._metrics_total
            ring_len = len(self._ring)
        if ev_delta > 0:
            tel["events"].inc(ev_delta)
        if sm_delta > 0:
            tel["samples"].inc(sm_delta)
        tel["ring_events"].set(ring_len)

    # -- reads --

    def dump(self) -> Dict[str, Any]:
        """A consistent snapshot of the ring — the per-node payload of
        a diagnostic bundle (plain dicts/lists/scalars, so it survives
        the restricted wire unpickler)."""
        with self._lock:
            events = list(self._ring)
            samples = list(self._metrics)
            total = self._events_total
        self._publish()
        return {
            "node": self.node_id,
            "t_dump": time.time(),
            "capacity": self.capacity,
            "events_total": total,
            "dropped": max(0, total - len(events)),
            "events": events,
            "metrics_samples": samples,
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._metrics.clear()
            self._last_flat = None


class TeeSink:
    """Span-sink tee: every event lands in the flight recorder AND the
    wrapped inner sink (when one exists). Installing the tee with no
    inner sink is the always-on black-box mode: spans are recorded,
    nothing is written to disk. ``path`` proxies the inner sink's so
    timeline readers (/debug/snapshot's tail) keep working."""

    def __init__(self, recorder: FlightRecorder, inner=None):
        self.recorder = recorder
        self.inner = inner

    @property
    def path(self) -> Optional[str]:
        return getattr(self.inner, "path", None)

    def emit(self, event: Dict[str, Any]) -> None:
        self.recorder.emit(event)
        if self.inner is not None:
            self.inner.emit(event)

    def close(self) -> None:
        if self.inner is not None:
            self.inner.close()


# -- process registry of recorders ----------------------------------------

_reg_lock = threading.Lock()
_recorders: Dict[str, FlightRecorder] = {}  # guarded by _reg_lock


def recorder(
    node_id: Optional[str] = None, create: bool = True
) -> Optional[FlightRecorder]:
    """The named node's recorder (default: this process's node id),
    created on first use unless ``create=False``."""
    nid = node_id or _spans.node_id()
    with _reg_lock:
        rec = _recorders.get(nid)
        if rec is None and create:
            rec = _recorders[nid] = FlightRecorder(node_id=nid)
        return rec


def recorders() -> Dict[str, FlightRecorder]:
    with _reg_lock:
        return dict(_recorders)


def drop_recorder(node_id: str) -> None:
    """Remove one node's recorder (a drill or test cleaning up its OWN
    per-node recorders without resetting the process trigger plane)."""
    with _reg_lock:
        _recorders.pop(node_id, None)


def installed_recorder() -> Optional[FlightRecorder]:
    """The recorder behind the installed span sink (when the sink is a
    :class:`TeeSink`), else None."""
    sink = _spans.get_sink()
    return sink.recorder if isinstance(sink, TeeSink) else None


def arm(
    rec: Optional[FlightRecorder] = None, node_id: Optional[str] = None
) -> FlightRecorder:
    """Install the flight recorder as a tee over the current span sink
    (idempotent: re-arming the same recorder is a no-op). Armed with no
    inner sink, the black box records with zero file IO."""
    rec = rec or recorder(node_id)
    cur = _spans.get_sink()
    if isinstance(cur, TeeSink) and cur.recorder is rec:
        return rec
    _spans.install_sink(TeeSink(rec, inner=cur))
    return rec


def disarm() -> None:
    """Remove the tee, restoring the inner sink (no-op when not armed)."""
    cur = _spans.get_sink()
    if isinstance(cur, TeeSink):
        _spans.install_sink(cur.inner)


def reset() -> None:
    """Test hermeticity: disarm, drop every recorder, clear bundles and
    the trigger rate limiter."""
    global _last_trigger_t, _min_interval_s
    disarm()
    with _reg_lock:
        _recorders.clear()
    with _trigger_lock:
        _bundles.clear()
        _last_trigger_t = None
        _min_interval_s = DEFAULT_MIN_INTERVAL_S


# -- diagnostic bundles ----------------------------------------------------


def _guarded(section_fn, errors: Dict[str, str], name: str):
    """One bundle section, captured best-effort: a broken source
    records its error string instead of killing the whole capture."""
    try:
        return section_fn()
    except Exception as e:  # noqa: BLE001 — diagnosis must degrade,
        # not fail: a bundle with one missing section beats no bundle
        errors[name] = f"{type(e).__name__}: {str(e)[:200]}"
        return None


def capture_bundle(
    trigger: str = "manual",
    detail: str = "",
    aux=None,
    rings: Optional[Dict[str, dict]] = None,
    stale: Optional[Dict[str, str]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Capture one self-contained diagnostic bundle right now.

    ``aux`` (an AuxRuntime) supplies the cluster context: ring dumps
    fetched from every node over the Van (``fetch_rings`` — staleness
    for silent nodes), the node-labeled metrics snapshot, alert states
    and clock offsets. Without it, the capture is process-local (the
    armed recorder + the default registry). ``rings`` overrides the
    ring source entirely; ``stale`` marks named nodes stale (a caller
    — the recovery coordinator — knows who just died even when the
    aggregator has not noticed yet). Every section is best-effort; a
    broken source records its error under ``section_errors``.
    """
    t0 = time.perf_counter()
    errors: Dict[str, str] = {}
    if rings is None:
        if aux is not None:
            rings = _guarded(lambda: aux.fetch_rings(), errors, "rings") or {}
        else:
            rings = {
                nid: rec.dump() for nid, rec in sorted(recorders().items())
            }
            inst = installed_recorder()
            if inst is not None and inst.node_id not in rings:
                rings[inst.node_id] = inst.dump()
    rings = dict(rings)
    for nid, reason in (stale or {}).items():
        rings[nid] = {"stale": True, "reason": reason}

    def _metrics():
        if aux is not None:
            return aux.cluster.snapshot()
        return telemetry_registry.default_registry().snapshot()

    def _alerts():
        mgr = getattr(aux, "alerts", None) if aux is not None else None
        return mgr.snapshot() if mgr is not None else None

    def _executors():
        from ..system.executor import live_executors

        return sorted(
            (ex.debug_state() for ex in live_executors()),
            key=lambda d: d["name"],
        )

    def _device():
        from . import device as device_mod

        return device_mod.snapshot()

    def _clock():
        return aux.clock.snapshot() if aux is not None else {}

    def _history():
        # the down-sampled hour before the trigger: the installed
        # process history ring (telemetry/history.py), folded once so
        # the open second lands in the capture. installed_store never
        # creates — a process without a history plane bundles None,
        # which is a disclosed absence, not an empty ring.
        from . import history as history_mod

        store = history_mod.installed_store()
        if store is None:
            return None
        store.fold(force=True)
        return store.export_ring(window_s=3600.0)

    def _trace():
        from . import timeline as timeline_mod

        events_by_node = {
            nid: d["events"]
            for nid, d in rings.items()
            if isinstance(d, dict) and d.get("events")
        }
        offsets = aux.clock.offsets() if aux is not None else {}
        merged = timeline_mod.merge_node_events(events_by_node, offsets)
        return timeline_mod.to_chrome_trace(merged)

    bundle: Dict[str, Any] = {
        "kind": "ps_diagnostic_bundle",
        "version": 1,
        "trigger": {"kind": trigger, "detail": detail, "t_wall": time.time()},
        "node_id": _spans.node_id(),
        "rings": rings,
        "metrics": _guarded(_metrics, errors, "metrics"),
        "alerts": _guarded(_alerts, errors, "alerts"),
        "executors": _guarded(_executors, errors, "executors"),
        "device": _guarded(_device, errors, "device"),
        "clock_offsets": _guarded(_clock, errors, "clock_offsets"),
        "history": _guarded(_history, errors, "history"),
        "trace": _guarded(_trace, errors, "trace"),
    }
    if extra:
        bundle["extra"] = extra
    if errors:
        bundle["section_errors"] = errors
    tel = _bundle_tel()
    if tel is not None:
        tel["captures"].labels(trigger=trigger).inc()
        tel["capture_seconds"].observe(time.perf_counter() - t0)
        tel["last_ring_nodes"].set(len(rings))
    return bundle


def summarize_bundle(bundle: Dict[str, Any]) -> Dict[str, Any]:
    """A record-embeddable digest of a bundle (the drill's ``blackbox``
    section): per-node ring event counts / staleness, alert states,
    trigger — everything an assertion needs without megabytes of
    events in a bench record."""
    rings = bundle.get("rings", {})
    nodes = {}
    for nid, d in sorted(rings.items()):
        if not isinstance(d, dict):
            continue
        if d.get("stale") or d.get("absent"):
            nodes[nid] = {
                "stale": bool(d.get("stale")),
                "absent": bool(d.get("absent")),
                "reason": d.get("reason", ""),
            }
        else:
            nodes[nid] = {
                "stale": False,
                "events": len(d.get("events", ())),
                "events_total": d.get("events_total", 0),
                "metrics_samples": len(d.get("metrics_samples", ())),
            }
    alerts = bundle.get("alerts") or {}
    states = {
        name: st.get("state_name")
        for name, st in (alerts.get("states") or {}).items()
    }
    hist = bundle.get("history") or {}
    return {
        "captured": True,
        "trigger": dict(bundle.get("trigger", {})),
        "nodes": nodes,
        "alert_states": states,
        "trace_events": len((bundle.get("trace") or {}).get(
            "traceEvents", ())),
        "history_series": int(hist.get("series", 0)),
        "history_window_s": hist.get("window_s"),
        "section_errors": bundle.get("section_errors", {}),
    }


# -- the trigger plane -----------------------------------------------------

_trigger_lock = threading.Lock()
# monotonic time of the last capture, or None before any — a None
# sentinel, NOT 0.0: monotonic() can legitimately be smaller than the
# rate-limit interval on a freshly booted host, which would suppress
# the very first capture
_last_trigger_t: Optional[float] = None  # guarded by _trigger_lock
_min_interval_s = DEFAULT_MIN_INTERVAL_S  # guarded by _trigger_lock
_bundles: collections.deque = collections.deque(maxlen=4)  # guarded by _trigger_lock


def set_min_interval(seconds: float) -> float:
    """Set the auto-capture rate limit; returns the previous value
    (tests and drills drop it to 0 to capture deterministically)."""
    global _min_interval_s
    with _trigger_lock:
        prev, _min_interval_s = _min_interval_s, float(seconds)
        return prev


def trigger_bundle(
    trigger: str,
    detail: str = "",
    aux=None,
    stale: Optional[Dict[str, str]] = None,
) -> Optional[Dict[str, Any]]:
    """Auto-capture entry point for the trigger plane (alert firing,
    DegradedError, node death, wedged wait). Rate-limited — a trigger
    storm captures once per interval, the rest count as suppressed —
    and NEVER raises: the capture is a side effect of a failure path
    that must stay on its original course. Returns the bundle, or None
    when suppressed/failed."""
    global _last_trigger_t
    try:
        with _trigger_lock:
            now = time.monotonic()
            if (
                _last_trigger_t is not None
                and now - _last_trigger_t < _min_interval_s
            ):
                tel = _bundle_tel()
                if tel is not None:
                    tel["suppressed"].inc()
                return None
            _last_trigger_t = now
        bundle = capture_bundle(
            trigger=trigger, detail=detail, aux=aux, stale=stale
        )
        with _trigger_lock:
            _bundles.append(bundle)
        return bundle
    except Exception:  # noqa: BLE001 — see docstring
        _LOG.exception("diagnostic bundle capture failed (%s)", trigger)
        return None


def last_bundle() -> Optional[Dict[str, Any]]:
    with _trigger_lock:
        return _bundles[-1] if _bundles else None


def bundles() -> List[Dict[str, Any]]:
    with _trigger_lock:
        return list(_bundles)


# -- in-record overhead A/B (the disarmed-overhead pattern) ----------------


def overhead_ab(reps: int = 5, n: int = 400) -> Dict[str, Any]:
    """Steady-state recorder overhead, measured the disarmed-
    overhead way: the SAME span-instrumented work stream (spans wrap
    real work, as they do in production — span density per unit work is
    what matters, not a bare span loop) with the ring armed (tee, no
    inner sink — the always-on black-box mode) vs no sink at all, both
    orders inside one rep so a monotone capacity drift on this flapping
    host cancels out of the paired ratio. The honest claim is the
    median ratio straddling the host's noise floor; because the stream
    ratio is hostage to seconds-scale capacity flaps, the absolute cost
    is ALSO priced as a tight-loop ``armed_ns_per_event`` a flap cannot
    fake. Zero file IO in both arms — asserted by the tee having no
    path."""
    rec = FlightRecorder(capacity=1024, node_id="ovh")
    tee = TeeSink(rec, inner=None)
    assert tee.path is None  # armed-but-idle: no file IO by construction
    sink_of = {"armed": tee, "off": None}

    def stream() -> float:
        # ~50-100µs of real work per span — the production span density
        # (a span wraps a prep stage or an executor step, never nothing)
        acc = 0.0
        for i in range(n):
            with _spans.span("bb.ovh"):
                for j in range(1500):
                    acc += j * 1e-9
        return acc

    def timed(arm: str) -> float:
        _spans.install_sink(sink_of[arm])
        t0 = time.perf_counter()
        stream()
        return time.perf_counter() - t0

    prev = _spans.install_sink(None)
    try:
        timed("armed")  # warm both shapes
        timed("off")
        ratios = []
        for _ in range(reps):
            # both orders inside one rep: armed, off, off, armed
            a1 = timed("armed")
            o = (timed("off") + timed("off")) / 2
            a2 = timed("armed")
            ratios.append(((a1 + a2) / 2) / max(o, 1e-9))
        # tight-loop absolute: empty spans, armed — the pure per-event
        # recorder cost (dict build + tee emit + ring append)
        _spans.install_sink(tee)
        m = 20_000
        t0 = time.perf_counter()
        for _ in range(m):
            with _spans.span("bb.tight"):
                pass
        armed_ns = (time.perf_counter() - t0) / m * 1e9
        _spans.install_sink(None)
        t0 = time.perf_counter()
        for _ in range(m):
            with _spans.span("bb.tight"):
                pass
        off_ns = (time.perf_counter() - t0) / m * 1e9
    finally:
        _spans.install_sink(prev)
    ratios.sort()
    return {
        "reps": reps,
        "spans_per_rep": n,
        "ratio_median": round(ratios[len(ratios) // 2], 3),
        "armed_ns_per_event": round(armed_ns, 1),
        "disarmed_ns_per_event": round(off_ns, 1),
        "added_ns_per_event": round(armed_ns - off_ns, 1),
        "file_io": False,
    }
