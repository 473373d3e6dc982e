"""Critical-path attribution over a merged span timeline.

Answers the ROADMAP's standing question — *which resource binds this
run?* — from the trace itself instead of hand-computed breakdowns (the
BENCH_r05 "75% upload-bound at 107.4 B/ex" arithmetic). Every span in
a timeline maps to one of eight categories:

    host_prep       parse/localize/remap/stack on host CPU
    encode          compact-wire encode (learner/wire.py, prep pool)
    upload          host→device staging (the tunnel/link wire time)
    network         host-wire frames between nodes (Van.transfer — the
                    control-plane/metric-report wire legs; distinct
                    from ``upload``, the host→device link)
    queue_wait      time a unit sat waiting — executor queue, serve
                    admission queue, pipeline hand-off gaps
    device_compute  executor run + materialize (XLA step + forcing)
    decode          served LM generation (the speculative lane)
    reply           completion hand-back to the waiting client

Two complementary views are computed:

- **resource view** (:func:`summarize`): busy seconds per category over
  a wall-clock window → per-resource *utilization* (busy/wall) and
  *shares* (busy/Σ stage busy). The binding resource is the stage
  category with the most busy time; at high pipeline efficiency its
  utilization approaches 1.0 — the pipeline is that resource.
- **flow view** (:func:`attribute_flows`): per flow id (one batch /
  launch / request), the spans ordered in time form the unit's
  critical path; gaps between consecutive spans are queue-wait. The
  median per-category share across flows says where a *typical* step
  or request spends its life — queueing is visible here even when
  every resource looks idle.

``executor.step`` events (system/executor.py) are expanded into their
three phases (queue-wait / run / materialize) before analysis, so the
logical-clock spans the executor already emits join the same timeline without
the executor knowing about categories.

`bench.py` embeds :func:`summarize`'s output as the ``attribution``
section of every record (doc/PERFORMANCE.md names it the required
evidence format for perf claims); ``script/bench_diff.py`` guards the
resulting trajectory against silent regression.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .timeline import _start_end, events_window, flows

CATEGORIES = (
    "host_prep",
    "encode",
    "upload",
    "network",
    "queue_wait",
    "device_compute",
    "decode",
    "reply",
)

#: categories that are physical resources a pipeline can saturate (the
#: binding resource is named among these; queue_wait/reply are symptoms)
RESOURCE_CATEGORIES = (
    "host_prep", "encode", "upload", "network", "device_compute", "decode",
)

#: device-track events (utils/profiling.device_track_events — a merged
#: torch.profiler capture) are named ``device.<op>`` on ``device:<pid>``
#: threads. They are deliberately OUTSIDE the category map: their wall
#: time is already billed to device_compute through the executor
#: run/materialize phases, so categorizing them would double-count.
#: Instead :func:`device_breakdown` turns them into the per-kernel
#: sub-breakdown of device_compute that :func:`summarize` attaches as
#: ``device_compute_breakdown`` whenever a device track is present.
DEVICE_TRACK_PREFIX = "device."

#: span-name prefix → category. Longest prefix wins; names outside the
#: map contribute to the timeline but not to attribution.
NAME_CATEGORIES: Dict[str, str] = {
    "bench.prep": "host_prep",
    "bench.stack": "host_prep",
    "bench.device": "device_compute",
    "bench.upload": "upload",
    "ingest.read": "host_prep",
    "ingest.filter": "host_prep",
    "ingest.prep": "host_prep",
    "ingest.upload": "upload",
    "wire.encode": "encode",
    "van.transfer": "network",
    "executor.queue_wait": "queue_wait",
    "executor.run": "device_compute",
    "executor.materialize": "device_compute",
    # serve.coalesce.flush is deliberately ABSENT: the flush span wraps
    # the union merge + store pull whose real work is already attributed
    # through the flush flow's own executor.step expansion — mapping the
    # wrapper would bill the same interval twice
    "serve.decode": "decode",
    "serve.execute": "host_prep",  # predict lane: host gather math
    "serve.reply": "reply",
}


def categorize(name: str) -> Optional[str]:
    if name.startswith(DEVICE_TRACK_PREFIX):
        return None  # device track: handled by device_breakdown
    best: Optional[str] = None
    best_len = -1
    for prefix, cat in NAME_CATEGORIES.items():
        if name.startswith(prefix) and len(prefix) > best_len:
            best, best_len = cat, len(prefix)
    return best


def is_device_event(ev: Dict[str, Any]) -> bool:
    """True for merged device-track spans (``device.<op>`` names on a
    ``device:<pid>`` thread)."""
    return str(ev.get("name", "")).startswith(DEVICE_TRACK_PREFIX) or str(
        ev.get("thread", "")
    ).startswith("device:")


def categorize_event(ev: Dict[str, Any]) -> Optional[str]:
    """Category of one span event. Name-prefix lookup, with one
    event-aware override: a ``serve.execute`` span whose ``req`` is a
    pull spends its life blocked on the shared read machinery (replica
    miss → coalescer window deadline → store round trip inside
    PullTicket.result), so it is queue-wait from the request's point of
    view — the store-side work itself is attributed by the flush flow's
    executor.step expansion. Predict execution (host gather + margin
    math on the worker thread) stays host_prep."""
    name = str(ev.get("name", ""))
    if name == "serve.execute" and ev.get("req") == "pull":
        return "queue_wait"
    return categorize(name)


def expand_executor_steps(
    events: Iterable[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Replace each ``executor.step`` event with three phase spans
    (queue-wait → run → materialize) laid back from its finish time —
    the event's ``t_wall`` is stamped when the step finishes and
    ``total_s`` spans submit→finish, so the phases tile the interval
    in order. Other events pass through unchanged."""
    out: List[Dict[str, Any]] = []
    for ev in events:
        if ev.get("name") != "executor.step":
            out.append(ev)
            continue
        t_end = float(ev.get("t_wall", 0.0))
        total = float(ev.get("total_s", 0.0))
        qw = float(ev.get("queue_wait_s", 0.0))
        run_s = float(ev.get("run_s", 0.0))
        mat_s = float(ev.get("materialize_s", 0.0))
        t0 = t_end - total
        carry = {
            k: ev[k] for k in ("ts", "flow", "executor", "thread") if k in ev
        }
        phases = (
            ("executor.queue_wait", t0, qw),
            ("executor.run", t0 + qw, run_s),
            ("executor.materialize", t0 + qw + run_s, mat_s),
        )
        for name, start, dur in phases:
            if dur <= 0.0:
                continue
            out.append(
                {
                    "kind": "span",
                    "name": name,
                    "t_wall": start,
                    "dur_s": dur,
                    **carry,
                }
            )
    return out


def _clip(start: float, dur: float, window: Optional[Tuple[float, float]]) -> float:
    if window is None:
        return max(0.0, dur)
    lo, hi = window
    return max(0.0, min(start + dur, hi) - max(start, lo))


def _start_end_dur(ev: Dict[str, Any]) -> Tuple[float, float]:
    """(start, duration) of one span event — the _clip calling shape."""
    s, e = _start_end(ev)
    return s, e - s


def _merge_intervals(
    intervals: List[Tuple[float, float]],
) -> List[Tuple[float, float]]:
    intervals.sort()
    merged: List[Tuple[float, float]] = []
    for lo, hi in intervals:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def busy_by_category(
    events: Sequence[Dict[str, Any]],
    window: Optional[Tuple[float, float]] = None,
) -> Dict[str, float]:
    """Busy seconds per category (span durations, clipped to ``window``).
    Busy time is summed per category even when spans overlap across
    threads — each category models one resource (the host cores, the
    wire, the chip), and parallel spans of one category mean that
    resource is multiply subscribed, which utilization should show.

    The one exception is nesting ACROSS categories on one thread:
    ``wire.encode`` runs inside the prep call (worker.prep →
    encode_exact), so its interval sits inside a ``bench.prep`` /
    ``ingest.prep`` span on the same thread — and a ``van.transfer``
    runs inside the RPC step body the executor dispatched, so its
    interval sits inside that step's ``executor.run`` phase. Those
    seconds belong to the nested (encode / network) resource alone —
    they are carved out of the ENCLOSING span's category so one CPU
    second is never billed to two stages."""
    expanded = [
        ev for ev in expand_executor_steps(events) if not ev.get("abandoned")
    ]
    # intervals of the carve categories, per thread: encode nests in
    # host_prep wrappers, network (van.transfer) nests in the
    # executor.run phase of the RPC step that sent it
    carve_cats = ("encode", "network")
    carve_by_thread: Dict[Any, List[Tuple[float, float]]] = {}
    for ev in expanded:
        if categorize_event(ev) in carve_cats:
            s = float(ev.get("t_wall", 0.0))
            carve_by_thread.setdefault(ev.get("thread"), []).append(
                (s, s + float(ev.get("dur_s", 0.0)))
            )
    carve_by_thread = {
        t: _merge_intervals(iv) for t, iv in carve_by_thread.items()
    }
    busy = {cat: 0.0 for cat in CATEGORIES}
    for ev in expanded:
        cat = categorize_event(ev)
        if cat is None:
            continue
        s = float(ev.get("t_wall", 0.0))
        d = float(ev.get("dur_s", 0.0))
        sec = _clip(s, d, window)
        if cat not in carve_cats:
            for lo, hi in carve_by_thread.get(ev.get("thread"), ()):
                ov_lo, ov_hi = max(lo, s), min(hi, s + d)
                if ov_hi > ov_lo:
                    sec -= _clip(ov_lo, ov_hi - ov_lo, window)
        busy[cat] += max(0.0, sec)
    return busy


def _span_self_times(spans: List[Dict[str, Any]]):
    """Yield ``(event, self_s)`` per span of ONE track: duration minus
    time covered by child spans nested inside it (same stack pass as
    utils/profiling._self_times, over span dicts) — a ``while``/
    ``fusion`` wrapper is credited only the time its body ops leave."""
    evs = sorted(
        spans,
        key=lambda e: (
            float(e.get("t_wall", 0.0)), -float(e.get("dur_s", 0.0) or 0.0)
        ),
    )
    stack: List[list] = []  # [event, end_t, child_s]
    for ev in evs:
        t0 = float(ev.get("t_wall", 0.0))
        dur = float(ev.get("dur_s", 0.0) or 0.0)
        while stack and t0 >= stack[-1][1]:
            top, _, child = stack.pop()
            yield top, float(top.get("dur_s", 0.0) or 0.0) - child
        if stack:
            stack[-1][2] += dur
        stack.append([ev, t0 + dur, 0.0])
    while stack:
        top, _, child = stack.pop()
        yield top, float(top.get("dur_s", 0.0) or 0.0) - child


def device_breakdown(
    events: Sequence[Dict[str, Any]],
    window: Optional[Tuple[float, float]] = None,
    top: int = 8,
) -> Optional[Dict[str, Any]]:
    """Per-kernel sub-breakdown of device_compute from a merged device
    track, or None when the trace carries no device events.

    Busy time is per-kernel SELF time (nesting carved out, per device
    thread); ``gap_s`` is the device wall window minus the union of op
    intervals — a kernel-dominated capture shows ``busy_frac`` near
    1.0, a dispatch-bound one shows the gaps the ROADMAP's "where do
    the other 96% go" question is about. ``shares`` normalize over
    total device busy time (the device_compute analog of the resource
    view's ``shares``)."""
    dev = [
        ev for ev in events
        if is_device_event(ev) and not ev.get("abandoned")
    ]
    if not dev:
        return None
    if window is None:
        window = events_window(dev)
    wall = max(0.0, window[1] - window[0])
    by_thread: Dict[Any, List[Dict[str, Any]]] = {}
    for ev in dev:
        by_thread.setdefault(ev.get("thread"), []).append(ev)
    per_kernel: Dict[str, List[float]] = {}
    intervals: List[Tuple[float, float]] = []
    busy_total = 0.0
    for track in by_thread.values():
        for ev in track:
            s = float(ev.get("t_wall", 0.0))
            d = float(ev.get("dur_s", 0.0) or 0.0)
            lo, hi = max(s, window[0]), min(s + d, window[1])
            if hi > lo:
                intervals.append((lo, hi))
        for ev, self_s in _span_self_times(track):
            sec = min(self_s, _clip(
                float(ev.get("t_wall", 0.0)), float(ev.get("dur_s", 0.0) or 0.0),
                window,
            ))
            if sec <= 0.0:
                continue
            name = str(ev.get("name", "?"))
            if name.startswith(DEVICE_TRACK_PREFIX):
                name = name[len(DEVICE_TRACK_PREFIX):]
            rec = per_kernel.setdefault(name, [0.0, 0])
            rec[0] += sec
            rec[1] += 1
            busy_total += sec
    covered = sum(hi - lo for lo, hi in _merge_intervals(intervals))
    out: Dict[str, Any] = {
        "device_busy_s": round(busy_total, 6),
        "wall_s": round(wall, 6),
        "gap_s": round(max(0.0, wall - covered), 6),
        "busy_frac": round(covered / wall, 4) if wall > 0 else None,
        "tracks": len(by_thread),
    }
    if busy_total > 0:
        ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
        out["kernels"] = [
            {
                "name": k,
                "ms": round(v[0] * 1e3, 4),
                "calls": v[1],
                "share": round(v[0] / busy_total, 4),
            }
            for k, v in ranked[:top]
        ]
    return out


def flow_critical_path(seq: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """One flow's path through the pipeline: spans in time order, gaps
    between consecutive spans charged to queue-wait (a gap immediately
    before a ``reply`` span is charged to reply — the hand-back leg).
    Returns ``{"total_s", "by_category": {...}}``."""
    spans = [
        ev
        for ev in expand_executor_steps(seq)
        if not ev.get("abandoned")
    ]
    spans.sort(key=lambda e: float(e.get("t_wall", 0.0)))
    by_cat = {cat: 0.0 for cat in CATEGORIES}
    cursor: Optional[float] = None
    first = last = None
    for ev in spans:
        start = float(ev.get("t_wall", 0.0))
        dur = float(ev.get("dur_s", 0.0))
        cat = categorize_event(ev)
        if first is None:
            first = start
        if cursor is not None and start > cursor:
            gap_cat = "reply" if cat == "reply" else "queue_wait"
            by_cat[gap_cat] += start - cursor
        if cat is not None:
            # only the portion past the cursor extends the critical
            # path — overlapped work (pipelining) is not path time
            base = start if cursor is None else max(start, cursor)
            by_cat[cat] += max(0.0, start + dur - base)
        cursor = start + dur if cursor is None else max(cursor, start + dur)
        last = cursor
    total = (last - first) if (first is not None and last is not None) else 0.0
    return {"total_s": total, "by_category": by_cat}


def attribute_flows(
    events: Sequence[Dict[str, Any]],
    window: Optional[Tuple[float, float]] = None,
) -> Dict[str, Any]:
    """Median per-category critical-path share across every flow in the
    trace, plus the dominant category — where a typical unit of work
    spends its life (queue-wait included, unlike the resource view).
    With ``window``, only flows with at least one span intersecting it
    are counted (each qualifying flow's path is measured whole — a flow
    straddling the boundary is not truncated); warmup or serialized
    breakdown-phase flows outside the measured window stay out of the
    median."""
    by_flow = flows(events)
    shares: Dict[str, List[float]] = {cat: [] for cat in CATEGORIES}
    totals: List[float] = []
    for seq in by_flow.values():
        if window is not None and not any(
            _clip(s, e - s, window) > 0.0 or window[0] <= s <= window[1]
            for s, e in (_start_end(ev) for ev in seq)
        ):
            continue
        cp = flow_critical_path(seq)
        if cp["total_s"] <= 0.0:
            continue
        if sum(cp["by_category"].values()) <= 0.0:
            # a flow with NO attributable path time says nothing about
            # where a unit spends its life — e.g. a coalescer flush
            # flow, whose only duration-bearing span is the deliberately
            # uncategorized serve.coalesce.flush wrapper (the executor
            # phases nest inside it and extend the path by ~nothing);
            # letting it in would dilute every category's share list
            # with zeros and inflate count with non-request units
            continue
        totals.append(cp["total_s"])
        for cat in CATEGORIES:
            shares[cat].append(cp["by_category"][cat] / cp["total_s"])
    if not totals:
        return {"count": 0}
    med = {
        cat: round(statistics.median(vals), 4)
        for cat, vals in shares.items()
        if vals and statistics.median(vals) > 0.0
    }
    dominant = max(med, key=med.get) if med else None
    return {
        "count": len(totals),
        "median_total_s": round(statistics.median(totals), 6),
        "critical_path_shares": med,
        "dominant": dominant,
    }


def summarize(
    events: Sequence[Dict[str, Any]],
    window: Optional[Tuple[float, float]] = None,
) -> Dict[str, Any]:
    """The record-embeddable attribution section.

    ``shares`` normalizes stage busy time over the resource categories
    (comparable to the old hand-derived ``breakdown_fracs``);
    ``utilization`` divides by the wall window (1.0 = that resource ran
    the whole time — it IS the pipeline); ``binding_resource`` names
    the stage category with the most busy time and quotes its
    utilization. The per-flow critical-path view rides along under
    ``flows``.
    """
    # expand once up front: re-expansion downstream (busy_by_category,
    # flow_critical_path) passes already-expanded phase spans through
    # unchanged, so the O(events) rebuild happens a single time
    events = expand_executor_steps(events)
    if window is None:
        window = events_window(events)
    wall = max(0.0, window[1] - window[0])
    busy = busy_by_category(events, window)
    stage_busy = {cat: busy[cat] for cat in RESOURCE_CATEGORIES}
    stage_total = sum(stage_busy.values())
    abandoned = sum(1 for ev in events if ev.get("abandoned"))
    out: Dict[str, Any] = {
        "wall_s": round(wall, 6),
        "busy_s": {
            cat: round(sec, 6) for cat, sec in busy.items() if sec > 0.0
        },
        "queue_wait_s": round(busy["queue_wait"], 6),
        "abandoned_spans": abandoned,
        "flows": attribute_flows(events, window),
    }
    # the per-kernel view of where device_compute itself goes — present
    # only when a profiler capture's device track was merged into this
    # timeline; records without one are unchanged. Gap accounting runs
    # over the device TRACK's own extent (a capture covers one launch,
    # not the whole bench window — clipping to `window` would charge
    # every non-captured second as device gap).
    dev_events = [
        ev for ev in events
        if is_device_event(ev)
        and (window is None or _clip(*_start_end_dur(ev), window) > 0.0)
    ]
    dev = device_breakdown(dev_events) if dev_events else None
    if dev is not None:
        out["device_compute_breakdown"] = dev
    if stage_total > 0.0:
        out["shares"] = {
            cat: round(sec / stage_total, 4)
            for cat, sec in stage_busy.items()
            if sec > 0.0
        }
        binding = max(stage_busy, key=stage_busy.get)
        out["binding_resource"] = binding
        if wall > 0.0:
            out["utilization"] = {
                cat: round(sec / wall, 4)
                for cat, sec in stage_busy.items()
                if sec > 0.0
            }
            out["binding_utilization"] = round(stage_busy[binding] / wall, 4)
    return out


def summarize_trace(
    jsonl_path: str, window: Optional[Tuple[float, float]] = None
) -> Dict[str, Any]:
    """:func:`summarize` over a JSONL trace file."""
    from .timeline import load_events

    return summarize(load_events(jsonl_path), window)
