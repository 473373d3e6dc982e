"""Merged cross-thread timeline: JSONL span events → Perfetto-openable
Chrome trace JSON with flow arrows.

The span sink (:mod:`telemetry.spans`) appends flat per-thread events;
the training and serving pipeline is a multi-thread dataflow (feeder →
countmin filter → prep pool → DeviceUploader → trainer step → executor
run; serve submit → admission → coalescer flush → executor → reply)
whose bottleneck shifts per run. This module turns the flat stream into
a *timeline*: per-thread tracks, flow arrows stitching each batch or
request across threads (the ``flow`` ids :func:`spans.new_flow`
allocates), and the input of the critical-path analyzer
(:mod:`telemetry.attribution`).

Export format is the Chrome trace-event JSON array form — open it at
https://ui.perfetto.dev (or chrome://tracing): each span becomes one
``"ph": "X"`` complete event on its thread's track, consecutive spans
of the same flow on *different* threads are joined by ``"s"``/``"f"``
flow arrows, and ``abandoned`` terminators render as zero-duration
instant events so a worker-exception tombstone is visible exactly where
the batch died. ``doc/OBSERVABILITY.md`` ("Reading a timeline") walks
a rendered example.

Runs on the card can interleave device-side context: wrap launches in
:func:`device_annotation` and capture a ``torch.profiler`` trace beside
the host timeline (the CLIs' ``--profile``); the annotation names show
up in the capture around the launches, keyed by the same step names.
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from . import spans as _spans

# re-exported so call sites can treat timeline as the one flow API
new_flow = _spans.new_flow
flow_scope = _spans.flow_scope
current_flow = _spans.current_flow


def load_events(path: str) -> List[Dict[str, Any]]:
    """Read a JSONL span trace, skipping half-written trailing lines
    (a killed run must still be analyzable)."""
    events: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if isinstance(ev, dict):
                events.append(ev)
    return events


def _start_end(ev: Dict[str, Any]) -> Tuple[float, float]:
    t0 = float(ev.get("t_wall", 0.0))
    dur = ev.get("dur_s")
    if dur is None and "total_s" in ev:
        # executor.step stamps t_wall at FINISH and total_s spans
        # submit→finish (system/executor.py) — render the full interval
        # so the step is a box, not a zero-width sliver at its end
        return t0 - float(ev["total_s"]), t0
    return t0, t0 + float(dur or 0.0)


def events_window(events: Iterable[Dict[str, Any]]) -> Tuple[float, float]:
    """(earliest start, latest end) wall time across ``events``."""
    starts, ends = [], []
    for ev in events:
        s, e = _start_end(ev)
        starts.append(s)
        ends.append(e)
    if not starts:
        return 0.0, 0.0
    return min(starts), max(ends)


def flows(events: Iterable[Dict[str, Any]]) -> Dict[int, List[Dict[str, Any]]]:
    """Events grouped by flow id, each group sorted by start time.
    Events without a flow are omitted (they still render on their
    thread track; they just draw no arrows)."""
    out: Dict[int, List[Dict[str, Any]]] = {}
    for ev in events:
        fid = ev.get("flow")
        if fid is None:
            continue
        out.setdefault(int(fid), []).append(ev)
    for seq in out.values():
        seq.sort(key=lambda e: _start_end(e)[0])
    return out


def merge_node_events(
    events_by_node: Dict[str, Sequence[Dict[str, Any]]],
    offsets: Optional[Dict[str, float]] = None,
) -> List[Dict[str, Any]]:
    """Merge several nodes' span streams into ONE timeline.

    Three things make per-node streams unmergeable raw, and this fixes
    each: (1) wall clocks differ across hosts — ``offsets[node]``
    (seconds to ADD to that node's clock, the
    ``system/heartbeat.ClockSync`` convention) aligns every event onto
    the caller's clock; (2) thread names collide ("MainThread" on every
    node) — threads are tagged ``node/thread`` and the event gains a
    ``node`` field (the Chrome export renders one process track per
    node); (3) flow ids are per-process counters, so two nodes' local
    flow 7 are different units — flows are renumbered by
    ``(origin node, id)``, where the origin is the event's
    ``flow_node`` (a flow that crossed the Van keeps its origin, which
    is exactly how the sending span and the receiving executor land on
    the SAME merged flow and draw the cross-node arrow).

    Inputs are unmodified; returns a new time-sorted list.
    """
    offsets = offsets or {}
    flow_map: Dict[Tuple[str, int], int] = {}

    def global_flow(origin: str, fid: Any) -> int:
        key = (origin, int(fid))
        if key not in flow_map:
            flow_map[key] = len(flow_map) + 1
        return flow_map[key]

    merged: List[Dict[str, Any]] = []
    for node in sorted(events_by_node):
        off = float(offsets.get(node, 0.0))
        for ev in events_by_node[node]:
            ev = dict(ev)
            ev["node"] = node
            if "t_wall" in ev:
                ev["t_wall"] = float(ev["t_wall"]) + off
            ev["thread"] = f"{node}/{ev.get('thread', '?')}"
            origin = str(ev.pop("flow_node", None) or node)
            if ev.get("flow") is not None:
                ev["flow"] = global_flow(origin, ev["flow"])
            if isinstance(ev.get("flows"), (list, tuple)):
                ev["flows"] = [
                    global_flow(origin, f) for f in ev["flows"]
                ]
            merged.append(ev)
    merged.sort(key=lambda e: _start_end(e)[0])
    return merged


def merge_node_sinks(
    node_paths: Dict[str, str],
    offsets: Optional[Dict[str, float]] = None,
) -> List[Dict[str, Any]]:
    """:func:`merge_node_events` over per-node JSONL sink files."""
    return merge_node_events(
        {node: load_events(path) for node, path in node_paths.items()},
        offsets,
    )


def merge_device_track(
    host_events: Sequence[Dict[str, Any]],
    device_events: Sequence[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Merge a profiler-derived device track
    (utils/profiling.device_track_events) into a host span timeline.

    Each device span inherits the flow id of the ``executor.step`` span
    whose submit→finish interval contains its midpoint — the submitting
    step — so the Chrome export draws flow arrows from the host step
    phases onto the device ops they launched, and the attribution
    reader can group device time per unit of work. Device spans whose
    midpoint lands in no step (profiler warmup, gaps) merge without a
    flow: they still render on the ``device:<pid>`` track, they just
    draw no arrows. Returns a new time-sorted list; inputs unmodified.
    """
    steps: List[Tuple[float, float, int]] = []
    for ev in host_events:
        if ev.get("name") == "executor.step" and ev.get("flow") is not None:
            s, e = _start_end(ev)
            steps.append((s, e, int(ev["flow"])))
    steps.sort()
    out = list(host_events)
    for ev in device_events:
        ev = dict(ev)
        mid = float(ev.get("t_wall", 0.0)) + float(ev.get("dur_s", 0.0)) / 2.0
        for s, e, fid in steps:
            if s <= mid <= e:
                ev["flow"] = fid
                break
        out.append(ev)
    out.sort(key=lambda e: _start_end(e)[0])
    return out


def to_chrome_trace(
    events: Sequence[Dict[str, Any]],
    *,
    pid: int = 1,
    process_name: str = "parameter_server_tpu",
) -> Dict[str, Any]:
    """Render span events as a Chrome trace-event JSON object.

    Deterministic for a given event list: thread track ids are assigned
    in first-appearance order, timestamps are microseconds relative to
    the earliest event (Perfetto prefers small offsets over epoch
    micros). Flow arrows connect consecutive spans of one flow id
    across thread boundaries; a coalescer flush span that carries a
    ``flows`` list additionally receives one arrow from each merged
    request's preceding span (fan-in). ``abandoned`` events render as
    instant (``"ph": "i"``) tombstones.

    Node-tagged events (:func:`merge_node_events` sets ``ev["node"]``)
    render as one Perfetto *process* per node (``process_name:
    <name>:<node>``) — single-node traces keep the legacy single-pid
    shape bit-for-bit. Flow arrows cross process tracks the same way
    they cross threads, which is how a flow's Van hop draws as an arrow
    from the sending node's span to the receiving node's executor step.
    """
    t_base, _ = events_window(events)
    pids: Dict[Any, int] = {}
    tids: Dict[str, Tuple[int, int]] = {}  # thread -> (pid, tid)
    trace: List[Dict[str, Any]] = []

    def pid_of(node) -> int:
        if node not in pids:
            pids[node] = pid + len(pids)
            name = process_name if node is None else f"{process_name}:{node}"
            trace.append(
                {
                    "ph": "M",
                    "pid": pids[node],
                    "tid": 0,
                    "name": "process_name",
                    "args": {"name": name},
                }
            )
        return pids[node]

    def track_of(ev: Dict[str, Any]) -> Tuple[int, int]:
        thread = str(ev.get("thread", "?"))
        if thread not in tids:
            p = pid_of(ev.get("node"))
            tids[thread] = (p, len(tids) + 1)
            trace.append(
                {
                    "ph": "M",
                    "pid": p,
                    "tid": tids[thread][1],
                    "name": "thread_name",
                    "args": {"name": thread},
                }
            )
        return tids[thread]

    def us(t_wall: float) -> float:
        return round((t_wall - t_base) * 1e6, 3)

    meta_keys = ("kind", "name", "t_wall", "dur_s", "thread")
    for ev in events:
        epid, tid = track_of(ev)
        start, end = _start_end(ev)
        args = {k: v for k, v in ev.items() if k not in meta_keys}
        if ev.get("abandoned"):
            trace.append(
                {
                    "ph": "i",
                    "pid": epid,
                    "tid": tid,
                    "name": str(ev.get("name", "span")) + " (abandoned)",
                    "ts": us(start),
                    "s": "t",  # thread-scoped instant marker
                    "args": args,
                }
            )
            continue
        trace.append(
            {
                "ph": "X",
                "pid": epid,
                "tid": tid,
                "name": str(ev.get("name", "span")),
                "ts": us(start),
                "dur": round((end - start) * 1e6, 3),
                "args": args,
            }
        )

    # flow arrows: consecutive spans of one flow id on different threads
    arrows: List[Dict[str, Any]] = []
    by_flow = flows(events)
    for fid, seq in sorted(by_flow.items()):
        for prev, nxt in zip(seq, seq[1:]):
            if prev.get("thread") == nxt.get("thread"):
                continue  # same track: adjacency already reads left-to-right
            _, prev_end = _start_end(prev)
            nxt_start, _ = _start_end(nxt)
            s_pid, s_tid = track_of(prev)
            f_pid, f_tid = track_of(nxt)
            arrows.append(
                {
                    "ph": "s",
                    "pid": s_pid,
                    "tid": s_tid,
                    "name": "flow",
                    "cat": "flow",
                    "id": fid,
                    "ts": us(prev_end),
                }
            )
            arrows.append(
                {
                    "ph": "f",
                    "bp": "e",
                    "pid": f_pid,
                    "tid": f_tid,
                    "name": "flow",
                    "cat": "flow",
                    "id": fid,
                    "ts": us(max(nxt_start, prev_end)),
                }
            )
    # fan-in arrows: a flush/merge span naming the flows it absorbed
    for ev in events:
        merged = ev.get("flows")
        if not isinstance(merged, (list, tuple)) or ev.get("flow") is None:
            continue
        start, _ = _start_end(ev)
        e_pid, e_tid = track_of(ev)
        for fid in merged:
            seq = by_flow.get(int(fid))
            if not seq:
                continue
            # the arrow originates from the merged request's span
            # PRECEDING the flush — not the flow's last span overall,
            # which (serve.reply) can postdate the flush and would draw
            # backwards causality. Clamp the origin into the preceding
            # span's interval when it is still open at flush start.
            preceding = [e for e in seq if _start_end(e)[0] <= start]
            if not preceding:
                continue
            prev = preceding[-1]
            _, prev_end = _start_end(prev)
            s_pid, s_tid = track_of(prev)
            arrows.append(
                {
                    "ph": "s",
                    "pid": s_pid,
                    "tid": s_tid,
                    "name": "flow",
                    "cat": "flow",
                    "id": int(fid),
                    "ts": us(min(prev_end, start)),
                }
            )
            arrows.append(
                {
                    "ph": "f",
                    "bp": "e",
                    "pid": e_pid,
                    "tid": e_tid,
                    "name": "flow",
                    "cat": "flow",
                    "id": int(fid),
                    "ts": us(start),
                }
            )
    trace.extend(arrows)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def export_chrome_trace(
    jsonl_path: str, out_path: str, **kwargs
) -> Dict[str, Any]:
    """Load a JSONL span trace and write the Chrome trace JSON next to
    it; returns the trace object (callers embed summary stats). A
    merged device track in the JSONL (``device.*`` events from a
    --profile run) is re-stitched to its submitting steps so the export
    carries the host→device flow arrows."""
    from .attribution import is_device_event

    events = load_events(jsonl_path)
    dev = [e for e in events if is_device_event(e)]
    if dev:
        events = merge_device_track(
            [e for e in events if not is_device_event(e)], dev
        )
    trace = to_chrome_trace(events, **kwargs)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return trace


def device_annotation(name: str):
    """Optional device-side annotation: inside a ``torch.profiler``
    capture (``utils/profiling.device_trace``), a
    ``torch.profiler.record_function`` range that names the enclosed
    launches, so the capture's kernels line up with the host timeline's
    step names. A null context when no profiler runs: safe to use
    unconditionally, and free on the hot path."""
    try:
        import torch

        if torch._C._autograd._profiler_enabled():
            return torch.profiler.record_function(name)
    except Exception:
        pass
    return contextlib.nullcontext()
