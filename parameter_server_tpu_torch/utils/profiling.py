"""Device-level tracing on ``torch.profiler``.

Counterpart of ``parameter_server_tpu/utils/profiling.py``. The JAX
package captures an XLA device trace with ``jax.profiler``; here
:func:`device_trace` runs ``torch.profiler`` with the CPU and (on a
card) CUDA activities and writes one Chrome trace (Perfetto opens it)
per capture under ``<log_dir>/<run>/<host>.trace.json``. CUDA activity
comes from CUPTI, which admits one profiling session per process: a
capture asked for while another profiler runs degrades to a warning and
runs the block untraced, as a profiler that fails to start does.

The readers work on the newest capture of a directory:

- :func:`device_track_events` turns its kernel, copy and memset records
  (``cat`` ``kernel`` / ``gpu_memcpy`` / ``gpu_memset``) into the
  ``device.*`` span events that ``telemetry/timeline.merge_device_track``
  stitches to their host steps, each with the host time of its launch
  (the ``ac2g`` flow that links a kernel to its ``cudaLaunchKernel``);
- :func:`kernel_counts` counts the kernel records by name;
- :func:`summarize_trace` buckets device time by phase and by kernel.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import time
from typing import Iterator

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_captures = itertools.count()


def _profiler_running() -> bool:
    try:
        import torch

        return bool(torch._C._autograd._profiler_enabled())
    except Exception:
        return False


@contextlib.contextmanager
def device_trace(log_dir: str | None) -> Iterator[None]:
    """Capture a trace of the enclosed block into ``log_dir``.

    ``None`` is a no-op, so callers can pass an optional CLI flag
    straight through. A profiler that fails to start (another session
    running, no CUPTI) degrades to a warning, never a crashed run."""
    if not log_dir:
        yield
        return
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    if _profiler_running():
        warnings.warn("device trace not started: another profiler session is running")
        yield
        return
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    try:
        prof.__enter__()
    except Exception as e:  # pragma: no cover - backend-dependent
        warnings.warn(f"device trace not started: {e!r}")
        yield
        return
    try:
        yield
    finally:
        try:
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            run = os.path.join(log_dir, time.strftime("%Y%m%d-%H%M%S")
                               + f"-{os.getpid()}-{next(_captures)}")
            os.makedirs(run, exist_ok=True)
            prof.export_chrome_trace(os.path.join(run, f"{socket.gethostname()}.trace.json"))
        except Exception as e:  # pragma: no cover
            warnings.warn(f"device trace not stopped cleanly: {e!r}")


def annotate(name: str):
    """Named region inside a capture (a ``user_annotation`` on the host
    track). Usable as a context manager: ``with annotate("push"): ...``"""
    import torch

    return torch.profiler.record_function(name)


# -- trace post-processing ---------------------------------------------------

_PHASE_PREFIXES = (
    "ps_decode", "ps_pull", "ps_compute", "ps_push", "ps_update",
    "ps_metrics",
)


def _trace_files(log_dir: str) -> "list[str]":
    """Trace files of the NEWEST capture only: each capture writes its
    own ``<log_dir>/<run>/`` directory, and a reused directory
    accumulates runs; mixing them would sum device time across
    captures."""
    import glob

    paths = {
        (p[:-3] if p.endswith(".gz") else p): p
        for pat in ("*.trace.json", "*.trace.json.gz")
        for p in glob.glob(os.path.join(log_dir, "**", pat), recursive=True)
    }
    if not paths:
        return []
    runs: dict = {}
    for p in paths.values():
        runs.setdefault(os.path.dirname(p), []).append(p)
    newest = max(runs, key=lambda d: os.path.getmtime(d))
    return sorted(runs[newest])


def _load(path: str):
    import gzip
    import json as _json

    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", errors="replace") as f:
                return _json.load(f)
        with open(path, errors="replace") as f:
            return _json.load(f)
    except (OSError, ValueError):
        return None


def _iter_trace_docs(log_dir: str):
    """Yield (base wall seconds, events) per trace file of the newest
    capture. ``baseTimeNanoseconds`` anchors torch's microsecond ``ts``
    on the wall clock (0.0 when the file has none)."""
    for path in _trace_files(log_dir):
        doc = _load(path)
        if doc is None:
            continue
        events = (doc if isinstance(doc, list) else doc.get("traceEvents")) or []
        base = 0.0
        if isinstance(doc, dict) and doc.get("baseTimeNanoseconds") is not None:
            base = float(doc["baseTimeNanoseconds"]) / 1e9
        yield base, [ev for ev in events if isinstance(ev, dict)]


def _is_device_op(ev: dict) -> bool:
    return ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS and bool(ev.get("dur"))


def _launches(events) -> dict:
    """``ac2g`` flow id (the CUPTI correlation id) → host ``ts`` of the
    launch it starts from; the runtime event's own ``correlation`` arg
    stands in where the flow start is missing."""
    out: dict = {}
    for ev in events:
        if ev.get("cat") == "ac2g" and ev.get("ph") == "s" and ev.get("id") is not None:
            out[ev["id"]] = float(ev.get("ts", 0.0))
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "cuda_runtime":
            c = (ev.get("args") or {}).get("correlation")
            if c is not None and c not in out:
                out[c] = float(ev.get("ts", 0.0))
    return out


def device_track_events(
    log_dir: str,
    host_anchor: "float | None" = None,
    max_events: int = 4000,
) -> "list[dict]":
    """The newest capture's kernel, copy and memset records as
    span-sink-shaped dicts: the device track of a merged timeline.

    Each becomes ``{"kind": "span", "name": "device.<kernel>", "thread":
    "device:<pid>", "t_wall": ..., "dur_s": ...}`` plus ``launch_t_wall``,
    the host time of its ``cudaLaunchKernel`` (or copy call), when the
    trace links them. Times are on the wall clock through the trace's
    ``baseTimeNanoseconds``; ``host_anchor`` instead shifts the track as
    a block to start there. Records beyond ``max_events`` are dropped
    shortest first. Never raises (result-path code)."""
    try:
        collected: "list[tuple]" = []
        for base, events in _iter_trace_docs(log_dir):
            launches = _launches(events)
            for ev in events:
                if not _is_device_op(ev):
                    continue
                corr = (ev.get("args") or {}).get("correlation")
                launch = launches.get(corr)
                collected.append((ev.get("pid"), base + float(ev.get("ts", 0.0)) / 1e6,
                                  float(ev["dur"]) / 1e6, str(ev.get("name") or "?")[:80],
                                  None if launch is None else base + launch / 1e6))
        if not collected:
            return []
        if len(collected) > max_events:
            collected = sorted(collected, key=lambda c: -c[2])[:max_events]
        shift = 0.0
        if host_anchor is not None:
            shift = host_anchor - min(c[1] for c in collected)
        out = []
        for pid, t, dur, name, launch in collected:
            ev = {"kind": "span", "name": f"device.{name}", "thread": f"device:{pid}",
                  "t_wall": t + shift, "dur_s": dur}
            if launch is not None:
                ev["launch_t_wall"] = launch + shift
            out.append(ev)
        out.sort(key=lambda e: e["t_wall"])
        return out
    except Exception:  # pragma: no cover - defensive: result-path code
        return []


def kernel_counts(log_dir: str) -> "dict[str, int]":
    """Kernel records of the newest capture, counted by kernel name
    (copies and memsets left out)."""
    counts: dict = {}
    for _, events in _iter_trace_docs(log_dir):
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") == "kernel":
                name = str(ev.get("name") or "?")
                counts[name] = counts.get(name, 0) + 1
    return counts


def _self_times(track_events: "list[dict]"):
    """Yield ``(event, self_us)`` for complete events of ONE trace
    track, where self_us is the event's duration minus the duration of
    child events nested inside it on the same track (Chrome-trace
    nesting: a child starts at/after the parent and ends at/before it).
    Sorting by (start, -duration) makes parents precede their children;
    a span stack then attributes each event's time to the innermost
    enclosing span, which is exactly per-op self time."""
    evs = sorted(
        track_events,
        key=lambda e: (e.get("ts", 0), -(e.get("dur") or 0)),
    )
    stack: list = []  # [event, end_ts, child_us]
    for ev in evs:
        ts = ev.get("ts", 0)
        dur = ev.get("dur") or 0
        while stack and ts >= stack[-1][1]:
            top_ev, _, child_us = stack.pop()
            yield top_ev, (top_ev.get("dur") or 0) - child_us
        if stack:
            stack[-1][2] += dur
        stack.append([ev, ts + dur, 0.0])
    while stack:
        top_ev, _, child_us = stack.pop()
        yield top_ev, (top_ev.get("dur") or 0) - child_us


def _phase_of(launch_ts, annotations) -> str:
    """The phase of a launch: the first of :data:`_PHASE_PREFIXES` found
    in the innermost host annotation that encloses its launch time."""
    best = None
    for ts, end, name in annotations:
        if ts <= launch_ts <= end and (best is None or ts >= best[0]):
            best = (ts, name)
    if best is None:
        return "other"
    return next((p for p in _PHASE_PREFIXES if p in best[1]), "other")


def summarize_trace(log_dir: str, top: int = 12) -> "dict | None":
    """Bucket device time in the newest capture by phase and by kernel.

    Returns ``{"device_ms": total, "device_tracks": n, "phases": {phase:
    ms}, "top_ops": [{"name", "ms", "calls"}...]}`` or None when no
    parseable trace or no device record exists (host records are never
    counted as device time). Each record is credited its self time on
    its (device, stream) track. A record's phase is the
    :data:`_PHASE_PREFIXES` entry named by the innermost host annotation
    (``annotate`` / ``record_function``) around its launch. Never
    raises: result-path code."""
    try:
        phases: dict = {}
        ops: dict = {}
        total_us = 0.0
        tracks_seen: set = set()
        for _, events in _iter_trace_docs(log_dir):
            launches = _launches(events)
            annotations = [
                (float(ev.get("ts", 0.0)), float(ev.get("ts", 0.0)) + float(ev.get("dur") or 0.0),
                 str(ev.get("name") or ""))
                for ev in events
                if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
            ]
            tracks: dict = {}
            for ev in events:
                if _is_device_op(ev):
                    tracks.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
            for key, track_events in tracks.items():
                tracks_seen.add(key[0])
                for ev, self_us in _self_times(track_events):
                    if self_us <= 0:
                        continue
                    total_us += self_us
                    launch = launches.get((ev.get("args") or {}).get("correlation"))
                    phase = "other" if launch is None else _phase_of(launch, annotations)
                    phases[phase] = phases.get(phase, 0.0) + self_us
                    rec = ops.setdefault(str(ev.get("name") or "?")[:80], [0.0, 0])
                    rec[0] += self_us
                    rec[1] += 1
        if not ops:
            return None
        return {
            "device_ms": round(total_us / 1e3, 3),
            "device_tracks": len(tracks_seen),
            "phases": {k: round(v / 1e3, 3)
                       for k, v in sorted(phases.items(), key=lambda kv: -kv[1])},
            "top_ops": [
                {"name": k, "ms": round(v[0] / 1e3, 3), "calls": v[1]}
                for k, v in sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
            ],
        }
    except Exception:  # pragma: no cover - defensive: result-path code
        return None
