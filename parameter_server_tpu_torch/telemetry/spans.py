"""Logical-clock span tracing: host wall time correlated to executor time.

The executor's logical clocks (``Task.time``) order every step but carry
no timing; ``bench.py`` can summarize an XLA device trace but sees
nothing host-side. A *span* bridges the two: a host wall-time interval
stamped with the logical timestamp it serves, emitted as one JSONL line
through the process sink. The executor emits one ``executor.step`` event
per finished step carrying all three phases (queue-wait from submit to
dispatch, run, materialize) so a trace reader can reconstruct the
pipeline without joining records.

Sink contract: append-only JSONL, one event per line, thread-safe,
best-effort (a tracing failure must never take down the step it was
measuring). ``install_sink(None)`` (the default) makes ``emit`` a cheap
None check — the hot path pays nothing when tracing is off.

Flow correlation (the timeline layer, :mod:`telemetry.timeline`): a
*flow id* names one unit of work — a batch, a superbatch launch, a
served request — as it crosses threads (feeder → prep pool → uploader
→ trainer step; serve submit → coalescer flush → executor). The stage
that creates the unit allocates an id with :func:`new_flow`, each stage
runs its work under ``with flow_scope(fid):``, and every span emitted
inside the scope carries ``"flow": fid`` automatically, so a trace
reader can stitch the per-thread tracks back into per-unit paths
without the stages knowing about each other. The scope is a
thread-local; crossing a thread boundary means carrying the id in the
hand-off (a queue tuple, a ticket field) and re-entering the scope on
the far side.

Crossing a *process* boundary (the Van wire) means carrying the id in
the message header instead: :func:`trace_context` builds the
wire-safe ``{"flow", "node", "t_send"}`` dict ``Van.transfer`` stamps
onto ``Task.trace``, and :func:`activate_trace` re-enters the scope on
the receiving side. Flow ids are per-process counters, so the context
also names the ORIGIN node — spans emitted under a received flow carry
``flow_node`` and the multi-node timeline merge
(:func:`telemetry.timeline.merge_node_events`) namespaces flows by
``(origin node, id)`` so two nodes' local flow 7 never alias.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import threading
import time
from typing import Any, Dict, Optional


class JsonlSink:
    """Append-only JSONL event sink (one dict per line)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f: Optional[io.TextIOWrapper] = open(path, "a", encoding="utf-8")

    def emit(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, default=str)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()  # readers (tests, tail -f) see events live

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


_sink_lock = threading.Lock()
_sink: Optional[JsonlSink] = None
_parked_depth = 0  # guarded-by: _sink_lock — nested parked_sink() count


def install_sink(sink: Optional[JsonlSink]) -> Optional[JsonlSink]:
    """Install the process event sink; returns the previous one (NOT
    closed — the caller owns both)."""
    global _sink
    with _sink_lock:
        prev, _sink = _sink, sink
        return prev


def get_sink() -> Optional[JsonlSink]:
    return _sink


def sink_state() -> str:
    """One of ``active`` / ``parked`` / ``absent`` — so a reader of an
    empty timeline tail (/debug/snapshot) can tell "no trace captured
    because nothing is listening" apart from "nothing happened":
    ``parked`` means a sink exists but is temporarily uninstalled
    (:func:`parked_sink`, the embedded-A/B idiom), ``absent`` means no
    sink was ever installed (or it was closed)."""
    with _sink_lock:
        if _sink is not None:
            return "active"
        return "parked" if _parked_depth > 0 else "absent"


def close_sink() -> None:
    """Close and uninstall the process sink (Postoffice.reset hook)."""
    global _sink
    with _sink_lock:
        sink, _sink = _sink, None
    if sink is not None:
        sink.close()


def emit(event: Dict[str, Any]) -> None:
    """Best-effort emit to the installed sink (no-op when none). Every
    event gains a ``thread`` field (the emitting thread's name) so the
    timeline reader can lay events out on per-thread tracks without the
    call sites threading identity through."""
    sink = _sink
    if sink is None:
        return
    with contextlib.suppress(Exception):
        if "thread" not in event:
            event["thread"] = threading.current_thread().name
        sink.emit(event)


# -- flow correlation ------------------------------------------------------

_flow_ids = itertools.count(1)  # count() is atomic under the GIL
_flow_local = threading.local()


def new_flow() -> int:
    """Allocate a fresh process-unique flow id (one per unit of work)."""
    return next(_flow_ids)


def maybe_new_flow() -> Optional[int]:
    """A fresh flow id when a sink is installed, else None — the
    producer-side idiom (only pay for flow ids when tracing is on;
    ``flow_scope(None)`` downstream is a no-op)."""
    return new_flow() if _sink is not None else None


@contextlib.contextmanager
def parked_sink():
    """Temporarily uninstall the span sink for a block — used around
    embedded A/B benches whose instrumented arms would otherwise pay a
    one-sided tracing tax and flood the run's trace with off-window
    events. Restores the previous sink on exit. While parked,
    :func:`sink_state` reports ``parked`` (only if a sink actually
    existed — parking nothing is still ``absent``)."""
    global _parked_depth
    prev = install_sink(None)
    had_sink = prev is not None
    if had_sink:
        with _sink_lock:
            _parked_depth += 1
    try:
        yield
    finally:
        if had_sink:
            with _sink_lock:
                _parked_depth -= 1
        install_sink(prev)


def current_flow() -> Optional[int]:
    """The flow id active on this thread, or None outside any scope."""
    return getattr(_flow_local, "flow", None)


def current_flow_node() -> Optional[str]:
    """The ORIGIN node of the active flow, or None when the flow was
    allocated locally (the overwhelmingly common case)."""
    return getattr(_flow_local, "node", None)


@contextlib.contextmanager
def flow_scope(flow: Optional[int], node: Optional[str] = None):
    """Run a block with ``flow`` as this thread's active flow id; spans
    emitted inside carry it automatically. ``flow_scope(None)`` is a
    no-op passthrough (tracing off / no id carried), so hand-off code
    can use it unconditionally. Scopes nest; the previous id is
    restored on exit. ``node`` names the flow's ORIGIN process when the
    id was received off the wire (:func:`activate_trace`) — spans then
    carry ``flow_node`` so the cross-node merge can namespace the id."""
    if flow is None:
        yield
        return
    prev = getattr(_flow_local, "flow", None)
    prev_node = getattr(_flow_local, "node", None)
    _flow_local.flow = flow
    _flow_local.node = node
    try:
        yield
    finally:
        _flow_local.flow = prev
        _flow_local.node = prev_node


def node_id() -> str:
    """This PROCESS's identity on the trace plane — the same id the
    cluster metrics plane reports under (``PS_NODE_ID``, default H0)."""
    import os

    return os.environ.get("PS_NODE_ID", "H0")


def trace_context() -> Dict[str, Any]:
    """The wire trace context for an outgoing message — the
    restricted-unpickler-safe dict ``Van.transfer`` stamps onto
    ``Task.trace``: the sending thread's active flow id (when one is
    active), this process's node id, and the send wall time. ``t_send``
    and ``node`` are stamped even with tracing off: the receiver's
    clock-offset estimator (system/heartbeat.ClockSync) needs the send
    time on every report exchange, tracing or not — the cost is one
    small dict per control-plane frame."""
    ctx: Dict[str, Any] = {"node": current_flow_node() or node_id(),
                           "t_send": time.time()}
    fid = current_flow()
    if fid is not None:
        ctx["flow"] = int(fid)
    return ctx


def activate_trace(trace: Optional[Dict[str, Any]]):
    """Re-enter a received message's flow on THIS thread (the receiving
    executor) so the unit of work stays ONE flow across the Van:
    ``with activate_trace(msg.task.trace): handle(msg)``. A context
    without a flow (or None — legacy peer, tracing off) is a no-op
    passthrough. The origin node rides along as ``flow_node`` on every
    span emitted inside, unless the flow originated here."""
    if not isinstance(trace, dict):
        return contextlib.nullcontext()
    fid = trace.get("flow")
    if fid is None:
        return contextlib.nullcontext()
    origin = trace.get("node")
    if origin == node_id():
        origin = None  # local loopback: no namespacing needed
    return flow_scope(int(fid), node=origin)


def abandoned(name: str, reason: str, flow: Optional[int] = None, **attrs) -> None:
    """Emit an explicit ``abandoned`` terminator for work that died
    before its span could close — the pool exception-forwarding path
    (utils/concurrent.OrderedStagePool) calls this so a worker
    exception leaves a tombstone in the timeline instead of an
    open-ended track."""
    event: Dict[str, Any] = {
        "kind": "span",
        "name": name,
        "t_wall": time.time(),
        "dur_s": 0.0,
        "abandoned": True,
        "reason": reason,
    }
    fid = flow if flow is not None else current_flow()
    if fid is not None:
        event["flow"] = fid
    event.update(attrs)
    emit(event)


@contextlib.contextmanager
def span(name: str, ts: Optional[int] = None, histogram=None, **attrs):
    """Time a host-side block and emit it as one JSONL event.

    ``ts`` is the executor logical timestamp the block serves — the
    correlation key between host spans and device steps. ``histogram``
    (a telemetry Histogram or labeled child) additionally records the
    duration, so the same interval feeds both the trace and the
    registry. Extra keyword attrs ride along verbatim.

    The thread's active :func:`flow_scope` id is attached as ``flow``
    (pass an explicit ``flow=`` attr to override). A block that exits
    via an exception still emits its event — with ``error`` naming the
    exception type — so the timeline never holds open-ended spans;
    MUST be used as a ``with`` statement (the pslint ``spans`` pass
    flags bare calls, whose block would otherwise never run).
    """
    t_wall = time.time()
    t0 = time.perf_counter()
    error: Optional[str] = None
    try:
        yield
    except BaseException as e:
        # only an exception that actually unwound THIS block is an
        # error of the span — sys.exc_info() in the finally would also
        # see an outer exception being handled around a clean block
        error = type(e).__name__
        raise
    finally:
        dur = time.perf_counter() - t0
        if histogram is not None:
            with contextlib.suppress(Exception):
                histogram.observe(dur)
        event = {"kind": "span", "name": name, "t_wall": t_wall, "dur_s": dur}
        if ts is not None:
            event["ts"] = ts
        fid = current_flow()
        if fid is not None:
            event["flow"] = fid
            fnode = current_flow_node()
            if fnode is not None:
                event["flow_node"] = fnode
        if error is not None:
            event["error"] = error
        event.update(attrs)
        emit(event)
