"""Executor: logical clocks and dependency tracking over asynchronous
device work.

Counterpart of ``Executor`` and ``TaskTracker`` in the JAX package's
``system/executor.py`` (the reference's ``src/system/executor.{h,cc}``
and ``task_tracker.h``), with its telemetry (the ``executor_*`` phase
histograms and depth gauges, one ``executor.step`` span a finished
step), its trace flows (the submitter's flow id rides into the step
body) and the live-executor registry the flight recorder reads; without
its fault points. ``submit`` enqueues a step and returns its timestamp at once; a
dispatch thread runs the lowest-timestamp step whose ``wait_time``
dependencies have finished, so a step behind an unmet dependency does not
hold up a later one that is ready. A step that launched CUDA work is
finished only when that work is: the dispatch thread records a CUDA
event after the step, on the stream it launched on, and waiting on the
step waits on that event (nothing to wait on for CPU tensors).

``wait(ts)`` blocks until step ``ts`` has run and its device work is
done, and returns its value (re-raising its exception). With
``max_in_flight`` > 0, ``submit`` blocks while more than that many steps
are unfinished: the bounded-delay window. :class:`NodeGroups` holds
the symbolic group ids ``ps.submit`` addresses.
"""

from __future__ import annotations

import heapq
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..telemetry import registry as telemetry_registry
from ..telemetry import spans as telemetry_spans

# the one Task of the port: the executor reads its scheduling part, an
# explicit timestamp (or INVALID_TIME for the next one) and the
# timestamps that must have finished before the step runs
from .message import INVALID_TIME, Task  # noqa: F401  (re-exported)


class _ExecutorTelemetry:
    """Per-executor bridge into the process registry (telemetry spine).

    The per-step path is ONE buffer append under one small lock; the
    buffered phase records flush into the registry instruments lazily,
    on the registry's collector hook (every ``snapshot()`` /
    ``render_text()`` read) or when the buffer fills. Instrument
    children are bound once here."""

    __slots__ = (
        "queue_wait", "run", "materialize", "total",
        "steps", "in_flight", "pending", "name",
        "_buf", "_buf_lock", "__weakref__",
    )

    _FLUSH_AT = 4096  # bound buffered memory between registry reads

    def __init__(self, name: str):
        from ..telemetry.instruments import executor_instruments

        reg = telemetry_registry.default_registry()
        insts = executor_instruments(reg)
        self.name = name
        self.queue_wait = insts["queue_wait"].labels(executor=name)
        self.run = insts["run"].labels(executor=name)
        self.materialize = insts["materialize"].labels(executor=name)
        self.total = insts["total"].labels(executor=name)
        self.steps = insts["steps"].labels(executor=name)
        self.in_flight = insts["in_flight"].labels(executor=name)
        self.pending = insts["pending"].labels(executor=name)
        self._buf: list = []  # guarded-by: _buf_lock
        self._buf_lock = threading.Lock()
        reg.add_collector(self.flush)

    def record(self, queue_wait: float, run_s: float, mat_s: float, total: float,
               in_flight: int, pending: int) -> None:
        """Hot path: one lock, one append; the flush is amortized."""
        with self._buf_lock:
            self._buf.append((queue_wait, run_s, mat_s, total, in_flight, pending))
            if len(self._buf) < self._FLUSH_AT:
                return
            buf, self._buf = self._buf, []
        self._flush_records(buf)

    def flush(self) -> None:
        """Drain buffered step records into the registry (collector hook)."""
        with self._buf_lock:
            buf, self._buf = self._buf, []
        if buf:
            self._flush_records(buf)

    def _flush_records(self, buf: list) -> None:
        for qw, run_s, mat_s, total, _, _ in buf:
            self.queue_wait.observe(qw)
            self.run.observe(run_s)
            self.materialize.observe(mat_s)
            self.total.observe(total)
        self.steps.inc(len(buf))
        # gauges are point-in-time: the newest record wins
        self.in_flight.set(buf[-1][4])
        self.pending.set(buf[-1][5])


class TaskTracker:
    """Started and finished timestamps."""

    def __init__(self) -> None:
        self._finished: set = set()  # guarded by _lock
        self._started: set = set()  # guarded by _lock
        self._inflight = 0  # started, not finished; guarded by _lock
        self._lock = threading.Lock()

    def start(self, ts: int) -> None:
        with self._lock:
            if ts not in self._started and ts not in self._finished:
                self._inflight += 1
            self._started.add(ts)

    def finish(self, ts: int) -> None:
        with self._lock:
            if ts in self._started and ts not in self._finished:
                self._inflight -= 1
            self._finished.add(ts)

    def is_finished(self, ts: int) -> bool:
        with self._lock:
            return ts in self._finished

    def was_started(self, ts: int) -> bool:
        with self._lock:
            return ts in self._started

    def in_flight(self) -> int:
        """Started (dispatched) but not yet finished."""
        with self._lock:
            return self._inflight


def _cuda_tensor(value) -> Optional[torch.Tensor]:
    """A CUDA tensor of a step's result (a tensor, or a dict, list or
    tuple of them), or None."""
    if isinstance(value, torch.Tensor):
        return value if value.is_cuda else None
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            t = _cuda_tensor(v)
            if t is not None:
                return t
    return None


#: every live executor, weakly held: the diagnostic-bundle capture
#: (telemetry/blackbox.py) walks it; registration and the capture's copy
#: both go through _live_lock (a WeakSet is not thread-safe)
_live_executors: "weakref.WeakSet" = weakref.WeakSet()
_live_lock = threading.Lock()


def live_executors() -> List["Executor"]:
    """The process's live executors (for diagnostics; order arbitrary)."""
    with _live_lock:
        return list(_live_executors)


class Executor:
    def __init__(self, name: str = "", max_in_flight: int = 0,
                 telemetry: Optional[bool] = None):
        self.name = name
        self.max_in_flight = max_in_flight  # 0 = unbounded
        # telemetry: decided here, so the hot path tests one attribute;
        # None follows the process-wide switch
        if telemetry is None:
            telemetry = telemetry_registry.enabled()
        self._tel: Optional[_ExecutorTelemetry] = _ExecutorTelemetry(name) if telemetry else None
        # ts -> [t_submit, t_dispatch, run_s, materialize_s, flow]
        # (perf_counter); handed across threads by dict.pop's atomicity
        self._step_times: Dict[int, List[Any]] = {}
        # ts -> (flow id, origin node) of the submitting thread
        self._flows: Dict[int, Tuple[int, Optional[str]]] = {}  # guarded by _cv
        self._time = 0  # the logical clock; guarded by _cv
        # every field below is guarded by _cv
        self._pending: Dict[int, Tuple[Callable[[], Any], List[int]]] = {}
        self._unmet: Dict[int, int] = {}  # pending ts -> unmet dependencies
        self._dependents: Dict[int, List[int]] = {}  # dep ts -> steps waiting on it
        self._ready: List[int] = []  # heap of dispatchable timestamps
        self._running: Optional[int] = None  # picked, executing now
        self._ran: set = set()  # ran, not finished yet
        self._futures: Dict[int, Any] = {}  # ts -> the step's value
        self._events: Dict[int, "torch.cuda.Event"] = {}  # ts -> after its device work
        self._callbacks: Dict[int, Callable[[], None]] = {}
        self._errors: Dict[int, BaseException] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self.tracker = TaskTracker()
        self._cv = threading.Condition()
        # the most steps ever started and unfinished at a dispatch
        self.max_dispatched_in_flight = 0
        with _live_lock:
            _live_executors.add(self)

    def time(self) -> int:
        """The logical clock: the timestamp the next submitted step gets."""
        with self._cv:
            return self._time

    def pending_count(self) -> int:
        """Submitted steps not yet picked by the dispatch thread."""
        with self._cv:
            return len(self._pending)

    def debug_state(self, max_pending: int = 16) -> Dict[str, Any]:
        """Point-in-time diagnostic snapshot for incident bundles
        (telemetry/blackbox.py): logical clock, backlog depth and its
        oldest timestamps, the step executing now, in-flight count."""
        with self._cv:
            pending = sorted(self._pending)
            return {
                "name": self.name,
                "logical_time": self._time,
                "pending": len(pending),
                "pending_ts": pending[:max_pending],
                "running": self._running,
                "in_flight": self.tracker.in_flight(),
            }

    # -- submission --

    def submit(self, step: Callable[[], Any], task: Optional[Task] = None,
               callback: Optional[Callable[[], None]] = None) -> int:
        """Enqueue ``step`` and return its timestamp at once.

        ``task.wait_time`` lists timestamps that must be finished before
        the step runs; each must be earlier than the step's own. A
        dependency that was never submitted counts as met (checked once,
        here). The step runs on the dispatch thread, possibly after later
        steps whose dependencies were met first."""
        task = task or Task()
        with self._cv:
            if task.time != INVALID_TIME:
                ts = task.time
                if ts < self._time and self.tracker.was_started(ts) or ts in self._pending:
                    raise ValueError(f"timestamp {ts} already used")
                # the clock stays ahead of explicit timestamps
                self._time = max(self._time, ts + 1)
            else:
                ts = self._time
                self._time += 1
            deps = []
            for dep in task.wait_time:
                if dep == INVALID_TIME:
                    continue
                if dep >= ts:
                    raise ValueError(f"dependency {dep} is not before step {ts}")
                deps.append(dep)
            self._pending[ts] = (step, deps)
            flow = telemetry_spans.current_flow()
            if flow is not None:
                self._flows[ts] = (flow, telemetry_spans.current_flow_node())
            if self._tel is not None:
                # [t_submit, t_dispatch (0: not picked yet), run_s (-1:
                # not run yet), materialize_s, the submitter's flow]
                self._step_times[ts] = [time.perf_counter(), 0.0, -1.0, 0.0, flow]
            # a dependency not yet done registers this step as its
            # dependent; _finish(dep) counts it down and makes the step
            # ready at zero. One done now never changes again.
            unmet = [d for d in deps if not self._dep_done_locked(d)]
            if unmet:
                self._unmet[ts] = len(unmet)
                for d in unmet:
                    self._dependents.setdefault(d, []).append(ts)
            else:
                heapq.heappush(self._ready, ts)
            if callback is not None:
                self._callbacks[ts] = callback
            self._ensure_thread()
            self._cv.notify_all()
        if self.max_in_flight > 0 and ts - self.max_in_flight >= 0:
            # the window: step ts - max_in_flight must be done; its value
            # stays claimable by a later wait
            self.wait(ts - self.max_in_flight, pop=False)
        return ts

    # -- the dispatch thread --

    def _ensure_thread(self) -> None:  # holds _cv
        if self._thread is None or not self._thread.is_alive():
            self._stopped = False
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            name=f"executor:{self.name}", daemon=True)
            self._thread.start()

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                pick = self._pick_ready_locked()
                if pick is None:
                    # nothing ready: finish the oldest blocked step's first
                    # unmet dependency, which is older and so has run
                    oldest = min(self._pending)
                    dep = next((d for d in self._pending[oldest][1]
                                if not self._dep_done_locked(d)), None)
                    if dep is None:
                        # its dependencies are all done, yet no _finish
                        # made it ready (a wait() finished one meanwhile, or
                        # a tracker.finish from outside): make it ready here
                        self._unmet.pop(oldest, None)
                        heapq.heappush(self._ready, oldest)
                        continue
                    if dep not in self._futures:
                        # running, or taken by a concurrent wait(), which
                        # finishes it and notifies
                        self._cv.wait()
                        continue
                    event = self._events.pop(dep, None)
                else:
                    ts, step = pick
                    self._running = ts
                    step_flow = self._flows.pop(ts, None)
            if pick is None:
                if event is not None:
                    self._synchronize(dep, event)
                self._finish(dep)
                continue
            # the step runs outside the lock: submitters and waiters stay free
            self.tracker.start(ts)
            self.max_dispatched_in_flight = max(self.max_dispatched_in_flight,
                                                self.tracker.in_flight())
            event = None
            tel = self._tel
            times = None
            if tel is not None:
                t_run0 = time.perf_counter()
                times = self._step_times.get(ts)
                if times is not None:
                    times[1] = t_run0  # picked: the queue wait ends
            try:
                # the submitter's flow rides into the step body
                with telemetry_spans.flow_scope(*(step_flow or (None, None))):
                    result, err = step(), None
                t = _cuda_tensor(result)
                if t is not None:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(t.device))
            except BaseException as e:  # re-raised at the waiter
                result, err = None, e
            if times is not None:
                times[2] = time.perf_counter() - t_run0
            with self._cv:
                self._running = None
                self._ran.add(ts)
                if err is not None:
                    self._errors[ts] = err
                else:
                    self._futures[ts] = result
                    if event is not None:
                        self._events[ts] = event
                self._cv.notify_all()

    def _dep_done_locked(self, d: int) -> bool:  # holds _cv
        """Finished, or never submitted."""
        if self.tracker.is_finished(d):
            return True
        return (d not in self._pending and d != self._running and d not in self._ran
                and not self.tracker.was_started(d))

    def _pick_ready_locked(self) -> Optional[Tuple[int, Callable[[], Any]]]:  # holds _cv
        """The lowest ready timestamp and its step. Stale heap entries
        (run or cancelled, or a reused timestamp with unmet dependencies)
        are skipped."""
        while self._ready:
            if self._ready[0] in self._unmet:
                heapq.heappop(self._ready)
                continue
            ts = heapq.heappop(self._ready)
            entry = self._pending.pop(ts, None)
            if entry is not None:
                return ts, entry[0]
        return None

    def _synchronize(self, ts: int, event) -> None:
        """Wait for a step's device work, timing the wait onto its record
        (a step may be waited on from several threads; the phases sum)."""
        t0 = time.perf_counter()
        event.synchronize()
        if self._tel is not None:
            times = self._step_times.get(ts)
            if times is not None:
                times[3] += time.perf_counter() - t0

    def _record_finished(self, ts: int, num_pending: int) -> None:
        """Record the finished step's phases into the registry and emit
        its ``executor.step`` span (once a step, popped exactly once)."""
        tel = self._tel
        if tel is None:
            return
        times = self._step_times.get(ts)
        if times is None or times[1] == 0.0 or times[2] < 0.0:
            # not dispatched here, or its body still runs (a finish from
            # outside): the finish that sees the run completed records it
            return
        times = self._step_times.pop(ts, None)
        if times is None:
            return  # a concurrent finish won the pop; it emitted
        now = time.perf_counter()
        t_submit, t_dispatch, run_s, mat_s, flow = times
        queue_wait = max(0.0, t_dispatch - t_submit)
        total = max(0.0, now - t_submit)
        tel.record(queue_wait, run_s, mat_s, total, self.tracker.in_flight(), num_pending)
        if telemetry_spans.get_sink() is not None:
            event = {
                "kind": "span",
                "name": "executor.step",
                "executor": tel.name,
                "ts": ts,
                "t_wall": time.time(),
                "queue_wait_s": queue_wait,
                "run_s": run_s,
                "materialize_s": mat_s,
                "total_s": total,
            }
            if flow is not None:
                event["flow"] = flow
            telemetry_spans.emit(event)

    def _finish(self, ts: int) -> None:
        """Mark ``ts`` finished, make ready the steps whose last unmet
        dependency it was, and fire its callback once."""
        if self.tracker.was_started(ts):
            self.tracker.finish(ts)
        with self._cv:
            self._ran.discard(ts)
            self._events.pop(ts, None)
            self._flows.pop(ts, None)  # steps finished from outside
            for t in self._dependents.pop(ts, ()):
                left = self._unmet.get(t)
                if left is None:
                    continue  # cancelled by stop()
                if left <= 1:
                    del self._unmet[t]
                    if t in self._pending:
                        heapq.heappush(self._ready, t)
                else:
                    self._unmet[t] = left - 1
            cb = self._callbacks.pop(ts, None)
            num_pending = len(self._pending)
            self._cv.notify_all()
        self._record_finished(ts, num_pending)
        if cb is not None:
            cb()

    # -- waiting --

    def wait(self, ts: int, pop: bool = True, timeout: Optional[float] = None) -> Any:
        """Block until step ``ts`` has run and its device work is done;
        return its value (None if ``ts`` is unknown or already taken) or
        re-raise its exception. ``pop`` (default) drops the value, so its
        device tensors are freed; ``pop=False`` leaves it for a later
        wait. ``timeout`` (seconds) raises ``TimeoutError`` naming the
        step's state; the step keeps running."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            known = (ts in self._pending or ts == self._running or ts in self._ran
                     or self.tracker.was_started(ts) or self.tracker.is_finished(ts))
            if not known:
                return None
            while not (ts in self._futures or ts in self._errors
                       or self.tracker.is_finished(ts)):
                if deadline is None:
                    self._cv.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0:
                    timed_out = TimeoutError(self._timeout_message_locked(ts, timeout))
                    break
                self._cv.wait(left)
            else:
                timed_out = None
            if timed_out is None:
                err = self._errors.pop(ts, None) if pop else self._errors.get(ts)
                fut = self._futures.pop(ts, None) if pop else self._futures.get(ts)
                event = self._events.get(ts)
        if timed_out is not None:
            # a wedged wait is a flight-recorder trigger, raised outside
            # the lock (the capture reads executor state through it)
            from ..telemetry import blackbox

            blackbox.trigger_bundle("executor_wait_timeout", detail=str(timed_out))
            raise timed_out
        if err is not None:
            self._finish(ts)
            raise err
        if event is not None:
            try:
                self._synchronize(ts, event)
            except BaseException:
                # it ran: finish it anyway, or every later wait would spin
                self._finish(ts)
                raise
        self._finish(ts)
        return fut

    def _timeout_message_locked(self, ts: int, timeout: float) -> str:  # holds _cv
        entry = self._pending.get(ts)
        if entry is not None:
            unmet = [d for d in entry[1] if not self._dep_done_locked(d)]
            state = (f"pending with unmet wait_time dependencies {unmet}" if unmet
                     else "pending (ready, not dispatched yet)")
        elif ts == self._running:
            state = "executing on the dispatch thread"
        elif ts in self._ran:
            state = "ran; its device work not finished"
        else:
            state = "started from outside, never finished"
        return f"executor {self.name!r}: step {ts} unfinished after {timeout} s: {state}"

    def wait_all(self, pop: bool = True, timeout: Optional[float] = None) -> None:
        """Drain every unfinished step, the one executing now included;
        ``timeout`` bounds the whole drain."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cv:
                todo = set(self._pending) | self._ran
                if self._running is not None:
                    todo.add(self._running)
            if not todo:
                return
            for ts in sorted(todo):
                left = None if deadline is None else deadline - time.monotonic()
                self.wait(ts, pop=pop, timeout=left)

    def device_busy(self, ts: int) -> bool:
        """Step ``ts`` has run and its CUDA work has not finished yet (its
        event's ``query()`` reads false). False for a step that has not
        run, was waited on, or launched no CUDA work."""
        with self._cv:
            event = self._events.get(ts)
        return event is not None and not event.query()

    def result(self, ts: int) -> Any:
        """The value of step ``ts`` (its device work may still run), or
        None once waited or before it ran."""
        with self._cv:
            return self._futures.get(ts)

    def pop_result(self, ts: int) -> Any:
        """Step ``ts``'s value once it is done, taken out of the executor
        (:meth:`wait` with ``pop=True``)."""
        return self.wait(ts)

    def stop(self, cancel_pending: bool = True) -> None:
        """Stop the dispatch thread and join it. ``cancel_pending`` drops
        the steps not started (the executing one completes). Idempotent."""
        with self._cv:
            if cancel_pending:
                cancelled = set(self._pending)
                for ts in cancelled:
                    self._pending.pop(ts)
                    self._callbacks.pop(ts, None)
                    self._unmet.pop(ts, None)
                    self._step_times.pop(ts, None)  # never dispatched
                    self._flows.pop(ts, None)
                # purge, not skip later: a reused explicit timestamp must
                # not inherit a stale heap entry or dependent registration
                self._ready = [t for t in self._ready if t not in cancelled]
                heapq.heapify(self._ready)
                for d in list(self._dependents):
                    kept = [t for t in self._dependents[d] if t not in cancelled]
                    if kept:
                        self._dependents[d] = kept
                    else:
                        del self._dependents[d]
            self._stopped = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None and thread.is_alive() and thread is not threading.current_thread():
            thread.join(timeout=60)
        if self._tel is not None:
            # push buffered step records out before this executor (and its
            # collector registration) can be collected
            self._tel.flush()


class NodeGroups:
    """Symbolic node group ids (ref executor.h kServerGroup et al.), the
    JAX package's values: ``ps.submit`` resolves a group to the apps of
    its roles."""

    SERVER_GROUP = "all_servers"
    WORKER_GROUP = "all_workers"
    COMP_GROUP = "all_comp_nodes"
    REPLICA_GROUP = "all_replicas"
    OWNER_GROUP = "all_owners"
    LIVE_GROUP = "all_lives"
