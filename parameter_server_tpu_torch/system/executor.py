"""Executor: logical clocks and dependency tracking over asynchronous
device work.

Counterpart of ``Executor`` and ``TaskTracker`` in the JAX package's
``system/executor.py`` (the reference's ``src/system/executor.{h,cc}``
and ``task_tracker.h``), without its telemetry, trace flows and fault
points. ``submit`` enqueues a step and returns its timestamp at once; a
dispatch thread runs the lowest-timestamp step whose ``wait_time``
dependencies have finished, so a step behind an unmet dependency does not
hold up a later one that is ready. A step that launched CUDA work is
finished only when that work is: the dispatch thread records a CUDA
event after the step, on the stream it launched on, and waiting on the
step waits on that event (nothing to wait on for CPU tensors).

``wait(ts)`` blocks until step ``ts`` has run and its device work is
done, and returns its value (re-raising its exception). With
``max_in_flight`` > 0, ``submit`` blocks while more than that many steps
are unfinished: the bounded-delay window.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# the one Task of the port: the executor reads its scheduling part, an
# explicit timestamp (or INVALID_TIME for the next one) and the
# timestamps that must have finished before the step runs
from .message import INVALID_TIME, Task  # noqa: F401  (re-exported)


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


class Executor:
    def __init__(self, name: str = "", max_in_flight: int = 0):
        self.name = name
        self.max_in_flight = max_in_flight  # 0 = unbounded
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

    def time(self) -> int:
        """The logical clock: the timestamp the next submitted step gets."""
        with self._cv:
            return self._time

    def pending_count(self) -> int:
        """Submitted steps not yet picked by the dispatch thread."""
        with self._cv:
            return len(self._pending)

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
            if pick is None:
                if event is not None:
                    event.synchronize()
                self._finish(dep)
                continue
            # the step runs outside the lock: submitters and waiters stay free
            self.tracker.start(ts)
            self.max_dispatched_in_flight = max(self.max_dispatched_in_flight,
                                                self.tracker.in_flight())
            event = None
            try:
                result, err = step(), None
                t = _cuda_tensor(result)
                if t is not None:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(t.device))
            except BaseException as e:  # re-raised at the waiter
                result, err = None, e
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

    def _finish(self, ts: int) -> None:
        """Mark ``ts`` finished, make ready the steps whose last unmet
        dependency it was, and fire its callback once."""
        if self.tracker.was_started(ts):
            self.tracker.finish(ts)
        with self._cv:
            self._ran.discard(ts)
            self._events.pop(ts, None)
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
            self._cv.notify_all()
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
                    raise TimeoutError(self._timeout_message_locked(ts, timeout))
                self._cv.wait(left)
            err = self._errors.pop(ts, None) if pop else self._errors.get(ts)
            fut = self._futures.pop(ts, None) if pop else self._futures.get(ts)
            event = self._events.get(ts)
        if err is not None:
            self._finish(ts)
            raise err
        if event is not None:
            try:
                event.synchronize()
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
