"""Request coalescing: merge in-flight pulls into one executor submit.

Counterpart of ``parameter_server_tpu/serving/coalescer.py``, with its
``serve.coalesce.flush`` span (whose ``flows`` list names the merged
requests, so the timeline draws fan-in arrows) and its
``ps_serve_coalesce_*`` counters.

Serving traffic is read-heavy and hot-keyed: concurrent sessions ask
for overlapping key ranges within microseconds of each other. Issuing
each request as its own ``store.pull`` pays one executor submit + one
device gather + one host materialize PER REQUEST; the coalescer instead
accumulates requests for a bounded window (or until a key/request
budget fills), dedups the union key set host-side (``np.unique``), and
issues ONE submit for the whole batch. Each waiter then slices its rows
out of the union result by ``searchsorted`` — exact, because the union
contains every requested key by construction.

Two existing mechanisms make the merged pull cheap:

- the union of a hot working set repeats across windows, so the store's
  ``KeyDirectory`` slot-signature cache answers the hash/searchsorted
  pass AND the host→device index upload from cache;
- one [U, k] gather materializes fewer total rows than N overlapping
  gathers — the overlap is fetched once.

Under load the coalescer gets MORE effective, not less: while the
flusher is executing window t, new arrivals accumulate into window t+1,
so the merge factor grows exactly when the executor needs relief. The
bench's acceptance number (``submits_per_request < 1`` at overlapping-
key load) is the stats pair this class counts.

Threading: clients call :meth:`pull` from any thread; ONE flusher
thread owns store submission order. The pulled union is copied to the
host on the flusher thread, after the store's executor reports the
pull step's device work done. ``close()`` drains and joins.

On a mesh the store is rank 0's ``parallel/sequence.Order`` (the
frontend's, or one the caller built on every rank): the flush's pull
takes its place in the order every rank follows, and a pull that
raises on rank 0 is never published. A bare store on a mesh is refused.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from ..parallel import sequence
from ..telemetry import spans as telemetry_spans
from ..utils.retry import DeadlineExceeded


def _host(values) -> np.ndarray:
    """A pulled result as a host array (a tensor of the store's device,
    whose device work the store's ``wait_pull`` has waited out)."""
    if hasattr(values, "cpu"):
        return values.cpu().numpy()
    return np.asarray(values)


class _Window:
    """One coalesce generation: requests accumulated, then flushed as
    one pull. Published fields (``union``/``values``/``error``) are
    written by the flusher BEFORE ``done.set()`` and read by waiters
    only after ``done.wait()`` — the event is the fence, no lock."""

    __slots__ = (
        "keys", "n_requests", "deadline", "done", "union", "values",
        "error", "flows",
    )

    def __init__(self, deadline: float):
        self.keys: List[np.ndarray] = []
        self.n_requests = 0
        self.deadline = deadline
        self.done = threading.Event()
        self.union: Optional[np.ndarray] = None
        self.values: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # timeline fan-in: the flow ids of the requests this window
        # merged (appended under the coalescer's _cv, read by the
        # flusher after the hand-off)
        self.flows: List[int] = []


class PullTicket:
    """A client's claim on one coalesced pull. ``result()`` blocks for
    the window's flush, then slices this request's rows from the union
    result (each waiter pays its own searchsorted — the fan-out work
    parallelizes across client threads instead of serializing on the
    flusher)."""

    __slots__ = ("_win", "_keys")

    def __init__(self, win: _Window, keys: np.ndarray):
        self._win = win
        self._keys = keys

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._win.done.wait(timeout):
            # explicit deadline semantics (utils/retry.py) — still a
            # TimeoutError; the frontend's degraded path catches this
            # as "live store past deadline"
            raise DeadlineExceeded(
                f"coalesced pull did not complete within {timeout}s",
                op="serve:coalesced-pull", deadline_s=timeout,
            )
        if self._win.error is not None:
            raise RuntimeError(
                "coalesced pull failed"
            ) from self._win.error
        pos = np.searchsorted(self._win.union, self._keys)
        return self._win.values[pos]


# owner-thread: flusher
class PullCoalescer:
    """Merge concurrent pulls against one store channel.

    ``store`` is any parameter store exposing the ``pull(task, keys)``
    / ``wait_pull(ts)`` / ``request(channel=...)`` protocol (KVVector,
    KVMap). ``window_s`` bounds the latency cost of waiting for merge
    partners — the p50 tax that buys the p99 win; ``max_keys`` /
    ``max_requests`` flush a window early so one elephant request
    cannot hold the door open for the whole window.
    """

    def __init__(
        self,
        store,
        channel: int = 0,
        window_s: float = 0.002,
        max_keys: int = 1 << 16,
        max_requests: int = 256,
    ):
        sequence.require(store, "PullCoalescer")
        self.store = store
        self.channel = int(channel)
        self.window_s = float(window_s)
        self.max_keys = int(max_keys)
        self.max_requests = int(max_requests)
        self._cv = threading.Condition()
        self._open: Optional[_Window] = None  # guarded-by: _cv
        self._open_keys = 0  # guarded-by: _cv — total keys staged in _open
        self._closed = False  # guarded-by: _cv
        # stats (monotonic; the serve bench reads them): requests in,
        # submits out, keys requested vs keys actually pulled
        self.requests_total = 0  # guarded-by: _cv
        self.submits_total = 0  # guarded-by: _cv
        self.requested_keys_total = 0  # guarded-by: _cv
        self.union_keys_total = 0  # guarded-by: _cv
        from ..telemetry.instruments import cached_serve_instruments

        self._tel = cached_serve_instruments
        self._thread = threading.Thread(
            target=self._flush_loop, name="serve-coalescer", daemon=True
        )
        self._thread.start()

    # -- client side --

    def pull(self, keys: np.ndarray) -> PullTicket:
        """Stage one request into the current window; returns a ticket.
        Raises RuntimeError after :meth:`close`."""
        keys = np.asarray(keys, dtype=np.int64).ravel()
        with self._cv:
            if self._closed:
                raise RuntimeError("PullCoalescer is closed")
            win = self._open
            fresh = win is None
            if fresh:
                win = _Window(time.monotonic() + self.window_s)
                self._open = win
                self._open_keys = 0
            win.keys.append(keys)
            win.n_requests += 1
            fid = telemetry_spans.current_flow()
            if fid is not None:
                win.flows.append(fid)
            self._open_keys += len(keys)
            self.requests_total += 1
            self.requested_keys_total += len(keys)
            full = (
                self._open_keys >= self.max_keys
                or win.n_requests >= self.max_requests
            )
            if full:
                win.deadline = 0.0  # flush now
            if fresh or full:
                # only these change anything the flusher can act on (a
                # new deadline to sleep toward, or an early flush); a
                # mid-window arrival would just wake it into re-checking
                # the same deadline — at thousands of submits/sec those
                # wakeups are pure context-switch tax on the hot path
                self._cv.notify_all()
        return PullTicket(win, keys)

    # -- flusher thread --

    def _take_window_locked(self) -> Optional[_Window]:  # holds-lock: _cv
        """The open window once its deadline passed (or it filled), else
        None after bounding the wait to the deadline."""
        win = self._open
        if win is None:
            self._cv.wait()
            return None
        now = time.monotonic()
        if now < win.deadline:
            self._cv.wait(win.deadline - now)
            return None
        self._open = None
        self._open_keys = 0
        return win

    def _flush_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed and self._open is None:
                    return
                if self._closed and self._open is not None:
                    win, self._open = self._open, None
                else:
                    win = self._take_window_locked()
                    if win is None:
                        continue
            self._flush(win)

    def _flush(self, win: _Window) -> None:
        # the flush gets its own flow id; the span's ``flows`` list names
        # the merged requests, and the store's pull step submitted inside
        # correlates to the flush (the executor captures the active flow)
        fid = telemetry_spans.maybe_new_flow()

        def pull_union():
            union = np.unique(np.concatenate(win.keys))
            ts = self.store.pull(self.store.request(channel=self.channel), keys=union)
            return union, _host(self.store.wait_pull(ts))

        try:
            if fid is not None:
                with telemetry_spans.flow_scope(fid):
                    with telemetry_spans.span("serve.coalesce.flush", merged=win.n_requests,
                                              flows=list(win.flows)):
                        union, values = pull_union()
            else:  # tracing off: no span machinery on the flush path
                union, values = pull_union()
            win.union = union
            win.values = values
            with self._cv:
                self.submits_total += 1
                self.union_keys_total += len(union)
            tel = self._tel()
            if tel is not None:
                tel["coalesce_submits"].inc()
                tel["coalesce_merged_requests"].inc(win.n_requests)
                tel["coalesce_union_keys"].inc(len(union))
        except BaseException as e:  # publish; every waiter re-raises
            win.error = e
        finally:
            win.done.set()

    def close(self) -> None:
        """Flush whatever is staged, stop and join the flusher."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=60)

    # -- introspection (the serve bench's coalescing-win numbers) --

    def stats(self) -> dict:
        with self._cv:
            req = self.requests_total
            sub = self.submits_total
            return {
                "requests": req,
                "submits": sub,
                "submits_per_request": round(sub / req, 4) if req else None,
                "requested_keys": self.requested_keys_total,
                "union_keys": self.union_keys_total,
                "key_dedup_factor": round(
                    self.requested_keys_total
                    / max(1, self.union_keys_total), 3
                ),
            }
