"""ServeFrontend: the request-path composition.

One object owns the serving door for a table (and optionally an LM):

    client threads ──submit()──► admission gate ──► bounded work queue
                                     │ RejectedError (429)   │
                                     ▼                       ▼
                               shed counters        worker pool (N)
                                                     │        │
                                       replica gather│        │decode worker
                                     (hot hit, host) │        │(speculative)
                                                     ▼        ▼
                                            coalescer (misses/no-replica)
                                                     │ one executor submit
                                                     ▼ per window
                                               live table pull

Requests are typed (:class:`PullRequest` — raw rows;
:class:`PredictRequest` — sparse logistic margins over pulled weights;
:class:`DecodeRequest` — LM generation through a caller-supplied
``decode_fn``, normally ``models.speculative.speculative_generate``).
``submit`` is non-blocking: it either raises :class:`RejectedError`
at the door or returns a :class:`Ticket` whose ``result()`` waits for
a worker to complete the request. Latency is measured submit→complete
— the number the open-loop bench quotes as p50/p99.

Elasticity: :meth:`pause` gates the workers (admitted requests keep
queueing; the admission depth gate sheds past the bound — never an
error), :meth:`quiesce` waits out in-flight executions, and
:meth:`rebind` points the frontend at another store.

Counterpart of ``parameter_server_tpu/serving/frontend.py``, with its
request spans and flow ids (``serve.submit`` / ``serve.execute`` or
``serve.decode`` / ``serve.reply`` while a span sink is installed), its
``ps_serve_*`` counters, and the diagnostic bundle a degraded failure
triggers (``blackbox.trigger_bundle``). ``stats()`` carries every count
the frontend keeps itself. A decode result is returned as a host array
(int64 tokens).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .admission import AdmissionController, RejectedError  # noqa: F401  (re-export: the door's exception belongs to the frontend API)
from .coalescer import PullCoalescer
from .replica import ReadReplica
from ..system import faults
from ..telemetry import spans as telemetry_spans
from ..utils.retry import DeadlineExceeded


class DegradedError(Exception):
    """503-style failure degradation — DISTINCT from the admission 429
    (:class:`~.admission.RejectedError`). A shed says "you sent too
    much, back off and retry"; degraded says "the live store is dead or
    past its deadline AND the stale-read fallback could not answer"
    (no replica, staleness past the bound, or keys outside its
    coverage). Separately observable on purpose: overload shedding and
    failure degradation need different operator responses.

    ``reason`` is ``"no-replica"`` | ``"stale"`` | ``"replica-miss"``.
    """

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(
            f"live store unavailable and degraded path cannot serve "
            f"({reason})" + (f": {detail}" if detail else "")
        )
        self.reason = reason


@dataclasses.dataclass
class PullRequest:
    """Raw rows for ``keys`` (global int64 key ids)."""

    keys: np.ndarray
    channel: int = 0


@dataclasses.dataclass
class PredictRequest:
    """Sparse logistic scores: CSR rows over global keys; the response
    is ``sigmoid(sum_j w[key_ij])`` per row (the binary-feature CTR
    predict of the reference's linear apps)."""

    indices: np.ndarray  # [nnz] global keys
    indptr: np.ndarray  # [rows + 1]
    channel: int = 0


@dataclasses.dataclass
class DecodeRequest:
    """LM generation; executed by the frontend's ``decode_fn`` on the
    dedicated decode worker (heavy requests must not head-of-line-block
    the microsecond pull lane)."""

    prompt: np.ndarray  # [B, P] int32
    steps: int
    prompt_lengths: Optional[np.ndarray] = None
    eos_id: Optional[int] = None


@dataclasses.dataclass
class ServeConfig:
    # admission (0 disables a gate)
    admission_rate: float = 0.0  # requests/s sustained
    admission_burst: float = 32.0
    max_queue_depth: int = 1024
    # coalescing
    coalesce_window_s: float = 0.002
    coalesce_max_keys: int = 1 << 16
    coalesce_max_requests: int = 256
    # read replica: "off" (all pulls coalesce to the live table),
    # "full" (whole-table snapshot), "hot" with hot_keys set, or
    # "fallback" — a full snapshot that is NOT consulted on the happy
    # path (reads stay live/fresh through the coalescer) and serves
    # only as the degraded path when the live store fails or misses
    # its deadline (degraded-mode serving)
    replica: str = "full"
    hot_keys: Optional[np.ndarray] = None
    replica_refresh_s: Optional[float] = None  # None = manual refresh()
    # device-resident replica (serving/replica.py): keep the snapshot
    # as a tensor on the card and serve reads as gathers there —
    # replica capacity scales with the card's memory, not host RAM. The host budget
    # bounds what a HOST-mode replica may pin (a refresh past it fails
    # loudly); device mode ignores it by design
    replica_device: bool = False
    replica_host_budget_bytes: Optional[int] = None
    # worker pool (pull/predict lane) — decode gets its own worker
    workers: int = 2
    # degraded-mode serving: a live (coalesced) pull that raises — or
    # exceeds live_pull_deadline_s (0 = no deadline) — falls back to
    # the read replica IF its snapshot is younger than
    # degraded_max_staleness_s; otherwise the request fails with the
    # 503-style DegradedError (vs the admission 429). The staleness
    # bound is deliberately FINITE by default: an unbounded default
    # would let a forgotten config serve arbitrarily old parameters
    # forever with only a counter to notice — a store outage must
    # become loud within a bounded window, not silently stale
    live_pull_deadline_s: float = 0.0
    degraded_max_staleness_s: float = 60.0


class Ticket:
    """One admitted request's completion handle. ``flow`` is the
    request's timeline flow id when a span sink is installed: submit,
    execution, coalesced pull, executor step and reply all correlate
    through it."""

    __slots__ = ("_done", "value", "error", "t_submit", "t_done", "kind", "flow")

    def __init__(self, kind: str, flow: Optional[int] = None):
        self._done = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_done = 0.0
        self.kind = kind
        self.flow = flow

    def _complete(self, value=None, error=None) -> None:
        self.value = value
        self.error = error
        self.t_done = time.perf_counter()
        self._done.set()

    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            # explicit deadline semantics (utils/retry.py): still a
            # TimeoutError for legacy callers, but diagnosable
            raise DeadlineExceeded(
                f"{self.kind} request did not complete within "
                f"{timeout}s (submitted "
                f"{time.perf_counter() - self.t_submit:.3f}s ago)",
                op=f"serve:{self.kind}", deadline_s=timeout,
            )
        if self.error is not None:
            raise self.error
        return self.value


class ServeFrontend:
    """Concurrent serving sessions against one store channel (+ LM).

    ``store`` follows the KVVector protocol; ``decode_fn(req) -> array``
    (if given) enables :class:`DecodeRequest`. ``start()`` spins the
    worker pool; ``close()`` drains and joins every thread the frontend
    started.
    """

    def __init__(
        self,
        store,
        config: Optional[ServeConfig] = None,
        channel: int = 0,
        decode_fn: Optional[Callable[[DecodeRequest], np.ndarray]] = None,
        batcher=None,
    ):
        self.cfg = config or ServeConfig()
        self.store = store
        self.channel = int(channel)
        if decode_fn is not None and batcher is not None:
            raise ValueError(
                "pass decode_fn (one sequential call per request) OR "
                "batcher (continuous batching), not both"
            )
        self.decode_fn = decode_fn
        # serving/batcher.py ContinuousBatcher: the decode worker
        # becomes its single-owner scheduler thread (_batch_loop)
        self.batcher = batcher
        self._cv = threading.Condition()
        self._queue: deque = deque()  # guarded-by: _cv — pull/predict lane
        self._decode_queue: deque = deque()  # guarded-by: _cv
        # per-LANE in-flight counts (admitted, not completed): each
        # lane carries its own max_queue_depth bound (submit()) — a
        # decode backlog shedding microsecond pulls, or pull overload
        # starving decodes, would reintroduce exactly the head-of-line
        # coupling the dedicated decode worker removes
        self._in_flight = 0  # guarded-by: _cv — pull/predict lane
        self._in_flight_decode = 0  # guarded-by: _cv — decode lane
        self._executing = 0  # guarded-by: _cv — popped, running right now
        self._paused = False  # guarded-by: _cv — stop-the-world gate
        self._closed = False  # guarded-by: _cv
        self._threads: list = []
        self._refresher: Optional[threading.Thread] = None
        self._stop_refresh = threading.Event()
        self.completed = 0  # guarded-by: _cv
        # rate gate only: the depth bounds are PER-LANE and owned by
        # submit() (check+reserve in one critical section), not by the
        # controller's shared depth_fn hook — one shared count would
        # couple the lanes, and a depth_fn read outside the enqueue
        # lock would let concurrent submits overshoot the bound
        self.admission = AdmissionController(
            rate=self.cfg.admission_rate,
            burst=self.cfg.admission_burst,
        )
        # replica config is validated (and its first refresh runs)
        # BEFORE the coalescer exists: PullCoalescer starts its flusher
        # thread in its constructor, so raising after building it would
        # leak a live thread with no close() to ever reach it
        self.replica: Optional[ReadReplica] = None
        if self.cfg.replica == "hot":
            if self.cfg.hot_keys is None:
                raise ValueError("replica='hot' needs ServeConfig.hot_keys")
            self.replica = ReadReplica(
                store, channel, hot_keys=self.cfg.hot_keys,
                device=self.cfg.replica_device,
                host_budget_bytes=self.cfg.replica_host_budget_bytes,
            )
        elif self.cfg.replica in ("full", "fallback"):
            self.replica = ReadReplica(
                store, channel,
                device=self.cfg.replica_device,
                host_budget_bytes=self.cfg.replica_host_budget_bytes,
            )
        elif self.cfg.replica != "off":
            raise ValueError(
                f"ServeConfig.replica must be 'off'|'full'|'hot'|"
                f"'fallback', got {self.cfg.replica!r}"
            )
        self.degraded_served = 0  # guarded-by: _cv — stale-replica answers
        self.coalescer = PullCoalescer(
            store,
            channel=channel,
            window_s=self.cfg.coalesce_window_s,
            max_keys=self.cfg.coalesce_max_keys,
            max_requests=self.cfg.coalesce_max_requests,
        )
        from ..telemetry.instruments import cached_serve_instruments

        self._tel = cached_serve_instruments

    # -- lifecycle --

    def start(self) -> "ServeFrontend":
        if self._threads:
            return self
        for i in range(max(1, self.cfg.workers)):
            t = threading.Thread(
                target=self._worker_loop, args=(self._queue,),
                name=f"serve-worker-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        if self.batcher is not None:
            # the continuous batcher's single-owner scheduler: same
            # thread name and lane, different loop — it multiplexes the
            # whole decode queue into one running speculative call
            t = threading.Thread(
                target=self._batch_loop, name="serve-decode", daemon=True,
            )
            t.start()
            self._threads.append(t)
        elif self.decode_fn is not None:
            t = threading.Thread(
                target=self._worker_loop, args=(self._decode_queue,),
                name="serve-decode", daemon=True,
            )
            t.start()
            self._threads.append(t)
        if self.cfg.replica_refresh_s and self.replica is not None:
            self._refresher = threading.Thread(
                target=self._refresh_loop, name="serve-replica-refresh",
                daemon=True,
            )
            self._refresher.start()
        return self

    def close(self) -> None:
        """Drain queued work (closing un-pauses), then join every
        thread the frontend started."""
        with self._cv:
            self._closed = True
            self._paused = False  # workers must drain, not strand
            self._cv.notify_all()
        self._stop_refresh.set()
        for t in self._threads:
            t.join(timeout=60)
        self._threads = []
        if self._refresher is not None:
            self._refresher.join(timeout=60)
            self._refresher = None
        self.coalescer.close()

    # -- pause, quiesce, rebind, resume --

    def pause(self) -> None:
        """Gate the workers: admitted requests queue (and shed past the
        admission depth bound) instead of touching a store that is
        being swapped. In-flight executions finish against the old
        store — :meth:`quiesce` waits them out."""
        with self._cv:
            self._paused = True

    def quiesce(self, timeout: float = 30.0) -> None:
        """Block until no worker is mid-execution (call after
        :meth:`pause`, before tearing down the old store)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._executing > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("serve workers did not quiesce")
                self._cv.wait(left)

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def rebind(self, store, refresh_replica: bool = True) -> None:
        """Point the frontend at another store (in the JAX package, the
        post-resize store of an elastic resize; key→slot hashing is
        stable, so requests queued across the pause stay valid). Call
        between :meth:`pause`/:meth:`quiesce`
        and :meth:`resume`."""
        old = self.coalescer
        self.store = store
        self.coalescer = PullCoalescer(
            store,
            channel=self.channel,
            window_s=self.cfg.coalesce_window_s,
            max_keys=self.cfg.coalesce_max_keys,
            max_requests=self.cfg.coalesce_max_requests,
        )
        old.close()
        if self.replica is not None:
            self.replica.store = store
            if refresh_replica:
                self.replica.refresh()

    # -- the door --

    def depth(self) -> int:
        """The PULL/PREDICT lane's backlog: admitted, uncompleted
        requests (queued + executing). The decode lane is bounded
        separately (same-sized, in :meth:`submit`) — one shared count
        would let a slow-decode pileup shed the microsecond pull
        traffic at the door."""
        with self._cv:
            return self._in_flight

    def _queue_retry_s(self, depth: int) -> float:
        # the admission controller's drain-rate heuristic, applied to
        # this lane's depth (serving/admission.py queue_retry_s)
        return self.admission.queue_retry_s(depth)

    def submit(self, req) -> Ticket:
        """Admit and enqueue one request; raises
        :class:`~.admission.RejectedError` (the 429) at the door."""
        if (
            isinstance(req, DecodeRequest)
            and self.decode_fn is None
            and self.batcher is None
        ):
            raise ValueError(
                "this frontend has no decode lane (decode_fn or batcher)"
            )
        if getattr(req, "channel", self.channel) != self.channel:
            # one frontend serves ONE channel (its replica and
            # coalescer are bound to it); silently answering another
            # channel's request with this channel's rows would be a
            # wrong-data bug, so reject loudly — stand up a frontend
            # per served channel instead
            raise ValueError(
                f"this frontend serves channel {self.channel}, got a "
                f"request for channel {req.channel}"
            )
        decode = isinstance(req, DecodeRequest)
        with self._cv:
            # closed-check BEFORE the admission gate: a submit racing
            # close() must not burn tokens (or count as admitted) for a
            # request that can never enqueue
            if self._closed:
                raise RuntimeError("ServeFrontend is closed")
            # per-LANE depth gate, check AND reserve in this ONE
            # critical section: each lane takes the same-sized bound
            # against its own backlog (a shared count would let a
            # decode pileup shed microsecond pulls — and vice versa),
            # and checking in one section then reserving in another
            # would let concurrent submits overshoot the bound by the
            # submitter count. The reservation is released below on any
            # rejection between here and enqueue.
            lane = self._in_flight_decode if decode else self._in_flight
            if 0 < self.cfg.max_queue_depth <= lane:
                tel = self._tel()
                if tel is not None:
                    tel["shed"].labels(reason="queue").inc()
                raise RejectedError("queue", self._queue_retry_s(lane))
            if decode:
                self._in_flight_decode += 1
            else:
                self._in_flight += 1
        try:
            self.admission.admit()  # rate gate (depth owned above)
        except BaseException:
            with self._cv:
                if decode:
                    self._in_flight_decode -= 1
                else:
                    self._in_flight -= 1
            raise
        kind = (
            "pull" if isinstance(req, PullRequest)
            else "predict" if isinstance(req, PredictRequest)
            else "decode"
        )
        fid = telemetry_spans.maybe_new_flow()
        ticket = Ticket(kind, flow=fid)
        if fid is not None:
            # zero-duration submit marker: the gap to the execute span is
            # the request's queue wait in the timeline
            telemetry_spans.emit({"kind": "span", "name": "serve.submit", "t_wall": time.time(),
                                  "dur_s": 0.0, "flow": fid, "req": kind})
        tel = self._tel()
        with self._cv:
            if self._closed:  # closed during admit: nothing enqueued
                if decode:
                    self._in_flight_decode -= 1
                else:
                    self._in_flight -= 1
                raise RuntimeError("ServeFrontend is closed")
            if decode:
                self._decode_queue.append((req, ticket))
            else:
                self._queue.append((req, ticket))
            depth = self._in_flight + self._in_flight_decode
            self._cv.notify_all()
        # counted only once the request is really enqueued, so
        # requests_total reconciles with tickets issued
        if tel is not None:
            tel["requests"].labels(kind=kind).inc()
            tel["queue_depth"].set(depth)
        return ticket

    # -- workers --

    def _worker_loop(self, queue: deque) -> None:
        decode_lane = queue is self._decode_queue
        while True:
            with self._cv:
                while (not queue or self._paused) and not self._closed:
                    self._cv.wait()
                if not queue:  # closed and drained
                    return
                req, ticket = queue.popleft()
                self._executing += 1
            try:
                # a span only when the request carries a flow (a sink was
                # installed at submit): the pull lane pays nothing for
                # tracing that is off
                if ticket.flow is not None:
                    span_name = "serve.decode" if ticket.kind == "decode" else "serve.execute"
                    with telemetry_spans.flow_scope(ticket.flow):
                        with telemetry_spans.span(span_name, req=ticket.kind):
                            value = self._execute(req)
                else:
                    value = self._execute(req)
                err = None
            except BaseException as e:
                value, err = None, e
            ticket._complete(value, err)
            self._reply_marker(ticket, err)
            with self._cv:
                self._executing -= 1
                if decode_lane:
                    self._in_flight_decode -= 1
                else:
                    self._in_flight -= 1
                self.completed += 1
                self._cv.notify_all()
            tel = self._tel()
            if tel is not None:
                tel["latency"].labels(kind=ticket.kind).observe(ticket.latency_s())

    @staticmethod
    def _reply_marker(ticket: Ticket, err) -> None:
        """The reply marker: completion handed back to the waiter, which
        closes the request's flow in the timeline."""
        if ticket.flow is None:
            return
        event = {"kind": "span", "name": "serve.reply", "t_wall": time.time(), "dur_s": 0.0,
                 "flow": ticket.flow, "latency_s": ticket.latency_s(), "req": ticket.kind}
        if err:
            event["error"] = type(err).__name__
        telemetry_spans.emit(event)

    def _finish_decode_ticket(self, ticket: Ticket, value, err) -> None:
        """Completion bookkeeping for one batched decode request —
        the tail of _worker_loop, factored out for _batch_loop (which
        completes tickets at round boundaries, not per pop)."""
        ticket._complete(value, err)
        self._reply_marker(ticket, err)
        with self._cv:
            self._in_flight_decode -= 1
            self.completed += 1
            self._cv.notify_all()
        tel = self._tel()
        if tel is not None:
            tel["latency"].labels(kind=ticket.kind).observe(ticket.latency_s())

    def _batch_loop(self) -> None:
        """The continuous batcher's single-owner scheduler: this thread
        alone calls
        ``batcher.admit_many``/``step_block``. Sessions join at round
        boundaries
        into free slots; finished sessions retire between rounds
        without stalling the rest; requests too wide for the current
        free set wait at the head of the queue (admission sheds past
        the lane depth bound long before that).

        Pause semantics differ from _worker_loop on purpose: ``pause``
        gates NEW joins (the queue holds), but resident sessions keep
        stepping — decode rounds touch only device model state, never
        the store, so serving continues straight through a store
        rebind. Rounds therefore do not count into ``_executing``/:meth:`quiesce`."""
        b = self.batcher
        active = False
        while True:
            admits = []
            with self._cv:
                while (
                    (not self._decode_queue or self._paused)
                    and not self._closed
                    and not active
                ):
                    self._cv.wait()
                if self._closed and not self._decode_queue and not active:
                    return
                if not self._paused or self._closed:  # closing drains
                    free = b.free_slots()
                    while self._decode_queue:
                        req, _t = self._decode_queue[0]
                        try:
                            rows = int(np.asarray(req.prompt).shape[0])
                        except Exception:
                            rows = 1  # malformed: admit() rejects it below
                        if rows > free:
                            break
                        admits.append(self._decode_queue.popleft())
                        free -= rows
            if admits:
                try:
                    # the whole wave joins in ONE fused call (the
                    # per-call join cost dominates admission otherwise)
                    b.admit_many(admits)
                except ValueError:
                    # a malformed request poisons the wave-validate;
                    # re-admit one by one so only the bad ones fail
                    for req, ticket in admits:
                        try:
                            b.admit(req, context=ticket)
                        except BaseException as e:
                            self._finish_decode_ticket(ticket, None, e)
                except BaseException as e:
                    for _req, ticket in admits:
                        self._finish_decode_ticket(ticket, None, e)
            for handle in b.step_block():
                out = handle.out
                tel = self._tel()
                if tel is not None:
                    tel["decode_tokens"].inc(out.shape[0] * int(handle.req.steps))
                self._finish_decode_ticket(handle.context, out, None)
            active = b.active_sessions() > 0

    def _live_pull(self, keys: np.ndarray) -> np.ndarray:
        """One coalesced pull against the live store, bounded by
        ``live_pull_deadline_s``. The ``serve.pull`` fault point sits here — the exact place a dead shard
        manifests to serving — so drills can kill the store path
        without touching the admission door or the replica."""
        # inject() covers both documented kinds: "raise" raises after
        # any delay_s, "stall" sleeps delay_s and falls through
        faults.inject("serve.pull", detail=getattr(self.store, "name", ""))
        deadline = self.cfg.live_pull_deadline_s or None
        return self.coalescer.pull(keys).result(deadline)

    def _degraded_fallback(
        self, keys: np.ndarray, cause: BaseException
    ) -> np.ndarray:
        """The live store failed (or deadlined): serve from the read
        replica when its snapshot is inside the staleness bound and
        covers every key; otherwise raise the 503-style DegradedError.
        Never catches RejectedError — overload sheds are the door's
        verdict, not a store failure to degrade around."""
        tel = self._tel()
        r = self.replica
        reason = None
        if r is None:
            reason, detail = "no-replica", f"live pull failed: {cause}"
        else:
            age = r.age_s()
            if age > self.cfg.degraded_max_staleness_s:
                reason, detail = "stale", (
                    f"replica {age:.1f}s old > "
                    f"{self.cfg.degraded_max_staleness_s}s bound"
                )
        if reason is None:
            vals, hit = r.pull(keys)
            if hit.all():
                with self._cv:
                    self.degraded_served += 1
                if tel is not None:
                    tel["degraded"].labels(outcome="served").inc()
                return vals
            reason, detail = "replica-miss", (
                f"{int((~hit).sum())}/{len(hit)} keys outside the "
                "replica's coverage"
            )
        if tel is not None:
            tel["degraded"].labels(outcome="error").inc()
        # a request the degraded path could not save is a flight-recorder
        # trigger: the last few seconds of spans and metrics are the
        # diagnosis. Best-effort, rate-limited, never alters the error.
        from ..telemetry import blackbox

        blackbox.trigger_bundle("degraded", detail=f"{reason}: {detail}")
        raise DegradedError(reason, detail) from cause

    def _pull_values(self, keys: np.ndarray) -> np.ndarray:
        """The read path (requests for other channels never get here —
        submit rejects them at the door). Modes:

        - replica full/hot: replica first, coalesced live pull for
          misses; a FAILED live pull degrades (hot misses degrade to
          DegradedError — the hot replica cannot cover them);
        - replica fallback: live-first (fresh reads), replica only as
          the degraded path;
        - replica off: live only; failures are DegradedError(no-replica).
        """
        if self.replica is not None and self.cfg.replica != "fallback":
            vals, hit = self.replica.pull(keys)
            if hit.all():
                return vals
            missed = np.asarray(keys)[~hit]
            try:
                miss_vals = self._live_pull(missed)
            except RejectedError:
                raise
            except Exception as e:
                return self._degraded_fallback(keys, e)
            out = np.array(vals)
            out[~hit] = miss_vals
            return out
        try:
            return self._live_pull(keys)
        except RejectedError:
            raise
        except Exception as e:
            return self._degraded_fallback(keys, e)

    def _execute(self, req):
        if isinstance(req, PullRequest):
            return self._pull_values(req.keys)
        if isinstance(req, PredictRequest):
            w = self._pull_values(req.indices)
            seg = np.repeat(
                np.arange(len(req.indptr) - 1), np.diff(req.indptr)
            )
            margins = np.zeros(len(req.indptr) - 1, np.float64)
            np.add.at(margins, seg, w.sum(axis=1))
            return 1.0 / (1.0 + np.exp(-margins))
        if isinstance(req, DecodeRequest):
            out = self.decode_fn(req)
            out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
            tel = self._tel()
            if tel is not None:
                tel["decode_tokens"].inc(out.shape[0] * req.steps)
            return out
        raise TypeError(f"unknown request type {type(req).__name__}")

    # -- replica refresher --

    def _refresh_loop(self) -> None:
        while not self._stop_refresh.wait(self.cfg.replica_refresh_s):
            # the paused check and the _executing claim are ONE critical
            # section: quiesce() waits on _executing, so an in-flight
            # refresh holds the pause→resize sequence back exactly like
            # a worker mid-request does — without this, pause() could
            # pass quiesce() while refresh() is still touching a store
            # the resize is about to tear down
            with self._cv:
                if self._paused:
                    continue
                self._executing += 1
            try:
                self.replica.refresh()
            except Exception:
                # one transient refresh failure must not silently kill
                # the refresher for the rest of the process — the
                # frontend would keep serving an ever-staler snapshot
                # with no signal. Log and retry next tick; persistent
                # failure shows up as a growing replica age_s.
                import logging

                logging.getLogger(__name__).exception(
                    "read-replica refresh failed; retrying next tick"
                )
            finally:
                with self._cv:
                    self._executing -= 1
                    self._cv.notify_all()

    # -- introspection (the serve bench's record fields) --

    def stats(self) -> dict:
        with self._cv:
            completed = self.completed
            in_flight = self._in_flight + self._in_flight_decode
            degraded = self.degraded_served
        out = {
            "completed": completed,
            "in_flight": in_flight,
            "degraded_served": degraded,
            "coalescer": self.coalescer.stats(),
        }
        if self.replica is not None:
            out["replica"] = {
                "version": self.replica.version,
                "age_s": round(self.replica.age_s(), 3),
                "nbytes": self.replica.nbytes(),
                "device": self.replica.device,
            }
        if self.batcher is not None:
            out["batcher"] = self.batcher.stats()
        return out
