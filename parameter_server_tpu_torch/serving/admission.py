"""Admission control: token bucket + queue-depth shedding.

Counterpart of ``parameter_server_tpu/serving/admission.py``, its shed
counters included (``ps_serve_shed_total{reason=...}``). The serving plane's overload story (doc/SERVING.md): an open-loop
client population does not slow down when the server does, so without
admission control the request queue — and therefore p99 — grows without
bound the moment offered load crosses capacity. The controller bounds
both: a token bucket caps the sustained accept rate (with a burst
allowance for arrival jitter), and a queue-depth gate sheds when the
backlog already exceeds what the latency SLO could absorb. Rejections
are EXPLICIT (:class:`RejectedError`, the HTTP-429 analog, carrying a
``retry_after_s`` hint) — a shed request costs microseconds; an
admitted request that can't meet its deadline costs a client timeout.

The reference server throttles through its bounded-delay message
clocks (executor.cc); serving inverts the direction: the clock bounds
how far the TRAINER may run ahead, the bucket bounds how fast CLIENTS
may push in.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class RejectedError(Exception):
    """Explicit 429-style rejection. ``reason`` is ``"rate"`` (token
    bucket empty) or ``"queue"`` (backlog past ``max_queue_depth``);
    ``retry_after_s`` is the earliest time a retry could be admitted
    (rate) or a heuristic backoff (queue)."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(
            f"request shed ({reason}); retry after {retry_after_s:.3f}s"
        )
        self.reason = reason
        self.retry_after_s = retry_after_s


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap.

    ``try_acquire`` never blocks — admission control sheds instead of
    queueing at the rate limiter (queueing is the failure mode this
    exists to bound). ``clock`` is injectable so tests are
    deterministic; production uses ``time.monotonic``.
    """

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)  # guarded-by: _lock
        self._last = clock()  # guarded-by: _lock
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:  # holds-lock: _lock
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now

    def try_acquire(self, n: float = 1.0) -> Optional[float]:
        """Take ``n`` tokens. Returns None on success, else the seconds
        until ``n`` tokens will have refilled (the retry-after hint)."""
        with self._lock:
            # clock sampled INSIDE the lock: two concurrent callers
            # sampling outside could apply refills with out-of-order
            # timestamps, rewinding _last and re-crediting the same
            # interval
            self._refill_locked(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return None
            return (n - self._tokens) / self.rate

    def available(self) -> float:
        with self._lock:
            self._refill_locked(self._clock())
            return self._tokens


class AdmissionController:
    """The serving door: rate gate, then backlog gate.

    ``depth_fn`` reports the current backlog the latency SLO must
    absorb (e.g. ``executor.pending_count`` for a bare store; the
    frontend does NOT use it — its depth bounds are per-lane and
    check-and-reserve atomically inside ``submit()``, which a read-only
    callback sampled outside the enqueue lock cannot do). Order
    matters: the rate gate runs FIRST so a sustained overload drains
    tokens and sheds cheaply before the backlog ever builds — the
    queue gate is the safety net for slow-request pileups below the
    rate cap (a decode burst behind a device stall).

    ``rate <= 0`` disables the bucket (queue gate only); ``max_queue_depth
    <= 0`` disables the queue gate. Thread-safe; counters live in the
    telemetry registry (``ps_serve_shed_total{reason=...}``).
    """

    def __init__(
        self,
        rate: float = 0.0,
        burst: float = 1.0,
        max_queue_depth: int = 0,
        depth_fn: Optional[Callable[[], int]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.bucket = (
            TokenBucket(rate, max(1.0, burst), clock) if rate > 0 else None
        )
        self.max_queue_depth = int(max_queue_depth)
        self.depth_fn = depth_fn
        from ..telemetry.instruments import cached_serve_instruments

        self._tel = cached_serve_instruments

    def queue_retry_s(self, depth: int) -> float:
        """Retry-after hint for a queue shed: the backlog drains at
        ~the admitted rate, so tell the client to come back after its
        share of it (capped; 50ms when no rate gate is configured).
        Shared by the depth gate here and the frontend's per-lane
        check-and-reserve gates, so both lanes quote the same
        heuristic."""
        rate = self.bucket.rate if self.bucket is not None else 0.0
        return min(depth / rate, 5.0) if rate > 0 else 0.05

    def admit(self, cost: float = 1.0) -> None:
        """Admit one request (``cost`` tokens) or raise
        :class:`RejectedError`. Success returns None and consumes the
        tokens; the caller owns the request from here."""
        if self.bucket is not None:
            retry = self.bucket.try_acquire(cost)
            if retry is not None:
                tel = self._tel()
                if tel is not None:
                    tel["shed"].labels(reason="rate").inc()
                raise RejectedError("rate", retry)
        if self.max_queue_depth > 0 and self.depth_fn is not None:
            depth = self.depth_fn()
            if depth >= self.max_queue_depth:
                tel = self._tel()
                if tel is not None:
                    tel["shed"].labels(reason="queue").inc()
                raise RejectedError("queue", self.queue_retry_s(depth))
