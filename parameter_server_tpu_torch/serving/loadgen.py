"""Open-loop Poisson load generator + latency recorder.

A copy of ``parameter_server_tpu/serving/loadgen.py``: the same
arrivals from the same seed and the same record keys.

Closed-loop load tests lie about tail latency: when the server slows,
a closed-loop client slows WITH it (it waits for each response before
sending the next request), so the measured p99 flatters the server
exactly when it is failing. Production traffic is open-loop — arrivals
are a Poisson process that does not care how the last request went —
so the bench schedules arrivals from pre-drawn exponential gaps and
fires them on time whether or not earlier requests completed
(coordinated-omission-free: a stalled server faces the full backlog).

``open_loop_bench`` returns the dict of one offered-load point (the
serve CLI's ``serve_open_loop_point`` record): offered vs accepted
vs completed rates (goodput), shed counts by reason, and
p50/p90/p99/p99.9/max completion latency. Determinism: arrivals come
from ``np.random.default_rng(seed)``; wall-clock scheduling is the only
nondeterminism left (disclosed via ``achieved_offered_rate``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List

import numpy as np

from .admission import RejectedError


@dataclasses.dataclass
class LatencyStats:
    n: int
    p50_ms: float
    p90_ms: float
    p99_ms: float
    p999_ms: float
    max_ms: float

    @staticmethod
    def from_seconds(lat_s: "np.ndarray | List[float]") -> "LatencyStats":
        lat = np.asarray(lat_s, dtype=np.float64) * 1e3
        if lat.size == 0:
            return LatencyStats(0, 0.0, 0.0, 0.0, 0.0, 0.0)
        q = np.percentile(lat, [50, 90, 99, 99.9])
        return LatencyStats(
            n=int(lat.size),
            p50_ms=round(float(q[0]), 3),
            p90_ms=round(float(q[1]), 3),
            p99_ms=round(float(q[2]), 3),
            p999_ms=round(float(q[3]), 3),
            max_ms=round(float(lat.max()), 3),
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def open_loop_bench(
    frontend,
    make_request: Callable[[int], object],
    rate: float,
    duration_s: float,
    seed: int = 0,
    collectors: int = 4,
    warmup_requests: int = 0,
) -> dict:
    """Drive ``frontend`` with Poisson arrivals at ``rate`` req/s for
    ``duration_s``; returns the offered-load point's record dict.

    ``make_request(i)`` builds the i-th request (vary keys per call for
    realistic overlap patterns). Completion latencies are collected by
    ``collectors`` waiter threads so slow completions never block the
    arrival schedule (the open-loop contract). ``warmup_requests``
    issues that many requests closed-loop first, excluded from stats
    (compile/caches must not pollute the tail)."""
    for i in range(warmup_requests):
        try:
            frontend.submit(make_request(i)).result(timeout=120)
        except RejectedError:
            pass

    rng = np.random.default_rng(seed)
    n_planned = max(1, int(rate * duration_s * 1.5))
    gaps = rng.exponential(1.0 / rate, size=n_planned)
    arrivals = np.cumsum(gaps)

    tickets: List[object] = []  # guarded-by: tickets_lock
    tickets_lock = threading.Lock()
    done_collecting = threading.Event()
    latencies: List[float] = []  # guarded-by: tickets_lock
    errors: List[str] = []  # guarded-by: tickets_lock

    def collect():
        while True:
            with tickets_lock:
                t = tickets.pop() if tickets else None
            if t is None:
                if done_collecting.is_set():
                    return
                time.sleep(0.0005)
                continue
            try:
                t.result(timeout=120)
                with tickets_lock:
                    latencies.append(t.latency_s())
            except BaseException as e:  # collected, not raised: the
                # bench must report a failing server, not crash on it
                with tickets_lock:
                    errors.append(f"{type(e).__name__}: {e}")

    threads = [
        threading.Thread(target=collect, name=f"serve-collect-{i}",
                         daemon=True)
        for i in range(collectors)
    ]
    for t in threads:
        t.start()

    shed_rate = shed_queue = submitted = 0
    t0 = time.perf_counter()
    for i, due in enumerate(arrivals):
        if due > duration_s:
            break
        now = time.perf_counter() - t0
        if due > now:
            time.sleep(due - now)
        # behind schedule: fire immediately (open-loop catch-up — the
        # arrival process does not thin out because the host is busy)
        try:
            ticket = frontend.submit(make_request(i))
            submitted += 1
            with tickets_lock:
                tickets.append(ticket)
        except RejectedError as e:
            if e.reason == "rate":
                shed_rate += 1
            else:
                shed_queue += 1
    offered = submitted + shed_rate + shed_queue
    elapsed_submit = time.perf_counter() - t0
    done_collecting.set()
    for t in threads:
        t.join(timeout=180)
    elapsed = time.perf_counter() - t0

    stats = LatencyStats.from_seconds(latencies)
    return {
        "offered_rate": round(rate, 1),
        "achieved_offered_rate": round(offered / elapsed_submit, 1),
        "duration_s": round(elapsed, 3),
        "offered": offered,
        "accepted": submitted,
        "completed": stats.n,
        "shed_rate": shed_rate,
        "shed_queue": shed_queue,
        "shed_frac": round((shed_rate + shed_queue) / max(1, offered), 4),
        "goodput_per_sec": round(stats.n / elapsed, 1),
        "latency_ms": stats.as_dict(),
        "errors": errors[:5],
        "n_errors": len(errors),
    }
