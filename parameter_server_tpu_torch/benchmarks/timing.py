"""The one kernel timer of the port's scripts: CUDA events on a cold L2,
with a spin queued before the start event.

``chip_smoke.py``, :mod:`.flash_ab`, :mod:`.ftrl_ab` and :mod:`.segment_ab`
import :func:`median_ms` from here.

Each rep: write 256 MB (the 50 MB L2 then holds nothing of the timed
inputs), queue a spin on the card (``torch.cuda._sleep``), record the
start event, run ``fn``, record the end event, wait for it. The spin
keeps the card busy while the host records the start event and launches
``fn``: the start event is reached only after the spin, by which time
``fn``'s launches are queued behind it, so the host's launch gap (a
loaded host takes 7-15 us a launch, more when it is descheduled) cannot
fall between the two events. Without the spin the card drains the flush,
reaches the start event and waits there for ``fn``'s first launch, and
that wait is read as ``fn``'s time
(``tests/test_torch_kernels_cuda.py::test_timer_keeps_a_host_delay_out``
shows both).

The spin is sized from the host: the median host time of one ``fn()``
call, taken over the warm-up calls (each waited for), times
``SPIN_MARGIN``, and never under ``SPIN_MIN_US``. ``torch.cuda._sleep``
counts clock cycles; their rate is calibrated once a process with CUDA
events.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

REPS, WARMUP = 20, 3
SPIN_MARGIN = 4.0
SPIN_MIN_US = 100.0
FLUSH_BYTES = 256 << 20

_flush_buf = None
_cycles_per_us = None


def flush_l2() -> None:
    """Write 256 MB so that the 50 MB L2 holds nothing of the timed
    inputs: on the main paths other kernels run between two calls."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    _flush_buf.fill_(1)


def cycles_per_us() -> float:
    """Clock cycles a microsecond of ``torch.cuda._sleep``, measured
    once a process (CUDA events around a spin of 10^6 cycles)."""
    global _cycles_per_us
    if _cycles_per_us is None:
        cycles = 1_000_000
        torch.cuda._sleep(cycles)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _cycles_per_us = cycles / (start.elapsed_time(end) * 1e3)
    return _cycles_per_us


def host_us(fn, calls: int) -> float:
    """Median host microseconds of one ``fn()`` call over ``calls`` calls,
    the card waited for after each, outside the clock."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def times_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> "list[float]":
    """Device milliseconds of ``fn`` in each of ``reps`` timed calls, each
    on a cold L2 behind a spin sized from ``fn``'s host time."""
    launch_us = host_us(fn, warmup)
    spin_cycles = int(max(SPIN_MIN_US, SPIN_MARGIN * launch_us) * cycles_per_us())
    times = []
    for _ in range(reps):
        flush_l2()
        torch.cuda._sleep(spin_cycles)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` calls (:func:`times_ms`)."""
    return float(np.median(times_ms(fn, reps)))

