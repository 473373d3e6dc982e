"""Per-component performance suite of the port.

Counterpart of ``parameter_server_tpu/benchmarks``: the reference's perf
binaries in ``src/test/`` (``kv_vector_perf_ps.cc``, ``kv_map_perf_ps.cc``,
``kv_layer_perf_ps.cc``, ``network_perf_ps.cc``,
``sparse_matrix_perf.cc``) and the planes' probes. Each benchmark times
one subsystem on one device, the card unless the caller names another,
and prints one JSON line per metric: ``{"metric": ..., "value": ...,
"unit": ...}``. The benchmarks live in :mod:`.components`, which this
module does not import (the scripts beside it import this module on
every use).

Run all:    python -m parameter_server_tpu_torch.benchmarks [--smoke] [--device cpu]
Run one:    python -m parameter_server_tpu_torch.benchmarks kv_vector [--smoke]

A registered benchmark is ``fn(smoke: bool = False, device=None)``;
``device=None`` is the card, and raises when there is none.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional

from ..telemetry.device import FLOPS_PEAK_TFLOPS, HBM_PEAK_GB_S

__all__ = ["REGISTRY", "benchmark", "report", "timeit", "peak", "HBM_PEAK_GB_S",
           "FLOPS_PEAK_TFLOPS"]

REGISTRY: Dict[str, Callable[..., object]] = {}


def benchmark(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn

    return deco


def report(metric: str, value: float, unit: str) -> None:
    """Print one metric line (on rank 0 alone inside a world)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return
    print(json.dumps({"metric": metric, "value": round(value, 2), "unit": unit}), flush=True)


def peak(table: Dict[str, float], device) -> Optional[float]:
    """``table``'s entry for ``device``'s card (``HBM_PEAK_GB_S`` or
    ``FLOPS_PEAK_TFLOPS``), keyed by ``torch.cuda.get_device_name``. The
    CPU and cards the table does not know give None: a share of the
    peak is then reported as null, never faked."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return table.get(torch.cuda.get_device_name(device))


def timeit(fn, n: int, warmup: int = 3, budget_s: float = 90.0) -> float:
    """Lower median of up to 3 windows of up to ``n`` calls; seconds a
    call on the host clock. ``fn`` must wait for its own device work.

    One call warms up; a second estimates the cost of a call, from which
    ``n`` is cut so that the three windows fit ``budget_s``; the wall
    clock bounds the whole measurement. With 2 windows (a budget break)
    the lower median is the faster one: a stalled window must not become
    the reported rate."""
    t_start = time.perf_counter()
    fn()  # always warm at least once (allocator and kernel caches)
    # the cost of a call from a second call: the first builds and caches
    t1 = time.perf_counter()
    fn()
    per = max(time.perf_counter() - t1, 1e-9)
    for _ in range(warmup - 2):
        if time.perf_counter() - t_start > budget_s / 4:
            break
        fn()
    n_eff = max(1, min(n, int(budget_s / (3 * per)) or 1))
    times = []
    t_meas = time.perf_counter()
    for _ in range(3):
        w0 = time.perf_counter()
        for _ in range(n_eff):
            fn()
        times.append((time.perf_counter() - w0) / n_eff)
        if time.perf_counter() - t_meas > budget_s:
            break
    return sorted(times)[(len(times) - 1) // 2]
