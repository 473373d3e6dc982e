"""What a segment sum needs, counted from its inputs: bytes, and the
serial floor that bit equality sets.

Shared by ``chip_smoke.py`` and :mod:`.segment_ab`; the counts are plain
PyTorch on tensors of any device, no card needed. :func:`add_latency`
measures on the card the one number the floor takes from it.

- ``bytes``: the ids read once (4 B an entry), the nonzero values read
  once (4 B each) and the sums written once (4 B a segment);
- ``longest``: the longest run of nonzero entries, the most nonzero
  entries that one segment holds. Each segment's sum is added in entry
  order from +0.0 (the card's sums equal the CPU's ``index_add_`` bit for
  bit), so its adds depend on each other: however many threads feed it,
  a segment takes one dependent add a nonzero entry;
- the serial floor: ``longest`` times the latency of one dependent f32
  add, which :func:`add_latency` times on the card with one thread's
  chain of ``__fadd_rn`` (clock cycles by ``clock64``, nanoseconds by the
  global timer, so the SM clock of the run comes with it).

The bound is the larger of the bytes' time at 3.35 TB/s and the serial
floor.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
ADDS = 1 << 20  # the probe's chain: ~2 ms at ~4 cycles an add


def counts(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> dict:
    """Entries, nonzero entries, bytes and the longest run of nonzero
    entries of ``segment_sum(data, ids, num_segments)``."""
    live = data != 0
    held = ids[live].to(torch.int64)
    held = held[(held >= 0) & (held < num_segments)]
    longest = int(torch.bincount(held).max()) if held.numel() else 0
    m, nz = data.numel(), int(live.sum())
    return dict(entries=m, live=nz, segments=num_segments, longest=longest,
                bytes=4 * m + 4 * nz + 4 * num_segments)


def ms(nbytes: float) -> float:
    """Milliseconds to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def serial_floor_ms(longest: int, ns_per_add: float) -> float:
    return longest * ns_per_add * 1e-6


def bound(need: dict, ns_per_add: float):
    """``(ms, "bytes" | "operations")``: the larger of the bytes' time and
    the serial floor (a chain of operations)."""
    t_bytes, t_chain = ms(need["bytes"]), serial_floor_ms(need["longest"], ns_per_add)
    return (t_bytes, "bytes") if t_bytes >= t_chain else (t_chain, "operations")


def add_latency(adds: int = ADDS, device: str = "cuda") -> dict:
    """One thread's chain of ``adds`` dependent ``__fadd_rn`` on the card
    (``segment_sum_add_latency`` in ``kernels/csrc/segment_sum.cu``, built
    as the kernel is): clock cycles and nanoseconds an add, and the SM
    clock they imply."""
    from .. import kernels

    fn = kernels.library("segment_sum").segment_sum_add_latency
    inp = torch.tensor([0.0, 1e-30], device=device)
    out = torch.empty(1, device=device)
    t = torch.empty(2, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for _ in range(2):  # the first call warms the clocks
        kernels.check(fn(inp.data_ptr(), out.data_ptr(), t.data_ptr(), adds, stream),
                      "segment_sum_add_latency")
    cycles, ns = (int(v) for v in t.cpu())
    return dict(adds=adds, cycles_per_add=cycles / adds, ns_per_add=ns / adds,
                sm_clock_mhz=cycles / ns * 1e3)
