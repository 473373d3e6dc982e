"""Deterministic segment sums for the linear step.

Counterpart of ``jax.ops.segment_sum`` as the JAX package's linear step
calls it (``parameter_server_tpu/apps/linear/async_sgd.py``: Xw by row,
the per-slot gradient by slot, the shard gradient by shard slot).

On the card, one algorithm that adds the same numbers in the same order
as the CPU, so both give the same bits, run after run:

1. order the entries by segment with a stable sort (deterministic on
   CUDA too), the entries whose value is zero after the last segment;
2. sum each segment in entry order, starting from +0.0: the hand-written
   CUDA kernel ``segment_sum`` (``kernels/csrc/segment_sum.cu``), whose
   plain version is :func:`segment_sum_sorted_ref`.

The presorted route (``presorted=True``) skips step 1 where the caller's
ids are already grouped. Its contract: each segment's nonzero entries lie
in one run of equal ids (a maximal block of consecutive entries with one
id); zero-valued entries may sit anywhere, in runs of their own or inside
another segment's run. The kernel sums each run from its first nonzero
entry to its end and writes the sum only where the run holds a nonzero
entry, so a run of zeros (a batch's padding at row 0) never overwrites
row 0's sum. Its plain version is :func:`segment_sum_runs_ref`. The
linear step's Xw by row meets the contract by construction (rows in CSR
order, the padding at row 0 with value 0), as does the exact dense
step's shard gradient (sorted unique slots, the padding zero-valued).
A call that breaks it gets a wrong sum on the card: ``chip_smoke.py``
holds every card sum to the CPU's, which does not depend on it.

On the CPU the sum is ``torch.zeros(n).index_add_(0, ids, data)`` on the
entries as they come, on either route: the CPU's ``index_add_`` adds entry
by entry in index order, which is the order above (a stable sort keeps
each segment's entries in index order), and leaving the zeros out changes
no sum, because a sum that starts from +0.0 and rounds to nearest is never
-0.0, and adding +-0.0 to anything else leaves it as it is. So the CPU's
result is an independent reference for the card's bits. (``index_add_``
on the card sums with atomics, in an order that changes from run to run.)
On the sorting route, leaving the zeros out also keeps a batch's padding,
all in one segment, away from the kernel.
"""

from __future__ import annotations

import torch

from .ftrl import _check_cuda


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                presorted: bool = False) -> torch.Tensor:
    """``out[s] = sum of data[i] over segment_ids[i] == s``, ``[num_segments]``
    (float32 on the card), each sum taken in index order from +0.0. Every
    id must lie in ``[0, num_segments)``. ``presorted``: the ids meet the
    presorted route's contract (the module's docstring), and the card skips
    the sort."""
    if data.dim() != 1 or segment_ids.shape != data.shape:
        raise ValueError(f"segment_sum takes 1-D data and ids of one length, got "
                         f"{tuple(data.shape)} and {tuple(segment_ids.shape)}")
    if not 0 <= num_segments < (1 << 31):
        raise ValueError(f"num_segments must be in [0, 2^31), got {num_segments}")
    if data.device.type == "cpu":
        return torch.zeros(num_segments, dtype=data.dtype).index_add_(0, segment_ids, data)
    if presorted:
        return launch_kernel(data, segment_ids.to(torch.int32), num_segments)
    return launch_kernel(*sort_by_segment(data, segment_ids, num_segments), num_segments)


def sort_by_segment(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """Step 1: ``(values, int32 ids)`` ordered by segment with a stable
    sort, the zero values given id ``num_segments`` (after the last
    segment)."""
    keys = torch.where(data != 0, segment_ids.to(torch.int32), num_segments)
    ids, order = torch.sort(keys, stable=True)
    return data.index_select(0, order), ids


def segment_sum_sorted_ref(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version of the kernel on sorted ``ids``: the sums of their
    runs in entry order from +0.0; entries with id ``num_segments`` are
    dropped."""
    out = torch.zeros(num_segments + 1, dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def segment_sum_runs_ref(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version of the kernel on grouped ``ids`` (the presorted
    route): each run's entries summed in entry order from +0.0, written to
    ``out[id]`` where the run holds a nonzero entry and its id lies in
    ``[0, num_segments)``. Equal to ``index_add_`` on every input that meets
    the contract."""
    out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    if ids.numel() == 0:
        return out
    start = torch.ones(ids.numel(), dtype=torch.bool, device=ids.device)
    start[1:] = ids[1:] != ids[:-1]
    run = torch.cumsum(start, 0) - 1
    runs = int(run[-1]) + 1
    sums = torch.zeros(runs, dtype=data.dtype, device=data.device).index_add_(0, run, data)
    nonzero = torch.zeros(runs, dtype=torch.int64, device=data.device).index_add_(
        0, run, (data != 0).to(torch.int64)) > 0
    run_id = ids[start].to(torch.int64)
    keep = nonzero & (run_id >= 0) & (run_id < num_segments)
    out[run_id[keep]] = sums[keep]
    return out


def launch_kernel(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_sum`` alone, on CUDA tensors: float32 ``data`` and int32
    ``ids`` that meet the presorted contract (sorted ids do); ids outside
    ``[0, num_segments)`` are dropped."""
    from .. import kernels

    _check_cuda("segment_sum", data, ids)
    if data.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError(f"segment_sum kernel takes float32 data and int32 ids, got "
                         f"{data.dtype} and {ids.dtype}")
    # the kernel reads both with 16-byte loads
    data, ids = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format) for t in (data, ids))
    out = torch.zeros(num_segments, dtype=torch.float32, device=data.device)
    fn = kernels.library("segment_sum").segment_sum_launch
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), ids.data_ptr(), data.numel(), out.data_ptr(), num_segments,
                 stream)
    kernels.check(err, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0  # kernel launches (CUDA calls only)
