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

On the CPU the sum is ``torch.zeros(n).index_add_(0, ids, data)`` on the
entries as they come: the CPU's ``index_add_`` adds entry by entry in
index order, which is the order above (a stable sort keeps each segment's
entries in index order), and leaving the zeros out changes no sum,
because a sum that starts from +0.0 and rounds to nearest is never -0.0,
and adding +-0.0 to anything else leaves it as it is. So the CPU's result
is an independent reference for the card's bits. (``index_add_`` on the
card sums with atomics, in an order that changes from run to run.)
Leaving the zeros out also keeps a batch's padding, all in one segment,
away from the kernel.
"""

from __future__ import annotations

import torch

from .ftrl import _check_cuda


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[i] over segment_ids[i] == s``, ``[num_segments]``
    (float32 on the card), each sum taken in index order from +0.0. Every
    id must lie in ``[0, num_segments)``."""
    if data.dim() != 1 or segment_ids.shape != data.shape:
        raise ValueError(f"segment_sum takes 1-D data and ids of one length, got "
                         f"{tuple(data.shape)} and {tuple(segment_ids.shape)}")
    if not 0 <= num_segments < (1 << 31):
        raise ValueError(f"num_segments must be in [0, 2^31), got {num_segments}")
    if data.device.type == "cpu":
        return torch.zeros(num_segments, dtype=data.dtype).index_add_(0, segment_ids, data)
    return launch_kernel(*sort_by_segment(data, segment_ids, num_segments), num_segments)


def sort_by_segment(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """Step 1: ``(values, int32 ids)`` ordered by segment with a stable
    sort, the zero values given id ``num_segments`` (after the last
    segment)."""
    keys = torch.where(data != 0, segment_ids.to(torch.int32), num_segments)
    ids, order = torch.sort(keys, stable=True)
    return data.index_select(0, order), ids


def segment_sum_sorted_ref(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version of the kernel: the sums of sorted ``ids``' runs in
    entry order from +0.0; entries with id ``num_segments`` are dropped."""
    out = torch.zeros(num_segments + 1, dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def launch_kernel(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_sum`` alone, on CUDA tensors: float32 ``data`` and int32
    ``ids`` sorted (non-decreasing); ids outside ``[0, num_segments)``
    are dropped."""
    from .. import kernels

    _check_cuda("segment_sum", data, ids)
    if data.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError(f"segment_sum kernel takes float32 data and int32 ids, got "
                         f"{data.dtype} and {ids.dtype}")
    data, ids = data.contiguous(), ids.contiguous()
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
