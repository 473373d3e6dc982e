"""Stochastic fixed-point quantization of the push/pull wire.

Counterpart of ``parameter_server_tpu/ops/quantize.py``. ``quantize``
launches the hand-written CUDA kernel ``quantize_kernel``
(``kernels/csrc/quantize.cu``) on CUDA tensors and its plain PyTorch
version (``filter/fixing_float.quantize_codes``) on CPU tensors. ``lo``
and ``hi`` are reduced outside the kernel by :func:`quantize_range`, as
the JAX package reduces them outside its Pallas kernel, and stay on the
device: the kernel reads them from device memory, so a step never waits
for them on the host.

The JAX package's ``quantize_traced`` (the in-jit variant with a traced
seed) is the same function here: eager PyTorch has no tracing. Its
``use_pallas`` switch has no counterpart: the wrapper picks the kernel
from the tensor's device.
"""

from __future__ import annotations

import torch

from ..filter.fixing_float import (
    code_dtype,
    dequantize_torch,
    levels_of,
    quantize_codes,
    quantize_range,
)
from .ftrl import _M32, _check_cuda

dequantize = dequantize_torch


def quantize(x: torch.Tensor, seed: int, num_bytes: int = 1):
    """Quantize a 1-D float32 tensor to ``num_bytes`` fixed point:
    returns ``(q, lo, hi)``, ``q`` uint8/uint16 shaped like ``x``, ``lo``
    and ``hi`` 0-dim float32 tensors on ``x``'s device. ``seed`` is a
    uint32 (wider ints are taken mod 2^32).

    CUDA tensors launch ``quantize_kernel``; CPU tensors run the plain
    version. Nothing else: a CUDA call either launches the kernel or
    raises."""
    levels_of(num_bytes)  # validates the width
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError("quantize takes a 1-D float32 tensor")
    if x.numel() == 0:
        raise ValueError("quantize needs a non-empty tensor (its range is undefined)")
    lo, hi = quantize_range(x)
    if x.device.type == "cpu":
        return quantize_codes(x, lo, hi, int(seed) & _M32, num_bytes), lo, hi
    return launch_kernel(x, lo, hi, seed, num_bytes), lo, hi


def launch_kernel(x, lo, hi, seed: int, num_bytes: int) -> torch.Tensor:
    """``quantize_kernel`` alone, given ``lo``/``hi`` (0-dim float32
    tensors on ``x``'s CUDA device): the codes, uint8/uint16."""
    from .. import kernels

    _check_cuda("quantize", x, lo, hi)
    x = x.contiguous()
    q = torch.empty(x.numel(), dtype=code_dtype(num_bytes), device=x.device)
    fn = kernels.library("quantize").quantize_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), lo.data_ptr(), hi.data_ptr(), q.data_ptr(),
                 num_bytes, x.numel(), int(seed) & _M32, stream)
    kernels.check(err, "quantize_kernel")
    quantize.launches += 1
    return q


quantize.launches = 0  # kernel launches (CUDA calls only)
