"""Stochastic fixed-point quantization of the push/pull wire.

Counterpart of ``parameter_server_tpu/ops/quantize.py``. ``quantize``
launches the hand-written CUDA kernel ``quantize_kernel``
(``kernels/csrc/quantize.cu``) on CUDA tensors and its plain PyTorch
version (``filter/fixing_float.quantize_range``, then ``quantize_codes``)
on CPU tensors. On the card the one launch reduces ``lo`` and ``hi``
(the JAX package reduces them outside its Pallas kernel) and writes the
codes; ``lo`` and ``hi`` stay on the device, so a step never waits for
them on the host.

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


# scratch for the kernel's per-block partial ranges; it caps the grid (an
# H100 holds 132 SMs x 2 blocks of the kernel at once)
PARTIAL_BLOCKS = 4096


def quantize(x: torch.Tensor, seed: int, num_bytes: int = 1):
    """Quantize a 1-D float32 tensor to ``num_bytes`` fixed point:
    returns ``(q, lo, hi)``, ``q`` uint8/uint16 shaped like ``x``, ``lo``
    and ``hi`` 0-dim float32 tensors on ``x``'s device. ``seed`` is a
    uint32 (wider ints are taken mod 2^32).

    CUDA tensors launch ``quantize_kernel`` (range and codes in one
    launch); CPU tensors run the plain version. Nothing else: a CUDA call
    either launches the kernel or raises."""
    levels_of(num_bytes)  # validates the width
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError("quantize takes a 1-D float32 tensor")
    if x.numel() == 0:
        raise ValueError("quantize needs a non-empty tensor (its range is undefined)")
    if x.device.type == "cpu":
        lo, hi = quantize_range(x)
        return quantize_codes(x, lo, hi, int(seed) & _M32, num_bytes), lo, hi
    return launch_kernel(x, seed, num_bytes)


def launch_kernel(x, seed: int, num_bytes: int):
    """``quantize_kernel`` on a CUDA tensor: ``(q, lo, hi)`` as
    :func:`quantize` returns them."""
    from .. import kernels

    _check_cuda("quantize", x)
    if x.numel() == 0:
        raise ValueError("quantize needs a non-empty tensor (its range is undefined)")
    if not x.is_contiguous() or x.data_ptr() % 16:  # the kernel reads x with 16-byte loads
        x = x.clone(memory_format=torch.contiguous_format)
    q = torch.empty(x.numel(), dtype=code_dtype(num_bytes), device=x.device)
    lo_hi = torch.empty(2, dtype=torch.float32, device=x.device)
    partials = torch.empty(3 * PARTIAL_BLOCKS, dtype=torch.float32, device=x.device)
    fn = kernels.library("quantize").quantize_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), x.numel(), num_bytes, int(seed) & _M32, q.data_ptr(),
                 lo_hi[0].data_ptr(), lo_hi[1].data_ptr(), partials.data_ptr(), PARTIAL_BLOCKS,
                 stream)
    kernels.check(err, "quantize_kernel")
    quantize.launches += 1
    return q, lo_hi[0], lo_hi[1]


quantize.launches = 0  # kernel launches (CUDA calls only)
