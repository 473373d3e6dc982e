"""Fused FTRL-proximal update over a whole slot shard.

Counterpart of ``parameter_server_tpu/ops/ftrl.py``. ``ftrl_update``
launches the hand-written CUDA kernel ``ftrl_dense_kernel``
(``kernels/csrc/ftrl_dense.cu``) on CUDA tensors and its plain PyTorch
version :func:`ftrl_update_ref` on CPU tensors. Both update z and
√n IN PLACE, where the TPU kernel aliased its inputs to its outputs.

``sqrt_n`` may be stored bf16: the math runs in f32 and the narrow is
stochastically rounded with :func:`dither_hash_u32` indexed by flat slot
position, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from ..device import scalar_like

_M32 = 0xFFFFFFFF


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in [0, 2^32), without int64
    overflow: the constant is split into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def dither_hash_u32(i: torch.Tensor, seed: int) -> torch.Tensor:
    """The dither stream: a counter hash of (index, seed), as uint32
    values held in int64 (torch's uint32 lacks most CPU ops). Bit-equal
    to the JAX package's ``dither_hash_u32`` and to the CUDA kernels'."""
    h = i.to(torch.int64) & _M32
    s = (int(seed) & _M32) * 0x9E3779B9 & _M32
    h = _mul_u32(h, 2654435761) ^ s
    h = _mul_u32(h ^ (h >> 15), 0x85EBCA6B)
    h = _mul_u32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _round_bf16(x: torch.Tensor, seed: int, positions: torch.Tensor) -> torch.Tensor:
    """Stochastic f32 -> bf16: add dither in [0, 2^16) to the f32 bits,
    truncate the low 16. A value already exact in bf16 (an untouched
    slot) comes back unchanged for every draw. Non-negative inputs (√n)
    cannot overflow int32 here."""
    rnd = (dither_hash_u32(positions, seed) & 0xFFFF).to(torch.int32)
    bits = (x.contiguous().view(torch.int32) + rnd) & -65536  # 0xFFFF0000
    return bits.view(torch.float32).to(torch.bfloat16)


def stochastic_round_bf16(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Unbiased f32 -> bf16 narrowing, dither indexed by flat position."""
    pos = torch.arange(x.numel(), device=x.device).reshape(x.shape)
    return _round_bf16(x.float(), seed, pos)


def _ftrl_math(z, n, g, *, alpha, beta, l1, l2):
    """The FTRL-proximal step on f32 operands (the plain twin of
    ``ftrl_math`` in ``kernels/csrc/ftrl_common.cuh``, operation for
    operation)."""
    a = scalar_like(alpha, z)
    eta = torch.div(a, n + beta)
    zt = -z * eta
    w = torch.sign(zt) * torch.clamp_min(zt.abs() - l1 * eta, 0.0) / (1.0 + l2 * eta)
    n_new = torch.sqrt(n * n + g * g)
    sigma = torch.div(n_new - n, a)
    z_new = z + g - sigma * w
    return z_new, n_new


def ftrl_update_ref(z, sqrt_n, grad, touched, *, alpha, beta, l1, l2,
                    seed=None):
    """Plain PyTorch version of the dense kernel; updates ``z`` and
    ``sqrt_n`` IN PLACE and returns them. ``touched=None`` derives
    membership as ``grad != 0``. A bf16 ``sqrt_n`` is narrowed with the
    seeded stochastic rounding, or to nearest without a seed."""
    keep = grad != 0 if touched is None else touched.to(torch.float32) > 0
    n32 = sqrt_n.to(torch.float32)
    z_new, n_new = _ftrl_math(z, n32, grad, alpha=alpha, beta=beta, l1=l1, l2=l2)
    n_out = torch.where(keep, n_new, n32)
    if sqrt_n.dtype == torch.bfloat16 and seed is not None:
        n_out = stochastic_round_bf16(n_out, seed)
    z.copy_(torch.where(keep, z_new, z))
    sqrt_n.copy_(n_out.to(sqrt_n.dtype))
    return z, sqrt_n


def _check_state(z: torch.Tensor, sqrt_n: torch.Tensor) -> None:
    if z.dtype != torch.float32 or z.dim() != 1 or not z.is_contiguous():
        raise ValueError("z must be a contiguous 1-D float32 tensor")
    if sqrt_n.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sqrt_n must be float32 or bfloat16, got {sqrt_n.dtype}")
    if sqrt_n.shape != z.shape or not sqrt_n.is_contiguous():
        raise ValueError("sqrt_n must be contiguous and shaped like z")


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: runs on CPU or CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: all tensors must be on {dev}, got {t.device}")


def ftrl_update(z, sqrt_n, grad, touched=None, *, alpha: float, beta: float,
                l1: float, l2: float = 0.0, seed=None):
    """Fused FTRL update over a 1-D slot shard, IN PLACE on ``z`` and
    ``sqrt_n`` (returned for convenience). ``touched``: bool/float mask,
    or ``None`` to take membership as ``grad != 0`` (the unquantized
    push, which needs no table-sized mask). ``seed`` drives the
    stochastic narrow of a bf16 ``sqrt_n``.

    CUDA tensors launch ``ftrl_dense_kernel``; CPU tensors run
    :func:`ftrl_update_ref`. Nothing else: a CUDA call either launches
    the kernel or raises."""
    _check_state(z, sqrt_n)
    if grad.shape != z.shape or grad.dtype != torch.float32:
        raise ValueError("grad must be float32 and shaped like z")
    if touched is not None and touched.shape != z.shape:
        raise ValueError("touched must be shaped like z")
    if z.device.type == "cpu":
        return ftrl_update_ref(z, sqrt_n, grad, touched, alpha=alpha,
                               beta=beta, l1=l1, l2=l2, seed=seed)
    from .. import kernels

    mask = None
    if touched is not None:
        mask = touched if touched.dtype == torch.bool else touched.to(torch.float32) > 0
        mask = mask.contiguous()
        _check_cuda("ftrl_update", z, sqrt_n, grad, mask)
    else:
        _check_cuda("ftrl_update", z, sqrt_n, grad)
    grad = grad.contiguous()
    fn = kernels.library("ftrl_dense").ftrl_dense_launch
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(
            z.data_ptr(), sqrt_n.data_ptr(), int(sqrt_n.dtype == torch.bfloat16),
            grad.data_ptr(), None if mask is None else mask.data_ptr(),
            z.numel(), alpha, beta, l1, l2,
            int(seed is not None), 0 if seed is None else int(seed) & _M32,
            stream,
        )
    kernels.check(err, "ftrl_dense_kernel")
    ftrl_update.launches += 1
    return z, sqrt_n


ftrl_update.launches = 0  # kernel launches (CUDA calls only)
