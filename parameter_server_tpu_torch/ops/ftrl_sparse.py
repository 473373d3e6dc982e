"""Fused sparse FTRL-proximal update: gather → step → scatter over a
batch's deduplicated touched slots.

Counterpart of ``parameter_server_tpu/ops/ftrl_sparse.py``.
``ftrl_sparse_update`` launches the hand-written CUDA kernel
``ftrl_sparse_kernel`` (``kernels/csrc/ftrl_sparse.cu``) on CUDA tensors
and its plain PyTorch version :func:`ftrl_sparse_rows_ref` on CPU
tensors. Both update z and √n IN PLACE, where the TPU kernel aliased
its inputs to its outputs.

Inputs are ``localize``'s shard-relative ids ``rel`` and ownership mask
``ok`` for the batch's deduplicated ``uslots``, and the per-slot
gradient ``g_u``. Non-``ok`` entries are clipped sentinels that point at
a REAL slot: neither version ever writes them.
"""

from __future__ import annotations

import torch

from .ftrl import _M32, _check_cuda, _check_state, _ftrl_math, _round_bf16

#: update-path names (host-side twin of the dispatch in the train step)
PATH_CUDA_SPARSE = "cuda_sparse"
PATH_CUDA_DENSE = "cuda_dense"
PATH_TORCH_REF = "torch_ref"


def resolve_update_path(update_mode: str, *, on_cuda: bool) -> str:
    """Which FTRL update path a train step takes: the sparse or the
    dense CUDA kernel on the card (both take every shape and dtype the
    port stores, so no shape gate applies), the plain PyTorch version
    on the CPU."""
    if update_mode not in ("sparse", "dense"):
        raise ValueError(f"unknown update mode {update_mode!r}")
    if not on_cuda:
        return PATH_TORCH_REF
    return PATH_CUDA_SPARSE if update_mode == "sparse" else PATH_CUDA_DENSE


def assert_ok_unique(rel: torch.Tensor, ok: torch.Tensor) -> None:
    """The duplicate-free contract on host-resident inputs: the update
    is nonlinear in the summed gradient, so a duplicated ``ok`` slot
    would double-apply. Checked where it is cheap (CPU tensors); prep
    guarantees it on the card by deduplicating at slot level."""
    if rel.device.type != "cpu":
        return
    r = rel[ok.to(torch.bool)]
    if torch.unique(r).numel() != r.numel():
        raise ValueError(
            "rel must be duplicate-free among ok entries (host prep "
            "dedups at slot level)"
        )


def ftrl_sparse_rows_ref(z, sqrt_n, rel, ok, g_u, *, alpha, beta, l1, l2,
                         seed=None):
    """Plain PyTorch version of the sparse kernel, IN PLACE: gather the
    ``rel`` entries, run the dense step on the gathered vector
    (membership ``g != 0``, bf16 dither indexed by u-position), scatter
    back only the ``ok`` entries."""
    ok = ok.to(torch.bool)
    idx = rel.to(torch.int64)
    z_u = z[idx]
    n_u = sqrt_n[idx].to(torch.float32)
    g = torch.where(ok, g_u, torch.zeros_like(g_u))
    keep = g != 0
    z_new, n_new = _ftrl_math(z_u, n_u, g, alpha=alpha, beta=beta, l1=l1, l2=l2)
    z_out = torch.where(keep, z_new, z_u)
    n_out = torch.where(keep, n_new, n_u)
    if sqrt_n.dtype == torch.bfloat16 and seed is not None:
        pos = torch.arange(n_out.numel(), device=n_out.device)
        n_out = _round_bf16(n_out, seed, pos)
    dst = idx[ok]
    z.index_copy_(0, dst, z_out[ok])
    sqrt_n.index_copy_(0, dst, n_out[ok].to(sqrt_n.dtype))
    return z, sqrt_n


def ftrl_sparse_update(z, sqrt_n, rel, ok, g_u, *, alpha: float, beta: float,
                       l1: float, l2: float = 0.0, seed=None):
    """Fused sparse-touched FTRL update over a 1-D slot shard, IN PLACE
    on ``z`` and ``sqrt_n`` (returned for convenience). ``rel`` int32
    [U], ``ok`` bool [U] (``ok`` entries duplicate-free), ``g_u`` f32
    [U]; ``seed`` drives the stochastic narrow of a bf16 ``sqrt_n``.

    CUDA tensors launch ``ftrl_sparse_kernel``; CPU tensors run
    :func:`ftrl_sparse_rows_ref`. Nothing else: a CUDA call either
    launches the kernel or raises."""
    _check_state(z, sqrt_n)
    u = rel.numel()
    if rel.dim() != 1 or ok.shape != rel.shape or g_u.shape != rel.shape:
        raise ValueError("rel, ok and g_u must be 1-D of one length")
    if g_u.dtype != torch.float32:
        raise ValueError("g_u must be float32")
    if z.device.type == "cpu":
        assert_ok_unique(rel, ok)
        return ftrl_sparse_rows_ref(z, sqrt_n, rel, ok, g_u, alpha=alpha,
                                    beta=beta, l1=l1, l2=l2, seed=seed)
    from .. import kernels

    if rel.dtype != torch.int32:
        raise ValueError("rel must be int32 on the CUDA path")
    if z.numel() >= 2**31:
        raise ValueError("int32 rel addresses at most 2^31 - 1 slots")
    ok = ok if ok.dtype == torch.bool else ok.to(torch.bool)
    rel, ok, g_u = rel.contiguous(), ok.contiguous(), g_u.contiguous()
    _check_cuda("ftrl_sparse_update", z, sqrt_n, rel, ok, g_u)
    fn = kernels.library("ftrl_sparse").ftrl_sparse_launch
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(
            z.data_ptr(), sqrt_n.data_ptr(), int(sqrt_n.dtype == torch.bfloat16),
            rel.data_ptr(), ok.data_ptr(), g_u.data_ptr(), u,
            alpha, beta, l1, l2,
            int(seed is not None), 0 if seed is None else int(seed) & _M32,
            stream,
        )
    kernels.check(err, "ftrl_sparse_kernel")
    ftrl_sparse_update.launches += 1
    return z, sqrt_n


ftrl_sparse_update.launches = 0  # kernel launches (CUDA calls only)
