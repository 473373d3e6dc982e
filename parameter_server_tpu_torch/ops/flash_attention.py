"""Flash attention, forward pass.

Counterpart of the forward half of ``parameter_server_tpu/ops/flash_attention.py``.
:func:`flash_attention` launches the hand-written CUDA kernel
``flash_fwd`` (``kernels/csrc/flash_fwd.cu``) on CUDA tensors and its
plain PyTorch version :func:`flash_attention_ref` on CPU tensors.
Nothing else: a CUDA call either launches the kernel or raises.

Layouts are the JAX package's: ``[BH, S, D]`` head-major in, ``(out
[BH, Sq, D], lse [BH, Sq])`` out, ``out`` in the input dtype and ``lse``
(the base-e logsumexp of each masked score row) in float32. A fully
masked row gives ``out = 0`` and ``lse = _NEG``. ``q_offset`` /
``k_offset`` are the global positions of row 0 (Python ints or 0-dim
integer tensors); ``window`` (with ``causal``) keeps the keys with
``0 <= q_pos - k_pos < window``.

The plain version rounds where the TPU kernel rounds: q·kᵀ from float32
upcasts of the input values (exact products, float32 sums), exp against
the row max, P cast to v's dtype and back before P·V, statistics in
float32. The kernel sums in another order, so it is held to its plain
version within a stated tolerance, not bit for bit (``chip_smoke.py``).

Not here yet: gradients. The JAX package wraps the forward in a
``jax.custom_vjp`` whose backward is two Pallas kernels
(``_bwd_pallas``); the port's ``torch.autograd.Function`` comes with
those kernels and LM training. Serving needs the forward only. The
JAX ``block_q``/``block_k``/``use_pallas``/``interpret`` knobs have no
counterpart: the kernel's 64-row tiles are fixed, and the device of the
tensors picks the route. So the window-scale block clamp of the JAX
wrapper, which caps blocks at 128 or more, never binds here and is gone.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30  # finite mask value: keeps exp/max arithmetic NaN-free
KERNEL_HEAD_DIMS = (64, 128)  # head dims the CUDA kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _positions(offset, n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) + int(offset)


def flash_attention_ref(q, k, v, q_offset=0, k_offset=0, *, causal, window=None):
    """Plain version: ``[BH, Sq, D] x [BH, Sk, D] -> (out [BH, Sq, D], lse [BH, Sq])``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        qp = _positions(q_offset, q.shape[1], q.device)
        kp = _positions(k_offset, k.shape[1], q.device)
        keep = qp[:, None] >= kp[None, :]
        if window is not None:
            keep &= (qp[:, None] - kp[None, :]) < window
        s = torch.where(keep[None], s, _NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= _NEG / 2, 0.0, p)
    l = p.sum(dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp_min(l, 1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), _NEG)
    return out.to(q.dtype), lse


def block_live(q_off, iq, block_q, k_off, k_base, block_k, causal, window):
    """Whole-block skip predicate (the JAX package's ``_block_live``): a
    block is dead when (causal) even its LAST q row precedes its FIRST k
    row, or (window) even its FIRST q row is past its LAST k row's
    window. The kernel applies it to whole 64-key tiles."""
    if not causal:
        return True
    live = q_off + iq * block_q + block_q - 1 >= k_off + k_base
    if window is not None:
        live &= q_off + iq * block_q - (k_off + k_base + block_k - 1) < window
    return live


def _check_window(causal: bool, window):
    if window is None:
        return None
    if not causal:
        raise ValueError("window requires causal=True (sliding window)")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window)


def _flash_plain(q, k, v, q_offset, k_offset, causal, window, group):
    """The plain route of :func:`_flash`, K/V rows repeated per group."""
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    return flash_attention_ref(q, k, v, q_offset, k_offset, causal=causal, window=window)


def _flash(q, k, v, q_offset, k_offset, causal, window, group):
    """Both routes. ``k``/``v`` carry ``BH / group`` rows: query row
    ``bh`` reads K/V row ``bh // group`` (``group`` > 1 is grouped-query
    attention, see :func:`flash_mha`)."""
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, q_offset, k_offset, causal, window, group)
    return launch_kernel(q, k, v, q_offset, k_offset, causal=causal, window=window, group=group)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary: the kernel stages
    K/V rows with 16-byte loads (a view into a larger tensor may start
    anywhere, and is then copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_kernel(q, k, v, q_offset=0, k_offset=0, *, causal, window=None, group=1):
    """``flash_fwd`` alone, on CUDA tensors: returns ``(out, lse)``."""
    from .. import kernels
    from .ftrl import _check_cuda

    _check_cuda("flash_attention", q, k, v)
    bh, sq, d = q.shape
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 q/k/v of one dtype, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel is built for head dims {KERNEL_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.dim() != 3 or k.shape[0] * group != bh or k.shape[2] != d:
        raise ValueError(f"k/v must be [{bh // group}, Sk, {d}], got {tuple(k.shape)}/{tuple(v.shape)}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    fn = kernels.library("flash_fwd").flash_fwd_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 bh, sq, k.shape[1], d, group, int(q_offset), int(k_offset), int(causal),
                 0 if window is None else int(window), 1.0 / math.sqrt(d),
                 _DTYPE_CODE[q.dtype], stream)
    kernels.check(err, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = False, q_offset=0, k_offset=0,
                    with_lse: bool = False, window=None):
    """Blockwise exact attention over ``[BH, S, D]`` head-major tensors.
    Returns ``out``, or ``(out, lse)`` with ``with_lse``."""
    window = _check_window(causal, window)
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"q [BH, Sq, D] and k/v [BH, Sk, D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    out, lse = _flash(q, k, v, q_offset, k_offset, causal, window, 1)
    return (out, lse) if with_lse else out


flash_attention.launches = 0  # kernel launches (CUDA calls only)


def flash_mha(x_q, x_k, x_v, n_heads: int, *, causal: bool = False, q_offset=0,
              k_offset=0, window=None, n_kv_heads=None):
    """Multi-head wrapper: ``[B, S, H]`` with ``H = n_heads * dh``.

    ``n_kv_heads`` (grouped-query attention): ``x_k``/``x_v`` are ``[B,
    S, n_kv_heads * dh]`` and each K/V head serves ``n_heads //
    n_kv_heads`` query heads, in the JAX package's head order: query
    head ``h`` uses K/V head ``h // (n_heads // n_kv_heads)``. The CUDA
    kernel reads that K/V head directly; the plain version repeats it."""
    window = _check_window(causal, window)
    b, sq, h = x_q.shape
    sk = x_k.shape[1]
    dh = h // n_heads
    kvh = n_kv_heads if n_kv_heads is not None else n_heads
    if n_heads % kvh:
        raise ValueError(f"n_heads={n_heads} must divide by n_kv_heads={kvh}")

    def split(x, s, nh):
        return x.reshape(b, s, nh, dh).transpose(1, 2).reshape(b * nh, s, dh)

    out, _ = _flash(split(x_q, sq, n_heads), split(x_k, sk, kvh), split(x_v, sk, kvh),
                    q_offset, k_offset, causal, window, n_heads // kvh)
    return out.reshape(b, n_heads, sq, dh).transpose(1, 2).reshape(b, sq, h)
