"""Flash attention, forward and backward.

Counterpart of ``parameter_server_tpu/ops/flash_attention.py``.
:func:`flash_attention` and :func:`flash_mha` run through the
``torch.autograd.Function`` :class:`_Flash` (the JAX ``custom_vjp``). On
CUDA tensors its forward launches the hand-written CUDA kernel
``flash_fwd`` (``kernels/csrc/flash_fwd.cu``) and its backward the two
kernels ``flash_bwd_dq`` and ``flash_bwd_dkv``
(``kernels/csrc/flash_bwd.cu``); on CPU tensors it runs their plain
PyTorch versions :func:`flash_attention_ref` and
:func:`flash_attention_bwd_ref`. Nothing else: a CUDA call either
launches the kernels or raises.

Layouts are the JAX package's: ``[BH, S, D]`` head-major in, ``(out
[BH, Sq, D], lse [BH, Sq])`` out, ``out`` in the input dtype and ``lse``
(the base-e logsumexp of each masked score row) in float32. A fully
masked row gives ``out = 0`` and ``lse = _NEG``. ``q_offset`` /
``k_offset`` are the global positions of row 0 (Python ints or 0-dim
integer tensors; they get no gradient); ``window`` (with ``causal``)
keeps the keys with ``0 <= q_pos - k_pos < window``. Both ``out`` and
``lse`` are differentiable: the ring merge of ``models/attention.py``
differentiates through ``lse``, and its gradient enters the backward as
``c = rowsum(dout * out) - dlse``, as in JAX's ``_flash_bwd``.

The plain versions round where the TPU kernels round: products of
float32 upcasts of the input values (exact products, float32 sums), exp
against the row max (forward) or the saved lse (backward), P cast to v's
dtype before P·V and to do's dtype before Pᵀ·dO, dS cast to k's (q's)
dtype before dS·K (dSᵀ·Q), statistics in float32. In float32 that is
also what JAX's XLA branch computes. The kernels sum in another order
(and the float32 forward multiplies in 3xTF32, within ~2^-22 of each
product), so they are held to their plain versions within stated
tolerances, not bit for bit (``chip_smoke.py``).

The JAX ``block_q``/``block_k``/``use_pallas``/``interpret`` knobs have
no counterpart: the kernels' tiles are fixed (bf16: 64 rows a consumer
warpgroup, 128-key tiles in the forward, 64 in the backward; the float32
forward, 3xTF32 on the tensor cores: 16 rows a warp, 64-key tiles), and the
device of the tensors picks the route. So the window-scale block clamp of the JAX
wrapper, which caps blocks at 128 or more, never binds here and is gone.
Grouped-query attention reads the shared K/V rows in place in both
directions (:func:`flash_mha`); the JAX wrapper repeats them.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30  # finite mask value: keeps exp/max arithmetic NaN-free
# head dims the CUDA kernels are built for, by dtype: the float32 routes
# also take the serve CLI's small heads
KERNEL_HEAD_DIMS = {torch.float32: (16, 32, 64, 128), torch.bfloat16: (64, 128)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _keep(q_offset, k_offset, sq: int, sk: int, window, device) -> torch.Tensor:
    """The causal (and window) mask at global positions, [1, Sq, Sk]."""
    qp = torch.arange(sq, device=device)[:, None] + int(q_offset)
    kp = torch.arange(sk, device=device)[None, :] + int(k_offset)
    keep = qp >= kp
    if window is not None:
        keep &= (qp - kp) < window
    return keep[None]


def flash_attention_ref(q, k, v, q_offset=0, k_offset=0, *, causal, window=None):
    """Plain version: ``[BH, Sq, D] x [BH, Sk, D] -> (out [BH, Sq, D], lse [BH, Sq])``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_keep(q_offset, k_offset, q.shape[1], k.shape[1], window, q.device), s, _NEG)
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
    window. The kernels apply it to whole tiles of keys."""
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
    """The plain forward route, K/V rows repeated per group."""
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    return flash_attention_ref(q, k, v, q_offset, k_offset, causal=causal, window=window)


def flash_attention_bwd_ref(q, k, v, do, lse, c, q_offset=0, k_offset=0, *, causal,
                            window=None, group=1):
    """Plain backward: ``(dq, dk, dv)`` in the inputs' dtypes from the
    output gradient ``do`` [BH, Sq, D], the forward's ``lse`` and ``c =
    rowsum(do * out) - dlse`` (both float32 [BH, Sq]). P is recomputed
    from ``lse``. ``k``/``v`` may hold ``BH / group`` rows; their
    gradients sum the group's query heads in float32 before the cast."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=0)
        vf = vf.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kf) * scale
    keep = None
    if causal:
        keep = _keep(q_offset, k_offset, q.shape[1], k.shape[1], window, q.device)
        s = torch.where(keep, s, _NEG)
    p = torch.exp(s - lse[..., None])
    del s
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqd,bkd->bqk", do.float(), vf)
    ds = p * (dp - c[..., None]) * scale
    del p, dp
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    if group > 1:
        dk = dk.reshape(-1, group, *dk.shape[1:]).sum(1)
        dv = dv.reshape(-1, group, *dv.shape[1:]).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward(q, k, v, q_offset, k_offset, causal, window, group):
    """The forward of :class:`_Flash`, both routes. ``k``/``v`` carry ``BH
    / group`` rows: query row ``bh`` reads K/V row ``bh // group``
    (``group`` > 1 is grouped-query attention, see :func:`flash_mha`)."""
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, q_offset, k_offset, causal, window, group)
    return launch_kernel(q, k, v, q_offset, k_offset, causal=causal, window=window, group=group)


def _backward_plain(q, k, v, do, lse, c, q_offset, k_offset, causal, window, group):
    """The plain backward route (:func:`flash_attention_bwd_ref`)."""
    return flash_attention_bwd_ref(q, k, v, do, lse, c, q_offset, k_offset, causal=causal,
                                   window=window, group=group)


def _backward(q, k, v, do, lse, c, q_offset, k_offset, causal, window, group):
    """The backward of :class:`_Flash`, both routes."""
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, do, lse, c, q_offset, k_offset, causal, window, group)
    kw = dict(causal=causal, window=window, group=group)
    dq = flash_bwd_dq(q, k, v, do, lse, c, q_offset, k_offset, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, c, q_offset, k_offset, **kw))


class _Flash(torch.autograd.Function):
    """Flash attention with its backward (the JAX ``_flash`` custom VJP):
    saves q, k, v, out and lse; the backward folds ``dlse`` into ``c =
    rowsum(dout * out) - dlse`` in float32 (an unused output's gradient
    counts as zeros) and returns no gradient for the offsets."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal, window, group):
        out, lse = _forward(q, k, v, q_offset, k_offset, causal, window, group)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (int(q_offset), int(k_offset), causal, window, group)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        c = (dout.float() * out.float()).sum(-1)
        if dlse is not None:
            c = c - dlse.float()
        return (*_backward(q, k, v, dout, lse, c, *ctx.args), None, None, None, None, None)


def _flash(q, k, v, q_offset, k_offset, causal, window, group):
    return _Flash.apply(q, k, v, q_offset, k_offset, causal, window, group)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary: the kernel stages
    K/V rows with 16-byte loads (a view into a larger tensor may start
    anywhere, and is then copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_inputs(what: str, q, k, v, group: int, *more):
    """Check what the kernels take; returns q, k, v and ``more`` (tensors
    of q's shape and dtype) contiguous and 16-byte aligned."""
    from .ftrl import _check_cuda

    _check_cuda(what, q, k, v, *more)
    bh, _, d = q.shape
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise ValueError(f"{what} kernel takes float32 or bfloat16 q/k/v of one dtype, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in KERNEL_HEAD_DIMS[q.dtype]:
        raise ValueError(f"{what} kernel is built for {q.dtype} head dims "
                         f"{KERNEL_HEAD_DIMS[q.dtype]}, got {d}")
    if k.shape != v.shape or k.dim() != 3 or k.shape[0] * group != bh or k.shape[2] != d:
        raise ValueError(f"k/v must be [{bh // group}, Sk, {d}], got {tuple(k.shape)}/{tuple(v.shape)}")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{what}: the output gradient must be {tuple(q.shape)}")
    return [_aligned(t) for t in (q, k, v, *more)]


def _dims(q, k, q_offset, k_offset, causal, window, group):
    """The launch functions' shape and mask arguments, in their order."""
    bh, sq, d = q.shape
    return (bh, sq, k.shape[1], d, group, int(q_offset), int(k_offset), int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype])


def _launch(fn, what: str, q, args) -> None:
    from .. import kernels

    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, what)


def launch_kernel(q, k, v, q_offset=0, k_offset=0, *, causal, window=None, group=1):
    """``flash_fwd`` alone, on CUDA tensors: returns ``(out, lse)``."""
    from .. import kernels

    q, k, v = _kernel_inputs("flash_attention", q, k, v, group)
    bh, sq, d = q.shape
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _launch(kernels.library("flash_fwd").flash_fwd_launch, "flash_fwd", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             *_dims(q, k, q_offset, k_offset, causal, window, group)))
    flash_attention.launches += 1
    return out, lse


def _stats(what: str, lse, c, q):
    """lse and c as the backward kernels read them: float32 [BH, Sq] on
    q's device."""
    from .ftrl import _check_cuda

    _check_cuda(what, q, lse, c)
    want = q.shape[:2]
    if lse.shape != want or c.shape != want:
        raise ValueError(f"lse and c must be {tuple(want)}, got {tuple(lse.shape)}/{tuple(c.shape)}")
    return [_aligned(t.to(torch.float32)) for t in (lse, c)]


def flash_bwd_dq(q, k, v, do, lse, c, q_offset=0, k_offset=0, *, causal, window=None, group=1):
    """``flash_bwd_dq`` alone, on CUDA tensors: dq [BH, Sq, D] from the
    output gradient ``do``, the forward's ``lse`` and ``c = rowsum(do *
    out) - dlse``."""
    from .. import kernels

    q, k, v, do = _kernel_inputs("flash_bwd_dq", q, k, v, group, do)
    lse, c = _stats("flash_bwd_dq", lse, c, q)
    dq = torch.empty_like(q)
    _launch(kernels.library("flash_bwd").flash_bwd_dq_launch, "flash_bwd_dq", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             c.data_ptr(), dq.data_ptr(), *_dims(q, k, q_offset, k_offset, causal, window, group)))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, c, q_offset=0, k_offset=0, *, causal, window=None, group=1):
    """``flash_bwd_dkv`` alone, on CUDA tensors: (dk, dv) in the shape of
    k and v, each K/V row summing its ``group`` query heads."""
    from .. import kernels

    q, k, v, do = _kernel_inputs("flash_bwd_dkv", q, k, v, group, do)
    lse, c = _stats("flash_bwd_dkv", lse, c, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(kernels.library("flash_bwd").flash_bwd_dkv_launch, "flash_bwd_dkv", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             c.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_dims(q, k, q_offset, k_offset, causal, window, group)))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0  # kernel launches (CUDA calls only)
flash_bwd_dkv.launches = 0


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
