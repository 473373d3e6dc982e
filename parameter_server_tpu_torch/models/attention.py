"""Sequence-parallel attention schedules over sharded inputs.

Counterpart of ``parameter_server_tpu/models/attention.py``. The
sequence is sharded over an axis of the mesh: every rank of the axis
group calls these functions with its own ``[B, S/n, H]`` shard and the
mesh (``mesh=`` / ``axis=``, as the JAX signatures), and gets its shard
of the result. Each is exact (matches dense attention to float
tolerance):

- :func:`ring_attention`: the K/V shards stream around the ring
  (:func:`..parallel.mesh.shift_all`, one exchange a hop for the pair)
  while each rank keeps an online-softmax accumulator over its queries.
  The chunk compute: ``impl="xla"`` (a materialized score block),
  ``"flash"`` (the flash-attention kernel at the hop's global offsets,
  chunks merged by logsumexp), ``"zigzag"`` (flash over the zigzag
  layout: four half x half launches a hop, see
  :func:`zigzag_permutation`).
- :func:`ulysses_attention`: one all-to-all reshards sequence to heads
  (q, k and v stacked into one exchange), dense (or flash) attention per
  local head over the whole sequence, and a second restores sequence
  sharding.

Gradients flow by autograd, as JAX's do: through the shifts and
all-to-alls (whose backwards are JAX's transposes) and through the
flash kernel's ``torch.autograd.Function``, the merge's ``lse`` gradient
included (a fully masked hop gives ``lse = -1e30`` and gets none). With
no mesh (or an axis of size 1) the ring has one hop, the local K/V at
offset 0: the one-card program. The JAX ``use_pallas`` / ``interpret``
knobs have no counterpart (the device of the tensors picks the route).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.flash_attention import flash_attention
from ..parallel import mesh as meshlib


def _block_attn(q, k, mask):
    """Scores of one (q-block, kv-block) pair in the input dtype, masked
    to ``-inf``."""
    s = torch.einsum("bqh,bkh->bqk", q, k) / math.sqrt(q.shape[-1])
    return torch.where(mask, s, -torch.inf)


def _ring_hops(k, v, mesh, axis: str):
    """Yield ``(kb, vb, src)`` for each of the n ring hops: the K/V chunk
    held and WHICH rank's shard it is. The single home of the schedule
    invariant (the shift moves blocks forward, so the held chunk's source
    coordinate DEcrements), shared by every ring impl."""
    n, src = meshlib.axis_extent(mesh, axis)
    kb, vb = k, v
    for step in range(n):
        yield kb, vb, src
        if step + 1 < n:
            kb, vb = meshlib.shift_all((kb, vb), axis, mesh, 1)
            src = (src - 1) % n


def ring_attention(q, k, v, *, mesh=None, axis: str = "data", causal: bool = False,
                   impl: str = "xla", window=None):
    """Exact attention with S sharded over ``axis``: q, k, v are this
    rank's ``[B, S/n, H]`` shards (``B`` may fold heads). ``impl="xla"``
    materializes each visiting chunk's [S/n, S/n] score block;
    ``"flash"`` runs the flash kernel a hop and merges by logsumexp;
    ``"zigzag"`` is flash over the zigzag layout (inputs and outputs in
    it)."""
    if impl == "flash":
        return _ring_attention_flash(q, k, v, mesh=mesh, axis=axis, causal=causal, window=window)
    if impl == "zigzag":
        return _ring_attention_zigzag(q, k, v, mesh=mesh, axis=axis, causal=causal,
                                      window=window)
    if impl != "xla":
        raise ValueError(
            f"ring_attention impl must be 'xla', 'flash' or 'zigzag', got "
            f"{impl!r} — all are exact, so a silent fallback would hide "
            "the memory profile choice"
        )
    if window is not None:
        raise ValueError(
            "window (sliding-window attention) is implemented by the "
            "flash kernels — use impl='flash' or 'zigzag'"
        )
    b, s_loc, h = q.shape
    _, my = meshlib.axis_extent(mesh, axis)
    acc = torch.zeros((b, s_loc, h), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, s_loc), -torch.inf, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, s_loc), dtype=torch.float32, device=q.device)
    q_pos = my * s_loc + torch.arange(s_loc, device=q.device)
    for kb, vb, src in _ring_hops(k, v, mesh, axis):
        k_pos = src * s_loc + torch.arange(s_loc, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :] if causal else torch.ones(
            (s_loc, s_loc), dtype=torch.bool, device=q.device)
        scores = _block_attn(q, kb, mask[None])
        new_max = torch.maximum(row_max, scores.amax(-1))
        # guard fully-masked rows (all -inf)
        safe_max = torch.where(torch.isinf(new_max), 0.0, new_max)
        p = torch.exp(scores - safe_max[..., None])
        p = torch.where(torch.isinf(scores), 0.0, p)
        correction = torch.where(torch.isinf(row_max), 0.0, torch.exp(row_max - safe_max))
        acc = acc * correction[..., None] + torch.einsum("bqk,bkh->bqh", p, vb.float())
        row_sum = row_sum * correction + p.sum(-1)
        row_max = new_max
    out = acc / torch.clamp_min(row_sum, 1e-30)[..., None]
    return out.to(q.dtype)


def _merge_chunk(out, lse, out_i, lse_i):
    """Exact combination of two normalized partial-attention results via
    their logsumexps (the FlashAttention-2 chunk merge): order-invariant,
    and a fully-masked chunk (lse_i ~ -1e30) contributes weight 0."""
    new_lse = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(lse - new_lse)
    w_new = torch.exp(lse_i - new_lse)
    out = out * w_old[..., None] + out_i.to(torch.float32) * w_new[..., None]
    return out, new_lse


def _ring_attention_flash(q, k, v, *, mesh, axis, causal, window=None):
    """The ring schedule with the flash kernel as the chunk compute: each
    hop's normalized output and logsumexp, at the hop's global offsets
    (``q_offset = r·S/n``, ``k_offset = src·S/n``), merged exactly into
    the accumulator whatever the hop order."""
    b, s_loc, h = q.shape
    _, my = meshlib.axis_extent(mesh, axis)
    out = torch.zeros((b, s_loc, h), dtype=torch.float32, device=q.device)
    lse = torch.full((b, s_loc), -1e30, dtype=torch.float32, device=q.device)
    for kb, vb, src in _ring_hops(k, v, mesh, axis):
        out_i, lse_i = flash_attention(q, kb, vb, causal=causal, q_offset=my * s_loc,
                                       k_offset=src * s_loc, with_lse=True, window=window)
        out, lse = _merge_chunk(out, lse, out_i, lse_i)
    return out.to(q.dtype)


def zigzag_permutation(seq_len: int, n: int) -> np.ndarray:
    """Token permutation for the zigzag causal layout: the sequence is
    split into 2n half-blocks and device i holds half-blocks ``(i,
    2n-1-i)``; ``argsort(perm)`` inverts."""
    if seq_len % (2 * n):
        raise ValueError(f"seq_len {seq_len} must divide by 2n={2 * n}")
    h = seq_len // (2 * n)
    blocks = []
    for i in range(n):
        blocks.append(np.arange(i * h, (i + 1) * h))
        blocks.append(np.arange((2 * n - 1 - i) * h, (2 * n - i) * h))
    return np.concatenate(blocks)


def _ring_attention_zigzag(q, k, v, *, mesh, axis, causal, window=None):
    """Ring attention over zigzag-sharded inputs (inputs and outputs in
    the :func:`zigzag_permutation` layout): each rank holds two
    half-blocks at different global offsets, so every hop runs four half
    x half flash launches with their offset pairs, merged by logsumexp;
    the kernel's causal block skip makes the fully masked pairs cheap."""
    n, my = meshlib.axis_extent(mesh, axis)
    b, s_loc, h_feat = q.shape
    if s_loc % 2:
        raise ValueError(
            f"zigzag needs an even per-device sequence length, got "
            f"{s_loc} — shard a seq divisible by 2*{n} (see "
            "zigzag_permutation)"
        )
    half = s_loc // 2
    q_halves = (q[:, :half], q[:, half:])
    q_offs = (my * half, (2 * n - 1 - my) * half)
    outs = [torch.zeros((b, half, h_feat), dtype=torch.float32, device=q.device)
            for _ in range(2)]
    lses = [torch.full((b, half), -1e30, dtype=torch.float32, device=q.device) for _ in range(2)]
    for kb, vb, src in _ring_hops(k, v, mesh, axis):
        kv_halves = ((kb[:, :half], vb[:, :half]), (kb[:, half:], vb[:, half:]))
        kv_offs = (src * half, (2 * n - 1 - src) * half)
        for qi in range(2):
            for ki in range(2):
                out_i, lse_i = flash_attention(
                    q_halves[qi], kv_halves[ki][0], kv_halves[ki][1], causal=causal,
                    q_offset=q_offs[qi], k_offset=kv_offs[ki], with_lse=True, window=window)
                outs[qi], lses[qi] = _merge_chunk(outs[qi], lses[qi], out_i, lse_i)
    return torch.cat(outs, dim=1).to(q.dtype)


def dense_attention(q, k, v, causal: bool = False):
    """Reference implementation for tests."""
    s = torch.einsum("bqh,bkh->bqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        n = q.shape[1]
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=q.device))
        s = torch.where(mask[None], s, -torch.inf)
    return torch.einsum("bqk,bkh->bqh", torch.softmax(s, dim=-1), v)


def dense_mha(q, k, v, n_heads: int, causal: bool = False):
    """Multi-head reference: ``[B, S, H]`` with ``H = n_heads * dh``."""
    b, s, h = q.shape
    dh = h // n_heads

    def split(x):
        return x.reshape(b, s, n_heads, dh).transpose(1, 2)

    scores = torch.einsum("bnqd,bnkd->bnqk", split(q), split(k)) / math.sqrt(dh)
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        scores = torch.where(mask[None, None], scores, -torch.inf)
    out = torch.einsum("bnqk,bnkd->bnqd", torch.softmax(scores, dim=-1), split(v))
    return out.transpose(1, 2).reshape(b, s, h)


def ulysses_attention(q, k, v, *, mesh=None, axis: str = "data", n_heads: int,
                      causal: bool = False, impl: str = "xla", window=None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism, the complement
    of :func:`ring_attention`: q, k, v are this rank's ``[B, S/n, H]``
    shards (``H = n_heads * dh``); one all-to-all reshards them to
    ``n_heads / n`` whole-sequence heads a rank (q, k and v in one
    exchange), attention runs per local head (``impl="xla"``: dense;
    ``"flash"``: the flash kernel, which also takes ``window``), and the
    inverse all-to-all restores sequence sharding."""
    n, _ = meshlib.axis_extent(mesh, axis)
    if n_heads % n:
        raise ValueError(f"n_heads={n_heads} must divide by mesh axis {n}")
    if impl not in ("xla", "flash"):
        raise ValueError(f"ulysses_attention impl must be 'xla' or 'flash', got {impl!r}")
    if window is not None and impl != "flash":
        raise ValueError(
            "window (sliding-window attention) is implemented by the "
            "flash kernel — use impl='flash'"
        )
    b, s_loc, h = q.shape
    dh = h // n_heads
    qkv = torch.stack([t.reshape(b, s_loc, n_heads, dh) for t in (q, k, v)])
    if n > 1:  # scatter heads, gather sequence: [3, B, S, nh/n, dh]
        qkv = meshlib.all_to_all(qkv, axis, mesh, split_axis=3, concat_axis=2)
    qh, kh, vh = qkv.unbind(0)
    s_full, nh_loc = qh.shape[1], qh.shape[2]
    if impl == "flash":

        def to_bh(x):  # [B, S, nh/n, dh] -> [B*nh/n, S, dh]
            return x.transpose(1, 2).reshape(b * nh_loc, s_full, dh)

        out = flash_attention(to_bh(qh), to_bh(kh), to_bh(vh), causal=causal, window=window)
        out = out.reshape(b, nh_loc, s_full, dh).transpose(1, 2)
    else:
        scores = torch.einsum("bqnd,bknd->bnqk", qh, kh) / math.sqrt(dh)
        if causal:
            mask = torch.tril(torch.ones((s_full, s_full), dtype=torch.bool, device=q.device))
            scores = torch.where(mask[None, None], scores, -torch.inf)
        out = torch.einsum("bnqk,bknd->bqnd", torch.softmax(scores, dim=-1), vh)
    if n > 1:  # scatter sequence, gather heads
        out = meshlib.all_to_all(out, axis, mesh, split_axis=1, concat_axis=2)
    return out.reshape(b, s_loc, h)
