"""Sequence-parallel attention schedules, on one card.

Counterpart of ``parameter_server_tpu/models/attention.py``. In the JAX
package :func:`ring_attention` streams K/V shards around a mesh axis and
merges the chunks by logsumexp; :func:`ulysses_attention` reshards
sequence to heads with two all-to-alls. On one card the ring has one hop,
the local K/V at offset 0, and the schedules' point (the layout across
cards) is moot, so this module ports the one-hop computation exactly:
``impl="xla"`` (the online-softmax chunk over a materialized score block)
and ``impl="flash"`` (the flash-attention kernel and ``_merge_chunk``,
through which ``lse``'s gradient reaches the kernel's backward).

The JAX signatures' ``mesh`` / ``axis`` are dropped until ROADMAP A9
(multi-GPU) brings process groups, and so are ``use_pallas`` /
``interpret`` (the device of the tensors picks the route). What exists
only across cards raises ``NotImplementedError`` naming A9:
``impl="zigzag"``, :func:`ulysses_attention`, and any call while a
``torch.distributed`` group of more than one process is up.
:func:`dense_attention`, :func:`dense_mha` and :func:`zigzag_permutation`
are ported as they are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.flash_attention import flash_attention


def _multi_card(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} lays the sequence out across cards, which the PyTorch package does not do "
        "yet (ROADMAP A9, multi-GPU)"
    )


def _check_one_card() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise _multi_card("ring_attention over a process group")


def _block_attn(q, k, mask):
    """Scores of one (q-block, kv-block) pair in the input dtype, masked
    to ``-inf``."""
    s = torch.einsum("bqh,bkh->bqk", q, k) / math.sqrt(q.shape[-1])
    return torch.where(mask, s, -torch.inf)


def ring_attention(q, k, v, *, causal: bool = False, impl: str = "xla", window=None):
    """Exact attention over ``[B, S, H]`` (``B`` may fold heads). One ring
    hop: ``impl="xla"`` materializes the [S, S] score block, ``"flash"``
    runs the flash-attention kernel and merges by logsumexp."""
    if impl == "flash":
        return _ring_attention_flash(q, k, v, causal=causal, window=window)
    if impl == "zigzag":
        raise _multi_card("ring_attention(impl='zigzag')")
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
    _check_one_card()
    b, s_loc, h = q.shape
    acc = torch.zeros((b, s_loc, h), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, s_loc), -torch.inf, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, s_loc), dtype=torch.float32, device=q.device)
    pos = torch.arange(s_loc, device=q.device)
    mask = pos[:, None] >= pos[None, :] if causal else torch.ones((s_loc, s_loc), dtype=torch.bool,
                                                                  device=q.device)
    scores = _block_attn(q, k, mask[None])
    new_max = torch.maximum(row_max, scores.amax(-1))
    # guard fully-masked rows (all -inf)
    safe_max = torch.where(torch.isinf(new_max), 0.0, new_max)
    p = torch.exp(scores - safe_max[..., None])
    p = torch.where(torch.isinf(scores), 0.0, p)
    correction = torch.where(torch.isinf(row_max), 0.0, torch.exp(row_max - safe_max))
    acc = acc * correction[..., None] + torch.einsum("bqk,bkh->bqh", p, v.float())
    row_sum = row_sum * correction + p.sum(-1)
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


def _ring_attention_flash(q, k, v, *, causal, window=None):
    """The ring schedule with the flash kernel as the chunk compute: the
    one hop's normalized output and logsumexp merged into the empty
    accumulator."""
    _check_one_card()
    b, s_loc, h = q.shape
    out = torch.zeros((b, s_loc, h), dtype=torch.float32, device=q.device)
    lse = torch.full((b, s_loc), -1e30, dtype=torch.float32, device=q.device)
    out_i, lse_i = flash_attention(q, k, v, causal=causal, q_offset=0, k_offset=0, with_lse=True,
                                   window=window)
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


def ulysses_attention(q, k, v, *, n_heads: int, causal: bool = False, impl: str = "xla",
                      window=None):
    """The all-to-all (DeepSpeed-Ulysses) schedule: its two collectives
    reshard sequence to heads across cards."""
    raise _multi_card("ulysses_attention")
