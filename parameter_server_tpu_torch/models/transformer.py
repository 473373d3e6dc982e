"""Decoder-only byte LM: training and KV-cached serving.

Counterpart of ``parameter_server_tpu/models/transformer.py``:
:class:`LMConfig`, :func:`init_lm`; the training forward
:func:`lm_forward`, :func:`lm_loss`, :func:`lm_loss_with_targets`,
:func:`value_and_grad` and the SGD steps :func:`make_lm_train_step` /
:func:`make_lm_train_step_with_targets`; the int8 or compute-dtype KV
cache, the batched causal prefill, the one-token and chunked decode
steps, :func:`lm_generate` (dense and ragged batches, greedy or
sampled, with ``eos_id``, ``return_logits`` and ``return_state``),
:func:`lm_generate_continue` (multi-turn serving from a
:class:`GenState`) and :func:`lm_beam_search`. Every ``moe_every``-th
layer's FFN can be a mixture of experts: capacity-routed in training
(:mod:`.moe`), dropless in serving (:func:`_moe_ffn_dropless`), its
router and experts float32 under any compute dtype. Parameters are a
plain dict of float32 tensors with the JAX package's names (``emb``,
``ln_f``, ``l{i}/ln1|ln2|wq|wk|wv|wo``, then ``l{i}/w1|w2`` or, on a MoE
layer, ``l{i}/moe_router|moe_w_in|moe_w_out``); :mod:`..convert`
carries them over from the JAX package.

On the card attention is the hand-written CUDA flash-attention kernels:
``flash_fwd`` for the prefill and the training forward, ``flash_bwd_dq``
and ``flash_bwd_dkv`` for the training backward
(:mod:`..ops.flash_attention`); on the CPU it is their plain versions.
The decode step's attention is plain tensor code over the cache, as it
is in the JAX package, and the projections, MLP, MoE routing and
experts are ``torch.matmul``, ``torch.bmm`` and index ops. Everything
follows the device of the parameters it is given.

Differences from the JAX package, none of which changes a result:

- caches are written IN PLACE (``cache[i, :, :, pos] = ...``), where JAX
  updates them functionally and XLA in place (so a continuation extends
  its state's caches);
- serving casts the weights to the compute dtype once per call, as XLA
  hoists the cast out of its decode scan (training casts them inside
  each layer, as JAX does, so the gradient reaches the float32 weights);
- ``jax.random`` keys become an explicit ``torch.Generator``; the draws
  differ, so sampled runs match JAX in distribution, not draw for draw;
  :func:`init_lm` draws its normal(0, 0.02) weights from a seeded
  ``torch.Generator``, so its values differ from JAX's ``init_lm``;
- the decode loops and ``steps_per_launch`` are Python loops
  (``lax.scan`` in JAX), and ``remat`` is
  ``torch.utils.checkpoint`` (``jax.checkpoint``);
- grouped-query attention in training broadcasts each K/V head over its
  query-head group before attention, as JAX does (the grouped kernel
  call of serving would give the same gradient, summed in another order).

Not here yet: the attention layouts across cards (``attention=
"ring_zigzag"`` and ``"a2a"`` raise ``NotImplementedError``, ROADMAP A9),
so also ``zigzag_lm_arrays``, and experts sharded across cards (A9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..device import resolve, scalar_like
from ..ops.flash_attention import flash_mha
from .attention import ring_attention
from .moe import init_moe, moe_ffn

Params = Dict[str, torch.Tensor]
_NEG = -1e30  # finite mask value, as in the JAX package


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX package's ``LMConfig``, field for field and with its
    validation. ``attention`` and ``remat`` shape training only; serving
    reads them for validation. The attention modes that lay the sequence
    out across cards (``"ring_zigzag"``, ``"a2a"``) are accepted here, as
    serving does not read them, and raise in :func:`lm_forward`."""

    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 128
    attention: str = "ring_flash"
    moe_every: int = 0
    n_experts: int = 8
    capacity_factor: float = 2.0
    remat: bool = False
    compute_dtype: str = "float32"
    window: "int | None" = None
    n_kv_heads: "int | None" = None
    rope: bool = False
    rope_theta: float = 10000.0
    kv_cache_dtype: "str | None" = None

    def __post_init__(self):
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"LMConfig.kv_cache_dtype must be None or 'int8', got "
                             f"{self.kv_cache_dtype!r}")
        if self.attention not in ("ring", "ring_flash", "ring_zigzag", "a2a"):
            raise ValueError(f"LMConfig.attention must be 'ring', 'ring_flash', 'ring_zigzag' "
                             f"or 'a2a', got {self.attention!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"LMConfig.compute_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.compute_dtype!r}")
        if self.window is not None:
            if self.attention not in ("ring_flash", "ring_zigzag"):
                raise ValueError("LMConfig.window (sliding-window attention) needs a flash "
                                 "attention mode ('ring_flash' or 'ring_zigzag')")
            if self.window < 1:
                raise ValueError(f"LMConfig.window must be >= 1, got {self.window}")
        if self.n_kv_heads is not None:
            if not 1 <= self.n_kv_heads <= self.n_heads:
                raise ValueError(f"LMConfig.n_kv_heads must be in [1, n_heads={self.n_heads}], "
                                 f"got {self.n_kv_heads}")
            if self.n_heads % self.n_kv_heads:
                raise ValueError(f"n_heads={self.n_heads} must be a multiple of "
                                 f"n_kv_heads={self.n_kv_heads}")
        if self.rope and (self.d_model // self.n_heads) % 2:
            raise ValueError(f"LMConfig.rope pairs head dimensions: head_dim="
                             f"{self.d_model // self.n_heads} must be even")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def init_lm(seed: int, cfg: LMConfig, device=None) -> Params:
    """Float32 parameters of the JAX ``init_lm``'s names and shapes:
    normal(0, 0.02) matrices, unit norms. Drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (the same values on every
    device), then moved to ``device`` (CUDA by default; raises without a
    card)."""
    dev = resolve(device)
    gen = torch.Generator().manual_seed(int(seed))
    d, s = cfg.d_model, 0.02

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * s

    p = {"emb": normal(cfg.vocab, d), "ln_f": torch.ones(d)}
    kv_w = cfg.kv_heads * cfg.head_dim
    for i in range(cfg.n_layers):
        p[f"l{i}/ln1"] = torch.ones(d)
        p[f"l{i}/ln2"] = torch.ones(d)
        wq, wk, wv = normal(d, 3 * d).split(d, dim=1)
        p[f"l{i}/wq"] = wq.contiguous()
        p[f"l{i}/wk"] = wk[:, :kv_w].contiguous()  # GQA: narrow K/V projections
        p[f"l{i}/wv"] = wv[:, :kv_w].contiguous()
        p[f"l{i}/wo"] = normal(d, d)
        if _is_moe_layer(cfg, i):
            moe = init_moe(gen, d, cfg.d_ff, cfg.n_experts)
            p[f"l{i}/moe_router"] = moe["router"]
            p[f"l{i}/moe_w_in"] = moe["w_in"]
            p[f"l{i}/moe_w_out"] = moe["w_out"]
        else:
            p[f"l{i}/w1"] = normal(d, cfg.d_ff)
            p[f"l{i}/w2"] = normal(cfg.d_ff, d)
    return {k: v.to(dev) for k, v in p.items()}


def _is_moe_layer(cfg: LMConfig, i: int) -> bool:
    return cfg.moe_every > 0 and (i + 1) % cfg.moe_every == 0


def _layer_weights(cfg: LMConfig, i: int):
    """The names of layer ``i``'s weights that run in the compute dtype.
    A MoE layer's router and experts are not among them: they stay
    float32, as the JAX package routes and runs the experts in float32."""
    dense = ("ln1", "ln2", "wq", "wk", "wv", "wo")
    return dense if _is_moe_layer(cfg, i) else dense + ("w1", "w2")


def _moe_layer_params(params, i: int):
    """The MoE leaves of layer ``i`` for the serving path."""
    return {name: params[f"l{i}/{name}"] for name in ("moe_router", "moe_w_in", "moe_w_out")}


def _weights(params: Params, cfg: LMConfig) -> Params:
    """The layer weights cast to the compute dtype, once per call (a
    no-op for float32); ``emb``, ``ln_f`` and the MoE weights stay
    float32."""
    w = dict(params)
    for i in range(cfg.n_layers):
        for name in _layer_weights(cfg, i):
            w[f"l{i}/{name}"] = params[f"l{i}/{name}"].to(cfg.dtype)
    return w


def _ln(x, scale):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin rotation tables (float32) for positions ``positions``:
    angles pos * theta^(-i/half)."""
    half = head_dim // 2
    inv = theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / -half)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """Apply precomputed rotation tables in ``x.dtype`` (GPT-NeoX
    half-split pairing)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary position embedding of ``x`` [..., head_dim] at integer
    ``positions`` broadcastable to ``x.shape[:-1]``."""
    positions = torch.as_tensor(positions, device=x.device)
    return _rotate(x, *_rope_tables(positions, x.shape[-1], theta))


def _embed(params, cfg: LMConfig, toks):
    # scaled by sqrt(d_model) in float32, THEN cast to the compute dtype
    return (params["emb"][toks] * math.sqrt(cfg.d_model)).to(cfg.dtype)


def _logits(params, x):
    return _ln(x.to(torch.float32), params["ln_f"]) @ params["emb"].T


def _moe_ffn_dropless(lp, h2, n_experts: int):
    """Serving's MoE FFN: every token routed on its own to the expert of
    its largest gate, with no capacity. Training's capacity drops depend
    on the whole batch, which incremental decoding cannot see, so serving
    is dropless; it equals the training forward wherever the training
    capacity did not bind (``capacity_factor >= n_experts`` guarantees
    that). Routing and experts in float32, relu, the output scaled by
    the gate. As in the JAX package, each expert runs over every token
    and its output is kept where the token chose it: no per-token weight
    gather and no host sync, the right trade for the decode step, at
    ``n_experts`` times the dense FFN's FLOP in a prefill."""
    shape = h2.shape
    x = h2.reshape(-1, shape[-1]).to(torch.float32)  # [T, d]
    gates = torch.softmax(x @ lp["moe_router"], dim=-1)  # [T, E]
    expert = torch.argmax(gates, dim=-1)
    gate = gates.gather(1, expert[:, None])[:, 0]
    out = torch.zeros_like(x)
    for e in range(n_experts):
        y = torch.relu(x @ lp["moe_w_in"][e]) @ lp["moe_w_out"][e]
        out = out + torch.where((expert == e)[:, None], y, 0.0)
    return (out * gate[:, None]).reshape(shape)


def _mlp(w, i: int, h2):
    return F.gelu(h2 @ w[f"l{i}/w1"], approximate="tanh") @ w[f"l{i}/w2"]


def _ffn(w, cfg: LMConfig, i: int, x):
    """Layer ``i``'s residual FFN block in serving: the GELU MLP, or the
    dropless MoE FFN on a MoE layer."""
    h2 = _ln(x, w[f"l{i}/ln2"])
    if _is_moe_layer(cfg, i):
        return x + _moe_ffn_dropless(_moe_layer_params(w, i), h2, cfg.n_experts).to(cfg.dtype)
    return x + _mlp(w, i, h2)


# -- training --

_RING_IMPL = {"ring": "xla", "ring_flash": "flash"}


def _train_layer(params, cfg: LMConfig, i: int, x, rope_cs):
    """One decoder layer of :func:`lm_forward`: the weights cast to the
    compute dtype inside the layer (so ``remat`` recomputes the cast, as
    under ``jax.checkpoint``), attention through the ring schedule."""
    b, s, d = x.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    w = {f"l{i}/{n}": params[f"l{i}/{n}"].to(cfg.dtype) for n in _layer_weights(cfg, i)}
    h = _ln(x, w[f"l{i}/ln1"])
    q, k, v = h @ w[f"l{i}/wq"], h @ w[f"l{i}/wk"], h @ w[f"l{i}/wv"]
    if cfg.rope:  # rotate BEFORE the GQA broadcast: k is still narrow
        q = _rotate(q.reshape(b, s, nh, hd), *rope_cs).reshape(b, s, d)
        k = _rotate(k.reshape(b, s, kvh, hd), *rope_cs).reshape(b, s, kvh * hd)
    if kvh != nh:  # GQA: each K/V head broadcast over its query-head group

        def expand(t):
            return t.reshape(b, s, kvh, 1, hd).expand(b, s, kvh, nh // kvh, hd).reshape(b, s, d)

        k, v = expand(k), expand(v)

    def heads(t):  # [B, S, d] -> [B*nh, S, hd]
        return t.reshape(b, s, nh, hd).transpose(1, 2).reshape(b * nh, s, hd)

    att = ring_attention(heads(q), heads(k), heads(v), causal=True,
                         impl=_RING_IMPL[cfg.attention], window=cfg.window)
    att = att.reshape(b, nh, s, hd).transpose(1, 2).reshape(b, s, d)
    x = x + att.to(cfg.dtype) @ w[f"l{i}/wo"]
    h2 = _ln(x, w[f"l{i}/ln2"])
    if not _is_moe_layer(cfg, i):
        return x + _mlp(w, i, h2)
    # routing and the capacity bookkeeping in float32, for a stable
    # expert choice
    moe_p = {"router": params[f"l{i}/moe_router"], "w_in": params[f"l{i}/moe_w_in"],
             "w_out": params[f"l{i}/moe_w_out"]}
    return x + moe_ffn(moe_p, h2.to(torch.float32),
                       capacity_factor=cfg.capacity_factor).to(cfg.dtype)


def lm_forward(params: Params, tokens, cfg: LMConfig):
    """Logits [B, S, vocab] (always float32) of tokens [B, S]; decoder
    activations run in ``cfg.compute_dtype``, each layer rematerialized in
    the backward when ``cfg.remat``. The JAX ``mesh``/``axis`` arguments
    are gone: one card holds the whole sequence (ROADMAP A9)."""
    if cfg.attention not in _RING_IMPL:
        raise NotImplementedError(
            f"LMConfig.attention={cfg.attention!r} lays the sequence out across cards, which the "
            "PyTorch package does not do yet (ROADMAP A9, multi-GPU); use 'ring' or 'ring_flash'")
    tokens = torch.as_tensor(tokens, device=params["emb"].device).to(torch.int64)
    s = tokens.shape[1]
    # RoPE tables once per call, on positions arange(S), shared by every
    # layer (under remat they enter each checkpoint as inputs)
    rope_cs = _rope_tables(torch.arange(s, device=tokens.device)[None, :, None], cfg.head_dim,
                           cfg.rope_theta) if cfg.rope else None
    x = _embed(params, cfg, tokens)
    for i in range(cfg.n_layers):
        if cfg.remat:
            x = torch.utils.checkpoint.checkpoint(_train_layer, params, cfg, i, x, rope_cs,
                                                  use_reentrant=False)
        else:
            x = _train_layer(params, cfg, i, x, rope_cs)
    return _logits(params, x)


def lm_loss(params: Params, tokens, cfg: LMConfig):
    """Mean next-token cross entropy over positions 0 .. S-2."""
    if cfg.attention == "ring_zigzag":
        raise ValueError(
            "lm_loss's [:, 1:] shift assumes NATURAL token order; the "
            "zigzag layout breaks that adjacency — use "
            "zigzag_lm_arrays + lm_loss_with_targets instead"
        )
    tokens = torch.as_tensor(tokens, device=params["emb"].device).to(torch.int64)
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    weights = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    weights[:, -1] = 0.0
    return lm_loss_with_targets(params, tokens, targets, weights, cfg)


def lm_loss_with_targets(params: Params, tokens, targets, weights, cfg: LMConfig):
    """Weighted next-token cross entropy with explicit per-position
    targets: ``sum(nll * w) / max(sum(w), 1e-9)``."""
    dev = params["emb"].device
    logits = lm_forward(params, tokens, cfg)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    targets = torch.as_tensor(targets, device=dev).to(torch.int64)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    w = torch.as_tensor(weights, device=dev).to(torch.float32)
    # eps only guards all-zero weights (loss 0); fractional weight sums
    # must divide through unscaled
    return (nll * w).sum() / torch.clamp_min(w.sum(), 1e-9)


def value_and_grad(loss_fn, params: Params):
    """``(loss, grads)`` of ``loss_fn(params)``, as ``jax.value_and_grad``
    gives them: the loss detached, a gradient for every parameter. The
    caller's tensors are not marked as requiring gradients."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _sgd(params: Params, loss_fn, lr: float, donate: bool):
    """loss and gradients of ``loss_fn(params)``, then ``p - lr * g``:
    in place on the caller's tensors with ``donate``, else into new
    tensors (the caller's are left as they were)."""
    loss, grads = value_and_grad(loss_fn, params)
    with torch.no_grad():
        if donate:
            new = {k: v.detach().sub_(lr * grads[k]) for k, v in params.items()}
        else:
            new = {k: v.detach() - lr * grads[k] for k, v in params.items()}
    return new, loss


def make_lm_train_step(cfg: LMConfig, lr: float = 0.3, donate: bool = False,
                       steps_per_launch: int = 1):
    """SGD train step ``step(params, tokens) -> (params, loss)``.

    ``donate=True`` lets the step update the caller's parameter tensors
    in place (the JAX package donates their buffers); without it they are
    left unchanged, so two configs can step from the same initial params.
    ``steps_per_launch > 1`` takes a stacked ``[T, B, S]`` batch, runs T
    sequential steps (a Python loop where JAX scans) and returns
    ``(params, losses[T])``, the trajectory of T separate calls."""
    if cfg.attention == "ring_zigzag":
        raise ValueError(
            "the zigzag layout needs explicit targets — use "
            "make_lm_train_step_with_targets (+ zigzag_lm_arrays)"
        )
    if steps_per_launch < 1:
        raise ValueError(f"steps_per_launch must be >= 1, got {steps_per_launch}")

    def one(params, tokens, donate_now):
        return _sgd(params, lambda p: lm_loss(p, tokens, cfg), lr, donate_now)

    if steps_per_launch == 1:
        return lambda params, tokens: one(params, tokens, donate)

    def step(params, tokens_stack):
        losses = []
        for t in range(len(tokens_stack)):
            # the first step honours `donate`; later ones own their params
            params, loss = one(params, tokens_stack[t], donate or t > 0)
            losses.append(loss)
        return params, torch.stack(losses)

    return step


def make_lm_train_step_with_targets(cfg: LMConfig, lr: float = 0.3, donate: bool = False):
    """SGD train step on ``(params, tokens, targets, weights)``, the
    layout-agnostic factory; ``donate`` as in :func:`make_lm_train_step`."""

    def step(params, tokens, targets, weights):
        return _sgd(params, lambda p: lm_loss_with_targets(p, tokens, targets, weights, cfg), lr,
                    donate)

    return step


# -- the KV cache: (data, scale); scale None = the compute dtype, else
# int8 data with one float32 scale per [layer, batch, kv-head, position] --


def _quant_kv_i8(x):
    """Symmetric per-row int8: x [..., hd] -> (int8 rows, f32 scale per
    row), scale = max|x| / 127; rounds half to even, as ``jnp.round``."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(-1) / 127.0
    q = torch.round(x32 / torch.clamp_min(scale, 1e-30)[..., None]).to(torch.int8)
    return q, scale


def _cache_write(cache, idx, val):
    """Write ``val`` [..., hd] into ``cache`` at ``idx`` (indexing
    [layer, :, :, position(s)] on both arrays), in place."""
    data, scale = cache
    if scale is None:
        data[idx] = val.to(data.dtype)
    else:
        q, s = _quant_kv_i8(val)
        data[idx] = q
        scale[idx] = s


def _cache_layer(cache, i: int):
    """Layer ``i`` of a cache as float32 [B, kvh, T, hd], dequantized."""
    data, scale = cache
    full = data[i].to(torch.float32)
    if scale is not None:
        full = full * scale[i][..., None]
    return full


def _alloc_kv_caches(cfg: LMConfig, b: int, total: int, device):
    """(kcache, vcache) for ``total`` slots, zeroed: [layers, B, kv
    heads, total, head_dim] in the compute dtype, or int8 plus float32
    scales under ``kv_cache_dtype="int8"``."""
    shape = (cfg.n_layers, b, cfg.kv_heads, total, cfg.head_dim)

    def one():
        if cfg.kv_cache_dtype == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return torch.zeros(shape, dtype=cfg.dtype, device=device), None

    return one(), one()


def _cache_write_rows(cache, i: int, qpos, val):
    """Write ``val`` [B, C, kvh, hd] into layer ``i`` at per-row
    positions ``qpos`` [B, C], in place."""
    data, scale = cache
    rows = torch.arange(val.shape[0], device=val.device)[:, None]
    if scale is None:
        data[i][rows, :, qpos] = val.to(data.dtype)
    else:
        q, s = _quant_kv_i8(val)
        data[i][rows, :, qpos] = q
        scale[i][rows, :, qpos] = s


def _attend_cache(q32, kcache, vcache, i: int, keep, hd: int, spec: str):
    """Scores against every cached slot, masked to ``keep``, softmax,
    then the weighted sum of values (all float32)."""
    s = torch.einsum(f"{spec},bktd->{spec[:-1]}t", q32, _cache_layer(kcache, i)) / math.sqrt(hd)
    p = torch.softmax(torch.where(keep, s, _NEG), dim=-1)
    return torch.einsum(f"{spec[:-1]}t,bktd->{spec[:-1]}d", p, _cache_layer(vcache, i))


def _chunk_decode(w, cfg: LMConfig, toks, kcache, vcache, pos):
    """``toks`` [B, C] at absolute positions ``pos[:, None] + arange(C)``
    (per-row ``pos`` [B]): writes both caches there (each chunk position
    attends everything cached up to itself) and returns logits [B, C,
    vocab]. C = 1 is the ragged decode step, C = gamma + 1 speculative
    decoding's verify pass. ``w``: the weights as :func:`_weights` casts
    them, once per call of :func:`lm_generate` or of speculative decoding;
    the same for :func:`_decode_step` and :func:`_prefill`."""
    b, c = toks.shape
    kvh, hd = cfg.kv_heads, cfg.head_dim
    g = cfg.n_heads // kvh
    t_max = kcache[0].shape[3]
    x = _embed(w, cfg, toks)
    qpos = pos[:, None] + torch.arange(c, device=toks.device)  # [B, C]
    t_range = torch.arange(t_max, device=toks.device)
    keep = t_range[None, None, :] <= qpos[..., None]  # [B, C, T]
    if cfg.window is not None:
        keep &= (qpos[..., None] - t_range[None, None, :]) < cfg.window
    keep = keep[:, :, None, None, :]
    cos, sin = _rope_tables(qpos, hd, cfg.rope_theta) if cfg.rope else (None, None)
    for i in range(cfg.n_layers):
        h = _ln(x, w[f"l{i}/ln1"])
        q = (h @ w[f"l{i}/wq"]).reshape(b, c, kvh, g, hd)
        k = (h @ w[f"l{i}/wk"]).reshape(b, c, kvh, hd)
        v = (h @ w[f"l{i}/wv"]).reshape(b, c, kvh, hd)
        if cfg.rope:  # the cache stores ROTATED k
            q = _rotate(q, cos[:, :, None, None, :], sin[:, :, None, None, :])
            k = _rotate(k, cos[:, :, None, :], sin[:, :, None, :])
        _cache_write_rows(kcache, i, qpos, k)
        _cache_write_rows(vcache, i, qpos, v)
        att = _attend_cache(q.to(torch.float32), kcache, vcache, i, keep, hd, "bckgd")
        x = x + att.reshape(b, c, cfg.d_model).to(cfg.dtype) @ w[f"l{i}/wo"]
        x = _ffn(w, cfg, i, x)
    return _logits(w, x)


def _decode_step(w, cfg: LMConfig, tok, kcache, vcache, pos: int):
    """One KV-cached decode step at the scalar position ``pos`` (a
    Python int, so the cache writes are plain slices and nothing waits
    on the device): tok [B] -> logits [B, vocab]. The fast path of
    :func:`_chunk_decode` with C = 1 and equal to it (tested)."""
    b = tok.shape[0]
    kvh, hd = cfg.kv_heads, cfg.head_dim
    g = cfg.n_heads // kvh
    t_max = kcache[0].shape[3]
    x = _embed(w, cfg, tok)
    t_range = torch.arange(t_max, device=tok.device)
    keep = t_range <= pos
    if cfg.window is not None:
        keep &= (pos - t_range) < cfg.window
    if cfg.rope:
        cos, sin = _rope_tables(t_range[pos], hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        h = _ln(x, w[f"l{i}/ln1"])
        q = (h @ w[f"l{i}/wq"]).reshape(b, kvh, g, hd)
        k = (h @ w[f"l{i}/wk"]).reshape(b, kvh, hd)
        v = (h @ w[f"l{i}/wv"]).reshape(b, kvh, hd)
        if cfg.rope:
            q = _rotate(q, cos, sin)
            k = _rotate(k, cos, sin)
        idx = (i, slice(None), slice(None), pos)
        _cache_write(kcache, idx, k)
        _cache_write(vcache, idx, v)
        att = _attend_cache(q.to(torch.float32), kcache, vcache, i, keep, hd, "bkgd")
        x = x + att.reshape(b, cfg.d_model).to(cfg.dtype) @ w[f"l{i}/wo"]
        x = _ffn(w, cfg, i, x)
    return _logits(w, x)


def _prefill_attention(q, k, v, window):
    """Prefill attention: q [B, P, nh, hd], k/v [B, P, kvh, hd] -> [B, P,
    nh*hd], causal, through :func:`flash_mha` (the CUDA kernel on the
    card, its plain version on the CPU)."""
    b, p_len, nh, hd = q.shape
    kvh = k.shape[2]
    return flash_mha(q.reshape(b, p_len, nh * hd), k.reshape(b, p_len, kvh * hd),
                     v.reshape(b, p_len, kvh * hd), nh, n_kv_heads=kvh, causal=True,
                     window=window)


def _prefill(w, cfg: LMConfig, prompt, kcache, vcache):
    """Batched prompt ingestion: ONE causal forward over [B, P] writes
    cache slots [0, P) of every layer and returns every prompt
    position's logits [B, P, vocab]."""
    b, p_len = prompt.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    x = _embed(w, cfg, prompt)
    if cfg.rope:
        cos, sin = _rope_tables(torch.arange(p_len, device=prompt.device)[None, :, None], hd,
                                cfg.rope_theta)
    for i in range(cfg.n_layers):
        h = _ln(x, w[f"l{i}/ln1"])
        q = (h @ w[f"l{i}/wq"]).reshape(b, p_len, nh, hd)
        k = (h @ w[f"l{i}/wk"]).reshape(b, p_len, kvh, hd)
        v = (h @ w[f"l{i}/wv"]).reshape(b, p_len, kvh, hd)
        if cfg.rope:
            q = _rotate(q, cos, sin)
            k = _rotate(k, cos, sin)
        idx = (i, slice(None), slice(None), slice(None, p_len))
        _cache_write(kcache, idx, k.transpose(1, 2))
        _cache_write(vcache, idx, v.transpose(1, 2))
        att = _prefill_attention(q, k, v, cfg.window).to(cfg.dtype)
        x = x + att @ w[f"l{i}/wo"]
        x = _ffn(w, cfg, i, x)
    return _logits(w, x)


# -- sampling --


def _categorical(z, generator):
    """One draw per row from softmax(z) by the Gumbel-max trick (what
    ``jax.random.categorical`` does, with the generator's noise);
    ``-inf`` entries are never drawn."""
    u = torch.rand(z.shape, generator=generator, device=z.device)
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
    return torch.argmax(z + gumbel, dim=-1)


def _truncate(logits, temperature: float, top_p: float, *, top_k, has_top_p):
    """``logits / temperature`` with the tokens outside the top-k and
    the nucleus set to ``-inf`` (k-truncate, then nucleus)."""
    z = logits / temperature
    if top_k is not None:
        kth = torch.sort(z, dim=-1).values[:, -top_k][:, None]
        z = torch.where(z >= kth, z, -torch.inf)
    if has_top_p:
        # keep a token iff the probability mass strictly before it in
        # descending order is < top_p: the argmax always survives
        zs = torch.sort(z, dim=-1, descending=True).values
        ps = torch.softmax(zs, dim=-1)
        before = torch.cumsum(ps, dim=-1) - ps
        cutoff = torch.where(before < top_p, zs, torch.inf).amin(dim=-1, keepdim=True)
        z = torch.where(z >= cutoff, z, -torch.inf)
    return z


def _pick_token(logits, generator, temperature, top_p, *, greedy, top_k, has_top_p):
    """Greedy argmax or temperature / top-k / top-p sampling of one token
    per row."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    return _categorical(_truncate(logits, temperature, top_p, top_k=top_k, has_top_p=has_top_p),
                        generator)


@dataclasses.dataclass(frozen=True)
class GenState:
    """Resumable generation state, as the JAX package's: the caches,
    the last token, the length so far; ``boundary_cached`` says whether
    the last token's cache slot is written (then ``last_logits`` holds
    the next-token logits)."""

    kcache: tuple
    vcache: tuple
    last_tok: torch.Tensor  # [B]
    length: int
    boundary_cached: bool = False
    last_logits: Optional[torch.Tensor] = None  # [B, vocab], f32

    @property
    def capacity(self) -> int:
        return self.kcache[0].shape[3]


def _validate_prompt_lengths(prompt_lengths, prompt) -> torch.Tensor:
    lens = np.asarray(prompt_lengths.cpu() if isinstance(prompt_lengths, torch.Tensor)
                      else prompt_lengths)
    if lens.ndim != 1 or lens.shape[0] != prompt.shape[0]:
        raise ValueError(f"prompt_lengths must be [B={prompt.shape[0]}], got shape {lens.shape}")
    if lens.min() < 1 or lens.max() > prompt.shape[1]:
        raise ValueError(f"prompt_lengths must lie in [1, padded width={prompt.shape[1]}], "
                         f"got range [{lens.min()}, {lens.max()}]")
    return torch.as_tensor(lens.astype(np.int64), device=prompt.device)


def _sampling_args(cfg: LMConfig, temperature, top_k, top_p, generator):
    """Validation shared by the generate family; returns (greedy,
    temperature, top_p)."""
    greedy = temperature is None or temperature == 0
    if temperature is not None and temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not greedy and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    if top_k is not None:
        if greedy:
            raise ValueError("top_k requires sampling: pass temperature > 0")
        if not 1 <= top_k <= cfg.vocab:
            raise ValueError(f"top_k must be in [1, vocab={cfg.vocab}], got {top_k}")
    if top_p is not None:
        if greedy:
            raise ValueError("top_p requires sampling: pass temperature > 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    return greedy, 1.0 if greedy else float(temperature), 1.0 if top_p is None else float(top_p)


def lm_generate(params: Params, prompt, cfg: LMConfig, steps: int, *,
                return_logits: bool = False, return_state: bool = False,
                max_len: "int | None" = None, prompt_lengths=None, eos_id: "int | None" = None,
                temperature=None, top_k: "int | None" = None, top_p: "float | None" = None,
                generator: "torch.Generator | None" = None):
    """KV-cached decoding: ONE batched causal forward ingests the prompt
    [B, P] and fills the caches, then ``steps`` tokens are decoded one
    at a time. Returns the tokens [B, P + steps] (int64), on the
    parameters' device.

    As the JAX ``lm_generate``: ``temperature=None`` (or 0) is greedy;
    otherwise softmax(logits / temperature), truncated to ``top_k`` and
    the ``top_p`` nucleus, drawn with ``generator`` (a ``torch.Generator``
    on the parameters' device, in place of the JAX ``key``). ``eos_id``
    freezes a row after it emits that token (pads 0 after it).
    ``prompt_lengths`` [B] makes the batch ragged (right-padded prompts,
    row b continues at ``len_b``; tokens only). ``return_logits``
    appends the [B, P + steps - 1, vocab] logits (row t predicts token
    t + 1); ``return_state`` appends a :class:`GenState`; ``max_len``
    sizes its caches."""
    greedy, temp, top_p_val = _sampling_args(cfg, temperature, top_k, top_p, generator)
    device = params["emb"].device
    prompt = torch.as_tensor(prompt, device=device).to(torch.int64)
    total = prompt.shape[1] + steps
    capacity = max_len if max_len is not None else total
    if capacity < total:
        raise ValueError(f"max_len={max_len} < prompt+steps={total}: the caches cannot hold "
                         "the generation being requested")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(f"eos_id must be in [0, vocab={cfg.vocab}), got {eos_id}")
    if eos_id is not None and (return_state or return_logits):
        raise ValueError("eos_id does not compose with return_state/return_logits: frozen "
                         "rows cache pad tokens")

    def pick(logits):
        return _pick_token(logits, generator, temp, top_p_val, greedy=greedy, top_k=top_k,
                           has_top_p=top_p is not None)

    w = _weights(params, cfg)
    if prompt_lengths is not None:
        if return_logits or return_state:
            raise ValueError("prompt_lengths (ragged batches) does not compose with "
                             "return_logits/return_state")
        if steps == 0:
            raise ValueError("ragged generation needs steps >= 1")
        lengths = _validate_prompt_lengths(prompt_lengths, prompt)
        return _generate_ragged(w, cfg, prompt, lengths, steps, capacity, pick, eos_id)
    toks, logits, state = _generate_dense(w, cfg, prompt, steps, capacity, pick, eos_id,
                                          return_logits, return_state)
    out = (toks,) + ((logits,) if return_logits else ()) + ((state,) if return_state else ())
    return out if len(out) > 1 else toks


def _generate_dense(w, cfg, prompt, steps, capacity, pick, eos_id, return_logits, return_state):
    b, p_len = prompt.shape
    total = p_len + steps
    kcache, vcache = _alloc_kv_caches(cfg, b, capacity, prompt.device)
    toks = torch.zeros((b, total), dtype=torch.int64, device=prompt.device)
    toks[:, :p_len] = prompt
    prefill_logits = _prefill(w, cfg, prompt, kcache, vcache)
    if steps == 0:
        state = GenState(kcache, vcache, toks[:, total - 1], total, True, prefill_logits[:, -1])
        return toks, prefill_logits[:, :-1], state if return_state else None
    first = pick(prefill_logits[:, -1])
    toks[:, p_len] = first
    done = first == eos_id if eos_id is not None else None
    gen_logits = []
    # positions p_len .. total-2: each processes an already-written token
    # and writes the next one
    for pos in range(p_len, total - 1):
        logits = _decode_step(w, cfg, toks[:, pos], kcache, vcache, pos)
        nxt = pick(logits)
        if done is not None:
            nxt = torch.where(done, 0, nxt)
            done |= nxt == eos_id
        toks[:, pos + 1] = nxt
        if return_logits:
            gen_logits.append(logits)
    logits = torch.cat([prefill_logits, *(g[:, None] for g in gen_logits)], 1) \
        if return_logits else None
    state = GenState(kcache, vcache, toks[:, total - 1], total) if return_state else None
    return toks, logits, state


def _generate_ragged(w, cfg, prompt, lengths, steps, capacity, pick, eos_id):
    """Right-padded prompt [B, P] + per-row lengths: one padded prefill,
    then C = 1 chunk decode steps at per-row positions. Pad slots are
    never attended: each is overwritten by a generated token before the
    row's position admits it."""
    b, p_len = prompt.shape
    dev = prompt.device
    kcache, vcache = _alloc_kv_caches(cfg, b, capacity, dev)
    rows = torch.arange(b, device=dev)
    out = torch.zeros((b, p_len + steps), dtype=torch.int64, device=dev)
    col = torch.arange(p_len, device=dev)
    out[:, :p_len] = torch.where(col[None, :] < lengths[:, None], prompt, 0)
    prefill_logits = _prefill(w, cfg, prompt, kcache, vcache)
    cur = pick(prefill_logits[rows, lengths - 1])
    out[rows, lengths] = cur
    done = cur == eos_id if eos_id is not None else None
    for t in range(steps - 1):
        pos = lengths + t
        logits = _chunk_decode(w, cfg, cur[:, None], kcache, vcache, pos)
        nxt = pick(logits[:, 0])
        if done is not None:
            nxt = torch.where(done, 0, nxt)
            done |= nxt == eos_id
        out[rows, pos + 1] = nxt
        cur = nxt
    return out


# -- multi-turn continuation --


def lm_generate_continue(params: Params, state: GenState, cfg: LMConfig, steps: int, *,
                         new_tokens=None, temperature=None, top_k: "int | None" = None,
                         top_p: "float | None" = None,
                         generator: "torch.Generator | None" = None):
    """Extend a :class:`GenState` by ``steps`` tokens without re-reading
    the history: ``new_tokens`` [B, M] (the next turn) goes through the
    caches in ONE :func:`_chunk_decode` pass, then ``steps`` tokens are
    decoded one at a time. Returns ``(generated [B, steps], new state)``.
    The state's capacity (``lm_generate(..., max_len=)``) must hold
    ``state.length + M + steps`` slots, else ``ValueError``. Sampling as
    :func:`lm_generate`.

    ``steps=0`` with ``new_tokens`` ingests the turn only: the new state
    is ``boundary_cached`` and carries the turn's next-token logits, so
    the next call starts from them and rewrites no cached slot. ``steps=0``
    without tokens returns the state as it is.

    The caches are extended IN PLACE (JAX returns new ones). A state
    handed in earlier stays usable: the slots it has not written are
    rewritten before they are read."""
    greedy, temp, top_p_val = _sampling_args(cfg, temperature, top_k, top_p, generator)
    b = state.last_tok.shape[0]
    dev = state.last_tok.device
    m = 0 if new_tokens is None else new_tokens.shape[1]
    if steps == 0 and m == 0:
        return torch.zeros((b, 0), dtype=torch.int64, device=dev), state
    need = state.length + m + steps
    if need > state.capacity:
        raise ValueError(f"continuation needs {need} cache slots but the state was allocated "
                         f"{state.capacity} — create it with lm_generate(..., max_len={need}) "
                         "or more")
    new_tokens = (torch.zeros((b, 0), dtype=torch.int64, device=dev) if new_tokens is None
                  else torch.as_tensor(new_tokens, device=dev).to(torch.int64))
    w = _weights(params, cfg)
    kc, vc = state.kcache, state.vcache

    def at(pos):
        return torch.full((b,), pos, dtype=torch.int64, device=dev)

    if state.boundary_cached:
        # every slot so far is written: ingest only the new turn, or start
        # from the carried logits
        src_logits = (_chunk_decode(w, cfg, new_tokens, kc, vc, at(state.length))[:, -1]
                      if m > 0 else state.last_logits)
    else:
        # the last token's slot is pending: ingest [last token, new turn]
        chunk = torch.cat([state.last_tok[:, None].to(torch.int64), new_tokens], 1)
        src_logits = _chunk_decode(w, cfg, chunk, kc, vc, at(state.length - 1))[:, -1]
    if steps == 0:
        return (torch.zeros((b, 0), dtype=torch.int64, device=dev),
                GenState(kc, vc, new_tokens[:, -1], need, True, src_logits))

    def pick(logits):
        return _pick_token(logits, generator, temp, top_p_val, greedy=greedy, top_k=top_k,
                           has_top_p=top_p is not None)

    start = state.length + m  # the absolute position of the first generated token
    gen = torch.zeros((b, steps), dtype=torch.int64, device=dev)
    gen[:, 0] = pick(src_logits)
    for i in range(steps - 1):
        gen[:, i + 1] = pick(_decode_step(w, cfg, gen[:, i], kc, vc, start + i))
    return gen, GenState(kc, vc, gen[:, -1], need)


# -- beam search --


def _top(x, k: int):
    """The ``k`` largest of each row and their indices, equal values in
    index order, as ``jax.lax.top_k`` (``torch.topk`` promises no order
    for ties on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def lm_beam_search(params: Params, prompt, cfg: LMConfig, steps: int, *, beam_width: int = 4,
                   eos_id: "int | None" = None, length_penalty: float = 0.0, prompt_lengths=None):
    """Beam search over the KV-cached decode path: the ``beam_width``
    highest-log-probability continuations of each prompt, as ``(tokens
    [B, W, P + steps], scores [B, W])`` best first.

    One prefill fills the caches, which are then tiled W times (rows
    ``b * W + w``); each step scores all ``W * vocab`` candidates, keeps
    the top W (ties to the lower index, as ``jax.lax.top_k``) and
    reorders every cache leaf, the int8 scales too, by each survivor's
    parent. ``scores`` are sums of next-token log-probabilities.

    ``eos_id``: a beam that emits it is finished: its score freezes and it
    pads with 0, competing as one candidate. ``length_penalty`` alpha
    divides by ``((5 + len) / 6) ** alpha`` at the final ranking only
    (``len`` the generated tokens, eos included), sorted stably as
    ``jnp.argsort``. ``prompt_lengths`` [B] makes the batch ragged, as in
    :func:`lm_generate`: row b's beams continue at ``len_b``, zeros past
    ``len_b + steps``, each prompt's beams those of a single-prompt call.
    Deterministic."""
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab:
        raise ValueError(f"eos_id must be in [0, vocab={cfg.vocab}), got {eos_id}")
    if beam_width > cfg.vocab:
        raise ValueError(f"beam_width {beam_width} > vocab {cfg.vocab}: the first expansion "
                         "cannot fill the beams")
    dev = params["emb"].device
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    ragged = prompt_lengths is not None
    lengths = (_validate_prompt_lengths(prompt_lengths, prompt) if ragged else
               torch.full((prompt.shape[0],), prompt.shape[1], dtype=torch.int64, device=dev))
    toks, scores, gen_len = _beam(_weights(params, cfg), cfg, prompt, lengths, eos_id, steps,
                                  beam_width, ragged)
    ranked = scores
    if length_penalty:
        six = scalar_like(6.0, scores)
        ranked = scores / ((5.0 + gen_len.to(torch.float32)) / six) ** float(length_penalty)
    order = torch.sort(-ranked, dim=1, stable=True).indices
    return (toks.gather(1, order[:, :, None].expand(-1, -1, toks.shape[2])),
            scores.gather(1, order))


def _beam(w, cfg: LMConfig, prompt, lengths, eos_id, steps: int, width: int, ragged: bool):
    b, p_len = prompt.shape
    dev, vocab = prompt.device, cfg.vocab
    total = p_len + steps
    kc, vc = _alloc_kv_caches(cfg, b, total, dev)
    prefill_logits = _prefill(w, cfg, prompt, kc, vc)
    rows = torch.arange(b, device=dev)
    # each prompt's first expansion reads ITS last real position
    last = prefill_logits[rows, lengths - 1] if ragged else prefill_logits[:, -1]
    del prefill_logits
    scores, tok = _top(torch.log_softmax(last.to(torch.float32), dim=-1), width)  # [B, W]

    def tile(cache):  # [L, B, ...] -> [L, B*W, ...], beam-major rows b*W + w
        return tuple(None if x is None else x.repeat_interleave(width, dim=1) for x in cache)

    kc, vc = tile(kc), tile(vc)
    base = torch.where(torch.arange(p_len, device=dev)[None, :] < lengths[:, None], prompt, 0) \
        if ragged else prompt
    toks = torch.zeros((b, width, total), dtype=torch.int64, device=dev)
    toks[:, :, :p_len] = base[:, None, :]
    beams = torch.arange(width, device=dev)[None, :]
    if ragged:
        toks[rows[:, None], beams, lengths[:, None]] = tok
    else:
        toks[:, :, p_len] = tok
    done = tok == eos_id if eos_id is not None else None
    gen_len = torch.ones((b, width), dtype=torch.int32, device=dev)  # tokens emitted, eos included
    batch_base = (rows * width)[:, None]
    lengths_rows = lengths.repeat_interleave(width)
    if eos_id is not None:  # a finished beam's only candidate: pad at an unchanged score
        frozen = torch.full((vocab,), -torch.inf, device=dev)
        frozen[0] = 0.0
    for t in range(steps - 1):
        cur = tok.reshape(b * width)
        if ragged:  # per-row positions through the chunk path
            logits = _chunk_decode(w, cfg, cur[:, None], kc, vc, lengths_rows + t)[:, 0]
        else:
            logits = _decode_step(w, cfg, cur, kc, vc, p_len + t)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(b, width, vocab)
        if done is not None:
            logp = torch.where(done[:, :, None], frozen, logp)
        scores, idx = _top((scores[:, :, None] + logp).reshape(b, width * vocab), width)
        parent, tok = idx // vocab, idx % vocab
        toks = toks.gather(1, parent[:, :, None].expand(-1, -1, total))
        gen_len = gen_len.gather(1, parent)
        flat_parent = (batch_base + parent).reshape(-1)
        kc, vc = (tuple(None if x is None else x[:, flat_parent] for x in c) for c in (kc, vc))
        if ragged:
            toks[rows[:, None], beams, (lengths + t + 1)[:, None]] = tok
        else:
            toks[:, :, p_len + 1 + t] = tok
        if done is not None:
            done = done.gather(1, parent)
            gen_len += (~done).to(torch.int32)
            done |= tok == eos_id
        else:
            gen_len += 1
    return toks, scores, gen_len
