"""KV-cached decoder-only LM serving.

Counterpart of the serving half of ``parameter_server_tpu/models/transformer.py``:
:class:`LMConfig`, :func:`init_lm`, the int8 or compute-dtype KV cache,
the batched causal prefill, the one-token and chunked decode steps, and
:func:`lm_generate` (dense and ragged batches, greedy or sampled, with
``eos_id``, ``return_logits`` and ``return_state``). Parameters are a
plain dict of float32 tensors with the JAX package's names (``emb``,
``ln_f``, ``l{i}/ln1|ln2|wq|wk|wv|wo|w1|w2``); :mod:`..convert` carries
them over from the JAX package.

On the card the prefill's attention is the CUDA kernel ``flash_fwd``
(:func:`..ops.flash_attention.flash_mha`); on the CPU it is that
kernel's plain version. The decode step's attention is plain tensor
code over the cache, as it is in the JAX package, and the projections
and MLP are ``torch.matmul``. Everything follows the device of the
parameters it is given.

Differences from the JAX package, none of which changes a result:

- caches are written IN PLACE (``cache[i, :, :, pos] = ...``), where JAX
  updates them functionally and XLA in place;
- the weights are cast to the compute dtype once per call, as XLA
  hoists the cast out of its decode scan;
- ``jax.random`` keys become an explicit ``torch.Generator``; the draws
  differ, so sampled runs match JAX in distribution, not draw for draw;
  :func:`init_lm` draws its normal(0, 0.02) weights from a seeded
  ``torch.Generator``, so its values differ from JAX's ``init_lm``;
- the decode loops are Python loops (``lax.scan`` in JAX).

Not here yet: the training forward and loss (``lm_forward``,
``lm_loss``, the ring / zigzag / Ulysses schedules), beam search,
``lm_generate_continue`` and MoE layers (``moe_every > 0`` raises
``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve
from ..ops.flash_attention import flash_mha

Params = Dict[str, torch.Tensor]
_NEG = -1e30  # finite mask value, as in the JAX package


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX package's ``LMConfig``, field for field and with its
    validation. ``attention`` and ``remat`` shape training only; serving
    reads them for validation."""

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
        if self.moe_every > 0:
            raise NotImplementedError("LMConfig.moe_every > 0: MoE layers (the dropless serving "
                                      "FFN) are not ported yet (ROADMAP Queue A item 11)")

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
        p[f"l{i}/w1"] = normal(d, cfg.d_ff)
        p[f"l{i}/w2"] = normal(cfg.d_ff, d)
    return {k: v.to(dev) for k, v in p.items()}


_LAYER_WEIGHTS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w1", "w2")


def _weights(params: Params, cfg: LMConfig) -> Params:
    """The layer weights cast to the compute dtype, once per call (a
    no-op for float32); ``emb`` and ``ln_f`` stay float32."""
    w = dict(params)
    for i in range(cfg.n_layers):
        for name in _LAYER_WEIGHTS:
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


def _mlp(w, i: int, x):
    h2 = _ln(x, w[f"l{i}/ln2"])
    return x + F.gelu(h2 @ w[f"l{i}/w1"], approximate="tanh") @ w[f"l{i}/w2"]


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
        x = _mlp(w, i, x)
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
        x = _mlp(w, i, x)
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
        x = _mlp(w, i, x)
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
