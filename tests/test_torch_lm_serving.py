"""PyTorch port: KV-cached LM serving and speculative decoding against the JAX package.

Both sides run on the CPU on the same weights: the JAX ``init_lm`` dict,
carried into the port by ``convert.lm_params_from_jax``. The weights are
scaled up (embedding x2, matrices x15) so that greedy decoding of the
random model does not collapse onto one repeated token. Prompts come
from numpy seeds. The port's prefill attention is the flash kernel's
plain version; the JAX prefill off the TPU is its chunked XLA path, held
to the Pallas kernel by ``tests/test_transformer.py`` (and the port's
prefill attention to it in ``tests/test_torch_flash_attention.py``).

Tolerances:

- float32: logits within 1e-4 absolute (float32 sums in other orders
  through two layers; about 1e-6 is seen), caches within 1e-5, greedy
  tokens equal;
- float32 with the int8 cache: the same, the caches compared after
  dequantization; both sides quantize the same float32 rows, so the codes
  agree and the cache's quantize / dequantize wiring is held tightly;
- bfloat16: the two frameworks round at other points (layer norm, GELU,
  matmul outputs), so logits and caches are held to 3x the config's own
  bf16 noise, measured on the reference alone: the largest gap between
  the JAX package's bf16 and float32 runs of the same weights on the
  same tokens (teacher-forced prefill). A fault of the port's bf16 path
  does not widen that bound. Greedy tokens are compared up to each
  row's first difference, which must fall at a near-tie: JAX's logits
  for the two tokens within that tolerance. Logits and cache slots
  before it are compared; after it the inputs differ.

Sampling cannot match draw for draw (``torch.Generator`` vs
``jax.random``), so it is held to the distribution: top-k = 1 is greedy,
the top-k / top-p survivor sets equal the tokens JAX's ``_pick_token``
draws, and a chi-square test of the port's draws against
softmax(z / T).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parameter_server_tpu.models import speculative as jspec
from parameter_server_tpu.models import transformer as jtr
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.models import speculative as tspec
from parameter_server_tpu_torch.models import transformer as ttr

torch.set_num_threads(1)

BASE = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128)
B, P, STEPS = 3, 16, 12
F32_LOGIT_TOL, F32_CACHE_TOL = 1e-4, 1e-5
BF16_NOISE_MULTIPLE = 3.0


def _scaled(jparams):
    return {k: np.asarray(v) * (1.0 if "ln" in k else 2.0 if k == "emb" else 15.0)
            for k, v in jparams.items()}


def setup(seed=0, **kw):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    base = {**BASE, **kw}
    jc, tc = jtr.LMConfig(**base), ttr.LMConfig(**base)
    npp = _scaled(jtr.init_lm(jax.random.PRNGKey(seed), jc))
    return jc, tc, {k: jnp.asarray(v) for k, v in npp.items()}, \
        convert.lm_params_from_jax(npp, tc, device="cpu")


def _prompt(seed=0, b=B, p=P, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, p)).astype(np.int32)


def _bf16_noise(jp, jc, seq):
    """max |logits| gap and max |cache| gap between the JAX package's
    bf16 and float32 runs of the same weights, teacher-forced on ``seq``:
    the reference's own rounding noise, independent of the port."""
    jc32 = dataclasses.replace(jc, compute_dtype="float32", kv_cache_dtype=None)
    _, l16, s16 = jtr.lm_generate(jp, jnp.asarray(seq), jc, 0, return_logits=True,
                                  return_state=True)
    _, l32, s32 = jtr.lm_generate(jp, jnp.asarray(seq), jc32, 0, return_logits=True,
                                  return_state=True)
    cache_gap = max(float((_dequant(a) - _dequant(c)).abs().max())
                    for a, c in ((s16.kcache, s32.kcache), (s16.vcache, s32.vcache)))
    return float(np.abs(np.asarray(l16) - np.asarray(l32)).max()), cache_gap


def _dequant(cache):
    data, scale = (torch.tensor(np.asarray(x, np.float32)) if x is not None and not
                   isinstance(x, torch.Tensor) else x for x in cache)
    data = data.float()
    return data if scale is None else data * scale.float()[..., None]


def _first_diff(a, b, start):
    """Per row: the first column >= start where a and b differ (else width)."""
    diff = a[:, start:] != b[:, start:]
    return np.where(diff.any(1), diff.argmax(1) + start, a.shape[1])


def _check_near_ties(want_logits, want_toks, got_toks, first, tol):
    """A row whose tokens part at column t must part at a near-tie: JAX's
    logits row t - 1 rates the two tokens within ``tol``."""
    for r, t in enumerate(first):
        if t < want_toks.shape[1]:
            row = want_logits[r, t - 1]
            gap = abs(float(row[want_toks[r, t]]) - float(row[got_toks[r, t]]))
            assert gap <= tol, (r, t, gap, tol)


CONFIGS = {
    "f32_mha": dict(),
    "f32_gqa_rope_window": dict(n_kv_heads=2, rope=True, window=7),
    "f32_gqa_int8": dict(n_kv_heads=2, kv_cache_dtype="int8"),
    "bf16_gqa_int8": dict(n_kv_heads=2, compute_dtype="bfloat16", kv_cache_dtype="int8"),
    "bf16_gqa_rope_window": dict(n_kv_heads=2, compute_dtype="bfloat16", rope=True, window=7),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_generate_matches_jax(name):
    jc, tc, jp, tp = setup(**CONFIGS[name])
    prompt = _prompt()
    jt, jl, js = jtr.lm_generate(jp, jnp.asarray(prompt), jc, STEPS, return_logits=True,
                                 return_state=True)
    tt, tl, ts = ttr.lm_generate(tp, torch.tensor(prompt), tc, STEPS, return_logits=True,
                                 return_state=True)
    jt, jl = np.asarray(jt), np.asarray(jl)
    assert tt.shape == jt.shape and tl.shape == jl.shape and tl.dtype == torch.float32
    assert ts.length == js.length and ts.capacity == js.capacity and not ts.boundary_cached
    tt, tl = tt.numpy(), tl.numpy()
    if tc.compute_dtype == "float32":
        logit_tol, cache_tol = F32_LOGIT_TOL, F32_CACHE_TOL
        np.testing.assert_array_equal(tt, jt)
    else:
        logit_gap, cache_gap = _bf16_noise(jp, jc, jt)
        logit_tol = BF16_NOISE_MULTIPLE * logit_gap
        cache_tol = BF16_NOISE_MULTIPLE * cache_gap
    first = _first_diff(tt, jt, P)
    _check_near_ties(jl, jt, tt, first, logit_tol)
    np.testing.assert_array_equal(tt[:, :P], prompt)
    for r, t in enumerate(first):
        np.testing.assert_array_equal(tt[r, :t], jt[r, :t])
        np.testing.assert_allclose(tl[r, :t - 1], jl[r, :t - 1], rtol=0, atol=logit_tol)
        for mine, theirs in ((ts.kcache, js.kcache), (ts.vcache, js.vcache)):
            got, want = _dequant(mine)[:, r, :, :t], _dequant(theirs)[:, r, :, :t]
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=cache_tol)
            if tc.compute_dtype == "float32" and tc.kv_cache_dtype == "int8":
                np.testing.assert_array_equal(mine[0][:, r, :, :t].numpy(),
                                              np.asarray(theirs[0])[:, r, :, :t])
    np.testing.assert_array_equal(ts.last_tok.numpy(), tt[:, -1])


@pytest.mark.parametrize("d_model", [48, 96])
def test_bf16_embedding_cast_point_matches_jax(d_model):
    """With no layers the logits are ``_ln(x32, ln_f) @ emb.T`` on the
    bf16 embedding rows, so both sides agree to float32 sums
    (F32_LOGIT_TOL) only if they round the same values: the embedding
    scaled by sqrt(d_model) in float32, then cast. sqrt(d_model) is not a
    power of two here, so scaling after the cast rounds elsewhere."""
    jc, tc, jp, tp = setup(n_layers=0, d_model=d_model, compute_dtype="bfloat16",
                           kv_cache_dtype="int8", n_kv_heads=2)
    prompt = _prompt(15)
    _, jl = jtr.lm_generate(jp, jnp.asarray(prompt), jc, 0, return_logits=True)
    _, tl = ttr.lm_generate(tp, torch.tensor(prompt), tc, 0, return_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=F32_LOGIT_TOL)


def test_lm_generate_steps_zero_state_matches_jax():
    jc, tc, jp, tp = setup()
    prompt = _prompt(1)
    jt, jl, js = jtr.lm_generate(jp, jnp.asarray(prompt), jc, 0, return_logits=True,
                                 return_state=True, max_len=P + 5)
    tt, tl, ts = ttr.lm_generate(tp, torch.tensor(prompt), tc, 0, return_logits=True,
                                 return_state=True, max_len=P + 5)
    assert ts.boundary_cached and ts.capacity == P + 5 and tl.shape == (B, P - 1, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=F32_LOGIT_TOL)
    np.testing.assert_allclose(ts.last_logits.numpy(), np.asarray(js.last_logits), rtol=0,
                               atol=F32_LOGIT_TOL)


@pytest.mark.parametrize("name,eos", [("f32_mha", None), ("f32_mha", 43),
                                      ("f32_gqa_rope_window", 41)])
def test_ragged_with_eos_matches_jax(name, eos):
    jc, tc, jp, tp = setup(**CONFIGS[name])
    prompt = _prompt(2)
    lengths = np.array([16, 5, 11], np.int32)
    want = np.asarray(jtr.lm_generate(jp, jnp.asarray(prompt), jc, STEPS, prompt_lengths=lengths,
                                      eos_id=eos))
    got = ttr.lm_generate(tp, torch.tensor(prompt), tc, STEPS, prompt_lengths=lengths, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("eos", [None, 51])
def test_dense_eos_matches_jax(eos):
    jc, tc, jp, tp = setup()
    prompt = _prompt(3)
    want = np.asarray(jtr.lm_generate(jp, jnp.asarray(prompt), jc, STEPS, eos_id=eos))
    got = ttr.lm_generate(tp, torch.tensor(prompt), tc, STEPS, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_rows_equal_single_row_calls():
    _, tc, _, tp = setup(**CONFIGS["f32_gqa_rope_window"])
    prompt = _prompt(4)
    lengths = [16, 5, 11]
    out = ttr.lm_generate(tp, torch.tensor(prompt), tc, STEPS, prompt_lengths=lengths)
    for r, n in enumerate(lengths):
        solo = ttr.lm_generate(tp, torch.tensor(prompt[r:r + 1, :n]), tc, STEPS)
        assert torch.equal(out[r, :n + STEPS], solo[0])
        assert torch.all(out[r, n + STEPS:] == 0)


@pytest.mark.parametrize("kw", [
    {}, {"rope": True}, {"n_kv_heads": 2, "compute_dtype": "bfloat16"},
    {"kv_cache_dtype": "int8"}, {"window": 3, "rope": True, "n_kv_heads": 1},
])
def test_decode_step_equals_chunk_decode(kw):
    """The port pins what the JAX package pins: the scalar-position step
    and the C = 1 chunk step give the same logits and caches."""
    cfg = ttr.LMConfig(**{**dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64), **kw})
    params = ttr._weights(ttr.init_lm(0, cfg, device="cpu"), cfg)
    b, p = 2, 6
    rng = np.random.default_rng(0)
    prompt = torch.tensor(rng.integers(0, 32, (b, p)))
    k1, v1 = ttr._alloc_kv_caches(cfg, b, p + 2, "cpu")
    ttr._prefill(params, cfg, prompt, k1, v1)
    k2, v2 = (tuple(None if x is None else x.clone() for x in c) for c in (k1, v1))
    tok = torch.tensor(rng.integers(0, 32, (b,)))
    la = ttr._decode_step(params, cfg, tok, k1, v1, p)
    lb = ttr._chunk_decode(params, cfg, tok[:, None], k2, v2, torch.full((b,), p))
    tol = 2e-2 if cfg.compute_dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(la.numpy(), lb[:, 0].numpy(), atol=tol, rtol=0)
    for a, c in zip(k1 + v1, k2 + v2):
        if a is not None:
            np.testing.assert_allclose(a.float().numpy(), c.float().numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"rope": True, "n_kv_heads": 2, "window": 5}])
def test_prefill_equals_decoding_one_token_at_a_time(kw):
    """Prompt logits from the batched prefill equal feeding the prompt
    through the decode step token by token."""
    cfg = ttr.LMConfig(**{**BASE, **kw})
    params = ttr._weights(ttr.init_lm(1, cfg, device="cpu"), cfg)
    prompt = torch.tensor(_prompt(5, b=2, p=10))
    k1, v1 = ttr._alloc_kv_caches(cfg, 2, 10, "cpu")
    want = ttr._prefill(params, cfg, prompt, k1, v1)
    k2, v2 = ttr._alloc_kv_caches(cfg, 2, 10, "cpu")
    got = torch.stack([ttr._decode_step(params, cfg, prompt[:, t], k2, v2, t) for t in range(10)], 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(k2[0].numpy(), k1[0].numpy(), atol=1e-5, rtol=0)


def test_quant_kv_i8_matches_jax():
    x = np.random.default_rng(6).normal(size=(3, 4, 16)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 0, codes 0
    x[1, 1, :2] = [127.0, 0.5]  # exact halves round to even
    qj, sj = jtr._quant_kv_i8(jnp.asarray(x))
    qt, st = ttr._quant_kv_i8(torch.tensor(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_rope_ln_and_embedding_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5)[None, :, None]
    np.testing.assert_allclose(ttr.apply_rope(torch.tensor(x), torch.tensor(pos)).numpy(),
                               np.asarray(jtr.apply_rope(jnp.asarray(x), pos)), atol=1e-6, rtol=0)
    h = rng.normal(size=(4, 32)).astype(np.float32)
    s = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(ttr._ln(torch.tensor(h), torch.tensor(s)).numpy(),
                               np.asarray(jtr._ln(jnp.asarray(h), jnp.asarray(s))), atol=1e-6,
                               rtol=0)


# -- sampling --


def test_top_k_one_is_greedy():
    _, tc, _, tp = setup()
    prompt = torch.tensor(_prompt(8))
    greedy = ttr.lm_generate(tp, prompt, tc, STEPS)
    g = torch.Generator().manual_seed(3)
    assert torch.equal(ttr.lm_generate(tp, prompt, tc, STEPS, temperature=0.7, top_k=1,
                                       generator=g), greedy)
    g = torch.Generator().manual_seed(3)
    assert torch.equal(ttr.lm_generate(tp, prompt, tc, STEPS, temperature=0.9, top_p=1e-9,
                                       generator=g), greedy)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.8), (6, 0.7), (None, 0.95),
                                         (10, 0.95)])
def test_survivor_sets_equal_jax_pick_token(top_k, top_p):
    """The tokens the port's truncation keeps are exactly the tokens
    JAX's ``_pick_token`` draws over 4000 keys (each survivor is drawn
    with probability >= 0.5% here, so 4000 draws miss none but with
    probability < 1e-8)."""
    v, temp = 16, 0.7
    logits = np.random.default_rng(9).normal(size=(4, v)).astype(np.float32) * 0.8
    z = ttr._truncate(torch.tensor(logits), temp, 1.0 if top_p is None else top_p, top_k=top_k,
                      has_top_p=top_p is not None)
    keep = torch.isfinite(z)
    probs = torch.softmax(z, -1)
    assert float(probs[keep].min()) >= 0.005
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    draws = np.asarray(jax.vmap(lambda k: jtr._pick_token(
        jnp.asarray(logits), k, jnp.float32(temp), jnp.float32(1.0 if top_p is None else top_p),
        greedy=False, top_k=top_k, has_top_p=top_p is not None))(keys))
    for r in range(4):
        assert set(np.flatnonzero(keep[r].numpy())) == set(draws[:, r].tolist()), r


@pytest.mark.parametrize("top_k", [None, 4])
def test_draws_follow_softmax_chi_square(top_k):
    """20000 draws of one row against softmax(z / T) (renormalized over
    the top-k): the chi-square statistic under its 0.1% critical value."""
    v, temp, n = 8, 0.8, 20000
    z = torch.tensor(np.random.default_rng(10).normal(size=(v,)).astype(np.float32))
    g = torch.Generator().manual_seed(11)
    toks = ttr._pick_token(z.expand(n, v), g, temp, 1.0, greedy=False, top_k=top_k,
                           has_top_p=False)
    counts = np.bincount(toks.numpy(), minlength=v)
    p = torch.softmax(ttr._truncate(z[None], temp, 1.0, top_k=top_k, has_top_p=False), -1)[0]
    p = p.double().numpy()
    live = p > 0
    assert counts[~live].sum() == 0
    chi2 = float(((counts[live] - n * p[live]) ** 2 / (n * p[live])).sum())
    critical = {7: 24.32, 3: 16.27}[int(live.sum()) - 1]  # chi-square 0.999 quantiles
    assert chi2 < critical, (chi2, counts, n * p)


def test_sampling_validation_matches_jax():
    _, tc, _, tp = setup()
    prompt = torch.tensor(_prompt())
    g = torch.Generator()
    for kw in (dict(top_k=3), dict(top_p=0.5), dict(temperature=-1.0, generator=g),
               dict(temperature=0.5), dict(temperature=0.5, top_k=0, generator=g),
               dict(temperature=0.5, top_p=1.5, generator=g), dict(eos_id=64),
               dict(eos_id=1, return_logits=True), dict(max_len=P + STEPS - 1),
               dict(prompt_lengths=[1, 2], eos_id=None), dict(prompt_lengths=[0, 2, 3])):
        with pytest.raises(ValueError):
            ttr.lm_generate(tp, prompt, tc, STEPS, **kw)


# -- speculative decoding --


def _draft(seed=1):
    base = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64)
    jc, tc = jtr.LMConfig(**base), ttr.LMConfig(**base)
    npp = _scaled(jtr.init_lm(jax.random.PRNGKey(seed), jc))
    return jc, tc, {k: jnp.asarray(v) for k, v in npp.items()}, \
        convert.lm_params_from_jax(npp, tc, device="cpu")


@pytest.mark.parametrize("gamma,ragged,eos", [(1, False, None), (4, False, None), (4, True, None),
                                              (2, False, 46), (4, True, 36)])
def test_speculative_greedy_equals_greedy_generate(gamma, ragged, eos):
    _, tc, _, tp = setup(**CONFIGS["f32_gqa_rope_window"])
    _, dc, _, dp = _draft()
    prompt = torch.tensor(_prompt(12))
    lengths = [16, 7, 12] if ragged else None
    want = ttr.lm_generate(tp, prompt, tc, STEPS, prompt_lengths=lengths, eos_id=eos)
    got, stats = tspec.speculative_generate(tp, tc, dp, dc, prompt, STEPS, gamma=gamma,
                                            prompt_lengths=lengths, eos_id=eos,
                                            return_stats=True)
    assert torch.equal(got, want)
    assert 1 <= stats["rounds"] <= STEPS and 0.0 <= stats["accepted_frac"] <= 1.0


def test_speculative_greedy_matches_jax():
    jc, tc, jp, tp = setup()
    djc, dtc, djp, dtp = _draft()
    prompt = _prompt(13)
    want, jstats = jspec.speculative_generate(jp, jc, djp, djc, jnp.asarray(prompt), STEPS,
                                              gamma=3, return_stats=True)
    got, stats = tspec.speculative_generate(tp, tc, dtp, dtc, torch.tensor(prompt), STEPS, gamma=3,
                                            return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["rounds"] == int(jstats["rounds"])
    assert stats["accepted_frac"] == pytest.approx(float(jstats["accepted_frac"]))


def test_speculative_sampled_runs_and_keeps_the_prompt():
    _, tc, _, tp = setup()
    _, dc, _, dp = _draft()
    prompt = torch.tensor(_prompt(14))
    g = torch.Generator().manual_seed(0)
    out, stats = tspec.speculative_generate(tp, tc, dp, dc, prompt, STEPS, gamma=3, temperature=0.8,
                                            generator=g, return_stats=True)
    assert out.shape == (B, P + STEPS) and torch.equal(out[:, :P], prompt)
    assert int(out.min()) >= 0 and int(out.max()) < 64 and stats["rounds"] >= 1


def test_acceptance_core_preserves_target_distribution():
    """Leviathan Thm 1 on the port's core (tests/test_speculative.py's
    test on the JAX core): for a draft distribution far from the target,
    the emitted token's marginal is the target's; 40000 rows, TV < 2%."""
    v, n = 8, 40_000
    rng = np.random.default_rng(0)
    p_t = rng.dirichlet(np.ones(v))
    p_d = rng.dirichlet(np.ones(v) * 0.3)
    g = torch.Generator().manual_seed(1)
    pd_b = torch.tensor(p_d, dtype=torch.float32).expand(n, 1, v)
    pt_b = torch.tensor(p_t, dtype=torch.float32).expand(n, 2, v)
    d = ttr._categorical(torch.log(pd_b[:, 0]), g)[:, None]
    _, commit = tspec._accept_and_correct(g, d, pd_b, pt_b)
    emp = np.bincount(commit[:, 0].numpy(), minlength=v) / n
    assert 0.5 * np.abs(emp - p_t).sum() < 0.02


def test_identical_models_accept_everything():
    v, n = 8, 1000
    p = torch.tensor(np.random.default_rng(1).dirichlet(np.ones(v)), dtype=torch.float32)
    g = torch.Generator().manual_seed(2)
    d = ttr._categorical(torch.log(p).expand(n, v), g)[:, None]
    nacc, commit = tspec._accept_and_correct(g, d, p.expand(n, 1, v), p.expand(n, 2, v))
    assert torch.all(nacc == 1) and torch.equal(commit[:, 0], d[:, 0])


def test_speculative_validation():
    _, tc, _, tp = setup()
    _, dc, _, dp = _draft()
    prompt = torch.tensor(_prompt())
    with pytest.raises(ValueError, match="gamma"):
        tspec.speculative_generate(tp, tc, dp, dc, prompt, 4, gamma=0)
    with pytest.raises(ValueError, match="vocab"):
        tspec.speculative_generate(tp, tc, dp, dataclasses.replace(dc, vocab=65), prompt, 4)
    with pytest.raises(ValueError, match="Generator"):
        tspec.speculative_generate(tp, tc, dp, dc, prompt, 4, temperature=0.5)


# -- parameters and config --


def test_init_lm_shapes_match_jax():
    kw = dict(n_kv_heads=2)
    jc, tc = jtr.LMConfig(**BASE, **kw), ttr.LMConfig(**BASE, **kw)
    jp = jtr.init_lm(jax.random.PRNGKey(0), jc)
    tp = ttr.init_lm(0, tc, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    w = torch.cat([tp[k].flatten() for k in tp if "/w" in k or k == "emb"])
    assert abs(float(w.std()) - 0.02) < 1e-3 and torch.all(tp["l0/ln1"] == 1)
    assert torch.equal(ttr.init_lm(0, tc, device="cpu")["l1/w2"], tp["l1/w2"])


def test_lm_params_round_trip_and_validation():
    jc, tc, jp, tp = setup(n_kv_heads=2)
    back = convert.lm_params_to_numpy(tp)
    assert all(np.array_equal(back[k], np.asarray(jp[k])) for k in jp)
    npp = {k: np.asarray(v) for k, v in jp.items()}
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_jax({k: v for k, v in npp.items() if k != "l1/wq"}, tc, "cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_jax({**npp, "l0/wk": npp["l0/wq"]}, tc, "cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttr.LMConfig(**BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_lm(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_jax({}, cfg)
    from parameter_server_tpu_torch.benchmarks import lm_serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_serve.make_prompt(0)


@pytest.mark.parametrize("kw", [
    dict(kv_cache_dtype="int4"), dict(attention="dense"), dict(compute_dtype="float16"),
    dict(window=0), dict(window=4, attention="ring"), dict(n_kv_heads=3), dict(n_kv_heads=8),
    dict(rope=True, n_heads=64),
])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jtr.LMConfig(**{**BASE, **kw})
    with pytest.raises(ValueError):
        ttr.LMConfig(**{**BASE, **kw})


def test_serving_config_is_the_documented_one():
    from parameter_server_tpu_torch.benchmarks import lm_serve

    c = lm_serve.SERVE_CFG
    assert (c.vocab, c.d_model, c.n_heads, c.kv_heads, c.n_layers, c.d_ff, c.head_dim) == \
        (256, 512, 8, 2, 8, 2048, 64)
    assert c.compute_dtype == "bfloat16" and c.kv_cache_dtype == "int8"
    assert (lm_serve.B, lm_serve.P, lm_serve.STEPS) == (8, 2048, 256)
    d = lm_serve.DRAFT_CFG
    assert (d.d_model, d.n_heads, d.head_dim, d.n_layers, d.d_ff) == (256, 2, 128, 1, 1024)
    p = lm_serve.make_prompt(0, b=2, p=5, device="cpu")
    assert p.shape == (2, 5) and torch.equal(p, lm_serve.make_prompt(0, b=2, p=5, device="cpu"))
