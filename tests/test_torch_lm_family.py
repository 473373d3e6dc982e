"""PyTorch port: continuation, beam search, Adafactor / Lion and the
pipeline stack against the JAX package.

Both sides run on the CPU on the same weights: the JAX ``init_lm`` dict,
carried into the port by ``convert.lm_params_from_jax``; prompts come
from numpy seeds.

- ``lm_generate_continue``: the cases of ``tests/test_transformer.py``'s
  ``TestGenerateContinue`` (a split run equals the single shot, a new
  turn equals generating over the whole history, the ingest-only call,
  the prefill-only state, the capacity check), and in float32 the port's
  continuation tokens EQUAL to JAX's. With bf16 and the int8 cache the
  port is held to itself (split against single shot), as JAX's own test
  holds JAX.
- ``lm_beam_search``: the cases of ``tests/test_beam_search.py`` (scores
  against teacher forcing through ``lm_forward``, width 1 is greedy, eos
  freezing, ``length_penalty`` reranking only, ragged batches against
  single-prompt calls); each holds the port's beams EQUAL to JAX's and
  its scores within 1e-4 of them (float32 sums of log-probabilities
  through two layers; about 1e-6 is seen).
- Adafactor (d_model 128, so that the matrices and the 3-D expert
  weights are factored) and Lion against optax 0.2.6 over 6 steps inside
  the CLI's clip, warmup and accumulation chain: parameters within 1e-6
  of their scale and 1e-5 relative, as the Adam chain's test.
- ``sequential_apply`` and one-card ``pipeline_apply`` against JAX's on
  a one-device mesh, within 1e-6.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from parameter_server_tpu.models import pipeline as jpipe
from parameter_server_tpu.models import transformer as J
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.lm import optim
from parameter_server_tpu_torch.models import pipeline as tpipe
from parameter_server_tpu_torch.models import transformer as T

torch.set_num_threads(1)

SCORE_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _mesh():
    return meshlib.make_mesh(num_data=1, num_server=1)


@functools.lru_cache(maxsize=None)
def _np_params(kw, seed=0):
    return {k: np.asarray(v) for k, v in
            J.init_lm(jax.random.PRNGKey(seed), J.LMConfig(**dict(kw))).items()}


def setup(base, seed=0, **kw):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    full = {**base, **kw}
    npp = _np_params(tuple(sorted(full.items())), seed)
    tc = T.LMConfig(**full)
    return J.LMConfig(**full), tc, {k: jnp.asarray(v) for k, v in npp.items()}, \
        convert.lm_params_from_jax(npp, tc, device="cpu")


def _tokens(seed, b, s, vocab, low=0):
    return np.random.default_rng(seed).integers(low, vocab, (b, s)).astype(np.int32)


# -- lm_generate_continue --

CONT = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64)


def test_split_equals_single_shot_and_jax():
    jc, tc, jp, tp = setup(CONT)
    prompt = _tokens(20, 2, 10, 32)
    full = T.lm_generate(tp, torch.tensor(prompt), tc, 12)
    part, state = T.lm_generate(tp, torch.tensor(prompt), tc, 5, return_state=True, max_len=22)
    gen2, state2 = T.lm_generate_continue(tp, state, tc, 7)
    assert torch.equal(torch.cat([part, gen2], 1), full) and state2.length == 22
    jpart, jstate = J.lm_generate(jp, prompt, jc, steps=5, return_state=True, max_len=22)
    jgen2, _ = J.lm_generate_continue(jp, jstate, jc, steps=7)
    np.testing.assert_array_equal(gen2.numpy(), np.asarray(jgen2))


def test_new_turn_matches_fresh_generation_and_jax():
    jc, tc, jp, tp = setup(CONT)
    p1, p2 = _tokens(21, 2, 8, 32), _tokens(22, 2, 5, 32)
    out1, state = T.lm_generate(tp, torch.tensor(p1), tc, 4, return_state=True, max_len=40)
    gen2, _ = T.lm_generate_continue(tp, state, tc, 6, new_tokens=torch.tensor(p2))
    history = torch.cat([out1, torch.tensor(p2).long()], 1)
    want = T.lm_generate(tp, history, tc, 6)[:, history.shape[1]:]
    assert torch.equal(gen2, want)
    _, jstate = J.lm_generate(jp, p1, jc, steps=4, return_state=True, max_len=40)
    jgen2, _ = J.lm_generate_continue(jp, jstate, jc, steps=6, new_tokens=jnp.asarray(p2))
    np.testing.assert_array_equal(gen2.numpy(), np.asarray(jgen2))


def test_continue_composes_with_features():
    """rope + GQA + bf16 + int8 cache through the state hand-off."""
    _, tc, _, tp = setup(dict(CONT, n_heads=4), seed=6, n_kv_heads=2, rope=True,
                         compute_dtype="bfloat16", kv_cache_dtype="int8")
    prompt = torch.tensor(_tokens(22, 2, 8, 32))
    full = T.lm_generate(tp, prompt, tc, 10)
    part, state = T.lm_generate(tp, prompt, tc, 4, return_state=True, max_len=18)
    gen2, _ = T.lm_generate_continue(tp, state, tc, 6)
    assert torch.equal(torch.cat([part, gen2], 1), full)


def test_capacity_validation():
    _, tc, _, tp = setup(CONT)
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="max_len"):
        T.lm_generate(tp, prompt, tc, 8, max_len=10)
    _, state = T.lm_generate(tp, prompt, tc, 2, return_state=True)  # capacity 6: no headroom
    with pytest.raises(ValueError, match="cache slots"):
        T.lm_generate_continue(tp, state, tc, 1)


def test_ingest_only_then_generate():
    jc, tc, jp, tp = setup(CONT)
    p1, p2 = _tokens(24, 2, 7, 32), _tokens(25, 2, 4, 32)
    out1, state = T.lm_generate(tp, torch.tensor(p1), tc, 3, return_state=True, max_len=30)
    empty, state = T.lm_generate_continue(tp, state, tc, 0, new_tokens=torch.tensor(p2))
    assert empty.shape == (2, 0) and state.boundary_cached and state.last_logits.shape == (2, 32)
    assert state.length == 7 + 3 + 4
    gen, _ = T.lm_generate_continue(tp, state, tc, 5)
    history = torch.cat([out1, torch.tensor(p2).long()], 1)
    assert torch.equal(gen, T.lm_generate(tp, history, tc, 5)[:, history.shape[1]:])
    _, jstate = J.lm_generate(jp, p1, jc, steps=3, return_state=True, max_len=30)
    _, jstate = J.lm_generate_continue(jp, jstate, jc, steps=0, new_tokens=jnp.asarray(p2))
    np.testing.assert_allclose(state.last_logits.numpy(), np.asarray(jstate.last_logits),
                               atol=1e-4, rtol=0)
    jgen, _ = J.lm_generate_continue(jp, jstate, jc, steps=5)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    noop, st2 = T.lm_generate_continue(tp, state, tc, 0)  # no tokens, no steps: a no-op
    assert noop.shape == (2, 0) and st2 is state


def test_prefill_only_state_is_exact():
    _, tc, _, tp = setup(CONT)
    prompt = torch.tensor(_tokens(25, 2, 9, 32))
    _, state = T.lm_generate(tp, prompt, tc, 0, return_state=True, max_len=25)
    assert state.boundary_cached and state.last_logits is not None
    gen, _ = T.lm_generate_continue(tp, state, tc, 8)
    assert torch.equal(gen, T.lm_generate(tp, prompt, tc, 8)[:, 9:])


def test_sampled_continuation_reproducible_and_a_state_reusable():
    _, tc, _, tp = setup(CONT)
    prompt = torch.tensor(_tokens(23, 2, 6, 32))
    _, state = T.lm_generate(tp, prompt, tc, 3, return_state=True, max_len=20)
    a, _ = T.lm_generate_continue(tp, state, tc, 5, temperature=0.9,
                                  generator=torch.Generator().manual_seed(1))
    # the same state again (its caches were extended in place)
    b, _ = T.lm_generate_continue(tp, state, tc, 5, temperature=0.9,
                                  generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        T.lm_generate_continue(tp, state, tc, 2, temperature=0.9)


# -- lm_beam_search --

BEAM = dict(vocab=37, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _seq_logprob(tp, tc, seqs, p_len):
    """Teacher-forced log-probability of the generated part of each
    sequence [..., total] under the port's training forward."""
    flat = seqs.reshape(-1, seqs.shape[-1])
    logp = torch.log_softmax(T.lm_forward(tp, flat, tc).detach(), -1)
    tgt = flat[:, p_len:]
    got = logp[:, p_len - 1:-1].gather(-1, tgt[..., None])[..., 0].sum(-1)
    return got.reshape(seqs.shape[:-1])


def _both(jp, jc, tp, tc, prompt, steps, **kw):
    """(port tokens, port scores, JAX tokens, JAX scores) as numpy."""
    tt, ts = T.lm_beam_search(tp, torch.tensor(prompt), tc, steps, **kw)
    jkw = dict(kw)
    if "prompt_lengths" in jkw:
        jkw["prompt_lengths"] = np.asarray(jkw["prompt_lengths"], np.int32)
    jt, js = J.lm_beam_search(jp, jnp.asarray(prompt), jc, steps=steps, **jkw)
    return tt.numpy(), ts.numpy(), np.asarray(jt), np.asarray(js)


def _match_jax(tt, ts, jt, js):
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=SCORE_TOL, rtol=0)


def test_scores_match_teacher_forcing_and_jax():
    jc, tc, jp, tp = setup(BEAM)
    prompt = _tokens(1, 2, 6, 37)
    tt, ts, jt, js = _both(jp, jc, tp, tc, prompt, 5, beam_width=3)
    assert tt.shape == (2, 3, 11) and ts.shape == (2, 3)
    assert (np.diff(ts, axis=1) <= 1e-6).all(), ts  # best first
    want = _seq_logprob(tp, tc, torch.tensor(tt), 6).numpy()
    np.testing.assert_allclose(ts, want, atol=2e-4, rtol=1e-4)
    _match_jax(tt, ts, jt, js)


def test_top_beam_at_least_greedy():
    _, tc, _, tp = setup(BEAM)
    prompt = torch.tensor(_tokens(2, 3, 5, 37))
    _, scores = T.lm_beam_search(tp, prompt, tc, 6, beam_width=4)
    greedy = T.lm_generate(tp, prompt, tc, 6)
    g_score = _seq_logprob(tp, tc, greedy[:, None, :], 5)[:, 0]
    assert bool((scores[:, 0] >= g_score - 1e-4).all()), (scores[:, 0], g_score)


def test_beam_width_one_is_greedy():
    jc, tc, jp, tp = setup(BEAM)
    prompt = _tokens(3, 2, 7, 37)
    tt, ts, jt, js = _both(jp, jc, tp, tc, prompt, 5, beam_width=1)
    np.testing.assert_array_equal(tt[:, 0], T.lm_generate(tp, torch.tensor(prompt), tc, 5).numpy())
    _match_jax(tt, ts, jt, js)


def test_eos_freezes_beam_and_score():
    jc, tc, jp, tp = setup(BEAM)
    prompt = _tokens(4, 1, 5, 37, low=1)
    base, _ = T.lm_beam_search(tp, torch.tensor(prompt), tc, 6, beam_width=2)
    gen = base[0, 0, 5:].numpy()
    cands = [t for t in range(6) if gen[t] != 0 and (gen[:t] != gen[t]).all()]
    assert cands, gen
    eos = int(gen[cands[-1]])
    tt, ts, jt, js = _both(jp, jc, tp, tc, prompt, 6, beam_width=2, eos_id=eos)
    froze = False
    for w in range(2):
        row = tt[0, w, 5:]
        hits = np.flatnonzero(row == eos)
        if hits.size:
            froze = True
            assert (row[hits[0] + 1:] == 0).all(), row
            upto = 5 + hits[0] + 1
            want = _seq_logprob(tp, tc, torch.tensor(tt[0, w][None, None, :upto]), 5)[0, 0]
            np.testing.assert_allclose(ts[0, w], float(want), atol=2e-4, rtol=1e-4)
    assert froze, tt
    _match_jax(tt, ts, jt, js)


@pytest.mark.parametrize("variant", [dict(n_kv_heads=2, rope=True, kv_cache_dtype="int8"),
                                     dict(compute_dtype="bfloat16", window=8)],
                         ids=["gqa_rope_int8", "bf16_window"])
def test_beam_variants_score_parity(variant):
    """The tile and the reorder run over the (data, scale) cache tuples;
    scores against teacher forcing, as JAX's test (bf16 and the int8
    cache at its loose tolerance); float32 beams equal to JAX's."""
    jc, tc, jp, tp = setup(BEAM, seed=8, **variant)
    prompt = _tokens(9, 2, 6, 37)
    tt, ts, jt, js = _both(jp, jc, tp, tc, prompt, 5, beam_width=3)
    want = _seq_logprob(tp, tc, torch.tensor(tt), 6).numpy()
    tol = 0.05 if tc.compute_dtype == "bfloat16" or tc.kv_cache_dtype else 2e-4
    np.testing.assert_allclose(ts, want, atol=tol, rtol=0.02)
    if tc.compute_dtype == "float32":
        _match_jax(tt, ts, jt, js)
    else:
        np.testing.assert_allclose(ts, js, atol=tol, rtol=0.02)


def test_length_penalty_reranks_only():
    jc, tc, jp, tp = setup(BEAM)
    prompt = torch.tensor(_tokens(7, 2, 5, 37))
    a, sa = T.lm_beam_search(tp, prompt, tc, 5, beam_width=3)
    b, sb = T.lm_beam_search(tp, prompt, tc, 5, beam_width=3, length_penalty=1.0)
    torch.testing.assert_close(sa.sort(1).values, sb.sort(1).values, atol=1e-6, rtol=0)
    # with eos, beams of other lengths are reranked as JAX reranks them
    tt, ts, jt, js = _both(jp, jc, tp, tc, prompt.numpy(), 6, beam_width=3, eos_id=int(a[0, 0, 6]),
                           length_penalty=0.6)
    _match_jax(tt, ts, jt, js)


def test_ragged_beams_equal_single_prompt_calls_and_jax():
    jc, tc, jp, tp = setup(BEAM)
    rng = np.random.default_rng(10)
    widths = [4, 9, 6]
    rows = [rng.integers(1, 37, w).astype(np.int32) for w in widths]
    padded = np.zeros((3, 9), np.int32)
    for i, r in enumerate(rows):
        padded[i, :r.size] = r
    tt, ts, jt, js = _both(jp, jc, tp, tc, padded, 5, beam_width=3, prompt_lengths=widths)
    _match_jax(tt, ts, jt, js)
    for i, r in enumerate(rows):
        solo_t, solo_s = T.lm_beam_search(tp, torch.tensor(r[None, :]), tc, 5, beam_width=3)
        np.testing.assert_allclose(ts[i], solo_s[0].numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(tt[i, :, :r.size + 5], solo_t[0].numpy())
        assert (tt[i, :, r.size + 5:] == 0).all()


def test_ragged_beam_with_eos_matches_single_prompt():
    jc, tc, jp, tp = setup(BEAM)
    rng = np.random.default_rng(12)
    widths = [3, 8]
    rows = [rng.integers(1, 37, w).astype(np.int32) for w in widths]
    padded = np.zeros((2, 8), np.int32)
    for i, r in enumerate(rows):
        padded[i, :r.size] = r
    base, _ = T.lm_beam_search(tp, torch.tensor(padded), tc, 6, beam_width=2,
                               prompt_lengths=widths)
    emitted = [t for i in range(2) for t in base[i, 0, widths[i]:widths[i] + 6].tolist() if t]
    assert emitted
    eos = int(emitted[-1])
    tt, ts, jt, js = _both(jp, jc, tp, tc, padded, 6, beam_width=2, eos_id=eos,
                           prompt_lengths=widths, length_penalty=0.6)
    _match_jax(tt, ts, jt, js)
    for i, r in enumerate(rows):
        solo_t, solo_s = T.lm_beam_search(tp, torch.tensor(r[None, :]), tc, 6, beam_width=2,
                                          eos_id=eos, length_penalty=0.6)
        np.testing.assert_array_equal(tt[i, :, :r.size + 6], solo_t[0].numpy())
        np.testing.assert_allclose(ts[i], solo_s[0].numpy(), atol=1e-5, rtol=1e-5)


def test_ragged_beam_uniform_equals_dense():
    _, tc, _, tp = setup(BEAM)
    prompt = torch.tensor(_tokens(11, 2, 7, 37, low=1))
    a_t, a_s = T.lm_beam_search(tp, prompt, tc, 4, beam_width=2)
    b_t, b_s = T.lm_beam_search(tp, prompt, tc, 4, beam_width=2, prompt_lengths=[7, 7])
    assert torch.equal(a_t, b_t)
    torch.testing.assert_close(a_s, b_s, atol=1e-5, rtol=0)


def test_ties_go_to_the_lower_index():
    vals, idx = T._top(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0, 3.0, 3.0]]
    jv, ji = jax.lax.top_k(jnp.asarray([[1.0, 3.0, 3.0, 2.0, 3.0]]), 3)
    assert np.asarray(ji).tolist() == idx.tolist()


def test_beam_validation():
    _, tc, _, tp = setup(BEAM)
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="beam_width"):
        T.lm_beam_search(tp, prompt, tc, 2, beam_width=0)
    with pytest.raises(ValueError, match="beam_width"):
        T.lm_beam_search(tp, prompt, tc, 2, beam_width=38)
    with pytest.raises(ValueError, match="eos_id"):
        T.lm_beam_search(tp, prompt, tc, 2, eos_id=99)
    with pytest.raises(ValueError, match="steps"):
        T.lm_beam_search(tp, prompt, tc, 0)


# -- Adafactor and Lion --

OPT_CFG = T.LMConfig(vocab=64, d_model=128, n_heads=2, n_layers=2, d_ff=256, moe_every=2,
                     n_experts=2)
OPTAX = {"adafactor": optax.adafactor, "lion": optax.lion}


def _optax_chain(name, lr, steps, warmup, clip_norm, grad_accum):
    """The JAX CLI's chain, as its main() builds it."""
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=max(1, warmup // grad_accum),
        decay_steps=max(2, steps // grad_accum), end_value=0.1 * lr) if warmup else lr
    chain = ([optax.clip_by_global_norm(clip_norm)] if clip_norm else []) + [OPTAX[name](sched)]
    tx = optax.chain(*chain)
    return optax.MultiSteps(tx, every_k_schedule=grad_accum) if grad_accum > 1 else tx


@pytest.mark.parametrize("name", list(OPTAX))
@pytest.mark.parametrize("warmup,clip_norm,grad_accum",
                         [(0, None, 1), (3, None, 1), (0, 0.05, 1), (2, 0.05, 3)])
def test_optimizer_matches_optax(name, warmup, clip_norm, grad_accum):
    lr, steps = 3e-2, 6
    params = T.init_lm(0, OPT_CFG, "cpu")
    rng = np.random.default_rng(1)
    tx = optim.build(lr, steps, warmup, clip_norm, grad_accum, name)
    state = tx.init(params)
    jtx = _optax_chain(name, lr, steps, warmup, clip_norm, grad_accum)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jstate = jtx.init(jp)
    for _ in range(steps):
        toks = torch.tensor(rng.integers(0, 64, (2, 16)))
        _, grads = T.value_and_grad(lambda p: T.lm_loss(p, toks, OPT_CFG), params)
        with torch.no_grad():
            updates, state = tx.update(grads, state, params)
            params = optim.apply_updates(params, updates)
        jupdates, jstate = jtx.update({k: jnp.asarray(g.numpy()) for k, g in grads.items()},
                                      jstate, jp)
        jp = optax.apply_updates(jp, jupdates)
    for k, v in params.items():
        want = np.asarray(jp[k])
        np.testing.assert_allclose(v.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)


def test_adafactor_factors_as_optax_does():
    """The state's shapes are optax's: the 2-D weights of >= 128 on both
    axes and the 3-D expert weights (on their last two dims) factored,
    the rest full."""
    params = T.init_lm(0, OPT_CFG, "cpu")
    state = optim.Adafactor(1e-3).init(params)
    jstate = optax.adafactor(1e-3).init({k: jnp.asarray(v.numpy()) for k, v in params.items()})
    fact = jstate[0]
    for part in ("v_row", "v_col", "v"):
        assert {k: tuple(v.shape) for k, v in state[part].items()} == \
            {k: tuple(v.shape) for k, v in getattr(fact, part).items()}, part
    assert tuple(state["v_row"]["l1/moe_w_in"].shape) == (2, 128)
    assert tuple(state["v"]["l0/wq"].shape) == (1,) and tuple(state["v"]["l0/ln1"].shape) == (128,)


def test_adafactor_and_lion_need_the_parameters():
    params = T.init_lm(0, OPT_CFG, "cpu")
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    for tx in (optim.Adafactor(1e-3), optim.Lion(1e-3)):
        with pytest.raises(ValueError, match="params"):
            tx.update(grads, tx.init(params))


# -- the pipeline stack --


def _stage_fn(p, x):
    return x @ p["w"] + p["b"]


def _stage_inputs(n_stages=4, m=3, mb=2, d=8):
    rng = np.random.default_rng(0)
    params = {"w": (rng.standard_normal((n_stages, d, d)) / np.sqrt(d)).astype(np.float32),
              "b": rng.standard_normal((n_stages, d)).astype(np.float32)}
    return params, rng.standard_normal((m, mb, d)).astype(np.float32)


def _jax_stage_fn(p, x):
    return jnp.tanh(_stage_fn(p, x))


def _torch_stage_fn(p, x):
    return torch.tanh(_stage_fn(p, x))


def test_sequential_and_one_card_pipeline_match_jax():
    params, x = _stage_inputs()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want_seq = np.asarray(jpipe.sequential_apply(_jax_stage_fn, jparams, jnp.asarray(x)))
    want_pipe = np.asarray(jpipe.pipeline_apply(_jax_stage_fn, jparams, jnp.asarray(x),
                                                mesh=_mesh()))
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    got_seq = tpipe.sequential_apply(_torch_stage_fn, tparams, torch.tensor(x)).numpy()
    got_pipe = tpipe.pipeline_apply(_torch_stage_fn, tparams, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got_seq, want_seq, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_pipe, want_pipe, atol=1e-6, rtol=0)
    assert np.array_equal(got_seq, got_pipe)


def test_pipeline_stage_count_is_checked_and_tuples_work():
    """The stage count against the axis (JAX's ``MULTIPLE`` check, before
    any collective) and a tuple of leaves; a mesh of one stage group is
    the one-card pipeline. ``tests/test_torch_parallel_moe_pipeline.py``
    holds the schedule across 4 ranks."""
    from parameter_server_tpu_torch.parallel.mesh import Mesh

    params, x = _stage_inputs(n_stages=4)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="MULTIPLE"):
        tpipe.pipeline_apply(_torch_stage_fn, tparams, torch.tensor(x), mesh=Mesh(3, 1, "cpu"))
    one = tpipe.pipeline_apply(_torch_stage_fn, tparams, torch.tensor(x), mesh=Mesh(1, 1, "cpu"))
    # a tuple of leaves works as a dict does
    tup = (tparams["w"], tparams["b"])
    got = tpipe.pipeline_apply(lambda p, v: torch.tanh(v @ p[0] + p[1]), tup, torch.tensor(x))
    want = tpipe.sequential_apply(_torch_stage_fn, tparams, torch.tensor(x))
    assert torch.equal(got, want) and torch.equal(one, want)


def test_continue_state_dataclass_matches_jax_fields():
    names = [f.name for f in dataclasses.fields(T.GenState)]
    assert names == [f.name for f in dataclasses.fields(J.GenState)]
