"""PyTorch port: mixture-of-experts layers against the JAX package.

The layer (``models/moe.py``): the port's ``moe_ffn_dense`` and
``moe_ffn`` against JAX's ``moe_ffn_dense`` and ``moe_ffn`` on a
one-device mesh, on the same weights and tokens (numpy, from seeds),
with capacities that bind (tokens dropped) and that do not. The routing
(which expert, which slot, which tokens drop) must be EQUAL; the outputs
and the gradients of x, the router and the experts agree within 1e-5 of
each tensor's largest |value| (float32 products summed in another order
by the two libraries' matmuls). The port's gathers are shown to equal
the one-hot einsums bit for bit, and a recording of every tensor a call
makes shows memory linear in the token count.

The model (``models/transformer.py`` with ``moe_every``): ``lm_loss``
and its gradients against JAX's on a one-device mesh (float32: the loss
within 1e-6 relative, gradients within 1e-5 of their scale), prefill
logits against the training forward, and the decoding cases of
``tests/test_moe_serving.py``: greedy decode against the forward's
argmax, ragged rows against single rows, a multi-turn continuation, a
speculative MoE target, and the documented caveat that a binding
training capacity parts serving from training. Each generation is also
held against JAX's on the same weights: tokens equal, logits within
1e-4 (float32 through two layers).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from parameter_server_tpu.models import moe as jmoe
from parameter_server_tpu.models import speculative as jspec
from parameter_server_tpu.models import transformer as J
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.models import moe as tmoe
from parameter_server_tpu_torch.models import speculative as tspec
from parameter_server_tpu_torch.models import transformer as T

torch.set_num_threads(1)

GRAD_SHARE = 1e-5  # of each tensor's largest |value|
LOGIT_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _mesh():
    return meshlib.make_mesh(num_data=1, num_server=1)


def _layer(seed=0, b=2, s=24, d=16, d_ff=32, e=4):
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in jmoe.init_moe(jax.random.PRNGKey(seed), d, d_ff, e).items()}
    return p, rng.standard_normal((b, s, d)).astype(np.float32)


def _jax_routing(p, xt, capacity):
    """(expert, position, kept) per token from JAX's dispatch one-hot."""
    dispatch, _ = jmoe._route(jnp.asarray(xt), jnp.asarray(p["router"]), p["router"].shape[1],
                              capacity)
    d = np.asarray(dispatch)  # [T, E, C]
    kept = d.reshape(d.shape[0], -1).sum(1) > 0
    flat = d.reshape(d.shape[0], -1).argmax(1)
    return kept, flat  # flat = expert * C + position where kept


LAYER_CASES = [(8.0, 1), (1.25, 1), (0.5, 1), (1.25, 2)]


@pytest.mark.parametrize("cf,n_shards", LAYER_CASES)
def test_routing_equals_jax_and_drops_where_capacity_binds(cf, n_shards):
    p, x = _layer()
    b, s, d = x.shape
    e = p["router"].shape[1]
    t_loc = b * (s // n_shards)
    capacity = max(1, int(cf * t_loc / e))
    dropped = 0
    for i in range(n_shards):
        xt = x[:, i * s // n_shards:(i + 1) * s // n_shards].reshape(-1, d)
        kept, flat = _jax_routing(p, xt, capacity)
        slot, _ = tmoe._route(torch.tensor(xt), torch.tensor(p["router"]), e, capacity)
        slot = slot.numpy()
        np.testing.assert_array_equal(slot < e * capacity, kept)
        np.testing.assert_array_equal(slot[kept], flat[kept])
        assert (slot[~kept] == e * capacity).all()
        dropped += int((~kept).sum())
    assert (dropped > 0) == (cf * t_loc / e < t_loc), (cf, dropped)  # binds iff C < T


def _jax_out_and_grads(p, x, cf, n_shards, r):
    def f(pp, xx):
        out = jmoe.moe_ffn_dense(pp, xx, n_shards, cf)
        return jnp.sum(out * r), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    return np.asarray(out), {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}


def _port_out_and_grads(p, x, cf, n_shards, r, fn=None):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = fn(tp, tx) if fn else tmoe.moe_ffn_dense(tp, tx, n_shards, cf)
    grads = torch.autograd.grad((out * torch.tensor(r)).sum(), [*tp.values(), tx])
    return out.detach().numpy(), {**dict(zip(tp, (g.numpy() for g in grads[:-1]))),
                                  "x": grads[-1].numpy()}


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_SHARE * scale, err_msg=what)


@pytest.mark.parametrize("cf,n_shards", LAYER_CASES)
def test_moe_ffn_dense_and_gradients_match_jax(cf, n_shards):
    p, x = _layer(seed=1)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jout, jg = _jax_out_and_grads(p, x, cf, n_shards, r)
    tout, tg = _port_out_and_grads(p, x, cf, n_shards, r)
    _close(tout, jout, "out")
    # a dropped token's output is exactly zero on both sides
    np.testing.assert_array_equal(tout == 0, jout == 0)
    for k in jg:
        _close(tg[k], jg[k], f"grad {k}")


def test_moe_ffn_on_one_card_equals_jax_moe_ffn_on_a_one_device_mesh():
    p, x = _layer(seed=3, s=32)
    jout = np.asarray(jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                   J.shard_tokens(x, _mesh()), mesh=_mesh(), capacity_factor=1.0))
    tout = tmoe.moe_ffn({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
                        capacity_factor=1.0)
    _close(tout.numpy(), jout, "out")
    torch.testing.assert_close(tout, tmoe.moe_ffn_dense(
        {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x), 1, 1.0), rtol=0, atol=0)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_gathers_equal_the_one_hot_einsums_bit_for_bit(cf):
    """Each dispatch slot and each combined token has at most one nonzero
    term, so the einsums over the [T, E, C] one-hots give exactly the
    port's gathers (same expert products fed to both)."""
    p, x = _layer(seed=4)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    xt = torch.tensor(x).reshape(-1, x.shape[-1])
    e = tp["router"].shape[1]
    capacity = max(1, int(cf * xt.shape[0] / e))
    slot, gate = tmoe._route(xt, tp["router"], e, capacity)
    dispatch = torch.nn.functional.one_hot(slot, e * capacity + 1)[:, :-1].float()
    dispatch = dispatch.reshape(-1, e, capacity)  # [T, E, C]
    h = torch.einsum("tec,td->ecd", dispatch, xt)
    out_e = tmoe._expert_ffn(tp["w_in"], tp["w_out"], h)
    want = torch.einsum("tec,ecd->td", dispatch * gate[:, None, None], out_e)
    assert torch.equal(tmoe._moe_tokens(tp, xt, capacity), want)


class _Largest(TorchDispatchMode):
    """Records the largest tensor any op of a call returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def _largest_tensor(tokens, cf=2.0, e=8, d=16, d_ff=32):
    gen = torch.Generator().manual_seed(0)
    p = {k: v.requires_grad_() for k, v in tmoe.init_moe(gen, d, d_ff, e).items()}
    x = torch.randn(1, tokens, d, generator=gen, requires_grad=True)
    with _Largest() as rec:
        out = tmoe.moe_ffn(p, x, capacity_factor=cf)
        torch.autograd.grad(out.sum(), [x, *p.values()])
    return rec.numel


def test_memory_stays_linear_in_the_token_count():
    """At 4096 tokens, 8 experts and capacity factor 2 a [T, E, C]
    one-hot would hold 4096 * 8 * 1024 = 33.5M floats; the largest tensor
    of the port's forward and backward is the [E, C, d_ff] hidden layer,
    cf * T * d_ff, and it doubles with T."""
    small, big = _largest_tensor(2048), _largest_tensor(4096)
    assert big <= 2.0 * 4096 * 32, big
    assert big == 2 * small, (small, big)
    assert big < 4096 * 8 * 1024 // 64


def test_init_moe_shapes_and_scales():
    p = tmoe.init_moe(torch.Generator().manual_seed(0), 64, 256, 8)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {"router": (64, 8), "w_in": (8, 64, 256), "w_out": (8, 256, 64)}
    for k, fan_in in (("router", 64), ("w_in", 64), ("w_out", 256)):
        assert abs(float(p[k].std()) * np.sqrt(fan_in) - 1.0) < 0.1, k


# -- the model --

MOE = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, moe_every=2, n_experts=4,
           capacity_factor=8.0)


def _scaled(params):
    """Weights scaled up (embedding x2, dense matrices x15, the experts as
    drawn) so greedy decoding of a random model does not collapse onto
    one token."""
    return {k: np.asarray(v) * (1.0 if "ln" in k or "moe" in k else 2.0 if k == "emb" else 15.0)
            for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _np_params(seed=0, **kw):
    return _scaled(J.init_lm(jax.random.PRNGKey(seed), J.LMConfig(**{**MOE, **kw})))


def setup(seed=0, **kw):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    base = {**MOE, **kw}
    jc, tc = J.LMConfig(**base), T.LMConfig(**base)
    npp = _np_params(seed, **kw)
    return jc, tc, {k: jnp.asarray(v) for k, v in npp.items()}, \
        convert.lm_params_from_jax(npp, tc, device="cpu")


def _tokens(seed, b, s, vocab=61, low=0):
    return np.random.default_rng(seed).integers(low, vocab, (b, s)).astype(np.int32)


def test_init_lm_gives_moe_layers_their_experts_and_no_mlp():
    cfg = T.LMConfig(**{**MOE, "n_layers": 4})
    p = T.init_lm(0, cfg, "cpu")
    jp = J.init_lm(jax.random.PRNGKey(0), J.LMConfig(**{**MOE, "n_layers": 4}))
    assert set(p) == set(jp)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    assert "l1/w1" not in p and "l3/moe_w_in" in p and "l0/w1" in p
    # the dense layers draw what a dense model draws
    dense = T.init_lm(0, T.LMConfig(**{**MOE, "n_layers": 1, "moe_every": 0}), "cpu")
    for k in dense:
        assert torch.equal(p[k], dense[k]), k


def test_moe_weights_stay_float32_under_bf16():
    cfg = T.LMConfig(**{**MOE, "compute_dtype": "bfloat16"})
    w = T._weights(T.init_lm(0, cfg, "cpu"), cfg)
    assert w["l1/moe_w_in"].dtype == torch.float32 and w["l1/wq"].dtype == torch.bfloat16
    assert w["l0/w1"].dtype == torch.bfloat16 and "l1/w1" not in w


@pytest.mark.parametrize("kw", [dict(), dict(capacity_factor=0.5), dict(remat=True, rope=True)],
                         ids=["no_drops", "drops", "remat_rope"])
def test_lm_loss_and_gradients_match_jax(kw):
    jc, tc, jp, tp = setup(**kw)
    toks = _tokens(1, 2, 24)
    jl, jg = jax.value_and_grad(lambda p: J.lm_loss(p, J.shard_tokens(toks, _mesh()), jc,
                                                    _mesh()))(jp)
    tl, tg = T.value_and_grad(lambda p: T.lm_loss(p, torch.tensor(toks), tc), tp)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert set(tg) == set(jg)
    for k in jg:
        _close(tg[k].numpy(), np.asarray(jg[k]), k)
    assert float(np.abs(np.asarray(jg["l1/moe_router"])).max()) > 0  # the gate carries gradient


def test_moe_prefill_logits_match_the_forward_and_jax():
    jc, tc, jp, tp = setup()
    toks = _tokens(1, 2, 16)
    _, tdec = T.lm_generate(tp, torch.tensor(toks), tc, 0, return_logits=True)
    full = T.lm_forward(tp, torch.tensor(toks), tc)
    np.testing.assert_allclose(tdec.numpy(), full[:, :-1].detach().numpy(), atol=2e-4, rtol=1e-4)
    _, jdec = J.lm_generate(jp, toks, jc, steps=0, return_logits=True)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), atol=LOGIT_TOL, rtol=0)


def test_moe_greedy_decode_matches_forward_argmax_and_jax():
    jc, tc, jp, tp = setup()
    prompt = _tokens(2, 2, 9)
    out = T.lm_generate(tp, torch.tensor(prompt), tc, 7)
    pred = T.lm_forward(tp, out, tc).argmax(-1)
    assert torch.equal(pred[:, 8:-1], out[:, 9:])
    np.testing.assert_array_equal(out.numpy(), np.asarray(J.lm_generate(jp, prompt, jc, steps=7)))
    assert len(np.unique(out[:, 9:].numpy())) > 1  # not collapsed onto one token


def test_moe_ragged_rows_equal_single_row():
    jc, tc, jp, tp = setup()
    rng = np.random.default_rng(3)
    rows = [rng.integers(1, 61, w).astype(np.int32) for w in (4, 10)]
    padded = np.zeros((2, 10), np.int32)
    for i, r in enumerate(rows):
        padded[i, :r.size] = r
    out = T.lm_generate(tp, torch.tensor(padded), tc, 5, prompt_lengths=[4, 10]).numpy()
    jout = np.asarray(J.lm_generate(jp, jnp.asarray(padded), jc, steps=5,
                                    prompt_lengths=np.asarray([4, 10], np.int32)))
    np.testing.assert_array_equal(out, jout)
    for i, r in enumerate(rows):
        solo = T.lm_generate(tp, torch.tensor(r[None, :]), tc, 5)[0].numpy()
        np.testing.assert_array_equal(out[i, :r.size + 5], solo)


def test_moe_multiturn_continuation():
    jc, tc, jp, tp = setup()
    p1, turn2 = _tokens(4, 2, 6), _tokens(5, 2, 3)
    out1, st = T.lm_generate(tp, torch.tensor(p1), tc, 4, return_state=True, max_len=24)
    out2, st2 = T.lm_generate_continue(tp, st, tc, 4, new_tokens=torch.tensor(turn2))
    hist = torch.cat([out1, torch.tensor(turn2).long()], 1)
    single = T.lm_generate(tp, hist, tc, 4)
    assert torch.equal(out2, single[:, -4:]) and st2.length == 6 + 4 + 3 + 4
    jout1, jst = J.lm_generate(jp, p1, jc, steps=4, return_state=True, max_len=24)
    jout2, _ = J.lm_generate_continue(jp, jst, jc, steps=4, new_tokens=jnp.asarray(turn2))
    np.testing.assert_array_equal(out2.numpy(), np.asarray(jout2))


def test_moe_speculative_target():
    jc, tc, jp, tp = setup()
    prompt = _tokens(5, 2, 7)
    dkw = dict(vocab=61, d_model=16, n_heads=2, n_layers=1, d_ff=32)
    dnp = {k: np.asarray(v) for k, v in J.init_lm(jax.random.PRNGKey(6), J.LMConfig(**dkw)).items()}
    dcfg = T.LMConfig(**dkw)
    dparams = convert.lm_params_from_jax(dnp, dcfg, device="cpu")
    plain = T.lm_generate(tp, torch.tensor(prompt), tc, 6)
    spec = tspec.speculative_generate(tp, tc, dparams, dcfg, torch.tensor(prompt), 6, gamma=2)
    assert torch.equal(plain, spec)
    jspec_out = jspec.speculative_generate(jp, jc, {k: jnp.asarray(v) for k, v in dnp.items()},
                                           J.LMConfig(**dkw), jnp.asarray(prompt), 6, gamma=2)
    np.testing.assert_array_equal(spec.numpy(), np.asarray(jspec_out))


def test_moe_sampled_generation_and_beam_run():
    _, tc, _, tp = setup()
    prompt = torch.tensor(_tokens(7, 2, 5))
    gen = torch.Generator().manual_seed(8)
    out = T.lm_generate(tp, prompt, tc, 4, temperature=0.9, top_k=8, generator=gen)
    assert out.shape == (2, 9)
    toks, scores = T.lm_beam_search(tp, prompt, tc, 4, beam_width=3)
    assert toks.shape == (2, 3, 9) and bool(torch.isfinite(scores).all())


def test_capacity_binding_breaks_parity_documented():
    """With a SMALL training capacity (tokens dropped) the training
    forward and the dropless serving prefill part, on both sides: the
    equality above is doing work, not holding vacuously."""
    jc, tc, jp, tp = setup()
    tight_t = dataclasses.replace(tc, capacity_factor=0.25)
    tight_j = dataclasses.replace(jc, capacity_factor=0.25)
    toks = _tokens(9, 2, 32)
    _, dec = T.lm_generate(tp, torch.tensor(toks), tight_t, 0, return_logits=True)
    full = T.lm_forward(tp, torch.tensor(toks), tight_t)[:, :-1].detach()
    assert float((dec - full).abs().max()) > 1e-3
    jfull = J.lm_forward(jp, J.shard_tokens(toks, _mesh()), tight_j, _mesh())
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull)[:, :-1], atol=LOGIT_TOL, rtol=0)


def test_dropless_serving_ffn_matches_jax():
    jc, tc, jp, tp = setup()
    h = np.random.default_rng(10).standard_normal((3, 5, 32)).astype(np.float32)
    want = J._moe_ffn_dropless(J._moe_layer_params(jp, 1), jnp.asarray(h), 4)
    got = T._moe_ffn_dropless(T._moe_layer_params(tp, 1), torch.tensor(h), 4)
    _close(got.numpy(), np.asarray(want), "dropless")


def test_convert_carries_the_moe_keys_both_ways():
    jc, tc, _, tp = setup()
    npp = _np_params(0)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in npp.items()}
    assert tuple(tp["l1/moe_w_in"].shape) == (4, 32, 64) and "l1/w1" not in tp
    back = convert.lm_params_to_numpy(tp)
    assert set(back) == set(npp)
    for k, v in npp.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)


@pytest.mark.parametrize("kw,bad", [
    (dict(moe_every=0), None),          # the dict has experts where the config has an MLP
    (dict(moe_every=1), None),          # ... and an MLP where the config has experts
    (dict(), "l1/moe_w_in"),            # an expert tensor of the wrong shape
], ids=["dense_config", "every_layer", "misshapen_expert"])
def test_convert_refuses_a_dict_that_disagrees_with_moe_every(kw, bad):
    npp = dict(_np_params(0))
    if bad:
        npp[bad] = npp[bad][:, :, :-1]
    with pytest.raises(ValueError, match="LM param"):
        convert.lm_params_from_jax(npp, T.LMConfig(**{**MOE, **kw}), device="cpu")
