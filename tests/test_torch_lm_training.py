"""PyTorch port: LM training against the JAX package.

The port's ``lm_loss`` and its gradients (autograd through the flash
Function and, under ``remat``, ``torch.utils.checkpoint``) against
``jax.value_and_grad(lm_loss)`` on a one-device mesh, on the JAX
``init_lm`` weights carried across by ``convert.lm_params_from_jax``, and
the SGD step against JAX's ``make_lm_train_step``. On the CPU the port's
attention is the kernels' plain versions; JAX's ``ring_flash`` there is
its XLA branch (``use_pallas`` is off off-TPU), ``ring`` its XLA ring.

Tolerances:

- float32: loss within 1e-6 relative and every gradient within 1e-5 of
  its tensor's largest |value|: the same float32 operations, summed in
  another order;
- bfloat16: the loss and each gradient within 3x JAX's own gap between
  its bf16 and float32 runs on the same weights and tokens (per
  parameter kind, the largest over the layers; for the loss, the mean
  |gap| of the per-token losses it averages, since the mean's own gap can
  cancel to near nothing by chance): the two frameworks round to bf16 at
  other points (JAX's XLA attention keeps P in float32, the port rounds
  it where the TPU kernel does), and that noise is what bf16 buys, so a
  port fault shows as a gap beyond it.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parameter_server_tpu.models import attention as jatt
from parameter_server_tpu.models import transformer as J
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.models import attention as tatt
from parameter_server_tpu_torch.models import transformer as T

torch.set_num_threads(1)

BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
B, S = 2, 40
CONFIGS = {
    "ring": dict(attention="ring"),
    "ring_flash": dict(attention="ring_flash"),
    "rope_window_gqa_remat": dict(attention="ring_flash", rope=True, window=7, n_kv_heads=2,
                                  remat=True),
}


@functools.lru_cache(maxsize=None)
def _mesh():
    return meshlib.make_mesh(num_data=1, num_server=1)


def _cfgs(name, dtype="float32"):
    kw = dict(BASE, **CONFIGS[name], compute_dtype=dtype)
    return J.LMConfig(**kw), T.LMConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    jc, _ = _cfgs(name)
    return {k: np.asarray(v) for k, v in J.init_lm(jax.random.PRNGKey(0), jc).items()}


def _tokens(seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, BASE["vocab"], (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(name, dtype):
    jc, _ = _cfgs(name, dtype)
    params = {k: jnp.asarray(v) for k, v in _jax_params(name).items()}
    fn = jax.jit(jax.value_and_grad(lambda p, t: J.lm_loss(p, t, jc, _mesh())))
    loss, grads = fn(params, J.shard_tokens(_tokens(), _mesh()))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@functools.lru_cache(maxsize=None)
def _jax_token_nll(name, dtype):
    """JAX's per-token next-token losses [B, S-1]."""
    jc, _ = _cfgs(name, dtype)
    params = {k: jnp.asarray(v) for k, v in _jax_params(name).items()}
    toks = _tokens()
    logits = jax.jit(lambda p, t: J.lm_forward(p, t, jc, _mesh()))(
        params, J.shard_tokens(toks, _mesh()))
    logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1))[:, :-1]
    return -np.take_along_axis(logp, toks[:, 1:, None].astype(np.int64), axis=-1)[..., 0]


def _port_loss_grads(name, dtype, params=None):
    _, tc = _cfgs(name, dtype)
    params = params or convert.lm_params_from_jax(_jax_params(name), tc, "cpu")
    loss, grads = T.value_and_grad(lambda p: T.lm_loss(p, torch.tensor(_tokens()), tc), params)
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def _kind(name):
    return name.split("/")[-1]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_float32_loss_and_gradients_match_jax(name):
    jl, jg = _jax_loss_grads(name, "float32")
    tl, tg = _port_loss_grads(name, "float32")
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert set(tg) == set(jg)
    for k in jg:
        scale = float(np.abs(jg[k]).max())
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("name", ["ring", "rope_window_gqa_remat"])
def test_bfloat16_within_three_times_jax_bf16_noise(name):
    jl16, jg16 = _jax_loss_grads(name, "bfloat16")
    jl32, jg32 = _jax_loss_grads(name, "float32")
    tl, tg = _port_loss_grads(name, "bfloat16")
    token_gap = np.abs(_jax_token_nll(name, "bfloat16") - _jax_token_nll(name, "float32"))
    noise, gap = {"loss": float(token_gap.mean())}, {"loss": abs(tl - jl16)}
    for k in jg16:
        noise[_kind(k)] = max(noise.get(_kind(k), 0.0), float(np.abs(jg16[k] - jg32[k]).max()))
        gap[_kind(k)] = max(gap.get(_kind(k), 0.0), float(np.abs(tg[k] - jg16[k]).max()))
    assert all(noise[k] > 0 for k in noise), noise  # bf16 really rounds somewhere
    over = {k: gap[k] / (3 * noise[k]) for k in gap}
    assert max(over.values()) <= 1.0, (gap, noise)


def test_sgd_steps_match_jax():
    """Three SGD steps (lr 0.3) of ``ring_flash`` from the same weights and
    batches: every loss and the final parameters."""
    jc, tc = _cfgs("ring_flash")
    toks = [_tokens(seed) for seed in (1, 2, 3)]
    jstep = J.make_lm_train_step(jc, _mesh(), lr=0.3)
    jp = {k: jnp.asarray(v) for k, v in _jax_params("ring_flash").items()}
    tstep = T.make_lm_train_step(tc, lr=0.3)
    tp = convert.lm_params_from_jax(_jax_params("ring_flash"), tc, "cpu")
    for t in toks:
        jp, jl = jstep(jp, J.shard_tokens(t, _mesh()))
        tp, tl = tstep(tp, torch.tensor(t))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k, v in convert.lm_params_to_numpy(tp).items():
        np.testing.assert_allclose(v, np.asarray(jp[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_steps_per_launch_is_two_calls_bit_for_bit():
    _, tc = _cfgs("ring_flash")
    params = convert.lm_params_from_jax(_jax_params("ring_flash"), tc, "cpu")
    stack = torch.tensor(np.stack([_tokens(4), _tokens(5)]))
    fused, losses = T.make_lm_train_step(tc, steps_per_launch=2)(params, stack)
    step = T.make_lm_train_step(tc)
    p, l0 = step(params, stack[0])
    p, l1 = step(p, stack[1])
    assert losses.shape == (2,) and torch.equal(losses, torch.stack([l0, l1]))
    assert all(torch.equal(fused[k], p[k]) for k in p)


def test_remat_on_and_off_bit_identical():
    _, tc = _cfgs("rope_window_gqa_remat")
    params = convert.lm_params_from_jax(_jax_params("rope_window_gqa_remat"), tc, "cpu")
    on = _port_loss_grads("rope_window_gqa_remat", "float32", params)
    off_cfg = dataclasses.replace(tc, remat=False)
    loss, grads = T.value_and_grad(lambda p: T.lm_loss(p, torch.tensor(_tokens()), off_cfg), params)
    assert float(loss) == on[0]
    assert all(np.array_equal(g.numpy(), on[1][k]) for k, g in grads.items())


@pytest.mark.parametrize("donate", [False, True])
def test_donate_decides_whether_the_callers_params_change(donate):
    _, tc = _cfgs("ring")
    params = convert.lm_params_from_jax(_jax_params("ring"), tc, "cpu")
    before = {k: v.clone() for k, v in params.items()}
    new, _ = T.make_lm_train_step(tc, donate=donate)(params, torch.tensor(_tokens()))
    unchanged = all(torch.equal(params[k], before[k]) for k in params)
    assert unchanged != donate
    assert all(torch.equal(new[k], params[k]) for k in params) == donate
    if not donate:  # two configs can step from the same initial params
        again, _ = T.make_lm_train_step(tc)(params, torch.tensor(_tokens()))
        assert all(torch.equal(again[k], new[k]) for k in new)


def test_train_step_with_targets_equals_the_shifted_loss():
    _, tc = _cfgs("ring_flash")
    params = convert.lm_params_from_jax(_jax_params("ring_flash"), tc, "cpu")
    toks = torch.tensor(_tokens(6)).long()
    tgt = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])], 1)
    w = torch.ones(toks.shape)
    w[:, -1] = 0
    a, la = T.make_lm_train_step_with_targets(tc)(params, toks, tgt, w)
    b, lb = T.make_lm_train_step(tc)(params, toks)
    assert torch.equal(la, lb) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("attention", ["ring_zigzag", "a2a"])
def test_layouts_across_cards_on_one_card_match_jax(attention):
    """The layouts across ranks on one card (no mesh: the zigzag layout of
    one rank is the natural order, the all-to-alls the identity): the
    loss and gradients against JAX on its one-device mesh, within the
    float32 tolerances above. ``tests/test_torch_parallel_lm.py`` holds
    them across 4 ranks."""
    _, tc = _cfgs("ring")
    cfg = dataclasses.replace(tc, attention=attention)
    jc = dataclasses.replace(_cfgs("ring")[0], attention=attention)
    params = convert.lm_params_from_jax(_jax_params("ring"), cfg, "cpu")
    toks = _tokens()
    tgt, w = np.concatenate([toks[:, 1:], 0 * toks[:, :1]], 1), np.ones(toks.shape, np.float32)
    w[:, -1] = 0
    jp = {k: jnp.asarray(v) for k, v in _jax_params("ring").items()}
    jl, jg = jax.value_and_grad(lambda p: J.lm_loss_with_targets(
        p, jnp.asarray(toks), jnp.asarray(tgt), jnp.asarray(w), jc, _mesh()))(jp)
    tl, tg = T.value_and_grad(lambda p: T.lm_loss_with_targets(
        p, torch.tensor(toks), torch.tensor(tgt), torch.tensor(w), cfg), params)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    for k in jg:
        scale = float(np.abs(np.asarray(jg[k])).max())
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=0, atol=1e-5 * scale,
                                   err_msg=k)


def test_validation_matches_jax():
    _, tc = _cfgs("ring")
    zig = dataclasses.replace(tc, attention="ring_zigzag")
    with pytest.raises(ValueError, match="NATURAL"):
        T.lm_loss({}, torch.zeros(1, 4, dtype=torch.long), zig)
    with pytest.raises(ValueError, match="explicit targets"):
        T.make_lm_train_step(zig)
    with pytest.raises(ValueError, match="steps_per_launch"):
        T.make_lm_train_step(tc, steps_per_launch=0)


# -- models/attention.py --


@pytest.mark.parametrize("impl,causal,window", [("xla", True, None), ("xla", False, None),
                                                ("flash", True, None), ("flash", True, 5)])
def test_ring_attention_one_hop_matches_jax(impl, causal, window):
    """Values and gradients of the one-card ring (float32) against the JAX
    ring on a one-device mesh."""
    rng = np.random.default_rng(7)
    q, k, v, dy = (rng.normal(size=(3, 24, 16)).astype(np.float32) for _ in range(4))
    kw = dict(causal=causal, impl=impl, window=window)

    @jax.jit
    def jax_vjp(q, k, v, dy):
        out, vjp = jax.vjp(lambda q, k, v: jatt.ring_attention(q, k, v, mesh=_mesh(), **kw), q, k, v)
        return out, vjp(dy)

    want_out, want = jax_vjp(*(jnp.asarray(x) for x in (q, k, v, dy)))
    ts = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    out = tatt.ring_attention(*ts, **kw)
    got = torch.autograd.grad(out, ts, torch.tensor(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=2e-5)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=2e-5)


def test_dense_references_and_zigzag_permutation_match_jax():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 12, 16)).astype(np.float32) for _ in range(3))
    for causal in (False, True):
        np.testing.assert_allclose(
            tatt.dense_attention(*(torch.tensor(x) for x in (q, k, v)), causal=causal).numpy(),
            np.asarray(jatt.dense_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal)),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            tatt.dense_mha(*(torch.tensor(x) for x in (q, k, v)), 4, causal=causal).numpy(),
            np.asarray(jatt.dense_mha(*(jnp.asarray(x) for x in (q, k, v)), 4, causal=causal)),
            rtol=0, atol=1e-5)
    for s, n in ((16, 2), (24, 3), (8, 1)):
        assert np.array_equal(tatt.zigzag_permutation(s, n), jatt.zigzag_permutation(s, n))
    with pytest.raises(ValueError, match="divide"):
        tatt.zigzag_permutation(10, 3)


def test_ring_attention_validation_and_multi_card_schedules():
    q = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="impl must be"):
        tatt.ring_attention(q, q, q, impl="bogus")
    with pytest.raises(ValueError, match="flash kernels"):
        tatt.ring_attention(q, q, q, causal=True, impl="xla", window=4)
    with pytest.raises(ValueError, match="even per-device"):
        tatt.ring_attention(q[:, :7], q[:, :7], q[:, :7], causal=True, impl="zigzag")
    with pytest.raises(ValueError, match="'xla' or 'flash'"):
        tatt.ulysses_attention(q, q, q, n_heads=2, impl="bogus")
    with pytest.raises(ValueError, match="flash kernel"):
        tatt.ulysses_attention(q, q, q, n_heads=2, causal=True, window=3)
    # the schedules across ranks on one card: zigzag (one rank's layout is
    # the natural order) and Ulysses equal the dense references
    rng = np.random.default_rng(9)
    x = [torch.tensor(rng.normal(size=(2, 12, 16)).astype(np.float32)) for _ in range(3)]
    torch.testing.assert_close(tatt.ring_attention(*x, causal=True, impl="zigzag"),
                               tatt.dense_attention(*x, causal=True), rtol=0, atol=2e-6)
    for impl in ("xla", "flash"):
        torch.testing.assert_close(tatt.ulysses_attention(*x, n_heads=4, causal=True, impl=impl),
                                   tatt.dense_mha(*x, 4, causal=True), rtol=0, atol=2e-6)
