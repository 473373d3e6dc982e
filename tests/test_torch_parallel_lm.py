"""PyTorch port: the LM trained with its sequence sharded over 4 ranks,
against the JAX package's LM on a data axis of 4.

One gloo world of 4 CPU ranks (rank functions in
``tests/torch_seq_parallel_ranks.py``) runs every config on its sequence
shard of the same [2, 32] tokens (``shard_tokens``; under
``ring_zigzag`` the shards of ``zigzag_lm_arrays``): the logits shard,
the loss and the gradients summed over the ranks (``value_and_grad``
with the mesh), then 3 SGD steps (lr 0.3) of the mesh's train step. The
JAX side runs the same config on the data axis of a 4 x 1 mesh of the
suite's virtual devices, on the JAX ``init_lm`` weights (carried across
by ``convert``). Tolerances, as ``tests/test_torch_lm_training.py``
holds one card to JAX (float32 operations summed in another order):
logits within 1e-5 of their scale, the loss within 1e-6 relative, each
gradient within 1e-5 of its tensor's largest |value|, each SGD step's
loss within 1e-5 relative and the final parameters within 1e-5
relative and 1e-6 absolute.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.models import transformer as J
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.models import transformer as T
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.parallel import mesh as tmesh
from tests import torch_seq_parallel_ranks as ranks

torch.set_num_threads(1)

N = 4
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
CONFIGS = {
    "ring": dict(attention="ring"),
    "ring_flash": dict(attention="ring_flash"),
    "ring_zigzag rope": dict(attention="ring_zigzag", rope=True),
    "a2a 8 heads": dict(attention="a2a", n_heads=8),
    "moe_every 2": dict(attention="ring_flash", moe_every=2),
    "ring remat": dict(attention="ring", remat=True),
    "rope window gqa remat": dict(attention="ring_flash", rope=True, window=7, n_kv_heads=2,
                                  remat=True),
}
TOKENS = np.random.default_rng(5).integers(0, BASE["vocab"], (2, 32)).astype(np.int32)
STEPS, LR = 3, 0.3


def _cfgs(name):
    kw = dict(BASE, **CONFIGS[name])
    return J.LMConfig(**kw), T.LMConfig(**kw), kw


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jmesh.make_mesh(num_data=N, num_server=1, devices=jax.devices()[:N])


@functools.lru_cache(maxsize=None)
def _np_params(name):
    jc, tc, _ = _cfgs(name)
    jp = {k: np.asarray(v) for k, v in J.init_lm(jax.random.PRNGKey(0), jc).items()}
    return jp, convert.lm_params_to_numpy(convert.lm_params_from_jax(jp, tc, "cpu"))


def _data(name):
    """The global arrays the loss takes: tokens, or the zigzag triple."""
    if CONFIGS[name]["attention"] == "ring_zigzag":
        return J.zigzag_lm_arrays(TOKENS, N)
    return (TOKENS,)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX's logits, loss, gradients and SGD trajectory on the mesh."""
    jc, _, _ = _cfgs(name)
    mesh = _jmesh()
    zig = jc.attention == "ring_zigzag"
    data = tuple(J.shard_tokens(a, mesh) for a in _data(name))
    loss_fn = J.lm_loss_with_targets if zig else J.lm_loss
    vg = jax.jit(jax.value_and_grad(lambda p, *d: loss_fn(p, *d, jc, mesh)))
    p = {k: jnp.asarray(v) for k, v in _np_params(name)[0].items()}
    logits = jax.jit(lambda p, t: J.lm_forward(p, t, jc, mesh))(p, data[0])
    loss, grads = vg(p, *data)
    losses = []
    for _ in range(STEPS):
        sl, g = vg(p, *data)
        p = jax.tree.map(lambda a, b: a - LR * b, p, g)
        losses.append(float(sl))
    return (np.asarray(logits), float(loss), {k: np.asarray(v) for k, v in grads.items()},
            losses, {k: np.asarray(v) for k, v in p.items()})


@pytest.fixture(scope="module")
def world():
    cases = [(name, _cfgs(name)[2], _np_params(name)[1]) for name in CONFIGS]
    return launch.run_world(ranks.lm_world, N, args=(cases, TOKENS, STEPS, LR),
                            device_type="cpu", timeout=300)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_loss_and_gradients_match_jax(world, name):
    logits, loss, grads, _, _ = _jax(name)
    got = np.concatenate([r[name]["logits"] for r in world], axis=1)
    np.testing.assert_allclose(got, logits, rtol=0, atol=1e-5 * np.abs(logits).max())
    for r in world:  # the global loss and the summed gradients on every rank
        assert abs(r[name]["loss"] - loss) <= 1e-6 * abs(loss)
        assert set(r[name]["grads"]) == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(r[name]["grads"][k], g, rtol=0,
                                       atol=1e-5 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("name", ["ring", "ring_flash", "ring_zigzag rope", "a2a 8 heads",
                                  "moe_every 2"])
def test_sgd_steps_match_jax(world, name):
    _, _, _, losses, params = _jax(name)
    for r in world:
        np.testing.assert_allclose(r[name]["losses"], losses, rtol=1e-5, atol=0)
        for k, v in params.items():
            np.testing.assert_allclose(r[name]["params"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    for k in params:  # the parameters stay the same on every rank
        assert all(np.array_equal(r[name]["params"][k], world[0][name]["params"][k])
                   for r in world)


def test_loss_shift_crosses_shards(world):
    """Shard r's last target is shard r+1's first token and only the
    global last position has weight 0: the 4 ranks' loss is the one-card
    loss of the whole sequence (JAX ``test_loss_shift_crosses_shards``
    checks only that its loss is finite)."""
    _, tc, _ = _cfgs("ring")
    params = {k: torch.tensor(v) for k, v in _np_params("ring")[1].items()}
    one = float(T.lm_loss(params, torch.tensor(TOKENS), tc))
    assert np.isfinite(one) and one > 0
    for r in world:
        assert abs(r["ring"]["loss"] - one) <= 1e-6 * one


def test_world_of_one_is_the_one_card_program_bit_for_bit():
    """A 1 x 1 mesh (a process with no world) runs the one-card program:
    the loss, the gradients and an SGD step bit-equal to no mesh."""
    mesh = tmesh.make_mesh(num_data=1, num_server=1, device="cpu")
    for name in ("ring_flash", "a2a 8 heads", "moe_every 2", "rope window gqa remat"):
        _, tc, _ = _cfgs(name)
        params = {k: torch.tensor(v) for k, v in _np_params(name)[1].items()}
        toks = T.shard_tokens(TOKENS, mesh)
        la, ga = T.value_and_grad(lambda p: T.lm_loss(p, toks, tc, mesh=mesh), params, mesh=mesh)
        lb, gb = T.value_and_grad(lambda p: T.lm_loss(p, torch.tensor(TOKENS), tc), params)
        assert torch.equal(la, lb) and all(torch.equal(ga[k], gb[k]) for k in ga), name
        pa, sa = T.make_lm_train_step(tc, mesh=mesh)(params, toks)
        pb, sb = T.make_lm_train_step(tc)(params, torch.tensor(TOKENS))
        assert torch.equal(sa, sb) and all(torch.equal(pa[k], pb[k]) for k in pa), name


def test_shard_tokens_and_zigzag_arrays_match_jax():
    mesh = tmesh.Mesh(N, 1, "cpu", rank=2)
    stack = np.stack([TOKENS, TOKENS + 1])
    assert np.array_equal(T.shard_tokens(TOKENS, mesh).numpy(), TOKENS[:, 16:24])
    assert np.array_equal(T.shard_tokens(stack, mesh).numpy(), stack[..., 16:24])
    for a, b in zip(T.zigzag_lm_arrays(TOKENS, N), J.zigzag_lm_arrays(TOKENS, N)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="split"):
        T.shard_tokens(TOKENS[:, :30], mesh)
    cfg = dataclasses.replace(_cfgs("ring")[1], attention="ring_zigzag")
    with pytest.raises(ValueError, match="NATURAL"):
        T.lm_loss({}, TOKENS, cfg, mesh=mesh)
