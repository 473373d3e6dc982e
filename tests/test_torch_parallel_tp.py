"""PyTorch port: Megatron tensor parallelism of the LM over the server
axis (``models/transformer.shard_lm_params``), training and every decode
entry point, against the JAX package.

One gloo world of 8 CPU ranks (rank functions in
``tests/torch_sharded_ranks.py``) runs every case: on a ``data 4 x server
2`` mesh (the JAX tests' ``mesh8``) and on a ``1 x 2`` mesh of its first
two ranks, each rank on its sequence shard over ``data`` and its column
blocks of ``wq`` / ``wk`` / ``wv`` / ``w1`` and row blocks of ``wo`` /
``w2`` over ``server``. The JAX side runs ``lm_forward`` and
``jax.value_and_grad(lm_loss)`` on ``shard_lm_params``' placement of the
same weights (its ``init_lm``'s, carried across by ``convert``).
Tolerances: logits within 2e-4 (``tests/test_transformer.py``'s TP bar),
the loss within 1e-6 relative and each gradient within 1e-5 of its
tensor's largest |value| (``tests/test_torch_parallel_lm.py``'s);
the gradients of the leaves every rank of a server row holds whole
(embedding, norms, MoE tables) bit-equal across the row.

Decoding (``tests/test_tp_generate.py``, ``test_moe_serving.py``,
``test_beam_search.py``, ``test_ragged_generate.py``): greedy tokens of
TP weights token for token those of the whole weights, on every rank,
beam scores within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parameter_server_tpu.models import transformer as J
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.models import transformer as T
from parameter_server_tpu_torch.parallel import launch
from tests import torch_sharded_ranks as ranks

BASE = dict(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
CASES = {
    "4x2 mha": ((4, 2), {}),
    "4x2 gqa": ((4, 2), dict(n_kv_heads=2)),
    "1x2 mha": ((1, 2), {}),
    "4x2 heads do not divide": ((4, 2), dict(n_heads=2, n_kv_heads=1, rope=True)),
    "4x2 a2a heads gathered": ((4, 2), dict(attention="a2a")),
    "4x2 moe remat ring": ((4, 2), dict(moe_every=2, remat=True, attention="ring")),
}
TOKENS = np.random.default_rng(0).integers(0, 32, (2, 64)).astype(np.int32)
TRAIN = dict(vocab=16, d_model=32, n_heads=4, n_layers=2, d_ff=64)
TRAIN_STEPS, TRAIN_LR = 30, 0.2

DEC = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64)
MOE = dict(DEC, moe_every=2, n_experts=4, capacity_factor=8.0)
P12 = np.random.default_rng(1).integers(0, 61, (2, 12))
RAGGED = np.zeros((3, 11), np.int64)
for _i, _w in enumerate([4, 11, 7]):
    RAGGED[_i, :_w] = np.random.default_rng(7 + _i).integers(1, 61, _w)
DECODE = [
    ("greedy", "generate", DEC, 0, dict(prompt=P12, steps=9)),
    ("gqa int8 cache", "generate", dict(DEC, n_kv_heads=2, kv_cache_dtype="int8"), 2,
     dict(prompt=P12, steps=7)),
    ("multi-turn continuation", "continue", DEC, 0, dict(prompt=P12, turn=[[7, 8], [9, 10]])),
    ("speculative target", "speculative", DEC, 0, dict(prompt=P12)),
    ("moe", "generate", MOE, 0,
     dict(prompt=np.random.default_rng(11).integers(0, 61, (2, 7)), steps=5)),
    ("beam", "beam", dict(DEC, vocab=37), 0,
     dict(prompt=np.random.default_rng(13).integers(0, 37, (2, 6)))),
    ("ragged", "generate", DEC, 8, dict(prompt=RAGGED, steps=6, lengths=[4, 11, 7])),
    ("heads do not divide", "generate", dict(DEC, n_heads=2, n_kv_heads=1), 3,
     dict(prompt=P12, steps=6)),
    ("sampled", "generate", DEC, 0, dict(prompt=P12, steps=6, temperature=0.9, top_k=8)),
]
GREEDY = [c[0] for c in DECODE if c[0] != "sampled"]


def _cfgs(name):
    kw = dict(BASE, **CASES[name][1])
    return J.LMConfig(**kw), T.LMConfig(**kw), kw


@functools.lru_cache(maxsize=None)
def _np_params(kw_items, seed):
    kw = dict(kw_items)
    jp = {k: np.asarray(v) for k, v in J.init_lm(jax.random.PRNGKey(seed),
                                                 J.LMConfig(**kw)).items()}
    return jp, convert.lm_params_to_numpy(convert.lm_params_from_jax(jp, T.LMConfig(**kw), "cpu"))


def _jmesh(shape):
    d, s = shape
    return jmesh.make_mesh(num_data=d, num_server=s, devices=jax.devices()[:d * s])


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX's logits, loss and gradients on its Megatron placement."""
    jc, _, kw = _cfgs(name)
    mesh = _jmesh(CASES[name][0])
    p = J.shard_lm_params({k: jnp.asarray(v) for k, v in
                           _np_params(tuple(sorted(kw.items())), 1)[0].items()}, mesh, "server")
    toks = J.shard_tokens(TOKENS, mesh)
    logits = jax.jit(lambda p, t: J.lm_forward(p, t, jc, mesh, "data"))(p, toks)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, t: J.lm_loss(p, t, jc, mesh, "data")))(
        p, toks)
    return np.asarray(logits), float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def world():
    cases = [(name, shape, _cfgs(name)[2], _np_params(tuple(sorted(_cfgs(name)[2].items())), 1)[1])
             for name, (shape, _) in CASES.items()]
    train = (TRAIN, _np_params(tuple(sorted(TRAIN.items())), 0)[1], TRAIN_STEPS, TRAIN_LR)
    return launch.run_world(ranks.tp_world, 8, args=(cases, TOKENS, train, DECODE),
                            device_type="cpu", timeout=400)


def _rows(world, name):
    """The ranks that ran ``name``, by mesh coordinates."""
    return {r[name]["coords"]: r[name] for r in world if name in r}


@pytest.mark.parametrize("name", list(CASES))
def test_tp_logits_loss_and_gradients_match_jax(world, name):
    logits, loss, grads = _jax(name)
    rows = _rows(world, name)
    d = CASES[name][0][0]
    for s in range(CASES[name][0][1]):
        got = np.concatenate([rows[(i, s)]["logits"] for i in range(d)], axis=1)
        np.testing.assert_allclose(got, logits, rtol=0, atol=2e-4)
    for rec in rows.values():
        assert abs(rec["loss"] - loss) <= 1e-6 * abs(loss)
        assert set(rec["grads"]) == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(rec["grads"][k], g, rtol=0, atol=1e-5 * np.abs(g).max(),
                                       err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_gradients_are_bit_equal_across_a_server_row(world, name):
    rows = _rows(world, name)
    for (d, s), rec in rows.items():
        assert set(rec["local"]) == {k for k in rec["grads"]
                                     if not k.endswith(("/wq", "/wk", "/wv", "/wo", "/w1", "/w2"))}
        for k, g in rec["local"].items():
            np.testing.assert_array_equal(g, rows[(d, 0)]["local"][k], err_msg=k)


def test_placement_is_megatrons(world):
    specs = world[0]["4x2 moe remat ring"]["specs"]
    assert specs[("l0/wq",)] == (None, "server") and specs[("l0/w1",)] == (None, "server")
    assert specs[("l0/wo",)] == ("server", None) and specs[("l0/w2",)] == ("server", None)
    assert ("l1/moe_w_in",) not in specs and ("emb",) not in specs and ("l0/ln1",) not in specs


def test_tp_training_lowers_the_loss_and_keeps_the_placement(world):
    for r in world:
        losses = r["train"]["losses"]
        assert np.isfinite(losses[-1]) and losses[-1] < losses[0], losses
        assert r["train"]["wq_spec"] == (None, "server")
    assert len({tuple(r["train"]["losses"]) for r in world}) == 1


@pytest.mark.parametrize("name", GREEDY)
def test_tp_decoding_equals_the_replicated_run(world, name):
    for r in world:
        rec = r["decode"][name]
        np.testing.assert_array_equal(rec["tp"][0], rec["whole"][0])
        if name == "multi-turn continuation":
            np.testing.assert_array_equal(rec["tp"][1], rec["whole"][1])
        if name == "beam":
            np.testing.assert_allclose(rec["tp"][1], rec["whole"][1], rtol=0, atol=1e-4)


def test_sampled_tp_decoding_agrees_across_every_rank(world):
    toks = [r["decode"]["sampled"]["tp"][0] for r in world]
    assert toks[0].shape == (2, 18)
    for t in toks[1:]:
        np.testing.assert_array_equal(t, toks[0])


def test_decode_caches_hold_this_ranks_kv_heads(world):
    dec = world[0]["decode"]
    assert dec["greedy"]["kv_heads"] == 2 and dec["gqa int8 cache"]["kv_heads"] == 1
    assert dec["heads do not divide"]["kv_heads"] == 1  # gathered: all of its one head
