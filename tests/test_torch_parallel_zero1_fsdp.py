"""PyTorch port: ZeRO-1 and FSDP over the data axis
(``models/transformer.zero1_shard_opt_state``, ``fsdp_shard_lm_params``,
``parallel/placement.shard_tree_over_axis``) and the optimizer chain on
placed trees (``apps/lm/optim.py``), against the JAX package.

One gloo world of 8 CPU ranks (rank functions in
``tests/torch_sharded_ranks.py``) runs every case on a ``data 4 x server
2`` mesh (``mesh8``), and on a ``1 x 8`` one for a trivial data axis.
The counterparts of ``tests/test_zero1.py`` and ``tests/test_fsdp.py``:

- placement: each leaf's spec equal to JAX's ``NamedSharding`` spec for
  the same tree (ZeRO-1 of Adam's state, composed with Megatron's
  placement, on a trivial data axis, of an indivisible leaf; FSDP of the
  parameters, the moments ``tx.init`` makes from them, composed with
  Megatron's, an indivisible leaf), and this rank's bytes of each leaf its
  whole bytes over the ranks that split it;
- trajectories (4 Adam steps, lr 1e-2, on the JAX ``init_lm``'s weights):
  ZeRO-1 bit-equal to the replicated state (Adam, Lion, Adafactor and
  Adam under ``--clip-norm``: each state leaf's slice updated from the
  slice of the summed gradient, the update gathered exactly; JAX holds
  its own to 1e-6), FSDP within JAX's FSDP bar (parameters 1e-4, losses
  1e-5: the gradient's reduce-scatter sums in another order), and the
  replicated and FSDP runs within the same bar of JAX's; Adafactor (at
  widths it factors) and the clip under Megatron's and FSDP's placements
  within the same bar of the replicated port;
- FSDP under remat, RoPE and ``ring``: two SGD steps lower the loss and
  the parameters stay split.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from parameter_server_tpu.models import transformer as J
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.models import transformer as T
from parameter_server_tpu_torch.parallel import launch
from tests import torch_sharded_ranks as ranks

CFG = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64)
AF = dict(vocab=128, d_model=128, n_heads=4, n_layers=1, d_ff=256)  # adafactor factors
SGD = dict(CFG, remat=True, rope=True, attention="ring")
_RNG = np.random.default_rng(0)
BATCHES = [_RNG.integers(0, 32, (2, 64)).astype(np.int32) for _ in range(4)]
SGD_TOKENS = np.random.default_rng(3).integers(0, 32, (2, 64)).astype(np.int32)
CLIP = dict(clip_norm=0.05)
RUNS = {
    "replicated adam": (CFG, "adam", {}, ()),
    "zero1 adam": (CFG, "adam", {}, ("zero1",)),
    "replicated lion": (CFG, "lion", {}, ()),
    "zero1 lion": (CFG, "lion", {}, ("zero1",)),
    "fsdp adam": (CFG, "adam", {}, ("fsdp",)),
    "tp fsdp zero1 adam": (CFG, "adam", {}, ("tp", "fsdp", "zero1")),
    "replicated adam clip": (CFG, "adam", CLIP, ()),
    "zero1 adam clip": (CFG, "adam", CLIP, ("zero1",)),
    "tp fsdp adam clip": (CFG, "adam", CLIP, ("tp", "fsdp")),
    "replicated adafactor": (AF, "adafactor", {}, ()),
    "zero1 adafactor": (AF, "adafactor", {}, ("zero1",)),
    "fsdp adafactor": (AF, "adafactor", {}, ("fsdp",)),
    "tp adafactor": (AF, "adafactor", {}, ("tp",)),
    "tp fsdp zero1 adafactor": (AF, "adafactor", {}, ("tp", "fsdp", "zero1")),
}
BIT_EQUAL = {"zero1 adam": "replicated adam", "zero1 lion": "replicated lion",
             "zero1 adam clip": "replicated adam clip",
             "zero1 adafactor": "replicated adafactor"}
WITHIN = {"fsdp adam": "replicated adam", "tp fsdp zero1 adam": "replicated adam",
          "tp fsdp adam clip": "replicated adam clip", "fsdp adafactor": "replicated adafactor",
          "tp adafactor": "replicated adafactor",
          "tp fsdp zero1 adafactor": "replicated adafactor"}
PLACEMENTS = ["zero1", "zero1 tp", "zero1 trivial data", "zero1 indivisible", "fsdp", "fsdp opt",
              "fsdp tp", "fsdp indivisible"]


@functools.lru_cache(maxsize=None)
def _np_params(kw_items, seed):
    kw = dict(kw_items)
    jp = {k: np.asarray(v) for k, v in J.init_lm(jax.random.PRNGKey(seed),
                                                 J.LMConfig(**kw)).items()}
    return jp, convert.lm_params_to_numpy(convert.lm_params_from_jax(jp, T.LMConfig(**kw), "cpu"))


def _items(kw):
    return tuple(sorted(kw.items()))


def _spec(x):
    if not isinstance(x.sharding, NamedSharding):  # a fresh leaf of one device: whole
        return None
    s = tuple(x.sharding.spec) + (None,) * (x.ndim - len(x.sharding.spec))
    return s if any(s) else None


def _jax_specs(name, mesh8):
    """JAX's placement of the tree the port's ``name`` places: path ->
    spec (None for whole)."""
    params = {k: jnp.asarray(v) for k, v in _np_params(_items(CFG), 0)[0].items()}
    rep = jax.device_put(params, NamedSharding(mesh8, P()))
    tx = optax.adam(1e-2)

    def adam_specs(opt):
        st = opt[0]
        out = {("count",): _spec(st.count)}
        for k in params:
            out[("mu", k)], out[("nu", k)] = _spec(st.mu[k]), _spec(st.nu[k])
        return out

    odd = jax.device_put(np.zeros((3, 5), np.float32), NamedSharding(mesh8, P()))
    if name == "zero1":
        return adam_specs(J.zero1_shard_opt_state(tx.init(rep), mesh8, "data"))
    if name == "zero1 tp":
        return adam_specs(J.zero1_shard_opt_state(
            tx.init(J.shard_lm_params(params, mesh8, "server")), mesh8, "data"))
    if name == "zero1 trivial data":
        m = jmesh.make_mesh(num_data=1, num_server=8, devices=jax.devices())
        return adam_specs(J.zero1_shard_opt_state(tx.init(J.shard_lm_params(params, m, "server")),
                                                  m, "data"))
    if name in ("zero1 indivisible", "fsdp indivisible"):
        fn = J.zero1_shard_opt_state if name.startswith("zero1") else J.fsdp_shard_lm_params
        return {("w",): _spec(fn({"w": odd}, mesh8, "data")["w"])}
    fsdp_in = J.shard_lm_params(params, mesh8, "server") if name == "fsdp tp" else params
    fsdp = J.fsdp_shard_lm_params(fsdp_in, mesh8, "data")
    if name == "fsdp opt":
        return adam_specs(tx.init(fsdp))
    return {(k,): _spec(v) for k, v in fsdp.items()}


@functools.lru_cache(maxsize=None)
def _jax_trajectory(fsdp):
    """JAX's 4 Adam steps of ``tests/test_fsdp.py`` (replicated or FSDP
    parameters) on the same weights and batches: losses, parameters."""
    mesh = jmesh.make_mesh(num_data=4, num_server=2, devices=jax.devices())
    cfg = J.LMConfig(**CFG)
    init = {k: jnp.asarray(v) for k, v in _np_params(_items(CFG), 1)[0].items()}
    p = J.fsdp_shard_lm_params(init, mesh, "data") if fsdp else \
        jax.device_put(init, NamedSharding(mesh, P()))
    tx = optax.adam(1e-2)

    @jax.jit
    def step(p, opt, toks):
        loss, g = jax.value_and_grad(J.lm_loss)(p, toks, cfg, mesh, "data")
        up, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, up), opt, loss

    opt = tx.init(p)
    losses = []
    for t in BATCHES:
        p, opt, loss = step(p, opt, J.shard_tokens(t, mesh))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def world():
    runs = [(name, kw, _np_params(_items(kw), 1)[1], opt, okw, names)
            for name, (kw, opt, okw, names) in RUNS.items()]
    sgd = (SGD, _np_params(_items(SGD), 2)[1], SGD_TOKENS)
    return launch.run_world(ranks.zero1_fsdp_world, 8,
                            args=(_np_params(_items(CFG), 0)[1], runs, BATCHES, sgd),
                            device_type="cpu", timeout=400)


@pytest.mark.parametrize("name", PLACEMENTS)
def test_placement_of_each_leaf_equals_jaxs(world, mesh8, name):
    want = {p: s for p, s in _jax_specs(name, mesh8).items() if s is not None}
    for r in world:
        assert r["placements"][name]["specs"] == want


@pytest.mark.parametrize("name", PLACEMENTS)
def test_this_ranks_bytes_are_the_whole_over_its_split(world, name):
    sizes = {"data": 4, "server": 2} if name != "zero1 trivial data" else {"data": 1, "server": 8}
    for r in world:
        rec = r["placements"][name]
        for path, whole in rec["whole"].items():
            split = int(np.prod([sizes[a] for a in rec["specs"].get(path, ()) if a]))
            assert rec["nbytes"][path] * split == whole, path
    if name in ("zero1", "fsdp"):  # JAX's own check: the embedding's bytes over n
        key = ("mu", "emb") if name == "zero1" else ("emb",)
        assert world[0]["placements"][name]["nbytes"][key] * 4 == \
            world[0]["placements"][name]["whole"][key]


@pytest.mark.parametrize("name", list(BIT_EQUAL))
def test_zero1_trajectory_is_bit_equal_to_the_replicated_state(world, name):
    for r in world:
        got, want = r["runs"][name], r["runs"][BIT_EQUAL[name]]
        assert got["losses"] == want["losses"]
        for k, v in want["params"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
        assert any("data" in s for s in got["opt_specs"].values())  # moments stayed split


@pytest.mark.parametrize("name", list(WITHIN))
def test_placed_trajectory_within_jaxs_fsdp_bar_of_the_replicated_one(world, name):
    for r in world:
        got, want = r["runs"][name], r["runs"][WITHIN[name]]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=1e-4, err_msg=k)
    if "fsdp" in name:
        assert world[0]["runs"][name]["specs"][("emb",)].count("data") == 1


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
def test_trajectories_match_jaxs(world, fsdp):
    losses, params = _jax_trajectory(fsdp)
    got = world[0]["runs"]["fsdp adam" if fsdp else "replicated adam"]
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=1e-4, err_msg=k)


def test_fsdp_under_remat_rope_and_ring_trains(world):
    for r in world:
        l0, l1 = r["sgd"]["losses"]
        assert np.isfinite(l0) and np.isfinite(l1) and l1 < l0
        assert "data" in r["sgd"]["emb_spec"]
