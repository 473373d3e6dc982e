"""PyTorch port: the MoE layer with its experts sharded over 4 ranks and
the pipeline over 4 stage groups, against the JAX package (the
counterparts of ``tests/test_nn_parallel.py``'s ``TestMoEExpertParallel``
and ``TestPipelineParallel``).

One gloo world of 4 CPU ranks (rank functions in
``tests/torch_seq_parallel_ranks.py``) runs every case; the JAX side runs
on the data axis of a 4 x 1 mesh of the suite's virtual devices, on the
same float32 inputs (JAX ``init_moe``'s tables). Each rank takes its
slice of the whole tables, as JAX's ``in_specs=P(axis)`` does, and the
tables' gradients are the ranks' summed over the axis. Tolerances are the
JAX tests': MoE values within 1e-6 of JAX's layer and of
``moe_ffn_dense(..., 4)``, gradients within 2e-4; the pipeline's outputs
within 1e-5 of JAX's and of ``sequential_apply``, gradients within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.models import moe as jmoe
from parameter_server_tpu.models import pipeline as jpipe
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu_torch.models import moe as tmoe
from parameter_server_tpu_torch.models import pipeline as tpipe
from parameter_server_tpu_torch.parallel import launch
from tests import torch_seq_parallel_ranks as ranks

N = 4
MOE = {k: np.asarray(v) for k, v in jmoe.init_moe(jax.random.PRNGKey(0), 16, 32, 8).items()}
X = np.random.default_rng(1).normal(size=(2, 32, 16)).astype(np.float32)
DY = np.random.default_rng(2).normal(size=(2, 32, 16)).astype(np.float32)
CAPACITY = (1.25, 8.0, 0.5)


def _stage_params(n, d, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, d, d)).astype(np.float32) * 0.3,
            "b": rng.normal(size=(n, d)).astype(np.float32) * 0.1}


def _mb(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


PIPES = {
    "one stage a group": (_stage_params(4, 8, 0), _mb((6, 5, 8), 1)),
    "gradients": (_stage_params(4, 8, 2), _mb((5, 4, 8), 3)),
    "2 stages a group": (_stage_params(8, 8, 6), _mb((5, 3, 8), 7)),
    "3 stages a group": (_stage_params(12, 8, 6), _mb((5, 3, 8), 7)),
    "single microbatch": (_stage_params(4, 8, 4), _mb((1, 3, 8), 5)),
    "5 stages on 4 groups": (_stage_params(5, 8, 0), np.zeros((2, 3, 8), np.float32)),
}


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jmesh.make_mesh(num_data=N, num_server=1, devices=jax.devices()[:N])


@pytest.fixture(scope="module")
def world():
    return launch.run_world(ranks.moe_pipeline_world, N,
                            args=(MOE, X, DY, CAPACITY,
                                  [(name, p, x) for name, (p, x) in PIPES.items()]),
                            device_type="cpu", timeout=240)


def _moe_out(world, cf):
    return np.concatenate([r["moe"][cf] for r in world], axis=1)


def test_moe_matches_jax_and_the_dense_reference(world):
    jp = {k: jnp.asarray(v) for k, v in MOE.items()}
    want = np.asarray(jmoe.moe_ffn(jp, jnp.asarray(X), mesh=_jmesh(), axis="data"))
    dense = tmoe.moe_ffn_dense({k: torch.tensor(v) for k, v in MOE.items()}, torch.tensor(X), 4)
    np.testing.assert_allclose(_moe_out(world, 1.25), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(_moe_out(world, 1.25), dense.numpy(), rtol=0, atol=1e-6)


def test_moe_gradients_match_jax(world):
    jp = {k: jnp.asarray(v) for k, v in MOE.items()}
    _, vjp = jax.vjp(lambda p, x: jmoe.moe_ffn(p, x, mesh=_jmesh(), axis="data"), jp,
                     jnp.asarray(X))
    gp, gx = vjp(jnp.asarray(DY))
    for r in world:  # every rank holds the summed gradient
        for k in MOE:
            np.testing.assert_allclose(r["moe"]["grads"][k], np.asarray(gp[k]), rtol=0,
                                       atol=2e-4, err_msg=k)
    got_dx = np.concatenate([r["moe"]["dx"] for r in world], axis=1)
    np.testing.assert_allclose(got_dx, np.asarray(gx), rtol=0, atol=2e-4)


def test_moe_capacity_drops_overflow_tokens(world):
    """Ample capacity serves every token; a tight one drops some, which
    emit exactly 0 (Switch's residual path), as JAX's layer drops them."""
    def zero_frac(cf):
        flat = _moe_out(world, cf).reshape(-1, 16)
        return (np.abs(flat).sum(axis=1) == 0).mean()

    assert zero_frac(8.0) == 0.0
    assert zero_frac(0.5) > zero_frac(8.0)
    jp = {k: jnp.asarray(v) for k, v in MOE.items()}
    for cf in (8.0, 0.5):
        want = jmoe.moe_ffn(jp, jnp.asarray(X), mesh=_jmesh(), axis="data", capacity_factor=cf)
        np.testing.assert_allclose(_moe_out(world, cf), np.asarray(want), rtol=0, atol=1e-6)


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("name", [k for k in PIPES if k != "5 stages on 4 groups"])
def test_pipeline_matches_jax_and_sequential(world, name):
    params, x = PIPES[name]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(jpipe.pipeline_apply(_jstage, jp, jnp.asarray(x), mesh=_jmesh(),
                                           axis="data"))
    seq = tpipe.sequential_apply(ranks._stage_fn, {k: torch.tensor(v) for k, v in params.items()},
                                 torch.tensor(x)).numpy()
    gp = jax.grad(lambda p: jnp.sum(jpipe.pipeline_apply(_jstage, p, jnp.asarray(x),
                                                         mesh=_jmesh(), axis="data") ** 2))(jp)
    for r in world:  # the output on every rank, the gradients summed
        out, grads = r["pipeline"][name]
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(out, seq, rtol=0, atol=1e-5)
        for k in params:
            np.testing.assert_allclose(grads[k], np.asarray(gp[k]), rtol=0, atol=1e-4,
                                       err_msg=k)


def test_pipeline_rejects_a_stage_count_off_the_axis(world):
    for r in world:
        assert "MULTIPLE" in r["pipeline"]["5 stages on 4 groups"]
    params, x = PIPES["5 stages on 4 groups"]
    with pytest.raises(ValueError, match="MULTIPLE"):
        jpipe.pipeline_apply(_jstage, {k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), mesh=_jmesh(), axis="data")
