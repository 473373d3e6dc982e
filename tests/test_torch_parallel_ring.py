"""PyTorch port: the ring collectives and the gradients of the mesh's
collectives across 4 ranks, against the JAX package.

One gloo world of 4 CPU ranks (``parallel/launch.run_world``, rank
functions in ``tests/torch_seq_parallel_ranks.py``) runs every case; the
JAX side runs each under ``shard_map(check_vma=False)`` over the data
axis of a 4 x 1 mesh of the suite's virtual devices, values by the
function and gradients by ``jax.vjp`` for the same cotangents. Both move
float32 values without arithmetic (the shifts and all-to-alls) or add
four of them (the sums), so values and gradients are held within 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import PartitionSpec as P

from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.parallel import ring as jring
from parameter_server_tpu.utils.compat import shard_map
from parameter_server_tpu_torch.parallel import launch
from tests import torch_seq_parallel_ranks as ranks

N = 4
TOL = dict(rtol=0, atol=1e-6)
RNG = np.random.default_rng(23)
X = RNG.normal(size=(16, 8, 4)).astype(np.float32)


def _jmesh():
    return jmesh.make_mesh(num_data=N, num_server=1, devices=jax.devices()[:N])


def _perm(shift):
    return [(i, (i + shift) % N) for i in range(N)]


JAX_COLLECTIVES = {
    "shift+1": lambda x: jax.lax.ppermute(x, "data", _perm(1)),
    "shift-1": lambda x: jax.lax.ppermute(x, "data", _perm(-1)),
    "shift+2": lambda x: jax.lax.ppermute(x, "data", _perm(2)),
    "all_to_all 0->1": lambda x: jax.lax.all_to_all(x, "data", 0, 1, tiled=True),
    "all_to_all 1->0": lambda x: jax.lax.all_to_all(x, "data", 1, 0, tiled=True),
    "all_to_all 2->1": lambda x: jax.lax.all_to_all(x, "data", 2, 1, tiled=True),
    "all_to_all untiled 0->2": lambda x: jax.lax.all_to_all(x, "data", 0, 2, tiled=False),
    "psum": lambda x: jax.lax.psum(x, "data"),
}


def _sharded(fn, out_spec=P("data")):
    return shard_map(fn, mesh=_jmesh(), in_specs=(P("data"),), out_specs=out_spec,
                     check_vma=False)


@functools.lru_cache(maxsize=None)
def _jax_vjp(name):
    """JAX's value and gradient for ``name``'s cotangent (the global
    arrays, sharded on dim 0). jax 0.9's vjp of an untiled all-to-all
    trips its own cotangent shape check, so that gradient is JAX's
    transpose written out: the inverse all-to-all (split and concat axes
    swapped) of the cotangent."""
    y, vjp = jax.vjp(_sharded(JAX_COLLECTIVES[name]), jnp.asarray(X))
    ct = jnp.asarray(RNG_CT[name])
    if name == "all_to_all untiled 0->2":
        g = _sharded(lambda c: jax.lax.all_to_all(c, "data", 2, 0, tiled=False))(ct)
    else:
        (g,) = vjp(ct)
    return np.asarray(y), np.asarray(g)


def _out_shape(name):
    return jax.eval_shape(_sharded(JAX_COLLECTIVES[name]), jnp.asarray(X)).shape


RNG_CT = {name: np.random.default_rng(i).normal(size=_out_shape(name)).astype(np.float32)
          for i, name in enumerate(JAX_COLLECTIVES)}
INVARIANT_CT = np.random.default_rng(99).normal(size=(4, 8, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    return launch.run_world(ranks.ring_world, N, args=(X, RNG_CT, INVARIANT_CT),
                            device_type="cpu", timeout=240)


def _cat(world, key, idx=None):
    parts = [r[key] if idx is None else r[key][idx] for r in world]
    return np.concatenate(parts, axis=0)


def test_ring_allreduce_allgather_and_scan_match_jax(world):
    def local(v):
        return (jring.ring_allreduce(v, "data"),
                jring.ring_allgather(v, "data")[None],
                jring.ring_scan(v, "data", lambda a, blk, step: a + blk * (step + 1),
                                jnp.zeros_like(v)),
                jring.ring_next(v, "data"))

    red, gat, scan, nxt = shard_map(
        local, mesh=_jmesh(), in_specs=(P("data"),),
        out_specs=(P("data"), P("data"), P("data"), P("data")), check_vma=False)(jnp.asarray(X))
    np.testing.assert_allclose(_cat(world, "allreduce"), np.asarray(red), **TOL)
    np.testing.assert_allclose(_cat(world, "scan"), np.asarray(scan), **TOL)
    np.testing.assert_allclose(_cat(world, "next"), np.asarray(nxt), **TOL)
    gat = np.asarray(gat)
    for r in range(N):  # every rank sees the shards in coordinate order
        np.testing.assert_allclose(world[r]["allgather"], gat[r], **TOL)
        np.testing.assert_allclose(world[r]["allgather"], X.reshape(N, 4, 8, 4), **TOL)


@pytest.mark.parametrize("name", list(JAX_COLLECTIVES))
def test_collective_value_and_gradient_match_jax(world, name):
    want_y, want_g = _jax_vjp(name)
    np.testing.assert_allclose(_cat(world, name, 0), want_y, **TOL)
    np.testing.assert_allclose(_cat(world, name, 1), want_g, **TOL)


def test_psum_of_a_replicated_result_counts_the_cotangent_once(world):
    """``psum_invariant`` is JAX's ``psum`` under ``out_specs=P()``: the
    replicated cotangent reaches each rank's input once (JAX divides it
    by the axis size before the transposed psum)."""
    y, vjp = jax.vjp(_sharded(lambda x: jax.lax.psum(x, "data"), P()), jnp.asarray(X))
    (g,) = vjp(jnp.asarray(INVARIANT_CT))
    for r in range(N):
        np.testing.assert_allclose(world[r]["psum_invariant"][0], np.asarray(y), **TOL)
    np.testing.assert_allclose(_cat(world, "psum_invariant", 1), np.asarray(g), **TOL)


def test_shift_all_moves_a_pair_in_one_exchange(world):
    """``shift_all`` (ring attention's K/V pair) against two JAX
    ``ppermute``\\ s: values, and the gradients of ``sum(a' * b')``."""
    def f(a, b):
        ya = jax.lax.ppermute(a, "data", _perm(1))
        yb = jax.lax.ppermute(b, "data", _perm(1))
        return ya, yb

    sf = shard_map(f, mesh=_jmesh(), in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")), check_vma=False)
    a, b = jnp.asarray(X), jnp.asarray(2 * X)
    ya, yb = sf(a, b)
    ga, gb = jax.grad(lambda a, b: jnp.sum(jnp.multiply(*sf(a, b))), argnums=(0, 1))(a, b)
    for i, want in enumerate((ya, yb, ga, gb)):
        np.testing.assert_allclose(_cat(world, "shift_all", i), np.asarray(want), **TOL)
