"""PyTorch port: the collectives of tensor and data parallelism
(``parallel/mesh.py``: ``pvary``, ``all_gather_dim``, ``psum_scatter``,
``all_gather_invariant``, ``split``) across a 4 x 2 world, against the
JAX package.

One gloo world of 8 CPU ranks (rank functions in
``tests/torch_sharded_ranks.py``) runs every case on its mesh
``data 4 x server 2``. The JAX side runs ``all_gather`` and
``psum_scatter`` under ``shard_map(check_vma=False)`` on ``mesh8`` with
the same in and out specs, values by the function and gradients by
``jax.vjp`` for the same cotangents: ``all_gather_dim``'s result stacked
on a leading dim split over the gathered axis (each rank's cotangent its
own, as each rank uses an FSDP weight on data of its own: the transpose
is their ``psum_scatter``), ``all_gather_invariant``'s replicated over it
(JAX divides the replicated cotangent by the axis size before the
transpose, so each rank keeps its block of it). Megatron's column projection
(``pvary`` before a weight split by columns over ``server``) and the
gathered-heads chain (``all_gather_invariant``, ``split``, the row's
``psum_invariant``) are held to ``jax.vjp`` of the same dense function on
whole arrays, the meaning GSPMD gives the placement. Gathers and slices
move float32 values exactly; sums add at most four of them: values and
gradients within 1e-6 (1e-5 of the scale where a product sums 12 terms
in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import PartitionSpec as P

from parameter_server_tpu.utils.compat import shard_map
from parameter_server_tpu_torch.parallel import launch
from tests import torch_sharded_ranks as ranks

TOL = dict(rtol=0, atol=1e-6)
RNG = np.random.default_rng(29)
X = RNG.normal(size=(8, 12, 8)).astype(np.float32)
X2 = RNG.normal(size=(8, 12)).astype(np.float32)
W = RNG.normal(size=(12, 10)).astype(np.float32)
V = RNG.normal(size=(10, 6)).astype(np.float32)

JAX_FNS = {
    "all_gather server dim 1": lambda x: jax.lax.all_gather(x, "server", axis=1, tiled=True)[None],
    "all_gather data dim 0": lambda x: jax.lax.all_gather(x, "data", axis=0, tiled=True)[None],
    "all_gather server dim 2": lambda x: jax.lax.all_gather(x, "server", axis=2, tiled=True)[None],
    "all_gather_invariant server dim 1": lambda x: jax.lax.all_gather(x, "server", axis=1,
                                                                      tiled=True),
    "psum_scatter server dim 1": lambda x: jax.lax.psum_scatter(x, "server", scatter_dimension=1,
                                                                tiled=True),
    "psum_scatter data dim 2": lambda x: jax.lax.psum_scatter(x, "data", scatter_dimension=2,
                                                              tiled=True),
}


def _sharded(mesh8, name):
    in_spec, _, out_spec = ranks.SHARDED[name]
    return shard_map(JAX_FNS[name], mesh=mesh8, in_specs=(P(*in_spec),), out_specs=P(*out_spec),
                     check_vma=False)


def _block(a, spec, coords):
    """Rank ``coords``' block of the global array ``a`` under ``spec`` on a
    4 x 2 mesh."""
    sizes = {"data": 4, "server": 2}
    idx = {"data": coords[0], "server": coords[1]}
    out = a
    for dim, ax in enumerate(spec):
        if ax is not None:
            n = a.shape[dim] // sizes[ax]
            out = np.take(out, range(idx[ax] * n, (idx[ax] + 1) * n), axis=dim)
    return out


def _coords(r):
    return divmod(r, 2)


@functools.lru_cache(maxsize=None)
def _cts():
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "server"))
    cts = {}
    for i, name in enumerate(ranks.SHARDED):
        shape = jax.eval_shape(_sharded(mesh, name), jnp.asarray(X)).shape
        cts[name] = np.random.default_rng(i).normal(size=shape).astype(np.float32)
    cts["pvary"] = np.random.default_rng(50).normal(size=(8, 10)).astype(np.float32)
    cts["gathered"] = np.random.default_rng(51).normal(size=(8, 6)).astype(np.float32)
    return cts


@pytest.fixture(scope="module")
def world():
    return launch.run_world(ranks.collectives_world, 8, args=(X, X2, W, V, _cts()),
                            device_type="cpu", timeout=240)


@pytest.mark.parametrize("name", list(ranks.SHARDED))
def test_gather_and_scatter_match_jax(world, mesh8, name):
    in_spec, _, out_spec = ranks.SHARDED[name]
    y, vjp = jax.vjp(_sharded(mesh8, name), jnp.asarray(X))
    (g,) = vjp(jnp.asarray(_cts()[name]))
    y, g = np.asarray(y), np.asarray(g)
    for r, rec in enumerate(world):
        np.testing.assert_allclose(rec[name][0], _block(y, out_spec, _coords(r)), **TOL)
        np.testing.assert_allclose(rec[name][1], _block(g, in_spec, _coords(r)), **TOL)


def test_pvary_before_a_column_split_sums_the_input_gradient(world):
    """``pvary(x) @ w_block``: the output block of ``x @ w`` and, through
    the row's ``psum`` of the partial input gradients, the whole gradient
    of ``x``; ``w``'s block gradient summed over ``data``."""
    y, vjp = jax.vjp(lambda x, w: x @ w, jnp.asarray(X2), jnp.asarray(W))
    gx, gw = (np.asarray(t) for t in vjp(jnp.asarray(_cts()["pvary"])))
    for r, rec in enumerate(world):
        c = _coords(r)
        got_y, got_gx, got_gw = rec["pvary"]
        np.testing.assert_allclose(got_y, _block(np.asarray(y), ("data", "server"), c),
                                   rtol=0, atol=1e-5 * np.abs(y).max())
        np.testing.assert_allclose(got_gx, _block(gx, ("data", None), c), rtol=0,
                                   atol=1e-5 * np.abs(gx).max())
        np.testing.assert_allclose(got_gw, _block(gw, (None, "server"), c), rtol=0,
                                   atol=1e-5 * np.abs(gw).max())


def test_gathered_heads_and_split_count_each_cotangent_once(world):
    """The heads-gathered path in miniature: ``all_gather_invariant`` of
    the column blocks, whole work on every rank of the row, ``split`` back
    to this rank's block before the row-split ``v`` and the row's
    ``psum_invariant``: the value and the gradients of ``(x @ w) ** 2 @
    v``, none counted twice."""
    y, vjp = jax.vjp(lambda x, w, v: (x @ w) ** 2 @ v, jnp.asarray(X2), jnp.asarray(W),
                     jnp.asarray(V))
    grads = [np.asarray(t) for t in vjp(jnp.asarray(_cts()["gathered"]))]
    specs = [("data", None), ("data", None), (None, "server"), ("server", None)]
    want = [np.asarray(y)] + grads
    for r, rec in enumerate(world):
        for got, w_, spec in zip(rec["gathered"], want, specs):
            np.testing.assert_allclose(got, _block(w_, spec, _coords(r)), rtol=0,
                                       atol=1e-5 * np.abs(w_).max())
