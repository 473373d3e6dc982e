"""PyTorch port: ring attention (``xla``, ``flash``, ``zigzag``) and
Ulysses attention (``xla``, ``flash``) across 4 ranks, against the JAX
package.

One gloo world of 4 CPU ranks (rank functions in
``tests/torch_seq_parallel_ranks.py``) runs every case on its sequence
shard of the same ``[2, 32, 32]`` float32 q, k, v (the zigzag cases in
the layout of ``zigzag_permutation(32, 4)``); each rank returns its
output shard and the gradients of ``sum(out * dy)``. The JAX side is the
same function on the data axis of a 4 x 1 mesh of the suite's virtual
devices (its flash impls take their XLA branch off the TPU, the port its
kernels' plain versions), gradients by ``jax.vjp``. The causal rings'
later hops are fully masked for the first ranks (their ``lse`` gradient
must be zero), and the windowed cases (window 5) cut keys at nonzero
offsets. Tolerances are the JAX tests' against dense attention
(``tests/test_nn_parallel.py``): values within 2e-5, gradients within
2e-4; the two sum float32 terms in other orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.models import attention as jatt
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu_torch.models import attention as tatt
from parameter_server_tpu_torch.parallel import launch
from tests import torch_seq_parallel_ranks as ranks

N = 4
B, S, H, HEADS = 2, 32, 32, 8
RNG = np.random.default_rng(31)
Q, K, V, DY = (RNG.normal(size=(B, S, H)).astype(np.float32) for _ in range(4))
PERM = tatt.zigzag_permutation(S, N)

CASES = [
    ("ring xla causal", "ring", dict(impl="xla", causal=True)),
    ("ring xla", "ring", dict(impl="xla", causal=False)),
    ("ring flash causal", "ring", dict(impl="flash", causal=True)),
    ("ring flash causal window 5", "ring", dict(impl="flash", causal=True, window=5)),
    ("ring flash", "ring", dict(impl="flash", causal=False)),
    ("ring zigzag causal", "ring", dict(impl="zigzag", causal=True)),
    ("ring zigzag causal window 5", "ring", dict(impl="zigzag", causal=True, window=5)),
    ("ulysses xla causal", "ulysses", dict(impl="xla", causal=True, n_heads=HEADS)),
    ("ulysses xla", "ulysses", dict(impl="xla", causal=False, n_heads=HEADS)),
    ("ulysses flash causal", "ulysses", dict(impl="flash", causal=True, n_heads=HEADS)),
    ("ulysses flash causal window 5", "ulysses",
     dict(impl="flash", causal=True, n_heads=HEADS, window=5)),
]
ZIG = [c for c in CASES if c[2].get("impl") == "zigzag"]
NATURAL = [c for c in CASES if c not in ZIG]


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jmesh.make_mesh(num_data=N, num_server=1, devices=jax.devices()[:N])


def _inputs(zig: bool):
    arrs = (Q, K, V, DY)
    return tuple(a[:, PERM] for a in arrs) if zig else arrs


@pytest.fixture(scope="module")
def world():
    groups = [(NATURAL, *_inputs(False)), (ZIG, *_inputs(True))]
    return launch.run_world(ranks.attention_world, N, args=(groups,), device_type="cpu",
                            timeout=240)


def _jax(fn, kw, zig):
    q, k, v, dy = (jnp.asarray(a) for a in _inputs(zig))
    f = jatt.ring_attention if fn == "ring" else jatt.ulysses_attention
    out, vjp = jax.vjp(lambda q, k, v: f(q, k, v, mesh=_jmesh(), axis="data", **kw), q, k, v)
    return (np.asarray(out), *[np.asarray(g) for g in vjp(dy)])


def _check(world, name, fn, kw, zig):
    want = _jax(fn, kw, zig)
    for i, (w, tol) in enumerate(zip(want, (2e-5, 2e-4, 2e-4, 2e-4))):
        got = np.concatenate([r[name][i] for r in world], axis=1)
        np.testing.assert_allclose(got, w, rtol=0, atol=tol, err_msg=f"{name} [{i}]")


@pytest.mark.parametrize("name,fn,kw", NATURAL, ids=[c[0] for c in NATURAL])
def test_schedule_matches_jax(world, name, fn, kw):
    _check(world, name, fn, kw, False)


@pytest.mark.parametrize("name,fn,kw", ZIG, ids=[c[0] for c in ZIG])
def test_zigzag_matches_jax(world, name, fn, kw):
    _check(world, name, fn, kw, True)


def test_zigzag_equals_dense_attention_in_natural_order(world):
    """The zigzag ring's shards, put back in natural order, are dense
    causal attention (``argsort(perm)`` inverts the layout)."""
    got = np.concatenate([r["ring zigzag causal"][0] for r in world], axis=1)
    want = tatt.dense_attention(*(torch.tensor(a) for a in (Q, K, V)), causal=True)
    np.testing.assert_allclose(got[:, np.argsort(PERM)], want.numpy(), rtol=0, atol=2e-5)
