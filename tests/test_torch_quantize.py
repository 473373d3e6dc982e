"""PyTorch port: stochastic fixed-point quantization against the JAX package.

The port's ``ops/quantize.quantize`` runs its plain PyTorch version on
CPU tensors (the CUDA kernel is held to that version bit for bit in
``tests/test_torch_kernels_cuda.py``). The JAX side is ``quantize_jax``
/ ``dequantize_jax``, the path the JAX package takes off the TPU.

The two noise streams cannot match: JAX draws ``jax.random.uniform``,
the port hashes (position, seed) as its kernel does. So:

- ``lo``/``hi`` and ``dequantize`` on the same codes: bit-equal (the
  same operations in the same order);
- codes: each within one code of JAX's (both are ``floor(scaled + u)``
  with ``u`` in [0, 1));
- round trip: ``|dequantize(q) - x| <= (hi - lo) / levels`` plus 1e-6 of
  f32 rounding in the dequantize, the bound of ``tests/test_ops.py``;
- the mean over seeds: unbiased within 4 standard errors of the
  uniform-noise rounding (per element at most half a step, so the mean
  of S seeds over N elements has a standard error <= step / (2 sqrt(SN)));
- the same seed gives the same codes, and a different seed other codes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parameter_server_tpu.filter.fixing_float import dequantize_jax, quantize_jax
from parameter_server_tpu_torch.filter import fixing_float as tff
from parameter_server_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)

N = 50_003  # not a multiple of any block


def _x(seed=0, n=N, sparse=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 0.3
    if sparse:  # a pushed gradient: most slots untouched
        x = x * (rng.random(n) < 0.3)
    return x.astype(np.float32)


def _jax(x, nb, key=0):
    q, lo, hi = quantize_jax(jnp.asarray(x), nb, jax.random.PRNGKey(key))
    return np.asarray(q), np.float32(lo), np.float32(hi)


@pytest.mark.parametrize("nb", [1, 2])
def test_range_bit_equal_and_codes_within_one(nb):
    x = _x(1)
    q, lo, hi = tq.quantize(torch.from_numpy(x), seed=7, num_bytes=nb)
    jq, jlo, jhi = _jax(x, nb)
    assert q.dtype == (torch.uint8 if nb == 1 else torch.uint16)
    assert q.shape == (N,) and lo.shape == hi.shape == ()
    assert np.float32(lo).tobytes() == jlo.tobytes()
    assert np.float32(hi).tobytes() == jhi.tobytes()
    diff = np.abs(q.numpy().astype(np.int64) - jq.astype(np.int64))
    assert diff.max() <= 1
    assert 0 < (diff != 0).mean() < 1  # the streams differ, the scheme does not


@pytest.mark.parametrize("nb", [1, 2])
def test_round_trip_within_one_step(nb):
    x = _x(2)
    q, lo, hi = tq.quantize(torch.from_numpy(x), seed=3, num_bytes=nb)
    back = tq.dequantize(q, lo, hi, nb).numpy()
    step = (float(hi) - float(lo)) / tff.levels_of(nb)
    assert np.abs(back - x).max() <= step + 1e-6
    jq, jlo, jhi = _jax(x, nb)
    jback = np.asarray(dequantize_jax(jnp.asarray(jq), jlo, jhi, nb))
    assert np.abs(jback - x).max() <= step + 1e-6


@pytest.mark.parametrize("nb", [1, 2])
def test_dequantize_bit_equal_to_jax(nb):
    x = _x(3)
    q, lo, hi = tq.quantize(torch.from_numpy(x), seed=5, num_bytes=nb)
    ours = tq.dequantize(q, lo, hi, nb).numpy()
    theirs = np.asarray(dequantize_jax(jnp.asarray(q.numpy()), jnp.asarray(lo.numpy()),
                                       jnp.asarray(hi.numpy()), nb))
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.int32), theirs.view(np.int32))


@pytest.mark.parametrize("nb", [1, 2])
def test_unbiased_over_seeds(nb):
    x = _x(4, n=4096, sparse=False)
    seeds = range(64)
    xt = torch.from_numpy(x)
    mean = np.mean([tq.dequantize(*tq.quantize(xt, s, nb), nb).numpy() for s in seeds], axis=0)
    jmean = np.mean([np.asarray(dequantize_jax(*_jax(x, nb, key=s), nb)) for s in seeds], axis=0)
    step = (float(x.max()) - float(x.min())) / tff.levels_of(nb)
    se = step / (2 * np.sqrt(len(seeds) * x.size))
    assert abs(float((mean - x).mean())) < 4 * se + 1e-7
    assert abs(float((jmean - x).mean())) < 4 * se + 1e-7
    # per element the mean over seeds converges too (half a step at most)
    assert np.abs(mean - x).max() <= step / 2 + 1e-6


def test_unbiased_constant_fraction():
    """tests/test_ops.py TestQuantizeOp's case: 0.37 between 0 and 1."""
    x = np.full(20000, 0.37, np.float32)
    x[0], x[1] = 0.0, 1.0
    q, lo, hi = tq.quantize(torch.from_numpy(x), seed=11, num_bytes=1)
    back = tq.dequantize(q, lo, hi, 1).numpy()
    assert abs(float(back[2:].mean()) - 0.37) < 2e-3


@pytest.mark.parametrize("nb", [1, 2])
def test_same_seed_same_codes(nb):
    xt = torch.from_numpy(_x(5))
    a = tq.quantize(xt, 9, nb)[0]
    b = tq.quantize(xt.clone(), 9, nb)[0]
    c = tq.quantize(xt, 10, nb)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # the seed is a uint32: wider ints wrap
    assert torch.equal(tq.quantize(xt, 9 + (1 << 32), nb)[0], a)


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("value", [0.0, 5.0, -3.25])
def test_all_zero_and_constant_inputs(nb, value):
    """All-zero (the first pull of an L1 table): hi = 1e-12, codes 0.
    Constant nonzero: lo + 1e-12 rounds back to lo, so hi == lo and the
    quotient is 0/0; the code is defined as 0 and decodes to lo exactly."""
    x = np.full(1000, value, np.float32)
    q, lo, hi = tq.quantize(torch.from_numpy(x), seed=1, num_bytes=nb)
    jq, jlo, jhi = _jax(x, nb)
    assert float(lo) == float(jlo) == value
    assert np.float32(hi).tobytes() == jhi.tobytes()
    assert int(q.numpy().max()) == 0 and int(jq.max()) == 0
    back = tq.dequantize(q, lo, hi, nb).numpy()
    np.testing.assert_array_equal(back, x)


def test_noise_is_the_top_24_hash_bits():
    from parameter_server_tpu_torch.ops.ftrl import dither_hash_u32

    u = tff.quantize_noise(4096, 77, "cpu")
    h = dither_hash_u32(torch.arange(4096), 77)
    assert torch.equal(u, (h >> 8).float() / (1 << 24))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02


def test_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="1 or 2"):
        tq.quantize(torch.zeros(8), 0, num_bytes=3)
    with pytest.raises(ValueError, match="1-D float32"):
        tq.quantize(torch.zeros(8, dtype=torch.float64), 0)
    with pytest.raises(ValueError, match="non-empty"):
        tq.quantize(torch.zeros(0), 0)
    # a tensor that is not on the CPU goes to the kernel route, which
    # launches or raises: there is no fallback to the plain version
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tq.quantize(torch.zeros(8, device="meta"), 0)
    assert tq.quantize.launches == 0
