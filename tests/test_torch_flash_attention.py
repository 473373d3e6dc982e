"""PyTorch port: the flash-attention forward against the JAX package.

The port's ``ops/flash_attention.flash_attention`` runs its plain
PyTorch version on CPU tensors (the CUDA kernel is held to that version
on the card, ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).
The JAX side is ``flash_attention(..., use_pallas=True, interpret=True)``:
the Pallas kernel ``_fwd_kernel`` itself, in interpret mode, as
``tests/test_flash_attention.py`` runs it.

Tolerances:

- float32: out and lse within 2e-5 absolute, the interpret-mode figure of
  the JAX module (its lines 30-46): both sides compute exact f32 products
  and f32 sums, in another order;
- bfloat16: out within one bf16 ulp of its magnitude (2^-8 relative,
  plus 2^-8 absolute for values near zero): both sides round P to bf16
  against the same row max (the sequences here fit one JAX block) and
  the output to bf16 once, so the f32 sums' order can move the output
  across one bf16 rounding boundary and no further; lse (f32) within
  2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parameter_server_tpu.models.transformer import _prefill_attention as jax_prefill_attention
from parameter_server_tpu.ops import flash_attention as jfa
from parameter_server_tpu_torch.models.transformer import _prefill_attention
from parameter_server_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_ULP = 2.0 ** -8
NEG = -1e30


def _inputs(seed, bh, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32) for s in (sq, sk, sk))
    if dtype == "bfloat16":  # round once, in numpy terms both sides read alike
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    return q, k, v


def _torch(x, dtype):
    t = torch.tensor(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _assert_close(got_out, got_lse, want_out, want_lse, dtype):
    got_out = got_out.float().numpy()
    want_out = np.asarray(jnp.asarray(want_out, jnp.float32))
    want_lse = np.asarray(want_lse)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got_out, want_out, rtol=BF16_ULP, atol=BF16_ULP)
    else:
        np.testing.assert_allclose(got_out, want_out, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=0, atol=F32_TOL)


CASES = [
    # (sq, sk, d, causal, q_offset, k_offset, window)
    (32, 32, 16, True, 0, 0, None),
    (32, 32, 16, False, 0, 0, None),
    (24, 40, 16, True, 16, 0, None),      # Sq != Sk, chunk later in the sequence
    (17, 29, 8, True, 12, 3, None),       # ragged tails, both offsets
    (21, 13, 16, False, 0, 0, None),      # ragged, non-causal
    (32, 32, 16, True, 0, 0, 1),
    (40, 48, 16, True, 8, 0, 7),
    (64, 64, 32, True, 0, 0, 16),
    (19, 33, 8, True, 20, 5, 7),          # window, ragged, offsets
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,d,causal,qo,ko,window", CASES)
def test_plain_matches_jax_pallas_interpret(dtype, sq, sk, d, causal, qo, ko, window):
    q, k, v = _inputs(sq * 1000 + sk, 3, sq, sk, d, dtype)
    want_out, want_lse = jfa.flash_attention(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), causal=causal, q_offset=qo,
        k_offset=ko, window=window, use_pallas=True, interpret=True, with_lse=True)
    got_out, got_lse = tfa.flash_attention(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), causal=causal, q_offset=qo,
        k_offset=ko, window=window, with_lse=True)
    assert got_out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert got_out.shape == (3, sq, d) and got_lse.shape == (3, sq) and got_lse.dtype == torch.float32
    _assert_close(got_out, got_lse, want_out, want_lse, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_chunk(dtype):
    """Every key after every query: out 0 and lse _NEG on both sides."""
    q, k, v = _inputs(5, 2, 16, 16, 16, dtype)
    kw = dict(causal=True, q_offset=0, k_offset=100, with_lse=True)
    want_out, want_lse = jfa.flash_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                                             use_pallas=True, interpret=True, **kw)
    got_out, got_lse = tfa.flash_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), **kw)
    assert torch.count_nonzero(got_out) == 0
    assert torch.all(got_lse == NEG)
    _assert_close(got_out, got_lse, want_out, want_lse, dtype)


def test_partially_masked_rows_are_zero():
    """A chunk whose first rows see no key: those rows only are 0 / _NEG."""
    q, k, v = _inputs(6, 2, 16, 8, 16, "float32")
    out, lse = tfa.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True,
                                   q_offset=0, k_offset=4, with_lse=True)
    assert torch.all(out[:, :4] == 0) and torch.all(lse[:, :4] == NEG)
    assert torch.all(lse[:, 4:] > NEG / 2)


def test_tensor_offsets_equal_int_offsets():
    q, k, v = (torch.tensor(x) for x in _inputs(7, 2, 12, 20, 8, "float32"))
    a = tfa.flash_attention(q, k, v, causal=True, q_offset=9, k_offset=2, with_lse=True)
    b = tfa.flash_attention(q, k, v, causal=True, q_offset=torch.tensor(9),
                            k_offset=torch.tensor(2), with_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh,window", [(4, None), (2, None), (1, None), (2, 5), (1, 3)])
def test_flash_mha_gqa_matches_jax(dtype, kvh, window):
    """``flash_mha`` head fold and GQA grouping (query head h reads K/V
    head h // group) against the JAX wrapper."""
    b, s, nh, dh = 2, 24, 4, 8
    rng = np.random.default_rng(kvh * 10 + (window or 0))
    xq = rng.normal(size=(b, s, nh * dh)).astype(np.float32)
    xk, xv = (rng.normal(size=(b, s, kvh * dh)).astype(np.float32) for _ in range(2))
    want = jfa.flash_mha(_jax(xq, dtype), _jax(xk, dtype), _jax(xv, dtype), nh, causal=True,
                         window=window, n_kv_heads=kvh, use_pallas=True, interpret=True)
    got = tfa.flash_mha(_torch(xq, dtype), _torch(xk, dtype), _torch(xv, dtype), nh, causal=True,
                        window=window, n_kv_heads=kvh)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = dict(rtol=BF16_ULP, atol=BF16_ULP) if dtype == "bfloat16" else dict(rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("kvh,window,rope", [(4, None, False), (2, None, True), (1, 7, False),
                                             (2, 5, True)])
def test_prefill_attention_matches_jax_flash(kvh, window, rope):
    """The LM's prefill attention against the JAX dispatch forced through
    the flash kernel in interpret mode (as tests/test_transformer.py
    calls it); ``rope`` rotates q and k first, as the prefill does."""
    from parameter_server_tpu.models.transformer import apply_rope as jax_rope
    from parameter_server_tpu_torch.models.transformer import apply_rope

    b, p, nh, hd = 2, 24, 4, 8
    rng = np.random.default_rng(kvh + 3 * (window or 0))
    q = rng.normal(size=(b, p, nh, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, p, kvh, hd)).astype(np.float32) for _ in range(2))
    pos = np.arange(p)[None, :, None]
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    if rope:
        jq, jk = jax_rope(jq, pos), jax_rope(jk, pos)
        tq, tk = apply_rope(tq, torch.tensor(pos)), apply_rope(tk, torch.tensor(pos))
    want = jax_prefill_attention(jq, jk, jv, window, use_flash=True, interpret=True)
    got = _prefill_attention(tq, tk, tv, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)


def test_block_live_matches_jax():
    for args in [(0, 0, 64, 0, 0, 64, True, None), (0, 1, 64, 0, 128, 64, True, None),
                 (5, 2, 64, 0, 64, 64, True, 32), (0, 3, 64, 0, 0, 64, True, 100),
                 (0, 0, 64, 10, 64, 64, False, None)]:
        assert bool(tfa.block_live(*args)) == bool(jfa._block_live(*args)), args


def test_validation_matches_jax():
    q = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        tfa.flash_attention(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="divide"):
        tfa.flash_mha(torch.zeros(1, 4, 24), torch.zeros(1, 4, 16), torch.zeros(1, 4, 16), 3,
                      n_kv_heads=2)
    with pytest.raises(ValueError):
        jfa.flash_attention(jnp.zeros((1, 4, 8)), jnp.zeros((1, 4, 8)), jnp.zeros((1, 4, 8)),
                            window=4)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = tfa.flash_attention.launches
    q = torch.randn(2, 8, 8)
    out = tfa.flash_attention(q, q, q, causal=True)
    want, _ = tfa.flash_attention_ref(q, q, q, causal=True)
    assert torch.equal(out, want)
    assert tfa.flash_attention.launches == before


def test_other_devices_go_to_the_kernel_route_and_raise():
    q = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfa.flash_attention(q, q, q, causal=True)


def test_jax_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
