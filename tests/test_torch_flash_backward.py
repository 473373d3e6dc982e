"""PyTorch port: the flash-attention backward against the JAX package.

The port's ``ops/flash_attention`` differentiates through the autograd
Function ``_Flash``, whose backward on CPU tensors is the plain version
``flash_attention_bwd_ref`` of the CUDA kernels ``flash_bwd_dq`` /
``flash_bwd_dkv`` (they are held to it on the card,
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``). The JAX side
is ``jax.vjp`` of ``flash_attention(..., use_pallas=True, interpret=True,
with_lse=True)``: the Pallas kernels ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` themselves, in interpret mode, as
``tests/test_flash_attention.py`` runs them. Both get the same output
gradient and, where the case says so, the same lse gradient.

Tolerances, as a share of each gradient's largest |value| (its scale):

- float32: 1e-5 of the scale, and against the XLA branch (``use_pallas=
  False``) too: exact f32 products, f32 sums in another order, over at
  most 64 terms here (the cases need up to 8.2e-7 of it);
- bfloat16: 2^-7 relative (one bf16 ulp: each side rounds the gradient
  once) plus 2^-11 of the scale: both round P and dS to bf16 where the
  TPU kernels do, but from lse and scores summed in another order, so a
  few of a sum's bf16 terms sit one ulp apart, and a gradient that
  cancels to near zero keeps that absolute difference (the cases need up
  to 1.5e-5 of the scale);
- bfloat16 GQA through ``flash_mha``: 2^-7 of the scale. JAX repeats the
  K/V heads and rounds each query head's dK/dV to bf16 before their sum;
  the port sums the group in float32 and rounds once, so the two part by
  up to a group's worth of half-ulps (up to 2.7e-3 of the scale here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parameter_server_tpu.ops import flash_attention as jfa
from parameter_server_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

TOL = {"float32": (0.0, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -11)}
GQA_BF16_SHARE = 2.0 ** -7


def _rounded(x, dtype):
    """``x`` as the values both sides read (bf16-rounded for bf16)."""
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x.astype(np.float32)


def _inputs(seed, bh, sq, sk, d, dtype, group=1):
    rng = np.random.default_rng(seed)
    q, do = (_rounded(rng.normal(size=(bh, sq, d)), dtype) for _ in range(2))
    k, v = (_rounded(rng.normal(size=(bh // group, sk, d)), dtype) for _ in range(2))
    dlse = rng.normal(size=(bh, sq)).astype(np.float32)
    return q, k, v, do, dlse


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _jax_grads(q, k, v, do, dlse, dtype, use_pallas, **kw):
    """``jax.vjp`` of the JAX flash attention, jitted (interpret mode
    traces far faster under jit than op by op)."""

    def grads(q, k, v, do, dlse):
        def f(q, k, v):
            return jfa.flash_attention(q, k, v, use_pallas=use_pallas, interpret=True,
                                       with_lse=True, **kw)

        return jax.vjp(f, q, k, v)[1]((do, dlse))

    args = [jnp.asarray(x, _jdt(dtype)) for x in (q, k, v, do)] + [jnp.asarray(dlse)]
    return [np.asarray(jnp.asarray(g, jnp.float32)) for g in jax.jit(grads)(*args)]


def _port_grads(q, k, v, do, dlse, dtype, with_dlse, **kw):
    tq, tk, tv = (torch.tensor(x).to(_tdt(dtype)).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention(tq, tk, tv, with_lse=True, **kw)
    outs, cots = ((out, lse), (torch.tensor(do).to(_tdt(dtype)), torch.tensor(dlse))) \
        if with_dlse else ((out,), (torch.tensor(do).to(_tdt(dtype)),))
    grads = torch.autograd.grad(outs, (tq, tk, tv), cots)
    assert all(g.dtype == _tdt(dtype) for g in grads)
    return [g.float().numpy() for g in grads]


def _assert_close(got, want, dtype, share=None):
    rtol, dtype_share = TOL[dtype]
    share = dtype_share if share is None else share
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        scale = max(float(np.abs(y).max()), 1e-30)
        np.testing.assert_allclose(x, y, rtol=rtol, atol=share * scale, err_msg=name)


CASES = [
    # (sq, sk, d, causal, q_offset, k_offset, window, dlse)
    (32, 32, 64, True, 0, 0, None, False),
    (32, 32, 128, True, 0, 0, None, True),
    (24, 40, 64, True, 16, 0, None, True),      # Sq != Sk, chunk later in the sequence
    (17, 29, 64, True, 12, 3, None, False),     # ragged tails, both offsets
    (21, 13, 64, False, 0, 0, None, True),      # ragged, non-causal
    (40, 48, 64, True, 8, 0, 7, True),          # window with offsets
    (19, 33, 128, True, 20, 5, 7, False),       # window, ragged, offsets, D 128
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,d,causal,qo,ko,window,dlse", CASES)
def test_gradients_match_jax_pallas_interpret(dtype, sq, sk, d, causal, qo, ko, window, dlse):
    q, k, v, do, dl = _inputs(sq * 1000 + sk + d, 3, sq, sk, d, dtype)
    kw = dict(causal=causal, q_offset=qo, k_offset=ko, window=window)
    want = _jax_grads(q, k, v, do, dl if dlse else 0 * dl, dtype, True, **kw)
    got = _port_grads(q, k, v, do, dl, dtype, dlse, **kw)
    _assert_close(got, want, dtype)
    if dtype == "float32":  # the XLA branch computes the same float32 math
        _assert_close(got, _jax_grads(q, k, v, do, dl if dlse else 0 * dl, dtype, False, **kw),
                      dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh,window", [(2, None), (1, 5)])
def test_flash_mha_gqa_gradients_match_jax(dtype, kvh, window):
    """GQA through ``flash_mha``: the port reads the grouped K/V in place
    and sums each K/V head's gradient over its query heads (in float32,
    before the cast); JAX repeats K/V and sums the repeated heads'
    gradients."""
    b, s, nh, dh = 2, 24, 4, 64
    rng = np.random.default_rng(kvh * 10 + (window or 0))
    xq, dy = (_rounded(rng.normal(size=(b, s, nh * dh)), dtype) for _ in range(2))
    xk, xv = (_rounded(rng.normal(size=(b, s, kvh * dh)), dtype) for _ in range(2))
    kw = dict(causal=True, window=window, n_kv_heads=kvh)

    @jax.jit
    def grads(q, k, v, dy):
        return jax.vjp(lambda q, k, v: jfa.flash_mha(q, k, v, nh, use_pallas=True, interpret=True,
                                                     **kw), q, k, v)[1](dy)

    want = [np.asarray(jnp.asarray(g, jnp.float32))
            for g in grads(*(jnp.asarray(x, _jdt(dtype)) for x in (xq, xk, xv, dy)))]
    ts = [torch.tensor(x).to(_tdt(dtype)).requires_grad_() for x in (xq, xk, xv)]
    out = tfa.flash_mha(*ts, nh, **kw)
    got = [g.float().numpy() for g in torch.autograd.grad(out, ts, torch.tensor(dy).to(_tdt(dtype)))]
    _assert_close(got, want, dtype, GQA_BF16_SHARE if dtype == "bfloat16" else None)


def test_plain_backward_equals_autograd_of_the_plain_forward():
    """In float32 the plain backward is the exact gradient of the plain
    forward: autograd through ``flash_attention_ref`` gives the same
    numbers to float32 rounding (lse's gradient included)."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.normal(size=(2, 20, 16)), dtype=torch.float32).requires_grad_()
               for _ in range(3))
    do = torch.tensor(rng.normal(size=(2, 20, 16)), dtype=torch.float32)
    dl = torch.tensor(rng.normal(size=(2, 20)), dtype=torch.float32)
    got = torch.autograd.grad(tfa.flash_attention(q, k, v, causal=True, q_offset=4, window=9,
                                                  with_lse=True), (q, k, v), (do, dl))
    want = torch.autograd.grad(tfa.flash_attention_ref(q, k, v, 4, 0, causal=True, window=9),
                               (q, k, v), (do, dl))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)


def test_unused_lse_and_offsets_get_no_gradient():
    """Only ``out`` used: ``dlse`` counts as zeros; offsets given as
    tensors get no gradient."""
    q = torch.randn(2, 8, 16, requires_grad=True)
    out, _ = tfa.flash_attention(q, q, q, causal=True, q_offset=torch.tensor(3),
                                 k_offset=torch.tensor(0), with_lse=True)
    (g,) = torch.autograd.grad(out.sum(), (q,))
    assert torch.isfinite(g).all()


def test_cpu_backward_launches_no_kernel():
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    q = torch.randn(2, 8, 64, requires_grad=True)
    tfa.flash_attention(q, q, q, causal=True).sum().backward()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == before


def test_backward_kernel_route_raises_off_the_card():
    """A tensor that is not on the CPU goes to the kernel route, which
    launches or raises: there is no fallback to the plain version."""
    q = torch.zeros(2, 8, 64, device="meta")
    lse = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfa.flash_bwd_dq(q, q, q, q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfa.flash_bwd_dkv(q, q, q, q, lse, lse, causal=True)
