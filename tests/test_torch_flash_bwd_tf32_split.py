"""PyTorch port: the arithmetic of the float32 ``flash_bwd_dq`` and
``flash_bwd_dkv`` kernels, emulated on the CPU.

The CUDA kernels (``kernels/csrc/flash_bwd.cu``, float32 route) run all
five products on the tensor cores in 3xTF32: S = Q.K^T and dP = dO.V^T,
then dQ = dS.K, dV = P^T.dO and dK = dS^T.Q, each operand x split as ``hi
= tf32(x)`` (round to nearest, ties away from zero, by bit mask) and ``lo
= x - hi``, which the tensor cores truncate to TF32, and each product
summed as ``lo.hi + hi.lo + hi.hi`` in float32. P and dS are formed as
the kernels form them: ``P = 2^(S scale log2e - lse log2e)``, zero where
masked, and ``dS = P (dP scale - c scale)``. The kernels run only on the
card (``tests/test_torch_kernels_cuda.py``); here the same arithmetic,
in torch (its float32 sums in torch's order,
not the kernels' k-steps: the CUDA tests hold the kernels' own sums), is
held at each float32 backward case shape of those tests but S 8192

- against the JAX package's gradients (``jax.vjp`` of ``flash_attention``
  with the lse, the Pallas kernels in interpret mode as
  ``tests/test_torch_flash_backward.py`` runs them; its plain XLA route
  past S 512, where interpret mode would take minutes) and against the
  port's plain backward ``flash_attention_bwd_ref``, within
  ``FLASH_BWD_TOL[float32]`` of ``chip_smoke.py`` and the CUDA tests (1e-5
  of each gradient's largest |value|);
- and one TF32 pass (operands rounded to TF32 once) against the same
  plain version: it falls outside that tolerance, which is why the
  kernels take three.

Inputs come from numpy with a seed.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parameter_server_tpu.ops import flash_attention as jfa
from parameter_server_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_flash_tf32_split import product, tf32

torch.set_num_threads(1)

SHARE = 1e-5  # FLASH_BWD_TOL[float32]: atol as a share of the gradient's scale
# the float32 backward cases of tests/test_torch_kernels_cuda.py (BWD_CASES
# and the race probe's) but S 8192; all causal:
# (bh, sq, sk, d, q_offset, k_offset, window, group, dlse)
CASES = [
    (4, 256, 256, 64, 0, 0, None, 1, False),
    (4, 192, 192, 128, 0, 0, 70, 2, True),
    (16, 64, 64, 16, 0, 0, None, 1, False),      # the serve CLI's small LMs
    (8, 130, 190, 32, 60, 0, 40, 2, True),       # D 32, window, GQA
    (8, 2048, 2048, 64, 0, 0, None, 4, False),   # GQA 4 at S 2048
    (2, 64, 64, 64, 0, 500, None, 1, True),      # every key in the future
    (4, 2048, 2048, 128, 0, 0, 1024, 1, False),  # D 128, window
    (32, 256, 256, 16, 0, 0, None, 1, False),    # the LM CLI's default
    (16, 96, 96, 64, 0, 0, 40, 4, False),        # the race probe's cases
    (8, 300, 300, 128, 0, 0, None, 2, False),
    (4, 4096, 4096, 64, 0, 0, None, 1, False),
    (8, 9, 333, 64, 293, 0, 100, 2, True),       # Sq < 16, offsets, window, GQA
]
INTERPRET_MAX_S = 512  # longer sequences take the JAX package's XLA route
HEADS = 2  # query heads a chunk of the emulation (a group's multiple)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def bwd_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` as the backward kernels take it: three passes with hi
    rounded and lo truncated, or (``passes`` 1) one pass on rounded
    operands."""
    if passes == 1:
        return product(a, b, 1)
    ah, bh = tf32(a), tf32(b)
    al, bl = truncated(a - ah), truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulate(q, k, v, do, lse, c, q_offset, k_offset, window, group, passes):
    """The kernels' backward (causal): every product in ``passes`` TF32
    passes; dK and dV of a K/V row summed over its group's query heads.
    Returns (dq, dk, dv)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scale_log2 = scale * math.log2(math.e)
    keep = tfa._keep(q_offset, k_offset, sq, sk, window, q.device)
    dq = torch.empty_like(q)
    dk = torch.zeros(bh, sk, d)
    dv = torch.zeros(bh, sk, d)
    heads = group * max(1, HEADS // group)
    for h in range(0, bh, heads):
        sl = slice(h, h + heads)
        kr = k[h // group:(h + heads) // group].repeat_interleave(group, dim=0)
        vr = v[h // group:(h + heads) // group].repeat_interleave(group, dim=0)
        s = bwd_product(q[sl], kr.transpose(1, 2), passes)
        dp = bwd_product(do[sl], vr.transpose(1, 2), passes)
        p = torch.where(keep, torch.exp2(s * scale_log2 - (lse[sl] * math.log2(math.e))[..., None]),
                        0.0)
        ds = p * (dp * scale - (c[sl] * scale)[..., None])
        dq[sl] = bwd_product(ds, kr, passes)
        dk[sl] = bwd_product(ds.transpose(1, 2), q[sl], passes)
        dv[sl] = bwd_product(p.transpose(1, 2), do[sl], passes)
    return dq, dk.reshape(-1, group, sk, d).sum(1), dv.reshape(-1, group, sk, d).sum(1)


def _inputs(case):
    bh, sq, sk, d, qo, ko, window, group, dlse = case
    rng = np.random.default_rng(bh * 7919 + sq * 31 + sk + d)
    q, do = (rng.normal(size=(bh, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(bh // group, sk, d)).astype(np.float32) for _ in range(2))
    dl = rng.normal(size=(bh, sq)).astype(np.float32) if dlse else np.zeros((bh, sq), np.float32)
    return q, k, v, do, dl


def _stats(q, k, v, do, dl, case):
    """lse and c as the kernels get them: the forward's lse, c = rowsum(do
    * out) - dlse (the port's plain forward)."""
    _, _, _, _, qo, ko, window, group, _ = case
    out, lse = tfa._flash_plain(q, k, v, qo, ko, True, window, group)
    return lse, (do * out).sum(-1) - dl


def _jax_grads(q, k, v, do, dl, case):
    """``jax.vjp`` of the JAX flash attention with the lse, K/V repeated
    over the group and their gradients summed back."""
    _, sq, sk, _, qo, ko, window, group, _ = case

    def grads(q, k, v, do, dl):
        def f(q, k, v):
            return jfa.flash_attention(q, k, v, causal=True, q_offset=qo, k_offset=ko,
                                       window=window, with_lse=True,
                                       use_pallas=max(sq, sk) <= INTERPRET_MAX_S, interpret=True)

        return jax.vjp(f, q, k, v)[1]((do, dl))

    kr, vr = (np.repeat(x, group, axis=0) for x in (k, v))
    args = (jnp.asarray(x) for x in (q, kr, vr, do, dl))
    gq, gk, gv = (np.asarray(g) for g in jax.jit(grads)(*args))
    return [torch.tensor(x) for x in (gq, gk.reshape(-1, group, *gk.shape[1:]).sum(1),
                                      gv.reshape(-1, group, *gv.shape[1:]).sum(1))]


def _shares(got, want):
    """Each gradient's max |got - want| as a share of its largest |want|."""
    return [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30) for x, y in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_3xtf32_backward_within_the_f32_tolerance(case):
    bh, sq, sk, d, qo, ko, window, group, _ = case
    arrays = _inputs(case)
    q, k, v, do, dl = (torch.tensor(x) for x in arrays)
    lse, c = _stats(q, k, v, do, dl, case)
    got = emulate(q, k, v, do, lse, c, qo, ko, window, group, passes=3)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    plain = tfa.flash_attention_bwd_ref(q, k, v, do, lse, c, qo, ko, causal=True, window=window,
                                        group=group)
    for ref in (plain, _jax_grads(*arrays, case)):
        shares = _shares(got, ref)
        assert max(shares) <= SHARE, shares


@pytest.mark.parametrize("case", [c for c in CASES if c[5] == 0], ids=lambda c: "-".join(map(str, c)))
def test_one_tf32_pass_misses_the_f32_tolerance(case):
    """Every case with a kept (query, key) pair (the case with every key in
    the future has none: its gradients are 0 both ways)."""
    bh, sq, sk, d, qo, ko, window, group, _ = case
    q, k, v, do, dl = (torch.tensor(x) for x in _inputs(case))
    lse, c = _stats(q, k, v, do, dl, case)
    one = emulate(q, k, v, do, lse, c, qo, ko, window, group, passes=1)
    plain = tfa.flash_attention_bwd_ref(q, k, v, do, lse, c, qo, ko, causal=True, window=window,
                                        group=group)
    assert max(_shares(one, plain)) > 10 * SHARE
