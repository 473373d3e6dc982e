"""PyTorch port: the arithmetic of the float32 ``flash_fwd`` kernel,
emulated on the CPU.

The CUDA kernel (``kernels/csrc/flash_fwd.cu``, float32 route) runs both
products on the tensor cores in 3xTF32: each operand x is split as ``hi =
tf32(x)``, ``lo = tf32(x - hi)`` (round to nearest, ties away from zero,
by bit mask), and each product is summed as ``lo.hi + hi.lo + hi.hi`` in
float32, over key tiles of 64 (32 at D >= 64) with the online softmax. The
kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``);
here the same arithmetic, in torch, is held at each float32 case shape of
those tests

- against the JAX package's ``flash_attention`` (the Pallas kernel in
  interpret mode, as the JAX tests run it; its plain XLA route past S 512,
  where interpret mode would take minutes) and against the port's plain
  version ``_flash_plain``, within the float32 ``FLASH_TOL`` of
  ``chip_smoke.py`` and the CUDA tests (out and lse within 2e-5);
- and one TF32 pass (operands rounded to TF32 once) against the same
  plain version: it falls outside that tolerance, which is why the kernel
  takes three.

Inputs come from numpy with a seed.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parameter_server_tpu.ops import flash_attention as jfa
from parameter_server_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

F32_TOL = 2e-5  # FLASH_TOL[float32]: out and lse, absolute
NEG = -1e30

# the float32 cases of tests/test_torch_kernels_cuda.py but its S 8192 one
# (its point is the tensor cores' own sums, which this emulation does not
# model, and its plain version would take GiBs here):
# (bh, sq, sk, d, causal, q_offset, k_offset, window, group)
CASES = [
    (4, 130, 190, 128, False, 0, 0, None, 1),
    (4, 256, 256, 64, True, 0, 0, 100, 1),
    (16, 64, 64, 16, True, 0, 0, None, 1),       # the serve CLI's decode-lane prefill
    (8, 100, 130, 32, True, 30, 0, 50, 2),       # D 32, ragged, window, GQA
    (128, 8, 8, 64, True, 0, 0, None, 1),        # a batcher join
    (16, 2048, 2048, 64, True, 0, 0, None, 1),   # causal, S 2048
    (8, 192, 192, 64, True, 0, 0, None, 4),      # GQA 4
    (8, 9, 333, 64, True, 293, 0, 100, 2),       # Sq < 16, offsets, window
    (2, 64, 64, 64, True, 0, 500, None, 1),      # every key in the future
    (4, 384, 384, 128, True, 0, 0, None, 1),     # D 128
    (16, 96, 96, 64, True, 0, 0, 40, 4),         # the race probe's cases
    (8, 300, 300, 128, True, 0, 0, None, 2),
    (4, 4096, 4096, 64, True, 0, 0, None, 1),
]
INTERPRET_MAX_S = 512  # longer sequences take the JAX package's XLA route


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 (10 mantissa bits; ties away from
    zero, as ``cvt.rna.tf32.f32``): add half a TF32 ulp to the magnitude
    bits, clear the 13 bits below."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` on TF32 operands with float32 sums: one pass, or three
    (lo.hi + hi.lo + hi.hi, lo.lo left out)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulate(q, k, v, q_offset, k_offset, causal, window, group, passes):
    """The kernel's forward: key tiles, online softmax with base-2
    exponentials against the running maximum of q.k, both products in
    ``passes`` TF32 passes; returns (out, lse)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    kt = 32 if d >= 64 else 64
    scale = 1.0 / math.sqrt(d)
    scale_log2 = scale * math.log2(math.e)
    keep = tfa._keep(q_offset, k_offset, sq, sk, window, q.device) if causal else None
    m = torch.full((bh, sq), NEG)
    l = torch.zeros(bh, sq)
    o = torch.zeros(bh, sq, d)
    for k0 in range(0, sk, kt):
        s = product(q, k[:, k0:k0 + kt].transpose(1, 2), passes)
        if keep is not None:
            s = torch.where(keep[..., k0:k0 + kt], s, -math.inf)
        mn = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - mn) * scale_log2)
        p = torch.exp2(s * scale_log2 - (mn * scale_log2)[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + product(p, v[:, k0:k0 + kt], passes)
        m = mn
    out = o / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m * scale + torch.log(l.clamp_min(1e-30)), NEG)
    return out, lse


def _inputs(case):
    bh, sq, sk, d, causal, qo, ko, window, group = case
    rng = np.random.default_rng(bh * 7919 + sq * 31 + sk + d)
    q = rng.normal(size=(bh, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(bh // group, sk, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _max_diffs(got, ref):
    """max |got - ref| of out and of lse (``ref`` torch or JAX arrays)."""
    return tuple(float((x - torch.as_tensor(np.array(y))).abs().max()) for x, y in zip(got, ref))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_3xtf32_within_the_f32_tolerance(case):
    bh, sq, sk, d, causal, qo, ko, window, group = case
    q, k, v = _inputs(case)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    got = emulate(tq, tk, tv, qo, ko, causal, window, group, passes=3)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    plain = tfa._flash_plain(tq, tk, tv, qo, ko, causal, window, group)
    kr, vr = (np.repeat(x, group, axis=0) for x in (k, v))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), causal=causal,
                               q_offset=qo, k_offset=ko, window=window, with_lse=True,
                               use_pallas=max(sq, sk) <= INTERPRET_MAX_S, interpret=True)
    for ref in (plain, want):
        out_err, lse_err = _max_diffs(got, ref)
        assert out_err <= F32_TOL and lse_err <= F32_TOL, (out_err, lse_err)


@pytest.mark.parametrize("case", [c for c in CASES if c[6] == 0],
                         ids=lambda c: "-".join(map(str, c)))
def test_one_tf32_pass_misses_the_f32_tolerance(case):
    """Every case with a kept (query, key) pair (the case with every key in
    the future has none: both give out 0, lse -1e30)."""
    bh, sq, sk, d, causal, qo, ko, window, group = case
    tq, tk, tv = (torch.tensor(x) for x in _inputs(case))
    one = emulate(tq, tk, tv, qo, ko, causal, window, group, passes=1)
    plain = tfa._flash_plain(tq, tk, tv, qo, ko, causal, window, group)
    out_err, lse_err = _max_diffs(one, plain)
    assert max(out_err, lse_err) > 10 * F32_TOL, (out_err, lse_err)


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([1.0, 1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                      1 + ulp / 2 - 2.0 ** -23, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 1.0, 0.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got, want)
    assert torch.equal(tf32(got), got)  # TF32 values are fixed points
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    y = torch.tensor(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21
