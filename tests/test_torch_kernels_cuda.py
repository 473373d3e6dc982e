"""PyTorch port: each CUDA kernel against its plain PyTorch version, on
the card.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels have
no CPU mode): they carry the ``cuda`` marker and skip elsewhere. On a
machine with a card: ``python -m pytest tests/test_torch_kernels_cuda.py -q``.

Tolerance of the FTRL and quantize kernels: bit equality. They are built
with ``--fmad=false``, so every operation rounds once, as each eager
PyTorch op does; the bf16 dither is indexed by flat position (dense) or
u-position (sparse) in both versions, and the quantization noise by flat
position.

Tolerance of ``flash_fwd``: it sums in another order than its plain
version. float32: out and lse within 2e-5 (exact products, float32 sums
in another order). bfloat16: out within 2^-7 of |plain| plus 2^-9
absolute. 2^-7 relative is one bf16 ulp of the output (each side rounds
it once); the absolute term bounds what the two versions differ by
before that rounding: P is rounded to bf16 against the running row max
(then rescaled in f32) where the plain version rounds it against the
final max, which moves every output by a few 1e-4 whatever its size, and
an output that cancels to near zero relatively much. On an H100 the
absolute part needed was 1.09e-3 at the serving prefill and 1.34e-3 at
D 128 here; ``chip_smoke.py`` prints what each case uses. lse (float32)
within 1e-4.

Tolerance of ``flash_bwd_dq`` / ``flash_bwd_dkv`` (through the autograd
Function, against ``flash_attention_bwd_ref`` on the same out, lse and
c): see ``FLASH_BWD_TOL`` below; two backward passes must be
bit-identical (no atomics).

Race probes: ``flash_fwd`` built with ``FLASH_FWD_RACE_PROBE`` (and
``flash_bwd`` with ``FLASH_BWD_RACE_PROBE``) poisons its shared tiles with
NaN before staging them and skews every thread by a seeded pseudo-random
sleep where threads hand data over; it must give the normal build's bits
at every seed, on inputs inside NaN guard zones and into NaN-filled
outputs (no missing barrier, no stale shared memory, no read out of
range, every output written).
"""

import ctypes

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch import kernels
from parameter_server_tpu_torch.ops import flash_attention as tfa
from parameter_server_tpu_torch.ops import ftrl as tftrl
from parameter_server_tpu_torch.ops import ftrl_sparse as tsparse
from parameter_server_tpu_torch.filter import fixing_float as tff
from parameter_server_tpu_torch.ops import quantize as tq
from parameter_server_tpu_torch.ops.kv_ops import localize

pytestmark = pytest.mark.cuda

KW = dict(alpha=0.1, beta=1.0, l1=1.0, l2=0.01)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_bit_equal(a, b):
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("dtype,masked,seed", [
    (torch.float32, True, None),
    (torch.float32, False, None),
    (torch.bfloat16, False, 9),
    (torch.bfloat16, True, 9),
    (torch.bfloat16, False, None),
])
def test_dense_kernel_bit_equal(dev, dtype, masked, seed):
    rng = np.random.default_rng(0)
    p = (1 << 16) + 3  # a ragged tail past the last full block
    z = torch.tensor(rng.normal(size=p), dtype=torch.float32, device=dev)
    n = torch.tensor(rng.random(p) * 2, dtype=torch.float32, device=dev).to(dtype)
    g = torch.tensor(rng.normal(size=p) * (rng.random(p) < 0.2), dtype=torch.float32, device=dev)
    touched = (g != 0) | torch.tensor(rng.random(p) < 0.05, device=dev) if masked else None
    zk, nk, zr, nr = z.clone(), n.clone(), z.clone(), n.clone()
    before = tftrl.ftrl_update.launches
    tftrl.ftrl_update(zk, nk, g, touched, **KW, seed=seed)
    assert tftrl.ftrl_update.launches == before + 1
    tftrl.ftrl_update_ref(zr, nr, g, touched, **KW, seed=seed)
    _assert_bit_equal((zk, nk), (zr, nr))
    assert not torch.equal(zk, z)


@pytest.mark.parametrize("dtype,seed", [(torch.float32, None), (torch.bfloat16, 5)])
def test_sparse_kernel_bit_equal(dev, dtype, seed):
    rng = np.random.default_rng(1)
    p, u = 1 << 16, 4096
    live = np.unique(rng.integers(0, p, 3000))
    uslots = np.full(u, p, np.int32)  # the one-past-the-end sentinel tail
    uslots[: len(live)] = live
    rel, ok = localize(torch.tensor(uslots, device=dev), p)
    g = torch.tensor(rng.normal(size=u), dtype=torch.float32, device=dev)
    z = torch.tensor(rng.normal(size=p), dtype=torch.float32, device=dev)
    n = torch.tensor(rng.random(p) * 2, dtype=torch.float32, device=dev).to(dtype)
    zk, nk, zr, nr = z.clone(), n.clone(), z.clone(), n.clone()
    before = tsparse.ftrl_sparse_update.launches
    tsparse.ftrl_sparse_update(zk, nk, rel, ok, g, **KW, seed=seed)
    assert tsparse.ftrl_sparse_update.launches == before + 1
    tsparse.ftrl_sparse_rows_ref(zr, nr, rel, ok, g, **KW, seed=seed)
    _assert_bit_equal((zk, nk), (zr, nr))
    # the sentinel tail clips onto slot p - 1 and must not be written
    # unless a genuine entry owns it
    if p - 1 not in live:
        assert zk[p - 1] == z[p - 1]


def test_kernels_reject_what_they_do_not_take(dev):
    z = torch.zeros(64, device=dev)
    with pytest.raises(ValueError):
        tftrl.ftrl_update(z, torch.zeros(64, device=dev), torch.zeros(64), **KW)  # g on the CPU
    rel = torch.zeros(8, dtype=torch.int64, device=dev)
    ok = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="int32"):
        tsparse.ftrl_sparse_update(z, torch.zeros(64, device=dev), rel, ok,
                                   torch.zeros(8, device=dev), **KW)


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("p", [(1 << 16), (1 << 16) - 3, 1])
def test_quantize_kernel_bit_equal(dev, nb, p):
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=p) * (rng.random(p) < 0.3), dtype=torch.float32, device=dev)
    before = tq.quantize.launches
    q, lo, hi = tq.quantize(x, 1234567, nb)
    assert tq.quantize.launches == before + 1
    assert q.dtype == (torch.uint8 if nb == 1 else torch.uint16) and q.device == x.device
    lor, hir = tff.quantize_range(x)
    qr = tff.quantize_codes(x, lor, hir, 1234567, nb)
    torch.cuda.synchronize()
    assert torch.equal(q.view(torch.uint8), qr.view(torch.uint8))
    assert float(lo) == float(lor) and float(hi) == float(hir)


@pytest.mark.parametrize("value", [0.0, 5.0])
def test_quantize_kernel_constant_input(dev, value):
    x = torch.full((4099,), value, device=dev)
    q, lo, hi = tq.quantize(x, 3, 1)
    assert int(q.max()) == 0
    assert torch.equal(tq.dequantize(q, lo, hi, 1), x)


@pytest.mark.parametrize("nb", [1, 2])
def test_dequantize_on_the_card_equals_the_cpu(dev, nb):
    """The CPU dequantize is bit-equal to the JAX package's
    (tests/test_torch_quantize.py); on the card a division by a Python
    number would become a reciprocal multiply and part from it."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=1 << 16), dtype=torch.float32)
    q, lo, hi = tq.quantize(x, 11, nb)
    cpu = tq.dequantize(q, lo, hi, nb)
    card = tq.dequantize(q.to(dev), lo.to(dev), hi.to(dev), nb).cpu()
    assert torch.equal(card.view(torch.int32), cpu.view(torch.int32))


FLASH_TOL = {torch.float32: (0.0, 2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -9, 1e-4)}


@pytest.mark.parametrize("bh,sq,sk,d,dtype,causal,qo,ko,window,group", [
    (4, 256, 256, 64, torch.bfloat16, True, 0, 0, None, 1),
    (4, 256, 256, 128, torch.bfloat16, True, 0, 0, None, 1),
    (4, 200, 333, 64, torch.bfloat16, True, 133, 0, None, 1),   # ragged, offsets, Sq != Sk
    (4, 130, 190, 128, torch.float32, False, 0, 0, None, 1),
    (4, 256, 256, 64, torch.float32, True, 0, 0, 100, 1),
    (8, 300, 300, 64, torch.bfloat16, True, 0, 0, 70, 1),
    (8, 192, 192, 64, torch.bfloat16, True, 0, 0, None, 4),     # GQA: K/V rows bh / 4
    (2, 64, 64, 64, torch.bfloat16, True, 0, 500, None, 1),     # every key in the future
])
def test_flash_kernel_matches_plain(dev, bh, sq, sk, d, dtype, causal, qo, ko, window, group):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(bh, sq, d, device=dev, generator=g).to(dtype)
    k = torch.randn(bh // group, sk, d, device=dev, generator=g).to(dtype)
    v = torch.randn(bh // group, sk, d, device=dev, generator=g).to(dtype)
    before = tfa.flash_attention.launches
    out, lse = tfa.launch_kernel(q, k, v, qo, ko, causal=causal, window=window, group=group)
    assert tfa.flash_attention.launches == before + 1
    want_out, want_lse = tfa._flash_plain(q, k, v, qo, ko, causal, window, group)
    torch.cuda.synchronize()
    rtol, atol, lse_tol = FLASH_TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want_out.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=lse_tol)
    again, _ = tfa.launch_kernel(q, k, v, qo, ko, causal=causal, window=window, group=group)
    assert torch.equal(again, out)  # no atomics: run-to-run bit-identical


def test_flash_mha_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(4)
    xq = torch.tensor(rng.normal(size=(2, 96, 8 * 64)), dtype=torch.float32)
    xk, xv = (torch.tensor(rng.normal(size=(2, 96, 2 * 64)), dtype=torch.float32) for _ in range(2))
    want = tfa.flash_mha(xq, xk, xv, 8, causal=True, n_kv_heads=2, window=40)
    got = tfa.flash_mha(xq.to(dev), xk.to(dev), xv.to(dev), 8, causal=True, n_kv_heads=2, window=40)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-5)


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(2, 8, 32, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, q, q, causal=True)
    h = torch.zeros(2, 8, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(h, h, h)


def _guarded(t, pad=4096):
    """``t`` copied into the middle of a NaN-filled buffer (16-byte
    aligned): a read past either end gives NaN."""
    buf = torch.full((2 * pad + t.numel(),), float("nan"), dtype=t.dtype, device=t.device)
    buf[pad:pad + t.numel()] = t.flatten()
    return buf[pad:pad + t.numel()].view(t.shape)


def _launch(lib, q, k, v, qo, ko, window, group):
    """One causal launch of ``lib``'s kernel into NaN-filled outputs."""
    bh, sq, d = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((bh, sq), float("nan"), device=q.device)
    err = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               lse.data_ptr(), bh, sq, k.shape[1], d, group, qo, ko, 1,
                               window or 0, 1.0 / d ** 0.5, tfa._DTYPE_CODE[q.dtype],
                               torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "flash_fwd")
    torch.cuda.synchronize()
    return out, lse


@pytest.mark.parametrize("bh,sq,sk,d,dtype,qo,ko,window,group", [
    (16, 96, 96, 64, torch.float32, 0, 0, 40, 4),     # test_flash_mha_on_the_card_matches_the_cpu
    (16, 96, 96, 64, torch.bfloat16, 0, 0, 40, 4),
    (8, 300, 300, 128, torch.float32, 0, 0, None, 2),
    (8, 300, 300, 128, torch.bfloat16, 0, 0, 70, 2),
    (4, 200, 333, 64, torch.bfloat16, 133, 0, None, 1),
    (16, 1000, 2037, 64, torch.bfloat16, 1037, 0, None, 4),  # chip_smoke.py's ragged Sk tail
])
def test_flash_race_probe_is_bit_identical(dev, bh, sq, sk, d, dtype, qo, ko, window, group):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (_guarded(torch.randn(n, s, d, device=dev, generator=g).to(dtype))
               for n, s in ((bh, sq), (bh // group, sk), (bh // group, sk)))
    want_out, want_lse = _launch(kernels.library("flash_fwd"), q, k, v, qo, ko, window, group)
    assert bool(torch.isfinite(want_out.float()).all() and torch.isfinite(want_lse).all())
    plain_out, _ = tfa._flash_plain(q, k, v, qo, ko, True, window, group)
    rtol, atol, _ = FLASH_TOL[dtype]
    torch.testing.assert_close(want_out.float(), plain_out.float(), rtol=rtol, atol=atol)
    probe = kernels.variant("flash_fwd", "FLASH_FWD_RACE_PROBE")
    for seed in range(6):
        assert probe.flash_fwd_probe_seed(ctypes.c_uint(seed)) == 0
        out, lse = _launch(probe, q, k, v, qo, ko, window, group)
        assert torch.equal(_bits(out), _bits(want_out)), seed
        assert torch.equal(_bits(lse), _bits(want_lse)), seed


# -- the backward: flash_bwd_dq and flash_bwd_dkv --

# (rtol, atol as a share of the largest |plain| of the tensor). float32:
# products exact, sums in another order: 1e-5 of the tensor's scale (a
# gradient sums up to Sq or Sk terms, each of the scale's order; an H100
# needed at most 4.2e-7 of it here). bf16: one bf16 ulp of each output
# (2^-7 relative: both sides round once), plus 2^-9 of the scale for what
# the two differ by before that rounding: P and dS are rounded to bf16 from
# scores summed in another order, so a few of the thousands of bf16 terms
# of a sum sit one bf16 ulp apart, and an output that cancels to near zero
# keeps that absolute difference (an H100 needed at most 2.2e-4 of the
# scale here, 7.1e-5 at chip_smoke.py's B*H 8 x S 8192).
FLASH_BWD_TOL = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -9)}


def _bwd_case(dev, bh, sq, sk, d, dtype, qo, ko, window, group, dlse, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(bh, sq, d, device=dev, generator=g).to(dtype).requires_grad_()
    k = torch.randn(bh // group, sk, d, device=dev, generator=g).to(dtype).requires_grad_()
    v = torch.randn(bh // group, sk, d, device=dev, generator=g).to(dtype).requires_grad_()
    do = torch.randn(bh, sq, d, device=dev, generator=g).to(dtype)
    dl = torch.randn(bh, sq, device=dev, generator=g) if dlse else None
    out, lse = tfa._flash(q, k, v, qo, ko, True, window, group)
    return q, k, v, do, dl, out, lse


def _bwd_kernel_and_plain(dev, bh, sq, sk, d, dtype, qo, ko, window, group, dlse):
    """The kernels' gradients through the autograd Function (one launch
    of each) and the plain backward's on the same out, lse and c."""
    q, k, v, do, dl, out, lse = _bwd_case(dev, bh, sq, sk, d, dtype, qo, ko, window, group, dlse)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    outs, grads = ((out, lse), (do, dl)) if dlse else ((out,), (do,))
    got = torch.autograd.grad(outs, (q, k, v), grads)
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    c = (do.float() * out.float()).sum(-1)
    if dlse:
        c = c - dl
    with torch.no_grad():
        want = tfa.flash_attention_bwd_ref(q, k, v, do, lse, c, qo, ko, causal=True, window=window,
                                           group=group)
    torch.cuda.synchronize()
    return got, want


BWD_CASES = [
    # (bh, sq, sk, d, dtype, q_off, k_off, window, group, dlse)
    (4, 256, 256, 64, torch.bfloat16, 0, 0, None, 1, False),
    (4, 256, 256, 128, torch.bfloat16, 0, 0, None, 1, False),
    (4, 256, 256, 64, torch.float32, 0, 0, None, 1, False),
    (4, 192, 192, 128, torch.float32, 0, 0, 70, 2, True),
    (8, 300, 300, 64, torch.bfloat16, 0, 0, 70, 1, False),          # window, ragged
    (8, 192, 192, 64, torch.bfloat16, 0, 0, None, 4, False),        # GQA: dK/dV sum 4 heads
    (4, 200, 333, 64, torch.bfloat16, 133, 0, None, 1, True),       # offsets, Sq != Sk, dlse
    (4, 1000, 2037, 64, torch.bfloat16, 1037, 0, None, 1, False),   # ragged Sk tail
    (2, 64, 64, 64, torch.bfloat16, 0, 500, None, 1, True),         # every key in the future
    (2, 8192, 8192, 64, torch.bfloat16, 0, 0, None, 1, False),      # full length: the ring laps
    (4, 320, 192, 128, torch.bfloat16, 0, 128, None, 1, False),     # 64-multiples, not 128, D 128
    (8, 448, 1000, 64, torch.bfloat16, 552, 0, None, 4, True),      # GQA 4, offsets, Sq != Sk
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernels_match_plain(dev, case):
    dtype = case[4]
    got, want = _bwd_kernel_and_plain(dev, *case)
    rtol, share = FLASH_BWD_TOL[dtype]
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and x.shape == y.shape
        scale = max(float(y.float().abs().max()), 1e-30)
        diff = (x.float() - y.float()).abs()
        need = max(0.0, float((diff - rtol * y.float().abs()).max())) / scale
        print(f"# readings {case} {name}: max |diff| {float(diff.max()):.3g}, scale {scale:.3g}, "
              f"atol needed {need:.3g} of the scale")
        torch.testing.assert_close(x.float(), y.float(), rtol=rtol, atol=share * scale)
    # no atomics: a second backward gives the same bits
    again, _ = _bwd_kernel_and_plain(dev, *case)
    for x, y in zip(got, again):
        assert torch.equal(_bits(x), _bits(y))


def test_flash_bwd_kernels_reject_what_they_do_not_take(dev):
    q = torch.zeros(2, 64, 64, device=dev)
    lse = torch.zeros(2, 64, device=dev)
    with pytest.raises(ValueError, match="output gradient"):
        tfa.flash_bwd_dq(q, q, q, q[:, :32], lse, lse, causal=True)
    with pytest.raises(ValueError, match="lse and c"):
        tfa.flash_bwd_dkv(q, q, q, q, lse[:, :8], lse, causal=True)
    with pytest.raises(ValueError, match="one dtype"):
        tfa.flash_bwd_dq(q, q, q, q.to(torch.bfloat16), lse, lse, causal=True)


def _bwd_launch(lib, q, k, v, do, lse, c, qo, ko, window, group):
    """Both backward kernels of ``lib`` into NaN-filled outputs."""
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    dims = tfa._dims(q, k, qo, ko, True, window, group)
    stream = torch.cuda.current_stream().cuda_stream
    kernels.check(lib.flash_bwd_dq_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                          lse.data_ptr(), c.data_ptr(), dq.data_ptr(), *dims, stream),
                  "flash_bwd_dq")
    kernels.check(lib.flash_bwd_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                           lse.data_ptr(), c.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                           *dims, stream), "flash_bwd_dkv")
    torch.cuda.synchronize()
    return dq, dk, dv


@pytest.mark.parametrize("bh,sq,sk,d,dtype,qo,ko,window,group", [
    (16, 96, 96, 64, torch.float32, 0, 0, 40, 4),
    (16, 96, 96, 64, torch.bfloat16, 0, 0, 40, 4),
    (8, 300, 300, 128, torch.float32, 0, 0, None, 2),
    (8, 300, 300, 128, torch.bfloat16, 0, 0, 70, 2),
    (4, 200, 333, 64, torch.bfloat16, 133, 0, None, 1),
    (16, 1000, 2037, 64, torch.bfloat16, 1037, 0, None, 4),
    (2, 8192, 8192, 64, torch.bfloat16, 0, 0, None, 1),      # the ring laps over 100 times
    (4, 320, 192, 128, torch.bfloat16, 0, 128, None, 1),     # D 128, 64-multiples, not 128
])
def test_flash_bwd_race_probe_is_bit_identical(dev, bh, sq, sk, d, dtype, qo, ko, window, group):
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (_guarded(torch.randn(n, s, d, device=dev, generator=g).to(dtype))
                   for n, s in ((bh, sq), (bh // group, sk), (bh // group, sk), (bh, sq)))
    lse = _guarded(tfa.launch_kernel(q, k, v, qo, ko, causal=True, window=window, group=group)[1])
    c = _guarded(torch.randn(bh, sq, device=dev, generator=g))
    want = _bwd_launch(kernels.library("flash_bwd"), q, k, v, do, lse, c, qo, ko, window, group)
    assert all(bool(torch.isfinite(t.float()).all()) for t in want)
    probe = kernels.variant("flash_bwd", "FLASH_BWD_RACE_PROBE")
    for seed in range(6):
        assert probe.flash_bwd_probe_seed(ctypes.c_uint(seed)) == 0
        got = _bwd_launch(probe, q, k, v, do, lse, c, qo, ko, window, group)
        for x, y in zip(got, want):
            assert torch.equal(_bits(x), _bits(y)), seed


def test_flash_f32_card_vs_cpu_repeated(dev):
    """The float32 shape of test_flash_mha_on_the_card_matches_the_cpu,
    forward and backward, 20 times: every output and gradient element
    beyond 2e-5 of the CPU's (plain version) is recorded with its size;
    the test fails on any."""
    rng = np.random.default_rng(4)
    xq = torch.tensor(rng.normal(size=(2, 96, 8 * 64)), dtype=torch.float32)
    xk, xv = (torch.tensor(rng.normal(size=(2, 96, 2 * 64)), dtype=torch.float32) for _ in range(2))
    dy = torch.tensor(rng.normal(size=(2, 96, 8 * 64)), dtype=torch.float32)

    def run(device):
        xs = [t.to(device).requires_grad_() for t in (xq, xk, xv)]
        out = tfa.flash_mha(*xs, 8, causal=True, n_kv_heads=2, window=40)
        grads = torch.autograd.grad(out, xs, dy.to(device))
        return [out.detach().cpu(), *(t.cpu() for t in grads)]

    want = run("cpu")
    mismatches = []
    for rep in range(20):
        for name, x, y in zip(("out", "dq", "dk", "dv"), run(dev), want):
            diff = (x - y).abs()
            bad = diff > 2e-5
            if bool(bad.any()):
                mismatches.append((rep, name, int(bad.sum()), int(diff.numel()), float(diff.max())))
    print(f"# f32 card vs CPU, 20 repeats: mismatches {mismatches}")
    assert not mismatches, mismatches
