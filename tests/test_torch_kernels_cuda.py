"""PyTorch port: each CUDA kernel against its plain PyTorch version, on
the card.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels have
no CPU mode): they carry the ``cuda`` marker and skip elsewhere. On a
machine with a card: ``python -m pytest tests/test_torch_kernels_cuda.py -q``.

Tolerance of the FTRL and quantize kernels: bit equality (the FTRL
kernels also at lengths that leave a ragged tail, with views at odd
offsets that leave an unaligned head, and with no slot or every slot
touched). They are built
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

Tolerance of ``segment_sum``: bit equality with the CPU, and run to run.
Both devices add each segment in entry order from +0.0 (``ops/segment_sum.py``:
the card after a stable sort, or on ids already grouped on the presorted
route; the CPU with ``index_add_`` on the entries as they come).

Tolerance of the fused ``quantize``: ``lo``, ``hi`` and the codes bit-equal
to ``quantize_range`` and ``quantize_codes`` on the card, on inputs whose
min or max is a zero of both signs, with a NaN, all zeros, constant.

The timer (``benchmarks/timing.py``): a host sleep before a short kernel's
launch must not show in its reading; the timer without the spin, kept
here, reads it.

Race probes: ``flash_fwd`` built with ``FLASH_FWD_RACE_PROBE`` (and
``flash_bwd`` with ``FLASH_BWD_RACE_PROBE``) poisons its shared tiles with
NaN before staging them and skews every thread by a seeded pseudo-random
sleep where threads hand data over; it must give the normal build's bits
at every seed, on inputs inside NaN guard zones and into NaN-filled
outputs (no missing barrier, no stale shared memory, no read out of
range, every output written).
"""

import ctypes
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch import kernels
from parameter_server_tpu_torch.benchmarks import ctr, segment_bytes, timing
from parameter_server_tpu_torch.ops import flash_attention as tfa
from parameter_server_tpu_torch.ops import ftrl as tftrl
from parameter_server_tpu_torch.ops import ftrl_sparse as tsparse
from parameter_server_tpu_torch.filter import fixing_float as tff
from parameter_server_tpu_torch.ops import quantize as tq
from parameter_server_tpu_torch.ops import segment_sum as tseg
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


def _at_offset(t, offset):
    """``t`` copied into a view that starts ``offset`` elements into its
    buffer (no longer 16-byte aligned for an odd offset)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:]
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype,seed", [(torch.float32, None), (torch.bfloat16, None),
                                        (torch.bfloat16, 9)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("frac", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("p", [(1 << 16) + 3, (1 << 16) + 15])
def test_dense_kernel_bit_equal_at_ragged_lengths_and_offsets(dev, p, offset, frac, masked, dtype,
                                                              seed):
    """The scalar head (a view at an odd offset) and tail (P not a whole
    number of 16-slot chunks), no slot and every slot touched."""
    rng = np.random.default_rng(p + offset)
    g = torch.tensor(rng.normal(size=p) * (rng.random(p) < frac), dtype=torch.float32, device=dev)
    z = torch.tensor(rng.normal(size=p), dtype=torch.float32, device=dev)
    n = torch.tensor(rng.random(p) * 2, dtype=torch.float32, device=dev).to(dtype)
    touched = (g != 0) | torch.tensor(rng.random(p) < frac / 4, device=dev) if masked else None
    zk, nk, gk = (_at_offset(t, offset) for t in (z, n, g))
    tk = None if touched is None else _at_offset(touched, offset)
    zr, nr = z.clone(), n.clone()
    tftrl.ftrl_update(zk, nk, gk, tk, **KW, seed=seed)
    tftrl.ftrl_update_ref(zr, nr, g, touched, **KW, seed=seed)
    _assert_bit_equal((zk, nk), (zr, nr))
    assert torch.equal(zk, z) == (frac == 0.0)


@pytest.mark.parametrize("dtype,seed", [(torch.float32, None), (torch.bfloat16, None),
                                        (torch.bfloat16, 5)])
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (1, 1, 1, 1), (1, 0, 3, 1)])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("u", [4093, 4096])
def test_sparse_kernel_bit_equal_at_ragged_lengths_orders_and_offsets(dev, u, order, offsets,
                                                                      dtype, seed):
    """U not a multiple of 4, rel in any order, and rel / g / ok / the
    table as views at offsets (all aligned together, or never: then every
    position takes the scalar route)."""
    rng = np.random.default_rng(u)
    p = 1 << 16
    live = np.unique(rng.integers(0, p, 3000))
    uslots = np.full(u, p, np.int32)  # the one-past-the-end sentinel tail
    uslots[: len(live)] = live
    rel, ok = localize(torch.tensor(uslots, device=dev), p)
    g = torch.tensor(rng.normal(size=u), dtype=torch.float32, device=dev)
    g[::7] = 0.0  # some owned entries with no gradient
    if order == "shuffled":
        perm = torch.tensor(rng.permutation(u), device=dev)
        rel, ok, g = rel[perm], ok[perm], g[perm]
    z = torch.tensor(rng.normal(size=p), dtype=torch.float32, device=dev)
    n = torch.tensor(rng.random(p) * 2, dtype=torch.float32, device=dev).to(dtype)
    rel_o, g_o, ok_o, table_o = offsets
    relk, gk, okk = _at_offset(rel, rel_o), _at_offset(g, g_o), _at_offset(ok, ok_o)
    zk, nk = _at_offset(z, table_o), _at_offset(n, table_o)
    zr, nr = z.clone(), n.clone()
    tsparse.ftrl_sparse_update(zk, nk, relk, okk, gk, **KW, seed=seed)
    tsparse.ftrl_sparse_rows_ref(zr, nr, rel, ok, g, **KW, seed=seed)
    _assert_bit_equal((zk, nk), (zr, nr))
    assert not torch.equal(zk, z)


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


def _range_cases(p, rng):
    """Inputs whose range needs care: a pushed gradient (zeros of both
    signs inside it), a min or a max that is a zero of both signs, all
    zeros of both signs, all +0.0, a NaN, a constant."""
    x = (rng.normal(size=p) * (rng.random(p) < 0.3)).astype(np.float32)
    pos = np.abs(x)
    pos[(pos == 0) & (rng.random(p) < 0.5)] = -0.0
    zeros = np.zeros(p, np.float32)
    zeros[rng.random(p) < 0.5] = -0.0
    nan = x.copy()
    nan[p // 3] = np.nan
    return {"pushed gradient": x, "min a zero of both signs": pos,
            "max a zero of both signs": -pos, "all zeros, both signs": zeros,
            "all +0.0": np.zeros(p, np.float32), "a NaN": nan,
            "constant": np.full(p, 5.0, np.float32)}


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("p", [1 << 22, (1 << 22) - 3, 100])
def test_fused_quantize_range_and_codes_bit_equal(dev, nb, p):
    """One launch: ``lo``, ``hi`` and codes bit-equal to the plain
    version's on the card, on every case of ``_range_cases``."""
    for name, x in _range_cases(p, np.random.default_rng(7)).items():
        xt = torch.from_numpy(x).to(dev)
        before = tq.quantize.launches
        q, lo, hi = tq.quantize(xt, 4321, nb)
        assert tq.quantize.launches == before + 1
        lor, hir = tff.quantize_range(xt)
        qr = tff.quantize_codes(xt, lor, hir, 4321, nb)
        torch.cuda.synchronize()
        got = [int(t.view(torch.int32)) for t in (lo, hi)]
        want = [int(t.view(torch.int32)) for t in (lor, hir)]
        assert got == want, (name, [hex(v) for v in got], [hex(v) for v in want])
        assert torch.equal(q.view(torch.uint8), qr.view(torch.uint8)), name
        if name.startswith("all zeros") or name.startswith("min a zero"):
            assert got[0] == 0, name  # +0.0, whatever the signs' order


def test_fused_quantize_takes_a_view_at_an_odd_offset(dev):
    x = torch.randn(1 << 16, device=dev)[3:]
    q, lo, hi = tq.quantize(x, 5, 1)
    lor, hir = tff.quantize_range(x)
    assert torch.equal(q, tff.quantize_codes(x, lor, hir, 5, 1))
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
    (8, 40, 333, 64, torch.bfloat16, True, 293, 0, 100, 2),     # Sq < 64, offsets, window, GQA
    (4, 384, 640, 128, torch.bfloat16, True, 256, 0, 200, 2),   # D 128, Sk no multiple of 128
    (16, 64, 64, 16, torch.float32, True, 0, 0, None, 1),       # the serve CLI's decode prefill
    (8, 100, 130, 32, torch.float32, True, 30, 0, 50, 2),       # f32 D 32, ragged, window, GQA
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
    q = torch.zeros(2, 8, 48, device=dev)  # float32 takes D 16, 32, 64 and 128
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, q, q, causal=True)
    b = torch.zeros(2, 8, 32, device=dev, dtype=torch.bfloat16)  # bf16: D 64 and 128
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(b, b, b, causal=True)
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
    (4, 8192, 8192, 64, torch.bfloat16, 0, 0, None, 1),      # a block laps the ring many times
    (8, 40, 333, 64, torch.bfloat16, 293, 0, 100, 2),        # Sq < 64, offsets, window, GQA
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
    (16, 64, 64, 16, torch.float32, 0, 0, None, 1, False),          # the serve CLI's small LMs
    (8, 130, 190, 32, torch.float32, 60, 0, 40, 2, True),           # f32 D 32, window, GQA
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


# -- the linear step's segment sums: deterministic, the card's equal to the CPU's --


def _segment_case(kind, rng):
    if kind == "headline_rows":  # Xw by row: sorted rows, padding (row 0, value 0) last
        rows = np.sort(rng.integers(0, 16384, 638976)).astype(np.int32)
        ids = np.concatenate([rows, np.zeros(159744, np.int32)])
        data = np.concatenate([rng.normal(size=rows.size), np.zeros(159744)])
        return data.astype(np.float32), ids, 16384
    if kind == "hot_key":  # the CTR data's frequent keys: a few segments of thousands
        ids = np.where(rng.random(200000) < 0.05, 7, rng.integers(0, 1 << 22, 200000))
        return rng.normal(size=ids.size).astype(np.float32), ids.astype(np.int32), 1 << 22
    if kind == "ctr_hot_run":  # a CTR minibatch's shard gradient by slot: a run of > 7,000
        _, keys, first = ctr.ctr_rows(rng, 10_000)
        ids = (keys[first] % (1 << 22)).astype(np.int32)
        return rng.normal(size=ids.size).astype(np.float32), ids, 1 << 22
    if kind == "mixed":  # unsorted, mixed sign and magnitude, -0.0, exact cancellations
        ids = rng.integers(0, 300, 50000).astype(np.int32)
        data = (rng.normal(size=ids.size) * 10.0 ** rng.integers(-30, 30, ids.size)).astype(np.float32)
        data[rng.random(ids.size) < 0.1] = -0.0
        return data, ids, 300
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["headline_rows", "hot_key", "ctr_hot_run", "mixed"])
def test_segment_sum_on_the_card_equals_the_cpu(dev, kind):
    data, ids, n = _segment_case(kind, np.random.default_rng(5))
    if kind == "ctr_hot_run":
        assert segment_bytes.counts(torch.from_numpy(data), torch.from_numpy(ids), n)["longest"] > 7000
    want = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n)
    routes = [False, True] if kind == "headline_rows" else [False]  # rows: grouped already
    for presorted in routes:
        before = tseg.segment_sum.launches
        got = tseg.segment_sum(torch.from_numpy(data).to(dev), torch.from_numpy(ids).to(dev), n,
                               presorted=presorted)
        assert tseg.segment_sum.launches == before + 1
        again = tseg.segment_sum(torch.from_numpy(data).to(dev), torch.from_numpy(ids).to(dev), n,
                                 presorted=presorted)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got.cpu()), _bits(want)), presorted
        assert torch.equal(_bits(again), _bits(got)), presorted


def _grouped_case(rng, runs):
    """Ids that meet the presorted contract, built to reach every path of
    the kernel: runs of 1 to a few entries, of hundreds (across tiles) and
    of thousands (streamed), ids rising with gaps; runs of zeros of an
    earlier id (a batch's padding), all-zero segments, zeros of both
    signs inside runs and before a run's first nonzero entry, exact
    cancellations."""
    ids, vals, seg = [], [], 0
    for _ in range(runs):
        r = rng.random()
        if r < 0.08 and seg:  # zeros of an earlier id, in a run of their own
            length, s, live = int(rng.integers(1, 400)), int(rng.integers(0, seg)), False
        else:
            length = int(rng.geometric(0.3)) if r < 0.9 else int(rng.integers(100, 600)) \
                if r < 0.99 else int(rng.integers(1000, 9000))
            s, live = seg, rng.random() > 0.05  # some segments hold zeros only
            seg += int(rng.integers(1, 4))
        v = rng.normal(size=length) * 10.0 ** rng.integers(-3, 4, length)
        v[rng.random(length) < 0.15] = 0.0
        v[rng.random(length) < 0.05] = -0.0
        if length > 3 and rng.random() < 0.1:
            v[-2:] = [v[0], -v[0]]  # a sum that cancels
        ids += [s] * length
        vals += list(v if live else np.where(rng.random(length) < 0.5, 0.0, -0.0))
    return np.asarray(vals, np.float32), np.asarray(ids, np.int32), seg + 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_presorted_route_on_the_card_equals_the_cpu(dev, seed):
    """The presorted route (no sort) on grouped ids: the kernel's sums
    equal the CPU's ``index_add_`` bit for bit, run to run, at lengths
    that leave a ragged tile, and from offsets (views the wrapper copies
    to 16-byte alignment)."""
    rng = np.random.default_rng(seed)
    data, ids, n = _grouped_case(rng, 20_000)
    for lo in (0, 1, 3):
        d, i = torch.from_numpy(data[lo:]), torch.from_numpy(ids[lo:])
        want = tseg.segment_sum(d, i, n)
        got = tseg.segment_sum(d.to(dev), i.to(dev), n, presorted=True)
        again = tseg.segment_sum(d.to(dev), i.to(dev), n, presorted=True)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got.cpu()), _bits(want)), lo
        assert torch.equal(_bits(again), _bits(got)), lo
        sorted_route = tseg.segment_sum(d.to(dev), i.to(dev), n)
        assert torch.equal(_bits(sorted_route.cpu()), _bits(want)), lo


@pytest.mark.parametrize("m", [1, 3, 4, 127, 128, 129, 255, 256, 257, 1000, 4096, 100_003])
def test_segment_sum_at_small_and_ragged_lengths(dev, m):
    """One segment of m entries, and m segments of one: the kernel's ends
    of tiles, chunks and data."""
    rng = np.random.default_rng(m)
    data = rng.normal(size=m).astype(np.float32)
    for ids, n in ((np.zeros(m, np.int32), 1), (np.arange(m, dtype=np.int32), m)):
        want = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n)
        for presorted in (False, True):
            got = tseg.segment_sum(torch.from_numpy(data).to(dev), torch.from_numpy(ids).to(dev), n,
                                   presorted=presorted)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got.cpu()), _bits(want)), (n, presorted)


def test_add_latency_probe(dev):
    lat = segment_bytes.add_latency(1 << 16)
    print(f"# dependent f32 add: {lat}")
    assert 1.0 <= lat["cycles_per_add"] <= 64 and 0.3 <= lat["ns_per_add"] <= 64


def _timer_without_spin(fn, reps=timing.REPS):
    """The timer before the spin: flush, start event, fn, end event."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        timing.flush_l2()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def test_timer_keeps_a_host_delay_out(dev):
    """A short kernel (the fused quantize at P 2^22) timed plainly and with
    a 300 us host sleep before each launch, shorter than the spin (the
    spin is sized from the host's time of the call, sleep included): the
    shared timer's two readings agree within the plain readings' spread;
    the timer without the spin reads the delay."""
    x = torch.randn(1 << 22, device=dev)
    delay_s = 300e-6

    def fn():
        tq.quantize(x, 5, 1)

    def delayed():
        time.sleep(delay_s)
        fn()

    plain = timing.times_ms(fn)
    with_spin = timing.times_ms(delayed)
    no_spin = _timer_without_spin(delayed)
    med = [float(np.median(t)) for t in (plain, with_spin, no_spin)]
    print(f"# timer probe, {delay_s * 1e6:.0f} us host delay: plain median {med[0]:.4f} ms "
          f"(spread {min(plain):.4f}-{max(plain):.4f}), delayed {med[1]:.4f} ms, delayed without "
          f"the spin {med[2]:.4f} ms")
    assert min(plain) <= med[1] <= max(plain)
    assert med[2] > max(plain) + 0.1


@pytest.mark.parametrize("update", ["sparse", "dense"])
def test_headline_steps_are_bit_identical_run_to_run(dev, update):
    """Two workers on the card, the same two headline minibatches: the
    same state bits (the segment sums add in a fixed order)."""
    from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDWorker
    from parameter_server_tpu_torch.benchmarks.headline import conf, make_batch

    batches = [make_batch(i) for i in range(2)]
    states = []
    for _ in range(2):
        w = AsyncSGDWorker(conf(update, "float32", 2), device=dev)
        if update == "sparse":
            w.submit_superbatch(batches, with_aux=False)
        else:
            for b in batches:
                w.process_minibatch(b, with_aux=False)
        torch.cuda.synchronize()
        states.append({k: v.clone() for k, v in w.state.items()})
    for k in states[0]:
        assert torch.equal(_bits(states[0][k]), _bits(states[1][k])), k


@pytest.mark.parametrize("dtype,seed", [(torch.float32, None), (torch.bfloat16, 7)])
def test_sparse_kernel_under_an_interior_keep_mask(dev, dtype, seed):
    """The KKT filter's ``ok & keep``: holes anywhere in the unique
    vector, not only a sentinel tail. A suppressed slot's z and √n stay
    bit-untouched, bf16 dither of its neighbours included, and every
    slot's result equals the plain version's."""
    rng = np.random.default_rng(11)
    p, u = 1 << 16, 20_000
    rel = torch.tensor(np.sort(rng.choice(p, u, replace=False)), dtype=torch.int32, device=dev)
    ok = torch.ones(u, dtype=torch.bool, device=dev)
    ok[-500:] = False  # the sentinel tail
    keep = torch.tensor(rng.random(u) < 0.6, device=dev)
    g = torch.tensor(rng.normal(size=u), dtype=torch.float32, device=dev)
    g = torch.where(keep, g, 0.0)
    z = torch.tensor(rng.normal(size=p), dtype=torch.float32, device=dev)
    n = torch.tensor(rng.random(p) * 2, dtype=torch.float32, device=dev).to(dtype)
    zk, nk, zr, nr = z.clone(), n.clone(), z.clone(), n.clone()
    tsparse.ftrl_sparse_update(zk, nk, rel, ok & keep, g, **KW, seed=seed)
    tsparse.ftrl_sparse_rows_ref(zr, nr, rel, ok & keep, g, **KW, seed=seed)
    _assert_bit_equal((zk, nk), (zr, nr))
    held = rel[~keep].long()
    assert torch.equal(_bits(zk[held]), _bits(z[held])) and torch.equal(_bits(nk[held]), _bits(n[held]))
    moved = rel[keep & ok].long()
    assert float((zk[moved] != z[moved]).float().mean()) > 0.9


def test_ell_scatter_card_equals_cpu(dev):
    """The ELL wires' gradient scatter (a stable sort by slot, then
    ``segment_sum.cu`` adding each slot's entries in entry order) and
    their Xw by row: bit-equal to the CPU's ``index_add_`` and run to run,
    with hot slots and padding rows' zero gradients."""
    rng = np.random.default_rng(5)
    rows, lanes, shard = 16384, 39, 1 << 22
    slots = rng.integers(0, shard, (rows, lanes)).astype(np.int32)
    slots[:, :13] = rng.integers(0, 90, (rows, 13))  # small-vocabulary lanes
    gr = rng.normal(size=rows).astype(np.float32)
    gr[-300:] = 0.0  # padding rows
    g_e = np.repeat(gr, lanes)
    w_e = rng.normal(size=rows * lanes).astype(np.float32)
    row_ids = np.repeat(np.arange(rows, dtype=np.int32), lanes)
    outs = []
    for d in ("cuda", "cuda", "cpu"):
        t = lambda a: torch.from_numpy(a).to(d)  # noqa: E731
        outs.append((tseg.segment_sum(t(g_e), t(slots.reshape(-1)), shard).cpu(),
                     tseg.segment_sum(t(w_e), t(row_ids), rows, presorted=True).cpu()))
    for a, b in ((outs[0], outs[1]), (outs[0], outs[2])):
        for x, y in zip(a, b):
            assert torch.equal(_bits(x), _bits(y))


def test_darlin_card_vs_cpu_and_run_to_run(dev):
    """The darlin app on the card: two runs bit-identical (w, the dual),
    every block step's three segment sums launched as the kernel, and the
    CPU run's per-pass objective within 1e-5 relative (the card's ``exp``
    is not the CPU's), nnz(w) and the active set within 1% of the
    columns, w within 1e-4 relative + 1e-5."""
    from parameter_server_tpu_torch.apps.linear import config as tcfg
    from parameter_server_tpu_torch.apps.linear.darlin import DarlinScheduler
    from parameter_server_tpu_torch.utils.sparse import random_sparse

    rng = np.random.default_rng(0)
    w_true = (rng.normal(size=3000) * (rng.random(3000) < 0.1) * 2).astype(np.float32)
    data = random_sparse(30_000, 3000, 20, seed=1, w_true=w_true)

    def run(device):
        c = tcfg.Config()
        c.penalty = tcfg.PenaltyConfig(type="l1", lambda_=[2.0])
        c.learning_rate = tcfg.LearningRateConfig(alpha=1.0)
        c.darlin = tcfg.BCDConfig(num_data_pass=8, feature_block_ratio=4.0, max_block_delay=2)
        s = DarlinScheduler(c, device=device)
        before = tseg.segment_sum.launches
        s.run_on(data)
        return s, tseg.segment_sum.launches - before

    (a, la), (b, lb), (cpu, lc) = run(dev), run(dev), run("cpu")
    steps = len(a.fea_blk) * len(a.g_progress)
    assert la == lb == 3 * steps and lc == 0
    assert torch.equal(_bits(a.solver.dual), _bits(b.solver.dual))
    assert np.array_equal(a.solver.w.view(np.int32), b.solver.w.view(np.int32))
    assert a.max_dispatch_window >= 2
    assert sorted(a.g_progress) == sorted(cpu.g_progress)
    for i in a.g_progress:
        x, y = a.g_progress[i], cpu.g_progress[i]
        np.testing.assert_allclose(x.objective, y.objective, rtol=1e-5)
        assert abs(x.nnz_w - y.nnz_w) <= 30 and abs(x.nnz_active_set - y.nnz_active_set) <= 30
    np.testing.assert_allclose(a.solver.w, cpu.solver.w, rtol=1e-4, atol=1e-5)


def _kv_run(device, seed=0, num_slots=1 << 10, rounds=4):
    """A KVVector on ``device`` fed pushes whose keys collide: 4096 keys
    a push into 1024 slots (about four entries a slot), and a push_pull."""
    from parameter_server_tpu_torch.parameter.kv_vector import KVVector

    kv = KVVector(k=2, num_slots=num_slots, hashed=True, name=f"kv_{device}", device=device)
    rng = np.random.default_rng(seed)
    pulled = None
    for r in range(rounds):
        keys = rng.integers(0, 1 << 30, 4096)
        vals = (rng.normal(size=(4096, 2)) * np.exp(rng.normal(size=(4096, 1)) * 3)).astype(
            np.float32)
        if r == rounds - 1:
            pulled = kv.wait_pull(kv.push_pull(kv.request(channel=0), keys=keys, values=vals))
        else:
            kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
    table = kv.table(0, copy=True).cpu()
    kv.executor.stop()
    return table, pulled.cpu()


def test_kv_push_with_collisions_card_equals_cpu_and_run_to_run(dev):
    """The push adds colliding entries in entry order on the card
    (``segment_sum`` with each slot's value first), so the table's bits
    equal the CPU's ``index_add_``, and two card runs are identical."""
    before = tseg.segment_sum.launches
    card, card_pulled = _kv_run(dev)
    assert tseg.segment_sum.launches - before == 4  # one a push
    again, again_pulled = _kv_run(dev)
    cpu, cpu_pulled = _kv_run("cpu")
    assert torch.equal(_bits(card), _bits(again)) and torch.equal(_bits(card_pulled),
                                                                   _bits(again_pulled))
    assert torch.equal(_bits(card), _bits(cpu)) and torch.equal(_bits(card_pulled),
                                                                 _bits(cpu_pulled))


def test_device_replica_gather_equals_host_replica(dev):
    from parameter_server_tpu_torch.parameter.kv_vector import KVVector
    from parameter_server_tpu_torch.serving import ReadReplica

    kv = KVVector(k=1, num_slots=1 << 12, hashed=True, name="rep", device=dev)
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(0, 1 << 20, 2048))
    kv.wait(kv.push(kv.request(channel=0), keys=keys,
                    values=rng.normal(size=(len(keys), 1)).astype(np.float32)))
    host, card = ReadReplica(kv), ReadReplica(kv, device=True)
    assert isinstance(card._table, torch.Tensor) and card._table.is_cuda
    for n in (1, 3, 32, 100, 2048):
        vh, _ = host.pull(keys[:n])
        vd, hit = card.pull(keys[:n])
        assert hit.all() and np.array_equal(vh.view(np.uint32), vd.view(np.uint32))
    hot = keys[:64]
    hh, hd = ReadReplica(kv, hot_keys=hot), ReadReplica(kv, hot_keys=hot, device=True)
    mixed = np.concatenate([hot[:5], keys[-7:]])
    (vh, mh), (vd, md) = hh.pull(mixed), hd.pull(mixed)
    assert np.array_equal(mh, md) and np.array_equal(vh, vd)
    kv.executor.stop()


def test_batcher_tokens_equal_solo_runs_on_the_card(dev):
    from parameter_server_tpu_torch.models.speculative import speculative_generate
    from parameter_server_tpu_torch.models.transformer import LMConfig, init_lm
    from parameter_server_tpu_torch.serving import (BatcherConfig, ContinuousBatcher,
                                                    DecodeRequest)

    tcfg = LMConfig(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128)  # heads of 16
    dcfg = LMConfig(vocab=256, d_model=32, n_heads=2, n_layers=1, d_ff=64)
    tp, dp = init_lm(0, tcfg, dev), init_lm(1, dcfg, dev)
    rng = np.random.default_rng(2)
    reqs = [DecodeRequest(prompt=rng.integers(0, 256, (1, 3 + i % 5)), steps=8 + 5 * (i % 3))
            for i in range(10)]
    b = ContinuousBatcher(tp, tcfg, dp, dcfg, BatcherConfig(slots=4, max_prompt=8, max_new=20,
                                                            gamma=2))
    before = tfa.flash_attention.launches
    with torch.no_grad():
        b.warmup()
        handles, pending = [], list(reqs)
        while pending or b.active_sessions():
            wave = []
            while pending and len(wave) < b.free_slots():
                wave.append((pending.pop(0), None))
            if wave:
                handles += b.admit_many(wave)
            b.step_block()
        assert tfa.flash_attention.launches > before  # the joins prefill through flash_fwd
        for h in handles:
            solo = speculative_generate(tp, tcfg, dp, dcfg, h.req.prompt, h.req.steps, gamma=2)
            assert np.array_equal(h.out, solo.cpu().numpy())
