"""PyTorch port: each CUDA kernel against its plain PyTorch version, on
the card.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels have
no CPU mode): they carry the ``cuda`` marker and skip elsewhere. On a
machine with a card: ``python -m pytest tests/test_torch_kernels_cuda.py -q``.

Tolerance: bit equality. The kernels are built with ``--fmad=false``, so
every operation rounds once, as each eager PyTorch op does; the bf16
dither is indexed by flat position (dense) or u-position (sparse) in
both versions, and the quantization noise by flat position.
"""

import numpy as np
import pytest
import torch

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
