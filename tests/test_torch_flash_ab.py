"""PyTorch port: the arithmetic of ``benchmarks/flash_ab.py``, without a
card.

The script prints each flash kernel's time beside its bound and says
whether two builds' outputs are bit-identical; these tests check the
bound for both dtypes (bf16: its FLOP at the bf16 tensor-core rate or its
bytes; float32: its FLOP in 3xTF32, its bytes or its MUFU floor) and that
the bit comparison tells signed zeros and NaN payloads apart, which a
float comparison does not.
"""

import pytest
import torch

from parameter_server_tpu_torch.benchmarks import flash_ab

FLOP, BYTES = 3.438e10, 134_742_016  # B·H 64 x S 2048 x D 64, causal


def test_bf16_bound_is_its_flop_or_its_bytes():
    half = BYTES // 2  # the same tensors in bf16
    assert flash_ab.bound_ms(FLOP, half) == pytest.approx(FLOP / 989e12 * 1e3)
    assert flash_ab.bound_ms(FLOP, BYTES) == pytest.approx(BYTES / 3.35e12 * 1e3)
    # the MUFU floor is printed beside the bf16 bound, not folded into it
    assert flash_ab.bound_ms(FLOP, half, "bfloat16", mufu_ms=5.0) == pytest.approx(FLOP / 989e12 * 1e3)


def test_float32_bound_is_three_tf32_passes_the_bytes_or_the_exponentials():
    three_passes = FLOP / (495e12 / 3) * 1e3
    assert three_passes == pytest.approx(0.2084, abs=1e-4)
    assert flash_ab.bound_ms(FLOP, BYTES, "float32") == pytest.approx(three_passes)
    assert flash_ab.bound_ms(FLOP, BYTES, "float32", mufu_ms=0.5) == 0.5
    assert flash_ab.bound_ms(1.0, BYTES, "float32") == pytest.approx(BYTES / 3.35e12 * 1e3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bit_identical_compares_bits(dtype):
    a = torch.tensor([0.0, 1.5, -2.0], dtype=dtype)
    assert flash_ab.bit_identical([a, a + 1], [a.clone(), a + 1])
    assert not flash_ab.bit_identical([a], [torch.tensor([-0.0, 1.5, -2.0], dtype=dtype)])
    assert not flash_ab.bit_identical([a], [a.clone().fill_(1.5)])


def test_float32_shapes_are_the_main_paths():
    shapes = {name: (bh, s, d, group) for name, bh, s, d, group in flash_ab.FWD_SHAPES["float32"]}
    assert shapes["prefill"] == (64, 2048, 64, 1)
    assert shapes["batcher_join"] == (128, 8, 64, 1)  # phase D's widest wave
    assert shapes["decode_lane_prefill"] == (16, 64, 16, 1)  # the serve CLI's decode pair
    bwd = {name: (bh, s, d) for name, bh, s, d in flash_ab.BWD_SHAPES["float32"]}
    assert bwd["S2048"] == (64, 2048, 64)
    assert bwd["S8192"] == (32, 8192, 64)  # the LM's full width
    assert bwd["cli_default"] == (32, 256, 16)  # the LM CLI's default: batch 8 x 4 heads of 16
    assert bwd["D128"] == (64, 2048, 128)
    assert flash_ab.turn_order([]) == ("other", "this", "this", "other")


def test_unknown_shape_is_refused_before_any_build(capsys):
    with pytest.raises(SystemExit) as exc:
        flash_ab.main(["--kernel", "bwd", "--dtype", "float32", "--other", "unused",
                       "--shape", "S2048", "--shape", "S4096"])
    assert exc.value.code == 2
    assert "S4096" in capsys.readouterr().err
