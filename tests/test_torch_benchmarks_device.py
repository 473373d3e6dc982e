"""PyTorch port: the component suite's device benchmarks
(``benchmarks/components.py``: ``attention``, ``ftrl_sparse_ab``,
``ftrl_chain``, ``roofline``, and the unregistered
``flash_cost_crosscheck``) at smoke on the CPU beside the JAX package's.
On the CPU the ``cuda`` arms take their kernels' plain versions (the
wrappers do so for CPU tensors) and the arms that exist only on the card
are absent, as the JAX benchmarks' Pallas arms are off a TPU. No speed
ratio or wall time is asserted.
"""

import pytest
import torch

from parameter_server_tpu.benchmarks import components as jcomp
from parameter_server_tpu_torch.benchmarks import components as tcomp
from parameter_server_tpu_torch.benchmarks import ftrl_bytes
from tests.test_torch_benchmarks_cli import RECORD_FIELDS, check_against_jax, run_port

torch.set_num_threads(1)

BENCHMARKS = ["attention", "ftrl_sparse_ab", "ftrl_chain", "roofline"]


@pytest.mark.parametrize("name", BENCHMARKS)
def test_benchmark_lines_map_onto_the_jax_lines(name, tmp_path_factory):
    rec, _ = check_against_jax(name, tmp_path_factory.mktemp(name))
    assert rec["metrics"]


@pytest.mark.parametrize("p,u,seed", [(1 << 18, 1 << 11, 0), (1 << 12, 1 << 11, 3),
                                      (1 << 22, 1 << 16, 0)])
def test_sparse_touch_pattern_bit_equal_to_jax(p, u, seed):
    want = jcomp._sparse_touch_pattern(p, u, seed)
    got = tcomp._sparse_touch_pattern(p, u, seed)
    for w, g in zip(want[:3], got[:3]):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
    assert want[3] == got[3]


def test_ftrl_sparse_record_maps_onto_the_jax_record(tmp_path_factory):
    """The record's fields: the JAX record's, renamed or dropped as
    ``RECORD_FIELDS`` says; the arms made the same calls and left the
    same bits; the bytes are ``ftrl_bytes.sparse_counts`` of the inputs;
    no share of a peak on the CPU."""
    rec, _ = run_port("ftrl_sparse_ab", tmp_path_factory.mktemp("fs"))
    want = jcomp.ftrl_sparse_ab(smoke=True)
    fields = RECORD_FIELDS["ftrl_sparse_ab"]
    for k in want:
        mapped = fields.get(k, k)
        if mapped is not None:
            assert mapped in rec, k
    for k in ("num_slots", "uniq_pad", "live_slots", "reps", "calls_per_rep",
              "fused_is_fallback", "hbm_peak_gb_s", "frac_of_peak"):
        assert rec[k] == want[k], k
    assert rec["fused_is_fallback"] is True and rec["frac_of_peak"] is None
    assert rec["cuda_bit_equal_plain"] and rec["cuda_calls"] == rec["plain_calls"] == 1 + 3 * 2
    rel, ok, g, _ = tcomp._sparse_touch_pattern(1 << 18, 1 << 11)
    counts = ftrl_bytes.sparse_counts(torch.from_numpy(rel), torch.from_numpy(ok),
                                      torch.from_numpy(g), 4)
    assert rec["bytes_model"]["bytes"] == counts["bytes"]
    assert rec["bytes_model"]["sector_bytes"] == counts["sector_bytes"]
    assert rec["bytes_model"]["live"] == counts["members"] == want["live_slots"]


def test_ftrl_chain_counts_the_cards_bytes(tmp_path_factory):
    rec, _ = run_port("ftrl_chain", tmp_path_factory.mktemp("fc"))
    (tag, size), = rec["sizes"].items()
    assert tag == "2e14" and "cuda_ms" not in size  # no kernel arm off the card
    g = torch.randn(1 << 14)
    assert tcomp._ftrl_chain_bytes(g, 8) == 8 * 20 * (1 << 14)
    assert size["bytes_a_call"] == 8 * 20 * (1 << 14)


def test_flash_cost_crosscheck_reconciles_the_hand_model():
    """The hand 4·bh·s²·d against FlopCounterMode's count over the plain
    version: within 2x (as the JAX test holds XLA's count), and a CPU
    reports no MFU."""
    out = tcomp.flash_cost_crosscheck(smoke=True, device="cpu")
    want = jcomp.flash_cost_crosscheck(smoke=True)
    assert out["hand_flops"] == want["hand_flops"] > 0
    assert 0.5 < out["hand_over_counted_ratio"] < 2.0
    assert out["mfu_hand"] is None and want["mfu_hand"] is None
    for k, mapped in RECORD_FIELDS["flash_cost_crosscheck"].items():
        if k in want and mapped is not None:
            assert mapped in out, k
    assert out["shape_bh_s_d"] == want["shape_bh_s_d"]


def test_flash_flops_count_the_two_matmuls():
    assert tcomp._flash_flops(2, 64, 16, "cpu") == 4.0 * 2 * 64 * 64 * 16


def test_roofline_probes_declare_their_work(tmp_path_factory):
    rec, _ = run_port("roofline", tmp_path_factory.mktemp("rl"))
    fns = rec["functions"]
    assert set(fns) == {"roofline_ftrl_chain", "roofline_flash_fwd"}
    for f in fns.values():
        assert f["compiles"] == 1 and f["recompiles"] == 0
        assert "frac_of_hbm_peak" not in f["roofline"] and "mfu" not in f["roofline"]
    assert fns["roofline_ftrl_chain"]["cost"] == {"bytes_accessed": 8 * 20 * (1 << 14)}
    assert fns["roofline_flash_fwd"]["cost"]["flops"] == 4.0 * 4 * 256 * 256 * 64
    assert rec["calls"] == {"ftrl": 3, "flash": 3}


def test_attention_has_no_kernel_arm_off_the_card(tmp_path_factory):
    rec, _ = run_port("attention", tmp_path_factory.mktemp("at"))
    assert rec["cuda_forwards"] == 0 and rec["_first_forward"] == {}
    assert rec["shape_bh_s_d"] == [4, 512, 64] and rec["chain"] == 2
