"""PyTorch port: the byte and sector counts of the two FTRL updates
(``parameter_server_tpu_torch/benchmarks/ftrl_bytes.py``), exact, on
small hand-made inputs."""

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch.benchmarks import ftrl_bytes as fb

P = 64


def _keep(*members, p=P):
    keep = torch.zeros(p, dtype=torch.bool)
    keep[list(members)] = True
    return keep


@pytest.mark.parametrize("masked,stream", [(True, P), (False, 4 * P)])
def test_no_member_costs_the_stream_only(masked, stream):
    got = fb.dense_counts(_keep(), 4, masked)
    assert got == dict(members=0, bytes=stream, sector_bytes=stream)


@pytest.mark.parametrize("slot", [0, 5, 63])
def test_one_member_adds_one_sector_of_g_z_and_n(slot):
    got = fb.dense_counts(_keep(slot), 4, masked=True)
    assert got["members"] == 1
    assert got["bytes"] == P + 4 + 8 + 2 * 4
    assert got["sector_bytes"] == P + 32 + 2 * 32 + 2 * 32


def test_one_member_without_a_mask_reads_no_g_sector():
    got = fb.dense_counts(_keep(5), 4, masked=False)
    assert got["bytes"] == 4 * P + 8 + 8
    assert got["sector_bytes"] == 4 * P + 2 * 32 + 2 * 32


@pytest.mark.parametrize("members,n_sectors", [((8, 9), 1), ((8, 15), 1), ((7, 8), 2)])
def test_members_in_one_sector_share_it(members, n_sectors):
    got = fb.dense_counts(_keep(*members), 4, masked=True)
    assert got["bytes"] == P + 2 * (4 + 8 + 8)
    # g, z and n are all 4-byte: 8 slots a sector each
    assert got["sector_bytes"] == P + n_sectors * (32 + 64 + 64)


def test_bf16_n_holds_16_slots_a_sector():
    got = fb.dense_counts(_keep(0, 15), 2, masked=True)
    assert got["bytes"] == P + 2 * (4 + 8 + 4)
    # g and z: slots 0 and 15 in two sectors; bf16 n: one
    assert got["sector_bytes"] == P + 2 * 32 + 2 * 64 + 64
    got = fb.dense_counts(_keep(0, 16), 2, masked=False)
    assert got["sector_bytes"] == 4 * P + 2 * 64 + 2 * 64


def _sparse(rel, ok, g):
    return (torch.tensor(rel, dtype=torch.int32), torch.tensor(ok, dtype=torch.bool),
            torch.tensor(g, dtype=torch.float32))


@pytest.mark.parametrize("n_size", [4, 2])
def test_sparse_sorted_and_shuffled_rel_count_the_same(n_size):
    rng = np.random.default_rng(3)
    rel = np.sort(rng.choice(1 << 12, 40, replace=False)).astype(np.int32)
    g = rng.normal(size=40).astype(np.float32)
    ok = np.ones(40, bool)
    perm = rng.permutation(40)
    a = fb.sparse_counts(*_sparse(rel, ok, g), n_size)
    b = fb.sparse_counts(*_sparse(rel[perm], ok[perm], g[perm]), n_size)
    assert a == b
    assert a["members"] == 40
    assert a["bytes"] == 40 * (1 + 4) + 40 * (4 + 8 + 2 * n_size)


def test_sparse_sector_count_is_exact():
    # slots 0, 1 share every sector; 8 is a new z sector, the same bf16 one;
    # g_u and rel: positions 0-2 in one sector each
    rel, ok, g = _sparse([0, 1, 8], [True, True, True], [1.0, 2.0, 3.0])
    assert fb.sparse_counts(rel, ok, g, 4)["sector_bytes"] == 3 + 2 * 32 + 64 * (2 + 2)
    assert fb.sparse_counts(rel, ok, g, 2)["sector_bytes"] == 3 + 2 * 32 + 64 * (2 + 1)


def test_sparse_sentinel_tail_and_zero_gradient_touch_no_table_bytes():
    # the tail: ok False entries clipped onto a real slot, with a gradient;
    # position 0 is ok with a zero gradient: its g_u is read, its rel not
    rel, ok, g = _sparse([3, 63, 63, 63], [True, False, False, False], [0.0, 1.0, 2.0, 3.0])
    got = fb.sparse_counts(rel, ok, g, 4)
    assert got == dict(members=0, bytes=4 + 4, sector_bytes=4 + 32)


@pytest.mark.parametrize("n_size", [4, 2])
def test_sparse_sentinel_tail_costs_its_ok_byte_only(n_size):
    # a headline-like batch: 40 real positions on slots 8 apart (one sector
    # of z each), then a tail of 24 sentinels whose g_u is not even zero
    u, real = 64, 40
    rel = np.r_[np.arange(real) * 8, np.full(u - real, 511)].astype(np.int32)
    ok = np.arange(u) < real
    g = np.ones(u, np.float32)
    got = fb.sparse_counts(*_sparse(rel, ok, g), n_size)
    assert got["members"] == real
    assert got["bytes"] == u + 4 * real + real * (4 + 8 + 2 * n_size)
    # g_u and rel: 40 positions in 5 sectors each; z: 40 sectors; n: 40
    # (f32) or 20 (bf16, 16 slots a sector)
    n_sectors = real if n_size == 4 else real // 2
    assert got["sector_bytes"] == u + 2 * 5 * 32 + 2 * 32 * (real + n_sectors)
    # the tail alone adds only its ok bytes
    head = fb.sparse_counts(*_sparse(rel[:real], ok[:real], g[:real]), n_size)
    assert got["bytes"] - head["bytes"] == u - real
    assert got["sector_bytes"] - head["sector_bytes"] == u - real


def test_64_byte_granules_hold_16_f32_slots():
    # slots 0 and 15: two 32-byte sectors of g, z and n each, one granule
    got = fb.dense_counts(_keep(0, 15), 4, masked=True, granule=64)
    assert got["bytes"] == P + 2 * (4 + 8 + 8)
    assert got["sector_bytes"] == P + 64 + 2 * 64 + 2 * 64
    rel, ok, g = _sparse([0, 16], [True, True], [1.0, 1.0])
    assert fb.sparse_counts(rel, ok, g, 2, granule=64)["sector_bytes"] == 2 + 2 * 64 + 2 * 64 * (2 + 1)


def test_ms_is_bytes_over_the_memory_rate():
    assert fb.ms(3.35e9) == pytest.approx(1.0)
