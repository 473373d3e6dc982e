"""PyTorch port: the deterministic segment sum of the linear step
(``ops/segment_sum.py``) on the CPU, where it is ``index_add_`` on the
entries as they come, and the card's route (stable sort by segment, zeros
past the last segment, then the kernel's plain version) run on the CPU.

Inputs are made with numpy from fixed seeds. What each check holds, and
why:

- the card's route against ``torch.zeros(n).index_add_(0, ids, data)``,
  the sum the linear step takes on the CPU: bit for bit. Both add each
  segment's entries in index order from +0.0 (the stable sort keeps that
  order; the zeros it leaves out change no sum);
- against ``np.add.at`` in float32 (unbuffered, in index order): bit for
  bit, for the same reason;
- against ``jax.ops.segment_sum`` (the JAX package's call), which may add
  in another order: each segment within the bound of two recursive
  float32 sums of its ``m`` entries in any order, ``2 (m - 1) 2^-24
  sum |x|``.

The presorted route (ids already grouped, no sort on the card) has its
own plain version, ``segment_sum_runs_ref``: bit-equal to ``index_add_``
on every input that meets its contract (each segment's nonzero entries in
one run of equal ids), and the contract holds on the ids the linear step
hands it, from batches of both prep functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu_torch.apps.linear.async_sgd import prep_batch_hashed, prep_batch_shared
from parameter_server_tpu_torch.ops import segment_sum as ss
from parameter_server_tpu_torch.ops.kv_ops import localize
from parameter_server_tpu_torch.parameter.parameter import KeyDirectory
from parameter_server_tpu_torch.utils.sparse import random_sparse

U = 2.0 ** -24  # float32 unit roundoff


def _case(kind: str, seed: int):
    """``(data float32 [m], ids int32 [m], num_segments)``."""
    rng = np.random.default_rng(seed)
    if kind == "sorted_with_pads":  # Xw by row: rows non-decreasing, pads (row 0, value 0) last
        n, live, pad = 64, 900, 300
        ids = np.sort(rng.integers(0, n, live)).astype(np.int32)
        data = rng.normal(size=live).astype(np.float32)
        ids = np.concatenate([ids, np.zeros(pad, np.int32)])
        data = np.concatenate([data, np.zeros(pad, np.float32)])
        return data, ids, n
    if kind == "unsorted_duplicates":  # the gradient by slot: ids in any order, repeated
        n, m = 50, 2000
        return rng.normal(size=m).astype(np.float32), rng.integers(0, n, m).astype(np.int32), n
    if kind == "empty_segments":  # most segments get nothing
        n, m = 4096, 300
        ids = rng.choice(np.arange(0, n, 7), m).astype(np.int32)
        return rng.normal(size=m).astype(np.float32), ids, n
    if kind == "all_pads":
        m = 512
        return np.zeros(m, np.float32), np.zeros(m, np.int32), 16
    if kind == "mixed_sign_magnitude":  # the order of the adds shows in the bits
        n, m = 8, 4000
        mag = 10.0 ** rng.integers(-38, 38, m)
        data = (rng.choice([-1.0, 1.0], m) * rng.random(m) * mag).astype(np.float32)
        data[rng.random(m) < 0.1] = -0.0
        data[rng.random(m) < 0.05] = np.float32(1.4e-45) * rng.integers(1, 100)  # subnormals
        return data, rng.integers(0, n, m).astype(np.int32), n
    if kind == "exact_cancellation":  # sums that reach zero: +0.0, never -0.0
        n = 6
        ids = np.repeat(np.arange(n, dtype=np.int32), 4)
        data = np.array([1, -1, -0.0, -0.0, -0.0, -0.0, -0.0, 0.0, -2, 2, 0, 0,
                         3, -3, -0.0, -0.0, -0.0, -0.0, -0.0, -0.0, 0.0, -0.0, 0.0, -0.0],
                        np.float32)
        perm = rng.permutation(ids.size)
        return data[perm], ids[perm], n
    if kind == "one_long_segment":  # a frequent key: thousands of entries in one segment
        n, m = 32, 5000
        ids = np.where(rng.random(m) < 0.8, 3, rng.integers(0, n, m)).astype(np.int32)
        return rng.normal(size=m).astype(np.float32), ids, n
    raise ValueError(kind)


CASES = ["sorted_with_pads", "unsorted_duplicates", "empty_segments", "all_pads",
         "mixed_sign_magnitude", "exact_cancellation", "one_long_segment"]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", CASES)
def test_equals_index_add_bit_for_bit(kind, seed):
    data, ids, n = _case(kind, seed)
    got = ss.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n)
    want = torch.zeros(n).index_add_(0, torch.from_numpy(ids).long(), torch.from_numpy(data))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", CASES)
def test_card_route_equals_index_add_bit_for_bit(kind, seed):
    data, ids, n = _case(kind, seed)
    vals, sids = ss.sort_by_segment(torch.from_numpy(data), torch.from_numpy(ids), n)
    assert sids.dtype == torch.int32 and bool((sids[1:] >= sids[:-1]).all())
    got = ss.segment_sum_sorted_ref(vals, sids, n)
    want = torch.zeros(n).index_add_(0, torch.from_numpy(ids).long(), torch.from_numpy(data))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", CASES)
def test_equals_sequential_numpy_sum(kind, seed):
    data, ids, n = _case(kind, seed)
    want = np.zeros(n, np.float32)
    np.add.at(want, ids, data)
    got = ss.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", CASES)
def test_within_float32_reordering_of_jax_segment_sum(kind, seed):
    data, ids, n = _case(kind, seed)
    got = ss.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=n))
    count = np.bincount(ids, minlength=n)
    abs_sum = np.zeros(n, np.float64)
    np.add.at(abs_sum, ids, np.abs(data.astype(np.float64)))
    bound = 2 * np.maximum(count - 1, 0) * U * abs_sum
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(diff <= bound), (diff - bound).max()


def test_a_sum_that_cancels_is_positive_zero():
    data, ids, n = _case("exact_cancellation", 0)
    got = ss.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n).numpy()
    assert np.all(got == 0) and not np.any(np.signbit(got))


def test_sorted_plain_version_drops_the_zero_bucket():
    data = torch.tensor([1.0, 2.0, 4.0, 8.0, 0.0, 0.0])
    ids = torch.tensor([0, 0, 2, 2, 3, 3], dtype=torch.int32)  # 3 = num_segments: the zeros
    got = ss.segment_sum_sorted_ref(data, ids, 3)
    assert got.tolist() == [3.0, 0.0, 12.0]


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_takes_int32_and_int64_ids(ids_dtype):
    data, ids, n = _case("unsorted_duplicates", 4)
    got = ss.segment_sum(torch.from_numpy(data), torch.from_numpy(ids).to(ids_dtype), n)
    want = torch.zeros(n).index_add_(0, torch.from_numpy(ids).long(), torch.from_numpy(data))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("args", [
    (torch.zeros(4), torch.zeros(3, dtype=torch.int32), 2),       # lengths differ
    (torch.zeros(2, 2), torch.zeros(2, 2, dtype=torch.int32), 2),  # not 1-D
    (torch.zeros(4), torch.zeros(4, dtype=torch.int32), 1 << 31),  # ids past int32
])
def test_rejects_what_it_does_not_take(args):
    with pytest.raises(ValueError):
        ss.segment_sum(*args)


def test_cuda_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU only the plain version runs: the kernel's wrapper takes
    CUDA tensors or raises (no quiet fallback)."""
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ss.launch_kernel(torch.zeros(4), torch.zeros(4, dtype=torch.int32), 2)


# -- the presorted route: ids already grouped --


def _grouped(kind: str, seed: int):
    """``(data float32 [m], ids int32 [m], num_segments)`` that meet the
    presorted contract."""
    rng = np.random.default_rng(seed)
    if kind == "csr_rows_padded":  # Xw by row: CSR rows, the padding (row 0, value 0) last
        n, live, pad = 64, 900, 300
        ids = np.concatenate([np.sort(rng.integers(0, n, live)), np.zeros(pad, np.int64)])
        data = np.concatenate([rng.normal(size=live), np.zeros(pad)])
        data[rng.random(data.size) < 0.1] = 0.0  # a zero weight inside a row
        return data.astype(np.float32), ids.astype(np.int32), n
    if kind == "nonzeros_after_zeros_of_another_id":
        # segment 2's only nonzero entries follow a run of zeros of segment
        # 0; segment 1 holds a zero only
        data = np.array([1.0, 2.0, 0.0, -0.0, 0.0, 4.0, 8.0, 0.0, 16.0], np.float32)
        ids = np.array([0, 0, 1, 0, 0, 2, 2, 2, 2], np.int32)
        return data, ids, 3
    if kind == "all_zero_segment":  # segment 1 holds zeros of both signs only
        data = np.array([3.0, -1.0, 0.0, -0.0, -0.0, 5.0, 0.0], np.float32)
        ids = np.array([0, 0, 1, 1, 1, 2, 0], np.int32)
        return data, ids, 3
    if kind == "zeros_before_the_first_nonzero":
        data = np.array([-0.0, 0.0, 7.0, 1.5, 0.0, -2.0, 0.0], np.float32)
        ids = np.array([4, 4, 4, 4, 4, 5, 5], np.int32)
        return data, ids, 6
    if kind == "one_entry_a_slot_padding_at_0":  # the exact dense step's shard gradient
        n, live, pad = 500, 120, 80
        ids = np.concatenate([np.sort(rng.choice(n, live, replace=False)), np.zeros(pad, np.int64)])
        data = np.concatenate([rng.normal(size=live), np.zeros(pad)])
        return data.astype(np.float32), ids.astype(np.int32), n
    raise ValueError(kind)


GROUPED = ["csr_rows_padded", "nonzeros_after_zeros_of_another_id", "all_zero_segment",
           "zeros_before_the_first_nonzero", "one_entry_a_slot_padding_at_0"]


def _meets_contract(data, ids) -> bool:
    """Each segment's nonzero entries lie in one run of equal ids."""
    data, ids = np.asarray(data), np.asarray(ids)
    run = np.cumsum(np.r_[True, ids[1:] != ids[:-1]])
    nz = data != 0
    pairs = np.unique(np.stack([ids[nz], run[nz]]), axis=1)
    return np.unique(pairs[0]).size == pairs.shape[1]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", GROUPED)
def test_runs_plain_version_equals_index_add_bit_for_bit(kind, seed):
    data, ids, n = _grouped(kind, seed)
    assert _meets_contract(data, ids)
    got = ss.segment_sum_runs_ref(torch.from_numpy(data), torch.from_numpy(ids), n)
    want = torch.zeros(n).index_add_(0, torch.from_numpy(ids).long(), torch.from_numpy(data))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    cpu = ss.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n, presorted=True)
    np.testing.assert_array_equal(_bits(cpu.numpy()), _bits(want.numpy()))


def test_runs_plain_version_writes_no_run_of_zeros():
    """Row 0's sum survives the padding's run of zeros at row 0."""
    data = torch.tensor([2.0, 3.0, 1.0, 0.0, -0.0, 0.0])
    ids = torch.tensor([0, 0, 1, 0, 0, 0], dtype=torch.int32)
    assert ss.segment_sum_runs_ref(data, ids, 2).tolist() == [5.0, 1.0]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", GROUPED)
def test_runs_route_within_float32_reordering_of_jax_segment_sum(kind, seed):
    data, ids, n = _grouped(kind, seed)
    got = ss.segment_sum_runs_ref(torch.from_numpy(data), torch.from_numpy(ids), n).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=n))
    count = np.bincount(ids, minlength=n)
    abs_sum = np.zeros(n, np.float64)
    np.add.at(abs_sum, ids, np.abs(data.astype(np.float64)))
    bound = 2 * np.maximum(count - 1, 0) * U * abs_sum
    assert np.all(np.abs(got.astype(np.float64) - want.astype(np.float64)) <= bound)


def test_contract_check_catches_a_split_segment():
    assert not _meets_contract([1.0, 2.0, 3.0], [0, 1, 0])
    assert _meets_contract([1.0, 0.0, 3.0], [0, 1, 1])
    assert _meets_contract([1.0, 2.0, 0.0], [0, 1, 0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prepped_batches_meet_the_presorted_contract(seed):
    """The ids the linear step hands the presorted route, from small
    batches of both prep functions: Xw by row (exact and hashed steps) and
    the exact dense step's shard gradient by slot, its padding moved to
    slot 0. Values are drawn nonzero wherever the step's can be."""
    rng = np.random.default_rng(seed)
    rows_pad, slots = 64, 1 << 10
    batch = random_sparse(50, 4000, 7, seed=seed, binary=bool(seed % 2))
    nnz_pad = 4 * 1024
    directory = KeyDirectory(slots, hashed=True)
    pb = prep_batch_shared(batch, directory, 1, rows_pad, nnz_pad, nnz_pad, slots)
    hb = prep_batch_hashed(batch, directory, 1, rows_pad, nnz_pad, slots)
    weights = rng.normal(size=nnz_pad).astype(np.float32)
    for rows, vals in ((pb.rows[0], pb.vals[0]), (hb.rows[0], hb.vals[0])):
        data = vals * weights
        assert _meets_contract(data, rows)
        got = ss.segment_sum_runs_ref(torch.from_numpy(data), torch.from_numpy(rows), rows_pad)
        want = torch.zeros(rows_pad).index_add_(0, torch.from_numpy(rows).long(),
                                                torch.from_numpy(data))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    rel, ok = localize(torch.from_numpy(pb.uslots[0]), slots)
    g_push = torch.where(ok, torch.from_numpy(weights[: rel.numel()]), 0.0)
    ids = torch.where(ok, rel, 0)
    assert _meets_contract(g_push.numpy(), ids.numpy())
    got = ss.segment_sum_runs_ref(g_push, ids, slots)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(torch.zeros(slots).index_add_(0, rel.long(), g_push).numpy()))
