"""PyTorch port: the counts of ``benchmarks/segment_bytes.py`` that bound
a segment sum (bytes, and the longest run of nonzero entries that the
serial floor multiplies), exact on inputs built by hand, on the CPU."""

import pytest
import torch

from parameter_server_tpu_torch.benchmarks import segment_bytes as sb


def test_bytes_count_ids_nonzero_values_and_sums():
    data = torch.tensor([1.0, 0.0, -2.0, -0.0, 3.0, 0.0])
    ids = torch.tensor([0, 0, 1, 1, 1, 4], dtype=torch.int32)
    need = sb.counts(data, ids, 5)
    assert need == dict(entries=6, live=3, segments=5, longest=2, bytes=4 * 6 + 4 * 3 + 4 * 5)


def test_longest_counts_nonzero_entries_of_one_segment_in_any_order():
    # segment 7: four nonzero entries scattered (the sort gathers them), one
    # zero; segment 2: three
    data = torch.tensor([1.0, 5.0, 2.0, 0.0, 3.0, 6.0, 4.0, 7.0, 0.0])
    ids = torch.tensor([7, 2, 7, 7, 7, 2, 7, 2, 2], dtype=torch.int32)
    assert sb.counts(data, ids, 8)["longest"] == 4


def test_longest_is_zero_without_a_nonzero_entry():
    need = sb.counts(torch.zeros(10), torch.zeros(10, dtype=torch.int32), 3)
    assert (need["live"], need["longest"], need["bytes"]) == (0, 0, 40 + 12)


def test_nan_counts_as_nonzero_and_ids_past_the_segments_are_left_out():
    data = torch.tensor([float("nan"), 1.0, 1.0, 1.0])
    ids = torch.tensor([0, 3, 3, 3], dtype=torch.int32)
    need = sb.counts(data, ids, 3)  # id 3 is past the 3 segments
    assert (need["live"], need["longest"]) == (4, 1)


@pytest.mark.parametrize("longest,ns,want_by", [(7452, 2.0, "operations"), (3, 2.0, "bytes")])
def test_bound_is_the_larger_of_bytes_and_the_serial_floor(longest, ns, want_by):
    need = dict(bytes=3_350_000, longest=longest)  # 1 us of bytes at 3.35 TB/s
    ms, by = sb.bound(need, ns)
    assert by == want_by
    assert ms == pytest.approx(max(1e-3, longest * ns * 1e-6))
    assert sb.serial_floor_ms(longest, ns) == pytest.approx(longest * ns * 1e-6)
