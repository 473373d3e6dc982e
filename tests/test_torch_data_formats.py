"""PyTorch port: the Python-only text formats against the JAX package.

adfea, terafea, ps / ps_sparse and ps_dense (``data/text_parser.py``)
must give the JAX package's ``SparseBatch`` bit for bit (y, indptr,
indices, values or None, slot ids): on the JAX package's own golden
lines and slot cases, on edge cases (empty tokens, leading zeros, keys
past 2^64, negative groups, mangled lines), on lines mutated from a
seed (numpy, as the JAX package's robustness test does) and by
hypothesis, through ``ExampleParser`` and through ``StreamReader`` on
files. Unknown format names and ``bin`` raise ``ValueError`` in both.

Tolerance: none.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from parameter_server_tpu.data import stream_reader as jsr
from parameter_server_tpu.data import text_parser as jtp
from parameter_server_tpu_torch.data import stream_reader as tsr
from parameter_server_tpu_torch.data import text_parser as ttp

NEW = ["adfea", "terafea", "ps", "ps_sparse", "ps_dense"]
FN = {"adfea": "parse_adfea", "terafea": "parse_terafea", "ps": "parse_ps_sparse",
      "ps_sparse": "parse_ps_sparse", "ps_dense": "parse_ps_dense"}
K1, K2, K3 = (3 << 54) | 123, (3 << 54) | 456, (9 << 54) | 123

# the JAX package's golden lines and slot cases (tests/test_data.py), then edge cases
CASES = {
    "adfea": [
        ["100 1 1 123:4 456:7", "101 1 0 789:2"],
        ["7 1 -1 5:0 6:1", "8 1 0.5 18446744073709551617:3 4:-2", "9 1 x 1:1", "10 1"],
        ["1 1 1 0005:00012 9:", "2 1 1 1:2:3:4 5", "3 1 1e3 4503599627370499:1", ""],
        ["4 1 1 7:1 8:x 9:2", "5\t1\t1\t7:1", "6 1 1 :3 5:"],
    ],
    "terafea": [
        [f"1 1000 | {K1} {K2} {K3}", f"-1 1001 | {K1}"],
        [f"1 1000 | {K1} {K2}"],
        ["0 1 | 18446744073709551615 -5 x 7", "1 2", "y 1 | 3", "1 2 | 00017"],
        [f"2 3 4 {1 << 70} 9", "0.0 1 | 5", ""],
    ],
    "ps_sparse": [
        ["1;2 3:0.5 4:1.5;7 9:2;", "-1;2 3:1;"],
        ["1;2 3:0.5 4:1.5;7 9:2;"],
        ["0;-3 5:1 6 7:x 8:;", "1;x 4:1;", "1; ;;", "junk", "1;4 18446744073709551617:2;"],
        ["1;0 1:1e40 2:-0 3:nan;", "1;2 00007:1.25;", ";", "1.5"],
    ],
    "ps_dense": [
        ["1;2 0.5 1.5 2.5;", "-1;2 9;"],
        ["1;2 0.5 x 2.5;3 -0.0;", "0;1;", "1;y 1 2;", "1;0 1e40 inf;", "bad;1 1;"],
    ],
}
CASES["ps"] = CASES["ps_sparse"]


def assert_batches_equal(tb, jb):
    for name in ("y", "indptr", "indices", "values", "slot_ids"):
        a, b = getattr(jb, name), getattr(tb, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8), err_msg=name)


@pytest.mark.parametrize("fmt,i", [(f, i) for f in NEW for i in range(len(CASES[f]))])
def test_golden_and_edge_lines_bit_equal(fmt, i):
    lines = CASES[fmt][i]
    tb = ttp.ExampleParser(fmt).parse_lines(lines)
    jb = jtp.ExampleParser(fmt).parse_lines(lines)
    assert_batches_equal(tb, jb)
    assert_batches_equal(getattr(ttp, FN[fmt])(lines), jb)
    assert tb.n >= 1 and tb.binary == (fmt in ("adfea", "terafea"))


def test_golden_values():
    """The JAX package's expectations, on the port's parsers."""
    b = ttp.parse_adfea(["100 1 1 123:4 456:7", "101 1 0 789:2"])
    assert b.indices.tolist() == [4 * ttp.SLOT_SPACE + 123, 7 * ttp.SLOT_SPACE + 456,
                                  2 * ttp.SLOT_SPACE + 789]
    assert b.slot_ids.tolist() == [4, 7, 2] and b.y.tolist() == [1, -1]
    b = ttp.parse_terafea([f"1 1000 | {K1} {K2} {K3}", f"-1 1001 | {K1}"])
    assert b.indices[0] == b.indices[3] == K1 and b.indices[2] == K3
    assert b.slot_ids.tolist() == [3, 3, 9, 3]
    b = ttp.parse_ps_sparse(["1;2 3:0.5 4:1.5;7 9:2;", "-1;2 3:1;"])
    assert b.slot_ids.tolist() == [2, 2, 7, 2] and b.values.tolist() == [0.5, 1.5, 2.0, 1.0]
    b = ttp.parse_ps_dense(["1;2 0.5 1.5 2.5;", "-1;2 9;"])
    assert (b.indices[:3] - 2 * ttp.SLOT_SPACE).tolist() == [0, 1, 2]


def _mutate(rng, line):
    """The JAX package's mutation operators (tests/test_data.py)."""
    for _ in range(int(rng.integers(1, 4))):
        op = rng.integers(0, 5)
        if op == 0 and len(line) > 2:
            line = line[: rng.integers(1, len(line))]
        elif op == 1:
            i = rng.integers(0, len(line) + 1)
            line = line[:i] + chr(rng.integers(33, 127)) + line[i:]
        elif op == 2 and line:
            i = rng.integers(0, len(line))
            line = line[:i] + (";" if rng.random() < 0.5 else ":") + line[i:]
        elif op == 3:
            line = ""
        elif op == 4 and len(line) > 4:
            i = rng.integers(1, len(line) - 1)
            line = line[i:] + line[:i]
    return line


@pytest.mark.parametrize("fmt", NEW)
def test_mutated_lines_bit_equal(fmt):
    rng = np.random.default_rng(11)
    base = [line for case in CASES[fmt] for line in case if line]
    for trial in range(150):
        lines = [_mutate(rng, base[int(rng.integers(len(base)))]) if rng.random() < 0.7
                 else base[int(rng.integers(len(base)))] for _ in range(int(rng.integers(1, 8)))]
        lines.append(base[0])  # a good line always survives
        tb = ttp.ExampleParser(fmt).parse_lines(lines)
        jb = jtp.ExampleParser(fmt).parse_lines(lines)
        assert tb.n >= 1, (trial, lines)
        assert_batches_equal(tb, jb)


_ALPHABET = "0123456789 ;:-+.xe\t|"


@pytest.mark.parametrize("fmt", NEW)
@settings(max_examples=120, deadline=None, derandomize=True)
@given(lines=st.lists(st.text(alphabet=_ALPHABET, max_size=40), min_size=1, max_size=6))
def test_hypothesis_lines_bit_equal(fmt, lines):
    assert_batches_equal(ttp.ExampleParser(fmt).parse_lines(lines),
                         jtp.ExampleParser(fmt).parse_lines(lines))


@pytest.mark.parametrize("fmt", NEW)
def test_stream_reader_files_bit_equal(tmp_path, fmt):
    """Files of each format read in 3-row minibatches, across two files
    (one gzipped), by both packages' readers; the byte path takes the
    line path for these formats."""
    import gzip

    lines = [line for case in CASES[fmt] for line in case]
    (tmp_path / "part-1").write_text("\n".join(lines[:5]) + "\n")
    (tmp_path / "part-2.gz").write_bytes(gzip.compress(("\n".join(lines[5:]) + "\n").encode()))
    pattern = [str(tmp_path / "part-*")]
    tr, jr = tsr.StreamReader(pattern, fmt), jsr.StreamReader(pattern, fmt)
    assert tr.files == jr.files and len(tr.files) == 2
    tb, jb = list(tr.minibatches(3)), list(jr.minibatches(3))
    assert len(tb) == len(jb) >= 2
    for t, j in zip(tb, jb):
        assert_batches_equal(t, j)
    for t, j in zip(tr.minibatches_bytes(3), jb):
        assert_batches_equal(t, j)
    assert_batches_equal(tr.read_all(), jr.read_all())


@pytest.mark.parametrize("name", ["nope", "bin", "record", "ref_record", "svm"])
def test_unknown_names_raise_value_error_in_both(name):
    with pytest.raises(ValueError):
        jtp.ExampleParser(name)
    with pytest.raises(ValueError):
        ttp.ExampleParser(name)


def test_bin_reader_raises_what_the_jax_reader_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown text format"):
        jsr.StreamReader([str(tmp_path / "x")], "bin")
    with pytest.raises(ValueError, match="unknown text format"):
        tsr.StreamReader([str(tmp_path / "x")], "bin")
