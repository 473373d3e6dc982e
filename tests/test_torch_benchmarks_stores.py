"""PyTorch port: the component suite's store and host benchmarks
(``benchmarks/components.py``: ``kv_vector``, ``kv_map``, ``kv_layer``,
``network``, ``sparse_matrix``, ``step_phases``, ``host_ingest``,
``wire``, ``stream_prep``, ``executor``) at smoke on the CPU beside the
JAX package's, and the three public names the suite needed
(``utils/localizer.py::count_uniq_keys``,
``apps/linear/async_sgd.py::prep_batch``, ``learner/wire.py::tree_nbytes``)
held to the JAX functions on the same inputs. No speed ratio or wall
time is asserted.
"""

import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.benchmarks import components as jcomp
from parameter_server_tpu.learner import wire as jwire
from parameter_server_tpu.parameter.parameter import KeyDirectory as JKeyDirectory
from parameter_server_tpu.utils import localizer as jloc
from parameter_server_tpu.utils.sparse import random_sparse as jrandom_sparse
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.benchmarks import components as tcomp
from parameter_server_tpu_torch.learner import wire as twire
from parameter_server_tpu_torch.parameter.parameter import KeyDirectory
from parameter_server_tpu_torch.utils import localizer as tloc
from parameter_server_tpu_torch.utils.sparse import random_sparse
from tests.test_torch_benchmarks_cli import check_against_jax, run_port

torch.set_num_threads(1)

BENCHMARKS = ["kv_vector", "kv_map", "kv_layer", "network", "sparse_matrix", "step_phases",
              "host_ingest", "wire", "stream_prep", "executor"]


@pytest.mark.parametrize("name", BENCHMARKS)
def test_benchmark_lines_map_onto_the_jax_lines(name, tmp_path_factory):
    rec, _ = check_against_jax(name, tmp_path_factory.mktemp(name))
    assert rec["metrics"]


def _batches():
    out = [jrandom_sparse(200, 1 << 20, 9, seed=s, binary=s % 2 == 0) for s in range(3)]
    return out, [random_sparse(200, 1 << 20, 9, seed=s, binary=s % 2 == 0) for s in range(3)]


@pytest.mark.parametrize("cap", [255, 2])
def test_count_uniq_keys_equals_jax(cap):
    jb, tb = _batches()
    for a, b in zip(jb, tb):
        b.indices[: 40] = b.indices[0]  # repeats past the cap
        a.indices[: 40] = a.indices[0]
        jk, jc = jloc.count_uniq_keys(a, cap)
        tk, tc = tloc.count_uniq_keys(b, cap)
        assert np.array_equal(jk, tk) and jk.dtype == tk.dtype
        assert np.array_equal(jc, tc) and jc.dtype == tc.dtype


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_prep_batch_equals_jax(num_shards):
    jb, tb = _batches()
    num_slots = 1 << 14
    jdir, tdir = JKeyDirectory(num_slots, hashed=True), KeyDirectory(num_slots, hashed=True)
    rows_pad = -(-200 // num_shards)
    nnz_pad = rows_pad * 9
    for a, b in zip(jb, tb):
        want = jsgd.prep_batch(a, jdir, num_shards, rows_pad, nnz_pad, nnz_pad, num_slots)
        got = tsgd.prep_batch(b, tdir, num_shards, rows_pad, nnz_pad, nnz_pad, num_slots)
        for f in ("y", "mask", "rows", "ucols", "vals", "uslots", "umask"):
            w, g = np.asarray(getattr(want, f)), getattr(got, f)
            assert g.dtype == w.dtype and g.shape == w.shape, f
            assert np.array_equal(g, w), f
        assert got.num_examples == want.num_examples == 200


def test_prep_batch_refuses_a_batch_past_its_padding():
    b = random_sparse(64, 1 << 20, 9, seed=0)
    with pytest.raises(ValueError, match="exceeds padding"):
        tsgd.prep_batch(b, KeyDirectory(1 << 10), 1, 64, 64 * 9 - 1, 64 * 9, 1 << 10)


def test_tree_nbytes_equals_jax():
    """Over the port's batch classes (prepped, encoded exact and int8,
    the bits and stream wires) and over a list and a bare array."""
    rows, lanes, shards, num_slots = 512, 39, 2, 1 << 22
    jbs = jcomp._criteo_shape_batches(rows, lanes, 2)
    tbs = tcomp._criteo_shape_batches(rows, lanes, 2)
    jdir, tdir = JKeyDirectory(num_slots, hashed=True), KeyDirectory(num_slots, hashed=True)
    rows_pad, nnz_pad = rows // shards, rows // shards * lanes
    uniq_pad = -(-min(nnz_pad * shards, num_slots) // 1024) * 1024
    st_j = jwire.derive_stream_statics(jbs[0].indices, lanes, num_slots, num_slots)
    st_t = twire.derive_stream_statics(tbs[0].indices, lanes, num_slots, num_slots)
    for a, b in zip(jbs, tbs):
        jp = jsgd.prep_batch_shared(a, jdir, shards, rows_pad, nnz_pad, uniq_pad, num_slots)
        tp = tsgd.prep_batch_shared(b, tdir, shards, rows_pad, nnz_pad, uniq_pad, num_slots)
        pairs = [
            (jp, tp),
            (jwire.encode_exact(jp, num_slots), twire.encode_exact(tp, num_slots)),
            (jsgd.prep_batch_ell_bits(a, jdir, shards, rows_pad, lanes, num_slots),
             tsgd.prep_batch_ell_bits(b, tdir, shards, rows_pad, lanes, num_slots)),
            (jsgd.prep_batch_ell_stream(a, jdir, shards, rows_pad, lanes, num_slots, st_j),
             tsgd.prep_batch_ell_stream(b, tdir, shards, rows_pad, lanes, num_slots, st_t)),
            (jsgd.prep_batch(a, jdir, shards, rows_pad, nnz_pad, nnz_pad, num_slots),
             tsgd.prep_batch(b, tdir, shards, rows_pad, nnz_pad, nnz_pad, num_slots)),
        ]
        for jx, tx in pairs:
            assert jx is not None and tx is not None
            assert twire.tree_nbytes(tx) == jwire.tree_nbytes(jx) > 0
        assert (twire.tree_nbytes([p[1] for p in pairs])
                == jwire.tree_nbytes([p[0] for p in pairs]))
    arr = np.zeros(37, np.float32)
    assert twire.tree_nbytes(arr) == jwire.tree_nbytes(arr) == 148


def test_criteo_shape_batches_bit_equal_to_jax():
    for valued, seed in ((False, 0), (True, 1), (False, 3)):
        jbs = jcomp._criteo_shape_batches(300, 39, 2, valued=valued, seed=seed)
        tbs = tcomp._criteo_shape_batches(300, 39, 2, valued=valued, seed=seed)
        for a, b in zip(jbs, tbs):
            for f in ("y", "indptr", "indices"):
                w, g = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
                assert w.dtype == g.dtype and w.tobytes() == g.tobytes(), f
            assert (a.values is None) == (b.values is None) == (not valued)
            if valued:
                assert a.values.tobytes() == b.values.tobytes()


def test_synth_libsvm_equals_jax(tmp_path):
    jcomp._write_synth_libsvm(str(tmp_path / "j.libsvm"), 50, 7, seed=2)
    tcomp._write_synth_libsvm(str(tmp_path / "t.libsvm"), 50, 7, seed=2)
    assert (tmp_path / "j.libsvm").read_bytes() == (tmp_path / "t.libsvm").read_bytes()


def test_wire_bytes_per_example_equal_the_jax_record(tmp_path_factory):
    """The lossless encodings' bytes a example (exact, raw, bits, the
    stream wire, the int8 valued one) and the cache amortization: the
    port's wire record against the JAX ``wire_ab`` record on the same
    data; the parity bits hold."""
    rec, _ = run_port("wire", tmp_path_factory.mktemp("wire"))
    want = jcomp.wire_ab(smoke=True)
    assert rec["bytes_per_example"] == want["bytes_per_example"]
    assert rec["amortized_bytes_per_example"] == want["amortized_bytes_per_example"]
    assert rec["reduction_vs_raw_baseline"] == want["reduction_vs_raw_baseline"]
    assert rec["lz_staging_bytes_per_example"] == want["lz_staging_bytes_per_example"]
    assert rec["cache"] == want["cache"]
    assert rec["exact_parity_bit_identical"] and rec["stream_parity_bit_identical"]
    assert rec["bytes_per_example"]["bits"] == 107.4  # the recorded baseline


def test_stream_prep_is_byte_identical(tmp_path_factory):
    rec, _ = run_port("stream_prep", tmp_path_factory.mktemp("stream_prep"))
    assert rec["native_available"] and rec["parity_byte_identical"] is True
    assert rec["dict_lanes"] == jcomp.stream_prep_ab(smoke=True)["dict_lanes"]


def test_sparse_matrix_spmv_equals_jax_segment_sum():
    """The benchmark's SpMV (the segment sum by row over the localized
    COO) against ``jax.ops.segment_sum`` on the same inputs, within
    reordering of the sums (1e-5 relative, 1e-6 absolute)."""
    import jax

    batch = random_sparse(1 << 10, 1 << 24, 64, seed=0)
    loc = tloc.Localizer()
    keys, _ = loc.count_uniq_index(batch)
    local = loc.remap_index(keys)
    n = batch.n
    w = np.random.default_rng(0).normal(size=len(keys)).astype(np.float32)
    rows = local.row_ids().astype(np.int32)
    ucols = local.indices.astype(np.int64)
    vals = (np.ones(local.nnz, np.float32) if local.binary
            else local.values.astype(np.float32))
    got = tcomp._spmv(*(torch.from_numpy(a) for a in (vals, ucols, rows, w)), n).numpy()
    want = np.asarray(jax.jit(lambda v, c, r, w: jax.ops.segment_sum(v * w[c], r, num_segments=n))(
        vals, ucols.astype(np.int32), rows, w))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.count_nonzero(got) == n


def test_step_phases_record_has_both_sizes_at_full_and_one_at_smoke(tmp_path_factory):
    rec, _ = run_port("step_phases", tmp_path_factory.mktemp("step_phases"))
    assert list(rec["phase_ms"]) == [str(1 << 14)]
    assert set(rec["phase_ms"][str(1 << 14)]) == {"decode", "weights_dense", "gather_sum",
                                                  "scatter_add", "ftrl_update"}
