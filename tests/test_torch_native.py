"""PyTorch port: the native host library against the JAX package's.

``parameter_server_tpu_torch/native/psnative.cc`` is built by the port's
own loader (g++ at first use, into ``build/psnative/``) and every
exported ``ps_*`` function is held bit for bit to the JAX package's
prebuilt ``cpp.native()`` on the same seeded inputs: hash, mix, murmur,
crc32c, bit packing, the stream encode, LZ compression (bytes and round
trip) and both text parsers, truncation included. The port's parsers,
native and Python, must give equal ``SparseBatch`` arrays, and the byte
path of ``StreamReader`` the line path's minibatches.

Tolerance: none; every comparison is exact.
"""

import ctypes
import pathlib

import numpy as np
import pytest

from parameter_server_tpu import cpp as jcpp
from parameter_server_tpu.data import text_parser as jtp
from parameter_server_tpu_torch import native
from parameter_server_tpu_torch.benchmarks.criteo import criteo_rows, criteo_text
from parameter_server_tpu_torch.data import stream_reader as tsr
from parameter_server_tpu_torch.data import text_parser as ttp
from parameter_server_tpu_torch.utils import murmur as tmurmur

ROOT = pathlib.Path(__file__).resolve().parents[1]
U8, U64, I32 = ctypes.c_uint8, ctypes.c_uint64, ctypes.c_int32


@pytest.fixture(scope="module")
def libs():
    """(the port's library, the JAX package's), both with every C
    signature declared (the JAX loader's declarations, applied to a
    second handle of the port's library)."""
    native.library()
    jlib = jcpp.native()
    assert jlib is not None, "the JAX package's native library did not load"
    return jcpp._configure(ctypes.CDLL(str(native.library_path()))), jlib


def _p(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _both(libs, name, make_args):
    """Call ``name`` in both libraries on fresh buffers from
    ``make_args()`` -> (args, outputs); returns [(ret, outputs)] a lib."""
    res = []
    for lib in libs:
        args, outs = make_args()
        res.append((getattr(lib, name)(*args), outs))
    return res


def _assert_same(res):
    (ra, oa), (rb, ob) = res
    assert ra == rb
    for a, b in zip(oa, ob):
        np.testing.assert_array_equal(a, b)


def test_library_is_built_from_the_port_source(libs):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent == ROOT / "build" / "psnative"
    assert native.SOURCE.parent.name == "native" and "parameter_server_tpu_torch" in str(native.SOURCE)
    # the port's source holds every function the JAX library exports
    src = native.SOURCE.read_text()
    jsrc = (ROOT / "parameter_server_tpu" / "cpp" / "psnative.cc").read_text()
    names = sorted(set(n for n in jsrc.split() if n.startswith("ps_") and "(" in n))
    assert names and all(n in src for n in names)


def test_library_name_keys_source_and_flags(monkeypatch, tmp_path):
    base = native.library_path()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-DPS_UNUSED_MACRO"])
    assert native.library_path() != base
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS[:-1])
    src = tmp_path / "psnative.cc"
    src.write_text(native.SOURCE.read_text() + "\n// changed\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != base


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "psnative.cc"
    src.write_text("int ps_hash_slots( {\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native host library build failed(.|\n)*error"):
        native.library()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 4095, 100_003])
def test_crc32c(libs, n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    got = [lib.ps_crc32c(_p(data, U8), n) for lib in libs]
    assert got[0] == got[1]


def test_mix64_scalar_and_array(libs):
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 63, 5000, dtype=np.int64).view(np.uint64)
    for seed in (0, 7, (1 << 64) - 1):
        for k in keys[:20].tolist():
            assert libs[0].ps_mix64(k, seed) == libs[1].ps_mix64(k, seed)
        _assert_same(_both(libs, "ps_mix64_array", lambda: (
            (_p(keys, U64), keys.size, seed, _p(out := np.zeros_like(keys), U64)), [out])))


@pytest.mark.parametrize("num_slots", [1 << 22, 1000003, 1])
def test_hash_slots(libs, num_slots):
    keys = np.random.default_rng(2).integers(-(1 << 63), (1 << 63) - 1, 70_000, dtype=np.int64)
    k = keys.view(np.uint64)
    for seed in (0, 3):
        _assert_same(_both(libs, "ps_hash_slots", lambda: (
            (_p(k, U64), k.size, seed, num_slots, _p(out := np.zeros(k.size, np.int32), I32)),
            [out])))


@pytest.mark.parametrize("n", [4096, 626_895])
def test_hash_slots_native_route_equals_numpy(n):
    """``hash_slots`` takes the native library from 4096 keys: the slots
    are the NumPy finalizer's."""
    keys = np.random.default_rng(n).integers(0, 1 << 40, n, dtype=np.int64)
    for num_slots in (1 << 22, 999_983):
        h = tmurmur.murmur64_np(keys.view(np.uint64))
        want = (h % np.uint64(num_slots)).astype(np.int32)
        np.testing.assert_array_equal(tmurmur.hash_slots(keys, num_slots), want)


def test_murmur3(libs):
    for s in (b"", b"a", b"abcdefgh", b"0123456789abcdef", b"0123456789abcdefXYZ" * 3, bytes(range(256))):
        for seed in (0, 512927377):
            outs = []
            for lib in libs:
                out = np.zeros(2, np.uint64)
                lib.ps_murmur3_x64_128(s, len(s), seed, _p(out, U64))
                outs.append(out)
            np.testing.assert_array_equal(*outs)
            assert tuple(outs[0].tolist()) == tmurmur.murmur3_x64_128(s, seed)


@pytest.mark.parametrize("bits", [1, 3, 8, 13, 22, 31, 32])
def test_pack_bits(libs, bits):
    n = 10_001
    vals = np.random.default_rng(bits).integers(0, 1 << min(bits, 31), n).astype(np.int32)
    nbytes = (n * bits + 7) // 8 + 8
    _assert_same(_both(libs, "ps_pack_bits", lambda: (
        (_p(vals, I32), n, bits, _p(out := np.zeros(nbytes, np.uint8), U8)), [out])))


@pytest.mark.parametrize("num_slots,bits", [(1 << 22, 22), (1000003, 20)])
def test_hash_slots_packbits(libs, num_slots, bits):
    keys = np.random.default_rng(bits).integers(0, 1 << 62, 9000, dtype=np.int64).view(np.uint64)
    nbytes = (keys.size * bits + 7) // 8
    _assert_same(_both(libs, "ps_hash_slots_packbits", lambda: (
        (_p(keys, U64), keys.size, 5, num_slots, bits,
         _p(out := np.zeros(nbytes, np.uint8), U8)), [out])))


@pytest.mark.parametrize("vocab,code_bits", [(40, 6), (5000, 6)])  # fits / does not fit
def test_stream_encode(libs, vocab, code_bits):
    rng = np.random.default_rng(vocab)
    nsub, lanes, num_slots, raw_bits, dict_pad = 600, 8, 1 << 16, 16, 512
    keys = rng.integers(0, 1 << 40, (nsub, lanes), dtype=np.int64)
    keys[:, :3] = rng.integers(0, vocab, (nsub, 3))  # the dictionary lanes' small vocabulary
    k = keys.view(np.uint64).ravel()
    mask = np.array([1, 1, 1, 0, 0, 0, 0, 0], np.uint8)
    cap = nsub * lanes * 4 + 64

    def args():
        starts = np.zeros(4, np.int32)
        raw, code, table = (np.zeros(cap, np.uint8) for _ in range(3))
        return ((_p(k, U64), nsub, lanes, 9, num_slots, _p(mask, U8), raw_bits, code_bits,
                 dict_pad, _p(starts, I32), _p(raw, U8), _p(code, U8), _p(table, U8)),
                [starts, raw, code, table])

    res = _both(libs, "ps_stream_encode", args)
    _assert_same(res)
    assert (res[0][0] >= 0) == (vocab == 40)


@pytest.mark.parametrize("kind", ["zeros", "text", "random", "repeats", "tiny"])
def test_lz_compress_bytes_and_round_trip(libs, kind):
    rng = np.random.default_rng(5)
    data = {
        "zeros": np.zeros(100_000, np.uint8),
        "text": np.frombuffer(criteo_text(*criteo_rows(rng, 200)), np.uint8).copy(),
        "random": rng.integers(0, 256, 50_000, dtype=np.uint8),
        "repeats": np.tile(rng.integers(0, 256, 37, dtype=np.uint8), 3000),
        "tiny": np.array([7], np.uint8),
    }[kind]
    n = data.size
    caps = [lib.ps_lz_max_compressed(n) for lib in libs]
    assert caps[0] == caps[1]
    res = _both(libs, "ps_lz_compress", lambda: (
        (_p(data, U8), n, _p(out := np.zeros(caps[0], np.uint8), U8), caps[0]), [out]))
    _assert_same(res)
    got = res[0][0]
    assert got >= 0
    comp = res[0][1][0][:got].copy()
    for lib in libs:
        back = np.zeros(n, np.uint8)
        assert lib.ps_lz_decompress(_p(comp, U8), comp.size, _p(back, U8), n) == n
        np.testing.assert_array_equal(back, data)
    # a corrupt stream is refused alike
    bad = comp.copy()
    bad[0] ^= 0xFF
    rets = [lib.ps_lz_decompress(_p(bad, U8), bad.size, _p(np.zeros(n, np.uint8), U8), n)
            for lib in libs]
    assert rets[0] == rets[1]


def _libsvm_text(n, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        idx = np.unique(rng.integers(0, 1 << 40, rng.integers(0, 30)))
        vals = rng.choice(["1", "0.25", "-3e-2", "7", "1e5", ""], idx.size)
        lines.append(" ".join([("+1", "-1", "0", "2.5")[i % 4]] + [f"{k}:{v}" for k, v in zip(idx, vals)]))
    lines += ["x 1:1", "1 5:1 3:1", "1\t4:2\r", "", "1 :2 7:"]
    return lines


def _criteo_lines(n, seed):
    rng = np.random.default_rng(seed)
    labels, ints, ids = criteo_rows(rng, n)
    lines = criteo_text(labels, ints, ids).decode().splitlines()
    lines += ["1\t2\t3", "\t" * 39, "1\t" + "\t".join(["-99999999999999999999"] * 13 + ["ab"] * 26)]
    return lines


PARSERS = [("ps_parse_libsvm", "libsvm", _libsvm_text), ("ps_parse_criteo", "criteo", _criteo_lines)]


@pytest.mark.parametrize("fn,fmt,lines", PARSERS, ids=[f for _, f, _ in PARSERS])
@pytest.mark.parametrize("max_nnz", [1 << 16, 100])  # the second truncates mid-stream
def test_parsers(libs, fn, fmt, lines, max_nnz):
    text = ("\n".join(lines(300, 1)) + "\n").encode()
    rows = text.count(b"\n") + 1

    def args():
        outs = [np.zeros(rows, np.float32), np.zeros(rows + 1, np.int64),
                np.zeros(max_nnz, np.uint64), np.zeros(max_nnz, np.float32),
                np.zeros(max_nnz, np.int32), np.zeros(1, np.int64)]
        y, indptr, idx, vals, slots, nnz = outs
        return ((text, len(text), _p(y, ctypes.c_float), _p(indptr, ctypes.c_int64), _p(idx, U64),
                 _p(vals, ctypes.c_float), _p(slots, I32), rows, max_nnz,
                 _p(nnz, ctypes.c_int64)), outs)

    res = _both(libs, fn, args)
    _assert_same(res)
    got = res[0][0]
    assert (got < 0) == (max_nnz == 100)  # -(rows + 1): the value buffer filled


def _assert_batches_equal(a, b):
    for name in ("y", "indptr", "indices", "values", "slot_ids"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("fmt,lines", [("libsvm", _libsvm_text), ("criteo", _criteo_lines)])
def test_native_and_python_parsers_give_equal_batches(fmt, lines):
    ls = lines(500, 2)
    nat = ttp.ExampleParser(fmt)
    py = ttp.ExampleParser(fmt, use_native=False)
    assert nat.use_native and not py.use_native
    tb = nat.parse_lines(ls)
    assert tb.n > 400
    _assert_batches_equal(tb, py.parse_lines(ls))
    _assert_batches_equal(tb, nat.parse_text(("\n".join(ls) + "\n").encode()))
    _assert_batches_equal(tb, jtp.ExampleParser(fmt).parse_lines(ls))


def test_formats_without_a_native_parser_take_the_python_one():
    p = ttp.ExampleParser("ps_sparse_binary")
    assert not p.use_native
    b = p.parse_text(b"1; 0 5 7;\n0; 0 9;\n")
    assert b.n == 2 and b.nnz == 3


@pytest.mark.parametrize("fmt,lines", [("libsvm", _libsvm_text), ("criteo", _criteo_lines)])
@pytest.mark.parametrize("chunk", [1 << 10, 1 << 20])
def test_byte_path_equals_line_path(tmp_path, fmt, lines, chunk):
    """Two files (the first without a final newline); minibatches cross
    the file boundary and the chunk boundaries."""
    ls = lines(700, 3)
    (tmp_path / "part-1").write_text("\n".join(ls[:401]))
    (tmp_path / "part-2").write_text("\n".join(ls[401:]) + "\n")
    files = [str(tmp_path / "part-*")]
    want = list(tsr.StreamReader(files, fmt).minibatches(128))
    got = list(tsr.StreamReader(files, fmt).minibatches_bytes(128, chunk_bytes=chunk, threads=3))
    assert len(got) == len(want) > 4
    for a, b in zip(got, want):
        _assert_batches_equal(a, b)


def test_byte_path_takes_the_line_path_without_native():
    r = tsr.StreamReader([], "ps_sparse_binary")
    assert list(r.minibatches_bytes(8)) == []
