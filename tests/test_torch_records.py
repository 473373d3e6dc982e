"""PyTorch port: record files, the reference's PROTO records and the
data containers against the JAX package.

- ``utils/crc32c.py`` (the native ``ps_crc32c``) and its plain table
  version give the JAX package's ``crc32c.value``; ``masked`` /
  ``unmask`` match.
- ``utils/recordio.py`` and ``data/example.py``: this repo's batch
  records (``format: RECORD``) are byte-equal to the JAX package's and
  read across packages.
- ``data/ref_interop.py``: the reference's protobuf ``Example`` records
  (``format: PROTO``), including ``tests/data/ref_example.recordio``,
  which the reference's toolchain wrote, decode and encode as the JAX
  package does.
- ``StreamReader`` formats ``record`` and ``ref_record``, the
  ``text2record`` CLI (both formats) and ``show_example`` against the
  JAX package's; ``minibatches_bytes`` routes the record formats to the
  record path, which training reads through.
- The CTR conf trained on the CPU from RECORD and from PROTO files of
  the same rows as a text run: the same z and sqrt(n) bits and
  objectives.
- ``data/info.py``, ``data/slot_reader.py`` and ``data/binmat.py``
  against the JAX package on the same inputs.

Tolerance: none.
"""

import gzip
import io
import pathlib
import random
import struct

import numpy as np
import pytest
import torch

from parameter_server_tpu.data import binmat as jbin
from parameter_server_tpu.data import example as jex
from parameter_server_tpu.data import info as jinfo
from parameter_server_tpu.data import ref_interop as jref
from parameter_server_tpu.data import show_example as jshow
from parameter_server_tpu.data import slot_reader as jslot
from parameter_server_tpu.data import stream_reader as jsr
from parameter_server_tpu.data import text2record as jt2r
from parameter_server_tpu.utils import crc32c as jcrc
from parameter_server_tpu.utils import recordio as jrio
from parameter_server_tpu_torch.apps.linear import main as tmain
from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDWorker
from parameter_server_tpu_torch.benchmarks.criteo import write_criteo_shards
from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, write_ctr_shards
from parameter_server_tpu_torch.data import binmat as tbin
from parameter_server_tpu_torch.data import example as tex
from parameter_server_tpu_torch.data import info as tinfo
from parameter_server_tpu_torch.data import ref_interop as tref
from parameter_server_tpu_torch.data import show_example as tshow
from parameter_server_tpu_torch.data import slot_reader as tslot
from parameter_server_tpu_torch.data import stream_reader as tsr
from parameter_server_tpu_torch.data import text2record as tt2r
from parameter_server_tpu_torch.data import text_parser as ttp
from parameter_server_tpu_torch.learner import sgd as tlearner
from parameter_server_tpu_torch.utils import crc32c as tcrc
from parameter_server_tpu_torch.utils import recordio as trio
from parameter_server_tpu_torch.utils.sparse import SparseBatch, random_sparse

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = str(ROOT / "tests" / "data" / "ref_example.recordio")
LIBSVM = "1 3:0.5 7:1.25\n-1 1:2 9:0.125\n1 2:1\n1 4:1\n0 5:-0 6:3e-3\n"


def assert_batches_equal(tb, jb):
    for name in ("y", "indptr", "indices", "values", "slot_ids"):
        a, b = getattr(jb, name), getattr(tb, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8), err_msg=name)


def _random_batch(rng, binary, slots=True, n=17):
    counts = rng.integers(0, 6, n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    nnz = int(indptr[-1])
    return SparseBatch(
        y=rng.choice([-1.0, 1.0], n).astype(np.float32),
        indptr=indptr,
        indices=rng.integers(-(1 << 63), (1 << 63) - 1, nnz, dtype=np.int64),
        values=None if binary else rng.normal(size=nnz).astype(np.float32),
        slot_ids=rng.integers(1, 5, nnz).astype(np.int32) if slots else None,
    )


# -- crc32c --


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 4095, 100_003])
def test_crc32c_value_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    want = jcrc.value(data.tobytes())
    assert tcrc.value(data.tobytes()) == tcrc.value(data) == want
    if n <= 4095:
        assert tcrc.value_ref(data.tobytes()) == want
    assert tcrc.masked(want) == jcrc.masked(want)
    assert tcrc.unmask(tcrc.masked(want)) == want == jcrc.unmask(jcrc.masked(want))


def test_crc32c_known_value():
    # the CRC-32C check value of the ASCII digits 1-9
    assert tcrc.value(b"123456789") == tcrc.value_ref(b"123456789") == 0xE3069283


# -- this repo's records (format: RECORD) --


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("slots", [False, True])
def test_batch_payload_and_records_byte_equal(tmp_path, binary, slots):
    rng = np.random.default_rng(int(binary) * 2 + int(slots))
    batches = [_random_batch(rng, binary, slots) for _ in range(3)]
    for b in batches:
        assert tex.batch_to_bytes(b) == jex.batch_to_bytes(b)
        assert_batches_equal(tex.batch_from_bytes(jex.batch_to_bytes(b)),
                             jex.batch_from_bytes(jex.batch_to_bytes(b)))
    for mod, name in ((trio, "t.rec"), (jrio, "j.rec")):
        with open(tmp_path / name, "wb") as f:
            w = mod.RecordWriter(f)
            for b in batches:
                w.write_record(jex.batch_to_bytes(b))
    assert (tmp_path / "t.rec").read_bytes() == (tmp_path / "j.rec").read_bytes()
    with open(tmp_path / "j.rec", "rb") as f:
        got = [tex.batch_from_bytes(p) for p in trio.RecordReader(f)]
    for g, b in zip(got, batches):
        assert_batches_equal(g, b)
    assert len(got) == 3


def test_record_reader_rejects_corruption(tmp_path):
    payload = b"x" * 40
    buf = io.BytesIO()
    trio.RecordWriter(buf).write_record(payload)
    raw = bytearray(buf.getvalue())
    raw[-1] ^= 1
    for mod in (trio, jrio):
        with pytest.raises(IOError, match="crc mismatch"):
            mod.RecordReader(io.BytesIO(bytes(raw))).read_record()
        with pytest.raises(IOError, match="truncated"):
            mod.RecordReader(io.BytesIO(buf.getvalue()[:-3])).read_record()
        with pytest.raises(IOError, match="bad batch magic"):
            tex.batch_from_bytes(payload)


def test_example_info_merge_matches_jax():
    def infos(mod):
        a = mod.ExampleInfo(slot=[mod.SlotInfo(id=2, min_key=5, max_key=9, nnz_ele=3, nnz_ex=2)],
                            num_ex=4)
        b = mod.ExampleInfo(slot=[mod.SlotInfo(id=1, format="dense", nnz_ele=7),
                                  mod.SlotInfo(id=2, min_key=1, max_key=20, nnz_ele=1, nnz_ex=1)],
                            num_ex=6)
        a.merge(b)
        return [(s.id, s.format, s.min_key, s.max_key, s.nnz_ele, s.nnz_ex) for s in a.slot], a.num_ex

    assert infos(tex) == infos(jex)


# -- the reference's records (format: PROTO) --


def test_golden_file_decodes_as_in_the_jax_package():
    tp, jp = list(tref.iter_ref_records(GOLDEN)), list(jref.iter_ref_records(GOLDEN))
    assert tp == jp and len(tp) == 3
    for p in tp:
        ts, js = tref.decode_example(p), jref.decode_example(p)
        assert [s[0] for s in ts] == [s[0] for s in js]
        for (_, tk, tv), (_, jk, jv) in zip(ts, js):
            np.testing.assert_array_equal(tk, jk)
            assert (tv is None) == (jv is None)
            if tv is not None:
                np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
        assert tref.encode_example(ts) == p == jref.encode_example(js)
    b = tref.read_ref_batch(GOLDEN)
    assert_batches_equal(b, jref.read_ref_batch(GOLDEN))
    assert b.indices.view(np.uint64).tolist() == [3, 17, 2**40 + 5, 11, 13, 2**63 + 9]
    assert b.slot_ids.tolist() == [1, 1, 1, 2, 2, 5]
    assert_batches_equal(tref.read_ref_batch(GOLDEN, max_examples=2),
                         jref.read_ref_batch(GOLDEN, max_examples=2))


@pytest.mark.parametrize("binary", [False, True])
def test_ref_payloads_and_files_byte_equal(tmp_path, binary):
    b = _random_batch(np.random.default_rng(7), binary)
    b.slot_ids = np.abs(b.slot_ids) + 1  # slot 0 is the label's
    tp, jp = list(tref.batch_to_ref_payloads(b)), list(jref.batch_to_ref_payloads(b))
    assert tp == jp
    assert tref.write_ref_batch(str(tmp_path / "t"), b) == jref.write_ref_batch(str(tmp_path / "j"), b)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert_batches_equal(tref.read_ref_batch(str(tmp_path / "j")),
                         jref.read_ref_batch(str(tmp_path / "t")))


def test_ref_reader_rejects_bad_files(tmp_path):
    (tmp_path / "magic").write_bytes(struct.pack("<iI", 7, 0))
    raw = open(GOLDEN, "rb").read()
    (tmp_path / "payload").write_bytes(raw[:-2])
    (tmp_path / "header").write_bytes(raw[:5])
    for name, match in (("magic", "bad magic"), ("payload", "truncated record payload"),
                        ("header", "truncated record header")):
        for mod in (tref, jref):
            with pytest.raises(ValueError, match=match):
                list(mod.iter_ref_records(str(tmp_path / name)))


def test_decoder_on_mutated_and_random_bytes_matches_jax():
    """Bit-flipped golden payloads and random bytes: both decoders give
    the same slots or both raise ``ValueError``."""
    rng = np.random.default_rng(100)
    payloads = list(jref.iter_ref_records(GOLDEN))
    blobs = [rng.integers(0, 256, rng.integers(0, 64), dtype=np.uint8).tobytes()
             for _ in range(150)]
    for _ in range(150):
        p = bytearray(payloads[rng.integers(len(payloads))])
        for _ in range(rng.integers(1, 4)):
            p[rng.integers(len(p))] ^= 1 << rng.integers(8)
        blobs.append(bytes(p))
    for blob in blobs:
        out = []
        for mod in (tref, jref):
            try:
                out.append([(i, k.tolist(), None if v is None else v.view(np.int32).tolist())
                            for i, k, v in mod.decode_example(blob)])
            except ValueError:
                out.append("ValueError")
        assert out[0] == out[1], blob


def test_info_ascii_matches_jax():
    def info(mod):
        return mod.ExampleInfo(slot=[
            mod.SlotInfo(id=1, format="sparse_binary", min_key=5, max_key=2**63, nnz_ele=321,
                         nnz_ex=99),
            mod.SlotInfo(id=0, format="dense", min_key=0, max_key=0, nnz_ele=100, nnz_ex=100)],
            num_ex=100)

    text = tref.format_info_ascii(info(tex))
    assert text == jref.format_info_ascii(info(jex))
    odd = text + "# a comment\nslot {\n format: 3\n id: 2\n}\nsomething: 1\n"
    t, j = tref.parse_info_ascii(odd), jref.parse_info_ascii(odd)
    assert [vars(s) for s in t.slot] == [vars(s) for s in j.slot] and t.num_ex == j.num_ex
    assert t.slot[2].format == "sparse_binary"
    with pytest.raises(ValueError):
        tref.parse_info_ascii("slot {\n junk\n}\n")


# -- the readers, text2record and show_example --


def _text_files(tmp_path):
    (tmp_path / "a.libsvm").write_text(LIBSVM)
    (tmp_path / "b.libsvm").write_text(LIBSVM[::-1].split("\n", 1)[1][::-1] + "\n")
    return [str(tmp_path / "a.libsvm"), str(tmp_path / "b.libsvm")]


@pytest.mark.parametrize("ref", [False, True])
@pytest.mark.parametrize("fmt", ["libsvm", "ps_sparse_binary", "criteo"])
def test_text2record_files_and_readers_match_jax(tmp_path, capsys, ref, fmt):
    """``text2record`` (the CLI, in both packages) writes the same bytes;
    both readers read them into the same minibatches, also through
    ``minibatches_bytes`` and across a gzipped copy. The generated
    SPARSE_BINARY rows hold their features in group 0, the label's slot
    in the reference's records: there the port refuses to write them,
    and the JAX package writes records that read back without them."""
    if fmt == "libsvm":
        inputs = _text_files(tmp_path)
    elif fmt == "criteo":
        inputs = write_criteo_shards(str(tmp_path / "c"), 2, 30, seed=1)
    else:
        inputs = write_ctr_shards(str(tmp_path / "s"), 2, 30, seed=1, key_bits=10)
    flag = ["--ref-format"] if ref else []
    if ref and fmt == "ps_sparse_binary":
        args = ["--input", *inputs, "--format", fmt, "--batch", "7", *flag]
        with pytest.raises(ValueError, match="slot/group 0"):
            tt2r.main([*args, "--output", str(tmp_path / "t.rec")])
        assert jt2r.main([*args, "--output", str(tmp_path / "j.rec")]) == 0
        lost = jsr.StreamReader([str(tmp_path / "j.rec")], "ref_record").read_all()
        text = jsr.StreamReader(inputs, fmt).read_all()
        assert lost.n == text.n == 60 and text.nnz > 0 and lost.nnz == 0
        return
    outs = {}
    for name, mod in (("t", tt2r), ("j", jt2r)):
        out = str(tmp_path / f"{name}.rec")
        assert mod.main(["--input", *inputs, "--format", fmt, "--output", out, "--batch", "7",
                         *flag]) == 0
        outs[name] = (out, capsys.readouterr().out)
    assert outs["t"][1] == outs["j"][1].replace(outs["j"][0], outs["t"][0])
    assert open(outs["t"][0], "rb").read() == open(outs["j"][0], "rb").read()
    rec = outs["t"][0]
    with open(rec, "rb") as f, gzip.open(rec + ".gz", "wb") as g:
        g.write(f.read())
    kind = "ref_record" if ref else "record"
    files = [rec, rec + ".gz"]
    want = list(jsr.StreamReader(files, kind).minibatches(5))
    got = list(tsr.StreamReader(files, kind).minibatches(5))
    assert len(got) == len(want) >= 4
    for t, j in zip(got, want):
        assert_batches_equal(t, j)
    for t, j in zip(tsr.StreamReader(files, kind).minibatches_bytes(5, threads=2), want):
        assert_batches_equal(t, j)
    assert_batches_equal(tsr.StreamReader(files, kind).read_all(),
                         jsr.StreamReader(files, kind).read_all())


def test_minibatch_reader_reads_records(tmp_path):
    """``learner/sgd.py::MinibatchReader`` reads through
    ``minibatches_bytes``: RECORD and PROTO files give the text's
    batches (PROTO: the reference's records carry features of slot >= 1)."""
    inputs = _text_files(tmp_path)
    tt2r.convert(inputs, "libsvm", str(tmp_path / "r.rec"), batch_size=3)
    tt2r.convert_ref(inputs, "libsvm", str(tmp_path / "p.rec"))

    def read(path, fmt):
        r = tlearner.MinibatchReader(files=[path], minibatch_size=4, data_format=fmt)
        with r:
            return list(r)

    want = read(str(tmp_path / "*.libsvm"), "libsvm")
    for path, fmt in (("r.rec", "record"), ("p.rec", "ref_record")):
        got = read(str(tmp_path / path), fmt)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert_batches_equal(g, w)


def test_show_example_matches_the_jax_cli(tmp_path, capsys):
    inputs = _text_files(tmp_path)
    tt2r.convert(inputs, "libsvm", str(tmp_path / "r.rec"), batch_size=2)
    criteo = write_criteo_shards(str(tmp_path / "c"), 1, 6, seed=3)[0]
    (tmp_path / "ad").write_text("100 1 1 123:4 456:7 9:4\n101 1 0 789:2\n")
    # (file, format, -n, examples printed)
    cases = [(str(tmp_path / "r.rec"), "recordio", "4", 4), (inputs[0], "libsvm", "2", 2),
             (criteo, "criteo", "3", 3), (str(tmp_path / "ad"), "adfea", "9", 2)]
    for path, fmt, n, shown in cases:
        outs = []
        for mod in (tshow, jshow):
            assert mod.main(["-input", path, "-format", fmt, "-n", n]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and outs[0].count("\n") == shown
    (tmp_path / "empty").write_text("")
    assert tshow.main(["-input", str(tmp_path / "empty"), "-format", "libsvm"]) == 1
    assert "(no examples)" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tshow.main(["-input", inputs[0], "-format", "libsvm", "-n", "0"])
    assert tshow._FORMATS == jshow._FORMATS


# -- training from record files --


def _train(monkeypatch, tmp_path, data_glob, data_block, name):
    """The CTR conf through the CLI on the CPU; the worker's state and
    objectives."""
    text = ctr_conf(data_glob, str(tmp_path / name), num_slots=4096, countmin_n=1 << 16,
                    num_data_pass=2, minibatch=700)
    text = text.replace("  format: TEXT\n  text: SPARSE_BINARY\n", data_block)
    (tmp_path / f"{name}.conf").write_text(text)
    made = []

    class Recording(AsyncSGDWorker):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(tmain, "AsyncSGDWorker", Recording)
    random.seed(0)
    assert tmain.main([str(tmp_path / f"{name}.conf")], device="cpu") == 0
    (w,) = made
    return w.state_host()["state"], list(w.progress.objective)


@pytest.mark.parametrize("fmt", ["RECORD", "PROTO"])
def test_ctr_conf_trains_from_records_as_from_text(tmp_path, monkeypatch, fmt):
    """The CTR conf (tail filter, 1-byte push filter, tau 4) on the CPU,
    once from text and once from record files of the same rows. PROTO
    rows keep their features in group 1: the reference's records hold the
    label in slot 0, and both packages drop group-0 features on that
    path (ROADMAP Queue C)."""
    paths = write_ctr_shards(str(tmp_path / "text"), 2, 1500, seed=5, key_bits=14)
    if fmt == "PROTO":
        for p in paths:
            pathlib.Path(p).write_text(pathlib.Path(p).read_text().replace("; 0 ", "; 1 "))
    recs = []
    for i, p in enumerate(paths):
        recs.append(str(tmp_path / f"part-{i}.rec"))
        convert = tt2r.convert_ref if fmt == "PROTO" else tt2r.convert
        convert([p], "ps_sparse_binary", recs[-1], batch_size=512)
    z_text, obj_text = _train(monkeypatch, tmp_path, str(tmp_path / "text" / "part.*"),
                              "  format: TEXT\n  text: SPARSE_BINARY\n", "text")
    z_rec, obj_rec = _train(monkeypatch, tmp_path, str(tmp_path / "part-.*\\.rec"),
                            f"  format: {fmt}\n", "rec")
    assert len(obj_text) == 10 and obj_rec == obj_text  # 5 minibatches a pass
    assert z_text.keys() == z_rec.keys()
    for k in z_text:
        np.testing.assert_array_equal(np.asarray(z_rec[k]).view(np.uint8),
                                      np.asarray(z_text[k]).view(np.uint8), err_msg=k)
    assert np.count_nonzero(np.asarray(z_text["z"])) > 100


# -- info, slot reader, binary matrices --


def test_info_from_batch_matches_jax():
    lines = ["1 3:0.5 7:2", "-1 1:1", "1 9:2 4503599627370499:1"]
    b = ttp.parse_libsvm(lines)
    stripes = random_sparse(50, 64, 5, seed=2)
    stripes.indices = stripes.indices * (1 << 46)  # keys striped over slots 0-3
    for batch in (b, stripes, SparseBatch(y=b.y[:0], indptr=b.indptr[:1], indices=b.indices[:0])):
        for split in (True, False):
            t, j = tinfo.info_from_batch(batch, split), jinfo.info_from_batch(batch, split)
            assert [vars(s) for s in t.slot] == [vars(s) for s in j.slot] and t.num_ex == j.num_ex


@pytest.mark.parametrize("fmt", ["criteo", "libsvm"])
def test_slot_reader_matches_jax(tmp_path, fmt):
    if fmt == "criteo":
        files = write_criteo_shards(str(tmp_path / "d"), 2, 40, seed=4)
    else:
        files = _text_files(tmp_path)
    t = tslot.SlotReader(files, fmt, cache_dir=str(tmp_path / "tc"))
    j = jslot.SlotReader(files, fmt, cache_dir=str(tmp_path / "jc"))
    ti, ji = t.read(), j.read()
    assert [vars(s) for s in ti.slot] == [vars(s) for s in ji.slot] and ti.num_ex == ji.num_ex
    np.testing.assert_array_equal(t.labels, j.labels)
    for s in ji.slot:
        assert_batches_equal(t.slot(s.id), j.slot(s.id))
        t.clear(s.id)
        assert_batches_equal(t.slot(s.id), j.slot(s.id))  # from the cache
    assert sorted(p.name for p in (tmp_path / "tc").iterdir()) == sorted(
        p.name for p in (tmp_path / "jc").iterdir())
    assert t.slot(999) is None
    assert tslot.SlotReader([]).read().num_ex == 0


def test_binmat_files_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    tbin.save_bin(str(tmp_path / "v"), rng.normal(size=100), np.float32)
    np.testing.assert_array_equal(tbin.load_bin(str(tmp_path / "v"), "float32", 10, 20),
                                  jbin.load_bin(str(tmp_path / "v"), "float32", 10, 20))
    dense = rng.normal(size=(5, 3))
    sparse = random_sparse(20, 64, 3, seed=1)
    wide = random_sparse(6, 8, 2, seed=2)
    wide.indices = wide.indices + ((1 << 40) - (1 << 63))  # past 2^32, negative as int64
    binary = random_sparse(8, 30, 4, seed=3, binary=True)
    keys = np.arange(64, dtype=np.uint64) * 3
    for i, (mat, k) in enumerate(((dense, None), (sparse, keys), (wide, None), (binary, None))):
        tbin.mat2bin(str(tmp_path / f"t{i}"), mat, k)
        jbin.mat2bin(str(tmp_path / f"j{i}"), mat, k)
        for ext in (".info", ".offset", ".index", ".value", ".key"):
            tp, jp = tmp_path / f"t{i}{ext}", tmp_path / f"j{i}{ext}"
            assert tp.exists() == jp.exists()
            if tp.exists():
                assert tp.read_bytes() == jp.read_bytes(), ext
        got, want = tbin.bin2mat(str(tmp_path / f"j{i}")), jbin.bin2mat(str(tmp_path / f"t{i}"))
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
            continue
        assert_batches_equal(got[0], want[0])
        assert got[0].num_cols == want[0].num_cols
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("binary", [False, True])
def test_saveas_pserver_and_filter_fea_match_jax(tmp_path, binary):
    b = random_sparse(30, 40, 4, seed=5, binary=binary)
    b.indices = np.sort(b.indices.reshape(30, -1), axis=1).reshape(-1)
    group = np.repeat(np.arange(4), 10)
    tbin.saveas_pserver(str(tmp_path / "t"), b.y, b, group)
    jbin.saveas_pserver(str(tmp_path / "j"), b.y, b, group)
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()
    fmt = "ps_sparse_binary" if binary else "ps_sparse"
    lines = (tmp_path / "t").read_text().splitlines()
    assert ttp.ExampleParser(fmt).parse_lines(lines).nnz == b.nnz
    with pytest.raises(ValueError, match="sorted"):
        tbin.saveas_pserver(str(tmp_path / "x"), b.y, b, group[::-1])
    (tf, tk), (jf, jk) = tbin.filter_fea(b, 3), jbin.filter_fea(b, 3)
    np.testing.assert_array_equal(tk, jk)
    assert_batches_equal(tf, jf)
    assert tf.num_cols == jf.num_cols == len(tk) and 0 < tf.nnz < b.nnz
