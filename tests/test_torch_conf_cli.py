"""PyTorch port: the conf-driven CLI and its host side against the JAX package.

- ``parse_conf`` gives the JAX parser's field values for every ``.conf``
  under ``configs/`` that selects ``async_sgd`` or ``darlin`` (exact), and
  the same defaults; a conf of a feature the port does not have (server
  replicas) raises ``NotImplementedError``; the model-evaluation confs
  run (``tests/test_torch_model_evaluation.py``).
- Each ``batch_l1lr.conf`` (darlin) runs through both CLIs on ~2,000
  generated rows of its format, from a directory laid out as its paths
  expect: the same progress lines, each printed number within one unit
  of its last printed digit plus the run's tolerance (objective 1e-6
  relative, rel 1e-6, violation 1e-5 relative: XLA's CPU ``exp`` is not
  libm's, ``tests/test_torch_darlin.py``), ``|w|0`` and the active set
  equal; the ``_S0`` models hold the same keys in the same order, the
  weights within 1e-4 relative + 1e-5. ``eval_batch.conf`` then scores
  the port's model through both CLIs to the same line.
- The text parsers give bit-equal ``SparseBatch``es on the committed
  libsvm fixtures and on generated SPARSE_BINARY and CRITEO lines; the
  minibatch reader with the count-min tail filter yields the same
  batches as the JAX reader; the workload pool hands out the same order.
- The CLI runs the CTR conf (``configs/ctr/online_l1lr.conf``) on the
  CPU, rewritten only where the data files, the model output and the
  table sizes (weights and count-min sketch) must shrink, and writes
  ``model_S0``. With the quantized push filter removed, its model equals
  a JAX worker's trained on the same batches within the exact-wire
  tolerance (rtol 1e-5, atol 1e-6: XLA's FMA contraction under jit).
"""

import dataclasses
import glob
import importlib.util
import os
import pathlib
import random
import re

import numpy as np
import pytest
import torch

import jax

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.data import text_parser as jtp
from parameter_server_tpu.learner import sgd as jlearner
from parameter_server_tpu.learner import workload_pool as jpool
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu.system.postoffice import Postoffice
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear import main as tmain
from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, write_ctr_shards
from parameter_server_tpu_torch.data import stream_reader as tsr
from parameter_server_tpu_torch.data import text_parser as ttp
from parameter_server_tpu_torch.learner import sgd as tlearner
from parameter_server_tpu_torch.learner import workload_pool as tpool

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFS = sorted(glob.glob(str(ROOT / "configs" / "*" / "*.conf")))
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)


def _selects_async_sgd(path):
    return "async_sgd" in jcfg.parse_conf_dict(open(path).read())


ASYNC = [c for c in CONFS if _selects_async_sgd(c)]
OTHER = [c for c in CONFS if not _selects_async_sgd(c)]
DARLIN = [c for c in OTHER if "darlin" in jcfg.parse_conf_dict(open(c).read())]


def _ids(paths):
    return [os.path.relpath(p, ROOT / "configs") for p in paths]


def test_every_conf_is_covered():
    assert len(ASYNC) >= 4 and len(OTHER) >= 6
    assert str(ROOT / "configs" / "ctr" / "online_l1lr.conf") in ASYNC
    # every other conf is a darlin conf or a model evaluation
    evals = [c for c in OTHER if os.path.basename(c).startswith("eval_")]
    assert len(DARLIN) == 3 and sorted(DARLIN + evals) == OTHER


@pytest.mark.parametrize("path", ASYNC, ids=_ids(ASYNC))
def test_parse_conf_matches_jax(path):
    text = open(path).read()
    j = jcfg.parse_conf(text)
    js = dataclasses.asdict(j.async_sgd)
    unported = {k for k, v in tcfg._UNPORTED.items() if js.get(k, v) != v}
    if unported:  # a wire the port does not have: the parse fails loudly
        with pytest.raises(NotImplementedError, match="|".join(sorted(unported))):
            tcfg.parse_conf(text)
        return
    t = tcfg.parse_conf(text)
    for name in ("training_data", "validation_data", "model_output", "model_input",
                 "loss", "penalty", "learning_rate"):
        jv, tv = getattr(j, name), getattr(t, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            _assert_fields_match(dataclasses.asdict(tv), dataclasses.asdict(jv),
                                 dataclasses.asdict(type(jv)()))
    _assert_fields_match(dataclasses.asdict(t.async_sgd), js, dataclasses.asdict(jcfg.SGDConfig()))


def _assert_fields_match(ours, theirs, their_defaults):
    """Every field the port carries equals the JAX value; the JAX fields
    the port does not carry are at their defaults (no conf set them)."""
    for k, v in ours.items():
        assert theirs[k] == v, k
    for k in set(theirs) - set(ours):
        assert theirs[k] == their_defaults[k], k


def test_ctr_conf_fields():
    c = tcfg.parse_conf(open(ROOT / "configs" / "ctr" / "online_l1lr.conf").read())
    s = c.async_sgd
    assert c.training_data.text == "ps_sparse_binary"
    assert s.push_filter == [{"type": "key_caching", "clear_cache_if_done": True},
                             {"type": "fixing_float", "num_bytes": 1}]
    assert (s.max_delay, s.num_data_pass, s.tail_feature_freq) == (4, 10, 4)
    assert (s.countmin_n, s.countmin_k, s.minibatch) == (100_000_000, 2, 10000)
    assert c.penalty.lambda_ == [10.0, 1.0]
    assert (c.learning_rate.alpha, c.learning_rate.beta) == (0.01, 10.0)


@pytest.mark.parametrize("path", DARLIN, ids=_ids(DARLIN))
def test_parse_darlin_conf_matches_jax(path):
    text = open(path).read()
    j, t = jcfg.parse_conf(text), tcfg.parse_conf(text)
    assert t.async_sgd is None and j.async_sgd is None
    for name in ("training_data", "validation_data", "model_output", "model_input",
                 "loss", "penalty", "learning_rate"):
        jv, tv = getattr(j, name), getattr(t, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            _assert_fields_match(dataclasses.asdict(tv), dataclasses.asdict(jv),
                                 dataclasses.asdict(type(jv)()))
    _assert_fields_match(dataclasses.asdict(t.darlin), dataclasses.asdict(j.darlin),
                         dataclasses.asdict(jcfg.BCDConfig()))
    assert dataclasses.asdict(t.darlin).keys() == dataclasses.asdict(j.darlin).keys()


def test_config_defaults_match_jax():
    for name in ("BCDConfig", "SGDConfig", "DataConfig", "LossConfig", "PenaltyConfig",
                 "LearningRateConfig"):
        _assert_fields_match(dataclasses.asdict(getattr(tcfg, name)()),
                             dataclasses.asdict(getattr(jcfg, name)()),
                             dataclasses.asdict(getattr(jcfg, name)()))
    assert dataclasses.asdict(tcfg.BCDConfig()) == dataclasses.asdict(jcfg.BCDConfig())


def test_darlin_conf_fields():
    c = tcfg.parse_conf(open(ROOT / "configs" / "criteo" / "batch_l1lr.conf").read())
    b = c.darlin
    assert (b.num_data_pass, b.epsilon, b.max_block_delay) == (50, 2e-5, 2)
    assert (b.save_model_every_n_iter, b.comm_filter) == (20, [{"type": "key_caching"}])
    assert c.penalty.lambda_ == [4.0, 1.0] and c.learning_rate.alpha == 0.9
    assert not hasattr(b, "tail_feature_freq")  # the JAX parser reads none either


_BATCH_DATA = {"ctr": "ps_sparse_binary", "criteo": "criteo", "rcv1": "libsvm"}
_PRINTED = re.compile(r"iter +(\d+): objv (\S+) rel (\S+) \|w\|0 (\d+) active (\d+) vio (\S+)$")


def _write_batch_data(name, directory, rows, seed):
    os.makedirs(directory, exist_ok=True)
    if name == "ctr":
        return write_ctr_shards(directory, 1, rows, seed, key_bits=16)
    if name == "criteo":
        from parameter_server_tpu_torch.benchmarks.criteo import write_criteo_shards

        return write_criteo_shards(directory, 1, rows, seed)
    spec = importlib.util.spec_from_file_location("synth_data", ROOT / "configs" / "synth_data.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=1 << 12) * (rng.random(1 << 12) < 0.1)).astype(np.float32)
    path = os.path.join(directory, "part-001")
    synth.write_libsvm(path, rng, rows, 1 << 12, 32, w)
    return [path]


def _printed_close(a: str, b: str, rtol: float = 0.0, atol: float = 0.0) -> bool:
    """Two numbers printed as ``%.Ne`` agree within one unit of the last
    printed digit (a rounding that fell the other way) plus the tolerance."""
    x, y = float(a), float(b)
    digits = len(a.split("e")[0].split(".")[1])
    unit = 10.0 ** (int(a.split("e")[1]) - digits)
    return abs(x - y) <= unit + atol + rtol * abs(y)


def _progress(out: str):
    lines = [_PRINTED.match(line) for line in out.splitlines() if line.startswith("iter ")]
    assert lines and all(lines), out
    return [m.groups() for m in lines]


@pytest.mark.parametrize("path", DARLIN, ids=_ids(DARLIN))
def test_batch_conf_cli_matches_jax(path, tmp_path, monkeypatch, capsys):
    """The conf as it is, from a directory laid out as its relative paths
    expect, through the port's CLI (``--device cpu``) and the JAX CLI
    (``--num-workers 1``); then ``eval_batch.conf`` on the port's model."""
    from parameter_server_tpu.apps.linear import main as jmain

    name = pathlib.Path(path).parent.name
    conf = tcfg.parse_conf(open(path).read())
    (train_glob,) = conf.training_data.file
    _write_batch_data(name, str(tmp_path / os.path.dirname(train_glob)), 2000, seed=1)
    model = tmp_path / (conf.model_output.file[0] + "_S0")
    monkeypatch.chdir(tmp_path)
    Postoffice.reset()
    try:
        assert jmain.main([path, "--num-workers", "1"]) == 0
    finally:
        Postoffice.reset()
    want = _progress(capsys.readouterr().out)
    os.rename(model, tmp_path / "model" / "jax_S0")
    assert tmain.main([path], device="cpu") == 0
    out = capsys.readouterr().out
    got = _progress(out)
    assert f"model written to {conf.model_output.file[0]}_S0" in out
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3:5] == w[3:5], (g, w)  # pass, |w|0, active
        assert _printed_close(g[1], w[1], rtol=1e-6), (g, w)
        assert _printed_close(g[2], w[2], atol=1e-6), (g, w)
        assert _printed_close(g[5], w[5], rtol=1e-5), (g, w)
    assert float(got[-1][1]) < float(got[0][1])

    def read(p):
        rows = [line.split("\t") for line in p.read_text().splitlines()]
        return [k for k, _ in rows], np.array([float(v) for _, v in rows])

    keys, w_port = read(model)
    jkeys, w_jax = read(tmp_path / "model" / "jax_S0")
    assert keys == jkeys and len(keys) == int(got[-1][3]) > 0
    np.testing.assert_allclose(w_port, w_jax, rtol=1e-4, atol=1e-5)

    # the eval conf of the set scores the port's model, through both CLIs
    eval_path = ROOT / "configs" / name / "eval_batch.conf"
    econf = tcfg.parse_conf(eval_path.read_text())
    (test_glob,) = econf.validation_data.file
    _write_batch_data(name, str(tmp_path / os.path.dirname(test_glob)), 600, seed=2)
    assert tmain.main([str(eval_path)], device="cpu") == 0
    port_eval = [x for x in capsys.readouterr().out.splitlines() if x.startswith("auc: ")]
    try:
        assert jmain.main([str(eval_path)]) == 0
    finally:
        Postoffice.reset()
    jax_eval = [x for x in capsys.readouterr().out.splitlines() if x.startswith("auc: ")]
    assert port_eval == jax_eval and len(port_eval) == 1 and "(600 examples)" in port_eval[0]


@pytest.mark.parametrize("flag", [["--num-servers", "2"], ["--num-workers", "2"]])
def test_system_layer_flags_raise(flag, tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text(open(ROOT / "configs" / "rcv1" / "online_l1lr.conf").read())
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tmain.main([str(conf), *flag], device="cpu")


# -- parsers --


def _assert_batches_equal(tb, jb):
    for name in ("y", "indptr", "indices", "values", "slot_ids"):
        a, b = getattr(jb, name), getattr(tb, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("fixture", ["wire_parity.libsvm", "ingest_parity.libsvm"])
def test_libsvm_fixtures_bit_equal(fixture):
    lines = (ROOT / "tests" / "data" / fixture).read_text().splitlines()
    tb = ttp.ExampleParser("libsvm").parse_lines(lines)
    assert tb.n > 50
    _assert_batches_equal(tb, jtp.ExampleParser("libsvm").parse_lines(lines))
    _assert_batches_equal(tb, jtp.parse_libsvm(lines))


def test_libsvm_reference_strictness_bit_equal():
    lines = ["1 3:1 2:1", "0 :2 5:", "x 1:1", "-1 1:1e400000000000000000000000000000000000000000000000000000000000000",
             "1 00000000000000000000000000007:1.5", "1 -3:2", "1 18446744073709551617:1", "", "1\t4:2\r"]
    _assert_batches_equal(ttp.parse_libsvm(lines), jtp.parse_libsvm(lines))


def _criteo_lines(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ints = [str(v) if v >= 0 else "" for v in rng.integers(-5, 200, 13)]
        if i % 7 == 0:
            ints[3] = " 0012"
        if i % 11 == 0:
            ints[5] = "-99999999999999999999"
        cats = [f"{v:08x}" if v % 5 else "ab" for v in rng.integers(0, 1 << 32, 26)]
        out.append("\t".join([str(int(rng.random() < 0.3))] + ints + cats))
    out.append("1\t2\t3")  # short line: dropped
    return out


def test_criteo_lines_bit_equal():
    lines = _criteo_lines(64, 0)
    tb = ttp.ExampleParser("criteo").parse_lines(lines)
    assert tb.n == 64 and tb.binary
    _assert_batches_equal(tb, jtp.parse_criteo(lines))
    _assert_batches_equal(tb, jtp.ExampleParser("criteo").parse_lines(lines))


def test_murmur3_bit_equal():
    from parameter_server_tpu.utils import murmur as jm
    from parameter_server_tpu_torch.utils import murmur as tm

    for s in (b"", b"a", b"abcdefgh", b"0123456789abcdef", b"0123456789abcdefXYZ" * 3):
        assert tm.murmur3_x64_128(s, 512927377) == jm.murmur3_x64_128(s, 512927377)


def test_sparse_binary_lines_bit_equal(tmp_path):
    (path,) = write_ctr_shards(str(tmp_path), 1, 300, seed=4)
    lines = pathlib.Path(path).read_text().splitlines()
    lines += ["0; 1 5 6; 2 7;", "junk", "1;x 4;", "1; 3 9 y 11;"]
    tb = ttp.ExampleParser("ps_sparse_binary").parse_lines(lines)
    assert tb.n == 303 and tb.binary
    _assert_batches_equal(tb, jtp.parse_ps_sparse_binary(lines))


def test_unported_formats_raise():
    """Only unknown names (and ``bin``, which no reader has) raise, with
    the JAX package's ``ValueError``; adfea, terafea, ps_dense and the
    record formats parse (``tests/test_torch_data_formats.py``,
    ``tests/test_torch_records.py``)."""
    with pytest.raises(ValueError):
        ttp.ExampleParser("nope")
    with pytest.raises(ValueError):
        tsr.StreamReader(["x"], "bin")
    for fmt in ("adfea", "terafea", "ps_dense"):
        assert ttp.ExampleParser(fmt).format == fmt
    assert tsr.StreamReader(["x"], "record").parser is None


# -- reader, tail filter, workload pool --


@pytest.fixture
def ctr_files(tmp_path):
    write_ctr_shards(str(tmp_path / "d"), 2, 700, seed=1, key_bits=14)
    with open(tmp_path / "d" / "part-001") as f, open(tmp_path / "d" / "part-002.gz", "wb") as g:
        import gzip

        g.write(gzip.compress(f.read().encode()))
    return str(tmp_path / "d" / "part.*")


@pytest.mark.parametrize("freq", [0, 4])
def test_minibatch_reader_with_tail_filter_matches_jax(ctr_files, freq):
    def read(mod):
        r = mod.MinibatchReader(files=[ctr_files], minibatch_size=256, data_format="ps_sparse_binary")
        if freq:
            r.init_filter(1 << 16, 2, freq)
        with r:
            return list(r)

    tb, jb = read(tlearner), read(jlearner)
    assert len(tb) == len(jb) == -(-2100 // 256)  # minibatches cross file boundaries
    for t, j in zip(tb, jb):
        _assert_batches_equal(t, j)
    if freq:
        # the filter keeps more of the later batches (counts accumulate)
        kept = [b.nnz for b in tb]
        assert kept[-2] > kept[0]


def test_stream_reader_globs_and_read_all(ctr_files):
    from parameter_server_tpu.data import stream_reader as jsr

    t = tsr.StreamReader([ctr_files], "ps_sparse_binary")
    j = jsr.StreamReader([ctr_files], "ps_sparse_binary")
    assert t.files == j.files and len(t.files) == 3
    _assert_batches_equal(t.read_all(), j.read_all())


def test_minibatch_reader_lifecycle():
    r = tlearner.MinibatchReader(batches=iter([]))
    with pytest.raises(RuntimeError, match="before start"):
        r.read()
    r.start().start()  # idempotent
    with pytest.raises(RuntimeError, match="after start"):
        r.init_filter(16, 2, 4)
    assert r.read() is None
    r.close()
    with pytest.raises(RuntimeError, match="after close"):
        r.read()
    with pytest.raises(RuntimeError, match="after close"):
        r.start()


def test_tail_filter_is_stateful_and_keeps_global_keys():
    from parameter_server_tpu.filter.frequency import FrequencyFilter as JFF
    from parameter_server_tpu_torch.filter.frequency import FrequencyFilter as TFF
    from parameter_server_tpu_torch.utils.sparse import random_sparse

    jf, tf = JFF(1 << 12, 2), TFF(1 << 12, 2)
    for seed in range(3):
        b = random_sparse(128, 300, 6, seed=seed)
        tb = tlearner.apply_tail_filter(b, tf, 3)
        jb = jlearner.apply_tail_filter(b, jf, 3)
        _assert_batches_equal(tb, jb)
        assert set(tb.indices.tolist()) <= set(b.indices.tolist())


@pytest.mark.parametrize("shuffle", [False, True])
def test_workload_pool_same_order(shuffle):
    files = [f"part-{i}" for i in range(5)]
    random.seed(3)
    pool = jpool.WorkloadPool(jpool.Workload(files=files, replica=3, shuffle=shuffle))
    want = []
    while (w := pool.assign("W0")) is not None:
        want.append((w.id, w.files))
        pool.finish(w.id)
    random.seed(3)
    pool = tpool.WorkloadPool(tpool.Workload(files=files, replica=3, shuffle=shuffle))
    got = []
    while (w := pool.assign()) is not None:
        got.append((w.id, w.files))
    assert got == want and len(got) == 15
    assert pool.assign() is None


# -- the CLI --


def _cli_conf(tmp_path, **sgd):
    write_ctr_shards(str(tmp_path / "train"), 2, 1500, seed=0, key_bits=16)
    sgd = dict(dict(num_slots=4096, countmin_n=1 << 16, num_data_pass=3), **sgd)
    text = ctr_conf(str(tmp_path / "train" / "part.*"), str(tmp_path / "model" / "ctr"), **sgd)
    conf = tmp_path / "ctr.conf"
    conf.write_text(text)
    return conf, text


def _read_model(path, num_slots):
    lines = pathlib.Path(path).read_text().splitlines()
    assert lines[0] == f"#hashed\t{num_slots}"
    w = np.zeros(num_slots, np.float32)
    for line in lines[1:]:
        slot, val = line.split("\t")
        w[int(slot)] = float(val)
    return w, len(lines) - 1


def test_cli_runs_the_ctr_conf(tmp_path, capsys):
    conf, text = _cli_conf(tmp_path)
    write_ctr_shards(str(tmp_path / "test"), 1, 500, seed=9, key_bits=16)
    conf.write_text(text + f'validation_data {{\n  format: TEXT\n  text: SPARSE_BINARY\n'
                           f'  file: "{tmp_path / "test" / "part.*"}"\n}}\n')
    assert tmain.main([str(conf), "--verbose"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "examples" in out and "model written to" in out
    assert out.count("workload ") == 3  # num_data_pass pieces of the one pattern
    auc = float(out.split("validation auc: ")[1].split(",")[0])
    assert 0.5 < auc <= 1.0
    w, nnz = _read_model(tmp_path / "model" / "ctr_S0", 4096)
    assert 0 < nnz < 4096 and np.all(np.isfinite(w))


def test_cli_without_the_push_filter_matches_a_jax_worker(tmp_path):
    conf, text = _cli_conf(tmp_path)
    text = text.replace("  push_filter {\n    type: FIXING_FLOAT\n    num_bytes: 1\n  }\n", "")
    assert "FIXING_FLOAT" not in text
    conf.write_text(text)
    random.seed(0)
    assert tmain.main([str(conf)], device="cpu") == 0
    w_port, _ = _read_model(tmp_path / "model" / "ctr_S0", 4096)

    # the JAX side: its own reader, tail filter and pool, the same conf;
    # padding pinned up front (the JAX worker keeps the first batch's nnz
    # padding and raises on a later, less-filtered batch)
    jconf = jcfg.parse_conf(text)
    jconf.async_sgd.nnz_pad = 1 << 16
    Postoffice.reset()
    try:
        mesh = meshlib.make_mesh(num_data=1, num_server=1, devices=jax.devices()[:1])
        jw = jsgd.AsyncSGDWorker(jconf, mesh=mesh)
        random.seed(0)
        s = jconf.async_sgd
        pool = jpool.WorkloadPool(jpool.Workload(files=jconf.training_data.file,
                                                 replica=s.num_data_pass, shuffle=True))
        while (load := pool.assign("W0")) is not None:
            r = jlearner.MinibatchReader(files=load.files, minibatch_size=s.minibatch,
                                         data_format="ps_sparse_binary")
            r.init_filter(s.countmin_n, s.countmin_k, s.tail_feature_freq)
            with r:
                jw.train(iter(r), pipelined=False)
            pool.finish(load.id)
        w_jax = jw.weights_dense()
    finally:
        Postoffice.reset()
    assert np.count_nonzero(w_port) > 100
    np.testing.assert_allclose(w_port, w_jax, **TRAJ_TOL)


def test_jax_worker_raises_where_the_port_grows_its_padding(tmp_path):
    """The divergence the port repairs: the tail filter keeps more keys
    in later minibatches than in the first, which pinned the padding.
    Twenty 1000-row minibatches of keys from 2^24 through one filter."""
    write_ctr_shards(str(tmp_path / "train"), 1, 20_000, seed=2)
    text = ctr_conf(str(tmp_path / "train" / "part.*"), str(tmp_path / "m"), num_slots=4096,
                    minibatch=1000, num_data_pass=1)
    r = tlearner.MinibatchReader(files=[str(tmp_path / "train" / "part.*")], minibatch_size=1000,
                                 data_format="ps_sparse_binary")
    r.init_filter(1 << 20, 2, 4)
    with r:
        batches = list(r)
    first_pad = -(-int(batches[0].nnz * 1.25) // 4096) * 4096
    assert max(b.nnz for b in batches) > first_pad
    Postoffice.reset()
    try:
        mesh = meshlib.make_mesh(num_data=1, num_server=1, devices=jax.devices()[:1])
        jw = jsgd.AsyncSGDWorker(jcfg.parse_conf(text), mesh=mesh)
        with pytest.raises(ValueError, match="exceeds padding"):
            for b in batches:
                jw.prep(b, device_put=False)
    finally:
        Postoffice.reset()
    from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDWorker

    tw = AsyncSGDWorker(tcfg.parse_conf(text), device="cpu")
    prepped = [tw.prep(b, device_put=False) for b in batches]
    assert prepped[0].slots.shape[-1] == first_pad  # the JAX worker's padding while it fits
    assert tw._pads[1] >= max(b.nnz for b in batches)


def test_bigtable_conf_cli_line_matches_jax(tmp_path, capsys, monkeypatch):
    """``configs/criteo/online_l1lr_bigtable.conf`` through both CLIs on
    generated Criteo text, cut to 2^20 slots (and 1024-row minibatches,
    a 2^18 count-min, and the nnz padding the JAX worker needs up front,
    C4). The sparse flip is lowered on both sides, the JAX package's
    through ``PS_SPARSE_UPDATE_MIN_SLOTS``, the port's by patching
    ``sparse_update_min_slots``, so both take the path the full conf
    takes at 2^30: the sparse update over the exact wire, T = 8 scan
    launches, bf16 √n, the tail filter, τ 4; the ``ell_lanes``/``wire``
    fields parsed and unused. The progress line (all but the wall
    seconds) is the same; the weights agree within ``TRAJ_TOL``."""
    from parameter_server_tpu.apps.linear import main as jmain
    from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
    from parameter_server_tpu_torch.benchmarks.criteo import write_criteo_shards

    write_criteo_shards(str(tmp_path / "train"), 2, 3000, seed=0)
    text = ctr_conf(str(tmp_path / "train" / "part.*"), str(tmp_path / "model" / "big"),
                    conf_text=(ROOT / "configs" / "criteo" / "online_l1lr_bigtable.conf").read_text(),
                    num_slots=1 << 20, countmin_n=1 << 18, minibatch=1024, nnz_pad=65536)
    conf = tmp_path / "big.conf"
    conf.write_text(text)
    monkeypatch.setenv("PS_SPARSE_UPDATE_MIN_SLOTS", str(1 << 20))
    monkeypatch.setattr(tsgd, "sparse_update_min_slots", lambda: 1 << 20)
    monkeypatch.setattr(tsgd, "_SAVE_CHUNK", 1 << 12)  # the model written in 256 chunks
    modes = []

    class Recording(tsgd.AsyncSGDWorker):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            modes.append((self._update_mode, self.sgd.ftrl_state_dtype, self.sgd.ell_lanes,
                          self.sgd.wire, self.sgd.steps_per_launch))

        def _submit_prepped(self, prepped, with_aux=True):
            modes.append(type(prepped).__name__)
            return super()._submit_prepped(prepped, with_aux)

    monkeypatch.setattr(tmain, "AsyncSGDWorker", Recording)
    random.seed(0)
    assert tmain.main([str(conf)], device="cpu") == 0
    port = capsys.readouterr().out.splitlines()
    os.rename(tmp_path / "model" / "big_S0", tmp_path / "model" / "port_S0")
    random.seed(0)
    Postoffice.reset()
    try:
        assert jmain.main([str(conf)]) == 0
    finally:
        Postoffice.reset()
    jax_out = capsys.readouterr().out.splitlines()
    assert modes[0] == ("sparse", "bfloat16", 39, "bits", 8)
    assert all(m == "PreppedSuperBatch" for m in modes[1:]) and len(modes) > 1
    line = port.index(" sec  examples    loss      auc   accuracy") + 1
    jline = jax_out.index(" sec  examples    loss      auc   accuracy") + 1
    assert port[line].split()[1:] == jax_out[jline].split()[1:]
    assert port[line].split()[1] == "6.00e+03"
    w_port, n_port = _read_model(tmp_path / "model" / "port_S0", 1 << 20)
    w_jax, n_jax = _read_model(tmp_path / "model" / "big_S0", 1 << 20)
    assert n_port > 1000 and abs(n_port - n_jax) <= n_jax // 1000
    np.testing.assert_allclose(w_port, w_jax, **TRAJ_TOL)
