"""PyTorch port: model evaluation against the JAX package.

The port's ``ModelEvaluation`` (``apps/linear/model_evaluation.py``) runs
with ``device="cpu"`` (the lookup and the multiply in PyTorch, the sum
by row the segment sum's CPU route, ``index_add_``), the JAX package's
on NumPy. Both add each row's entries in entry order from +0.0, so the
margins Xw and the metrics must be equal bit for bit:

- on libsvm, SPARSE_BINARY and Criteo validation files, for an
  exact-key model and a hashed one (with misses, an all-miss row, an
  empty row), an empty model and empty validation data;
- for models written by either package's training worker and scored by
  the other;
- through the CLI on every eval conf of ``configs/`` (the confs' own
  relative paths, in a directory of generated data and a model the
  port's CLI trained), against the JAX CLI's printed line.

Tolerance: none.
"""

import contextlib
import glob
import os
import pathlib
import random
import shutil

import numpy as np
import pytest
import torch

import jax

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.apps.linear import main as jmain
from parameter_server_tpu.apps.linear import model_evaluation as jme
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu.system.postoffice import Postoffice
from parameter_server_tpu.utils import evaluation as jeval
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear import main as tmain
from parameter_server_tpu_torch.apps.linear import model_evaluation as tme
from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDWorker
from parameter_server_tpu_torch.benchmarks.criteo import criteo_conf, write_criteo_shards
from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, write_ctr_shards
from parameter_server_tpu_torch.data.stream_reader import StreamReader
from parameter_server_tpu_torch.utils import evaluation as teval
from parameter_server_tpu_torch.utils.murmur import hash_slots
from parameter_server_tpu_torch.utils.sparse import random_sparse

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EVAL_CONFS = sorted(c for c in glob.glob(str(ROOT / "configs" / "*" / "eval_*.conf")))
FORMATS = {"libsvm": "LIBSVM", "ps_sparse_binary": "SPARSE_BINARY", "criteo": "CRITEO"}


@pytest.fixture(autouse=True)
def fresh_po():
    Postoffice.reset()
    yield
    Postoffice.reset()


def _conf_text(val_glob, model_glob, text="LIBSVM", fmt="TEXT"):
    return (f'validation_data {{\n  format: {fmt}\n  text: {text}\n  file: "{val_glob}"\n}}\n'
            f'model_input {{\n  format: TEXT\n  file: "{model_glob}"\n}}\n')


@contextlib.contextmanager
def _jax_margins():
    """Records the Xw the JAX package's ModelEvaluation scores (its
    metrics module's ``auc`` sees it first)."""
    seen = []
    auc = jme.evaluation.auc

    def recording_auc(y, xw):
        seen.append(np.array(xw))
        return auc(y, xw)

    jme.evaluation.auc = recording_auc
    try:
        yield seen
    finally:
        jme.evaluation.auc = auc


def _both(text):
    """(JAX metrics, JAX Xw, port metrics, port Xw) of one conf."""
    with _jax_margins() as seen:
        jm = jme.ModelEvaluation(jcfg.parse_conf(text)).run()
    ev = tme.ModelEvaluation(tcfg.parse_conf(text), device="cpu")
    tm = ev.run()
    return jm, seen[0], tm, ev.margins


def _assert_same(jm, jxw, tm, txw):
    assert jm == tm
    assert txw.dtype == jxw.dtype == np.float32
    np.testing.assert_array_equal(txw.view(np.int32), jxw.view(np.int32))


def _libsvm(path, rows):
    with open(path, "w") as f:
        for y, feats in rows:
            f.write(f"{y} " + " ".join(f"{k}:{v}" for k, v in feats) + "\n")


def _write_validation(fmt, directory, seed, rows=1500):
    """A validation file of ``fmt`` from ``seed``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    if fmt == "ps_sparse_binary":
        return write_ctr_shards(directory, 1, rows, seed, key_bits=12)[0]
    if fmt == "criteo":
        return write_criteo_shards(directory, 1, rows, seed)[0]
    rng = np.random.default_rng(seed)
    path = os.path.join(directory, "part-001")
    data = []
    for i in range(rows):
        k = np.sort(rng.choice(1000, size=int(rng.integers(0, 14)), replace=False))
        vals = rng.normal(size=k.size).astype(np.float32)
        vals[rng.random(k.size) < 0.1] = -0.0 if i % 2 else 0.0
        label = 1 if np.sum(vals * np.where(k % 7 < 3, 1.0, -0.5)) > 0 else -1
        data.append((label, list(zip(k.tolist(), (f"{v:.6g}" for v in vals)))))
    _libsvm(path, data)
    return path


def _write_model(path, keys, rng, hashed_slots=0, header_in=0):
    """``key\\tweight`` lines (weights printed with repr, as the workers
    write them); a ``#hashed`` header at line ``header_in`` if hashed."""
    lines = [f"{int(k)}\t{float(w)!r}\n" for k, w in zip(keys, rng.normal(size=len(keys)) * 0.3)]
    if hashed_slots:
        lines.insert(header_in, f"#hashed\t{hashed_slots}\n")
    with open(path, "w") as f:
        f.writelines(lines)


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("kind", ["exact", "hashed"])
def test_margins_and_metrics_bit_equal(tmp_path, fmt, kind):
    val = _write_validation(fmt, str(tmp_path / "val"), seed=3)
    b = StreamReader([val], fmt).read_all()
    rng = np.random.default_rng(5)
    if kind == "exact":  # half the data's keys, and keys it does not have
        keys = np.unique(b.indices)
        keys = np.concatenate([rng.choice(keys, keys.size // 2, replace=False),
                               rng.integers(-(1 << 62), 1 << 62, 300)])
        slots = 0
    else:
        slots = 1 << 12
        keys = rng.choice(slots, slots // 3, replace=False)
    # two shard files: a key repeated in the later one wins
    _write_model(tmp_path / "m_S0", keys[: keys.size // 2 + 20], rng, slots)
    _write_model(tmp_path / "m_S1", keys[keys.size // 2:], rng, slots, header_in=3)
    jm, jxw, tm, txw = _both(_conf_text(val, str(tmp_path / "m_S*"), FORMATS[fmt]))
    _assert_same(jm, jxw, tm, txw)
    assert tm["num_examples"] == b.n and np.count_nonzero(txw) > b.n // 3


def test_criteo_keys_past_2_63_exact_model(tmp_path):
    """Criteo keys of 2^63 and more are negative int64s: written so by
    an exact model they hit in both packages; written unsigned, the port
    takes their int64 view (the JAX package raises on such a file)."""
    val = _write_validation("criteo", str(tmp_path / "val"), seed=8, rows=400)
    b = StreamReader([val], "criteo").read_all()
    keys = np.unique(b.indices)
    assert (keys < 0).any()
    rng = np.random.default_rng(1)
    _write_model(tmp_path / "m_S0", keys, rng)
    text = _conf_text(val, str(tmp_path / "m_S0"), "CRITEO")
    jm, jxw, tm, txw = _both(text)
    _assert_same(jm, jxw, tm, txw)
    assert np.all(txw != 0)
    unsigned = [f"{int(k) % (1 << 64)}\t{w}" for k, w in
                (line.split("\t") for line in (tmp_path / "m_S0").read_text().splitlines())]
    (tmp_path / "m_S0").write_text("".join(u + "\n" for u in unsigned))
    ev = tme.ModelEvaluation(tcfg.parse_conf(text), device="cpu")
    assert ev.run() == tm
    np.testing.assert_array_equal(ev.margins.view(np.int32), txw.view(np.int32))


def test_manual_model_auc(tmp_path):
    """The JAX package's hand-built case: margins 2.0, -1.5 and 0.5."""
    (tmp_path / "model_S0").write_text("1\t2.0\n3\t-1.5\n")
    _libsvm(tmp_path / "val.libsvm", [(1, [(1, 1.0)]), (-1, [(3, 1.0)]),
                                      (1, [(1, 1.0), (3, 1.0)])])
    jm, jxw, tm, txw = _both(_conf_text(tmp_path / "val.libsvm", tmp_path / "model_S*"))
    _assert_same(jm, jxw, tm, txw)
    assert tm["auc"] == 1.0 and tm["accuracy"] == 1.0
    np.testing.assert_array_equal(txw, np.float32([2.0, -1.5, 0.5]))


@pytest.mark.parametrize("hashed", [False, True])
def test_misses_empty_rows_and_negative_zeros(tmp_path, hashed):
    """A row whose every key misses, a row with no entries and products
    of -0.0 all score +0.0, as ``np.add.at`` into zeros gives."""
    _libsvm(tmp_path / "val", [(1, [(5, -2.0), (9, 3.0)]), (-1, []), (1, [(1, -1.0)]),
                               (-1, [(1, 0.0), (2, -0.0)]), (1, [(2, 1.5)])])
    if hashed:
        s = hash_slots(np.array([1, 2], np.int64), 64)
        (tmp_path / "m").write_text(f"#hashed\t64\n{s[0]}\t0.0\n{s[1]}\t-0.5\n")
    else:
        (tmp_path / "m").write_text("1\t0.0\n2\t-0.5\n")
    jm, jxw, tm, txw = _both(_conf_text(tmp_path / "val", tmp_path / "m"))
    _assert_same(jm, jxw, tm, txw)
    assert txw[:4].view(np.int32).tolist() == [0, 0, 0, 0]  # +0.0 bits
    assert txw[4] == np.float32(-0.75)


@pytest.mark.parametrize("model", ["empty", "header only"])
def test_empty_model(tmp_path, model):
    _libsvm(tmp_path / "val", [(1, [(5, -2.0)]), (-1, [(1, 1.0)])])
    (tmp_path / "m").write_text("" if model == "empty" else "#hashed\t64\n")
    jm, jxw, tm, txw = _both(_conf_text(tmp_path / "val", tmp_path / "m"))
    _assert_same(jm, jxw, tm, txw)
    assert not txw.any()


def test_empty_validation_data(tmp_path):
    (tmp_path / "val").write_text("")
    (tmp_path / "m").write_text("1\t1.0\n")
    jm, jxw, tm, txw = _both(_conf_text(tmp_path / "val", tmp_path / "m"))
    _assert_same(jm, jxw, tm, txw)
    assert tm == {"num_examples": 0.0, "auc": 1.0, "accuracy": 0.0, "logloss": 0.0}


def test_validation_from_proto_records(tmp_path):
    """``format: PROTO`` validation data (the reference's records,
    written by ``text2record --ref-format``) scores as its text does."""
    from parameter_server_tpu_torch.data import text2record

    val = _write_validation("libsvm", str(tmp_path / "val"), seed=4, rows=600)
    text2record.convert_ref([val], "libsvm", str(tmp_path / "val.rec"))
    rng = np.random.default_rng(2)
    _write_model(tmp_path / "m", np.arange(0, 1000, 3), rng)
    jm, jxw, tm, txw = _both(_conf_text(tmp_path / "val.rec", tmp_path / "m", fmt="PROTO"))
    _assert_same(jm, jxw, tm, txw)
    text_run = _both(_conf_text(val, tmp_path / "m"))
    _assert_same(*text_run[2:], tm, txw)


def test_no_card_raises_unless_the_cpu_is_named(tmp_path):
    conf = tcfg.parse_conf(_conf_text(tmp_path / "v", tmp_path / "m"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tme.ModelEvaluation(conf)
    assert tme.ModelEvaluation(conf, device="cpu").device.type == "cpu"


def test_rmse_matches_jax():
    rng = np.random.default_rng(0)
    y = np.where(rng.random(300) < 0.5, 1.0, -1.0).astype(np.float32)
    xw = rng.normal(size=300).astype(np.float32)
    assert teval.rmse(y, xw) == jeval.rmse(y, xw)
    assert teval.rmse(y[:0], xw[:0]) == jeval.rmse(y[:0], xw[:0]) == 0.0


# -- models written by the training workers --


def _train_conf():
    conf = tcfg.Config()
    conf.penalty = tcfg.PenaltyConfig(type="l1", lambda_=[0.01])
    conf.learning_rate = tcfg.LearningRateConfig(type="decay", alpha=0.5, beta=1.0)
    conf.async_sgd = tcfg.SGDConfig(algo="ftrl", minibatch=128, num_slots=256, max_delay=0)
    return conf


def _labelled(n, seed):
    """``random_sparse`` rows (4 binary keys each, sorted within the row,
    as the libsvm file holds them) with labels from the keys."""
    b = random_sparse(n, 512, 4, seed=seed, binary=True)
    b.indices = np.sort(b.indices.reshape(n, -1), axis=1).reshape(-1)
    b.y = np.where((b.indices.reshape(n, -1) % 7 < 3).mean(1) > 0.4, 1.0, -1.0).astype(np.float32)
    return b


def _validation_libsvm(path, b):
    _libsvm(path, [(int(b.y[r]), [(int(k), 1) for k in b.indices[b.indptr[r]:b.indptr[r + 1]]])
                   for r in range(b.n)])


def test_port_trained_model_scores_alike_in_both_packages(tmp_path):
    """Train -> ``save_model`` (one ``_S0`` file, hashed) -> the port's
    and the JAX package's ModelEvaluation, bit-equal, and equal to the
    worker's own ``evaluate`` of the same rows."""
    w = AsyncSGDWorker(_train_conf(), device="cpu")
    for i in range(5):
        w.collect(w.process_minibatch(_labelled(128, i)))
    val = _labelled(200, 99)
    want = w.evaluate(val)
    w.save_model(str(tmp_path / "model"))
    _validation_libsvm(tmp_path / "val", val)
    jm, jxw, tm, txw = _both(_conf_text(tmp_path / "val", tmp_path / "model_S*"))
    _assert_same(jm, jxw, tm, txw)
    assert {k: tm[k] for k in want} == want


def test_jax_trained_model_scores_alike_in_both_packages(tmp_path):
    """A JAX worker on two server shards writes ``_S0`` and ``_S1``
    under one ``#hashed`` header each."""
    jconf = jcfg.Config()
    jconf.penalty = jcfg.PenaltyConfig(type="l1", lambda_=[0.01])
    jconf.learning_rate = jcfg.LearningRateConfig(type="decay", alpha=0.5, beta=1.0)
    jconf.async_sgd = jcfg.SGDConfig(algo="ftrl", minibatch=128, num_slots=256, max_delay=0)
    from parameter_server_tpu.utils.sparse import random_sparse as jrandom_sparse

    mesh = meshlib.make_mesh(num_data=1, num_server=2, devices=jax.devices()[:2])
    w = jsgd.AsyncSGDWorker(jconf, mesh=mesh)
    for i in range(5):
        t = _labelled(128, i)
        b = jrandom_sparse(128, 512, 4, seed=i, binary=True)
        b.indices, b.y = t.indices, t.y
        w.collect(w.process_minibatch(b))
    files = w.save_model(str(tmp_path / "model"))
    assert [os.path.basename(f) for f in files] == ["model_S0", "model_S1"]
    _validation_libsvm(tmp_path / "val", _labelled(200, 99))
    jm, jxw, tm, txw = _both(_conf_text(tmp_path / "val", tmp_path / "model_S*"))
    _assert_same(jm, jxw, tm, txw)
    assert np.count_nonzero(txw) > 100


# -- the CLI on the eval confs --

# dataset of the eval confs -> its data format
_TRAIN = {"ctr": "ps_sparse_binary", "rcv1": "libsvm", "criteo": "criteo"}


def _ids(paths):
    return [os.path.relpath(p, ROOT / "configs") for p in paths]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A model a port CLI run trained for each dataset, on the CPU, from
    the dataset's online conf (its files, model path and table sizes
    shrunk), and held-out data of the dataset's format."""
    out = {}
    for name, fmt in _TRAIN.items():
        d = tmp_path_factory.mktemp(name)
        train = _write_validation(fmt, str(d / "train"), seed=1, rows=2000)
        online = (ROOT / "configs" / name / "online_l1lr.conf").read_text()
        sgd = dict(num_slots=4096, minibatch=500, num_data_pass=1)
        if "countmin_n" in online:
            sgd["countmin_n"] = 1 << 16
        text = (criteo_conf(train, str(d / "model"), **sgd) if name == "criteo"
                else ctr_conf(train, str(d / "model"), conf_text=online, **sgd))
        (d / "train.conf").write_text(text)
        random.seed(0)
        assert tmain.main([str(d / "train.conf")], device="cpu") == 0
        val = _write_validation(fmt, str(d / "test"), seed=2, rows=1200)
        out[name] = (str(d / "model_S0"), val)
    return out


def _last_line(out: str) -> str:
    (line,) = [x for x in out.splitlines() if x.startswith("auc: ")]
    return line


@pytest.mark.parametrize("path", EVAL_CONFS, ids=_ids(EVAL_CONFS))
def test_eval_confs_match_the_jax_cli(path, trained, tmp_path, monkeypatch, capsys):
    """The conf as it is, run from a directory laid out as its relative
    paths expect: ``data/<set>/test/part-001`` and the model under the
    name its ``model_input`` pattern matches."""
    name = pathlib.Path(path).parent.name
    model, val = trained[name]
    conf = tcfg.parse_conf(open(path).read())
    (test_glob,) = conf.validation_data.file
    (model_glob,) = conf.model_input.file
    os.makedirs(tmp_path / os.path.dirname(test_glob))
    shutil.copy(val, tmp_path / os.path.dirname(test_glob) / "part-001")
    os.makedirs(tmp_path / "model")
    stem = os.path.basename(model_glob).split(".")[0].rstrip("*")  # ctr_online, ctr_batch_S
    shutil.copy(model, tmp_path / "model" / (stem.removesuffix("_S") + "_S0"))
    monkeypatch.chdir(tmp_path)
    assert tmain.main([path], device="cpu") == 0
    port = _last_line(capsys.readouterr().out)
    assert jmain.main([path]) == 0
    want = _last_line(capsys.readouterr().out)
    assert port == want
    assert "(1200 examples)" in port
    assert float(port.split(",")[0].split()[1]) > 0.5
