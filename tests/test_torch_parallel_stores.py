"""PyTorch port: the A10 stores and the embedding workers over a 2 x 2
(data, server) mesh against the JAX package's on the same mesh shape:
``FMWorker`` and ``DeepCTRWorker`` (``tests/test_fm.py`` /
``tests/test_deep_ctr.py``'s mesh cases), ``KVMap``
(``tests/test_parameter.py``'s), ``KVLayer`` (placement, push, pull),
``NNTrainer`` (``tests/test_nn_parallel.py:37-96``) and the NN CLI's
``--num-servers``.

The port's side runs in one gloo world of 4 CPU ranks (rank functions
in ``tests/torch_mesh_apps_ranks.py``), the JAX side in the test process
on 4 of the suite's 8 virtual CPU devices, on the same seeded inputs.

Tolerances, each with its reason:

- FM and wide&deep: the port starts from the JAX worker's initial
  whole state (each rank its shard; the V draws of ``jax.random`` and a
  ``torch.Generator`` differ); trained states and progress within
  ``STATE_RTOL`` of each leaf's scale, as the one-card tests
  (``tests/test_torch_fm.py``: the forward's sums may be reduced in
  another order by XLA); on the JAX worker's final state the mesh's
  ``predict_margin`` is **bit-equal** (the same float64 host forward
  over the gathered table) and ``evaluate`` equal; the port's own fresh
  ``V`` on each rank is the one-card draw's rows, bit for bit;
- ``KVMap``: tables, pulls and the written file **bit-equal** (each
  shard adds its owned rows in entry order, as the JAX shard does);
- ``KVLayer``: the placement decisions equal; pulls within
  ``UPDATER_RTOL`` of each layer's scale (``w - lr * g``: a fused
  multiply-add in XLA, two roundings in torch; after a few pushes an
  entry near cancellation is a few ulps of the scale apart, more than
  ``UPDATER_RTOL`` of itself);
- ``NNTrainer``: from the flax init, losses over steps and the final
  parameters within ``LOSS_RTOL`` (``tests/test_torch_nn.py``'s
  reasons), accuracies equal; a checkpoint round trip's next loss
  within 1e-6 relative (the JAX test's);
- the NN CLI at ``--num-servers 2 --num-workers 2`` against the port's
  one-card CLI: losses within ``LOSS_RTOL`` (the gradient is averaged
  over two data rows instead of summed over one batch), accuracies
  equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.apps.linear.deep_ctr import DeepCTRWorker as JDC
from parameter_server_tpu.apps.linear.fm import FMWorker as JFM
from parameter_server_tpu.apps.nn.trainer import NNTrainer as JTrainer
from parameter_server_tpu.models import convnet as jconv
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.parallel.mesh import SERVER_AXIS as JSERVER
from parameter_server_tpu.parameter import kv_layer as jlayer
from parameter_server_tpu.parameter import kv_map as jmap
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear.deep_ctr import DeepCTRWorker
from parameter_server_tpu_torch.apps.linear.fm import FMWorker
from parameter_server_tpu_torch.apps.nn import main as tnn_main
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.system.postoffice import Postoffice
from tests import torch_mesh_apps_ranks as mranks
from tests.test_torch_fm import (STATE_RTOL, assert_states_close, bits, make_conf,
                                 random_batches)
from tests.test_torch_kv_map_layer import UPDATER_RTOL
from tests.test_torch_nn import LOSS_RTOL, blobs

torch.set_num_threads(1)

FM_CONF = dict(num_slots=257, lanes=4, lambda1=0.01)
FM_KW = dict(k=4, v_init_std=0.1, seed=3)
DEEP_CONF = dict(num_slots=257, lanes=4, alpha=0.1)
DEEP_KW = dict(k=4, hidden=(16, 8), v_init_std=0.3, seed=3)
LAYER_SHAPES = {"a": (8, 3), "b": (3, 4), "c": (2,), "d": (5, 3)}
NN_CASES = {"mlp": (4, (16,)), "convnet": (4, (16, 16, 3))}


def _mesh22():
    return jmesh.make_mesh(num_data=2, num_server=2, devices=jax.devices()[:4])


def _jax_embedding(jcls, conf_kw, kw, train, eval_batch):
    """The JAX worker on 2 x 2: its initial and final whole states, its
    progress after each batch, and its margins and evaluation."""
    JPostoffice.reset()
    j = jcls(make_conf(jcfg, **conf_kw), mesh=_mesh22(), **kw)
    whole = jax.tree.map(np.asarray, j.state_host()["state"])
    progress = [mranks._progress(j.collect(j.process_minibatch(b))) for b in train]
    final = jax.tree.map(np.asarray, j.state_host()["state"])
    out = {"whole": whole, "final": final, "progress": progress,
           "margins": j.predict_margin(eval_batch), "evaluate": j.evaluate(eval_batch)}
    j.executor.stop()
    JPostoffice.reset()
    return out


def _kv_map_cases():
    rng = np.random.default_rng(7)

    def pushes(n_push, n_keys, key_space, k):
        out = []
        for _ in range(n_push):
            keys = rng.integers(0, key_space, n_keys)
            vals = (rng.normal(size=(n_keys, k)) * np.exp(rng.normal(size=(n_keys, 1)) * 3))
            out.append((keys, vals.astype(np.float32)))
        return out

    exact = np.array([5, 10, 20, 33, 41, 57], np.int64)
    return [
        ("add", 4, 257, None, pushes(5, 300, 1 << 30, 4), rng.integers(0, 1 << 30, 64)),
        ("assign", 4, 257, None, pushes(3, 200, 1 << 30, 4), rng.integers(0, 1 << 30, 64)),
        ("assign", 1, 32, exact, [(np.array([5, 20, 99]), np.array([[1.0], [2.0], [3.0]],
                                                                     np.float32))],
         np.array([5, 10, 20, 99])),
        ("add", 2, 32, exact, [(np.array([41, 5, 41]), np.ones((3, 2), np.float32))] * 2,
         np.array([5, 41, 57])),
    ]


def _layer_case():
    rng = np.random.default_rng(9)
    grads = [(key, rng.normal(size=shape).astype(np.float32))
             for _ in range(3) for key, shape in LAYER_SHAPES.items()]
    return 4, 0.037, LAYER_SHAPES, grads


def _jax_stores(map_cases, layer_case):
    JPostoffice.reset()
    mesh = _mesh22()
    maps = []
    for entry, k, num_slots, keys, pushes, probe in map_cases:
        e = {"assign": jmap.AssignEntry, "add": jmap.AddEntry}[entry]()
        m = jmap.KVMap(e, mesh=mesh, k=k, num_slots=num_slots, keys=keys, name="j")
        for pk, pv in pushes:
            m.wait(m.push(m.request(), pk, pv))
        maps.append({"table": m.get_replica()["value"], "values": m.values(probe)})
        m.executor.stop()
    thr, lr, shapes, grads = layer_case
    layer = jlayer.KVLayer(partition_thr=thr, updater=jlayer.SGDUpdater(lr=lr), mesh=mesh)
    rec = {"specs": {}, "pulls": {}}
    for key, shape in shapes.items():
        layer.init_layer(key, shape)
        rec["specs"][key] = tuple(layer._sharding(shape).spec)
    for key, g in grads:
        layer.wait(layer.push(layer.request(), key, jnp.asarray(g)))
        rec["pulls"].setdefault(key, []).append(
            np.asarray(layer.wait_pull(layer.pull(layer.request(), key))))
    key, g = grads[0]
    rec["push_pull"] = np.asarray(layer.wait_pull(layer.push_pull(layer.request(), key,
                                                                 jnp.asarray(g))))
    rec["replica"] = layer.get_replica()
    layer.executor.stop()
    JPostoffice.reset()
    return maps, rec


def _nn_models(name, classes):
    if name == "mlp":
        return jconv.MLP(num_classes=classes)
    return jconv.ConvNet(num_classes=classes, width=8)


def _jax_nn(steps_batches, probe):
    out = {}
    for name, (classes, shape) in NN_CASES.items():
        JPostoffice.reset()
        jt = JTrainer(_nn_models(name, classes), input_shape=shape, mesh=_mesh22())
        params = convert.nn_params_from_flax(jt.state_host()["params"], "cpu")
        metrics = [jt.train_step(x, y) for x, y in steps_batches[name]]
        out[name] = {"init": {k: v.numpy() for k, v in params.items()}, "metrics": metrics,
                     "evaluate": jt.evaluate(*probe[name]), "n_layers": len(jt.kv.layers),
                     "params": convert.nn_params_from_flax(jt.state_host()["params"], "cpu")}
        jt.kv.executor.stop()
        JPostoffice.reset()
    return out


@pytest.fixture(scope="module")
def runs():
    fm_train = random_batches(3, 3, 48, 4, ragged=True)
    fm_eval = random_batches(8, 1, 200, 4, ragged=True)[0]
    deep_train = random_batches(21, 3, 48, 4, ragged=True)
    deep_eval = random_batches(9, 1, 120, 4, ragged=False)[0]
    jfm = _jax_embedding(JFM, FM_CONF, FM_KW, [j for j, _ in fm_train], fm_eval[0])
    jdeep = _jax_embedding(JDC, DEEP_CONF, DEEP_KW, [j for j, _ in deep_train], deep_eval[0])
    map_cases, layer_case = _kv_map_cases(), _layer_case()
    jmaps, jlayer_rec = _jax_stores(map_cases, layer_case)
    steps_batches = {name: [blobs(10 + i, 32, shape, classes) for i in range(3)]
                     for name, (classes, shape) in NN_CASES.items()}
    probe = {name: blobs(99, 64, shape, classes) for name, (classes, shape) in NN_CASES.items()}
    jnn = _jax_nn(steps_batches, probe)
    nn_cases = [(name, classes, shape, jnn[name]["init"])
                for name, (classes, shape) in NN_CASES.items()]
    port = launch.run_world(
        mranks.stores_world, 4,
        args=((make_conf(tcfg, **FM_CONF), FM_KW, jfm["whole"], [t for _, t in fm_train],
               jfm["final"], fm_eval[1]),
              (make_conf(tcfg, **DEEP_CONF), DEEP_KW, jdeep["whole"], [t for _, t in deep_train],
               jdeep["final"], deep_eval[1]),
              (map_cases, layer_case), (nn_cases, steps_batches, probe)),
        device_type="cpu", timeout=300)
    return {"fm": jfm, "deep": jdeep, "maps": jmaps, "layer": jlayer_rec, "nn": jnn,
            "map_cases": map_cases, "port": port}


def _whole(recs, part, key):
    shards = sorted((r[part]["coords"][1], r[part][key]) for r in recs
                    if r[part]["coords"][0] == 0)
    return convert.unshard_state([st for _, st in shards])


@pytest.mark.parametrize("part,cls,conf_kw,kw", [("fm", FMWorker, FM_CONF, FM_KW),
                                                 ("deep", DeepCTRWorker, DEEP_CONF, DEEP_KW)])
def test_embedding_worker_on_a_mesh_matches_the_jax_mesh_worker(runs, part, cls, conf_kw, kw):
    want, recs = runs[part], runs["port"]
    assert sorted(r[part]["coords"] for r in recs) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in recs:
        for a, b in zip(r[part]["progress"], want["progress"]):
            assert a[0] == b[0]
            np.testing.assert_allclose(a[1:], b[1:], rtol=STATE_RTOL)
        assert np.array_equal(bits(r[part]["margins"]), bits(want["margins"]))
        assert r[part]["evaluate"] == want["evaluate"]
        assert r[part]["recovered"] is False
    assert_states_close(want["final"], _whole(recs, part, "trained"))
    # the wipe zeroes server shard 1's rows on its ranks only
    for r in recs:
        table = r[part]["wiped"]["table"] if part == "deep" else r[part]["wiped"]
        for name in ("w", "w_ss", "v", "v_ss"):
            zero = not np.any(table[name])
            assert zero == (r[part]["coords"][1] == 1), (name, r[part]["coords"])
    # each rank's fresh V: the rows of the one-card draw from the seed
    Postoffice.reset()
    one = cls(make_conf(tcfg, **conf_kw), device="cpu", **kw)
    v = one.table()["v"].numpy()
    one.executor.stop()
    Postoffice.reset()
    rows = -(-conf_kw["num_slots"] // 2)
    assert v.shape[0] == conf_kw["num_slots"]  # one card pads to one shard
    for r in recs:
        s = r[part]["coords"][1]
        fresh = r[part]["fresh"]["table"] if part == "deep" else r[part]["fresh"]
        np.testing.assert_array_equal(fresh["v"][: max(0, min(rows, v.shape[0] - s * rows))],
                                      v[s * rows:(s + 1) * rows])


@pytest.mark.parametrize("i", range(4), ids=["add-hashed", "assign-hashed", "assign-exact",
                                             "add-exact"])
def test_kv_map_on_a_mesh_bit_equal_to_the_jax_store(runs, i, tmp_path):
    entry, k, num_slots, keys, pushes, probe = runs["map_cases"][i]
    want = runs["maps"][i]
    recs = [r["kv"] for r in runs["port"]]
    for r in recs:
        m = r["maps"][i]
        assert m["rows"] == want["table"].shape[0] // 2  # this rank's shard
        assert np.array_equal(bits(m["table"]), bits(want["table"]))
        assert np.array_equal(bits(m["values"]), bits(np.asarray(want["values"])))
        assert np.array_equal(bits(m["round_trip"]), bits(m["values"]))
        assert (m["file"] is None) == (r["coords"] != (0, 0))
    # rank 0's file is the JAX store's, written from the same table
    JPostoffice.reset()
    try:
        e = {"assign": jmap.AssignEntry, "add": jmap.AddEntry}[entry]()
        j = jmap.KVMap(e, mesh=_mesh22(), k=k, num_slots=num_slots, keys=keys, name="j")
        j.set_replica({"value": want["table"]})
        j.write_to_file(str(tmp_path / "j.txt"))
        j.executor.stop()
    finally:
        JPostoffice.reset()
    assert recs[0]["maps"][i]["file"] == (tmp_path / "j.txt").read_text()


def _close_to_scale(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= UPDATER_RTOL * scale, (got, want)


def test_kv_layer_on_a_mesh_matches_the_jax_store(runs):
    want = runs["layer"]
    for r in (x["kv"] for x in runs["port"]):
        got = r["layer"]
        for key, shape in LAYER_SHAPES.items():
            spec = want["specs"][key]
            jdim = spec.index(JSERVER) if JSERVER in spec else None
            assert got["dims"][key] == jdim, key
            block = list(shape)
            if jdim is not None:
                block[jdim] //= 2
            assert got["blocks"][key] == tuple(block), key
            for a, b in zip(got["pulls"][key], want["pulls"][key]):
                _close_to_scale(a, b)
        _close_to_scale(got["push_pull"], want["push_pull"])
        for key, arr in want["replica"].items():
            _close_to_scale(got["replica"][key], np.asarray(arr))
            assert np.array_equal(got["set_back"][key], 2 * got["replica"][key])
    assert {key: d for key, d in runs["port"][0]["kv"]["layer"]["dims"].items()} == {
        "a": 0, "b": 1, "c": None, "d": None}


@pytest.mark.parametrize("name", sorted(NN_CASES))
def test_nn_trainer_on_a_mesh_matches_the_jax_trainer(runs, name):
    want = runs["nn"][name]
    i = list(NN_CASES).index(name)
    for r in runs["port"]:
        got = r["nn"]["cases"][i]
        assert got["n_layers"] == want["n_layers"]
        for step, (mt, mj) in enumerate(zip(got["metrics"], want["metrics"])):
            assert mt["loss"] == pytest.approx(mj["loss"], rel=LOSS_RTOL), step
            assert mt["accuracy"] == mj["accuracy"], step
        assert got["evaluate"]["loss"] == pytest.approx(want["evaluate"]["loss"], rel=LOSS_RTOL)
        assert got["evaluate"]["accuracy"] == want["evaluate"]["accuracy"]
        for key, p in got["params"].items():
            back = want["params"][key].numpy()
            scale = float(np.abs(back).max())
            assert float(np.abs(p - back).max()) <= LOSS_RTOL * scale, key
            assert np.array_equal(got["replica"][key], p), key  # the store's whole layer
        np.testing.assert_allclose(got["next"][1], got["next"][0], rtol=1e-6)
        # every rank holds the same parameters (one update, replicated)
        ref = runs["port"][0]["nn"]["cases"][i]["params"]
        assert all(np.array_equal(got["params"][k], ref[k]) for k in ref)


def _cli_rows(argv, capfd):
    Postoffice.reset()
    assert tnn_main.main(argv) == 0
    out = capfd.readouterr().out
    return [ln for ln in out.splitlines() if ln[:1] == " " or ln.startswith("step")]


def test_nn_cli_num_servers_runs_a_mesh_and_matches_one_card(capfd):
    """``--num-servers 2 --num-workers 2`` starts a world of 4 ranks, rank
    0 printing the rows: the one-card CLI's within ``LOSS_RTOL``."""
    argv = ["--steps", "6", "--report-every", "2", "--batch", "64", "--device", "cpu"]
    one = _cli_rows(argv, capfd)
    mesh = _cli_rows(argv + ["--num-servers", "2", "--num-workers", "2"], capfd)
    Postoffice.reset()
    assert len(one) == len(mesh) == 4 and one[0] == mesh[0]
    for a, b in zip(one[1:], mesh[1:]):
        sa, sb = a.split(), b.split()
        assert sa[0] == sb[0] and sa[2] == sb[2]
        assert float(sb[1]) == pytest.approx(float(sa[1]), rel=LOSS_RTOL, abs=1e-5)


@pytest.mark.parametrize("cli", ["nn", "linear"])
def test_clis_run_as_modules_start_their_worlds(cli, tmp_path):
    """``python -m ...apps.{nn,linear}.main --num-servers 2 --device cpu``
    as a user runs it: the ranks it starts import the CLI by its module
    name (a run's ``__main__`` is not importable in a rank), train, and
    rank 0 prints; exit 0."""
    import os
    import subprocess
    import sys

    from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, write_ctr_shards

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if cli == "nn":
        argv = ["--steps", "2", "--report-every", "1"]
    else:
        write_ctr_shards(str(tmp_path / "train"), 1, 2000, seed=0, key_bits=12)
        conf = tmp_path / "c.conf"
        conf.write_text(ctr_conf(str(tmp_path / "train" / "part.*"), str(tmp_path / "model"),
                                 num_slots=4096, countmin_n=4096, num_data_pass=1))
        argv = [str(conf)]
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-m", f"parameter_server_tpu_torch.apps.{cli}.main",
                           *argv, "--num-servers", "2", "--device", "cpu"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "starting 2 ranks on cpu over gloo" in proc.stdout
    if cli == "nn":
        assert proc.stdout.splitlines()[-1].split()[0] == "2"
    else:
        assert "model written to" in proc.stdout and (tmp_path / "model_S1").exists()
