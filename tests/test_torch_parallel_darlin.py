"""PyTorch port: darlin and model evaluation over a (data, server) mesh,
against the JAX package's darlin on the same mesh shape.

The port's ``DarlinScheduler`` runs on meshes 1x2, 2x1 and 2x2 of one
gloo world of 4 CPU ranks (rank functions in
``tests/torch_mesh_rest_ranks.py``); the JAX ``DarlinScheduler`` on the
same shape of the suite's virtual CPU devices. Both train
``tests/test_torch_darlin.py``'s data (2000 rows, 200 columns, seeded)
with its conf, at block delay τ 0 and 2, the blocks in the same random
order (Python's ``random`` with seed 0 on every rank).

Tolerances, each with its reason:

- every rank of a mesh: the same progress lines and weights, bit for
  bit (the G and U psum gives every rank of a data group the same sum,
  and the model is replicated);
- the port's 1x2 mesh against its one-card run: **bit-equal** (one data
  rank: the psum is the identity; the server axis repeats the work);
- the JAX mesh scheduler: ``tests/test_torch_darlin.py``'s whole-run
  tolerances (each pass's objective within 1e-6 relative, nnz(w) and the
  active set equal, the violation within 1e-5 relative + 1e-6, w within
  1e-5 relative + 5e-6: XLA's CPU ``exp`` is not libm's), and the model
  files of each server shard the JAX files' keys with weights within the
  same w tolerance;
- the CLI: darlin at ``--num-workers 2`` within the same tolerances of
  the one-process CLI; model evaluation in a world of 2 prints what the
  one-process CLI prints, digit for digit.
"""

import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.apps.linear import darlin as jdarlin
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch.apps.linear import darlin as tdarlin
from parameter_server_tpu_torch.apps.linear import main as tmain
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.system.postoffice import Postoffice
from tests import torch_mesh_rest_ranks as ranks
from tests import torch_parallel_ranks as pranks
from tests.test_torch_darlin import RUN_VIO_TOL, RUN_W_TOL, make_conf, to_port

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent

CASES = [(1, 2, 0), (2, 1, 0), (2, 2, 0), (2, 1, 2), (2, 2, 2)]
IDS = [f"{d}x{s}-tau{t}" for d, s, t in CASES]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    w_true = (rng.normal(size=200) * (rng.random(200) < 0.15) * 2).astype(np.float32)
    return jsparse.random_sparse(2000, 200, 10, seed=1, w_true=w_true)


@pytest.fixture(scope="module")
def world(data, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_darlin"))
    return launch.run_world(ranks.darlin_cases, 4, args=(CASES, to_port(data), tmp),
                            device_type="cpu", timeout=300)


def _case(world, i):
    return [r[i] for r in world if r[i] is not None]


def _model(path):
    out = {}
    for line in open(path):
        k, v = line.split("\t")
        out[int(k)] = float(v)
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_darlin_mesh_matches_the_jax_mesh_scheduler(world, data, tmp_path, i):
    d, s, tau = CASES[i]
    recs = _case(world, i)
    assert sorted(r["coords"] for r in recs) == [(a, b) for a in range(d) for b in range(s)]
    for r in recs:
        assert r["progress"] == recs[0]["progress"]
        assert r["w"].tobytes() == recs[0]["w"].tobytes()
        assert r["rows"] == -(-data.n // d)
    JPostoffice.reset()
    try:
        mesh = jmesh.make_mesh(num_data=d, num_server=s, devices=jax.devices()[: d * s])
        sched = jdarlin.DarlinScheduler(make_conf(jcfg, tau=tau), mesh=mesh)
        sched.run_on(data)
        want = [sched.g_progress[k] for k in sorted(sched.g_progress)]
        jfiles = sched.save_model(str(tmp_path / "model"))
        jw = sched.solver.w
        jmargin = sched.solver.predict_margin()
    finally:
        JPostoffice.reset()
    got = recs[0]["progress"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["objective"], w.objective, rtol=1e-6)
        assert (g["nnz_w"], g["nnz_active_set"]) == (w.nnz_w, w.nnz_active_set)
        np.testing.assert_allclose(g["violation"], w.violation, **RUN_VIO_TOL)
    np.testing.assert_allclose(recs[0]["w"], jw, **RUN_W_TOL)
    np.testing.assert_allclose(recs[0]["margin"], jmargin, rtol=1e-4, atol=1e-5)
    assert [os.path.basename(f) for f in recs[0]["files"]] == \
        [os.path.basename(f) for f in jfiles] == [f"model_S{k}" for k in range(s)]
    for mine, theirs in zip(recs[0]["files"], jfiles):
        a, b = _model(mine), _model(theirs)
        assert sorted(a) == sorted(b)
        np.testing.assert_allclose([a[k] for k in b], [b[k] for k in b], **RUN_W_TOL)
    # the bounded delay holds on every rank (how many steps were still
    # running at a dispatch depends on the ranks' pace)
    assert all(1 <= r["window"] <= tau + 1 for r in recs)


def test_darlin_one_by_two_bit_equal_to_one_card(world, data):
    recs = _case(world, CASES.index((1, 2, 0)))
    Postoffice.reset()
    sched = tdarlin.DarlinScheduler(make_conf(ranks.tcfg, tau=0), device="cpu")
    try:
        sched.run_on(to_port(data))
        one = [vars(sched.g_progress[k]) for k in sorted(sched.g_progress)]
        w = sched.solver.w
    finally:
        sched.remove()
        Postoffice.reset()
    assert recs[0]["progress"] == one
    assert recs[0]["w"].tobytes() == w.tobytes()


# -- the CLI --


def _libsvm(path, data):
    lines = []
    for r in range(data.n):
        lo, hi = data.indptr[r], data.indptr[r + 1]
        vals = data.values[lo:hi] if data.values is not None else np.ones(hi - lo)
        order = np.argsort(data.indices[lo:hi])  # the parser takes ascending keys only
        feats = " ".join(f"{int(k) + 1}:{float(v):.6g}"
                         for k, v in zip(data.indices[lo:hi][order], vals[order]))
        lines.append(f"{1 if data.y[r] > 0 else 0} {feats}\n")
    Path(path).write_text("".join(lines))


def _darlin_conf_text(train, model):
    return f"""
training_data {{
  format: TEXT
  text: LIBSVM
  file: "{train}"
}}
model_output {{
  format: TEXT
  file: "{model}"
}}
loss {{ type: LOGIT }}
penalty {{ type: L1 lambda: 1 }}
learning_rate {{ type: CONSTANT alpha: 1 }}
darlin {{
  feature_block_ratio: 4
  max_pass_of_data: 8
  max_block_delay: 2
  epsilon: 1e-6
}}
"""


def _eval_conf_text(test, model_glob):
    return f"""
validation_data {{
  format: TEXT
  text: LIBSVM
  file: "{test}"
}}
model_input {{
  format: TEXT
  file: "{model_glob}"
}}
"""


def _progress(out):
    return [tuple(float(x) for x in re.findall(r"objv (\S+) rel (\S+)", line)[0])
            for line in out.splitlines() if line.startswith("iter ")]


@pytest.fixture(scope="module")
def cli_files(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("darlin_cli")
    _libsvm(tmp / "part.train", data)
    held = jsparse.random_sparse(500, 200, 10, seed=7)
    _libsvm(tmp / "part.test", held)
    return tmp


def test_darlin_cli_two_workers_within_the_one_process_cli(cli_files, capfd):
    """``--num-workers 2`` starts 2 CPU ranks (a 2x1 mesh); rank 0 prints
    the progress lines, the one-process CLI's within the whole-run
    tolerance, and the two shard-less runs write one model file each,
    the same keys and weights within the w tolerance."""
    outs = {}
    for name, flags in (("one", []), ("mesh", ["--num-workers", "2"])):
        conf = cli_files / f"{name}.conf"
        conf.write_text(_darlin_conf_text(cli_files / "part.train", cli_files / name / "model"))
        Postoffice.reset()
        assert tmain.main([str(conf), *flags], device="cpu") == 0
        outs[name] = capfd.readouterr().out
    assert "starting 2 ranks on cpu over gloo" in outs["mesh"]
    one, mesh = _progress(outs["one"]), _progress(outs["mesh"])
    assert len(one) == len(mesh) > 1
    np.testing.assert_allclose([m[0] for m in mesh], [o[0] for o in one], rtol=1e-6)
    a, b = _model(cli_files / "mesh" / "model_S0"), _model(cli_files / "one" / "model_S0")
    assert sorted(a) == sorted(b)
    np.testing.assert_allclose([a[k] for k in b], [b[k] for k in b], **RUN_W_TOL)


def test_model_evaluation_in_a_world_prints_what_one_card_prints(cli_files, capfd):
    """The eval conf on the one-process CLI's darlin model, in the
    launcher's world of 2 ranks and in one process: rank 0 alone
    evaluates and prints the same AUC, accuracy and log loss."""
    model = cli_files / "evalmodel" / "model"
    conf = cli_files / "train_for_eval.conf"
    conf.write_text(_darlin_conf_text(cli_files / "part.train", model))
    Postoffice.reset()
    assert tmain.main([str(conf)], device="cpu") == 0
    capfd.readouterr()
    ev = cli_files / "eval.conf"
    ev.write_text(_eval_conf_text(cli_files / "part.test", f"{model}_S.*"))
    Postoffice.reset()
    assert tmain.main([str(ev)], device="cpu") == 0
    one = capfd.readouterr().out
    codes = launch.run_world(pranks.linear_cli, 2, args=([str(ev)],), device_type="cpu",
                             timeout=120)
    world_out = capfd.readouterr().out
    assert codes == [0, 0]
    lines = [line for line in one.splitlines() if "auc" in line]
    assert len(lines) == 1
    assert [line for line in world_out.splitlines() if "auc" in line] == lines
