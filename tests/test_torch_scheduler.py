"""PyTorch port: the system layer's schedulers and the linear CLI through
them, against the JAX package, on the CPU.

- ``NodeGroups`` and ``Env.from_env`` (``PS_*`` variables set) equal the
  JAX package's.
- ``App.create`` returns, for every conf under ``configs/``, the port's
  counterpart of the class the JAX package's returns (darlin, then
  async_sgd, then validation alone); a conf with none of them raises.
- ``ISGDScheduler.show_progress`` prints the JAX scheduler's text for the
  same progress reports; ``AsyncSGDScheduler``'s pool hands out the JAX
  pool's workloads in the same order.
- ``ModelEvaluation`` is an ``App``, and its printed line is the JAX
  package's on the same model and data.
- The linear CLI on the CTR conf at a small size (the quantized push
  filter removed, whose noise differs by design), the printer's interval
  set longer than the run: its progress lines, all but the ``sec``
  column, equal the JAX CLI's within the worker-parity tolerance
  (``rtol=1e-5, atol=1e-6`` plus one unit of the printed digit); the
  model file is, byte for byte, the one the CLI wrote before it went
  through the scheduler (its old loop, run here on the same conf).
- A worker declared dead hands its unfinished workloads back to the
  scheduler's pool.
"""

import contextlib
import dataclasses
import glob
import io
import pathlib
import random
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.apps import registry as jregistry
from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.apps.linear import main as jmain
from parameter_server_tpu.learner import sgd as jlearner
from parameter_server_tpu.system import env as jenv
from parameter_server_tpu.system.executor import NodeGroups as JNodeGroups
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch.apps import registry as tregistry
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear import main as tmain
from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDScheduler, AsyncSGDWorker
from parameter_server_tpu_torch.apps.linear.model_evaluation import ModelEvaluation
from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, eval_conf, write_ctr_shards
from parameter_server_tpu_torch.learner import sgd as tlearner
from parameter_server_tpu_torch.learner.workload_pool import Workload, WorkloadPool
from parameter_server_tpu_torch.system import env as tenv
from parameter_server_tpu_torch.system.customer import App
from parameter_server_tpu_torch.system.executor import NodeGroups
from parameter_server_tpu_torch.system.postoffice import Postoffice

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFS = sorted(glob.glob(str(ROOT / "configs" / "*" / "*.conf")))
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
PUSH_FILTER = "  push_filter {\n    type: FIXING_FLOAT\n    num_bytes: 1\n  }\n"


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    Postoffice.reset()
    JPostoffice.reset()


def test_node_groups_equal_the_jax_packages():
    names = [n for n in vars(JNodeGroups) if n.endswith("_GROUP")]
    assert len(names) == 6
    assert {n: getattr(NodeGroups, n) for n in names} == {n: getattr(JNodeGroups, n)
                                                          for n in names}
    assert sorted(n for n in vars(NodeGroups) if n.endswith("_GROUP")) == sorted(names)


@pytest.mark.parametrize("env", [{}, dict(PS_NUM_SERVERS="2", PS_NUM_WORKERS="3",
                                          PS_COORDINATOR_ADDRESS="127.0.0.1:1234",
                                          PS_PROCESS_ID="1", PS_NUM_PROCESSES="2",
                                          PS_VERBOSE="1")])
def test_env_from_env_equals_the_jax_packages(env, monkeypatch):
    for name in ("PS_NUM_SERVERS", "PS_NUM_WORKERS", "PS_COORDINATOR_ADDRESS", "PS_PROCESS_ID",
                 "PS_NUM_PROCESSES", "PS_VERBOSE"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = tenv.Env.from_env(), jenv.Env.from_env()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(tenv.Env()) == dataclasses.asdict(jenv.Env())


@pytest.mark.parametrize("path", CONFS, ids=[str(pathlib.Path(p).relative_to(ROOT / "configs"))
                                             for p in CONFS])
def test_app_create_returns_the_counterpart_class(path):
    text = open(path).read()
    JPostoffice.instance().start(num_data=1, num_server=1)  # the JAX darlin solver's mesh
    Postoffice.instance().start(device="cpu")
    theirs = jregistry.create_app(jcfg.parse_conf(text))
    ours = App.create(tcfg.parse_conf(text), device="cpu")
    assert isinstance(ours, App)
    assert type(ours).__name__ == type(theirs).__name__
    assert type(ours).__name__ in ("DarlinScheduler", "AsyncSGDScheduler", "ModelEvaluation")
    assert type(tregistry.create_app(tcfg.parse_conf(text), device="cpu")) is type(ours)


def test_app_create_refuses_a_conf_that_selects_no_app():
    conf = tcfg.parse_conf('training_data {\n  format: TEXT\n  text: LIBSVM\n  file: "x"\n}\n')
    with pytest.raises(ValueError, match="selects no app"):
        App.create(conf, device="cpu")


def _progress(pkg, objective, num_ex, acc, auc):
    cls = jlearner.SGDProgress if pkg == "jax" else tlearner.SGDProgress
    return cls(objective=list(objective), num_examples_processed=num_ex, accuracy=list(acc),
               auc=list(auc))


def test_show_progress_prints_the_jax_schedulers_text():
    rng = np.random.default_rng(0)
    windows = []
    for w in range(4):
        nodes = {}
        for node in ("W0", "W1")[: 1 + w % 2]:
            k = int(rng.integers(1, 4))
            nodes[node] = (rng.random(k) * 5000, int(rng.integers(1000, 20000)),
                           rng.random(k), rng.random(k) if w != 2 else [])
        windows.append((float(rng.random() * 100), nodes))
    windows.insert(1, (3.0, {}))  # an empty window prints nothing
    outs = {}
    for pkg, sched in (("jax", jlearner.ISGDScheduler()), ("port", tlearner.ISGDScheduler())):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            for elapsed, nodes in windows:
                progress = {n: _progress(pkg, *v) for n, v in nodes.items()}
                sched.show_progress(elapsed, progress)
                assert all(not p.objective and p.num_examples_processed == 0
                           for p in progress.values())
        outs[pkg] = buf.getvalue()
    assert outs["port"] == outs["jax"]
    assert outs["port"].count(" sec  examples    loss      auc   accuracy") == 1
    assert len(outs["port"].splitlines()) == 5


def test_monitor_merges_reports_into_one_line():
    sched = tlearner.ISGDScheduler()
    sched.monitor.set_printer(sched.show_progress, interval=1e9)
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        sched.monitor.report("W0", _progress("port", [10.0], 100, [0.5], [0.6]))
        sched.monitor.report("W0", _progress("port", [30.0], 100, [0.7], [0.8]))
        sched.monitor.report("W1", _progress("port", [20.0], 200, [0.9], []))
        sched.monitor.maybe_print(force=True)
    rows = [ln.split() for ln in lines.getvalue().splitlines()[1:]]
    # the first report prints at once; the forced line merges the rest
    assert [r[1:] for r in rows] == [["1.00e+02", "0.10000", "0.6000", "0.5000"],
                                     ["4.00e+02", "0.16667", "0.8000", "0.8000"]]


def _write_data(tmp_path, rows=1500, files=2):
    return write_ctr_shards(str(tmp_path / "train"), files, rows, seed=0, key_bits=16)


def test_async_sgd_scheduler_pool_equals_the_jax_schedulers(tmp_path):
    files = [str(tmp_path / f"part.{i}") for i in range(5)]
    text = ctr_conf(str(tmp_path / "part.*"), str(tmp_path / "m"), num_data_pass=3)
    text = text.replace(f'file: "{tmp_path / "part.*"}"',
                        "\n  ".join(f'file: "{f}"' for f in files), 1)
    conf, jconf = tcfg.parse_conf(text), jcfg.parse_conf(text)
    assert conf.training_data.file == files
    got = {}
    for pkg, sched_cls, c in (("port", AsyncSGDScheduler, conf),
                              ("jax", jsgd.AsyncSGDScheduler, jconf)):
        random.seed(7)
        sched = sched_cls(c)
        assert sched.name == "async_sgd_scheduler" and sched.conf is c
        loads = []
        while (w := sched.workload_pool.assign("W0")) is not None:
            loads.append((w.id, w.files))
            sched.workload_pool.finish(w.id)
        got[pkg] = loads
    assert got["port"] == got["jax"] and len(got["port"]) == 15
    assert all(sorted(f for _, (f,) in got["port"][i:i + 5]) == files for i in (0, 5, 10))


def test_a_dead_worker_hands_its_workloads_back(tmp_path):
    text = ctr_conf(str(tmp_path / "part.*"), str(tmp_path / "m"), num_data_pass=2)
    sched = AsyncSGDScheduler(tcfg.parse_conf(text))
    po = Postoffice.instance().start(device="cpu")
    aux = po.start_aux(heartbeat_timeout=0.5)
    aux.register("async_sgd_worker")
    po.beat("async_sgd_worker")
    aux.coordinator.on_worker_dead(sched.workload_pool.restore)
    first = sched.workload_pool.assign("async_sgd_worker")
    second = sched.workload_pool.assign("async_sgd_worker")
    sched.workload_pool.finish(first.id)
    assert sched.workload_pool.assign("other") is None
    assert aux.coordinator.check(now=time.time() + 5.0) == ["async_sgd_worker"]
    again = sched.workload_pool.assign("other")
    assert again is not None and again.id == second.id  # the unfinished one only
    assert sched.workload_pool.assign("other") is None
    po.stop()


def test_model_evaluation_is_an_app_and_prints_the_jax_line(tmp_path, capsys):
    from parameter_server_tpu.apps.linear.model_evaluation import ModelEvaluation as JEval

    write_ctr_shards(str(tmp_path / "test"), 1, 700, seed=5, key_bits=12)
    rng = np.random.default_rng(0)
    keys = rng.choice(1 << 12, 300, replace=False)
    (tmp_path / "model").write_text("".join(f"{k}\t{rng.normal():.6f}\n" for k in keys))
    text = eval_conf(str(ROOT / "configs" / "ctr" / "eval_online.conf"),
                     str(tmp_path / "test" / "part.*"), str(tmp_path / "model"))
    ev = ModelEvaluation(tcfg.parse_conf(text), device="cpu")
    assert isinstance(ev, App) and ev.name == "model_evaluation"
    ev.run()
    ours = capsys.readouterr().out
    JEval(jcfg.parse_conf(text)).run()
    theirs = capsys.readouterr().out
    assert ours == theirs and ours.startswith("auc: ") and "(700 examples)" in ours


# -- the CLI through the scheduler --


def _cli_text(tmp_path, model):
    return ctr_conf(str(tmp_path / "train" / "part.*"), str(model), num_slots=4096,
                    countmin_n=1 << 16, num_data_pass=3, minibatch=500,
                    nnz_pad=1 << 16).replace(PUSH_FILTER, "")


def _progress_rows(out):
    lines = out.splitlines()
    head = lines.index(" sec  examples    loss      auc   accuracy")
    rows = []
    for line in lines[head + 1:]:
        parts = line.split()
        if len(parts) != 5:
            break
        rows.append(parts)
    return rows


def _printed_close(a: str, b: str) -> bool:
    """Two printed numbers within one unit of the last printed digit plus
    the worker-parity tolerance."""
    x, y = float(a), float(b)
    mant = a.split("e")[0]
    digits = len(mant.split(".")[1]) if "." in mant else 0
    unit = 10.0 ** ((int(a.split("e")[1]) if "e" in a else 0) - digits)
    return abs(x - y) <= unit + TRAJ_TOL["atol"] + TRAJ_TOL["rtol"] * abs(y)


def _slow_printer(monkeypatch):
    """Both schedulers' printer at an interval longer than the run: the
    first report's line, then the forced one covering the rest."""
    for mod in (tlearner, jlearner):
        monkeypatch.setattr(mod.ISGDScheduler, "run",
                            lambda self: self.monitor.set_printer(self.show_progress,
                                                                  interval=1e9))


def _pre_scheduler_cli(conf_path):
    """The linear CLI's async_sgd loop before it went through the
    scheduler: its own pool, no monitor, the model written."""
    conf = tcfg.parse_conf(open(conf_path).read())
    Postoffice.instance().start(device="cpu")
    try:
        sgd, td = conf.async_sgd, conf.training_data
        pool = WorkloadPool(Workload(files=list(td.file), replica=sgd.num_data_pass,
                                     shuffle=True))
        worker = AsyncSGDWorker(conf, device="cpu")
        while (load := pool.assign(worker.name)) is not None:
            reader = tlearner.MinibatchReader(files=load.files, minibatch_size=sgd.minibatch,
                                              data_format=td.text)
            reader.init_filter(sgd.countmin_n, sgd.countmin_k, sgd.tail_feature_freq)
            with reader:
                worker.train(iter(reader))
            pool.finish(load.id)
        worker.save_model(conf.model_output.file[0])
    finally:
        Postoffice.instance().stop()
    return worker.progress


def test_cli_progress_and_model_through_the_scheduler(tmp_path, capsys, monkeypatch):
    _write_data(tmp_path)
    _slow_printer(monkeypatch)
    reports = []
    real_report = tlearner.MonitorMaster.report

    def counting(self, node_id, progress, seq=None):
        reports.append(node_id)
        return real_report(self, node_id, progress, seq)

    monkeypatch.setattr(tlearner.MonitorMaster, "report", counting)
    port_conf = tmp_path / "port.conf"
    port_conf.write_text(_cli_text(tmp_path, tmp_path / "model" / "port"))
    random.seed(0)
    assert tmain.main([str(port_conf)], device="cpu") == 0
    port_out = capsys.readouterr().out
    jax_conf = tmp_path / "jax.conf"
    jax_conf.write_text(_cli_text(tmp_path, tmp_path / "model" / "jax"))
    random.seed(0)
    try:
        assert jmain.main([str(jax_conf), "--num-workers", "1"]) == 0
    finally:
        JPostoffice.reset()
    jax_out = capsys.readouterr().out
    ours, theirs = _progress_rows(port_out), _progress_rows(jax_out)
    # 3 passes x 2 files x 3 minibatches: the first report's line, then
    # the forced line over the other 17
    assert len(ours) == len(theirs) == 2 and len(reports) == 18
    assert set(reports) == {"async_sgd_worker"}
    assert [r[1] for r in ours] == [r[1] for r in theirs] == ["5.00e+02", "9.00e+03"]
    for o, t in zip(ours, theirs):
        for a, b in zip(o[2:], t[2:]):
            assert _printed_close(a, b), (o, t)
    assert "_print_progress" not in vars(tmain)
    # the model: what the loop without the scheduler writes, byte for byte
    old_conf = tmp_path / "old.conf"
    old_conf.write_text(_cli_text(tmp_path, tmp_path / "model" / "old"))
    random.seed(0)
    Postoffice.reset()
    old = _pre_scheduler_cli(old_conf)
    new = (tmp_path / "model" / "port_S0").read_bytes()
    assert new == (tmp_path / "model" / "old_S0").read_bytes() and len(new) > 1000
    assert old.num_examples_processed == 9000
