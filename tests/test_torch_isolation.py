"""PyTorch port: package isolation, device selection and unported options.

The port stands beside the JAX package and must not lean on it: no port
module and not ``chip_smoke.py`` may load ``jax``, ``optax`` or any module
of ``parameter_server_tpu`` (whose name is a prefix of the port's own, so
the check compares the exact name and the ``parameter_server_tpu.``
prefix). Entry points run on the CUDA device unless the caller names
another, and without a card they raise instead of running on the CPU.
Config values of features the port does not have raise
``NotImplementedError``.
"""

import dataclasses
import os
import pathlib
import pkgutil
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import parameter_server_tpu_torch as port
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.ops import ftrl as tftrl
from parameter_server_tpu_torch.ops import ftrl_sparse as tsparse

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(port.__file__).resolve().parent


def port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix=f"{port.__name__}.")
    )


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_nothing_of_jax():
    mods = port_modules()
    for m in ("apps.linear.async_sgd", "apps.linear.main", "ops.quantize",
              "filter.fixing_float", "data.text_parser", "learner.workload_pool",
              "apps.lm.main", "apps.lm.optim", "models.attention", "benchmarks.lm_train",
              "utils.concurrent", "learner.ingest", "native", "system.executor",
              "benchmarks.criteo", "apps.linear.model_evaluation", "utils.crc32c",
              "utils.recordio", "data.example", "data.ref_interop", "data.text2record",
              "data.show_example", "data.info", "data.slot_reader", "data.binmat",
              "apps.linear.darlin", "learner.bcd", "system.customer", "utils.range",
              "utils.retry", "system.faults", "system.message", "system.manager", "system.van",
              "system.postoffice", "parameter.parameter", "parameter.kv_vector", "ops.kv_ops",
              "serving", "serving.admission", "serving.coalescer", "serving.replica",
              "serving.loadgen", "serving.batcher", "serving.frontend", "apps.serve.main",
              "models.speculative", "models.moe", "models.pipeline", "parameter.replica"):
        assert f"parameter_server_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'optax' or m.startswith('optax.')\n"
        "             or m == 'parameter_server_tpu'\n"
        "             or m.startswith('parameter_server_tpu.'))\n"
        "import os\n"
        "from parameter_server_tpu_torch import native\n"
        "native.library()  # the port's own native library, built from its own source\n"
        "maps = open('/proc/self/maps').read() if os.path.exists('/proc/self/maps') else ''\n"
        "if 'parameter_server_tpu/cpp/' in maps:\n"
        "    bad.append('libpsnative, the native library of the JAX package')\n"
        "if maps and str(native.library_path()) not in maps:\n"
        "    bad.append('the port native library is not the one loaded')\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def _write_cli_conf(tmp_path) -> pathlib.Path:
    from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, write_ctr_shards

    write_ctr_shards(str(tmp_path / "train"), 1, 200, seed=0, key_bits=12)
    conf = tmp_path / "ctr.conf"
    conf.write_text(ctr_conf(str(tmp_path / "train" / "part.*"), str(tmp_path / "model"),
                             num_slots=1024, countmin_n=4096, num_data_pass=1))
    return conf


def test_cli_run_as_a_module_imports_nothing_of_jax(tmp_path):
    """``python -m ...apps.linear.main`` end to end, every import traced:
    neither jax nor the JAX package (nor its native library, a module of
    it) is loaded."""
    conf = _write_cli_conf(tmp_path)
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "parameter_server_tpu_torch.apps.linear.main",
         str(conf), "--device", "cpu"],
        cwd=tmp_path, env=_clean_env(), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert (tmp_path / "model_S0").exists()
    loaded = {
        line.rsplit("|", 1)[1].strip()
        for line in out.stderr.splitlines()
        if line.startswith("import time:") and line.count("|") == 2
    }
    assert "parameter_server_tpu_torch.apps.linear.async_sgd" in loaded  # main runs as __main__
    assert "parameter_server_tpu_torch.data.text_parser" in loaded
    bad = sorted(m for m in loaded if m == "jax" or m.startswith("jax.")
                 or m == "parameter_server_tpu" or m.startswith("parameter_server_tpu."))
    assert not bad, bad


def test_lm_cli_run_as_a_module_imports_nothing_of_jax_or_optax(tmp_path):
    """``python -m ...apps.lm.main`` end to end (train, evaluate, generate),
    every import traced: neither jax, optax nor the JAX package is loaded."""
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "parameter_server_tpu_torch.apps.lm.main",
         "--device", "cpu", "--steps", "2", "--seq-len", "32", "--batch", "2", "--eval-every", "2",
         "--prompt", "a", "--gen-tokens", "2"],
        cwd=tmp_path, env=_clean_env(), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "--- generation" in out.stdout
    loaded = {
        line.rsplit("|", 1)[1].strip()
        for line in out.stderr.splitlines()
        if line.startswith("import time:") and line.count("|") == 2
    }
    assert "parameter_server_tpu_torch.models.transformer" in loaded
    assert "parameter_server_tpu_torch.apps.lm.optim" in loaded
    bad = sorted(m for m in loaded if m.split(".")[0] in ("jax", "optax", "parameter_server_tpu"))
    assert not bad, bad


def test_serve_cli_run_as_a_module_imports_nothing_of_jax(tmp_path):
    """``python -m ...apps.serve.main`` end to end (the decode lane through
    the batcher included), every import traced: neither jax nor the JAX
    package is loaded."""
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "parameter_server_tpu_torch.apps.serve.main",
         "--device", "cpu", "--num-slots", "4096", "--duration", "0.1", "--decode",
         "--batch-slots", "4", "--gamma", "2"],
        cwd=tmp_path, env=_clean_env(), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert '"serve_frontend_stats"' in out.stdout
    loaded = {
        line.rsplit("|", 1)[1].strip()
        for line in out.stderr.splitlines()
        if line.startswith("import time:") and line.count("|") == 2
    }
    assert "parameter_server_tpu_torch.serving.batcher" in loaded
    assert "parameter_server_tpu_torch.parameter.kv_vector" in loaded
    bad = sorted(m for m in loaded if m.split(".")[0] in ("jax", "optax", "parameter_server_tpu"))
    assert not bad, bad


def test_serve_cli_resolves_to_the_card(monkeypatch):
    from parameter_server_tpu_torch.apps.serve import main as serve_main
    from parameter_server_tpu_torch.parameter.kv_vector import KVVector
    from parameter_server_tpu_torch.system.postoffice import Postoffice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Postoffice.reset()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_main.main(["--num-slots", "4096", "--duration", "0.1"])
        Postoffice.reset()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KVVector(k=1, num_slots=64)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.kv_replica_from_jax({0: np.zeros((4, 1), np.float32)})
    finally:
        Postoffice.reset()


def test_serving_plane_limits_raise_naming_their_items():
    from parameter_server_tpu_torch.parameter.kv_vector import KVVector
    from parameter_server_tpu_torch.system.postoffice import Postoffice

    Postoffice.reset()
    try:
        with pytest.raises(NotImplementedError, match="A9"):
            Postoffice.instance().start(num_server=2, device="cpu")
        kv = KVVector(k=1, num_slots=64, device="cpu")
        with pytest.raises(NotImplementedError, match="A13"):
            kv.migrate(np.arange(64))
    finally:
        Postoffice.reset()


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|optax)\b|from\s+(jax|optax)\b|import\s+parameter_server_tpu(\.|\s|$)"
    r"|from\s+parameter_server_tpu(\.|\s))",
    re.M,
)


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_port_sources_name_no_jax_import(where):
    files = sorted(PKG.rglob("*.py")) if where == "package" else [ROOT / "chip_smoke.py"]
    assert files
    hits = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not hits, hits


def _conf(**sgd):
    c = tcfg.Config()
    c.async_sgd = tcfg.SGDConfig(num_slots=1 << 12, minibatch=64, **sgd)
    return c


def test_entry_points_raise_without_a_card(monkeypatch):
    from parameter_server_tpu_torch.benchmarks import lm_train
    from parameter_server_tpu_torch.models import transformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsgd.AsyncSGDWorker(_conf())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_jax({"z": torch.zeros(4).numpy()})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_lm(0, transformer.LMConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_train.make_tokens(0, 1, 1, 8)
    from parameter_server_tpu_torch.apps.linear.model_evaluation import ModelEvaluation

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelEvaluation(tcfg.Config())
    # the CPU runs only when asked for
    w = tsgd.AsyncSGDWorker(_conf(), device="cpu")
    assert w.device.type == "cpu" and w.update_path == "torch_ref"


def test_wrappers_take_the_plain_path_for_cpu_tensors_only():
    """A tensor that is not on the CPU goes to the kernel route, which
    launches or raises: there is no fallback to the plain version."""
    kw = dict(alpha=0.1, beta=1.0, l1=1.0)
    z = torch.zeros(8, device="meta")
    n = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tftrl.ftrl_update(z, n, torch.zeros(8, device="meta"), **kw)
    rel = torch.zeros(8, dtype=torch.int32, device="meta")
    ok = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tsparse.ftrl_sparse_update(z, n, rel, ok, torch.zeros(8, device="meta"), **kw)
    assert tftrl.ftrl_update.launches == 0
    assert tsparse.ftrl_sparse_update.launches == 0


UNPORTED = [
    ("num_replicas", 1),
    ("replica_every", 2),
]


@pytest.mark.parametrize("field,value", UNPORTED, ids=[f for f, _ in UNPORTED])
def test_unported_config_values_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        _conf(**{field: value})
    # set after construction: the worker validates again
    c = _conf()
    setattr(c.async_sgd, field, value)
    with pytest.raises(NotImplementedError, match=field):
        tsgd.AsyncSGDWorker(c, device="cpu")


# (field, a value the JAX package accepts, the settings it needs there)
PORTED = [
    ("max_delay", 4, {}),
    ("push_filter", [{"type": "fixing_float", "num_bytes": 1}], {}),
    ("pull_filter", [{"type": "add_noise", "std": 0.1}], {}),
    ("pull_gather", "narrow", {}),
    ("wire_encode", "exact", {"update": "sparse"}),
    ("ell_lanes", 39, {}),
    ("wire_u24", True, {"ell_lanes": 39}),
    ("wire", "bits", {"ell_lanes": 39}),
    ("wire_compress", "lz", {}),
    ("wire_cache_mb", 64, {}),
    ("kkt_filter", True, {"update": "sparse"}),
    ("tau_adaptive", True, {"max_delay": 4}),
]


@pytest.mark.parametrize("field,value,needs", PORTED, ids=[f for f, _, _ in PORTED])
def test_ported_config_values_are_accepted(field, value, needs):
    """Bounded delay, the filtered wire, the encoded and ELL wires, the
    KKT filter and adaptive τ are ported: their settings build a worker
    that trains a minibatch instead of raising."""
    from parameter_server_tpu.apps.linear import config as jcfg
    from parameter_server_tpu_torch.utils.sparse import random_sparse

    jcfg.SGDConfig(**{field: value}, **needs)  # the JAX package's dataclass takes it
    w = tsgd.AsyncSGDWorker(_conf(**{field: value}, **needs), device="cpu")
    assert getattr(w.sgd, field) == value
    assert field not in tcfg._UNPORTED
    m = w.process_minibatch(random_sparse(64, 1 << 14, 39, seed=0, binary=True))
    assert float(m["num_ex"]) == 64 and np.isfinite(float(m["objective"]))


def test_every_unported_field_is_covered():
    assert {f for f, _ in UNPORTED} == set(tcfg._UNPORTED) == {"num_replicas", "replica_every"}
    names = {f.name for f in dataclasses.fields(tcfg.SGDConfig)}
    assert set(tcfg._UNPORTED) <= names


@pytest.mark.parametrize("field,value", [
    ("update", "rows"), ("ftrl_state_dtype", "float16"), ("algo", "darlin"),
])
def test_unknown_config_values_raise(field, value):
    with pytest.raises(ValueError):
        _conf(**{field: value})


def test_chip_smoke_fails_without_a_card():
    """No card: a non-zero exit and no result line."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
