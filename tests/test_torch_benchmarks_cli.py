"""PyTorch port: the component suite's registry, report line, timer and
CLI (``parameter_server_tpu_torch/benchmarks/__init__.py``,
``__main__.py``) against the JAX package's, and the table that maps the
JAX suite's metric lines onto the port's.

The other ``tests/test_torch_benchmarks_*.py`` files run each registered
benchmark at smoke on the CPU beside its JAX benchmark and hold the
port's lines to the JAX lines through :data:`METRIC_MAP`. No test here
or there asserts a speed ratio or a wall time: the host's load moves
them.
"""

import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from parameter_server_tpu import benchmarks as jbench
from parameter_server_tpu.benchmarks import components as jcomp  # noqa: F401 (registers)
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.telemetry import blackbox as jblackbox
from parameter_server_tpu_torch import benchmarks as tbench
from parameter_server_tpu_torch.benchmarks import __main__ as tmain
from parameter_server_tpu_torch.benchmarks import components as tcomp  # noqa: F401
from parameter_server_tpu_torch.telemetry import device as tdevice

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# -- the mapping of the JAX suite's metric lines onto the port's --

class Absent(str):
    """A JAX metric line the port does not print; the string says why."""


#: every JAX metric line whose name the port changes, with the port's
#: name, or :class:`Absent` with the reason there is none; every other
#: line keeps its JAX name. The arms: the JAX package's ``xla``,
#: ``pallas``, ``fused`` and ``flash`` arms are ``plain`` (the plain
#: PyTorch version) and ``cuda`` (the hand-written kernel) in the port,
#: and so are the metrics built from them.
METRIC_MAP = {
    "attention_xla_gflops": "attention_plain_gflops",
    "attention_flash_gflops": "attention_cuda_gflops",
    "attention_flash_bf16_gflops": "attention_cuda_bf16_gflops",
    "attention_xla_bf16_gflops": "attention_plain_bf16_gflops",
    "ftrl_sparse_xla_rows_ms": "ftrl_sparse_plain_ms",
    "ftrl_sparse_fused_ms": "ftrl_sparse_cuda_ms",
    "ftrl_sparse_fused_speedup": "ftrl_sparse_cuda_speedup",
    # MB/s of the card's bytes (benchmarks/ftrl_bytes.py), not of the
    # JAX model's 512-byte TPU row granules; MB/s because the smoke's GB/s
    # on a loaded CPU falls under report()'s 2 decimals (0.00)
    "ftrl_sparse_fused_hbm_gb_s": "ftrl_sparse_cuda_hbm_mb_s",
    "ftrl_sparse_fused_frac_of_peak": "ftrl_sparse_cuda_frac_of_peak",
    # GB/s of the card's bytes: g read, z and sqrt_n read and written, 20
    # a slot an update (the JAX line counts 16, g left out)
    **{f"ftrl_dense_{j}_2e{e}_chain{what}": f"ftrl_dense_{t}_2e{e}_chain{what}"
       for j, t in (("xla", "plain"), ("pallas", "cuda"))
       for e in (14, 18, 20, 24, 26, 28)
       for what in ("_ms", "_per_update_ms", "_gb_s")},
    # microseconds: an 8 KB copy to the card takes ~0.01 ms, which
    # report()'s 2 decimals would flatten
    **{f"network_h2d_{kb}kb_ms": f"network_h2d_{kb}kb_us" for kb in (8, 64, 1024, 8192)},
    # MB/s: a probe moves a few MB a call, and its GB/s on a loaded CPU
    # falls under report()'s 2 decimals (0.00, which no line may print)
    "roofline_ftrl_chain_gb_s": "roofline_ftrl_chain_mb_s",
    "roofline_flash_fwd_gb_s": "roofline_flash_fwd_mb_s",
    "roofline_ftrl_chain_gflops": Absent(
        "the probe declares FlopCounterMode's count, which finds no FLOP in the FTRL update "
        "(no matmul): it declares bytes only"),
}

#: JAX benchmarks the port does not register (none: ``rebalance`` runs in
#: a world of 8 ranks it starts)
NOT_PORTED: dict = {}

#: record fields of the JAX benchmarks that the port renames or drops
RECORD_FIELDS = {
    "ftrl_sparse_ab": {
        "xla_rows_ms": "plain_ms",
        "fused_ms": "cuda_ms",
        "fused_speedup_median_paired": "cuda_speedup_median_paired",
        "rows_touched": None,  # 128-lane rows: the TPU's DMA granule; the port counts
        # bytes and 32-byte sectors with benchmarks/ftrl_bytes.py (bytes_model)
        "xla_rows_hbm_gb_s": None,  # the plain arm's bytes are not a kernel's bytes
        "bytes_model_cross_check": None,  # XLA cost analysis: no counterpart
        "onchip_target": None,  # a TPU capture's bar: the port states none
        "backend": "device",
    },
    "flash_cost_crosscheck": {
        "xla_flops": "counted_flops",  # FlopCounterMode over the plain version
        "hand_over_xla_ratio": "hand_over_counted_ratio",
        "xla_tflops": "counted_tflops",
        "mfu_xla": "mfu_counted",
        "xla_bytes_accessed": None,  # FlopCounterMode counts no bytes
        "xla_path": "counter",
    },
    "serve": {"compile_s": "first_call_s"},  # eager PyTorch compiles nothing
    # XLA's count of programs compiled after warm-up: eager PyTorch
    # compiles nothing, and the port invents no substitute
    "rebalance": {"recompiles_post_warmup": None},
    # the port's drill also records its live phase's timeline (the host
    # clock: when the rebalance started and ended, when training did)
    "decode_batching": {"compile_s": "warmup_s", "onchip_target": None},
}


def port_name(jax_metric: str):
    """The port's name for a JAX metric line (:data:`METRIC_MAP`), or
    None when the port has none."""
    name = METRIC_MAP.get(jax_metric, jax_metric)
    return None if isinstance(name, Absent) else name


# -- running both suites in-process --


def _lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.strip()]


_port_cache: dict = {}
_jax_cache: dict = {}


def run_port(name: str, tmp_dir) -> tuple:
    """``(record, lines)`` of the port's benchmark ``name`` at smoke on the
    CPU, run once per test process, with the process state reset before
    and after as the CLI resets it."""
    if name not in _port_cache:
        buf = io.StringIO()
        tmain.reset_process_state()
        with _env(tmp_dir, "port"), contextlib.redirect_stdout(buf):
            rec = tbench.REGISTRY[name](True, device="cpu")
        tmain.reset_process_state()
        _port_cache[name] = (rec, _lines(buf.getvalue()))
    return _port_cache[name]


def run_jax(name: str, tmp_dir) -> list:
    """The JAX benchmark's lines at smoke on the CPU, once per process.
    The JAX package's bundle store is emptied first: its consistency
    drill finds its bundle by the store's length, which stops growing
    once earlier work in the process has filled it (four bundles)."""
    if name not in _jax_cache:
        buf = io.StringIO()
        JPostoffice.reset()
        jblackbox.reset()
        with _env(tmp_dir, "jax"), contextlib.redirect_stdout(buf):
            jbench.REGISTRY[name](True)
        JPostoffice.reset()
        _jax_cache[name] = _lines(buf.getvalue())
    return _jax_cache[name]


@contextlib.contextmanager
def _env(tmp_dir, side: str):
    """Point the probes' output files at ``tmp_dir``."""
    keys = ("PS_TRACE_OUT", "PS_BUNDLE_OUT", "PS_CONSISTENCY_OUT")
    old = {k: os.environ.get(k) for k in keys}
    os.environ["PS_TRACE_OUT"] = str(tmp_dir / f"{side}_trace.json")
    os.environ["PS_BUNDLE_OUT"] = str(tmp_dir / f"{side}_bundle.json")
    os.environ["PS_CONSISTENCY_OUT"] = str(tmp_dir / f"{side}_consistency.json")
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_against_jax(name: str, tmp_dir, extra_port=()) -> tuple:
    """Run the port's and the JAX benchmark ``name`` at smoke: every port
    line parses with a finite value > 0, and the port's metric names are
    the JAX names mapped through :func:`port_name`, one to one.
    ``extra_port``: port lines the JAX run could not print here, with
    the reason given by the caller. Returns ``(record, lines)``."""
    rec, lines = run_port(name, tmp_dir)
    assert lines, f"{name} printed no line"
    for m in lines:
        assert {"metric", "value", "unit"} <= set(m), m
        assert isinstance(m["value"], (int, float)) and math.isfinite(m["value"]), m
        assert m["value"] > 0, m
    got = [m["metric"] for m in lines]
    assert len(got) == len(set(got)), got
    want = [port_name(m["metric"]) for m in run_jax(name, tmp_dir)]
    want = [w for w in want if w is not None]
    assert sorted(set(got) - set(extra_port)) == sorted(want), (got, want)
    assert {k: round(v, 2) for k, v in rec["metrics"].items()} == {
        m["metric"]: m["value"] for m in lines}
    return rec, lines


# -- the registry, report and timeit --


def test_registry_is_the_jax_registry_less_the_a9_benchmark():
    assert set(tbench.REGISTRY) == set(jbench.REGISTRY) - set(NOT_PORTED)
    assert len(tbench.REGISTRY) == 23
    for name, fn in tbench.REGISTRY.items():
        assert fn.__module__ == tcomp.__name__, name


def test_peak_tables_are_the_telemetry_tables():
    assert tbench.HBM_PEAK_GB_S is tdevice.HBM_PEAK_GB_S
    assert tbench.FLOPS_PEAK_TFLOPS is tdevice.FLOPS_PEAK_TFLOPS
    assert tcomp.HBM_PEAK_GB_S is tdevice.HBM_PEAK_GB_S


@pytest.mark.parametrize("table", ["hbm", "flops"])
def test_peaks_are_none_off_the_card(table):
    t = tbench.HBM_PEAK_GB_S if table == "hbm" else tbench.FLOPS_PEAK_TFLOPS
    assert tbench.peak(t, "cpu") is None
    assert tbench.peak(t, torch.device("cpu")) is None


@pytest.mark.parametrize("value", [0.004, 0.005, 1.234567, 12345.675, 7, 0.0, 2.5e-3, 1e12])
def test_report_prints_the_jax_line(value):
    outs = []
    for mod in (jbench, tbench):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.report("some_metric", value, "ms")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert json.loads(outs[1])["value"] == round(value, 2)


class _ScriptedClock:
    """``time.perf_counter`` that advances by a scripted step a read."""

    def __init__(self, steps):
        self.t = 0.0
        self.steps = list(steps)
        self.i = 0

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


@pytest.mark.parametrize("steps,n,warmup,budget", [
    ([0.001], 10, 3, 90.0),
    ([0.001, 0.003, 0.0005, 0.002, 0.01], 10, 3, 90.0),
    ([2.0, 0.5, 7.0], 5, 3, 30.0),      # the budget cuts windows
    ([0.25, 0.1, 0.4, 0.05], 20, 4, 1.0),
])
def test_timeit_is_the_jax_timeit_under_a_scripted_clock(monkeypatch, steps, n, warmup, budget):
    import time as time_mod

    results, calls = [], []
    for mod in (jbench, tbench):
        clock = _ScriptedClock(steps)
        monkeypatch.setattr(time_mod, "perf_counter", clock)
        count = [0]

        def fn():
            count[0] += 1

        results.append(mod.timeit(fn, n, warmup=warmup, budget_s=budget))
        calls.append((count[0], clock.i))
        monkeypatch.undo()
    assert results[0] == results[1]
    assert calls[0] == calls[1]


def test_mapping_names_a_reason_for_every_absent_line():
    for jax_name, name in METRIC_MAP.items():
        if isinstance(name, Absent):
            assert port_name(jax_name) is None and len(name) > 20
        else:
            assert name != jax_name and name not in METRIC_MAP
    assert port_name("ftrl_sparse_fused_ms") == "ftrl_sparse_cuda_ms"
    assert port_name("attention_flash_bf16_gflops") == "attention_cuda_bf16_gflops"
    assert port_name("ftrl_dense_pallas_2e24_chain_gb_s") == "ftrl_dense_cuda_2e24_chain_gb_s"
    assert port_name("network_h2d_8192kb_ms") == "network_h2d_8192kb_us"
    assert port_name("kv_vector_push_keys_per_sec") == "kv_vector_push_keys_per_sec"


# -- the CLI --


def _env_clean():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def _cli(*args, timeout=120):
    return subprocess.run([sys.executable, "-m", "parameter_server_tpu_torch.benchmarks", *args],
                          cwd=ROOT, env=_env_clean(), capture_output=True, text=True,
                          timeout=timeout)


def test_cli_rejects_an_unknown_name():
    proc = _cli("nope", "--smoke", "--device", "cpu")
    assert proc.returncode != 0
    assert "unknown benchmark" in proc.stderr
    assert proc.stdout == ""


def _record_keys(rec, renames, prefix=""):
    """The dotted field names of a nested record, each renamed or dropped
    as ``renames`` (a field's leaf name -> new name or None) says."""
    out = set()
    for key, value in rec.items():
        if key in renames:
            if renames[key] is None:
                continue
            key = renames[key]
        if isinstance(value, dict) and key not in ("chosen", "shape"):
            out |= _record_keys(value, renames, f"{prefix}{key}.")
        else:
            out.add(prefix + key)
    return out


def test_cli_refuses_rebalance_naming_a9(tmp_path):
    """``rebalance`` is ported: ``python -m parameter_server_tpu_torch.benchmarks
    rebalance --smoke --device cpu`` starts a world of 8 CPU ranks and
    exits 0, printing the JAX drill's metric lines (mapped through
    :data:`METRIC_MAP`), and its record holds the JAX record's fields
    less those :data:`RECORD_FIELDS` drops; no ``NotImplementedError``
    names A9 for it."""
    env = _env_clean()
    env["PS_REBALANCE_OUT"] = str(tmp_path / "port.json")
    proc = subprocess.run([sys.executable, "-m", "parameter_server_tpu_torch.benchmarks",
                           "rebalance", "--smoke", "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "A9" not in proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    for m in lines:
        assert set(m) == {"metric", "value", "unit"} and m["value"] > 0, m
    old = os.environ.get("PS_REBALANCE_OUT")
    os.environ["PS_REBALANCE_OUT"] = str(tmp_path / "jax.json")
    try:
        # the JAX drill is the reference here. Its own post-rebalance check
        # fails when a loaded host lets its train stream end before its
        # migration does (an empty post-rebalance window: ROADMAP lists it
        # among the JAX package's load failures); such a reference run says
        # nothing of the port, so it is run again, at most three times
        for attempt in range(3):
            try:
                want = run_jax("rebalance", tmp_path)
                break
            except AssertionError as e:
                if "post-rebalance imbalance" not in str(e) or attempt == 2:
                    raise
    finally:
        if old is None:
            os.environ.pop("PS_REBALANCE_OUT", None)
        else:
            os.environ["PS_REBALANCE_OUT"] = old
    assert [m["metric"] for m in lines] == [port_name(m["metric"]) for m in want]
    port_rec = json.loads((tmp_path / "port.json").read_text())["rebalance_record"]
    jax_rec = json.loads((tmp_path / "jax.json").read_text())["rebalance_record"]
    ours = {k for k in _record_keys(port_rec, {}) if not k.startswith("rebalance.timeline.")}
    assert ours == _record_keys(jax_rec, RECORD_FIELDS["rebalance"])
    reb = port_rec["rebalance"]
    assert reb["serve"]["failed"] == 0 and reb["trajectory_bit_identical"]
    assert reb["sharded_vs_single_bit_identical"] and reb["post_rebalance_imbalance"] < 4.0
    assert port_rec["mesh"]["shape"] == jax_rec["mesh"]["shape"] == {"data": 1, "server": 8}
    assert port_rec["mesh"]["auto_shape_demo"] == jax_rec["mesh"]["auto_shape_demo"]
    assert reb["alert"]["transitions"][:2] == ["inactive->pending", "pending->firing"]


def test_cli_without_a_card_or_a_device_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    proc = _cli("executor", "--smoke")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("executor", "history_ab", "wire", "ftrl_sparse_ab", "kv_map"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbench.REGISTRY[name](True)
        tmain.reset_process_state()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcomp.flash_cost_crosscheck(True)
    assert tmain.main(["executor", "--smoke"]) == 1


def test_cli_resets_the_process_between_benchmarks(monkeypatch):
    """Each benchmark starts from a fresh postoffice and no armed fault
    point: one armed in a benchmark does not reach the next."""
    from parameter_server_tpu_torch.system import faults
    from parameter_server_tpu_torch.system.postoffice import Postoffice

    seen = []

    def first(smoke=False, device=None):
        seen.append(("first", Postoffice.instance().started, faults.spec("executor.step")))
        Postoffice.instance().start(device=device)
        faults.arm("executor.step", kind="raise")

    def second(smoke=False, device=None):
        seen.append(("second", Postoffice.instance().started, faults.spec("executor.step")))

    monkeypatch.setitem(tbench.REGISTRY, "zz_first", first)
    monkeypatch.setitem(tbench.REGISTRY, "zz_second", second)
    try:
        assert tmain.main(["zz_first", "zz_second", "--device", "cpu"]) == 0
    finally:
        faults.reset()
        Postoffice.reset()
    assert seen == [("first", False, None), ("second", False, None)]
    assert faults.spec("executor.step") is None


def test_cli_runs_every_benchmark_in_one_process(tmp_path):
    """``python -m parameter_server_tpu_torch.benchmarks --smoke --device
    cpu``: all 22 in one process, exit 0, only JSON metric lines on
    stdout, every line's value finite and > 0, and the lines of each
    benchmark in the order the registry runs them."""
    env = _env_clean()
    env.update(PS_TRACE_OUT=str(tmp_path / "t.json"), PS_BUNDLE_OUT=str(tmp_path / "b.json"),
               PS_CONSISTENCY_OUT=str(tmp_path / "c.json"))
    proc = subprocess.run([sys.executable, "-m", "parameter_server_tpu_torch.benchmarks",
                           "--smoke", "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert lines
    for m in lines:
        assert set(m) == {"metric", "value", "unit"}, m
        assert math.isfinite(m["value"]) and m["value"] > 0, m
    names = [m["metric"] for m in lines]
    assert len(names) == len(set(names))
    firsts = {"kv_vector_push_keys_per_sec", "consistency_adaptive_examples_per_s",
              "decode_batched_speedup_at_8", "attention_plain_gflops",
              "recovery_detection_ms", "ftrl_sparse_plain_ms"}
    assert firsts <= set(names)
    assert (tmp_path / "t.json").exists() and (tmp_path / "b.json").exists()
