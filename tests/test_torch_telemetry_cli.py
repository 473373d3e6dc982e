"""PyTorch port, telemetry through the CLIs, on the CPU.

- The linear CLI on the CTR conf at a small size, with
  ``--report-interval``, ``--verbose`` and ``--profile DIR``: every
  counter whose value does not depend on the clock equals the JAX CLI's
  on the same conf (examples, ingest volume, executor steps, FTRL rows
  and path, device-inventory signatures, learning-plane volume, wire
  bytes), the executor's histogram counts too; the dashboard prints and
  the capture is written.
- Each system-layer flag the linear CLI used to refuse now runs.
- The serve CLI with ``--expose-port 0``: ``/metrics``, ``/healthz`` and
  ``/debug/snapshot`` answer while it runs, and the set of metric names
  its process records equals the JAX serve CLI's.
- The LM CLI's ``--profile DIR`` writes a capture and leaves the losses
  as they were.

No test asserts a time.
"""

import json
import pathlib
import random
import time
import urllib.request

import pytest
import torch

from parameter_server_tpu.apps.linear import main as jmain
from parameter_server_tpu.apps.serve import main as jserve
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.telemetry import blackbox as jblackbox
from parameter_server_tpu.telemetry import device as jdevice
from parameter_server_tpu.telemetry import registry as jreg
from parameter_server_tpu_torch.apps.linear import main as tmain
from parameter_server_tpu_torch.apps.lm import main as lm_main
from parameter_server_tpu_torch.apps.serve import main as tserve
from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, write_ctr_shards
from parameter_server_tpu_torch.system.postoffice import Postoffice
from parameter_server_tpu_torch.telemetry import blackbox as tblackbox
from parameter_server_tpu_torch.telemetry import device as tdevice
from parameter_server_tpu_torch.telemetry import exposition as texpo
from parameter_server_tpu_torch.telemetry import registry as treg

torch.set_num_threads(1)

#: counters that read the clock or the host, or a cache the two packages
#: place differently (the port's KeyDirectory caches the device slots
#: only, the JAX one the host slots too)
CLOCK_OR_CACHE = {"ps_directory_slot_cache_hits_total", "ps_directory_slot_cache_misses_total",
                  "heartbeat_reports_total"}

#: the port's names of the FTRL update paths that are the JAX package's
#: ``ref`` / ``xla_rows`` routes on the CPU
PATH_NAMES = {"path=torch_ref": "path=ref"}


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    Postoffice.reset()
    JPostoffice.reset()


def _ctr(tmp_path, rows=2400, passes=2) -> pathlib.Path:
    write_ctr_shards(str(tmp_path / "train"), 2, rows, seed=0, key_bits=12)
    conf = tmp_path / "ctr.conf"
    conf.write_text(ctr_conf(str(tmp_path / "train" / "part.*"), str(tmp_path / "model"),
                             num_slots=4096, countmin_n=4096, num_data_pass=passes))
    return conf


def _counters(snap: dict) -> dict:
    """Counter values and histogram counts, keyed by metric and labels."""
    out = {}
    for name, entry in snap.items():
        if name in CLOCK_OR_CACHE:
            continue
        for labels, val in entry["values"].items():
            labels = PATH_NAMES.get(labels, labels)
            if entry["type"] == "counter":
                out[(name, labels)] = val
            elif entry["type"] == "histogram" and name.startswith(("executor_", "ps_learning_")):
                out[(name + ".count", labels)] = val["count"]
    return out


def test_linear_cli_counters_equal_the_jax_clis(tmp_path, capsys, monkeypatch):
    conf = _ctr(tmp_path)
    monkeypatch.chdir(tmp_path)
    # both inventories fresh: the JAX package's is process-wide and keeps
    # the step builders of earlier tests (its Postoffice.reset keeps it)
    jdevice.reset()
    tdevice.reset()
    random.seed(0)
    assert jmain.main([str(conf), "--num-workers", "1", "--verbose"]) == 0
    jsnap = jreg.default_registry().snapshot()
    jout = capsys.readouterr().out
    random.seed(0)
    prof = tmp_path / "prof"
    assert tmain.main([str(conf), "--verbose", "--report-interval", "1", "--profile", str(prof)],
                      device="cpu") == 0
    tsnap = treg.default_registry().snapshot()
    tout = capsys.readouterr().out
    theirs, ours = _counters(jsnap), _counters(tsnap)
    assert theirs[("app_examples_total", "")] == 4 * 2400
    assert theirs[("executor_steps_finished_total", "executor=async_sgd_worker")] > 1
    assert ("ps_device_compiles_total", "fn=step_hashed.snap") in theirs
    assert ours == theirs
    # the dashboard: its node table and the telemetry section
    for out in (jout, tout):
        assert "node      total(s)" in out and "async_sgd_worker" in out and "telemetry:" in out
    # the capture of the run (CPU activity only here)
    traces = list(prof.rglob("*.trace.json"))
    assert len(traces) == 1
    doc = json.loads(traces[0].read_text())
    assert any(ev.get("cat") == "cpu_op" for ev in doc["traceEvents"])


@pytest.mark.parametrize("flag", [["--report-interval", "1"], ["--heartbeat-timeout", "3"],
                                  ["--profile", "trace"]], ids=["report", "heartbeat", "profile"])
def test_system_layer_flags_run(flag, tmp_path, capsys, monkeypatch):
    conf = _ctr(tmp_path, rows=600, passes=1)
    monkeypatch.chdir(tmp_path)
    assert tmain.main([str(conf), *flag], device="cpu") == 0
    out = capsys.readouterr().out
    assert " sec  examples" in out
    if flag[0] == "--report-interval":
        assert "node      total(s)" in out
    if flag[0] == "--profile":
        assert list((tmp_path / "trace").rglob("*.trace.json"))
    assert Postoffice.instance().aux is None  # stopped with the run


def test_start_aux_runs_heartbeats_and_recovery():
    po = Postoffice.instance().start(device="cpu")
    aux = po.start_aux(heartbeat_timeout=0.5)
    assert po.start_aux() is aux
    aux.register("W0")
    po.beat("W0")
    dead = []
    aux.coordinator.on_worker_dead(dead.append)
    assert aux.coordinator.check(now=time.time() + 5.0) == ["W0"]
    assert dead == ["W0"]
    assert aux.report_all() >= 1  # over the van: the metric report frames
    assert po.van.wire_sent_bytes > 0 and "ps_node_heartbeats_total" in aux.metrics_text()
    po.stop()
    assert po.aux is None


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _names(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def test_serve_cli_exposes_metrics_while_it_runs(capsys, monkeypatch):
    """The endpoint is scraped by the CLI's own teardown: the server
    ``expose_cluster`` returns scrapes itself once when the CLI closes it,
    after the load points and before it shuts, so no scrape can miss the
    run however loaded the host is."""
    scraped = []
    real = texpo.expose_cluster

    def capture(*a, **k):
        srv = real(*a, **k)
        shut = srv.close

        def scrape_then_close():
            url = srv.url
            metrics = _get(url + "/metrics").decode()
            health = json.loads(_get(url + "/healthz"))
            snap = json.loads(_get(url + "/debug/snapshot"))
            scraped.append((metrics, health, snap))
            shut()

        srv.close = scrape_then_close
        return srv

    monkeypatch.setattr(texpo, "expose_cluster", capture)
    argv = ["--num-slots", "4096", "--duration", "0.3", "--expose-port", "0"]
    assert tserve.main(argv + ["--device", "cpu"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    expo = recs[-1]
    assert expo["metric"] == "serve_exposition" and expo["url"].startswith("http://127.0.0.1:")
    assert len(scraped) == 1
    metrics, health, snap = scraped[-1]
    assert "ps_serve_requests_total" in metrics and 'node="' in metrics
    assert "ok" in health and "dead_nodes" in health
    assert {"metrics", "cluster", "health", "learning", "history"} <= set(snap)
    # the SLO alerts fire or not with the host's load (a p99 burn fires
    # a diagnostic capture, whose families then register): one capture
    # in each process after its run (the rate limit reset: a capture, not
    # a suppression), so both record the capture's families whatever the
    # load did
    tblackbox.reset()
    tblackbox.trigger_bundle("test")
    ours = set(treg.default_registry().snapshot())
    # the frontends' request counters against the CLI's own record
    reqs = sum(treg.default_registry().snapshot()["ps_serve_requests_total"]["values"].values())
    stats = [r for r in recs if r["metric"] == "serve_frontend_stats"][0]
    assert reqs == 210 + stats["completed"]  # the 10 + 200 calibration requests first
    assert {"ps_serve_requests_total", "ps_cluster_node_up", "ps_node_heartbeats_total"} <= _names(
        metrics)
    assert jserve.main(argv) == 0
    capsys.readouterr()
    jblackbox.reset()
    jblackbox.trigger_bundle("test")
    theirs = set(jreg.default_registry().snapshot())
    assert ours == theirs


def test_lm_cli_profile_writes_a_capture_and_keeps_the_losses(tmp_path):
    base = ["--device", "cpu", "--steps", "4", "--seq-len", "32", "--batch", "2",
            "--report-every", "1"]
    logs = []
    tdevice.reset()
    for extra in ([], ["--profile", str(tmp_path / "p")]):
        log = tmp_path / f"log{len(logs)}.jsonl"
        assert lm_main.main(base + ["--log-file", str(log)] + extra) == 0
        logs.append([json.loads(x)["loss"] for x in log.read_text().splitlines()])
    assert logs[0] == logs[1] and len(logs[0]) == 4
    traces = list((tmp_path / "p").rglob("*.trace.json"))
    assert len(traces) == 1
    fns = tdevice.snapshot()["functions"]
    # each run builds its own step: one signature a run, four calls a run
    assert fns["lm_train_step"]["compiles"] == 2 and fns["lm_train_step"]["calls"] == 8


def test_inventory_counts_new_shapes_after_warmup():
    inv = tdevice.DeviceInventory()

    def step(x, y, seed=0, mode="a"):
        return x + y

    f = inv.instrument("toy", step, static_argnames=("mode",),
                       cost=lambda x, y, seed=0, mode="a": {"bytes_accessed": 8.0 * x.numel()})
    a = torch.ones(4)
    for s in range(3):
        f(a, a, s)  # the seed's value is no signature: one compile
    f(a, a, seed=5, mode="a")
    assert inv.snapshot()["functions"]["toy"]["compiles"] == 1
    inv.mark_warmup()
    f(torch.ones(8), torch.ones(8))
    f(a, a, mode="b")
    snap = inv.snapshot()
    assert snap["functions"]["toy"]["compiles"] == 3 and snap["recompiles_post_warmup"] == 2
    inv.set_sampling(1)
    f(a, a)
    timing = inv.snapshot()["functions"]["toy"]["roofline"]
    assert timing["achieved_gb_s"] >= 0 and "frac_of_hbm_peak" not in timing  # no peak for a CPU
    assert tdevice.aot_analyze(f, a, a) == {"donation_warned": False, "bytes_accessed": 32.0}


def test_hbm_monitor_reads_nothing_without_a_card():
    mon = tdevice.HbmMonitor()
    snap = mon.snapshot()
    assert snap["devices"] == {} and snap["live_buffer_bytes"] == 0


def test_exposition_demo_runs_on_the_cpu():
    assert texpo._demo_main(["--port", "0", "--duration", "0.3", "--device", "cpu",
                             "--steps-per-tick", "1"]) == 0


def _bound_key(sig, args):
    """The key the inventory gives a call after binding it."""
    dyn, statics = tdevice._canonical_call(sig, (), args, {})
    return (tuple((k, tdevice._leaf_sig(v)) for k, v in dyn), statics)


@pytest.mark.parametrize("nargs", [1, 2, 3, 4])
def test_positional_calls_key_as_bound_calls(nargs):
    """The inventory's unbound key of a positional call equals the key
    of the bound call, defaults applied, and is None where binding fails."""
    import inspect

    def f(table, idx, seed=0, pull_idx=None):
        return table

    sig = inspect.signature(f)
    key = tdevice._positional_key(sig, ())
    args = (torch.ones(3), torch.arange(2), 7, None)[:nargs]
    if nargs == 1:
        assert key(args) is None
        with pytest.raises(TypeError):
            sig.bind(*args)
    else:
        assert key(args) == _bound_key(sig, args)
    assert key(args + (1,) * (5 - nargs)) is None
    assert tdevice._positional_key(sig, ("seed",)) is None


@pytest.mark.parametrize("update,encode", [("sparse", ""), ("sparse", "exact"), ("dense", "")],
                         ids=["sparse_raw", "sparse_encoded", "dense"])
def test_step_cost_counts_the_state_rows_the_route_updates(update, encode):
    """A linear step declares its batch's bytes plus the z and √n rows it
    reads and writes: at each real unique slot on the sparse route (the
    count made from the uploaded batch), at every slot on the dense one."""
    import numpy as np

    from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDWorker, _step_cost
    from parameter_server_tpu_torch.benchmarks.headline import conf
    from parameter_server_tpu_torch.learner import wire
    from parameter_server_tpu_torch.utils.sparse import random_sparse

    c = conf(update, steps=1)
    c.async_sgd.num_slots = 1 << 12
    c.async_sgd.minibatch = 64
    c.async_sgd.wire_encode = encode
    worker = AsyncSGDWorker(c, device="cpu")
    batch = random_sparse(64, 1 << 16, 12, seed=3, binary=True)
    host = worker.prep(batch, device_put=False)
    assert isinstance(host, wire.EncodedExactBatch) == bool(encode)
    cost = _step_cost(update)(worker.state, worker.state, worker.upload(host))
    uniq = np.unique(worker.directory.slots(batch.indices)).size
    rows = uniq if update == "sparse" else worker.num_slots
    assert float(cost["bytes_accessed"]) == wire.batch_nbytes(host) + 2 * 8 * rows
