"""PyTorch port, telemetry: the port's spine held to the JAX package's on
the same inputs, on the CPU.

Each test drives the JAX package's module and the port's copy with the
same sequence of operations (same values, same injected clocks) and
compares what comes out: the metric catalog, registry renderings, span
events and their Chrome export, history queries and drift verdicts,
alert transitions, cluster merges, the learning plane, the dashboard and
the monitor. The device track is the one rewritten piece: the port reads
a ``torch.profiler`` trace, and the ``device.*`` events it gives are
stitched by both packages' ``merge_device_track`` the same way. No test
asserts a time.
"""

import json

import numpy as np
import pytest

from parameter_server_tpu.system import dashboard as jdash
from parameter_server_tpu.system import heartbeat as jhb
from parameter_server_tpu.system import monitor as jmon
from parameter_server_tpu.telemetry import aggregate as jagg
from parameter_server_tpu.telemetry import alerts as jalerts
from parameter_server_tpu.telemetry import history as jhist
from parameter_server_tpu.telemetry import instruments as jinst
from parameter_server_tpu.telemetry import learning as jlearn
from parameter_server_tpu.telemetry import registry as jreg
from parameter_server_tpu.telemetry import spans as jspans
from parameter_server_tpu.telemetry import timeline as jtl
from parameter_server_tpu_torch.system import dashboard as tdash
from parameter_server_tpu_torch.system import heartbeat as thb
from parameter_server_tpu_torch.system import monitor as tmon
from parameter_server_tpu_torch.telemetry import aggregate as tagg
from parameter_server_tpu_torch.telemetry import alerts as talerts
from parameter_server_tpu_torch.telemetry import history as thist
from parameter_server_tpu_torch.telemetry import instruments as tinst
from parameter_server_tpu_torch.telemetry import learning as tlearn
from parameter_server_tpu_torch.telemetry import registry as treg
from parameter_server_tpu_torch.telemetry import spans as tspans
from parameter_server_tpu_torch.telemetry import timeline as ttl
from parameter_server_tpu_torch.utils import profiling as tprof

FAMILIES = sorted(
    name for name in dir(jinst)
    if name.endswith("_instruments") and not name.startswith("cached_")
    and callable(getattr(jinst, name))
)


def _decls(reg):
    """Every metric's name, type, labels, help and buckets."""
    return {name: {k: v for k, v in decl.items() if k != "series"}
            for name, decl in reg.export_state().items()}


# -- the catalog --


def test_install_all_catalog_equals_the_jax_catalog():
    j, t = jreg.MetricsRegistry(), treg.MetricsRegistry()
    jinst.install_all(j)
    tinst.install_all(t)
    jd, td = _decls(j), _decls(t)
    assert len(jd) > 100 and any("buckets" in d for d in jd.values())
    assert list(jd) == list(td)
    assert jd == td
    for name in ("ps_device_compiles_total", "ps_device_recompiles_total",
                 "ps_device_donation_fallbacks_total", "ps_device_dispatch_fallbacks_total",
                 "ps_device_roofline_frac", "ps_device_hbm_bytes_in_use"):
        assert name in td


def test_family_lists_are_the_same():
    port = sorted(n for n in dir(tinst) if n.endswith("_instruments") and not n.startswith("cached_")
                  and callable(getattr(tinst, n)))
    assert port == FAMILIES and len(FAMILIES) >= 20


# -- the registry, family by family --


def _drive(insts: dict, seed: int) -> None:
    """A fixed sequence of operations on every instrument of a family."""
    rng = np.random.default_rng(seed)
    for key in sorted(insts):
        inst = insts[key]
        labelnames = tuple(getattr(inst, "labelnames", ()) or ())
        for k in range(3):
            target = inst.labels(**{ln: f"{ln}{k}" for ln in labelnames}) if labelnames else inst
            kind = getattr(inst, "kind", "")
            vals = rng.random(4) * 10.0 ** float(rng.integers(-4, 3))
            if kind == "counter":
                for v in vals:
                    target.inc(float(v))
            elif kind == "gauge":
                for v in vals:
                    target.set(float(v))
            else:
                for v in vals:
                    target.observe(float(v))


@pytest.mark.parametrize("family", FAMILIES)
def test_registry_renders_byte_equal(family):
    j, t = jreg.MetricsRegistry(), treg.MetricsRegistry()
    ji, ti = getattr(jinst, family)(j), getattr(tinst, family)(t)
    assert sorted(ji) == sorted(ti)
    _drive(ji, seed=len(family))
    _drive(ti, seed=len(family))
    assert j.render_text() == t.render_text()
    assert j.snapshot() == t.snapshot()
    assert j.export_state() == t.export_state()


# -- spans under a fixed clock --


class _Clock:
    """A deterministic stand-in for the ``time`` module a span reads."""

    def __init__(self):
        self.t = 1_700_000_000.0
        self.p = 100.0

    def time(self):
        self.t += 0.25
        return self.t

    def perf_counter(self):
        self.p += 0.125
        return self.p


def _emit_spans(spans, timeline, path, monkeypatch):
    monkeypatch.setattr(spans, "time", _Clock())
    sink = spans.JsonlSink(str(path))
    prev = spans.install_sink(sink)
    try:
        f1 = spans.new_flow()
        with spans.flow_scope(f1):
            with spans.span("ingest.prep", ts=3, pipeline="p"):
                pass
            with spans.span("executor.step", ts=3):
                pass
        f2 = spans.new_flow()
        with spans.flow_scope(f2):
            with spans.span("serve.execute", req="pull"):
                pass
        with spans.span("serve.coalesce.flush", flows=[f1, f2], merged=2):
            pass
        spans.abandoned("stage.worker", reason="ValueError", flow=f2)
        with pytest.raises(KeyError):
            with spans.span("wire.encode", mode="exact"):
                raise KeyError("x")
    finally:
        spans.install_sink(prev)
        sink.close()
    events = timeline.load_events(str(path))
    out = path.with_suffix(".chrome.json")
    trace = timeline.export_chrome_trace(str(path), str(out))
    return events, trace, (f1, f2)


def test_spans_and_chrome_export_equal(tmp_path, monkeypatch):
    j_events, j_trace, j_flows = _emit_spans(jspans, jtl, tmp_path / "j.jsonl", monkeypatch)
    t_events, t_trace, t_flows = _emit_spans(tspans, ttl, tmp_path / "t.jsonl", monkeypatch)
    # flow ids are process counters of each package: compare relative to the first
    def norm(events, flows):
        m = {flows[0]: 1, flows[1]: 2}
        out = json.loads(json.dumps(events))
        for ev in out:
            for d in (ev, ev.get("args") or {}):
                if "flow" in d:
                    d["flow"] = m[d["flow"]]
                if "flows" in d:
                    d["flows"] = [m[f] for f in d["flows"]]
            if ev.get("cat") == "flow":
                ev["id"] = m[ev["id"]]
        return out

    assert len(j_events) == 6
    assert norm(j_events, j_flows) == norm(t_events, t_flows)
    assert norm(j_trace["traceEvents"], j_flows) == norm(t_trace["traceEvents"], t_flows)


# -- history under an injected clock --


def _history_run(reg_mod, hist_mod):
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("req_total", "requests", labelnames=("kind",))
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_seconds", "latency")
    t = [1000.0]
    store = hist_mod.HistoryStore(reg, resolutions=((1.0, 60), (10.0, 30)), clock=lambda: t[0])
    rng = np.random.default_rng(7)
    for i in range(90):
        c.labels(kind="pull").inc(int(rng.integers(1, 5)))
        g.set(float(i % 7) + 0.5 * i)
        h.observe(float(rng.random() * 0.01))
        t[0] += 1.0
        store.fold(force=True)
    out = {
        "rate": store.query("req_total", labels={"kind": "pull"}, window_s=60.0),
        "gauge": store.query("depth", window_s=60.0, resolution=10.0),
        "p99": store.query("lat_seconds", window_s=30.0, q=0.99),
        "snap": store.snapshot(),
    }
    samples = [(float(i), float(i % 5) + (0.5 * i if i > 20 else 0.0)) for i in range(40)]
    out["drift"] = hist_mod.drift_check(samples)
    out["drift_flat"] = hist_mod.drift_check([(float(i), 1.0) for i in range(40)])
    return json.loads(json.dumps(out, default=str))


def test_history_queries_and_drift_equal():
    j = _history_run(jreg, jhist)
    t = _history_run(treg, thist)
    assert j["rate"] and j == t


# -- alerts over the same series --


def _alerts_run(reg_mod, alerts_mod):
    reg = reg_mod.MetricsRegistry()
    g = reg.gauge("ps_serve_queue_depth", "depth")
    c = reg.counter("ps_serve_shed_total", "sheds", labelnames=("reason",))
    clock = [0.0]
    rules = [
        alerts_mod.AlertRule(name="deep", kind="gauge", metric="ps_serve_queue_depth",
                             threshold=10.0, for_s=2.0, resolve_hold_s=3.0),
        alerts_mod.AlertRule(name="shedding", kind="counter_rate", metric="ps_serve_shed_total",
                             threshold=5.0, window_s=4.0, resolve_hold_s=2.0),
    ]
    mgr = alerts_mod.AlertManager(rules, registry=reg, clock=lambda: clock[0])
    seen = []
    mgr.add_listener(lambda ev: seen.append(str(ev)))
    depth = [1, 4, 12, 15, 18, 20, 9, 3, 2, 1, 1, 1, 14, 1, 1, 1]
    for i, d in enumerate(depth):
        g.set(float(d))
        c.labels(reason="rate").inc(30.0 if 3 <= i <= 6 else 0.0)
        clock[0] = float(i)
        mgr.evaluate()
    return seen, {k: v.state_name for k, v in mgr.states().items()}


def test_alert_transitions_equal():
    j = _alerts_run(jreg, jalerts)
    t = _alerts_run(treg, talerts)
    assert any("->firing" in s for s in j[0]) and any("->resolved" in s for s in j[0])
    assert j == t


def test_default_rules_are_the_repos_rule_file():
    assert [r.name for r in talerts.default_rules()] == [r.name for r in jalerts.default_rules()]
    assert talerts.default_rules_path() == jalerts.default_rules_path()


# -- cluster aggregation --


def _node_export(reg_mod, inst_mod, node: int) -> dict:
    reg = reg_mod.MetricsRegistry()
    _drive(inst_mod.serve_instruments(reg), seed=node)
    _drive(inst_mod.node_instruments(reg), seed=10 + node)
    return reg.export_state()


def test_cluster_aggregation_equal():
    out = []
    for reg_mod, inst_mod, agg_mod in ((jreg, jinst, jagg), (treg, tinst, tagg)):
        t = [50.0]
        agg = agg_mod.ClusterAggregator(stale_after_s=3.0, clock=lambda: t[0])
        for node in ("W0", "W1", "S0"):
            agg.update(node, _node_export(reg_mod, inst_mod, int(node[1]) + len(node)))
            t[0] += 2.0
        out.append((agg.render_text(), json.dumps(agg.merged(), sort_keys=True, default=str),
                    sorted(agg.stale_nodes())))
    assert 'node="W0"' in out[0][0] and out[0][2] == ["W0", "W1"]
    assert out[0] == out[1]


# -- the learning plane and key heat --


def _learning_run(reg_mod, learn_mod):
    reg = reg_mod.MetricsRegistry()
    plane = learn_mod.LearningPlane("W0", num_slots=4096, num_shards=4, max_delay=2, registry=reg)
    rng = np.random.default_rng(11)
    for step in range(24):
        plane.note_slots(rng.zipf(1.3, 512) % 4096)
        plane.note_submit(step % 3, n_steps=1, clock_lag=step % 3, tau=2)
        plane.note_step({"objective": 100.0 / (step + 1), "num_ex": 128,
                         "grad_sq": 4.0 + step, "update_sq": 1.0 + step,
                         "weight_sq": 0.5 * step})
        if step % 8 == 7:
            plane.heat.advance()
    heat = learn_mod.KeyHeat(num_slots=100, num_shards=4, top_k=4)
    heat.note(np.concatenate([np.full(50, 80), np.arange(10)]))
    snap = plane.snapshot()
    return json.loads(json.dumps({"snap": snap, "text": reg.render_text(),
                                  "top": heat.top_slots(), "shares": heat.shares()},
                                 default=str))


def test_learning_plane_and_key_heat_equal():
    j = _learning_run(jreg, jlearn)
    t = _learning_run(treg, tlearn)
    assert j["top"][0]["slot"] == 80
    assert j == t


@pytest.mark.parametrize("cls,n,cap,keys_per_insert", [
    ("CountMin", 1 << 10, 40, 6000),  # more keys than counters, saturating
    ("CountMin", 1 << 16, 255, 700),
    ("CountMin", 1000, 40, 6000),  # a width that is no power of two
    ("DecayCountMin", 1 << 16, 1 << 30, 9000),
    ("DecayCountMin", 1 << 12, 300, 5000),
], ids=["pow2_saturating", "pow2_sparse", "odd_width", "decay_default", "decay_saturating"])
def test_count_min_sketches_equal(cls, n, cap, keys_per_insert):
    """The port's sketches (positions, inserts and queries in the native
    library) hold the JAX package's counters bit for bit: after inserts
    with duplicate keys and counts, saturation and decay, the counters
    and every query are equal."""
    from parameter_server_tpu.utils import sketch as jsketch
    from parameter_server_tpu_torch.utils import sketch as tsketch

    rng = np.random.default_rng(n + cap)
    j = getattr(jsketch, cls)(n=n, k=3, cap=cap)
    t = getattr(tsketch, cls)(n=n, k=3, cap=cap)
    for step in range(6):
        keys = rng.zipf(1.2, keys_per_insert).astype(np.int64) * 7919 - 5
        counts = rng.integers(0, 9, keys.size).astype(np.uint32) if step % 2 else 1
        j.insert(keys, counts)
        if step % 3 == 2:
            pos = t.positions(keys)
            t.insert_at(pos, counts)
            assert np.array_equal(t.query_at(pos), j.query(keys))
        else:
            t.insert(keys, counts)
        if cls == "DecayCountMin" and step % 2:
            j.decay()
            t.decay()
        assert np.array_equal(j.data, t.data)
        probe = rng.integers(-50, 1 << 40, 3000)
        assert np.array_equal(j.query(probe), t.query(probe))
    assert int(t.data.max()) <= cap


def test_unique_counts_and_range_sums_equal_numpys():
    """The key heat's native helpers give np.unique's values and counts
    and np.add.at's per-range float64 sums, bit for bit."""
    from parameter_server_tpu_torch.utils.sketch import add_by_range, unique_counts

    rng = np.random.default_rng(5)
    x = (rng.zipf(1.1, 20000) * 977) % (1 << 31)
    uniq, cnt = unique_counts(x)
    want_u, want_c = np.unique(x, return_counts=True)
    assert np.array_equal(uniq, want_u) and np.array_equal(cnt, want_c)
    starts = np.array([0, 5000, 1 << 20, 1 << 30], np.int64)
    ours, theirs = np.full(4, 0.375), np.full(4, 0.375)
    add_by_range(ours, starts, uniq, cnt)
    np.add.at(theirs, np.searchsorted(starts, want_u, side="right") - 1, want_c.astype(np.float64))
    assert np.array_equal(ours, theirs) and ours.sum() > 20000


@pytest.mark.parametrize("pipelined", [False, True], ids=["serial", "pipelined"])
def test_worker_key_heat_equals_the_jax_key_heat(pipelined):
    """The worker folds its key heat on a thread of its own: after a train
    (and a minibatch) the plane's sketch, shares and top slots equal the
    JAX package's KeyHeat noted inline with the JAX directory's slots of
    the same batches, in the same order."""
    from parameter_server_tpu.parameter.parameter import KeyDirectory as JKeyDirectory
    from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDWorker
    from parameter_server_tpu_torch.benchmarks.headline import conf
    from parameter_server_tpu_torch.utils.sparse import random_sparse

    treg.set_enabled(True)
    c = conf("sparse", steps=2)
    c.async_sgd.num_slots = 1 << 14
    c.async_sgd.minibatch = 256
    batches = [random_sparse(256, 1 << 20, 24, seed=s, binary=True) for s in range(7)]
    worker = AsyncSGDWorker(c, device="cpu", name="heat_probe")
    worker.train(batches[:6], pipelined=pipelined)
    worker.process_minibatch(batches[6])
    theirs = jlearn.KeyHeat(worker.num_slots, 1)
    jdir = JKeyDirectory(c.async_sgd.num_slots, hashed=True)
    for b in batches:
        theirs.note(jdir.slots(np.asarray(b.indices)))
    ours = worker._learning.heat
    assert np.array_equal(ours._sketch.data, theirs._sketch.data)
    assert ours.shares() == theirs.shares()
    assert ours.top_slots() == theirs.top_slots() and len(ours.top_slots()) == 16
    assert worker._heat_feed is None


# -- dashboard and monitor --


def _reports(hb_mod):
    return {
        "W0": hb_mod.HeartbeatReport(hostname="hostA", total_time_milli=4200.0,
                                     busy_time_milli=1300.0, net_in_mb=1.5, net_out_mb=2.25,
                                     process_rss_mb=812.0, process_cpu_usage=0.42),
        "S0": hb_mod.HeartbeatReport(hostname="hostB-long-name", total_time_milli=9100.0,
                                     busy_time_milli=8000.0, net_in_mb=10.0,
                                     process_rss_mb=2048.0, process_cpu_usage=1.25),
        "H0": hb_mod.HeartbeatReport(hostname="hostC"),
    }


def test_dashboard_report_text_equal():
    texts = []
    for reg_mod, inst_mod, hb_mod, dash_mod in ((jreg, jinst, jhb, jdash), (treg, tinst, thb, tdash)):
        reg = reg_mod.MetricsRegistry()
        _drive(inst_mod.executor_instruments(reg), seed=5)
        d = dash_mod.Dashboard(registry=reg)
        for node, rep in _reports(hb_mod).items():
            d.add_report(node, rep)
        d.add_event("recovered W3 in 0.2s")
        texts.append(d.report())
    assert "hostB-long" in texts[0] and "telemetry:" in texts[0]
    assert texts[0] == texts[1]


def test_monitor_master_merges_equal():
    out = []
    for mon_mod in (jmon, tmon):
        master = mon_mod.MonitorMaster()
        master.set_data_merger(lambda src, dst: dst.extend(src))
        slavers = [mon_mod.MonitorSlaver(master, n) for n in ("W0", "W1")]
        for i in range(4):
            slavers[i % 2].report([i])
        out.append((master.progress(), master.duplicates_dropped()))
    assert out[0] == out[1] == ({"W0": [0, 2], "W1": [1, 3]}, 0)


# -- the device track: a torch.profiler trace, stitched by both packages --


def _torch_trace(tmp_path) -> str:
    """A Chrome trace in torch.profiler's form: CPU ops and launches on a
    host thread, kernels and a copy on a device stream, each kernel
    linked to its ``cudaLaunchKernel`` by an ``ac2g`` flow."""
    base_ns = 1_700_000_000 * 10 ** 9
    host, dev = 4242, 0
    ev = [
        {"ph": "M", "name": "process_name", "pid": host, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": dev, "tid": 0, "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "user_annotation", "name": "ps_update", "pid": host, "tid": 7,
         "ts": 990.0, "dur": 3000.0},
    ]
    kernels = [("void ftrl_dense_kernel<float>(...)", 1000.0, 1200.0, 40.0),
               ("segment_sum_kernel", 1100.0, 1300.0, 25.0),
               ("quantize_kernel", 2500.0, 2600.0, 30.0),
               ("flash_fwd_f32<64>", 5000.0, 5200.0, 80.0)]
    for corr, (name, t_launch, t_run, dur) in enumerate(kernels, start=11):
        ev += [
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": host, "tid": 7,
             "ts": t_launch, "dur": 5.0, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "pid": dev, "tid": 7, "ts": t_run,
             "dur": dur, "args": {"correlation": corr, "device": 0, "stream": 7}},
            {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": corr, "pid": host, "tid": 7,
             "ts": t_launch},
            {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": corr, "pid": dev, "tid": 7,
             "ts": t_run, "bp": "e"},
        ]
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
               "pid": dev, "tid": 9, "ts": 900.0, "dur": 50.0, "args": {"correlation": 99}})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": host, "tid": 7,
               "ts": 1000.0, "dur": 20.0})
    run = tmp_path / "prof" / "run-1"
    run.mkdir(parents=True)
    (run / "host.trace.json").write_text(json.dumps(
        {"baseTimeNanoseconds": base_ns, "traceEvents": ev}))
    return str(tmp_path / "prof")


def test_device_track_events_merge_like_the_jax_track(tmp_path):
    log_dir = _torch_trace(tmp_path)
    dev = tprof.device_track_events(log_dir)
    assert [e["name"] for e in dev] == [
        "device.Memcpy HtoD (Pageable -> Device)", "device.void ftrl_dense_kernel<float>(...)",
        "device.segment_sum_kernel", "device.quantize_kernel", "device.flash_fwd_f32<64>"]
    assert all(e["thread"].startswith("device:") and e["kind"] == "span" for e in dev)
    base = 1_700_000_000.0
    k = dev[1]
    assert k["t_wall"] == pytest.approx(base + 1200e-6) and k["dur_s"] == pytest.approx(40e-6)
    assert k["launch_t_wall"] == pytest.approx(base + 1000e-6)
    assert "launch_t_wall" not in dev[0]  # a copy with no launch record
    assert tprof.kernel_counts(log_dir) == {
        "void ftrl_dense_kernel<float>(...)": 1, "segment_sum_kernel": 1,
        "quantize_kernel": 1, "flash_fwd_f32<64>": 1}
    # two executor steps whose submit-to-finish spans hold the kernels
    host = [
        {"kind": "span", "name": "executor.step", "t_wall": base + 0.0027, "ts": 0,
         "flow": 1, "total_s": 0.0018, "thread": "executor:w"},
        {"kind": "span", "name": "executor.step", "t_wall": base + 0.0053, "ts": 1,
         "flow": 2, "total_s": 0.0006, "thread": "executor:w"},
    ]
    merged_j = jtl.merge_device_track(host, dev)
    merged_t = ttl.merge_device_track(host, dev)
    assert merged_j == merged_t
    flows = {e["name"]: e.get("flow") for e in merged_t if e["name"].startswith("device.")}
    assert flows["device.flash_fwd_f32<64>"] == 2
    assert flows["device.void ftrl_dense_kernel<float>(...)"] == 1
    assert jtl.to_chrome_trace(merged_j) == ttl.to_chrome_trace(merged_t)
    summary = tprof.summarize_trace(log_dir)
    assert summary["top_ops"][0]["name"] == "flash_fwd_f32<64>"
    assert summary["phases"]["ps_update"] == pytest.approx(0.095)
    assert summary["device_ms"] == pytest.approx(0.225)


def test_device_track_block_shift_to_a_host_anchor(tmp_path):
    log_dir = _torch_trace(tmp_path)
    dev = tprof.device_track_events(log_dir, host_anchor=50.0)
    assert dev[0]["t_wall"] == pytest.approx(50.0)
    assert dev[-1]["t_wall"] == pytest.approx(50.0 + 4300e-6)
    assert tprof.device_track_events(str(tmp_path / "none")) == []
    assert tprof.summarize_trace(str(tmp_path / "none")) is None


def test_device_annotation_is_a_null_context_without_a_profiler():
    import contextlib

    assert isinstance(ttl.device_annotation("step"), contextlib.nullcontext)


def test_profiling_has_no_jax_left():
    import inspect
    import re

    src = inspect.getsource(tprof) + inspect.getsource(ttl)
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
