"""PyTorch port: the component suite's plane probes
(``benchmarks/components.py``: ``serve``, ``decode_batching``, ``trace``,
``bundle``, ``history_ab``, ``learning``, ``recovery_drill``,
``consistency``) at smoke on the CPU beside the JAX package's, with the
structural contracts each asserts in its record. No speed ratio or wall
time is asserted.
"""

import json

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch.benchmarks import components as tcomp
from parameter_server_tpu_torch.system.postoffice import Postoffice
from tests.test_torch_benchmarks_cli import check_against_jax, run_port

torch.set_num_threads(1)

BENCHMARKS = ["serve", "decode_batching", "trace", "bundle", "history_ab", "learning",
              "recovery_drill", "consistency"]


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("planes")


@pytest.mark.parametrize("name", BENCHMARKS)
def test_benchmark_lines_map_onto_the_jax_lines(name, out_dir):
    rec, _ = check_against_jax(name, out_dir)
    assert rec["metrics"]


def test_divergence_drill_fires_with_bundle():
    """As the JAX drill (tests/test_learning.py): the seeded blow-up
    drives the shipped loss_divergence rule to firing with a bundle
    captured through the alert trigger, and the rule resolves."""
    Postoffice.reset()
    try:
        out = tcomp._divergence_drill("cpu", smoke=True)
    finally:
        Postoffice.reset()
    assert out["divergence_counts"].get("nonfinite", 0) >= 1
    assert out["fired"]
    assert "firing" in out["states_seen"]
    assert out["resolved"]
    assert out["bundle_captured"]
    assert out["bundle_trigger"]["kind"] == "alert"
    assert out["bundle_trigger"]["detail"] == "loss_divergence"


def test_consistency_drill_finds_its_bundle_with_the_store_full():
    """The bundle store keeps its last four bundles; once earlier work in
    the process has filled it, a new bundle leaves its length as it was.
    The drill finds its rollback bundle by identity, so it is found."""
    from parameter_server_tpu_torch.telemetry import blackbox

    Postoffice.reset()
    prev = blackbox.set_min_interval(0.0)
    try:
        for i in range(4):
            blackbox.trigger_bundle("alert", detail=f"earlier {i}")
        assert len(blackbox.bundles()) == 4
        out = tcomp._consistency_divergence_drill("cpu", smoke=True)
    finally:
        blackbox.set_min_interval(prev)
        blackbox.reset()
        Postoffice.reset()
    assert out["bundle_captured"] and out["bundle_trigger"]["kind"] == "consistency_rollback"
    assert out["episodes"] and out["episodes"][0]["rolled_back"]


def test_consistency_structural_contract_at_smoke(out_dir):
    """The contract consistency_perf asserts in every mode: bounded delay
    in each arm, the controller widened τ, the KKT accounting reconciled
    with ps_push_keys_total with keys suppressed, the drill rolled back,
    alerted, bundled and converged again; the record written where
    PS_CONSISTENCY_OUT points."""
    rec, _ = run_port("consistency", out_dir)
    for arm in rec["tau_arms"].values():
        assert arm["staleness"]["within_bound"], arm
    trace = rec["tau_arms"]["adaptive"]["controller"]["trace"]
    assert max(trace) > trace[0]
    on = rec["significance_filter"]["on"]
    assert on["accounting"]["reconciled"] and on["counter_reconciled"]
    assert on["accounting"]["suppressed"] > 0
    assert on["push_keys_counter"] == on["accounting"]["pushed"]
    assert on["update_path"] == "torch_ref"  # the sparse update's plain version on the CPU
    drill = rec["divergence_drill"]
    assert drill["episodes"] and drill["episodes"][0]["rolled_back"]
    assert drill["alert_fired"] and drill["bundle_captured"] and drill["reconverged"]
    assert drill["bundle_trigger"]["kind"] == "consistency_rollback"
    assert rec["workload"]["num_shards"] == 1
    assert rec["workload"]["emulated_pull_rtt_ms"] == 25.0
    saved = json.loads((out_dir / "port_consistency.json").read_text())
    assert saved["consistency_record"]["workload"] == rec["workload"]


def test_decode_batching_token_parity_in_bench(out_dir):
    """Each rep asserts every session's batched tokens equal to its
    sequential run (the bench raises otherwise); the device replica over
    its host budget answered every request undegraded."""
    rec, _ = run_port("decode_batching", out_dir)
    (arm,) = rec["arms"]
    assert arm["slots"] == 8 and arm["sessions"] == 16
    assert arm["parity"] == "token-identical per session (asserted)"
    dr = rec["device_replica"]
    assert dr["degraded_served"] == 0 and dr["requests_served"] > 0
    assert dr["over_budget_factor"] == 2.0 and dr["device"] is True


def test_learning_record_is_one_shard(out_dir):
    rec, _ = run_port("learning", out_dir)
    assert rec["config"]["num_shards"] == 1
    assert rec["staleness"]["within_bound"]
    assert rec["heat_parity"]["upper_bound_frac"] == 1.0
    assert rec["examples"] == 24 * 128
    assert all(np.isfinite(p["loss"]) for p in rec["trajectory_tail"])


def test_recovery_drill_record(out_dir):
    rec, _ = run_port("recovery_drill", out_dir)
    assert rec["trajectory_bit_identical"] and rec["trainer_parked"]
    assert rec["replayed_updates"] > 0 and rec["serve"]["failed"] == 0


def test_trace_and_bundle_write_where_pointed(out_dir):
    tr, _ = run_port("trace", out_dir)
    bd, _ = run_port("bundle", out_dir)
    assert tr["trace_json"] == str(out_dir / "port_trace.json")
    trace = json.loads((out_dir / "port_trace.json").read_text())
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])
    assert bd["bundle_json"] == str(out_dir / "port_bundle.json")
    assert bd["stale_nodes"] == ["S0"]
    assert json.loads((out_dir / "port_bundle.json").read_text())["trigger"]


def test_serve_record_has_the_jax_sections(out_dir):
    rec, _ = run_port("serve", out_dir)
    low, over = rec["points"]
    assert (low["offered_multiple_of_capacity"], over["offered_multiple_of_capacity"]) == (0.25, 3.0)
    assert low["admission"] == over["admission"] == "on"
    assert rec["no_admission_overload"]["admission"] == "off"
    assert rec["coalesce"]["concurrent_requests"] == 200
    assert rec["decode"]["requests"] == 2 and rec["decode"]["tokens_per_sec"] > 0
