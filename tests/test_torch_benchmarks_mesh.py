"""PyTorch port: the component suite's probes on the JAX suite's meshes,
inside one gloo world of 8 CPU ranks, beside the JAX suite on its 8 host
devices.

Every rank runs ``kv_vector``, ``kv_map``, ``kv_layer``,
``sparse_matrix``, ``serve``, ``decode_batching``, ``learning``,
``recovery_drill`` and ``consistency`` at smoke, each from a reset
process state, as ``python -m parameter_server_tpu_torch.benchmarks``
runs them on every rank of a launcher's world
(``tests/torch_serving_ranks.py::suite_rank``). ``learning`` and
``consistency`` start on the JAX ``_learning_mesh()``, 4 x 2; the others
on the JAX ``_mesh()``, 8 x 1, except ``recovery_drill``, which is not run
across ranks: rank 0 drills a table of its own (1 x 1) and the other
ranks return a follower's record. Rank 0 alone prints; the serving
probes run on rank 0 while the other ranks follow its store calls. Each
record carries the mesh its store ran on; the records' structural contracts are the
one-card tests' (``tests/test_torch_benchmarks_planes.py``), and
``learning`` and ``consistency`` report the JAX records' shard count on
8 devices. No time or rate is asserted.
"""

import numpy as np
import pytest

from parameter_server_tpu.benchmarks import components as jcomp
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch.parallel import launch
from tests import torch_serving_ranks as ranks
from tests.test_torch_benchmarks_cli import port_name

DATA_ONLY = ["kv_vector", "kv_map", "kv_layer", "sparse_matrix", "serve", "decode_batching",
             "recovery_drill"]
TWO_SHARDS = ["learning", "consistency"]
RANK0_ALONE = ["recovery_drill"]  # drilled on rank 0's own one-position table


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import os

    out = tmp_path_factory.mktemp("suite_mesh")
    os.environ["PS_CONSISTENCY_OUT"] = str(out / "consistency.json")
    try:
        results = launch.run_world(ranks.suite_rank, 8, args=(DATA_ONLY + TWO_SHARDS,),
                                   device_type="cpu", timeout=300, quiet=True)
    finally:
        del os.environ["PS_CONSISTENCY_OUT"]
    return results


@pytest.fixture(scope="module")
def jax_records():
    JPostoffice.reset()
    try:
        return {"learning": jcomp.learning_truth(True), "consistency": jcomp.consistency_ab(True)}
    finally:
        JPostoffice.reset()


@pytest.mark.parametrize("name", DATA_ONLY + TWO_SHARDS)
def test_records_carry_the_jax_suites_meshes(world, name):
    if name in RANK0_ALONE:
        assert world[0][0][name]["mesh"] == {"data": 1, "server": 1}
        assert all(recs[name] == {"follower": True} for recs, _ in world[1:])
        return
    want = {"data": 4, "server": 2} if name in TWO_SHARDS else {"data": 8, "server": 1}
    for recs, _ in world:
        assert recs[name]["mesh"] == want


@pytest.mark.parametrize("name", DATA_ONLY + TWO_SHARDS)
def test_rank_zero_alone_prints(world, name):
    (recs0, lines0), rest = world[0], world[1:]
    assert lines0[name] and all(not lines[name] for _, lines in rest)
    assert {m["metric"]: m["value"] for m in lines0[name]} == {
        k: round(v, 2) for k, v in recs0[name]["metrics"].items()}
    assert all(port_name(m["metric"]) is None or m["value"] > 0 for m in lines0[name])


@pytest.mark.parametrize("name", ["serve", "decode_batching"])
def test_serving_probes_run_on_rank_zero_and_the_rest_follow(world, name):
    (recs0, _), rest = world[0], world[1:]
    assert not recs0[name].get("follower")
    assert all(recs[name] == {"follower": True, "mesh": {"data": 8, "server": 1}}
               for recs, _ in rest)


def test_serve_record_has_the_jax_sections(world):
    rec = world[0][0]["serve"]
    low, over = rec["points"]
    assert (low["offered_multiple_of_capacity"], over["offered_multiple_of_capacity"]) == (0.25, 3.0)
    assert rec["coalesce"]["concurrent_requests"] == 200
    assert rec["coalesce"]["submits"] < rec["coalesce"]["requests"]
    assert rec["decode"]["requests"] == 2 and rec["decode"]["tokens_per_sec"] > 0
    for p in (low, over, rec["no_admission_overload"]):
        assert p["n_errors"] == 0


def test_decode_batching_parity_and_device_replica(world):
    rec = world[0][0]["decode_batching"]
    (arm,) = rec["arms"]
    assert arm["parity"] == "token-identical per session (asserted)"
    dr = rec["device_replica"]
    assert dr["degraded_served"] == 0 and dr["requests_served"] > 0 and dr["device"] is True


def test_learning_at_two_server_shards(world, jax_records):
    jrec = jax_records["learning"]
    for recs, _ in world:
        rec = recs["learning"]
        assert rec["config"]["num_shards"] == jrec["config"]["num_shards"] == 2
        assert rec["staleness"]["within_bound"]
        assert rec["heat_parity"]["upper_bound_frac"] == 1.0
        assert rec["examples"] == jrec["examples"] == 24 * 128
        assert all(np.isfinite(p["loss"]) for p in rec["trajectory_tail"])
        drill = rec["divergence_drill"]
        assert drill["fired"] and drill["bundle_captured"]
    assert len(world[0][0]["learning"]["shards"]["shares"]) == len(jrec["shards"]["shares"]) == 2


def test_consistency_at_two_server_shards(world, jax_records):
    jrec = jax_records["consistency"]
    rec = world[0][0]["consistency"]
    assert rec["workload"]["num_shards"] == jrec["workload"]["num_shards"] == 2
    for arm in rec["tau_arms"].values():
        assert arm["staleness"]["within_bound"], arm
    trace = rec["tau_arms"]["adaptive"]["controller"]["trace"]
    assert max(trace) > trace[0]
    on = rec["significance_filter"]["on"]
    assert on["accounting"]["reconciled"] and on["counter_reconciled"]
    assert on["accounting"]["suppressed"] > 0
    drill = rec["divergence_drill"]
    assert drill["episodes"] and drill["episodes"][0]["rolled_back"]
    assert drill["alert_fired"] and drill["bundle_captured"] and drill["reconverged"]


def test_recovery_drill_on_rank_zero_ends_on_the_undisturbed_table(world):
    """Rank 0 drills its own table and ends bit for bit on the undisturbed
    run's; the other ranks follow (no drill of their own)."""
    rec = world[0][0]["recovery_drill"]
    assert rec["trajectory_bit_identical"] and rec["trainer_parked"]
    assert rec["replayed_updates"] > 0 and rec["serve"]["failed"] == 0
    assert all(recs["recovery_drill"] == {"follower": True} for recs, _ in world[1:])


def test_store_probes_run_on_every_rank(world):
    for recs, _ in world:
        assert recs["kv_vector"]["table_bytes"] > 0 and recs["kv_layer"]["shape"] == [256, 64]
        assert recs["sparse_matrix"]["nnz"] > 0 and recs["kv_map"]["n_keys"] == 1 << 12
