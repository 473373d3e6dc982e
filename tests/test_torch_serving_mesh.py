"""PyTorch port: the serving plane over a data x server mesh of ranks
(frontend, coalescer, host and device read replicas, an elastic resize
under traffic) against the JAX package's ``mesh8`` serving tests.

The port's side runs in one gloo world of 8 CPU ranks
(``tests/torch_serving_ranks.py::serving_world``): the JAX tests' cases
on a 4x2 mesh, rank 0 driving each through its order
(``parallel/sequence.py``) while the other ranks follow, then a full
replica on a 1x2 mesh, and a resize from 2x2 to 2x3 under traffic. The
JAX side runs the same pushes into a ``KVVector`` on the suite's 8
virtual devices (4x2) in the test process. Tolerances: the values
served, pulled and snapshotted are **bit-equal** to the JAX store's (one
push each, or pushes added in the same order); predict scores within
``rtol=1e-6`` of the sigmoid the JAX test computes; token ids equal.
"""

import numpy as np
import pytest

from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch.parallel import launch
from tests import torch_serving_ranks as ranks


@pytest.fixture(scope="module")
def world():
    results = launch.run_world(ranks.serving_world, 8, device_type="cpu", timeout=240)
    return results[0]["cases"], results


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    return a.view(np.uint32)


def _same(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


def _jax_values(mesh8, keys, extra=()):
    """The JAX store of the tests' ``_store`` on ``mesh8``, with the
    ``extra`` pushes after the warm one; its values of ``keys``."""
    JPostoffice.reset()
    try:
        wkeys, wvals = ranks.warm()
        jkv = JKVVector(mesh=mesh8, k=1, num_slots=1 << 12, hashed=True, name="serve_test")
        jkv.wait(jkv.push(jkv.request(channel=0), keys=wkeys, values=wvals))
        for k, v in extra:
            jkv.wait(jkv.push(jkv.request(channel=0), keys=k, values=v))
        return np.asarray(jkv.values(0, keys))
    finally:
        JPostoffice.reset()


def _case(cases, name):
    rec = cases[name]
    assert "error" not in rec, rec.get("error")
    return rec


KEYS = ranks.warm()[0]


# -- the order and the ranks' tables --


def test_every_server_column_holds_equal_shards(world):
    """The calls rank 0 made reached every rank in one order: after each
    case the ranks of a server column hold bit-equal shards."""
    _, results = world
    for case in results[0]["digests"]:
        by_shard = {}
        for r in results:
            coords = r["resize_coords"] if case == "resize" else r["coords"]
            if coords is None or not r["digests"][case]:
                continue
            by_shard.setdefault(coords[1], set()).add(r["digests"][case])
        assert by_shard and all(len(d) == 1 for d in by_shard.values()), (case, by_shard)


def test_ranks_that_disagree_on_the_order_fail_loudly(world):
    _, results = world
    for r in results:
        assert r["disagreement"] is not None and "disagree" in r["disagreement"], r["rank"]


# -- TestCoalescer --


def test_concurrent_pulls_match_direct_with_fewer_submits(world, mesh8):
    cases, _ = world
    rec = _case(cases, "coalescer_concurrent")
    assert not rec["errors"]
    for req, got, direct in zip(rec["reqs"], rec["results"], rec["direct"]):
        assert _same(got, direct)
        assert _same(got, _jax_values(mesh8, req))
    stats = rec["stats"]
    assert stats["requests"] == len(rec["reqs"])
    assert stats["submits"] < stats["requests"]
    assert stats["key_dedup_factor"] > 1.0


def test_duplicate_keys_within_one_request(world, mesh8):
    cases, _ = world
    rec = _case(cases, "coalescer_duplicates")
    assert _same(rec["got"], rec["want"]) and _same(rec["got"], _jax_values(mesh8, rec["req"]))


def test_store_failure_propagates_to_every_waiter_and_is_never_published(world):
    cases, _ = world
    rec = _case(cases, "coalescer_failure")
    assert rec["errors"] == ["coalesced pull failed"] * 2
    assert rec["calls_published"] == 0  # decided on rank 0 before publication


def test_close_rejects_new_and_flushes_staged(world, mesh8):
    cases, _ = world
    rec = _case(cases, "coalescer_close")
    assert _same(rec["got"], rec["want"]) and _same(rec["got"], _jax_values(mesh8, KEYS[:8]))
    assert "closed" in rec["closed"]


# -- TestReadReplica --


def test_snapshot_consistency_across_pushes(world, mesh8):
    cases, _ = world
    rec = _case(cases, "replica_snapshot")
    assert rec["hit"].all()
    assert _same(rec["before"], rec["want_before"])
    assert _same(rec["before"], _jax_values(mesh8, KEYS[:16]))
    assert _same(rec["again"], rec["before"])  # the snapshot held
    assert rec["v1"] == 2
    ones = [(KEYS[:16], np.ones((16, 1), np.float32))]
    assert _same(rec["after"], _jax_values(mesh8, KEYS[:16], ones))
    assert rec["nbytes"] == (1 << 12) * 4  # the whole table, gathered over the server axis


@pytest.mark.parametrize("case", ["replica_push_stream", "device_push_stream"])
def test_reads_survive_concurrent_push_stream(world, case):
    cases, _ = world
    rec = _case(cases, case)
    assert not rec["push_errors"] and not rec["bad"] and rec["reads"] > 0
    assert rec["device_table"] == (case == "device_push_stream")


def test_hot_key_replica_reports_misses(world, mesh8):
    cases, _ = world
    rec = _case(cases, "replica_hot")
    assert rec["hot_nbytes"] < rec["full_nbytes"]
    assert rec["hit"][:4].all() and not rec["hit"][4:].any()
    assert _same(rec["vals"][:4], rec["want"])
    assert _same(rec["vals"][:4], _jax_values(mesh8, KEYS[:4]))


def test_miss_counter_counts_keys_not_requests(world):
    cases, _ = world
    rec = _case(cases, "replica_miss_counter")
    assert rec["hit"][:3].all() and not rec["hit"][3:].any()
    assert rec["misses"] == 5 and rec["hits"] == 3


def test_snapshot_step_serializes_with_pushes(world, mesh8):
    cases, _ = world
    rec = _case(cases, "snapshot_serializes")
    assert rec["rows"] == rec["num_slots"]  # whole, not this rank's shard
    sevens = [(KEYS[:8], np.full((8, 1), 7.0, np.float32))]
    assert _same(rec["got"], rec["want"]) and _same(rec["got"], _jax_values(mesh8, KEYS[:8],
                                                                            sevens))


# -- TestDeviceReplica --


def test_device_matches_host_full_and_hot(world, mesh8):
    cases, _ = world
    rec = _case(cases, "device_matches_host")
    assert rec["dev_tensor"] and rec["host_numpy"]
    want = _jax_values(mesh8, KEYS[:100])
    for n, (vh, vd, hit) in rec["widths"].items():
        assert hit.all() and _same(vh, vd) and _same(vh, want[:n]) and _same(vh, rec["want"][:n])
    (vh, mh), (vd, md) = rec["hot"]
    assert np.array_equal(mh, md) and _same(vh, vd)


def test_host_budget_fails_loudly_device_ignores_it(world, mesh8):
    cases, _ = world
    rec = _case(cases, "host_budget")
    assert rec["refused"] and "device=True" in rec["refused"]
    assert rec["hit"].all() and _same(rec["vals"], rec["want"])
    assert _same(rec["vals"], _jax_values(mesh8, KEYS[:8]))


def test_device_frontend_over_host_budget_zero_degraded(world):
    cases, _ = world
    rec = _case(cases, "device_frontend_zero_degraded")
    assert rec["served"] > 0 and rec["wrong"] == 0
    assert rec["degraded_served"] == 0 and rec["degraded"] == 0
    assert rec["device"] is True and rec["replica_device"]


# -- TestFrontend --


def test_pull_predict_and_telemetry(world, mesh8):
    cases, _ = world
    rec = _case(cases, "frontend_pull_predict")
    assert _same(rec["got"], rec["want"]) and _same(rec["got"], _jax_values(mesh8, KEYS[:12]))
    w = _jax_values(mesh8, KEYS[:6]).ravel()
    assert _same(rec["w"], w)
    want = 1 / (1 + np.exp(-np.array([w[:2].sum(), w[2:6].sum()])))
    np.testing.assert_allclose(rec["scores"], want, rtol=1e-6)
    assert rec["telemetry"] and "closed" in rec["closed"]


def test_hot_replica_miss_falls_through_to_live_pull(world, mesh8):
    cases, _ = world
    rec = _case(cases, "frontend_hot_fallthrough")
    mixed = np.concatenate([KEYS[:8], KEYS[-8:]])
    assert _same(rec["got"], rec["want"]) and _same(rec["got"], _jax_values(mesh8, mixed))
    assert rec["live"] >= 1


def test_live_pull_receives_exactly_the_missed_keys(world):
    cases, _ = world
    rec = _case(cases, "live_pull_missed_keys")
    assert _same(rec["got"], rec["want"])
    assert len(rec["seen"]) == 1 and np.array_equal(np.sort(rec["seen"][0]), np.sort(rec["cold"]))


def test_shed_is_explicit_and_counted(world):
    cases, _ = world
    rec = _case(cases, "frontend_shed")
    assert rec["shed"] > 0 and rec["ok"] > 0 and set(rec["reasons"]) <= {"rate", "queue"}
    assert rec["counted"] >= rec["shed"]


def test_decode_equals_plain_greedy(world):
    cases, _ = world
    rec = _case(cases, "frontend_decode")
    assert np.array_equal(rec["served"], rec["plain"])


def test_decode_backlog_sheds_decode_not_pulls(world):
    cases, _ = world
    rec = _case(cases, "decode_backlog")
    assert rec["reason"] == "queue" and _same(rec["got"], rec["want"])
    assert len(rec["decoded"]) == 2


def test_pull_backlog_sheds_pulls_not_decode(world):
    cases, _ = world
    rec = _case(cases, "pull_backlog")
    assert rec["reason"] == "queue"
    assert np.array_equal(rec["decoded"], np.zeros((1, 4), np.int32))
    assert all(_same(p, rec["want"]) for p in rec["pulled"])


def test_a_frontend_that_fails_its_build_on_rank_zero_leaves_no_follower_waiting(world):
    """Rank 0's frontend raises at its build (decode_fn and batcher both
    given) after every rank built the order: the caller closes the order,
    every follower returns, and the world goes on to its next case."""
    cases, results = world
    rec = _case(cases, "frontend_build_fails")
    assert "decode_fn" in rec["raised"] and "batcher" in rec["raised"]
    assert rec["calls"] == 0
    assert all("frontend_build_fails" in r["digests"] for r in results)


def test_bad_replica_config_leaks_no_threads(world):
    cases, _ = world
    errs = cases["bad_replica_config"]["errors"]
    assert "hot_keys" in errs[0] and "'off'" in errs[1]
    assert cases["bad_replica_config"]["leaked"] == 0


def test_concurrent_submits_never_exceed_depth_bound(world):
    cases, _ = world
    rec = _case(cases, "depth_bound")
    assert rec["accepted"] == rec["depth"] == 16


def test_wrong_channel_and_missing_decode_rejected_at_door(world):
    cases, _ = world
    msgs = _case(cases, "door_checks")["messages"]
    assert "channel" in msgs[0] and "channel" in msgs[1] and "decode_fn" in msgs[2]


def test_open_loop_point_shape_and_rates(world):
    cases, _ = world
    rec = _case(cases, "loadgen_point")["rec"]
    assert 60 <= rec["offered"] <= 140
    assert rec["n_errors"] == 0 and rec["completed"] == rec["accepted"]
    lat = rec["latency_ms"]
    assert lat["p50_ms"] <= lat["p99_ms"] <= lat["max_ms"] + 1e-9
    assert rec["goodput_per_sec"] > 0


def test_a_faulted_live_pull_is_never_published(world, mesh8):
    """``serve.pull`` fails rank 0's live pull before the coalescer
    publishes it: the request degrades (no replica: the 503), the next is
    served, and the followers agreed the order at close."""
    cases, _ = world
    rec = _case(cases, "serve_pull_fault")
    assert rec["first"] == "no-replica"
    assert _same(rec["got"], rec["want"]) and _same(rec["got"], _jax_values(mesh8, KEYS[:4]))


def test_a_live_pull_past_its_deadline_degrades_and_still_runs_everywhere(world, mesh8):
    cases, _ = world
    rec = _case(cases, "live_pull_deadline")
    assert rec["degraded_served"] == 1
    assert _same(rec["got"], rec["want"]) and _same(rec["got"], _jax_values(mesh8, KEYS[:4]))


# -- a full replica over server shards --


def test_full_replica_on_1x2_serves_both_shards(world, mesh8):
    """The replica's refresh is the whole table (the row's shards
    gathered), so every key is served, whichever shard holds it."""
    cases, _ = world
    rec = _case(cases, "full_1x2")
    assert rec["rows"] == 2 * rec["shard_rows"]
    assert (rec["slots"] < rec["shard_rows"]).any() and (rec["slots"] >= rec["shard_rows"]).any()
    assert rec["hit"].all() and _same(rec["vals"], rec["want"])
    assert _same(rec["vals"], _jax_values(mesh8, KEYS))


# -- TestServeAcrossElasticResize --


def test_traffic_queues_or_sheds_never_errors_across_resize(world, mesh8):
    cases, _ = world
    rec = _case(cases, "resize")
    assert not rec["errors"], rec["errors"]
    assert rec["outcomes"]["wrong"] == 0
    assert rec["before"]["ok"] > 0, "no traffic completed before the resize"
    assert rec["outcomes"]["ok"] > rec["before"]["ok"], ("no traffic after the resize", rec)
    assert _same(rec["after"], rec["expect"])
    assert [(h["old"], h["new"]) for h in rec["history"]] == [((2, 2), (2, 3))]
    assert rec["shard_rows"] == 334  # 1000 padded to 1002 over 3 shards
    keys, vals = rec["pushed"]
    JPostoffice.reset()
    try:
        jkv = JKVVector(mesh=mesh8, k=1, num_slots=ranks.RESIZE_SLOTS, hashed=True, name="el")
        jkv.wait(jkv.push(jkv.request(channel=0), keys=keys, values=vals))
        assert _same(rec["expect"], np.asarray(jkv.values(0, keys)))
    finally:
        JPostoffice.reset()

