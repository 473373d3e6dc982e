"""PyTorch port: live repartitioning over server shards
(``parallel/partition.py``'s rebalance half, ``KVVector.migrate`` and the
replica hooks on a mesh) against the JAX package.

The port's side runs in one gloo world of 8 CPU ranks
(``tests/torch_elastic_ranks.py::rebalance_cases``: every case on every
rank, each case's mesh a prefix of the world); the JAX side runs the
same cases in the test process on the suite's 8 virtual CPU devices
(``tests/test_rebalance.py``'s data, perms and meshes). Tolerances:

- plans (``perm`` and ``moves``) from the same heat: **equal**;
- base-layout tables after migrations, journal replays, recoveries and
  reshards: **bit-equal** to the port's undisturbed run and to the JAX
  store's table (both add each push's entries in entry order, from
  the same start);
- pulled values: bit-equal to the undisturbed store's pulls;
- every rank of a data row reports the same whole table.
"""

import threading
import time

import jax
import numpy as np
import pytest

from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.parallel import partition as jpart
from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector
from parameter_server_tpu.system import faults as jfaults
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.telemetry.learning import KeyHeat as JKeyHeat
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.parallel import partition as tpart
from parameter_server_tpu_torch.telemetry.learning import KeyHeat as TKeyHeat
from tests import torch_elastic_ranks as ranks

#: the parity case's meshes: 2, 4 and 8 server shards over the 8 ranks
LAYOUTS = [(4, 2), (2, 4), (1, 8)]
PERM_SEEDS = {"parity": 11, "exact": 5, "one": 1, "two": 2, "nine": 9, "four": 4, "six": 6,
              "eight": 8}


def _batches(n, k=2, seed=3, n_keys=40, key_space=997):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = np.sort(rng.choice(key_space, size=n_keys, replace=False)).astype(np.int64)
        vals = rng.normal(size=(n_keys, k)).astype(np.float32)
        out.append((keys, vals))
    return out


def _perm(num_slots, seed):
    return np.random.default_rng(seed).permutation(num_slots).astype(np.int64)


def _jstore(d, s, num_slots=64, k=2, hashed=True, name="jreb", keys=None):
    mesh = jmesh.make_mesh(num_data=d, num_server=s, devices=jax.devices()[:d * s])
    kv = JKVVector(mesh=mesh, k=k, num_slots=num_slots, hashed=hashed, name=name)
    if keys is not None:
        kv.set_keys(0, keys)
    return kv


def _jpush_all(kv, batches):
    for keys, vals in batches:
        kv.push(kv.request(channel=0), keys=keys, values=vals)
    kv.executor.wait_all(pop=False)


def _jax_side(batches, batches48):
    """The JAX stores' tables for the cases the port is held to."""
    keys40 = np.arange(40, dtype=np.int64)
    vals40 = [v for _, v in batches]
    out = {}
    JPostoffice.reset()
    jfaults.reset()
    try:
        for d, s in LAYOUTS:
            kv = _jstore(d, s, name=f"jmig{d}x{s}")
            for i, (keys, vals) in enumerate(batches):
                if i == 3:
                    kv.migrate(_perm(64, PERM_SEEDS["parity"]))
                kv.push(kv.request(channel=0), keys=keys, values=vals)
            kv.executor.wait_all(pop=False)
            out[f"parity_{d}x{s}"] = kv.get_replica()[0]
        ref = _jstore(4, 2, hashed=False, name="jref", keys=keys40)
        prefixes = []
        for v in vals40:
            _jpush_all(ref, [(keys40, v)])
            prefixes.append(ref.get_replica()[0])
        out["exact_prefixes"] = prefixes  # the exact store after 1..6 pushes
        kv = _jstore(4, 2, hashed=False, name="jtwice", keys=keys40)
        _jpush_all(kv, [(keys40, v) for v in vals40[:2]])
        kv.migrate(_perm(kv.num_slots, PERM_SEEDS["one"]))
        _jpush_all(kv, [(keys40, v) for v in vals40[2:4]])
        kv.migrate(_perm(kv.num_slots, PERM_SEEDS["two"]))
        out["composed"] = kv.get_replica()[0]
        out["composed_layout"] = kv.layout(0)
        ctl = _jstore(1, 8, hashed=False, name="jctl", keys=np.arange(48, dtype=np.int64))
        _jpush_all(ctl, [(np.arange(48, dtype=np.int64), v) for v in batches48])
        out["controller_ref"] = ctl.get_replica()[0]
        hashed = _jstore(4, 2, name="jcons")
        prefixes = []
        for b in batches:
            _jpush_all(hashed, [b])
            prefixes.append(hashed.get_replica()[0])
        out["hashed_prefixes"] = prefixes
    finally:
        JPostoffice.reset()
        jfaults.reset()
    return out


@pytest.fixture(scope="module")
def runs():
    batches = _batches(6)
    batches48 = [v for _, v in _batches(3, n_keys=48)]
    perms = {name: _perm(64, seed) for name, seed in PERM_SEEDS.items()}
    port = launch.run_world(ranks.rebalance_cases, 8, args=(batches, batches48, perms, LAYOUTS),
                            device_type="cpu", timeout=300)
    return batches, batches48, perms, port, _jax_side(batches, batches48)


def _bits(a):
    return np.asarray(a).tobytes()


def _active(port, key):
    return [r[key] for r in port if r[key] is not None]


# -- TestMigrate --


def test_rejects_non_bijection(runs):
    port = runs[3]
    for r in port:
        assert len(r["reject"]) == 2
        assert all(e is not None and "bijection" in e for e in r["reject"]), r["reject"]


@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{d}x{s}" for d, s in LAYOUTS])
def test_bit_parity_vs_undisturbed_hashed(runs, layout):
    """Migrating mid-stream over 2, 4 and 8 server shards leaves the
    base-layout table bit-identical to a run that never migrated, on
    every rank, and to the JAX store migrated at the same point."""
    d, s = layout
    _, _, _, port, jx = runs
    recs = _active(port, f"parity_{d}x{s}")
    assert len(recs) == d * s
    for rec in recs:
        assert rec["mig3"]["rows_moved"] > 0 and rec["mig3"]["attempts"] == 1
        assert _bits(rec[None]) == _bits(rec[3])
        assert _bits(rec[3]) == _bits(jx[f"parity_{d}x{s}"])
        assert rec[3].shape == (64, 2) and rec["shard3"].shape == (64 // s, 2)


def test_pull_routing_and_values_survive_migration_exact_dir(runs):
    port = runs[3]
    recs = _active(port, "exact")
    assert len(recs) == 8
    for rec in recs:
        assert rec["attempts"] == 1 and rec["layout"] is not None
        assert _bits(rec["before"]) == _bits(rec["after"])
        s = rec["coords"][1]
        # this rank's rows of the physical (current-layout) table
        cur = np.empty_like(rec["base"])
        cur[rec["layout"]] = rec["base"]
        assert _bits(cur[s * 32:(s + 1) * 32]) == _bits(rec["shard"])
        assert _bits(cur) != _bits(rec["base"])
    assert _bits(recs[0]["base"]) == _bits(runs[4]["exact_prefixes"][2])


def test_composed_migrations_stack(runs):
    port, jx = runs[3], runs[4]
    for rec in _active(port, "composed"):
        assert _bits(rec["table"]) == _bits(jx["exact_prefixes"][3])
        assert _bits(rec["table"]) == _bits(jx["composed"])
        np.testing.assert_array_equal(rec["layout"], jx["composed_layout"])
        assert _bits(rec["pulled"]) == _bits(jx["exact_prefixes"][3][:40])


def test_snapshot_roundtrip_across_migration(runs):
    port, jx = runs[3], runs[4]
    for rec in _active(port, "roundtrip"):
        assert _bits(rec["table"]) == _bits(rec["snap"])
        assert _bits(rec["snap"]) == _bits(jx["exact_prefixes"][2])
        assert _bits(rec["pulled"]) == _bits(jx["exact_prefixes"][2][:40])


# -- TestJournalReplay --


def test_pushes_landing_mid_migration_replay_bit_identically(runs):
    port, jx = runs[3], runs[4]
    for rec in _active(port, "journal"):
        assert not rec["alive"]
        res = rec["result"]
        assert res["journaled"] >= 1 and res["replayed"] == res["journaled"]
        assert _bits(rec["table"]) == _bits(jx["exact_prefixes"][3])


# -- TestServeContinuity --


def test_pull_stream_across_migration_completes_every_request(runs):
    """A pull stream across six migrations (the first stalled) returns the
    undisturbed bytes on every pull, with no failure: every rank of a row
    flips between the same two pulls (a pull straddling ranks that flipped
    at different pulls would add a key's row twice or not at all)."""
    recs = _active(runs[3], "serve")
    assert len(recs) == 8
    for rec in recs:
        assert not rec["alive"] and rec["attempts"] == [1] * 6
        assert rec["failed"] == 0 and rec["wrong"] == 0
        assert rec["ok"] > 0
        # each data row agreed where its stream ends
        assert {r["ok"] for r in recs if r["coords"][0] == rec["coords"][0]} == {rec["ok"]}


# -- TestRecoveryComposition --


def test_restore_landing_mid_migration_forces_resnapshot(runs):
    for rec in _active(runs[3], "recovery"):
        ref, mig = rec[False], rec[True]
        assert ref["recovered"] and mig["recovered"]
        assert mig["result"]["attempts"] >= 2  # the stale image was discarded
        assert mig["layout"] is not None  # ...and the move still landed
        assert _bits(mig["table"]) == _bits(ref["table"])


def test_migrate_gives_up_after_max_attempts(runs):
    for rec in _active(runs[3], "giveup"):
        assert rec["err"] is not None and "could not complete" in rec["err"]
        assert rec["layout"] is None


# -- TestKeyHeatRebase --


def test_rebase_translates_candidates_and_resets_window():
    perm = np.arange(64)
    perm[0], perm[63] = 63, 0
    seen = []
    for cls in (JKeyHeat, TKeyHeat):
        heat = cls(num_slots=64, num_shards=8, top_k=16, decay_every=1 << 30)
        hot = np.arange(8)
        heat.note(np.repeat(hot, 40))
        assert heat.shares()["imbalance"] == pytest.approx(8.0)
        heat.rebase(perm)
        s = heat.shares()
        assert s["total_weight"] == 0.0 and s["imbalance"] is None
        heat.note(np.repeat(perm[hot], 40))
        seen.append((heat.shares(), heat.top_slots()))
        assert seen[-1][0]["imbalance"] < 8.0
    assert seen[0] == seen[1]


# -- TestRebalanceController --


def test_alert_fires_controller_rebalances_and_imbalance_recovers(runs):
    """On 8 server shards (1x8): the shipped shard_imbalance rule fires,
    the attached controller migrates the row's agreed plan (the JAX
    plan from the same heat), post-rebalance traffic re-measures below
    the threshold, and the table is bit-identical to an undisturbed run
    and to the JAX store's."""
    _, batches48, _, port, jx = runs
    recs = _active(port, "controller")
    assert len(recs) == 8
    heat = JKeyHeat(num_slots=64, num_shards=8, top_k=16, decay_every=1 << 30)
    for _ in range(4):
        heat.note(np.repeat(np.arange(8), 25))
    want = jpart.plan_rebalance(heat, 64, 8)
    for rec in recs:
        assert rec["num_slots"] == 64 and rec["imb0"] > 4.0
        assert rec["threshold"] == 4.0 and rec["should"]
        assert rec["hist0"] == [] and rec["hist_pending"] == []
        assert len(rec["hist"]) == 1
        h = rec["hist"][0]
        assert h["rows_moved"] == want.rows_moved > 0
        assert h["imbalance_before"] == pytest.approx(rec["imb0"])
        assert h["predicted_imbalance"] == pytest.approx(want.predicted_imbalance)
        assert h["predicted_imbalance"] < 4.0
        np.testing.assert_array_equal(rec["layout"], want.perm)
        assert rec["post"] is not None and rec["post"] < 4.0
        assert _bits(rec["table"]) == _bits(jx["controller_ref"])
        assert rec["hist_after"] == 1


def test_execute_is_noop_below_threshold(runs):
    for rec in _active(runs[3], "noop"):
        assert not rec["should"] and rec["executed"] is None and rec["layout"] is None


def _heats(make):
    out = []
    for cls in (JKeyHeat, TKeyHeat):
        out.append(make(cls))
    return out


@pytest.mark.parametrize("hot", [np.arange(8), np.arange(20, 36), np.array([0, 9, 18, 27, 63])],
                         ids=["one_shard", "two_shards", "spread"])
def test_plan_rebalance_is_deterministic_and_bijective(hot):
    def mk(cls):
        heat = cls(num_slots=64, num_shards=8, top_k=16, decay_every=1 << 30)
        heat.note(np.repeat(hot, 30))
        heat.note(np.arange(64))
        return heat

    jp, tp = (mod.plan_rebalance(h, 64, 8) for mod, h in zip((jpart, tpart), _heats(mk)))
    tp2 = tpart.plan_rebalance(mk(TKeyHeat), 64, 8)
    if jp is None:
        assert tp is None
        return
    np.testing.assert_array_equal(tp.perm, jp.perm)
    np.testing.assert_array_equal(tp.perm, tp2.perm)
    assert tp.moves == jp.moves
    assert tp.imbalance_before == jp.imbalance_before
    assert tp.predicted_imbalance == jp.predicted_imbalance
    np.testing.assert_array_equal(np.sort(tp.perm), np.arange(64))
    assert tp.rows_moved == 2 * len(tp.moves)  # swaps, not drops
    if len(hot) == 8:  # one shard's keys: the greedy plan spreads them
        assert tp.predicted_imbalance < tp.imbalance_before


def test_plan_rebalance_declines_single_shard_and_balance():
    heat = TKeyHeat(num_slots=64, num_shards=1, decay_every=1 << 30)
    heat.note(np.repeat(np.arange(8), 30))
    assert tpart.plan_rebalance(heat, 64, 1) is None
    cold = TKeyHeat(num_slots=64, num_shards=8, decay_every=1 << 30)
    assert tpart.plan_rebalance(cold, 64, 8) is None


def test_controller_with_a_fake_store_records_the_migration():
    """The controller's record and metrics off a mesh, on a stand-in
    store: it plans, migrates once with the plan's perm, rebases the heat
    and keeps the record; below threshold it does nothing."""
    calls = []

    class Store:
        num_slots = 64

        def migrate(self, perm, ch=0):
            calls.append((perm.copy(), ch))
            return {"barrier_ts": 3, "install_ts": 4, "replayed": 1, "journaled": 2,
                    "attempts": 1}

    heat = TKeyHeat(num_slots=64, num_shards=8, top_k=16, decay_every=1 << 30)
    heat.note(np.repeat(np.arange(8), 30))
    want = tpart.plan_rebalance(heat, 64, 8)
    ctl = tpart.RebalanceController(Store(), heat, threshold=4.0)
    rec = ctl.execute()
    assert len(calls) == 1 and np.array_equal(calls[0][0], want.perm)
    assert rec["rows_moved"] == want.rows_moved and rec["journaled_pushes"] == 2
    assert heat.shares()["imbalance"] is None  # a fresh window
    assert ctl.execute() is None and len(ctl.history()) == 1


# -- the replica hooks over server shards --


@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{d}x{s}" for d, s in LAYOUTS])
def test_consistent_replica_under_a_live_push_stream(runs, layout):
    """``get_replica_consistent`` while a thread pushes, over 2, 4 and 8
    server shards: every rank of a data row holds the same whole table,
    equal bit for bit to the JAX store after some prefix of the pushes
    (the row's agreed barrier; each data row is a replica of its own and
    agrees on its own), and ``set_replica`` of it into a fresh store
    gathers back the same bits."""
    d, s = layout
    prefixes = runs[4]["hashed_prefixes"]
    recs = [r["consistent"][f"{d}x{s}"] for r in runs[3]
            if r["consistent"][f"{d}x{s}"] is not None]
    assert len(recs) == d * s
    for rec in recs:
        row = [r for r in recs if r["coords"][0] == rec["coords"][0]]
        assert all(_bits(r["snap"]) == _bits(rec["snap"]) for r in row)
        assert any(_bits(rec["snap"]) == _bits(p) for p in prefixes[1:])
        assert _bits(rec["back"]) == _bits(rec["snap"])
        assert _bits(rec["final"]) == _bits(prefixes[-1])


# -- tests/test_reshard.py --


def test_kv_vector_reshards_2_to_4_servers(runs):
    """A replica taken at 4x2 installs at 2x4 (base layout), values intact,
    the table sharded 4 ways, and pushes land on the new shards; the
    snapshot equals the JAX store's."""
    JPostoffice.reset()
    try:
        keys = np.array([3, 17, 40, 99, 512, 1000], dtype=np.int64)
        vals = np.arange(12, dtype=np.float32).reshape(6, 2)
        ja = _jstore(4, 2, num_slots=1024, hashed=False, name="ja", keys=keys)
        ja.wait(ja.push(ja.request(channel=0), keys=keys, values=vals))
        jsnap = ja.get_replica()[0]
    finally:
        JPostoffice.reset()
    recs = _active(runs[3], "reshard")
    assert len(recs) == 8
    for rec in recs:
        assert _bits(rec["snap"]) == _bits(jsnap)
        np.testing.assert_array_equal(rec["first"], vals)
        assert rec["num_server"] == 4 and rec["shard_rows"] == 256
        np.testing.assert_array_equal(rec["second"], 2 * vals)
