"""PyTorch port: the KKT filter, adaptive τ, the encoded exact wire and
``checkpoint_async`` over a (data, server) mesh, against the JAX mesh
worker.

The port's side runs in one gloo world of 4 CPU ranks (each case's mesh
a prefix of it: 1x2, 2x1 or 2x2; rank functions in
``tests/torch_mesh_rest_ranks.py``). The JAX side runs
``AsyncSGDWorker(conf, mesh=...)`` in the test process on the suite's
virtual CPU devices. Both see the same minibatches (numpy, fixed seeds:
``tests/test_consistency.py``'s shape, 64 rows of 6 binary keys from
2^12, a 2^9-slot table, FTRL with λ1 0.1) and the same seeds.

Tolerances, each with its reason:

- the port's 1x2 KKT mesh against the port's one-card run: state
  **bit-equal**, counts equal (every slot has one owner, so each server
  psum, of w and of the KKT filter's z, adds exact zeros);
- every rank of a mesh holds the same counts, drop set (ministep by
  ministep) and τ trajectory, and every data rank the same bits of its
  server shard (each psum gives every rank of a group the same sum);
- the JAX mesh worker: state within ``TRAJ_TOL`` (``rtol 1e-5, atol
  1e-6``: XLA contracts the FTRL step into fused multiply-adds, eager
  PyTorch does not), the KKT counts, the drop set after every collect
  and the τ trajectories exact;
- the encoded exact wire against the raw wire on the same mesh: state
  and metrics **bit-equal** (the decode gives the raw arrays);
- pipelined against serial under the host drop set: **bit-equal**, and
  the same drop set (each launch group is prepped under the drop set the
  serial path's collects leave);
- ``checkpoint_async`` against ``checkpoint``: every member of the npz
  archive byte-equal (the zip headers carry the write's clock), and a
  restore from it resumes bit-equal to the unbroken run.
"""

import jax
import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.system.postoffice import Postoffice
from parameter_server_tpu_torch.utils import sparse as tsparse
from tests import torch_mesh_rest_ranks as ranks

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
MB, KEYS, LANES = ranks.MB, 1 << 12, 6
SHAPES = [(1, 2), (2, 1), (2, 2)]

#: the KKT filter with its default margin and escape (some slots
#: suppressed a ministep), and with the host drop set
KKT = dict(tau=2, update="sparse", kkt_filter=True)
DROP = dict(tau=1, update="sparse", kkt_filter=True, kkt_drop_after=2, kkt_revisit_every=3,
            ingest_workers=1)
TAU = dict(tau=4, tau_adaptive=True)


def _batches(mod, n, seed0=0, rows=MB):
    out = []
    for i in range(n):
        b = mod.random_sparse(rows, KEYS, LANES, seed=seed0 + i, binary=True)
        b.y = np.where(np.arange(rows) % 3 == 0, 1.0, -1.0).astype(np.float32)
        out.append(b)
    return out


def _bad(mod):
    b = _batches(mod, 1, seed0=90)[0]
    b.y = np.full_like(b.y, np.float32("inf"))
    return b


CASES = (
    [("kkt_serial", d, s, KKT, "b8") for d, s in SHAPES]
    + [("kkt_serial", d, s, DROP, "b8") for d, s in SHAPES]
    + [("kkt_train", 2, 2, DROP, "pipelined"), ("kkt_train", 2, 2, DROP, "serial")]
    + [("tau_widen", d, s, TAU, "widen") for d, s in SHAPES]
    + [("tau_spike", 2, 2, TAU, "none"), ("tau_react", 2, 2, dict(tau=3, tau_adaptive=True),
                                          "react"),
       ("tau_nonfinite", 2, 2, dict(tau=3, tau_adaptive=True), "nonfinite")]
    + [("encoded_vs_raw", d, s, None, "enc1") for d, s in SHAPES]
    + [("encoded_vs_raw", 2, 2, None, "enc4"), ("encoded_pipelined", 2, 2, None, "cached"),
       ("checkpoint_async", 2, 2, None, "ckpt"), ("disagree", 1, 2, None, "b8")]
)


def _args(tag, mod, tmp):
    b8 = _batches(mod, 8)
    return {
        "b8": (b8,), "pipelined": (b8, True), "serial": (b8, False),
        "widen": (_batches(mod, 12), 2), "none": (),
        "react": (_batches(mod, 4), _batches(mod, 3, 50), _batches(mod, 3, 100), 0),
        "nonfinite": (_batches(mod, 4), _bad(mod), _batches(mod, 4, 100)),
        "enc1": (b8, 1), "enc4": (b8, 4), "ckpt": (_batches(mod, 6), tmp),
        # rows enough that a data row's leaves reach the cache's 4 KiB floor
        "cached": (_batches(mod, 8, rows=2048), 4),
    }[tag]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_consistency"))
    cases = [(kind, d, s, kw, _args(tag, tsparse, tmp)) for kind, d, s, kw, tag in CASES]
    return launch.run_world(ranks.linear_cases, 4, args=(cases,), device_type="cpu",
                            timeout=300)


def _case(world, i):
    return [r[i] for r in world if r[i] is not None]


def _whole(recs):
    """The whole state from data row 0's shards."""
    shards = sorted((r["coords"][1], r["state"]) for r in recs if r["coords"][0] == 0)
    return convert.unshard_state([st for _, st in shards])


def _assert_ranks_agree(recs, keys=("tracker", "tau_trace", "objective")):
    """Every rank the same host decisions; every data rank the same bits
    of its server shard."""
    for r in recs:
        for k in keys:
            if k in r:
                assert r[k] == recs[0][k], k
        ref = next(o for o in recs if o["coords"] == (0, r["coords"][1]))
        for k in r["state"]:
            assert r["state"][k].tobytes() == ref["state"][k].tobytes(), k


def _jax_worker(d, s, kw, name):
    kw = dict(kw)
    tau = kw.pop("tau", 3)
    c = jcfg.Config()
    c.penalty = jcfg.PenaltyConfig(type="l1", lambda_=[0.1])
    c.learning_rate = jcfg.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = jcfg.SGDConfig(**dict(dict(algo="ftrl", minibatch=MB, num_slots=ranks.SLOTS,
                                             max_delay=tau), **kw))
    mesh = jmesh.make_mesh(num_data=d, num_server=s, devices=jax.devices()[: d * s])
    return jsgd.AsyncSGDWorker(c, mesh=mesh, name=name)


@pytest.fixture
def jax_side():
    JPostoffice.reset()
    made = []

    def make(*a):
        made.append(_jax_worker(*a))
        return made[-1]

    yield make
    for w in made:
        w.executor.stop()
    JPostoffice.reset()


def _jax_tracker(jw):
    tr = jw._consistency.tracker
    return {"dropped": sorted(tr._dropped), "summary": tr.summary()}


def _jax_state(jw):
    return {k: np.asarray(v) for k, v in jw.state_host()["state"].items()}


def _assert_close(js, ts):
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], **TRAJ_TOL, err_msg=k)


def _find(kind, d, s, kw=None, tag=None):
    for i, (k, dd, ss, kk, tt) in enumerate(CASES):
        if k == kind and (dd, ss) == (d, s) and (kw is None or kk is kw) and (tag in (None, tt)):
            return i
    raise KeyError((kind, d, s))


# -- the KKT filter --


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_kkt_mesh_matches_the_jax_mesh_worker(world, jax_side, shape):
    """The escape-1/64 filter, each batch collected before the next: the
    counts after every collect and the state against the JAX mesh worker
    on the same mesh shape."""
    recs = _case(world, _find("kkt_serial", *shape, KKT))
    _assert_ranks_agree(recs)
    jw = jax_side(*shape, KKT, f"kkt_{shape}")
    want = []
    for b in _batches(jsparse, 8):
        jw.collect(jw.process_minibatch(b))
        want.append(_jax_tracker(jw)["summary"])
    got = [p["summary"] for p in recs[0]["per_collect"]]
    assert got == want
    assert 0 < want[-1]["suppressed"] < want[-1]["candidates"]
    _assert_close(_jax_state(jw), _whole(recs))


def test_kkt_one_by_two_bit_equal_to_one_card(world):
    recs = _case(world, _find("kkt_serial", 1, 2, KKT))
    Postoffice.reset()
    w = tsgd.AsyncSGDWorker(ranks.conf(**KKT), device="cpu")
    try:
        one = ranks.kkt_serial(w, _batches(tsparse, 8))
        state = ranks._state(w)
    finally:
        w.remove()
        Postoffice.reset()
    whole = _whole(recs)
    for k in state:
        assert state[k].tobytes() == whole[k].tobytes(), k
    assert [p["summary"] for p in one["per_collect"]] == \
        [p["summary"] for p in recs[0]["per_collect"]]


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_drop_set_ministep_by_ministep_matches_the_jax_mesh_worker(world, jax_side, shape):
    """``kkt_drop_after`` 2: the drop set after every collect equal on
    every rank (its version and digest too) and to the JAX mesh
    worker's; the state within the trajectory tolerance."""
    recs = _case(world, _find("kkt_serial", *shape, DROP))
    _assert_ranks_agree(recs)
    for r in recs:
        assert [p["stamp"] for p in r["per_collect"]] == \
            [p["stamp"] for p in recs[0]["per_collect"]]
    jw = jax_side(*shape, DROP, f"drop_{shape}")
    want = []
    for b in _batches(jsparse, 8):
        jw.collect(jw.process_minibatch(b))
        want.append(_jax_tracker(jw))
    assert [p["dropped"] for p in recs[0]["per_collect"]] == [w["dropped"] for w in want]
    assert [p["summary"] for p in recs[0]["per_collect"]] == [w["summary"] for w in want]
    assert max(len(w["dropped"]) for w in want) > 0
    assert want[-1]["summary"]["revisit_batches"] > 0
    _assert_close(_jax_state(jw), _whole(recs))


def test_pipelined_drop_set_bit_equal_to_serial(world):
    """``train`` pipelined and serial under the host drop set at 2x2:
    the same drop set and the same state bits on every rank."""
    piped = _case(world, _find("kkt_train", 2, 2, tag="pipelined"))
    serial = _case(world, _find("kkt_train", 2, 2, tag="serial"))
    _assert_ranks_agree(piped)
    for a, b in zip(piped, serial):
        assert a["coords"] == b["coords"]
        assert a["tracker"] == b["tracker"]
        for k in a["state"]:
            assert a["state"][k].tobytes() == b["state"][k].tobytes(), k
    assert piped[0]["tracker"]["summary"]["dropped_slots"] > 0


def test_a_drop_set_one_rank_alone_holds_fails_every_rank_loudly(world):
    """A 1x2 mesh whose server rank 1 holds one more dropped slot: the
    next launch's agreement raises on both ranks, naming the drop set,
    and no rank waits in a collective (the world returns)."""
    recs = _case(world, _find("disagree", 1, 2))
    assert len(recs) == 2
    for r in recs:
        assert "disagree on the drop set's version, the drop set's digest" in r["result"], \
            r["result"]


# -- adaptive τ --


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_tau_widens_within_the_cap_as_the_jax_mesh_worker(world, jax_side, shape):
    recs = _case(world, _find("tau_widen", *shape))
    _assert_ranks_agree(recs)
    jw = jax_side(*shape, TAU, f"widen_{shape}")
    jw._consistency.controller.stable_steps = 2
    jw.train(iter(_batches(jsparse, 12)))
    jw.executor.wait_all(pop=False)
    trace = recs[0]["tau_trace"]
    assert trace == jw._consistency.controller.tau_trace
    assert trace[0] == 1 and 1 < max(trace) <= 4
    st = recs[0]["staleness"]
    assert st["within_bound"] and st["live_tau"] == trace[-1]
    _assert_close(_jax_state(jw), _whole(recs))


def test_soft_spike_halves_tau_on_every_rank(world, jax_side):
    recs = _case(world, _find("tau_spike", 2, 2))
    jw = jax_side(2, 2, TAU, "spike")
    ctl = jw._consistency.controller
    ctl._set_tau(4, "widen")
    for _ in range(10):
        ctl.on_metrics(0.5, 1.0, False)
    ctl.on_metrics(0.5, 50.0, False)
    for r in recs:
        assert r["tau"] == ctl.tau == 2
        assert r["alpha_kept"] and r["episodes"] == ctl.episodes == []


def test_a_reaction_one_rank_asks_for_runs_on_every_rank_at_one_launch(world, jax_side):
    """Only rank 0 asks (``react`` on a mesh is a request and returns
    None); at the collect of the next launch every rank backs the rate
    off by the JAX controller's factor, sets τ to 0 and rolls its shard
    back bit-exactly to the snapshot, as the JAX ``react`` does at once."""
    recs = _case(world, _find("tau_react", 2, 2))
    jw = jax_side(2, 2, dict(tau=3, tau_adaptive=True), "react")
    jw.train(iter(_batches(jsparse, 4)))
    jw.train(iter(_batches(jsparse, 3, 50)))
    jep = jw._consistency.react("test")
    for r in recs:
        assert r["episodes_before"] == []
        assert r["asked"] == (None if r["coords"] == (0, 0) else "not asked")
        (ep,) = r["episodes"]
        assert ep["reason"] == ("test" if r["coords"] == (0, 0) else "peer")
        assert ep["rolled_back"] is jep["rolled_back"] is True
        assert ep["tau_after"] == jep["tau_after"] == r["tau"] == 0
        assert ep["healthy_collects"] == recs[0]["episodes"][0]["healthy_collects"]
        assert r["alpha_ratio"] == 0.5
        assert r["moved_differs"] and r["restored_is_snapshot"]
    _assert_ranks_agree(recs)


def test_nonfinite_collect_reacts_on_every_rank_as_the_jax_mesh_worker(world, jax_side):
    recs = _case(world, _find("tau_nonfinite", 2, 2))
    _assert_ranks_agree(recs)
    jw = jax_side(2, 2, dict(tau=3, tau_adaptive=True), "nonfinite")
    jw.train(iter(_batches(jsparse, 4)))
    jw.train(iter([_bad(jsparse)]))
    ctl = jw._consistency.controller
    assert [e["reason"] for e in recs[0]["episodes"]] == [e["reason"] for e in ctl.episodes] \
        == ["nonfinite"]
    assert recs[0]["episodes"][0]["rolled_back"]
    jw.train(iter(_batches(jsparse, 4, 100)))
    jw.executor.wait_all(pop=False)
    assert recs[0]["tau_trace"] == ctl.tau_trace
    assert recs[0]["objective_finite"]
    _assert_close(_jax_state(jw), _whole(recs))


# -- the encoded exact wire --


@pytest.mark.parametrize("case", [(1, 2, "enc1"), (2, 1, "enc1"), (2, 2, "enc1"),
                                  (2, 2, "enc4")], ids=["1x2", "2x1", "2x2", "2x2-T4"])
def test_encoded_wire_bit_equal_to_the_raw_wire(world, case):
    recs = _case(world, _find("encoded_vs_raw", case[0], case[1], tag=case[2]))
    assert len(recs) == case[0] * case[1]
    for r in recs:
        raw, enc = r["result"]["raw"], r["result"]["encoded"]
        assert enc["kinds"] == ["EncodedExactBatch"] and raw["kinds"] == ["PreppedBatch"]
        for k in raw["state"]:
            assert raw["state"][k].tobytes() == enc["state"][k].tobytes(), k
        for a, b in zip(raw["metrics"], enc["metrics"]):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].tobytes() == b[k].tobytes(), k


def test_encoded_pipelined_caches_the_second_pass_on_every_rank(world):
    """Two pipelined passes (T 4, 2048-row minibatches) in one ``train``
    on the encoded wire with the upload cache: bit-equal to the raw
    wire's two passes, and on every rank the second pass hits where the
    first missed (a one-pass run's hits and misses are the first pass's;
    leaves under the cache's 4 KiB floor always upload)."""
    recs = _case(world, _find("encoded_pipelined", 2, 2))
    for r in recs:
        raw, one, enc = (r["result"][k] for k in ("raw", "encoded1", "encoded"))
        for k in raw["state"]:
            assert raw["state"][k].tobytes() == enc["state"][k].tobytes(), k
        (h1, m1), (h2, m2) = one["hits"], enc["hits"]
        # pass 1 hits only the leaves its batches repeat (the label bits)
        assert h2 - h1 > h1 and m2 - m1 < m1


# -- checkpoint_async --


def test_checkpoint_async_on_a_mesh_writes_checkpoints_file_and_resumes(world):
    recs = _case(world, _find("checkpoint_async", 2, 2))
    zero = next(r for r in recs if r["coords"] == (0, 0))["result"]
    assert zero["async_members"] == zero["sync_members"]
    assert "__treedef__.npy" in zero["async_members"]
    for r in recs:
        res = r["result"]
        assert res["step"] == 3
        for k in res["unbroken"]:
            assert res["unbroken"][k].tobytes() == res["resumed"][k].tobytes(), k
