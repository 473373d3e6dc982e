"""PyTorch port: the linear worker's ELL wires (i32, u24, bits, stream)
over a (data, server) mesh against the JAX mesh worker, the checkpoint
restored across server counts, the features a mesh refused until A9
slice 2's third part building there, and the CLI
on ``configs/criteo/online_l1lr_bigtable.conf`` with ``--num-servers``.

The port's side runs in one gloo world of 8 CPU ranks (rank functions
in ``tests/torch_mesh_apps_ranks.py``; each case's mesh a prefix of the
world, the other ranks idle). The JAX side runs ``AsyncSGDWorker(conf,
mesh=...)`` in the test process on the suite's 8 virtual CPU devices.
Both see the same minibatches (numpy, fixed seeds) and the same seeds.

Tolerances, each with its reason (those of
``tests/test_torch_parallel_linear.py``, whose hashed wire runs the same
per-entry ministep):

- every wire at 1x2, 2x1 and 2x2, and the bits and stream wires'
  4-ministep scan on each: state, weights and pulls ``rtol=1e-5,
  atol=1e-6``, objective relative 1e-5, counts exact (XLA contracts
  ``z + g - sigma * w`` into a fused multiply-add under jit, eager
  PyTorch does not; two data ranks sum ``a + b``, the same bits in
  either order);
- the 1x2 mesh against the port's one-card run on the bits wire:
  state **bit-equal** (every slot has one owner, so the server psum is
  ``x + 0``, and the data axis has one rank);
- the FIXING_FLOAT 1-byte push filter at 2x2 on the bits wire:
  statistical, each launch's per-example objective within ``max(0.01,
  0.02 * ll)`` of the JAX run's and the counts exactly (the noise
  streams differ: ``jax.random`` against the kernel's counter hash);
- the checkpoint taken at 4x2 and restored at 2x4, then replayed:
  weights within ``atol=1e-6`` of the 4x2 run's own replay (the JAX
  test's tolerance); the same checkpoint restored by the JAX worker at
  2x4 and replayed: within the trajectory tolerance of the port's.
"""

import numpy as np
import pytest
import torch

import jax

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.parameter.replica import CheckpointManager as JCheckpointManager
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.parallel import mesh as tmesh
from parameter_server_tpu_torch.system.postoffice import Postoffice
from parameter_server_tpu_torch.utils import sparse as tsparse
from tests import torch_mesh_apps_ranks as mranks
from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel_linear import TRAJ_TOL, assert_metrics_close, assert_state_close

torch.set_num_threads(1)

N_BATCHES, KEYS = 8, 1 << 14

#: (num_data, num_server, wire, lanes, ministeps a launch, push filter bytes)
CASES = [(d, s, wire, lanes, 1, 0) for d, s in ((1, 2), (2, 1), (2, 2))
         for wire, lanes in (("i32", 12), ("u24", 12), ("bits", 8), ("stream", 8))]
CASES += [(d, s, wire, 8, 4, 0) for d, s in ((1, 2), (2, 1), (2, 2)) for wire in ("bits", "stream")]
CASES += [(2, 2, "bits", 8, 1, 1)]
#: the prepped batch each wire's data takes, on both packages
KINDS = {"i32": "ELLBatch", "u24": "ELLPackedBatch", "bits": "ELLBitsBatch",
         "stream": "EncodedEllStreamBatch"}


def _criteo_like(mod, n_batches, rows=ranks.MB, lanes=8, vocab_small=40, seed=0):
    """Uniform binary rows with ±1 labels: half the lanes from small
    vocabularies (the stream wire's dictionary lanes), half wide."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        small = rng.integers(0, vocab_small, (rows, lanes // 2))
        wide = rng.integers(0, 1 << 40, (rows, lanes - lanes // 2))
        keys = np.concatenate([small + (np.arange(lanes // 2) << 50), wide], axis=1)
        # labels that the keys predict, so that the weights move
        y = np.where(small.sum(1) % 3 == 0, 1.0, -1.0).astype(np.float32)
        out.append(mod.SparseBatch(y=y, indptr=np.arange(0, rows * lanes + 1, lanes),
                                   indices=keys.astype(np.int64).ravel()))
    return out


def _ragged(mod, n_batches, binary, seed=0, rows=ranks.MB, lanes=6):
    """Rows of 0 to 11 features (sentinel lanes occur), valued or binary."""
    out = []
    for i in range(n_batches):
        rng = np.random.default_rng(seed + i)
        counts = rng.integers(0, 2 * lanes, rows)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        keys = rng.integers(0, KEYS, int(indptr[-1])).astype(np.int64)
        score = np.bincount(np.repeat(np.arange(rows), counts), weights=keys % 7, minlength=rows)
        y = np.where(score % 2 == 0, 1.0, -1.0)
        vals = None if binary else (rng.random(keys.size) + 0.5).astype(np.float32)
        out.append(mod.SparseBatch(y=y.astype(np.float32), indptr=indptr, indices=keys,
                                   values=vals))
    return out


def _batch_sets(mod):
    return {"i32": _ragged(mod, N_BATCHES, binary=False, seed=10),
            "u24": _ragged(mod, N_BATCHES, binary=True, seed=20),
            "bits": _criteo_like(mod, N_BATCHES, seed=1),
            "stream": _criteo_like(mod, N_BATCHES, seed=2)}


def _jax_conf(wire, lanes, steps, push):
    c = jcfg.Config()
    c.penalty = jcfg.PenaltyConfig(type="l1", lambda_=[1.0])
    c.learning_rate = jcfg.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = jcfg.SGDConfig(algo="ftrl", minibatch=ranks.MB, num_slots=ranks.SLOTS,
                                 max_delay=0, update="dense", steps_per_launch=steps,
                                 ell_lanes=lanes, wire=wire)
    if push:
        c.async_sgd.push_filter = [{"type": "fixing_float", "num_bytes": push}]
    return c


def _jax_run(case, batches, probe):
    d, s, wire, lanes, steps, push = case
    JPostoffice.reset()
    mesh = jmesh.make_mesh(num_data=d, num_server=s, devices=jax.devices()[: d * s])
    jw = jsgd.AsyncSGDWorker(_jax_conf(wire, lanes, steps, push), mesh=mesh)
    kind = type(jw.prep(batches[0], device_put=False)).__name__
    metrics = []
    for lo in range(0, len(batches), steps):
        group = batches[lo:lo + steps]
        if steps > 1:
            m = jw.executor.wait(jw.submit_superbatch(group, with_aux=True))
        else:
            m = jw.executor.wait(jw.process_minibatch(group[0]))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    weights = jw.weights_dense()
    out = {"kind": kind, "state": jw.state_host()["state"], "metrics": metrics,
           "weights": weights, "pulled": weights[jw.directory.slots(probe)]}
    JPostoffice.reset()
    return out


# -- the resharded checkpoint (tests/test_reshard.py's drill) --

W_TRUE = np.random.default_rng(0).normal(size=512) * (np.random.default_rng(1).random(512) < 0.2)


def _reshard_conf(mod):
    c = mod.Config()
    c.penalty = mod.PenaltyConfig(type="l1", lambda_=[0.01])
    c.learning_rate = mod.LearningRateConfig(type="decay", alpha=0.5, beta=1.0)
    c.async_sgd = mod.SGDConfig(algo="ftrl", minibatch=256, num_slots=4096, ell_lanes=8)
    return c


def _reshard_batches(mod, n, seed0=0):
    return [mod.random_sparse(256, 512, 8, seed=seed0 + i, w_true=W_TRUE.astype(np.float32),
                              binary=True) for i in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    probe = np.random.default_rng(5).integers(0, 1 << 41, 300)
    jsets, tsets = _batch_sets(jsparse), _batch_sets(tsparse)
    jax_runs = [_jax_run(c, jsets[c[2]], probe) for c in CASES]
    port = launch.run_world(mranks.ell_cases, 4, args=(CASES, tsets, probe),
                            device_type="cpu", timeout=300)
    ckpt = tmp_path_factory.mktemp("reshard")
    reshard = launch.run_world(
        mranks.reshard_checkpoint, 8,
        args=(str(ckpt), _reshard_conf(tcfg), _reshard_batches(tsparse, 5),
              _reshard_batches(tsparse, 3, seed0=50)),
        device_type="cpu", timeout=300)
    return tsets, probe, port, jax_runs, reshard, ckpt


def _case_ranks(port, i):
    return [r[i] for r in port if r[i] is not None]


def _whole_state(port, i):
    from parameter_server_tpu_torch import convert

    shards = sorted((r["coords"][1], r["state"]) for r in _case_ranks(port, i)
                    if r["coords"][0] == 0)
    return convert.unshard_state([st for _, st in shards])


def _case_id(c):
    d, s, wire, _, steps, push = c
    return f"{d}x{s}-{wire}" + (f"-T{steps}" if steps > 1 else "") + ("-push1" if push else "")


@pytest.mark.parametrize("i", range(len(CASES)), ids=[_case_id(c) for c in CASES])
def test_ell_wire_on_a_mesh_matches_the_jax_mesh_worker(runs, i):
    _, _, port, jax_runs, _, _ = runs
    d, s, wire, _, steps, push = CASES[i]
    want = jax_runs[i]
    mine = _case_ranks(port, i)
    assert sorted(r["coords"] for r in mine) == [(a, b) for a in range(d) for b in range(s)]
    assert {r["kind"] for r in mine} == {want["kind"]} == {KINDS[wire]}
    # every data rank holds the same bits of its server shard, and every
    # rank the same metrics, weights and pulls
    for r in mine:
        ref = next(o for o in mine if o["coords"] == (0, r["coords"][1]))
        for k in r["state"]:
            assert np.array_equal(r["state"][k].view(np.uint32), ref["state"][k].view(np.uint32))
        assert np.array_equal(r["weights"], mine[0]["weights"])
        assert np.array_equal(r["pulled"], mine[0]["pulled"])
        for a, b in zip(r["metrics"], mine[0]["metrics"]):
            assert all(np.array_equal(a[k], b[k]) for k in a)
    port_metrics = mine[0]["metrics"]
    assert len(port_metrics) == len(want["metrics"]) == N_BATCHES // steps
    if push:
        for jm, tm in zip(want["metrics"], port_metrics):
            np.testing.assert_array_equal(tm["num_ex"], jm["num_ex"])
            jl, tl = jm["objective"] / jm["num_ex"], tm["objective"] / tm["num_ex"]
            assert abs(tl - jl) <= max(0.01, 0.02 * jl), (jl, tl)
        assert np.count_nonzero(_whole_state(port, i)["z"]) > 0
        return
    for jm, tm in zip(want["metrics"], port_metrics):
        assert_metrics_close(jm, tm)
    assert_state_close(want["state"], _whole_state(port, i))
    assert np.count_nonzero(want["weights"]) > 0
    np.testing.assert_allclose(mine[0]["weights"], want["weights"], **TRAJ_TOL)
    np.testing.assert_allclose(mine[0]["pulled"], want["pulled"], **TRAJ_TOL)


@pytest.mark.parametrize("steps", [1, 4])
def test_one_by_two_bits_mesh_bit_equal_to_the_one_card_run(runs, steps):
    tsets, probe, port, _, _, _ = runs
    i = CASES.index((1, 2, "bits", 8, steps, 0))
    Postoffice.reset()
    tw = tsgd.AsyncSGDWorker(mranks.ell_conf("bits", 8, steps), device="cpu")
    try:
        ranks.train_linear(tw, tsets["bits"], steps)
        one = tw.state_host()["state"]
    finally:
        tw.remove()
        Postoffice.reset()
    whole = _whole_state(port, i)
    for k in one:
        assert np.array_equal(one[k].view(np.uint32), whole[k].view(np.uint32)), k


def test_checkpoint_restores_across_server_counts(runs):
    """4x2 -> checkpoint -> 2x4 restore and replay (the JAX drill of
    ``tests/test_reshard.py``): the replay within ``atol=1e-6``; and the
    JAX worker at 2x4 restores the port's checkpoint and replays within
    the trajectory tolerance of the port's replay."""
    _, _, _, _, reshard, ckpt = runs
    assert {r["restored_step"] for r in reshard} == {5}
    a, b = reshard[0]["a"], reshard[0]["b"]
    assert all(np.array_equal(r["a"], a) and np.array_equal(r["b"], b) for r in reshard)
    assert np.count_nonzero(a) > 0
    np.testing.assert_allclose(b, a, atol=1e-6)
    JPostoffice.reset()
    try:
        jw = jsgd.AsyncSGDWorker(_reshard_conf(jcfg), mesh=jmesh.make_mesh(num_data=2,
                                                                          num_server=4))
        assert jw.restore(JCheckpointManager(str(ckpt), use_orbax=False)) == 5
        jw.train(iter(_reshard_batches(jsparse, 3, seed0=50)))
        np.testing.assert_allclose(jw.weights_dense(), b, **TRAJ_TOL)
    finally:
        JPostoffice.reset()


# -- what a mesh refused until ROADMAP A9 slice 2, and every ELL wire building a mesh step --


@pytest.mark.parametrize("field,value", [
    ("kkt_filter", True), ("wire_encode", "exact"), ("tau_adaptive", True),
])
def test_features_left_unported_on_a_mesh_raise_naming_a9(field, value):
    """Ported in A9 slice 2's third part: each conf that raised naming it
    here builds on rank 0's view of a 2x2 mesh (nothing collective runs),
    preps this data row's part of a batch of the ELL tests and builds its
    mesh step: the KKT filter rides the raw exact wire's step, the
    encoded wire's own, adaptive τ starts at 1. Their worlds are in
    ``tests/test_torch_parallel_consistency.py``."""
    conf = ranks.linear_conf("sparse", "float32", 1)
    setattr(conf.async_sgd, field, value)
    if field == "tau_adaptive":
        conf.async_sgd.max_delay = 2
    mesh = tmesh.Mesh(2, 2, "cpu")  # rank 0's view; nothing collective runs
    Postoffice.reset()
    try:
        w = tsgd.AsyncSGDWorker(conf, mesh=mesh)
        batch = _batch_sets(tsparse)["i32"][0]
        prepped = w.prep(batch, device_put=False)
        want = "EncodedExactBatch" if field == "wire_encode" else "PreppedBatch"
        assert type(prepped).__name__ == want
        assert callable(w._get_step(prepped, True))
        key = "exact_enc" if field == "wire_encode" else "exact"
        assert (key, True) in w._steps
        if field == "tau_adaptive":
            assert w._consistency.controller.tau == 1
        w.remove()
    finally:
        Postoffice.reset()


@pytest.mark.parametrize("wire,lanes", [("i32", 12), ("u24", 12), ("bits", 8), ("stream", 8)])
def test_every_ell_wire_builds_a_mesh_step(wire, lanes):
    """On rank 0's view of a 2x2 mesh (no collective runs: the step is
    built, not called) each ELL wire preps this data row's shard of the
    batch and builds its step and its scan for the mesh."""
    conf = mranks.ell_conf(wire, lanes, 1)
    mesh = tmesh.Mesh(2, 2, "cpu")
    Postoffice.reset()
    try:
        w = tsgd.AsyncSGDWorker(conf, mesh=mesh)
        batch = _batch_sets(tsparse)[wire][0]
        prepped = w.prep(batch, device_put=False)
        assert type(prepped).__name__ == KINDS[wire]
        assert prepped.num_examples == batch.n // 2  # data row 0's half
        assert w.shard_rows == ranks.SLOTS // 2
        assert callable(w._get_step(w.upload(prepped), True))
        if wire in ("bits", "stream"):
            stacked = tsgd._stack([prepped, w.prep(_batch_sets(tsparse)[wire][1],
                                                   device_put=False)], "dense")
            assert stacked is not None and stacked.steps == 2
            assert callable(w._get_step(w.upload(stacked), True))
        w.remove()
    finally:
        Postoffice.reset()


# -- the CLI on the 2^30 bigtable conf, cut to size --


def _progress_line(out):
    return [ln for ln in out.splitlines() if ln.strip()[:1].isdigit()][-1].split()


def test_bigtable_conf_cli_on_a_mesh_matches_one_card(tmp_path):
    """``configs/criteo/online_l1lr_bigtable.conf`` through the linear CLI
    under ``--num-servers 2`` and ``--num-workers 2 --num-servers 2`` on
    the CPU over gloo, on generated Criteo text (``benchmarks/criteo.py``),
    cut to 2^18 slots, 512-row minibatches and a 2^18 count-min; the
    rest is the conf's (bf16 √n, the tail filter, τ 4, ``ell_lanes`` 39
    and the bits wire, T 8). Below the sparse flip every shape takes the
    dense update over an ELL wire (the tail-filtered rows are ragged, so
    the bits wire falls back to u24 here; at 2^30 to i32), each rank its
    shard, and writes its model file. The progress line against the
    one-card CLI's: the examples equal, loss, AUC and accuracy within
    1e-3 relative (the bf16 dither hashes the shard-local position, as
    the JAX mesh's does, so shard 1's √n parts from the one card's at
    its second step)."""
    from parameter_server_tpu_torch.benchmarks import mesh as bmesh
    from parameter_server_tpu_torch.benchmarks.criteo import write_criteo_shards
    from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf

    from tests.test_torch_parallel_linear import ROOT

    write_criteo_shards(str(tmp_path / "train"), 1, 8192, seed=0)
    text = ctr_conf(str(tmp_path / "train" / "part-*"), str(tmp_path / "model" / "big"),
                    conf_text=(ROOT / "configs" / "criteo" / "online_l1lr_bigtable.conf")
                    .read_text(), num_slots=1 << 18, countmin_n=1 << 18, minibatch=512)
    conf = tmp_path / "big.conf"
    conf.write_text(text)
    one = launch.run_world(bmesh.cli_rank, 1, args=([str(conf), "--device", "cpu"], False, True),
                           device_type="cpu", timeout=300)[0]
    want = _progress_line(one["out"])
    assert one["rc"] == 0 and want[1] == "8.19e+03"
    for extra, world in ((["--num-servers", "2"], 2),
                         (["--num-workers", "2", "--num-servers", "2"], 4)):
        recs = launch.run_world(bmesh.cli_rank, world,
                                args=([str(conf), "--device", "cpu", *extra], False, True),
                                device_type="cpu", timeout=300)
        assert [r["rc"] for r in recs] == [0] * world
        for r in recs:
            assert r["update"] == "dense" and r["kinds"] == ["ELLPackedBatch"]
            assert r["submissions"] == one["submissions"] == 16
            assert r["state"]["sqrt_n"].dtype.name == "bfloat16"
            assert r["state"]["z"].shape == (1 << 17,)  # a server shard
        got = _progress_line(recs[0]["out"])
        assert got[1] == want[1]
        np.testing.assert_allclose([float(x) for x in got[2:]], [float(x) for x in want[2:]],
                                   rtol=1e-3)
        for s in (0, 1):
            lines = (tmp_path / "model" / f"big_S{s}").read_text().splitlines()
            assert lines[0] == f"#hashed\t{1 << 18}" and len(lines) > 100
