"""PyTorch port: the linear worker over a (data, server) mesh against the
JAX mesh worker, and the CLI's ``--num-servers`` / ``--num-workers``.

The port's side runs in one gloo world of 8 CPU ranks (one rank a mesh
position; each case's mesh a prefix of the world, the other ranks idle;
rank functions in ``tests/torch_parallel_ranks.py``). The JAX side runs
``AsyncSGDWorker(conf, mesh=...)`` in the test process on the suite's 8
virtual CPU devices. Both see the same minibatches (numpy, fixed seeds:
``tests/test_torch_linear_step.py``'s data and conf) and the same seeds.

Tolerances, each with its reason:

- the port's ``1 x 2`` mesh against the port's one-card run, f32 √n,
  sparse and dense: state and weights **bit-equal** (every slot has one
  owner, so the server psum is ``x + 0``; the data axis has one rank);
  pulled weights equal in value (the psum's ``-0.0 + 0.0`` is +0.0);
- every data rank of a mesh holds the same bits of its server shard
  (the gradient psum gives every rank of a group the same sum);
- the JAX mesh worker, f32 √n, meshes 1x2, 2x1, 2x2 and 4x2, sparse and
  dense (and the 4-ministep scan at 2x2): state, weights and pulls
  ``rtol=1e-5, atol=1e-6``, objective relative 1e-5, counts exact: the
  one-card tolerance (XLA contracts ``z + g - sigma * w`` into a fused
  multiply-add under jit, eager PyTorch does not). Two data ranks sum
  ``a + b``, the same bits in either order; four may round differently
  from XLA's psum, which the same tolerance covers;
- bf16 √n (2x2 sparse, 1x2 and 2x2 dense): equal except for at most
  0.1% of entries, by one bf16 ulp (a last-bit f32 difference can flip
  the dithered truncation). The dense dither hashes the shard-local
  position, as the JAX ``shard_map`` body does, so these are held to
  the JAX mesh, not to the one-card run;
- the FIXING_FLOAT 1-byte push filter at 2x2 (each data rank quantizes
  its own contribution, seed ``seed * 1000003 + d``): statistical, as
  the one-card wire's test (``tests/test_torch_filtered_wire.py``): the
  noise streams differ (``jax.random`` against the kernel's counter
  hash), so the per-example objective of each launch is held within
  ``max(0.01, 0.02 * ll)`` of the JAX run's and the counts exactly;
- a JAX 2x2 state resumed on the port's 2x2 mesh (``convert.shard_state``):
  the trajectory tolerance;
- the CLI at ``--num-servers 2 --num-workers 2``: the model files have
  the JAX CLI's slots, and weights within ``rtol=1e-5, atol=1e-6``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.apps.linear import main as jmain
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear import main as tmain
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.parallel import mesh as tmesh
from parameter_server_tpu_torch.parameter.kv_vector import KVVector
from parameter_server_tpu_torch.system.postoffice import Postoffice
from parameter_server_tpu_torch.utils import sparse as tsparse
from tests import torch_parallel_ranks as ranks

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)  # FMA contraction, fed back
OBJ_RTOL = 1e-5
MB, KEYS, NNZ, N_BATCHES = ranks.MB, 1 << 14, 39, 8

#: (num_data, num_server, update, √n dtype, ministeps a launch, push filter bytes)
CASES = [
    (1, 2, "sparse", "float32", 1, 0),
    (2, 1, "sparse", "float32", 1, 0),
    (2, 2, "sparse", "float32", 1, 0),
    (4, 2, "sparse", "float32", 1, 0),
    (2, 2, "sparse", "float32", 4, 0),
    (1, 2, "dense", "float32", 1, 0),
    (2, 1, "dense", "float32", 1, 0),
    (2, 2, "dense", "float32", 1, 0),
    (4, 2, "dense", "float32", 1, 0),
    (2, 2, "sparse", "bfloat16", 1, 0),
    (1, 2, "dense", "bfloat16", 1, 0),
    (2, 2, "dense", "bfloat16", 1, 0),
    (2, 2, "dense", "float32", 1, 1),
]


def make_batch(seed, n=MB):
    """``tests/test_torch_linear_step.py``'s batch: binary keys, labels
    from the share of low-id features in the row."""
    b = jsparse.random_sparse(n, KEYS, NNZ, seed=seed, binary=True)
    b.y = np.where((b.indices.reshape(n, -1) % 1024 < 256).mean(1) > 0.24, 1.0, -1.0
                   ).astype(np.float32)
    return b


def _port_batch(b):
    return tsparse.SparseBatch(y=b.y.copy(), indptr=b.indptr.copy(), indices=b.indices.copy(),
                               values=None if b.values is None else b.values.copy())


def _jax_conf(update, dtype, steps, push):
    c = jcfg.Config()
    c.penalty = jcfg.PenaltyConfig(type="l1", lambda_=[1.0])
    c.learning_rate = jcfg.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = jcfg.SGDConfig(algo="ftrl", minibatch=MB, num_slots=ranks.SLOTS, max_delay=0,
                                 update=update, ftrl_state_dtype=dtype, steps_per_launch=steps)
    if push:
        c.async_sgd.push_filter = [{"type": "fixing_float", "num_bytes": push}]
    return c


def _jax_run(case, batches, probe):
    d, s, update, dtype, steps, push = case
    JPostoffice.reset()
    mesh = jmesh.make_mesh(num_data=d, num_server=s, devices=jax.devices()[: d * s])
    jw = jsgd.AsyncSGDWorker(_jax_conf(update, dtype, steps, push), mesh=mesh)
    metrics = []
    for lo in range(0, len(batches), steps):
        group = batches[lo:lo + steps]
        if steps > 1:
            m = jw.executor.wait(jw.submit_superbatch(group, with_aux=True))
        else:
            m = jw.executor.wait(jw.process_minibatch(group[0]))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    weights = jw.weights_dense()
    out = {"state": jw.state_host()["state"], "metrics": metrics, "weights": weights,
           "pulled": weights[jw.directory.slots(probe)]}  # the JAX worker has no pull
    JPostoffice.reset()
    return out


RESUME = (2, 2, "sparse", "float32", 1, 0)


def _jax_resume(batches):
    """The JAX 2 x 2 mesh worker: 4 minibatches, its whole state and seed
    counter taken, then 4 more; returns (taken, counter, final state)."""
    JPostoffice.reset()
    mesh = jmesh.make_mesh(num_data=2, num_server=2, devices=jax.devices()[:4])
    jw = jsgd.AsyncSGDWorker(_jax_conf("sparse", "float32", 1, 0), mesh=mesh)
    for b in batches[:4]:
        jw.executor.wait(jw.process_minibatch(b))
    taken = jw.state_host()
    for b in batches[4:]:
        jw.executor.wait(jw.process_minibatch(b))
    final = jw.state_host()["state"]
    JPostoffice.reset()
    return taken["state"], int(taken["seed_counter"]), final


@pytest.fixture(scope="module")
def runs():
    batches = [make_batch(i) for i in range(N_BATCHES)]
    probe = np.random.default_rng(5).integers(0, KEYS, 300)
    jax_runs = [_jax_run(c, batches, probe) for c in CASES]
    taken, counter, final = _jax_resume(batches)
    port_batches = [_port_batch(b) for b in batches]
    port = launch.run_world(ranks.linear_cases, 8,
                            args=(CASES, port_batches, probe,
                                  (RESUME, taken, counter, port_batches[4:])),
                            device_type="cpu", timeout=300)
    return batches, probe, port, jax_runs, final


def _case_ranks(port, i):
    return [r[i] for r in port if r[i] is not None]


def _whole_state(port, i):
    """The port's whole state of case ``i``, from data row 0's shards."""
    shards = sorted((r["coords"][1], r["state"]) for r in _case_ranks(port, i)
                    if r["coords"][0] == 0)
    return convert.unshard_state([st for _, st in shards])


def _bf16_bits(a):
    return np.asarray(a).view(np.uint16).astype(np.int32)


def assert_state_close(js, ts):
    for k in js:
        a, b = np.asarray(js[k]), np.asarray(ts[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        if a.dtype.name == "bfloat16":
            diff = np.abs(_bf16_bits(a) - _bf16_bits(b))
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, k
        else:
            np.testing.assert_allclose(b, a, **TRAJ_TOL, err_msg=k)


def assert_metrics_close(jm, tm):
    np.testing.assert_allclose(tm["objective"], jm["objective"], rtol=OBJ_RTOL)
    np.testing.assert_array_equal(tm["num_ex"], jm["num_ex"])
    np.testing.assert_array_equal(tm["correct"], jm["correct"])
    for k in ("grad_sq", "update_sq", "weight_sq"):
        np.testing.assert_allclose(tm[k], jm[k], **TRAJ_TOL, err_msg=k)
    assert tm["xw"].shape == jm["xw"].shape
    np.testing.assert_allclose(tm["xw"], jm["xw"], **TRAJ_TOL)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["x".join(map(str, c[:2])) + "-" + "-".join(map(str, c[2:]))
                              for c in CASES])
def test_mesh_worker_matches_the_jax_mesh_worker(runs, i):
    _, _, port, jax_runs, _ = runs
    d, s, update, dtype, steps, push = CASES[i]
    want = jax_runs[i]
    mine = _case_ranks(port, i)
    assert sorted(r["coords"] for r in mine) == [(a, b) for a in range(d) for b in range(s)]
    # every data rank holds the same bits of its server shard, and every
    # rank the same metrics, weights and pulls
    for r in mine:
        ref = next(o for o in mine if o["coords"] == (0, r["coords"][1]))
        for k in r["state"]:
            assert np.array_equal(_bf16_bits(r["state"][k]) if r["state"][k].dtype.name ==
                                  "bfloat16" else r["state"][k].view(np.uint32),
                                  _bf16_bits(ref["state"][k]) if ref["state"][k].dtype.name ==
                                  "bfloat16" else ref["state"][k].view(np.uint32))
        assert np.array_equal(r["weights"], mine[0]["weights"])
        assert np.array_equal(r["pulled"], mine[0]["pulled"])
        for a, b in zip(r["metrics"], mine[0]["metrics"]):
            assert all(np.array_equal(a[k], b[k]) for k in a)
    port_metrics = mine[0]["metrics"]
    assert len(port_metrics) == len(want["metrics"])
    if push:
        for jm, tm in zip(want["metrics"], port_metrics):
            np.testing.assert_array_equal(tm["num_ex"], jm["num_ex"])
            jl, tl = jm["objective"] / jm["num_ex"], tm["objective"] / tm["num_ex"]
            assert abs(tl - jl) <= max(0.01, 0.02 * jl), (jl, tl)
        return
    for jm, tm in zip(want["metrics"], port_metrics):
        assert_metrics_close(jm, tm)
    assert_state_close(want["state"], _whole_state(port, i))
    if dtype == "float32":
        np.testing.assert_allclose(mine[0]["weights"], want["weights"], **TRAJ_TOL)
        np.testing.assert_allclose(mine[0]["pulled"], want["pulled"], **TRAJ_TOL)


@pytest.mark.parametrize("update", ["sparse", "dense"])
def test_one_by_two_mesh_bit_equal_to_the_one_card_run(runs, update):
    batches, probe, port, _, _ = runs
    i = CASES.index((1, 2, update, "float32", 1, 0))
    Postoffice.reset()
    tw = tsgd.AsyncSGDWorker(ranks.linear_conf(update, "float32", 1), device="cpu")
    try:
        metrics = ranks.train_linear(tw, [_port_batch(b) for b in batches], 1)
        one = tw.state_host()["state"]
        weights, pulled = tw.weights_dense(), tw.pull(probe)
    finally:
        tw.remove()
        Postoffice.reset()
    whole = _whole_state(port, i)
    for k in one:
        assert np.array_equal(one[k].view(np.uint32), whole[k].view(np.uint32)), k
    mine = _case_ranks(port, i)[0]
    assert np.array_equal(weights.view(np.uint32), mine["weights"].view(np.uint32))
    # a pull is assembled with a psum over the server axis, where a
    # weight of -0.0 comes back +0.0 (-0.0 + 0.0), as the JAX psum's does
    assert np.array_equal(pulled, mine["pulled"])
    # the norms folded over the server axis are sums of per-shard sums,
    # in another order than the one card's sum over the table
    server_folded = tsgd._FOLD_DENSE if update == "dense" else tsgd._FOLD_SPARSE
    for a, b in zip(metrics, mine["metrics"]):
        for k in a:
            if "server" not in server_folded.get(k, ()):
                assert np.array_equal(a[k], b[k]), k


PUSH_CASE = (2, 2, "dense", "float32", 1, 1)


def _emulated_push_mesh(batches, d_n, s_n):
    """The 2 x 2 push-filter case in one process, with no collective: at
    each minibatch every data rank's rows give their own gradient of the
    whole table (the logistic row gradient at the current weights, each
    slot's entries summed in entry order, as the port's dense update
    adds them), each server shard of it is
    quantized with that rank's seed (``seed * 1000003 + d``, ``seed`` the
    ministep's count) and decoded where nonzero, the data ranks' decoded
    shards are added, the union of their supports is the touched mask,
    and FTRL updates each shard. The per-element pieces are the port's
    own (the loss, the quantizer, the FTRL update, each held to JAX
    elsewhere); the split, the seeds, the sums and the masks are this
    function's. Returns the whole state and each minibatch's objective."""
    Postoffice.reset()
    one = tsgd.AsyncSGDWorker(ranks.linear_conf(*PUSH_CASE[2:5], PUSH_CASE[5]), device="cpu")
    updater, loss, directory = one.updater, one.loss, one.directory
    one.remove()
    Postoffice.reset()
    shard = ranks.SLOTS // s_n
    state = [updater.init(shard, "cpu") for _ in range(s_n)]
    objective = []
    for t, b in enumerate(batches):
        seed = t + 1
        w = torch.cat([updater.weights(st) for st in state])
        g = [torch.zeros(shard) for _ in range(s_n)]
        touched = [torch.zeros(shard, dtype=torch.bool) for _ in range(s_n)]
        obj = 0.0
        per = -(-b.n // d_n)
        for d in range(d_n):
            lo_r, hi_r = min(d * per, b.n), min((d + 1) * per, b.n)
            keys = b.indices[b.indptr[lo_r]:b.indptr[hi_r]]
            rows = torch.as_tensor(np.repeat(np.arange(hi_r - lo_r), np.diff(b.indptr[lo_r:hi_r + 1])))
            y = torch.as_tensor(b.y[lo_r:hi_r])
            slots = torch.as_tensor(directory.slots(keys), dtype=torch.int64)
            xw = torch.zeros(hi_r - lo_r).index_add_(0, rows, w[slots])
            gr = loss.row_grad(y, xw)
            obj += float(loss.row_loss(y, xw).sum())
            g_all = torch.zeros(ranks.SLOTS).index_add_(0, slots, gr[rows])
            for s in range(s_n):
                part = g_all[s * shard:(s + 1) * shard]
                q, lo, hi = tsgd.qops.quantize(part, tsgd.mix_seed(seed, 1000003, d), num_bytes=1)
                g[s] = g[s] + torch.where(part != 0, tsgd.qops.dequantize(q, lo, hi, 1), 0.0)
                touched[s] |= part != 0
        for s in range(s_n):
            updater.apply(state[s], g[s], touched[s], seed=seed)
        objective.append(obj)
    whole = {k: torch.cat([st[k] for st in state]).numpy() for k in state[0]}
    return whole, objective


def test_push_filter_mesh_bit_equal_to_a_one_process_emulation(runs):
    """The push-filter case held tightly, where the JAX mesh can only be
    met statistically: the port's 2 x 2 state bit-equal to
    :func:`_emulated_push_mesh` (two data ranks add ``a + b``, the same
    bits in either order); the objectives, each a sum over rows in
    another order, within 1e-6 relative. A mesh that dropped the data
    psum, seeded every data rank alike, or took a wrong touched mask
    would part from it in the state's bits."""
    batches, _, port, _, _ = runs
    i = CASES.index(PUSH_CASE)
    whole, objective = _emulated_push_mesh(batches, *PUSH_CASE[:2])
    mine = _whole_state(port, i)
    for k in whole:
        assert np.array_equal(whole[k].view(np.uint32), mine[k].view(np.uint32)), k
    assert np.count_nonzero(whole["z"]) > 0
    got = [float(m["objective"]) for m in _case_ranks(port, i)[0]["metrics"]]
    np.testing.assert_allclose(got, objective, rtol=1e-6)


def test_jax_mesh_state_continues_on_the_port_mesh(runs):
    """The JAX 2 x 2 worker's whole state after 4 minibatches, cut to each
    rank's shard (``convert.shard_state``) with its seed counter, trains
    the last 4 on the port's 2 x 2 mesh: the JAX worker's own last 4
    within the trajectory tolerance."""
    _, _, port, _, final = runs
    i = len(CASES)  # the resumed case comes last
    mine = _case_ranks(port, i)
    assert sorted(r["coords"] for r in mine) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert_state_close(final, _whole_state(port, i))


# -- what a mesh refused until ROADMAP A9 slice 2 --


@pytest.mark.parametrize("field,value", [
    ("kkt_filter", True), ("wire_encode", "exact"), ("ell_lanes", 39), ("tau_adaptive", True),
])
def test_unported_features_on_a_mesh_raise_naming_a9(field, value):
    """The confs that raised naming A9 slice 2 here until its third part
    build on rank 0's view of a 2x2 mesh (nothing collective runs): the
    worker preps this data row's part of the global batch (with
    ``wire_encode``, encoded from the whole batch; ``ell_lanes`` rides
    along with it, as before) and builds the mesh step of its wire, with
    the KKT filter or adaptive τ; the launch agreement is on. They run in
    worlds in ``tests/test_torch_parallel_consistency.py``."""
    conf = ranks.linear_conf("sparse", "float32", 1)
    setattr(conf.async_sgd, field, value)
    if field == "tau_adaptive":
        conf.async_sgd.max_delay = 2
    if field == "ell_lanes":
        conf.async_sgd.wire_encode = "exact"
    mesh = tmesh.Mesh(2, 2, "cpu")  # rank 0's view; nothing collective runs
    Postoffice.reset()
    try:
        w = tsgd.AsyncSGDWorker(conf, mesh=mesh)
        prepped = w.prep(_port_batch(make_batch(0)), device_put=False)
        encoded = field in ("wire_encode", "ell_lanes")
        assert type(prepped).__name__ == ("EncodedExactBatch" if encoded else "PreppedBatch")
        assert prepped.counts.shape[0] == 1 if encoded else prepped.y.shape[0] == 1
        assert callable(w._get_step(prepped, True))
        assert w._agree_launches is (field != "kkt_filter")
        if field == "kkt_filter":
            assert w._significance is not None and w._consistency.tracker is not None
        if field == "tau_adaptive":
            assert w._consistency.controller.tau == 1
        w.remove()
    finally:
        Postoffice.reset()


def test_replica_and_migration_on_two_servers_raise_naming_a9():
    """What a mesh of two server shards refused until ROADMAP A9 slice 2,
    ported: no ``NotImplementedError`` is left there. On a 2x2 world: the
    worker's neighbour replica (``num_replicas 1``) on rank ``(d, s)`` is
    server shard ``s - 1``'s state at the last refresh, bit-equal to the
    JAX worker's ``jnp.roll`` of its table by a shard's width cut to that
    rank's rows up to ``TRAJ_TOL`` (the state's own tolerance); wiping
    shard 1 zeroes only its ranks' rows and ``recover_server_shard(1)``
    restores them bit for bit. The ``KVVector`` over the two shards
    migrates, gathers, snapshots and installs: its base-layout table
    bit-equal to the one-card store's on the same pushes."""
    from tests import torch_elastic_ranks as eranks

    batches = [make_batch(i) for i in range(3)]
    conf = ranks.linear_conf("sparse", "float32", 1)
    conf.async_sgd.num_replicas, conf.async_sgd.replica_every = 1, 1
    rng = np.random.default_rng(3)
    kv_batches = [(np.sort(rng.choice(997, 40, replace=False)).astype(np.int64),
                   rng.normal(size=(40, 2)).astype(np.float32)) for _ in range(4)]
    perm = np.random.default_rng(11).permutation(64)
    recs = launch.run_world(eranks.replica_and_migration_2x2, 4,
                            args=(conf, [_port_batch(b) for b in batches], kv_batches, perm),
                            device_type="cpu", timeout=240)
    JPostoffice.reset()
    try:
        jconf = _jax_conf("sparse", "float32", 1, 0)
        jconf.async_sgd.num_replicas, jconf.async_sgd.replica_every = 1, 1
        mesh = jmesh.make_mesh(num_data=2, num_server=2, devices=jax.devices()[:4])
        jw = jsgd.AsyncSGDWorker(jconf, mesh=mesh)
        for b in batches:
            jw.executor.wait(jw.process_minibatch(b))
        jw.executor.wait_all(pop=False)
        jrep = {k: np.asarray(v) for k, v in jw._replica_state.items()}
    finally:
        JPostoffice.reset()
    per = ranks.SLOTS // 2
    for rec in recs:
        d, s = rec["coords"]
        assert rec["no_replica"] is False and rec["recovered"] is True
        left = next(r for r in recs if r["coords"] == (d, 1 - s))
        for k in rec["state"]:
            # the copy of the left neighbour's shard (a roll by one shard)
            assert np.array_equal(rec["replica"][k], left["state"][k]), k
            np.testing.assert_allclose(rec["replica"][k], jrep[k][s * per:(s + 1) * per],
                                       **TRAJ_TOL, err_msg=k)
            assert np.array_equal(rec["after"][k], rec["state"][k]), k
            if s == 1:
                assert not rec["wiped"][k].any(), k
            else:
                assert np.array_equal(rec["wiped"][k], rec["state"][k]), k
    Postoffice.reset()
    one = KVVector(k=2, num_slots=64, hashed=True, device="cpu", name="one")
    try:
        for keys, vals in kv_batches:
            one.push(one.request(channel=0), keys=keys, values=vals)
        want = one.get_replica()[0]
    finally:
        one.executor.stop()
        Postoffice.reset()
    for rec in recs:
        assert rec["kv_migrate"]["rows_moved"] > 0 and rec["kv_migrate"]["attempts"] == 1
        for key in ("kv_replica", "kv_consistent", "kv_back"):
            assert rec[key].tobytes() == want.tobytes(), key
        assert not rec["kv_zeroed"].any()
        s = rec["coords"][1]
        cur = np.empty_like(want)
        cur[perm] = want
        assert rec["kv_shard"].tobytes() == cur[s * 32:(s + 1) * 32].tobytes()


# -- the CLI --


def test_cli_mesh_without_a_card_raises_unless_told_the_device(tmp_path, monkeypatch):
    """``--num-servers`` / ``--num-workers`` with no ``--device``: the
    ranks would run on the card, and with none the CLI raises before
    starting any, as the one-process CLI does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = tmp_path / "c.conf"
    conf.write_text('training_data { format: TEXT text: LIBSVM file: "none" }\n'
                    "async_sgd { algo: FTRL minibatch: 100 }\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main([str(conf), "--num-servers", "2", "--num-workers", "2"])


def test_darlin_in_a_launched_world_raises_on_the_mesh_it_builds(tmp_path, capfd):
    """In a launcher's world with the default flags the mesh auto-shapes
    over the world (here 2 x 1), where until ROADMAP A9 slice 2's third
    part each rank refused the darlin app naming A9: now every rank trains
    ``configs/rcv1/batch_l1lr.conf``'s app on its half of the rows (2,000
    generated), and the model of data row 0's rank holds the one-process
    CLI's keys, its weights within ``tests/test_torch_parallel_darlin.py``'s
    whole-run tolerance."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("synth_data", ROOT / "configs" / "synth_data.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    rng = np.random.default_rng(1)
    w = (rng.normal(size=1 << 12) * (rng.random(1 << 12) < 0.1)).astype(np.float32)
    synth.write_libsvm(str(tmp_path / "part-001"), rng, 2000, 1 << 12, 32, w)
    text = open(ROOT / "configs" / "rcv1" / "batch_l1lr.conf").read()
    text = text.replace("data/rcv1/train/part.*", str(tmp_path / "part-.*"))
    for name in ("world", "one"):
        (tmp_path / f"{name}.conf").write_text(
            text.replace("model/rcv1_batch", str(tmp_path / name / "model")))
    codes = launch.run_world(ranks.linear_cli, 2, args=([str(tmp_path / "world.conf")],),
                             device_type="cpu", timeout=120)
    assert codes == [0, 0]
    assert "model written to" in capfd.readouterr().out
    Postoffice.reset()
    assert tmain.main([str(tmp_path / "one.conf")], device="cpu") == 0
    a, b = _model(tmp_path / "world" / "model_S0"), _model(tmp_path / "one" / "model_S0")
    assert a and sorted(a) == sorted(b)
    np.testing.assert_allclose([a[k] for k in b], [b[k] for k in b], rtol=1e-5, atol=5e-6)


def _model(path):
    out = {}
    for line in open(path):
        if line.startswith("#"):
            assert re.match(r"#hashed\t\d+$", line.strip())
            continue
        k, v = line.split("\t")
        out[int(k)] = float(v)
    return out


def test_cli_two_by_two_model_matches_the_jax_cli(tmp_path, capfd):
    """``tests/test_linear_cli.py``'s svm conf (the one its ``mesh8``
    tests run), with a model output, at ``--num-servers 2 --num-workers
    2``: the port's CLI starts 4 CPU ranks; the JAX CLI runs a 2 x 2 mesh
    of its 8 virtual devices."""
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(400):
        y = rng.integers(0, 2)
        idx = np.sort(rng.choice(200, size=8, replace=False))
        lines.append(f"{y} " + " ".join(f"{i + 1}:1" for i in idx) + "\n")
    data = tmp_path / "part.train"
    data.write_text("".join(lines))
    confs = {}
    for side in ("jax", "port"):
        confs[side] = tmp_path / f"{side}.conf"
        confs[side].write_text(f"""
training_data {{
  format: TEXT
  text: LIBSVM
  file: "{data}"
}}
model_output {{
  format: TEXT
  file: "{tmp_path / side / 'model'}"
}}
loss {{ type: LOGIT }}
penalty {{ type: L1 lambda: 0.1 }}
learning_rate {{ type: DECAY alpha: 1 beta: 1 }}
async_sgd {{
  algo: FTRL
  minibatch: 100
}}
""")
    flags = ["--num-servers", "2", "--num-workers", "2"]
    JPostoffice.reset()
    try:
        assert jmain.main([str(confs["jax"]), *flags]) == 0
    finally:
        JPostoffice.reset()
    jax_out = capfd.readouterr().out
    assert tmain.main([str(confs["port"]), *flags], device="cpu") == 0
    port_out = capfd.readouterr().out
    assert "over gloo" in port_out and "examples" in port_out
    assert "model written to" in port_out and "model written to" in jax_out
    for s in (0, 1):
        want = _model(tmp_path / "jax" / f"model_S{s}")
        got = _model(tmp_path / "port" / f"model_S{s}")
        assert want and sorted(got) == sorted(want)
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], **TRAJ_TOL)
