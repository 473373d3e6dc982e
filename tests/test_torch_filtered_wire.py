"""PyTorch port: the filtered dense wire and bounded delay against the JAX worker.

The JAX side runs on a 1x1 mesh on the CPU, where its quantized wire
takes ``quantize_jax`` (``jax.random`` noise); the port runs with
``device="cpu"``, where ``ops/quantize`` takes its plain version
(counter-hash noise, the CUDA kernel's). The noise streams differ, so:

- what is deterministic is compared exactly: the ``touched`` mask (the
  pre-quantization support), exact zeros staying zero, ``lo``/``hi``;
- quantized values agree within one quantization step
  ``(hi - lo) / levels`` (each side's code is ``floor(scaled + u)``, so
  the two codes differ by at most one), and a state updated from them
  within what one step can move it: ``√n`` by the step (``|√(n²+a²) -
  √(n²+b²)| <= |a - b|``), ``z`` by the step times ``1 + |w|/α``;
- trajectories land within ``max(0.01, 0.02 * ll)`` of the JAX run's
  per-example objective, the JAX package's own bar for quantized wires;
- unfiltered paths keep the exact-wire tolerances of
  ``tests/test_torch_linear_step.py`` (rtol 1e-5, atol 1e-6: XLA
  contracts ``z + g - sigma * w`` into an FMA under jit, eager PyTorch
  does not), τ > 0 included; the realized staleness of each submission
  is equal.

Both sides start from the same trained nonzero state where it matters:
the JAX worker trains a few unfiltered steps and the port loads its
``state_host()``.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu.system.postoffice import Postoffice
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu.utils.compat import shard_map
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear.learning_rate import LearningRate
from parameter_server_tpu_torch.apps.linear.penalty import create_penalty
from parameter_server_tpu_torch.apps.linear.updaters import FTRLUpdater
from parameter_server_tpu_torch.ops import kv_ops
from parameter_server_tpu_torch.ops import quantize as tqops
from parameter_server_tpu_torch.system.postoffice import Postoffice as TPostoffice

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)  # FMA contraction, fed back
MB, KEYS, NNZ, SLOTS = 256, 1 << 14, 39, 1 << 12
ALPHA = 0.1
FF1 = [{"type": "fixing_float", "num_bytes": 1}]


@pytest.fixture(autouse=True)
def _release_port_workers():
    """A port worker registers with the port's postoffice, whose manager
    keeps it (and its executor's thread) alive: reset that postoffice
    after each test, as the JAX tests reset theirs."""
    yield
    TPostoffice.reset()


def make_batch(seed, n=MB):
    """bench.py's synthetic batch at a small size (as in
    tests/test_torch_linear_step.py)."""
    b = jsparse.random_sparse(n, KEYS, NNZ, seed=seed, binary=True)
    b.y = np.where(
        (b.indices.reshape(n, -1) % 1024 < 256).mean(1) > 0.24, 1.0, -1.0
    ).astype(np.float32)
    return b


def _conf(mod, **sgd):
    c = mod.Config()
    c.penalty = mod.PenaltyConfig(type="l1", lambda_=[1.0])
    c.learning_rate = mod.LearningRateConfig(type="decay", alpha=ALPHA, beta=1.0)
    kw = dict(algo="ftrl", minibatch=MB, num_slots=SLOTS, update="dense")
    kw.update(sgd)
    c.async_sgd = mod.SGDConfig(**kw)
    return c


class _Staleness:
    """Records the JAX worker's realized staleness per submission (its
    learning plane's ``note_submit``), whether or not telemetry is on."""

    heat_every = 1 << 30

    def __init__(self, plane):
        self.plane, self.seen = plane, []

    def note_submit(self, staleness, **kw):
        self.seen.append(int(staleness))
        if self.plane is not None:
            self.plane.note_submit(staleness, **kw)

    def __getattr__(self, name):
        if self.plane is None:
            return lambda *a, **k: None
        return getattr(self.plane, name)


@pytest.fixture
def mesh():
    Postoffice.reset()
    yield meshlib.make_mesh(num_data=1, num_server=1, devices=jax.devices()[:1])
    Postoffice.reset()


def _workers(mesh, warm=0, **sgd):
    """A JAX and a port worker with the same conf; both start from the
    state the JAX worker reaches after ``warm`` unfiltered ministeps."""
    jw = jsgd.AsyncSGDWorker(_conf(jcfg, **sgd), mesh=mesh)
    tw = tsgd.AsyncSGDWorker(_conf(tcfg, **sgd), device="cpu")
    if warm:
        pre = jsgd.AsyncSGDWorker(_conf(jcfg), mesh=mesh)
        for i in range(warm):
            pre.executor.wait(pre.process_minibatch(make_batch(1000 + i)))
        snap = pre.state_host()
        jw.load_state_host(snap)
        tw.load_state_host(snap)
    jw._learning = _Staleness(jw._learning)
    return jw, tw


def _jax_on_mesh(mesh, fn, *args):
    """Run a JAX wire function under shard_map on the 1x1 mesh (its
    collectives need the mesh axes)."""
    specs = tuple(P() for _ in args)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=specs, out_specs=P(),
                             check_vma=False))(*args)


def _grad(seed, n=SLOTS, support=0.2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * 0.5 * (rng.random(n) < support)).astype(np.float32)


# -- the push wire --


@pytest.mark.parametrize("nb", [1, 2])
def test_push_touched_one_step(mesh, nb):
    g = _grad(1)
    seed = np.uint32(17)
    jred, jtouched = _jax_on_mesh(mesh, jsgd.make_push_touched(nb), g, seed)
    tred, ttouched = tsgd.make_push_touched(nb)(torch.from_numpy(g), int(seed))
    jred, jtouched = np.asarray(jred), np.asarray(jtouched)
    np.testing.assert_array_equal(ttouched.numpy(), jtouched)
    np.testing.assert_array_equal(ttouched.numpy(), g != 0)
    tred = tred.numpy()
    assert np.all(tred[g == 0] == 0) and np.all(jred[g == 0] == 0)
    step = (float(g.max()) - float(g.min())) / ((1 << (8 * nb)) - 1)
    assert np.abs(tred - jred).max() <= step * (1 + 1e-5) + 1e-6
    assert np.abs(tred - g).max() <= step * (1 + 1e-5) + 1e-6


def test_push_unquantized_is_the_identity_with_no_mask():
    g = torch.from_numpy(_grad(2))
    red, touched = tsgd.make_push_touched(0)(g, 5)
    assert red is g and touched is None


def test_push_noise_mean_only_matches_jax_exactly(mesh):
    """ADD_NOISE with std 0 adds the mean to nonzero entries: no draw
    survives (0 * normal), so this part of the filter is bit-comparable."""
    g = _grad(3)
    jg = np.asarray(_jax_on_mesh(mesh, jsgd.make_push_reduce(0, noise=(0.25, 0.0)), g, np.uint32(3)))
    tg = tsgd.make_push_reduce(0, noise=(0.25, 0.0))(torch.from_numpy(g), 3).numpy()
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tg[g == 0], 0.0)


def test_push_noise_is_gaussian_on_the_support():
    g = torch.from_numpy(_grad(4, n=1 << 16))
    out = tsgd.make_push_reduce(0, noise=(0.0, 0.5))(g, 11)
    d = (out - g)[g != 0]
    assert torch.equal(out[g == 0], g[g == 0])
    assert abs(float(d.mean())) < 0.02 and abs(float(d.std()) - 0.5) < 0.02
    again = tsgd.make_push_reduce(0, noise=(0.0, 0.5))(g, 11)
    assert torch.equal(out, again)  # seeded: the same stream for the same seed


# -- the pull wire --


def _state(seed):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=SLOTS) * 3).astype(np.float32)
    n = (rng.random(SLOTS) * 2).astype(np.float32)
    return {"z": z, "sqrt_n": n}


def _updaters():
    from parameter_server_tpu.apps.linear.learning_rate import LearningRate as JLR
    from parameter_server_tpu.apps.linear.penalty import create_penalty as jpen
    from parameter_server_tpu.apps.linear.updaters import FTRLUpdater as JFTRL

    ju = JFTRL(JLR("decay", ALPHA, 1.0), jpen("l1", [1.0]))
    tu = FTRLUpdater(LearningRate("decay", ALPHA, 1.0), create_penalty("l1", [1.0]))
    return ju, tu


@pytest.mark.parametrize("nb", [1, 2])
def test_pull_derive_one_step(mesh, nb):
    ju, tu = _updaters()
    state = _state(5)
    seed = np.uint32(23)
    jderive, _ = jsgd.make_pull_lookup(ju, nb)
    jw = np.asarray(_jax_on_mesh(mesh, jderive, state, seed))
    tderive, _ = tsgd.make_pull_lookup(tu, nb)
    tw = tderive({k: torch.from_numpy(v) for k, v in state.items()}, int(seed)).numpy()
    w = np.asarray(tu.weights({k: torch.from_numpy(v) for k, v in state.items()}))
    assert (w == 0).mean() > 0.2  # the L1 dead zone leaves exact zeros
    np.testing.assert_array_equal(tw == 0, w == 0)
    np.testing.assert_array_equal(jw == 0, w == 0)
    step = (float(w.max()) - float(w.min())) / ((1 << (8 * nb)) - 1)
    assert np.abs(tw - jw).max() <= step * (1 + 1e-5) + 1e-6
    assert np.abs(tw - w).max() <= step * (1 + 1e-5) + 1e-6


@pytest.mark.parametrize("nb", [1, 2])
def test_pull_narrow_equals_wide(nb):
    _, tu = _updaters()
    state = {k: torch.from_numpy(v) for k, v in _state(6).items()}
    rng = np.random.default_rng(6)
    slots = torch.tensor(np.append(rng.integers(0, SLOTS, 3000), [SLOTS] * 96), dtype=torch.int32)
    rel, ok = kv_ops.localize(slots, SLOTS)
    derive, lookup = tsgd.make_pull_lookup(tu, nb)
    wide = lookup(derive(state, 9), rel, ok)
    # the narrow gather, as the JAX package computes it: gather the codes
    # and the zero mask, dequantize after the gather
    w = tu.weights(state)
    q, lo, hi = tqops.quantize(w, tsgd.mix_seed(9, tsgd._PULL_SEED_MUL), num_bytes=nb)
    codes = q.view(torch.int16)[rel].view(torch.uint16) if nb == 2 else q[rel]
    narrow = torch.where(ok & (w != 0)[rel], tqops.dequantize(codes, lo, hi, nb), 0.0)
    assert torch.equal(wide.view(torch.int32), narrow.view(torch.int32))
    assert float(wide[~ok].abs().max()) == 0.0


def test_unfiltered_pull_derives_the_gathered_rows():
    """No pull filter: the lookup derives weights of the gathered rows
    only, bit-equal to gathering the derived table."""
    _, tu = _updaters()
    state = {k: torch.from_numpy(v) for k, v in _state(7).items()}
    rel, ok = kv_ops.localize(torch.tensor([0, 5, SLOTS, 17], dtype=torch.int32), SLOTS)
    derive, lookup = tsgd.make_pull_lookup(tu, 0)
    assert derive(state, 0) is state
    full = tu.weights(state)
    want = torch.where(ok, full.index_select(0, rel), 0.0)
    assert torch.equal(lookup(state, rel, ok), want)


# -- whole steps through the workers --


def _assert_filtered_step_close(start, touched, jstate, tstate, step):
    """Untouched slots keep their start state exactly (both sides);
    touched ones moved within what one quantization step explains."""
    z0, n0 = start["z"], start["sqrt_n"]
    jz, jn, tz, tn = jstate["z"], jstate["sqrt_n"], tstate["z"], tstate["sqrt_n"]
    for a, b0 in ((jz, z0), (tz, z0), (jn, n0), (tn, n0)):
        np.testing.assert_array_equal(a[~touched], b0[~touched])
    assert (tz[touched] != z0[touched]).mean() > 0.9
    eta = ALPHA / (n0 + 1.0)
    w0 = np.maximum(np.abs(z0) * eta - 1.0 * eta, 0.0)  # |w| at the start (L1 = 1)
    assert np.all(np.abs(tn - jn) <= step * (1 + 1e-5) + 1e-6)
    assert np.all(np.abs(tz - jz) <= step * (1 + w0 / ALPHA) * (1 + 1e-4) + 1e-5)


@pytest.mark.parametrize("nb", [1, 2])
def test_push_filtered_worker_step_from_a_trained_state(mesh, nb):
    ff = [{"type": "fixing_float", "num_bytes": nb}]
    jw, tw = _workers(mesh, warm=3, push_filter=ff)
    start = tw.state_host()["state"]
    b = make_batch(7)
    jm = jw.executor.wait(jw.process_minibatch(b))
    tm = tw.wait(tw.process_minibatch(b))
    # the forward pass and the pushed (pre-quantization) gradient are
    # the unfiltered step's
    np.testing.assert_allclose(float(tm["objective"]), float(jm["objective"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_sq"]), float(jm["grad_sq"]), **TRAJ_TOL)
    jstate, tstate = jw.state_host()["state"], tw.state_host()["state"]
    # the quantization step of this ministep's shard gradient
    g = _shard_grad(start, b)
    step = (float(g.max()) - float(g.min())) / ((1 << (8 * nb)) - 1)
    _assert_filtered_step_close(start, g != 0, jstate, tstate, step)
    assert tw.update_path == "torch_ref"


def _shard_grad(state, batch):
    """The unquantized shard gradient of ``batch`` at ``state`` (the
    unfiltered step's push, read back through a scratch worker)."""
    scratch = tsgd.AsyncSGDWorker(_conf(tcfg), device="cpu")
    scratch.load_state_host({"state": state, "seed_counter": np.int64(0)})
    cap = {}
    orig = scratch.updater.apply

    def spy(live, g, touched, seed=None):
        cap["g"] = g.clone()
        return orig(live, g, touched, seed=seed)

    scratch.updater.apply = spy
    scratch.wait(scratch.process_minibatch(batch))
    return cap["g"].numpy()


@pytest.mark.parametrize("gather", ["wide", "narrow"])
def test_pull_filtered_worker_step(mesh, gather):
    jw, tw = _workers(mesh, warm=3, pull_filter=FF1, pull_gather=gather)
    b = make_batch(8)
    w = tw.weights_dense()  # the weights this step pulls, before quantization
    jm = jw.executor.wait(jw.process_minibatch(b))
    tm = tw.wait(tw.process_minibatch(b))
    # the forward pass ran on quantized weights: margins within what one
    # step per weight can move them (39 keys per row)
    step = (float(w.max()) - float(w.min())) / 255
    np.testing.assert_allclose(tm["xw"].numpy(), np.asarray(jm["xw"]), atol=NNZ * step * 1.001)


def test_pull_narrow_and_wide_workers_are_bit_identical(mesh):
    _, wide = _workers(mesh, pull_filter=FF1, pull_gather="wide")
    _, narrow = _workers(mesh, pull_filter=FF1, pull_gather="narrow")
    for i in range(4):
        wide.wait(wide.process_minibatch(make_batch(i)))
        narrow.wait(narrow.process_minibatch(make_batch(i)))
    for k in wide.state:
        assert torch.equal(wide.state[k], narrow.state[k])


FILTERED = [
    ("push", dict(push_filter=FF1)),
    ("pull_wide", dict(pull_filter=FF1)),
    ("pull_narrow", dict(pull_filter=FF1, pull_gather="narrow")),
    ("push_pull_tau4", dict(push_filter=FF1, pull_filter=FF1, max_delay=4)),
]


@pytest.mark.parametrize("name,sgd", FILTERED, ids=[n for n, _ in FILTERED])
def test_filtered_trajectory_within_the_quantized_wire_bar(mesh, name, sgd):
    jw, tw = _workers(mesh, **sgd)
    plain = tsgd.AsyncSGDWorker(_conf(tcfg, max_delay=sgd.get("max_delay", 0)), device="cpu")
    jl, tl, tseen = [], [], []
    for i in range(8):
        b = make_batch(i)
        jm = jw.executor.wait(jw.process_minibatch(b))
        tm = tw.wait(tw.process_minibatch(b))
        plain.wait(plain.process_minibatch(b))
        tseen.append(tw.last_staleness)
        jl.append(float(jm["objective"]) / MB)
        tl.append(float(tm["objective"]) / MB)
    for j, t in zip(jl, tl):
        assert abs(t - j) <= max(0.01, 0.02 * j), (jl, tl)
    assert tseen == jw._learning.seen
    # the filter really acted: the state left the unfiltered trajectory
    assert not torch.equal(tw.state["z"], plain.state["z"])


# -- filters off --


def _plain_hashed_step(updater, loss, shard, batch, state, seed):
    """The unfiltered hashed step written out: with no filter set, the
    wire must reduce to exactly these operations."""
    y, mask, rows, slots, vals = (batch.y[0], batch.mask[0], batch.rows[0],
                                  batch.slots[0], batch.vals[0])
    rel, ok = kv_ops.localize(slots, shard)
    w_e = torch.where(ok, updater.weights(tsgd._gather_state(state, rel)), 0.0)
    xw = tsgd._segment_sum(vals * w_e, rows, y.shape[0])
    gr = loss.row_grad(y, xw) * mask
    g_push = torch.where(ok, vals * gr.index_select(0, rows), 0.0)
    updater.apply(state, tsgd._segment_sum(g_push, rel, shard), None, seed=seed)
    return xw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filters_off_bit_identical_to_the_unfiltered_step(dtype):
    tw = tsgd.AsyncSGDWorker(_conf(tcfg, ftrl_state_dtype=dtype), device="cpu")
    ref = tsgd.AsyncSGDWorker(_conf(tcfg, ftrl_state_dtype=dtype), device="cpu")
    for i in range(4):
        b = make_batch(i)
        m = tw.wait(tw.process_minibatch(b))
        prepped = ref.upload(ref.prep(b, device_put=False))
        ref._seed_counter += 1
        xw = _plain_hashed_step(ref.updater, ref.loss, ref.num_slots, prepped, ref.state,
                              ref._seed_counter)
        assert torch.equal(m["xw"][0], xw)
        for k in tw.state:
            assert torch.equal(tw.state[k], ref.state[k]), k


@pytest.mark.parametrize("filters", [
    [{"type": "key_caching", "clear_cache_if_done": True}],
    [{"type": "compressing"}, {"type": "sparse"}],
    [{"type": "add_noise", "mean": 0.0, "std": 0.0}],
])
def test_no_op_filters_leave_the_step_bit_identical(filters):
    plain = tsgd.AsyncSGDWorker(_conf(tcfg), device="cpu")
    other = tsgd.AsyncSGDWorker(_conf(tcfg, push_filter=filters, pull_filter=filters), device="cpu")
    for i in range(3):
        plain.wait(plain.process_minibatch(make_batch(i)))
        other.wait(other.process_minibatch(make_batch(i)))
    for k in plain.state:
        assert torch.equal(plain.state[k], other.state[k])


# -- bounded delay τ > 0 --


TAU_CASES = [("dense", 1), ("sparse", 1), ("sparse", 2)]


@pytest.mark.parametrize("update,steps", TAU_CASES, ids=[f"{u}-T{s}" for u, s in TAU_CASES])
def test_tau4_trajectory_matches_jax(mesh, update, steps):
    jw, tw = _workers(mesh, warm=2, update=update, max_delay=4, steps_per_launch=steps)
    batches = [make_batch(i) for i in range(12)]
    tseen = []
    for lo in range(0, 12, steps):
        group = batches[lo:lo + steps]
        if steps > 1:
            jm = jw.executor.wait(jw.submit_superbatch(group, with_aux=True))
            tm = tw.submit_superbatch(group, with_aux=True)
        else:
            jm = jw.executor.wait(jw.process_minibatch(group[0]))
            tm = tw.wait(tw.process_minibatch(group[0]))
        tseen.append(tw.last_staleness)
        np.testing.assert_allclose(float(tm["objective"]), float(jm["objective"]), rtol=1e-5)
        js, ts = jw.state_host()["state"], tw.state_host()["state"]
        for k in js:
            np.testing.assert_allclose(ts[k], np.asarray(js[k]), **TRAJ_TOL, err_msg=k)
    assert tseen == jw._learning.seen
    assert max(tseen) > 0  # the snapshot really lagged
    want = [0, 1, 2, 3] * 3 if steps == 1 else [0, 2, 0, 2, 0, 2]
    assert tseen == want


def test_tau_snapshot_is_a_copy_and_tau0_reads_live():
    tw = tsgd.AsyncSGDWorker(_conf(tcfg, max_delay=2), device="cpu")
    tw.wait(tw.process_minibatch(make_batch(0)))
    snap = tw._pull_state
    assert snap["z"].data_ptr() != tw.state["z"].data_ptr()
    before = snap["z"].clone()
    tw.wait(tw.process_minibatch(make_batch(1)))  # computes on the snapshot
    assert tw._pull_state is snap and torch.equal(snap["z"], before)
    assert not torch.equal(tw.state["z"], before)
    t0 = tsgd.AsyncSGDWorker(_conf(tcfg), device="cpu")
    t0.wait(t0.process_minibatch(make_batch(0)))
    assert t0._pull_state is t0.state


# -- mode rules --


def test_filters_keep_auto_on_dense(monkeypatch):
    monkeypatch.setattr(tsgd, "sparse_update_min_slots", lambda: 1)
    assert tsgd.AsyncSGDWorker(_conf(tcfg, update="auto"), device="cpu")._update_mode == "sparse"
    for sgd in (dict(push_filter=FF1), dict(pull_filter=FF1),
                dict(push_filter=[{"type": "add_noise", "std": 0.1}])):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, update="auto", **sgd), device="cpu")
        assert w._update_mode == "dense"


@pytest.mark.parametrize("sgd,match", [
    (dict(push_filter=FF1), "unfiltered"),
    (dict(pull_filter=FF1), "unfiltered"),
    (dict(pull_gather="narrow"), "narrow"),
])
def test_explicit_sparse_with_filters_raises(sgd, match):
    w = tsgd.AsyncSGDWorker(_conf(tcfg, update="sparse", **sgd), device="cpu")
    with pytest.raises(ValueError, match=match):
        w.process_minibatch(make_batch(0))


def test_filter_list_validation():
    with pytest.raises(ValueError, match="1 or 2"):
        tsgd._fixing_float_bytes([{"type": "fixing_float", "num_bytes": 4}], "push_filter")
    assert tsgd._fixing_float_bytes(FF1 + [{"type": "key_caching"}], "push_filter") == 1
    assert tsgd._add_noise_params([{"type": "add_noise", "mean": 1, "std": 2}]) == (1.0, 2.0)
    with pytest.raises(ValueError, match="pull_gather"):
        tcfg.SGDConfig(pull_gather="sideways")
