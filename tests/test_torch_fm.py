"""PyTorch port: the factorization machine (``apps/linear/fm.py``) against
the JAX package's, and the JAX suite's capability cases.

Both sides run on the CPU; the JAX worker sits on a 1x1 mesh
(``make_mesh(num_data=1, num_server=1)``), so no cross-shard ``psum``
reorders its sums. The port starts from the JAX worker's initial state
(``state_host`` -> ``load_state_host``: the V draws of ``jax.random``
and of a ``torch.Generator`` differ). The scatters of ``g_w`` and ``g_v``
add in entry order on both sides, but the forward's reductions
(``v_e.sum(1)``, ``(s * s).sum(1)``, ``(v_e * v_e).sum((1, 2))`` and the
bias gradient's ``gr.sum()``) may be taken in another order by XLA than
by torch, so states and metrics are held within ``STATE_RTOL`` of each
leaf's scale (``max |leaf|``, at least ``SCALE_FLOOR``).
``predict_margin`` is the host's float64 forward copied from the JAX
worker: on one state it is bit-equal.
"""

import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.apps.linear.fm import FMWorker as JFM
from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.utils.sparse import SparseBatch as JBatch
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear.fm import FMWorker
from parameter_server_tpu_torch.ops import kv_ops
from parameter_server_tpu_torch.ops import segment_sum as tseg
from parameter_server_tpu_torch.parameter.replica import CheckpointManager
from parameter_server_tpu_torch.system.postoffice import Postoffice
from parameter_server_tpu_torch.utils.sparse import SparseBatch

torch.set_num_threads(1)

# within 1e-5 of each leaf's scale: the forward's sums may be reduced in
# another order by XLA than by torch (module docstring). A leaf's scale is
# its largest magnitude, but at least SCALE_FLOOR: the bias is a sum of
# row gradients that cancel (|b| ~ 7e-4 after one step, its rounding
# ~2e-8), so it is held to 1e-7 absolute
STATE_RTOL = 1e-5
SCALE_FLOOR = 1e-2


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(num_data=1, num_server=1)


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    Postoffice.reset()
    JPostoffice.reset()


def make_conf(mod, num_slots=64, lanes=2, alpha=0.5, lambda1=0.01, rows_pad=0):
    conf = mod.Config()
    conf.loss = mod.LossConfig(type="logit")
    conf.penalty = mod.PenaltyConfig(type="l1", lambda_=[lambda1])
    conf.learning_rate = mod.LearningRateConfig(type="decay", alpha=alpha, beta=1.0)
    conf.async_sgd = mod.SGDConfig(algo="standard", minibatch=256, num_slots=num_slots,
                                   ell_lanes=lanes, rows_pad=rows_pad)
    return conf


def batch_pair(indptr, indices, y):
    """The same CSR batch for both packages."""
    kw = dict(y=np.asarray(y, np.float32), indptr=np.asarray(indptr, np.int64),
              indices=np.asarray(indices, np.int64), values=None)
    return JBatch(**kw), SparseBatch(**kw)


def random_batches(seed, n_batches, rows, lanes, ragged, key_space=1 << 40):
    """Binary ELL batches: ``ragged`` rows hold 1..lanes features (so
    sentinel lanes occur), else exactly ``lanes``; keys from
    ``key_space`` (hashing collides them into few slots)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        counts = rng.integers(1, lanes + 1, rows) if ragged else np.full(rows, lanes)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        keys = rng.integers(0, key_space, int(indptr[-1]))
        y = np.where(rng.random(rows) < 0.5, 1.0, -1.0)
        out.append(batch_pair(indptr, keys, y))
    return out


def interaction_batches(n_batches, rows_per=256, seed0=0):
    """Pure-interaction labels (the JAX suite's task): y = +1 iff both
    features come from the same group, zero linear signal."""
    out = []
    for i in range(n_batches):
        rng = np.random.default_rng(seed0 + i)
        a = rng.integers(0, 2, rows_per)
        b = rng.integers(0, 2, rows_per)
        keys = np.stack([a, 2 + b], axis=1).reshape(-1)
        y = np.where(a == b, 1.0, -1.0)
        out.append(batch_pair(np.arange(0, 2 * rows_per + 1, 2), keys, y)[1])
    return out


def leaves(tree, prefix=""):
    """``{path: array}`` of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {p: a for k in sorted(tree) for p, a in leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: a for i, t in enumerate(tree) for p, a in leaves(t, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def assert_states_close(jstate, tstate, rtol=STATE_RTOL):
    ja, ta = leaves(jstate), leaves(tstate)
    assert sorted(ja) == sorted(ta)
    for path in ja:
        a, b = ja[path], ta[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        scale = max(float(np.abs(a).max()), SCALE_FLOOR)
        gap = float(np.abs(a.astype(np.float64) - b).max())
        assert gap <= rtol * scale, (path, gap, scale)


def assert_progress_close(jp, tp, rtol=STATE_RTOL):
    assert jp.num_examples_processed == tp.num_examples_processed
    np.testing.assert_allclose(tp.objective, jp.objective, rtol=rtol)
    np.testing.assert_allclose(tp.accuracy, jp.accuracy, rtol=rtol)
    np.testing.assert_allclose(tp.auc, jp.auc, rtol=rtol)


def bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def pair(jcls, tcls, mesh, conf_kw=None, **kw):
    """A JAX worker and a port worker started from the JAX state."""
    conf_kw = conf_kw or {}
    j = jcls(make_conf(jcfg, **conf_kw), mesh=mesh, **kw)
    t = tcls(make_conf(tcfg, **conf_kw), device="cpu", **kw)
    t.load_state_host(j.state_host())
    return j, t


def train_both(j, t, batches):
    for jb, tb in batches:
        assert_progress_close(j.collect(j.process_minibatch(jb)),
                              t.collect(t.process_minibatch(tb)))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("ragged", [False, True])
def test_fm_state_matches_jax(mesh1, steps, ragged):
    j, t = pair(JFM, FMWorker, mesh1, dict(num_slots=257, lanes=4, lambda1=0.01), k=4,
                v_init_std=0.1, seed=3)
    assert_states_close(j.state_host()["state"], t.state_host()["state"], rtol=0.0)
    batches = random_batches(steps, steps, 48, 4, ragged)
    train_both(j, t, batches)
    assert_states_close(j.state_host()["state"], t.state_host()["state"])
    assert_progress_close(j.progress, t.progress)


def test_fm_predict_margin_and_evaluate_match_jax(mesh1):
    j, t = pair(JFM, FMWorker, mesh1, dict(num_slots=512, lanes=4), k=3, v_init_std=0.2, seed=5)
    train = random_batches(7, 3, 64, 4, ragged=True)
    for jb, _ in train:
        j.collect(j.process_minibatch(jb))
    t.load_state_host(j.state_host())  # one state on both sides
    jb, tb = random_batches(8, 1, 200, 4, ragged=True)[0]
    assert np.array_equal(bits(j.predict_margin(jb)), bits(t.predict_margin(tb)))
    assert j.evaluate(jb) == t.evaluate(tb)
    empty = batch_pair([0], [], [])
    assert t.predict_margin(empty[1]).shape == (0,)


def test_fm_card_route_scatter_equals_cpu(monkeypatch):
    """The card's scatter route (``scatter_sum`` through the segment sum's
    stable sort and its kernel, here its plain version) leaves the same
    bits as ``index_add_``."""
    conf = make_conf(tcfg, num_slots=61, lanes=4)
    cpu = FMWorker(conf, k=4, device="cpu", v_init_std=0.1, seed=1)
    card = FMWorker(make_conf(tcfg, num_slots=61, lanes=4), k=4, device="cpu", v_init_std=0.1,
                    seed=1)
    plain = lambda d, i, m: tseg.segment_sum_sorted_ref(*tseg.sort_by_segment(d, i, m), m)  # noqa: E731
    batches = random_batches(11, 3, 80, 4, ragged=True)
    for _, b in batches:
        cpu.collect(cpu.process_minibatch(b))
    monkeypatch.setattr(kv_ops, "segment_sum", plain)
    for _, b in batches:
        card.collect(card.process_minibatch(b))
    for name, a in cpu.state_host()["state"].items():
        assert np.array_equal(bits(a), bits(card.state_host()["state"][name])), name


def test_fm_single_step_matches_numpy():
    """One step against a float64 NumPy oracle (the JAX suite's check)."""
    alpha, beta, lam = 0.5, 1.0, 0.01
    w = FMWorker(make_conf(tcfg, num_slots=32, alpha=alpha, lambda1=lam), k=4, device="cpu",
                 v_init_std=0.1, seed=3)
    S, k = w.num_slots, w.k
    v0 = w.state["v"].numpy().copy()
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 40, (8, 2))
    y = np.where(rng.random(8) < 0.5, 1.0, -1.0)
    batch = batch_pair(np.arange(0, 17, 2), keys.reshape(-1), y)[1]
    slots = w.directory.slots(batch.indices).reshape(8, 2)
    w.collect(w.process_minibatch(batch))
    vv = v0.astype(np.float64)
    xw = np.zeros(8)
    for r in range(8):
        vr = vv[slots[r]]
        s = vr.sum(0)
        xw[r] = 0.5 * (s @ s - (vr * vr).sum())
    gr = -y / (1.0 + np.exp(y * xw))
    g_w, g_v = np.zeros(S), np.zeros((S, k))
    for r in range(8):
        vr = vv[slots[r]]
        s = vr.sum(0)
        for j in range(2):
            g_w[slots[r, j]] += gr[r]
            g_v[slots[r, j]] += gr[r] * (s - vr[j])
    touched = g_w != 0
    eta_w = alpha / (np.abs(g_w) + beta)
    w_new = np.sign(-eta_w * g_w) * np.maximum(np.abs(-eta_w * g_w) - lam * eta_w, 0.0)
    v_new = vv - alpha / (np.abs(g_v) + beta) * g_v
    np.testing.assert_allclose(w.state["w"].numpy(), np.where(touched, w_new, 0.0), atol=1e-5)
    np.testing.assert_allclose(w.state["v"].numpy(), np.where(touched[:, None], v_new, vv),
                               atol=1e-5)


def test_fm_learns_what_linear_cannot():
    from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDWorker

    train = interaction_batches(60)
    test = interaction_batches(1, rows_per=1000, seed0=999)[0]
    fm = FMWorker(make_conf(tcfg, alpha=0.3, lambda1=0.001), k=4, device="cpu",
                  v_init_std=0.3, seed=2)
    fm.train(iter(train))
    fm_auc = fm.evaluate(test)["auc"]
    linear = AsyncSGDWorker(make_conf(tcfg, alpha=0.3, lambda1=0.001), device="cpu")
    linear.train(iter(train))
    lin_auc = linear.evaluate(test)["auc"]
    assert fm_auc > 0.9, f"FM failed the interaction task: {fm_auc}"
    assert lin_auc < 0.6, f"linear should NOT solve it: {lin_auc}"


def test_fm_checkpoint_restore(tmp_path):
    mk = lambda seed: FMWorker(make_conf(tcfg, alpha=0.3, lambda1=0.001), k=4,  # noqa: E731
                               device="cpu", v_init_std=0.3, seed=seed)
    fm = mk(2)
    fm.train(iter(interaction_batches(20)))
    test = interaction_batches(1, rows_per=500, seed0=999)[0]
    want = fm.predict_margin(test)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    fm.checkpoint(mgr, step=3)
    fm2 = mk(42)
    assert fm2.restore(mgr) == 3
    assert np.array_equal(fm2.predict_margin(test), want)
    fm2.collect(fm2.process_minibatch(interaction_batches(1, seed0=55)[0]))


def test_fm_checkpoint_carries_across_packages(mesh1, tmp_path):
    """A JAX worker's state through the port's converter, and a port
    checkpoint restored by another port worker, bit for bit."""
    j = JFM(make_conf(jcfg), k=4, mesh=mesh1, v_init_std=0.3, seed=2)
    for jb, _ in random_batches(4, 2, 32, 2, ragged=False):
        j.collect(j.process_minibatch(jb))
    snap = j.state_host()["state"]
    state = convert.tree_from_numpy(snap, "cpu")
    assert all(np.array_equal(bits(np.asarray(snap[k])), bits(state[k].numpy())) for k in snap)
    t = FMWorker(make_conf(tcfg), k=4, device="cpu", seed=9)
    t.load_state_host({"state": snap})
    mgr = CheckpointManager(str(tmp_path / "ck"))
    t.checkpoint_async(mgr, step=1)
    mgr.wait()
    t2 = FMWorker(make_conf(tcfg), k=4, device="cpu", seed=11)
    t2.restore(mgr, step=1)
    for name, leaf in t2.state_host()["state"].items():
        assert np.array_equal(bits(leaf), bits(np.asarray(snap[name]))), name


def test_fm_predict_margin_handles_ragged_and_empty_rows():
    w = FMWorker(make_conf(tcfg, num_slots=64, lanes=4), k=3, device="cpu", v_init_std=0.2,
                 seed=5)
    batch = batch_pair([0, 3, 3, 7], [5, 9, 11, 2, 5, 30, 31], [1.0, -1.0, 1.0])[1]
    out = w.predict_margin(batch)
    v, wl, b = w.state["v"].numpy(), w.state["w"].numpy(), float(w.state["b"])
    slots = w.directory.slots(batch.indices)
    for r in range(3):
        sl = slots[batch.indptr[r]: batch.indptr[r + 1]]
        vr = v[sl]
        s = vr.sum(0)
        np.testing.assert_allclose(out[r], b + wl[sl].sum() + 0.5 * (s @ s - (vr * vr).sum()),
                                   atol=1e-5)


def test_fm_padding_is_fixed_by_the_first_batch_as_in_jax(mesh1):
    """The row padding comes from the first batch (or rows_pad); a larger
    batch raises with the JAX worker's message."""
    messages = []
    j, t = pair(JFM, FMWorker, mesh1, dict(lanes=2), k=4)
    small, big = random_batches(1, 1, 8, 2, False)[0], random_batches(2, 1, 9, 2, False)[0]
    for w, (b_small, b_big) in ((j, (small[0], big[0])), (t, (small[1], big[1]))):
        w.collect(w.process_minibatch(b_small))
        with pytest.raises(ValueError) as e:
            w.process_minibatch(b_big)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    t2 = FMWorker(make_conf(tcfg, lanes=2, rows_pad=16), k=4, device="cpu")
    t2.collect(t2.process_minibatch(small[1]))
    t2.collect(t2.process_minibatch(big[1]))
    with pytest.raises(ValueError, match="needs an async_sgd conf with ell_lanes"):
        FMWorker(make_conf(tcfg, lanes=0), device="cpu")


def test_fm_reports_to_an_attached_monitor():
    """``collect`` reports each step's progress to the monitor of the
    scheduler it is attached to (``MonitorSlaver``), merged there."""
    from parameter_server_tpu_torch.learner.sgd import ISGDScheduler, SGDProgress

    sched = ISGDScheduler()
    w = FMWorker(make_conf(tcfg), k=4, device="cpu", v_init_std=0.1)
    w.collect(w.process_minibatch(interaction_batches(1)[0]))  # before: not reported
    w.attach_monitor(sched)
    for b in interaction_batches(2, seed0=5):
        w.collect(w.process_minibatch(b))
    got = sched.monitor.progress()[w.name]
    assert isinstance(got, SGDProgress) and got.num_examples_processed == 512
    assert got.objective == w.progress.objective[1:]
