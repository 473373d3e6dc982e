"""PyTorch port: the wide&deep CTR worker (``apps/linear/deep_ctr.py``)
against the JAX package's, and the JAX suite's capability cases.

Both sides on the CPU, the JAX worker on a 1x1 mesh, the port started
from the JAX worker's state (the MLP's He init is the same numpy draw on
both sides; V is carried across). The deep gradients come from
``torch.autograd`` against ``jax.vjp``: the MLP's products and the row
sums may be reduced in another order, so states and metrics are held
within ``STATE_RTOL`` of each leaf's scale (``tests/test_torch_fm.py``).
"""

import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.apps.linear.deep_ctr import DeepCTRWorker as JDC
from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear.deep_ctr import DeepCTRWorker
from parameter_server_tpu_torch.ops import kv_ops
from parameter_server_tpu_torch.ops import segment_sum as tseg
from parameter_server_tpu_torch.parameter.replica import CheckpointManager
from parameter_server_tpu_torch.system.postoffice import Postoffice
from tests.test_torch_fm import (
    assert_progress_close,
    assert_states_close,
    batch_pair,
    bits,
    interaction_batches,
    make_conf,
    pair,
    random_batches,
    train_both,
)

torch.set_num_threads(1)


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


def worker(seed=2, hidden=(8,), **conf_kw):
    conf_kw.setdefault("alpha", 0.3)
    conf_kw.setdefault("lambda1", 0.001)
    return DeepCTRWorker(make_conf(tcfg, **conf_kw), k=4, hidden=hidden, device="cpu",
                         v_init_std=0.3, seed=seed)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("ragged,hidden", [(False, (8,)), (True, (16,)), (True, (16, 8))])
def test_deep_ctr_state_matches_jax(mesh1, steps, ragged, hidden):
    j, t = pair(JDC, DeepCTRWorker, mesh1, dict(num_slots=257, lanes=4, alpha=0.1), k=4,
                hidden=hidden, v_init_std=0.3, seed=3)
    # the MLP's He init: the same numpy draw in both packages
    for a, b in zip(j.state_host()["state"]["mlp"], DeepCTRWorker(
            make_conf(tcfg, num_slots=257, lanes=4), k=4, hidden=hidden, device="cpu",
            seed=3).state["mlp"]):
        assert np.array_equal(bits(np.asarray(a)), bits(b.numpy()))
    train_both(j, t, random_batches(20 + steps, steps, 48, 4, ragged))
    assert_states_close(j.state_host()["state"], t.state_host()["state"])
    assert_progress_close(j.progress, t.progress)


def test_deep_ctr_predict_margin_and_evaluate_match_jax(mesh1):
    j, t = pair(JDC, DeepCTRWorker, mesh1, dict(num_slots=512, lanes=4), k=3, hidden=(8,),
                v_init_std=0.2, seed=5)
    for jb, _ in random_batches(7, 3, 64, 4, ragged=True):
        j.collect(j.process_minibatch(jb))
    t.load_state_host(j.state_host())
    jb, tb = random_batches(8, 1, 200, 4, ragged=True)[0]
    assert np.array_equal(bits(j.predict_margin(jb)), bits(t.predict_margin(tb)))
    assert j.evaluate(jb) == t.evaluate(tb)


def test_deep_ctr_device_forward_matches_host_predict():
    w = worker(seed=1, num_slots=64)
    rng = np.random.default_rng(0)
    batch = batch_pair(np.arange(0, 33, 2), rng.integers(0, 1 << 40, 32),
                       np.where(rng.random(16) < 0.5, 1.0, -1.0))[1]
    host = w.predict_margin(batch)
    y, mask, slots = w.upload(batch)
    _, metrics = w._step(w.state, y, mask, slots)
    xw = metrics["xw"].numpy().ravel()
    np.testing.assert_allclose(xw[metrics["mask"].numpy().ravel() > 0], host, atol=1e-4,
                               rtol=1e-4)


def test_deep_ctr_card_route_scatter_equals_cpu(monkeypatch):
    plain = lambda d, i, m: tseg.segment_sum_sorted_ref(*tseg.sort_by_segment(d, i, m), m)  # noqa: E731
    cpu, card = worker(num_slots=61, lanes=4), worker(num_slots=61, lanes=4)
    batches = random_batches(12, 3, 80, 4, ragged=True)
    for _, b in batches:
        cpu.collect(cpu.process_minibatch(b))
    monkeypatch.setattr(kv_ops, "segment_sum", plain)
    for _, b in batches:
        card.collect(card.process_minibatch(b))
    a, b = cpu.state_host()["state"], card.state_host()["state"]
    for name in a["table"]:
        assert np.array_equal(bits(a["table"][name]), bits(b["table"][name])), name


def test_untouched_slots_stay_fixed_and_mlp_updates():
    w = worker(seed=2, num_slots=64, alpha=0.1, lambda1=0.0)
    v0 = w.state["table"]["v"].numpy().copy()
    mlp0 = [p.numpy().copy() for p in w.state["mlp"]]
    batch = batch_pair([0, 2, 4], [1, 3, 0, 2], [1.0, -1.0])[1]
    touched = set(w.directory.slots(batch.indices).tolist())
    w.collect(w.process_minibatch(batch))
    v1 = w.state["table"]["v"].numpy()
    for s in range(w.num_slots):
        if s in touched:
            assert np.abs(v1[s] - v0[s]).max() > 0, f"slot {s} should move"
        else:
            assert np.array_equal(v1[s], v0[s])
    assert any(np.abs(p1.numpy() - p0).max() > 0 for p1, p0 in zip(w.state["mlp"], mlp0))


def test_l1_pins_wide_but_deep_still_learns():
    w = worker(seed=3, hidden=(16,), lambda1=10.0)
    w.train(iter(interaction_batches(40)))
    assert float(w.state["table"]["w"].abs().max()) == 0.0
    assert w.evaluate(interaction_batches(1, rows_per=1000, seed0=999)[0])["auc"] > 0.9


def test_wide_deep_learns_interaction_linear_cannot():
    from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDWorker

    train = interaction_batches(60)
    test = interaction_batches(1, rows_per=1000, seed0=999)[0]
    deep = worker(seed=2, hidden=(16,))
    deep.train(iter(train))
    linear = AsyncSGDWorker(make_conf(tcfg, alpha=0.3, lambda1=0.001), device="cpu")
    linear.train(iter(train))
    assert deep.evaluate(test)["auc"] > 0.9
    assert linear.evaluate(test)["auc"] < 0.6


def test_checkpoint_mid_flight_keeps_metrics(tmp_path):
    """A checkpoint between submit and collect keeps the step's metrics
    (``state_host`` drains the executor without taking the results)."""
    w = worker(seed=2)
    ts = w.process_minibatch(interaction_batches(1)[0])
    w.checkpoint(CheckpointManager(str(tmp_path / "ck")), step=1)
    assert w.collect(ts).num_examples_processed == 256


def test_predict_margin_ragged_and_overflow():
    w = DeepCTRWorker(make_conf(tcfg, num_slots=64, lanes=4), k=3, hidden=(8,), device="cpu",
                      v_init_std=0.2, seed=5)
    batch = batch_pair([0, 3, 3, 7], [5, 9, 11, 2, 5, 30, 31], [1.0, -1.0, 1.0])[1]
    out = w.predict_margin(batch)
    v = w.state["table"]["v"].numpy().astype(np.float64)
    wl = w.state["table"]["w"].numpy().astype(np.float64)
    mlp = [p.numpy().astype(np.float64) for p in w.state["mlp"]]
    b = float(w.state["b"])
    slots = w.directory.slots(batch.indices)
    for r in range(3):
        sl = slots[batch.indptr[r]: batch.indptr[r + 1]]
        e = np.zeros((4, 3))
        e[: len(sl)] = v[sl]
        h = e.reshape(1, -1)
        for i in range(len(mlp) // 2 - 1):
            h = np.maximum(h @ mlp[2 * i] + mlp[2 * i + 1], 0.0)
        np.testing.assert_allclose(out[r], b + wl[sl].sum() + (h @ mlp[-2] + mlp[-1])[0, 0],
                                   atol=1e-5)
    wide = batch_pair([0, 5], [1, 2, 3, 4, 5], [1.0])[1]
    with pytest.raises(ValueError, match="lane budget"):
        w.predict_margin(wide)


def test_deep_ctr_checkpoint_restore(tmp_path):
    w = worker(seed=2, hidden=(16,))
    w.train(iter(interaction_batches(20)))
    test = interaction_batches(1, rows_per=500, seed0=999)[0]
    want = w.predict_margin(test)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    w.checkpoint(mgr, step=7)
    w2 = worker(seed=99, hidden=(16,))
    assert w2.restore(mgr) == 7
    assert np.array_equal(w2.predict_margin(test), want)
    w2.collect(w2.process_minibatch(interaction_batches(1, seed0=55)[0]))


def test_deep_ctr_state_converts_from_jax(mesh1):
    j = JDC(make_conf(jcfg), k=4, hidden=(8,), mesh=mesh1, seed=4)
    snap = j.state_host()["state"]
    state = convert.tree_from_numpy(snap, "cpu")
    back = convert.tree_to_numpy(state)
    assert np.array_equal(bits(np.asarray(snap["table"]["v"])), bits(back["table"]["v"]))
    assert len(back["mlp"]) == 4 and back["b"].shape == ()
