"""PyTorch port: the KKT filter and adaptive τ against the JAX worker.

The port's ``AsyncSGDWorker`` (``device="cpu"``) and the JAX package's
(a 1x1 mesh) train the same seeded minibatches (the shape of
``tests/test_consistency.py``: 64 rows of 6 binary keys from 2^12, a
2^9-slot table, FTRL with λ1 = 0.1):

- KKT filter (``TestKKTFilter``): candidate and suppressed counts, the
  drop set's summary and the revisit cadence equal the JAX worker's;
  escape 1 is bit-identical to no filter; all suppressed leaves the
  state bit-untouched; the config errors are the JAX package's words.
- adaptive τ (``TestAdaptiveTau``): the τ trajectory equals the JAX
  controller's on the same data; the soft spike, the reaction (learning
  rate backoff, rollback bit-exact to the snapshot) and the non-finite
  reaction behave as there.
- the live τ (``TestLiveTauAccounting``): moving τ never rebuilds the
  executor; every submission's staleness stays within the τ in force
  when it was submitted.

Tolerances: state against the JAX worker within ``TRAJ_TOL`` (XLA
contracts the FTRL step into fused multiply-adds, eager PyTorch does
not; ``tests/test_torch_linear_step.py``). Counts, the drop set, the τ
trajectory and the port's own bit-identity contracts are exact.
"""

import jax
import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu.system.postoffice import Postoffice
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.utils import sparse as tsparse
from parameter_server_tpu_torch.system.postoffice import Postoffice as TPostoffice

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
MB, SLOTS, KEYS, LANES = 64, 1 << 9, 1 << 12, 6


@pytest.fixture(autouse=True)
def _release_port_workers():
    """A port worker registers with the port's postoffice, whose manager
    keeps it (and its executor's thread) alive: reset that postoffice
    after each test, as the JAX tests reset theirs."""
    yield
    TPostoffice.reset()


@pytest.fixture
def mesh():
    Postoffice.reset()
    yield meshlib.make_mesh(num_data=1, num_server=1, devices=jax.devices()[:1])
    Postoffice.reset()


def _conf(mod, tau=3, **sgd):
    c = mod.Config()
    c.penalty = mod.PenaltyConfig(type="l1", lambda_=[0.1])
    c.learning_rate = mod.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = mod.SGDConfig(**dict(dict(algo="ftrl", minibatch=MB, num_slots=SLOTS,
                                            max_delay=tau), **sgd))
    return c


def _batches(mod, n, seed0=0):
    out = []
    for i in range(n):
        b = mod.random_sparse(MB, KEYS, LANES, seed=seed0 + i, binary=True)
        b.y = np.where(np.arange(MB) % 3 == 0, 1.0, -1.0).astype(np.float32)
        out.append(b)
    return out


def _pair(mesh, name, tau=3, **sgd):
    jw = jsgd.AsyncSGDWorker(_conf(jcfg, tau, **sgd), mesh=mesh, name=f"tcons_{name}")
    tw = tsgd.AsyncSGDWorker(_conf(tcfg, tau, **sgd), device="cpu")
    return jw, tw


def _train_both(jw, tw, n, seed0=0):
    try:
        jw.train(iter(_batches(jsparse, n, seed0)))
    finally:
        jw.executor.wait_all(pop=False)
    tw.train(iter(_batches(tsparse, n, seed0)))


def _states(w):
    return {k: np.asarray(v) for k, v in w.state_host()["state"].items()}


def _assert_state_close(jw, tw):
    js, ts = _states(jw), _states(tw)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], **TRAJ_TOL, err_msg=k)


def _assert_bits(a, b):
    for k in a:
        np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8), err_msg=k)


class TestKKTFilter:
    def test_filter_off_two_runs_bit_identical(self):
        runs = []
        for _ in range(2):
            w = tsgd.AsyncSGDWorker(_conf(tcfg, 2, update="sparse"), device="cpu")
            w.train(iter(_batches(tsparse, 6)))
            runs.append(_states(w))
        _assert_bits(*runs)

    def test_escape_one_filter_is_bit_identical_to_off(self, mesh):
        runs = []
        for kw in ({}, {"kkt_filter": True, "kkt_escape": 1.0}):
            w = tsgd.AsyncSGDWorker(_conf(tcfg, 2, update="sparse", **kw), device="cpu")
            w.train(iter(_batches(tsparse, 6)))
            runs.append(_states(w))
        _assert_bits(*runs)
        jw, tw = _pair(mesh, "noop", 2, update="sparse", kkt_filter=True, kkt_escape=1.0)
        _train_both(jw, tw, 6)
        jw.executor.stop()
        _assert_state_close(jw, tw)
        assert tw._consistency.tracker.suppressed == jw._consistency.tracker.suppressed == 0

    def test_all_suppressed_leaves_state_bit_untouched(self, mesh):
        jw, tw = _pair(mesh, "allsup", 0, update="sparse", kkt_filter=True, kkt_margin=1e9,
                       kkt_escape=0.0)
        before = _states(tw)
        _train_both(jw, tw, 2)
        jw.executor.stop()
        _assert_bits(before, _states(tw))
        t, j = tw._consistency.tracker, jw._consistency.tracker
        assert t.candidates > 0 and t.suppressed == t.candidates and t.pushed == 0
        assert t.summary() == j.summary()

    @pytest.mark.parametrize("escape", [0.0, 1.0 / 64.0, 0.25])
    @pytest.mark.parametrize("tau", [0, 2])
    def test_suppressed_counts_and_state_match_jax(self, mesh, escape, tau):
        jw, tw = _pair(mesh, f"counts{escape}_{tau}", tau, update="sparse", kkt_filter=True,
                       kkt_escape=escape)
        _train_both(jw, tw, 10)
        jw.executor.stop()
        t, j = tw._consistency.tracker.summary(), jw._consistency.tracker.summary()
        assert t == j and t["reconciled"] and 0 < t["suppressed"] < t["candidates"]
        _assert_state_close(jw, tw)
        np.testing.assert_allclose(tw.progress.objective, jw.progress.objective, rtol=1e-5)

    def test_scan_supersteps_keep_the_mask_and_match_jax(self, mesh):
        jw, tw = _pair(mesh, "scan", 0, update="sparse", kkt_filter=True, steps_per_launch=4)
        _train_both(jw, tw, 8)
        jw.executor.stop()
        assert tw._consistency.tracker.summary() == jw._consistency.tracker.summary()
        assert tw._consistency.tracker.suppressed > 0
        _assert_state_close(jw, tw)

    def test_two_filtered_runs_deterministic(self):
        summaries, states = [], []
        for _ in range(2):
            w = tsgd.AsyncSGDWorker(_conf(tcfg, 2, update="sparse", kkt_filter=True,
                                          kkt_drop_after=2, kkt_revisit_every=4,
                                          ingest_workers=1), device="cpu")
            w.train(iter(_batches(tsparse, 8)))
            summaries.append(w._consistency.tracker.summary())
            states.append(_states(w))
        assert summaries[0] == summaries[1]
        _assert_bits(*states)

    def test_host_drop_engages_and_revisits_as_jax(self, mesh):
        kw = dict(update="sparse", kkt_filter=True, kkt_margin=1e9, kkt_escape=0.0,
                  kkt_drop_after=2, kkt_revisit_every=5, ingest_workers=1)
        jw, tw = _pair(mesh, "drop", 1, **kw)
        try:
            jw.train(iter([_batches(jsparse, 1)[0]] * 10))
        finally:
            jw.executor.stop()
        tw.train(iter([_batches(tsparse, 1)[0]] * 10))
        t, j = tw._consistency.tracker, jw._consistency.tracker
        assert t.summary() == j.summary()
        assert t.summary()["dropped_slots"] > 0 and t.summary()["filtered_batches"] > 0
        assert t.summary()["revisit_batches"] == 2  # preps 5 and 10
        with t._lock, j._lock:
            assert t._dropped == j._dropped
        assert tw._consistency.snapshot()["significance"] == jw._consistency.snapshot()["significance"]

    def test_feedback_is_one_keep_vector_a_step(self):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, 0, update="sparse", kkt_filter=True,
                                      kkt_drop_after=3, ingest_workers=1), device="cpu")
        m = w.wait(w.process_minibatch(_batches(tsparse, 1)[0]))
        assert m["kkt_keep"].dtype == torch.bool and m["kkt_keep"].shape == m["kkt_uslots"].shape
        assert float(m["kkt_slots"]) == float((m["kkt_uslots"] < SLOTS).sum())

    def test_unique_padding_matches_the_jax_worker(self, mesh):
        """The escape stream is keyed by position in the padded unique
        vector: both workers pad it alike."""
        jw, tw = _pair(mesh, "pad", 0, update="sparse")
        b = _batches(jsparse, 1)[0]
        jp = jw.prep(b, device_put=False)
        jw.executor.stop()
        tp = tw.prep(_batches(tsparse, 1)[0], device_put=False)
        assert tp.uslots.shape == np.asarray(jp.uslots).shape
        np.testing.assert_array_equal(tp.uslots, np.asarray(jp.uslots))

    @pytest.mark.parametrize("kw,match", [
        (dict(kkt_filter=True, update="dense"), "sparse"),
        (dict(kkt_filter=True, update="sparse", kkt_drop_after=2), "ingest_workers=1"),
        (dict(kkt_filter=True, update="sparse", algo="standard"), "L1"),
    ])
    def test_config_validation(self, mesh, kw, match):
        errors = []
        for build in (lambda: jsgd.AsyncSGDWorker(_conf(jcfg, **kw), mesh=mesh, name="tcons_bad"),
                      lambda: tsgd.AsyncSGDWorker(_conf(tcfg, **kw), device="cpu")):
            with pytest.raises(ValueError, match=match) as e:
                build()
            errors.append(str(e.value))
        assert errors[0] == errors[1]


class TestAdaptiveTau:
    def test_tau_trajectory_matches_jax(self, mesh):
        jw, tw = _pair(mesh, "widen", 4, tau_adaptive=True)
        for w in (jw, tw):
            w._consistency.controller.stable_steps = 2  # the short run's ramp
        _train_both(jw, tw, 12)
        jw.executor.stop()
        tc, jc = tw._consistency.controller, jw._consistency.controller
        assert tc.tau_trace == jc.tau_trace
        assert tc.tau_trace[0] == 1 and 1 < max(tc.tau_trace) <= 4
        assert tw._effective_tau == tc.tau
        ts, js = tw._consistency.snapshot(), jw._consistency.snapshot()
        assert ts["tau"] == js["tau"] and ts["episodes"] == js["episodes"] == []
        _assert_state_close(jw, tw)

    def test_tau_trajectory_with_a_spike_matches_jax(self, mesh):
        """A batch of flipped labels in a stable run: both controllers
        halve τ at the same collect."""
        jw, tw = _pair(mesh, "spikerun", 4, tau_adaptive=True)
        for w in (jw, tw):
            w._consistency.controller.stable_steps = 2
        for mod, w in ((jsparse, jw), (tsparse, tw)):
            bs = _batches(mod, 16)
            for b in bs[12:]:
                b.y = -b.y * 40.0
            w.train(iter(bs))
        jw.executor.stop()
        assert tw._consistency.controller.tau_trace == jw._consistency.controller.tau_trace

    def test_soft_spike_clamps_tau_without_reaction(self):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, 4, tau_adaptive=True), device="cpu")
        ctl = w._consistency.controller
        ctl._set_tau(4)
        for _ in range(10):
            ctl.on_metrics(0.5, 1.0, False)
        alpha = float(w.lr.alpha)
        ctl.on_metrics(0.5, 50.0, False)
        assert ctl.tau == 2 and float(w.lr.alpha) == alpha and ctl.episodes == []

    def test_react_backs_off_lr_and_rolls_back_state(self):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, 3, tau_adaptive=True), device="cpu")
        w.train(iter(_batches(tsparse, 4)))
        snap = {k: np.asarray(v).copy()
                for k, v in w._consistency.controller._snapshot["state"].items()}
        alpha = float(w.lr.alpha)
        w.train(iter(_batches(tsparse, 3, seed0=50)))
        assert any(not np.array_equal(_states(w)[k], snap[k]) for k in snap)
        episode = w._consistency.react("test")
        assert episode["rolled_back"] and episode["tau_after"] == 0
        assert float(w.lr.alpha) == alpha * 0.5
        _assert_bits(_states(w), snap)

    def test_nonfinite_collect_runs_reaction_then_reconverges(self, mesh):
        jw, tw = _pair(mesh, "poison", 3, tau_adaptive=True)
        for mod, w in ((jsparse, jw), (tsparse, tw)):
            w.train(iter(_batches(mod, 4)))
            bad = _batches(mod, 1, seed0=90)[0]
            bad.y = np.full_like(bad.y, np.float32("inf"))
            w.train(iter([bad]))
            w.train(iter(_batches(mod, 4, seed0=100)))
        jw.executor.stop()
        tc, jc = tw._consistency.controller, jw._consistency.controller
        assert [e["reason"] for e in tc.episodes] == [e["reason"] for e in jc.episodes] == ["nonfinite"]
        assert tc.episodes[0]["rolled_back"] and tc.tau_trace == jc.tau_trace
        assert all(np.isfinite(x) for x in tw.progress.objective[-3:])

    def test_rollback_fault_point_fires_before_any_state_change(self, mesh):
        """``consistency.rollback`` fires first in a reaction, as in the
        JAX controller: a raise there leaves the rate, τ, the state and
        the episode log as they were, on both packages."""
        from parameter_server_tpu.system import faults as jfaults
        from parameter_server_tpu_torch.system import faults

        jw, tw = _pair(mesh, "fault", 3, tau_adaptive=True)
        try:
            for mod, w, fmod in ((jsparse, jw, jfaults), (tsparse, tw, faults)):
                w.train(iter(_batches(mod, 2)))
                alpha, tau, state = float(w.lr.alpha), w._consistency.controller.tau, _states(w)
                fmod.arm("consistency.rollback", kind="raise")
                try:
                    with pytest.raises(fmod.FaultError, match="consistency.rollback"):
                        w._consistency.react("drill")
                finally:
                    fmod.disarm("consistency.rollback")
                assert float(w.lr.alpha) == alpha
                assert w._consistency.controller.tau == tau
                assert w._consistency.controller.episodes == []
                _assert_bits(_states(w), state)
            episode = tw._consistency.react("drill")  # disarmed: the reaction runs
            assert episode["reason"] == "drill" and float(tw.lr.alpha) == alpha * 0.5
        finally:
            jw.executor.stop()

    def test_effective_tau_clamped_to_configured_cap(self):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, 3), device="cpu")
        assert w.set_effective_tau(99) == 3
        assert w.set_effective_tau(-5) == 0


class TestLiveTauAccounting:
    def test_moving_tau_never_rebuilds_the_executor(self):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, 8, update="sparse"), device="cpu")
        ex = w.executor
        for tau in (0, 1, 3, 5, 8, 4, 0, 8):
            w.set_effective_tau(tau)
            w.train(iter(_batches(tsparse, 2, seed0=20 + tau)))
        assert w.executor is ex and ex.max_in_flight == 9

    def test_staleness_within_the_live_tau(self):
        """Each submission's realized staleness against the τ in force
        when it was submitted: the JAX worker's live-τ rule."""
        w = tsgd.AsyncSGDWorker(_conf(tcfg, 4, update="sparse"), device="cpu")
        seen = []
        for i, tau in enumerate((4, 4, 4, 4, 4, 1, 1, 1, 0, 2, 2, 2, 2)):
            w.set_effective_tau(tau)
            w.wait(w.process_minibatch(_batches(tsparse, 1, seed0=i)[0]))
            seen.append((tau, w.last_staleness))
        assert all(s <= t for t, s in seen)
        assert [s for _, s in seen] == [0, 1, 2, 3, 0, 0, 0, 0, 0, 1, 0, 1, 0]
