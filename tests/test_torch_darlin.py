"""PyTorch port: the darlin app (block coordinate descent) against the JAX package.

Both packages run on the CPU on the same numpy data: the JAX
``DarlinSolver``/``DarlinScheduler`` on a one-device mesh
(``make_mesh(num_data=1, num_server=1)``), the port's with
``device="cpu"``. Each side adds every segment sum in entry order (XLA's
CPU scatter; the port's ``segment_sum``, ``index_add_`` on the CPU), and
both visit the blocks in the same order (Python's ``random`` with seed
0). They part only where XLA's CPU ``exp`` is not libm's (or SLEEF's):
U's curvature and the dual update round their exponentials differently in
the last bit or two. Tolerances, set from that:

- one block step from the same carried state (``convert.
  darlin_state_from_jax``): w and delta within 1e-6 relative, the dual
  within 1e-6 relative (the exponential's ulps, then one multiply), the
  active set and the violation's KKT decisions equal, the violation
  within 1e-6 relative;
- whole runs (tau 0 and 2, random block order): each pass's objective
  within 1e-6 relative, nnz(w) and the active set equal (no KKT decision
  flipped on these data), the violation within 1e-5 relative + 1e-6, the
  final w within 1e-5 relative + 5e-6;
- the single-block oracle of ``tests/test_darlin.py`` with its own
  tolerances.

The small ports the app needs (``utils/range.py``, the CSC view and
``from_dense`` of ``utils/sparse.py``, ``Executor.time``) are equal to
their JAX counterparts; the BCD scheduler's loading, slot layout and
feature blocks are equal block for block.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.apps.linear import darlin as jdarlin
from parameter_server_tpu.learner import bcd as jbcd
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu.system import executor as jexecutor
from parameter_server_tpu.system.postoffice import Postoffice
from parameter_server_tpu.utils import range as jrange
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear import darlin as tdarlin
from parameter_server_tpu_torch.learner import bcd as tbcd
from parameter_server_tpu_torch.system import customer as tcustomer
from parameter_server_tpu_torch.system import executor as texecutor
from parameter_server_tpu_torch.utils import evaluation as teval
from parameter_server_tpu_torch.utils import range as trange
from parameter_server_tpu_torch.utils import sparse as tsparse
from tests import test_darlin as jtests

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-6, atol=0.0)
RUN_W_TOL = dict(rtol=1e-5, atol=5e-6)
RUN_VIO_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_po():
    Postoffice.reset()
    yield
    Postoffice.reset()


@pytest.fixture(scope="module")
def mesh1():
    return meshlib.make_mesh(num_data=1, num_server=1, devices=jax.devices()[:1])


def make_conf(mod, lam=1.0, passes=10, ratio=4.0, tau=0, random_order=True):
    conf = mod.Config()
    conf.loss = mod.LossConfig(type="logit")
    conf.penalty = mod.PenaltyConfig(type="l1", lambda_=[lam])
    conf.learning_rate = mod.LearningRateConfig(alpha=1.0)
    conf.darlin = mod.BCDConfig(num_data_pass=passes, feature_block_ratio=ratio, epsilon=1e-6,
                                max_block_delay=tau, random_feature_block_order=random_order)
    return conf


def to_port(batch):
    """A JAX ``SparseBatch`` as the port's (the same arrays)."""
    return tsparse.SparseBatch(**{f.name: getattr(batch, f.name)
                                  for f in dataclasses.fields(tsparse.SparseBatch)})


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    w_true = (rng.normal(size=200) * (rng.random(200) < 0.15) * 2).astype(np.float32)
    return jsparse.random_sparse(2000, 200, 10, seed=1, w_true=w_true)


def jax_sched(mesh, data, **kw):
    sched = jdarlin.DarlinScheduler(make_conf(jcfg, **kw), mesh=mesh)
    sched.run_on(data)
    return sched


def port_sched(data, **kw):
    sched = tdarlin.DarlinScheduler(make_conf(tcfg, **kw), device="cpu")
    sched.run_on(to_port(data))
    return sched


def objectives(sched):
    return [sched.g_progress[i].objective for i in sorted(sched.g_progress)]


# -- one block step from a carried state --


def _carried(mesh, data, passes):
    """A JAX solver after ``passes`` passes (0: just initialized) and a
    port solver holding its state."""
    j = jdarlin.DarlinScheduler(make_conf(jcfg, passes=max(passes, 1)), mesh=mesh)
    if passes:
        j.run_on(data)
    else:
        j.set_data(data)
        j.solver.init_data(j.data, j.divide_feature_blocks())
    t = tdarlin.DarlinScheduler(make_conf(tcfg), device="cpu")
    t.set_data(to_port(data))
    blocks = t.divide_feature_blocks()
    assert [(b.group, b.col_range.begin, b.col_range.end) for b in blocks] == \
        [(b.group, b.col_range.begin, b.col_range.end) for b in j.fea_blk]
    t.solver.init_data(t.data, blocks)
    state = dict(w=j.solver.w, delta=j.solver.delta, active=j.solver.active,
                 dual=np.asarray(j.solver.dual))
    t.solver.set_state(convert.darlin_state_from_jax(state, blocks, device="cpu"))
    back = convert.darlin_state_to_numpy(t.solver.state(), blocks, t.solver.num_cols)
    for k in ("w", "delta", "active"):
        np.testing.assert_array_equal(back[k], state[k])
    np.testing.assert_array_equal(back["dual"], state["dual"].ravel())
    return j, t, blocks


@pytest.mark.parametrize("passes", [0, 3], ids=["early", "mid_run"])
@pytest.mark.parametrize("thr", [1e20, 0.3], ids=["no_kkt", "kkt"])
def test_one_block_step_matches_jax_from_a_carried_state(mesh1, dataset, passes, thr):
    """Each block's step from the JAX solver's state of that moment."""
    j, t, blocks = _carried(mesh1, dataset, passes)
    for b in range(len(blocks)):
        state = dict(w=j.solver.w, delta=j.solver.delta, active=j.solver.active,
                     dual=np.asarray(j.solver.dual))
        t.solver.set_state(convert.darlin_state_from_jax(state, blocks, device="cpu"))
        vj = j.solver.update_block(b, blocks, thr, reset=False)
        vt = t.solver.update_block(b, blocks, thr, reset=False)
        got = convert.darlin_state_to_numpy(t.solver.state(), blocks, t.solver.num_cols)
        np.testing.assert_allclose(got["w"], j.solver.w, **STEP_TOL)
        np.testing.assert_allclose(got["delta"], j.solver.delta, **STEP_TOL)
        np.testing.assert_array_equal(got["active"], j.solver.active)
        np.testing.assert_allclose(got["dual"], np.asarray(j.solver.dual).ravel(), **STEP_TOL)
        np.testing.assert_allclose(vt, vj, **STEP_TOL)
        assert (vt == 0) == (vj == 0)
    if thr < 1e20 and passes == 0:
        assert not j.solver.active.all()  # the threshold suspended coordinates


def test_block_step_with_reset_reactivates(mesh1, dataset):
    j, t, blocks = _carried(mesh1, dataset, 3)
    assert not j.solver.active.all()
    vj = j.solver.update_block(1, blocks, 0.3, reset=True)
    vt = t.solver.update_block(1, blocks, 0.3, reset=True)
    got = convert.darlin_state_to_numpy(t.solver.state(), blocks, t.solver.num_cols)
    np.testing.assert_array_equal(got["active"], j.solver.active)
    np.testing.assert_allclose(got["w"], j.solver.w, **STEP_TOL)
    np.testing.assert_allclose(vt, vj, **STEP_TOL)


def test_single_block_matches_the_oracle():
    """``tests/test_darlin.py``'s NumPy transcription of the reference's
    ComputeGradient + UpdateWeight + UpdateDual, on a whole-feature block
    without repeated (row, column) pairs, with its tolerances."""
    rng = np.random.default_rng(3)
    dense = (rng.random((400, 120)) < 0.08) * rng.normal(size=(400, 120))
    w_true = (rng.normal(size=120) * (rng.random(120) < 0.2) * 2).astype(np.float32)
    y = np.where(rng.random(400) < 1 / (1 + np.exp(-(dense @ w_true))), 1.0, -1.0)
    data = tsparse.from_dense(dense.astype(np.float32), y.astype(np.float32))
    conf = make_conf(tcfg, lam=0.5, ratio=0)
    sched = tbcd.BCDScheduler(conf.darlin)
    localized = sched.set_data(data)
    blocks = [tbcd.FeatureBlock(0, trange.Range(0, localized.cols))]
    solver = tdarlin.DarlinSolver(conf, device="cpu")
    solver.init_data(localized, blocks)
    X = localized.to_dense()
    w0, delta0, active0 = solver.w.copy(), solver.delta.copy(), solver.active.copy()
    vio = solver.update_block(0, blocks, thr=1e20, reset=False)
    ew, edelta, eactive, edual, evio = jtests.darlin_block_oracle(
        X, localized.y.astype(np.float64), w0, delta0, active0, np.ones(localized.n),
        lam=0.5, eta=1.0, delta_max=conf.darlin.delta_max_value, thr=1e20)
    np.testing.assert_allclose(solver.w, ew, atol=1e-4)
    np.testing.assert_allclose(solver.delta, edelta, atol=1e-4)
    np.testing.assert_array_equal(solver.active, eactive)
    np.testing.assert_allclose(solver.dual.numpy(), edual, rtol=1e-3)
    assert abs(vio - evio) < 1e-3


# -- whole runs --


@pytest.mark.parametrize("tau", [0, 2])
def test_whole_run_matches_jax(mesh1, dataset, tau):
    j = jax_sched(mesh1, dataset, tau=tau, passes=10)
    t = port_sched(dataset, tau=tau, passes=10)
    assert sorted(t.g_progress) == sorted(j.g_progress) and len(t.g_progress) > 3
    flips = 0
    for i in sorted(j.g_progress):
        a, b = j.g_progress[i], t.g_progress[i]
        np.testing.assert_allclose(b.objective, a.objective, rtol=1e-6)
        np.testing.assert_allclose(b.violation, a.violation, **RUN_VIO_TOL)
        flips += abs(a.nnz_w - b.nnz_w) + abs(a.nnz_active_set - b.nnz_active_set)
    assert flips == 0, f"{flips} KKT decisions apart"
    np.testing.assert_allclose(t.solver.w, j.solver.w, **RUN_W_TOL)
    np.testing.assert_array_equal(t.solver.active, j.solver.active)
    np.testing.assert_array_equal(t.global_keys, j.global_keys)


def test_block_order_is_the_jax_order(mesh1, dataset):
    """Python's ``random`` with the scheduler's seed gives both packages
    the same shuffles, pass after pass."""
    seen = {}
    for name, mod in (("jax", jdarlin), ("port", tdarlin)):
        orders = []
        cls = mod.DarlinSolver
        orig = cls.dispatch_block

        def record(self, blk_id, thr, reset, orig=orig, orders=orders):
            orders.append(blk_id)
            return orig(self, blk_id, thr, reset)

        cls.dispatch_block = record
        try:
            if name == "jax":
                jax_sched(mesh1, dataset, passes=4, ratio=8.0)
            else:
                port_sched(dataset, passes=4, ratio=8.0)
        finally:
            cls.dispatch_block = orig
        seen[name] = orders
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 32
    assert seen["port"][:8] != sorted(seen["port"][:8])


# -- the behaviour tests of tests/test_darlin.py, on the port --


def test_objective_decreases_and_learns(dataset):
    t = port_sched(dataset, passes=10)
    objs = objectives(t)
    assert all(b <= a + 1e-6 for a, b in zip(objs, objs[1:]))
    assert teval.auc(dataset.y, t.solver.predict_margin()) > 0.8


def test_kkt_filter_prunes_active_set(dataset):
    t = port_sched(dataset, passes=6)
    assert t.g_progress[max(t.g_progress)].nnz_active_set < t.data.cols


def test_heavier_l1_sparser(dataset):
    nnz = [port_sched(dataset, lam=lam, passes=6).g_progress[5].nnz_w for lam in (0.1, 10.0)]
    assert nnz[1] < nnz[0] * 0.7


def test_save_model_bytes_equal_jax(mesh1, dataset, tmp_path):
    """The same weights written by both packages give the same bytes:
    ``key\\tweight`` with the weight's ``repr`` as a Python float, the
    nonzeros in column order, one file ``_S0``."""
    j = jax_sched(mesh1, dataset, passes=4)
    t = port_sched(dataset, passes=4)
    blocks = t.fea_blk
    state = dict(w=j.solver.w, delta=j.solver.delta, active=j.solver.active,
                 dual=np.asarray(j.solver.dual))
    t.solver.set_state(convert.darlin_state_from_jax(state, blocks, device="cpu"))
    (jfile,) = j.save_model(str(tmp_path / "jax"))
    (tfile,) = t.save_model(str(tmp_path / "port"))
    assert tfile == str(tmp_path / "port") + "_S0" and jfile.endswith("jax_S0")
    want = open(jfile).read()
    assert open(tfile).read() == want
    assert len(want.splitlines()) == int((j.solver.w != 0).sum()) > 10


class TestTauPipelining:
    """Step ts waits on step ts - tau - 1: up to tau + 1 block steps are
    started and unfinished at once."""

    def test_blocks_pipeline_with_tau(self, dataset):
        t = port_sched(dataset, passes=3, ratio=8.0, tau=2)
        assert len(t.fea_blk) >= 4
        assert t.max_dispatch_window >= 2
        objs = objectives(t)
        assert objs[-1] < objs[0]

    def test_tau_zero_serializes(self, dataset):
        t = port_sched(dataset, passes=2, ratio=8.0, tau=0)
        assert t.max_dispatch_window <= 1
        assert t.max_in_flight_observed == 0  # the CPU's steps have no device work

    def test_tau_matches_serial_result(self, dataset):
        # the block steps chain through the dual in submission order, so
        # a delay changes no number
        runs = [port_sched(dataset, passes=3, tau=tau, random_order=False).solver.w
                for tau in (0, 3)]
        np.testing.assert_array_equal(runs[0], runs[1])


# -- loading, slot layout and feature blocks --


def _write_criteo(tmp_path, n):
    return jtests.TestCriteoEndToEnd()._write_criteo(tmp_path, n)


def _assert_layout_equal(t, j):
    np.testing.assert_array_equal(t.global_keys, j.global_keys)
    for name in ("y", "indptr", "indices", "values"):
        a, b = getattr(j.data, name), getattr(t.data, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=name)
    assert t.data.cols == j.data.cols
    assert t.slot_ranges == {k: trange.Range(v.begin, v.end) for k, v in j.slot_ranges.items()}
    if j.col_slots is None:
        assert t.col_slots is None
    else:
        np.testing.assert_array_equal(t.col_slots, j.col_slots)


def _blocks(blocks):
    return [(b.group, b.col_range.begin, b.col_range.end) for b in blocks]


def test_criteo_slots_through_the_slot_reader_match_jax(mesh1, tmp_path):
    path = _write_criteo(tmp_path, 300)
    j = jdarlin.DarlinScheduler(make_conf(jcfg, lam=0.1, passes=4, ratio=0.5), mesh=mesh1)
    j.load_data([path], "criteo", cache_dir=str(tmp_path / "jcache"))
    t = tdarlin.DarlinScheduler(make_conf(tcfg, lam=0.1, passes=4, ratio=0.5), device="cpu")
    t.load_data([path], "criteo", cache_dir=str(tmp_path / "tcache"))
    assert len(t.slot_ranges) == 39
    _assert_layout_equal(t, j)
    blocks = t.divide_feature_blocks()
    assert _blocks(blocks) == _blocks(j.divide_feature_blocks())
    assert {b.group for b in blocks} == set(range(1, 40))
    j.run_loaded()
    t.run_loaded()
    np.testing.assert_allclose(objectives(t), objectives(j), rtol=1e-6)
    assert objectives(t)[-1] < objectives(t)[0]
    assert sum(b.col_range.size() for b in t.fea_blk) == t.data.cols


def test_group_zero_on_terafea(mesh1, tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "t.terafea"
    with open(path, "w") as f:
        for i in range(200):
            k0 = rng.integers(0, 50)  # group 0
            k1 = (1 << 54) | rng.integers(0, 50)  # group 1
            f.write(f"{i % 2 * 2 - 1} {i} | {k0} {k1}\n")
    out = {}
    for name, mod, kw in (("jax", jdarlin, dict(mesh=mesh1)), ("port", tdarlin, dict(device="cpu"))):
        sched = mod.DarlinScheduler(make_conf(jcfg if name == "jax" else tcfg, lam=0.05, passes=3,
                                              ratio=0), **kw)
        sched.load_data([str(path)], "terafea")
        out[name] = (sched, _blocks(sched.divide_feature_blocks()))
    (t, tb), (j, jb) = out["port"], out["jax"]
    assert tb == jb and 0 in {g for g, _, _ in tb}
    assert sum(e - b for _, b, e in tb) == t.data.cols
    _assert_layout_equal(t, j)


def test_reload_resets_the_slot_layout(mesh1, dataset, tmp_path):
    path = _write_criteo(tmp_path, 50)
    t = tdarlin.DarlinScheduler(make_conf(tcfg, passes=2), device="cpu")
    t.load_data([path], "criteo", cache_dir=str(tmp_path / "c"))
    assert t.slot_ranges
    t.set_data(to_port(dataset))
    assert not t.slot_ranges and t.info is None and t.col_slots is None
    blocks = t.divide_feature_blocks()
    assert sum(b.col_range.size() for b in blocks) == t.data.cols
    j = jdarlin.DarlinScheduler(make_conf(jcfg, passes=2), mesh=mesh1)
    j.load_data([path], "criteo", cache_dir=str(tmp_path / "jc"))
    j.set_data(dataset)
    assert _blocks(blocks) == _blocks(j.divide_feature_blocks())


@pytest.mark.parametrize("source", ["synthetic", "criteo", "ctr_group_zero"])
@pytest.mark.parametrize("ratio,num_groups", [(3.0, 2), (4.0, 1), (0.5, 1), (0.0, 1)])
def test_divide_feature_blocks_equal_jax(dataset, tmp_path, source, ratio, num_groups):
    from parameter_server_tpu_torch.benchmarks.ctr import write_ctr_shards

    js = jbcd.BCDScheduler(jcfg.BCDConfig(feature_block_ratio=ratio))
    ts = tbcd.BCDScheduler(tcfg.BCDConfig(feature_block_ratio=ratio))
    if source == "synthetic":
        js.set_data(dataset)
        ts.set_data(to_port(dataset))
    else:
        if source == "criteo":
            files, fmt = [_write_criteo(tmp_path, 200)], "criteo"
        else:
            files, fmt = write_ctr_shards(str(tmp_path), 1, 300, seed=2, key_bits=10), "ps_sparse_binary"
        js.load_data(files, fmt)
        ts.load_data(files, fmt)
    _assert_layout_equal(ts, js)
    tb = ts.divide_feature_blocks(num_groups=num_groups)
    assert _blocks(tb) == _blocks(js.divide_feature_blocks(num_groups=num_groups))
    assert ts.blk_order == js.blk_order == list(range(len(tb)))
    assert sum(b.col_range.size() for b in tb) == ts.data.cols
    if source == "synthetic" and ratio == 3.0:
        assert len(tb) == 6


def test_progress_merge_and_line_match_jax():
    a, ja = tbcd.BCDProgress(objective=1.0, violation=0.5, nnz_w=10), \
        jbcd.BCDProgress(objective=1.0, violation=0.5, nnz_w=10)
    a.merge(tbcd.BCDProgress(objective=2.0, violation=0.3, nnz_w=5, busy_time=1.5))
    ja.merge(jbcd.BCDProgress(objective=2.0, violation=0.3, nnz_w=5, busy_time=1.5))
    assert dataclasses.asdict(a) == dataclasses.asdict(ja)
    assert a.objective == 3.0 and a.violation == 0.5 and a.nnz_w == 15
    t, j = tbcd.BCDScheduler(tcfg.BCDConfig()), jbcd.BCDScheduler(jcfg.BCDConfig())
    for i, p in enumerate([a, tbcd.BCDProgress(objective=1234.5678, relative_obj=-3e-7,
                                               violation=0.0, nnz_w=0, nnz_active_set=7)]):
        t.merge_progress(i, p)
        j.merge_progress(i, jbcd.BCDProgress(**dataclasses.asdict(p)))
        assert t.show_progress(i) == j.show_progress(i)
    t.merge_progress(1, tbcd.BCDProgress(objective=1.0, violation=2.0))
    j.merge_progress(1, jbcd.BCDProgress(objective=1.0, violation=2.0))
    assert t.show_progress(1) == j.show_progress(1)
    assert t.show_progress(9) == j.show_progress(9)  # a pass never run


# -- the app's device and its unported parts --


def test_darlin_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdarlin.DarlinScheduler(make_conf(tcfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.darlin_state_from_jax(dict(w=np.zeros(2), delta=np.zeros(2),
                                           active=np.ones(2, bool), dual=np.ones(3)), [])
    assert tdarlin.DarlinScheduler(make_conf(tcfg), device="cpu").solver.device.type == "cpu"


def test_app_is_the_small_customer():
    app = tcustomer.App(name="a")
    assert app.name == "a" and app.executor.name == "a"
    ts = app.executor.submit(lambda: 7)
    assert app.executor.wait(ts) == 7
    app.executor.stop()
    # App.create picks the app the conf selects (apps/registry.py)
    sched = tcustomer.App.create(make_conf(tcfg), device="cpu")
    assert isinstance(sched, tdarlin.DarlinScheduler) and isinstance(sched, tcustomer.App)


def test_unknown_comm_filter_warns(caplog):
    conf = make_conf(tcfg)
    conf.darlin.comm_filter = [{"type": "key_caching"}, {"type": "fixing_float"}]
    with caplog.at_level("WARNING"):
        tdarlin.DarlinScheduler(conf, device="cpu")
    assert "comm_filter 'fixing_float' is not applied" in caplog.text
    assert "comm_filter 'key_caching'" not in caplog.text


def test_run_refuses_other_losses(dataset):
    conf = make_conf(tcfg)
    conf.loss = tcfg.LossConfig(type="square")
    sched = tdarlin.DarlinScheduler(conf, device="cpu")
    sched.set_data(to_port(dataset))
    with pytest.raises(ValueError, match="logistic"):
        sched.run_loaded()


# -- the small ports: Range, the CSC view, from_dense, Executor.time --


RANGES = [(0, 10), (3, 3), (5, 2), (7, 1000), (0, 1), (-4, 9)]


@pytest.mark.parametrize("b,e", RANGES)
def test_range_matches_jax(b, e):
    t, j = trange.Range(b, e), jrange.Range(b, e)
    assert (t.size(), t.empty(), t.valid(), str(t)) == (j.size(), j.empty(), j.valid(), str(j))
    for n in (1, 2, 3, 7):
        assert [(r.begin, r.end) for r in t.divide(n)] == [(r.begin, r.end) for r in j.divide(n)]
    for ob, oe in RANGES:
        o, jo = trange.Range(ob, oe), jrange.Range(ob, oe)
        for op in ("intersection", "union"):
            a, c = getattr(t, op)(o), getattr(j, op)(jo)
            assert (a.begin, a.end) == (c.begin, c.end)
        assert t.contains_range(o) == j.contains_range(jo)
        assert (t < o) == (j < jo) and (t == o) == (j == jo)
    for k in (b - 1, b, e - 1, e):
        assert (k in t) == (k in j)
    assert (t.shift(5).begin, t.shift(5).end) == (j.shift(5).begin, j.shift(5).end)
    with pytest.raises(ValueError):
        t.even_divide(2, 2)
    assert trange.Range.all().size() == jrange.Range.all().size() == trange.UINT64_MAX


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_csc_view_and_dense_match_jax(binary, seed):
    j = jsparse.random_sparse(300, 50, 7, seed=seed, binary=binary)  # repeated (row, key) pairs
    t = to_port(j)
    jc, tc = j.to_csc(), t.to_csc()
    np.testing.assert_array_equal(tc.colptr, jc.colptr)
    np.testing.assert_array_equal(tc.row_ids, jc.row_ids)
    assert tc.row_ids.dtype == jc.row_ids.dtype and tc.colptr.dtype == jc.colptr.dtype
    assert (tc.values is None) == (jc.values is None) == binary
    if not binary:
        np.testing.assert_array_equal(tc.values, jc.values)
    assert (tc.cols, tc.num_rows) == (jc.cols, jc.num_rows)
    for col in (0, 17, 49):
        (tr, tv), (jr, jv) = tc.col(col), jc.col(col)
        np.testing.assert_array_equal(tr, jr)
        assert (tv is None) == (jv is None)
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())


def test_csc_view_of_an_empty_batch():
    t = tsparse.SparseBatch(y=np.zeros(3, np.float32), indptr=np.zeros(4, np.int64),
                            indices=np.zeros(0, np.int64), values=np.zeros(0, np.float32),
                            num_cols=5)
    c = t.to_csc()
    np.testing.assert_array_equal(c.colptr, np.zeros(6, np.int64))
    assert c.row_ids.size == 0 and c.cols == 5


def test_from_dense_matches_jax():
    rng = np.random.default_rng(4)
    x = ((rng.random((30, 12)) < 0.3) * rng.normal(size=(30, 12))).astype(np.float32)
    x[5] = 0.0  # an empty row
    y = np.where(rng.random(30) < 0.5, 1.0, -1.0)
    t, j = tsparse.from_dense(x, y), jsparse.from_dense(x, y)
    for name in ("y", "indptr", "indices", "values"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert t.num_cols == j.num_cols == 12
    np.testing.assert_array_equal(t.to_dense(), x)


def test_executor_time_matches_jax():
    t, j = texecutor.Executor("t"), jexecutor.Executor(name="j")
    try:
        seen = []
        for ex, task_cls in ((t, texecutor.Task), (j, jexecutor.Task)):
            clock = [ex.time()]
            for _ in range(3):
                ex.wait(ex.submit(lambda: None))
                clock.append(ex.time())
            ex.wait(ex.submit(lambda: None, task_cls(time=10)))  # an explicit stamp moves it on
            clock.append(ex.time())
            ex.submit(lambda: None, task_cls(time=6))  # an earlier one does not move it back
            clock.append(ex.time())
            seen.append(clock)
        assert seen[0] == seen[1] == [0, 1, 2, 3, 11, 11]
    finally:
        t.stop()
        j.stop()
