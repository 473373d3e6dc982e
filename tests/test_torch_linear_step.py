"""PyTorch port: the linear worker's trajectory against the JAX worker.

The JAX ``AsyncSGDWorker`` runs on a 1x1 mesh (one data shard, one
server shard) on the CPU; the port's ``AsyncSGDWorker`` runs with
``device="cpu"``, where its FTRL wrappers take their plain PyTorch
versions. Both see the same minibatches, made with numpy from fixed
seeds (the ``bench.py`` synthetic label rule at a small size), and the
same seeds for the bf16 stochastic narrow.

Tolerances, each with its reason:

- 8-ministep trajectories (state after every launch, and the gradient,
  update and weight norms): ``rtol=1e-5, atol=1e-6``; objective
  relative 1e-5. XLA on the CPU contracts ``z + g - sigma * w`` into a
  fused multiply-add under jit, eager PyTorch does not, and the
  last-bit differences feed back through the weights.
- bf16 sqrt_n: equal except for at most 0.1% of entries, which may
  differ by one bf16 ulp (a last-bit f32 difference can flip the
  dithered truncation).
- integer outputs (``num_ex``, ``correct``, the prep arrays, hashed
  slots): exact.
- AUC: ``atol=1e-4``: two margins within the f32 tolerance of each
  other may swap ranks.
"""

import numpy as np
import pytest

import jax
import torch

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu.system.postoffice import Postoffice
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.parameter.parameter import KeyDirectory
from parameter_server_tpu_torch.utils import murmur as tmurmur
from parameter_server_tpu_torch.utils import sparse as tsparse

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)  # FMA contraction, fed back
OBJ_RTOL = 1e-5
MB, KEYS, NNZ, SLOTS = 256, 1 << 14, 39, 1 << 12


def make_batch(seed, n=MB, mod=jsparse):
    """bench.py's synthetic batch at a small size: binary keys, labels
    from the share of low-id features in the row."""
    b = mod.random_sparse(n, KEYS, NNZ, seed=seed, binary=True)
    b.y = np.where(
        (b.indices.reshape(n, -1) % 1024 < 256).mean(1) > 0.24, 1.0, -1.0
    ).astype(np.float32)
    return b


def _conf(mod, update, dtype, steps):
    c = mod.Config()
    c.penalty = mod.PenaltyConfig(type="l1", lambda_=[1.0])
    c.learning_rate = mod.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = mod.SGDConfig(
        algo="ftrl", minibatch=MB, num_slots=SLOTS, max_delay=0,
        update=update, ftrl_state_dtype=dtype, steps_per_launch=steps,
    )
    return c


@pytest.fixture
def make_workers():
    Postoffice.reset()
    mesh = meshlib.make_mesh(num_data=1, num_server=1, devices=jax.devices()[:1])

    def build(update="sparse", dtype="float32", steps=1):
        jw = jsgd.AsyncSGDWorker(_conf(jcfg, update, dtype, steps), mesh=mesh)
        tw = tsgd.AsyncSGDWorker(_conf(tcfg, update, dtype, steps), device="cpu")
        return jw, tw

    yield build
    Postoffice.reset()


def _bf16_bits(a):
    return np.asarray(a).view(np.uint16).astype(np.int32)


def assert_state_close(js, ts):
    for k in js:
        a, b = np.asarray(js[k]), np.asarray(ts[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if a.dtype.name == "bfloat16":
            diff = np.abs(_bf16_bits(a) - _bf16_bits(b))
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, k
        else:
            np.testing.assert_allclose(b, a, **TRAJ_TOL, err_msg=k)


def assert_metrics_close(jm, tm):
    tm = {k: v.numpy() for k, v in tm.items()}
    np.testing.assert_allclose(tm["objective"], np.asarray(jm["objective"]), rtol=OBJ_RTOL)
    np.testing.assert_array_equal(tm["num_ex"], np.asarray(jm["num_ex"]))
    np.testing.assert_array_equal(tm["correct"], np.asarray(jm["correct"]))
    for k in ("grad_sq", "update_sq", "weight_sq"):
        np.testing.assert_allclose(tm[k], np.asarray(jm[k]), **TRAJ_TOL, err_msg=k)
    if "xw" in jm:
        assert tm["xw"].shape == np.asarray(jm["xw"]).shape
        np.testing.assert_allclose(tm["xw"], np.asarray(jm["xw"]), **TRAJ_TOL)


def _launch(jw, tw, group):
    """One launch on each worker: a superbatch for groups > 1, else one
    minibatch. Returns (JAX metrics, port metrics)."""
    if len(group) > 1:
        ts = jw.submit_superbatch(group, with_aux=True)
        tm = tw.submit_superbatch(group, with_aux=True)
    else:
        ts = jw.process_minibatch(group[0])
        tm = tw.wait(tw.process_minibatch(group[0]))
    return jw.executor.wait(ts), tm


TRAJ_CASES = [
    ("sparse", "float32", 1),
    ("sparse", "float32", 4),
    ("sparse", "bfloat16", 1),
    ("sparse", "bfloat16", 4),
    ("dense", "float32", 1),
    ("dense", "bfloat16", 1),
]


@pytest.mark.parametrize("update,dtype,steps", TRAJ_CASES)
def test_trajectory_matches_jax(make_workers, update, dtype, steps):
    jw, tw = make_workers(update, dtype, steps)
    assert tw.update_path == "torch_ref"
    batches = [make_batch(i) for i in range(8)]
    for lo in range(0, 8, steps):
        jm, tm = _launch(jw, tw, batches[lo : lo + steps])
        assert_metrics_close(jm, tm)
        assert_state_close(jw.state_host()["state"], tw.state_host()["state"])
    assert tw.state_host()["seed_counter"] == jw.state_host()["seed_counter"] == 8
    np.testing.assert_allclose(tw.weights_dense(), jw.weights_dense(), **TRAJ_TOL)


def test_train_progress_matches_jax(make_workers):
    jw, tw = make_workers("sparse", "float32", 4)
    batches = [make_batch(i) for i in range(10)]  # groups of 4, 4, 2
    jp = jw.train(iter(batches), pipelined=False)
    tp = tw.train(iter(batches))
    assert tp.num_examples_processed == jp.num_examples_processed == 10 * MB
    np.testing.assert_allclose(tp.objective, jp.objective, rtol=OBJ_RTOL)
    np.testing.assert_array_equal(tp.accuracy, jp.accuracy)
    assert len(tp.auc) == len(jp.auc) == 10
    np.testing.assert_allclose(tp.auc, jp.auc, atol=1e-4)
    assert_state_close(jw.state_host()["state"], tw.state_host()["state"])


@pytest.mark.parametrize("update", ["sparse", "dense"])
def test_prep_arrays_bit_equal(make_workers, update):
    jw, tw = make_workers(update)
    for seed in (0, 1):
        b = make_batch(seed)
        jp, tp = jw.prep(b, device_put=False), tw.prep(b, device_put=False)
        assert type(tp).__name__ == type(jp).__name__
        for name in tp.__dataclass_fields__:
            a, c = np.asarray(getattr(jp, name)), getattr(tp, name)
            assert a.dtype == c.dtype, name
            np.testing.assert_array_equal(c, a, err_msg=name)
    if update == "sparse":  # unique width padded to a multiple of 1024
        assert tp.uslots.shape[-1] % 1024 == 0


def test_hashed_slots_and_batches_bit_equal():
    from parameter_server_tpu.utils import murmur as jmurmur

    keys = np.random.default_rng(3).integers(0, 1 << 40, 50_000, dtype=np.int64)
    for n in (1 << 22, 1000003):
        np.testing.assert_array_equal(
            tmurmur.hash_slots(keys, n), jmurmur.hash_slots(keys, n)
        )
    np.testing.assert_array_equal(
        KeyDirectory(1 << 22).slots(keys), jmurmur.hash_slots(keys, 1 << 22)
    )
    jb, tb = make_batch(5), make_batch(5, mod=tsparse)
    for name in ("y", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    np.testing.assert_array_equal(tb.row_ids(), jb.row_ids())
    vb = jsparse.random_sparse(64, 100, 5, seed=2)
    tv = tsparse.random_sparse(64, 100, 5, seed=2)
    np.testing.assert_array_equal(tv.values, vb.values)
    sj, st = vb.slice_rows(10, 20), tv.slice_rows(10, 20)
    np.testing.assert_array_equal(st.indptr, sj.indptr)
    np.testing.assert_array_equal(st.values, sj.values)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_from_jax_continues_the_trajectory(make_workers, dtype):
    jw, tw = make_workers("sparse", dtype, 2)
    batches = [make_batch(i) for i in range(6)]
    jw.executor.wait(jw.submit_superbatch(batches[:2], with_aux=True))
    jw.executor.wait(jw.submit_superbatch(batches[2:4], with_aux=True))
    snap = jw.state_host()
    state = convert.state_from_jax(snap["state"], device="cpu")
    for k, v in snap["state"].items():
        assert state[k].shape == v.shape
        np.testing.assert_array_equal(
            convert.state_to_numpy({k: state[k]})[k].view(np.uint8),
            np.asarray(v).view(np.uint8),
        )  # bit-exact both ways, bf16 included
    tw.load_state_host(snap)
    assert_state_close(snap["state"], tw.state_host()["state"])
    jm, tm = _launch(jw, tw, batches[4:6])
    assert_metrics_close(jm, tm)
    assert_state_close(jw.state_host()["state"], tw.state_host()["state"])


def test_evaluate_and_pull_match_jax(make_workers):
    jw, tw = make_workers("sparse", "float32", 4)
    batches = [make_batch(i) for i in range(8)]
    jw.train(iter(batches), pipelined=False)
    tw.train(iter(batches))
    held_out = make_batch(1000, n=512)
    je, te = jw.evaluate(held_out), tw.evaluate(held_out)
    assert set(te) == {"auc", "accuracy", "logloss"}
    np.testing.assert_allclose(te["logloss"], je["logloss"], rtol=1e-5)
    np.testing.assert_allclose(te["auc"], je["auc"], atol=1e-4)
    np.testing.assert_allclose(te["accuracy"], je["accuracy"], atol=2 / 512)
    assert te["auc"] > 0.5  # it learned something from the label rule
    keys = held_out.indices[:100]
    w = jw.weights_dense()
    np.testing.assert_allclose(
        tw.pull(keys), w[jw.directory.slots(keys)], **TRAJ_TOL
    )


def test_superbatch_needs_sparse_update(make_workers):
    _, tw = make_workers("dense", "float32", 4)
    with pytest.raises(ValueError, match="sparse"):
        tw.submit_superbatch([make_batch(0), make_batch(1)])
