"""PyTorch port: the linear worker as an ISGDCompNode, its checkpoints
and bit-identical resume, against the JAX package.

- ``CheckpointManager.restore`` of a bfloat16 leaf: the JAX package's
  npz checkpoints (and ``np.savez`` of any ``ml_dtypes`` array) hold a
  bf16 leaf as a 2-byte void array; it restores into a bf16 template
  from its raw bits, a float32 leaf (the port's own form, and the only
  one where ``ml_dtypes`` is missing) narrows back, and any other void
  leaf raises ``ValueError`` naming the leaf.
- The JAX ``TestCheckpointResume::test_resume_is_bit_identical``
  (``tests/test_async_sgd.py``) on the port: a run checkpointed part way
  and resumed in a fresh worker ends bit-equal to the unbroken run, on
  the ELL bits wire, the sparse update with bf16 √n and T 4, and the
  dense update with a 1-byte push filter and τ 4 (whose quantization
  noise follows the restored seed counter; with the counter forced to 0
  the resumed run differs, so the check can fail).
- Checkpoints across the packages (the JAX ``CheckpointManager`` with
  ``use_orbax=False``): a JAX worker's checkpoint restores into the
  port's worker, and the port's into the JAX worker, to the other's
  state bit for bit, f32 and bf16 √n, sparse and dense. The JAX npz
  restore cannot read a bf16 void leaf (``jax.device_put`` refuses
  ``|V2``); the port writes bf16 widened to float32, which the JAX
  worker restores as float32 leaves of the same values.
- ``checkpoint_async`` snapshots at the call (the JAX
  ``tests/test_linear_cli.py::test_checkpoint_async_mixin``), on a toy
  ``Checkpointable`` and on the worker.
- ``submit_group``'s ``(timestamp, ministeps)`` pairs equal the JAX
  worker's on the same batches; ``process_minibatch`` returns a
  timestamp; the worker is an ``App``, a ``Customer`` and a
  ``Checkpointable`` on the customer's executor, and ``remove()`` stops
  it and takes it off the manager.

Tolerance: bit-equal everywhere (a storage round trip and a replay of
the same steps on the same device). The JAX workers run on a 1x1 mesh
on the CPU, the port's with ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

import jax
import ml_dtypes

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu.parameter import replica as jreplica
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.learner.sgd import ISGDCompNode, SGDProgress
from parameter_server_tpu_torch.parameter.replica import Checkpointable, CheckpointManager
from parameter_server_tpu_torch.system.customer import App, Customer
from parameter_server_tpu_torch.system.postoffice import Postoffice
from parameter_server_tpu_torch.utils import sparse as tsparse

torch.set_num_threads(1)

MB, KEYS, NNZ = 256, 512, 8


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    Postoffice.reset()
    JPostoffice.reset()


@pytest.fixture(scope="module")
def mesh1():
    return meshlib.make_mesh(num_data=1, num_server=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def w_true():
    rng = np.random.default_rng(0)
    return (rng.normal(size=KEYS) * (rng.random(KEYS) < 0.2)).astype(np.float32)


def batches(n, w_true, seed0=0, mod=tsparse):
    return [mod.random_sparse(MB, KEYS, NNZ, seed=seed0 + i, w_true=w_true, binary=True)
            for i in range(n)]


# the resumed configurations: (SGDConfig fields, ministeps before the checkpoint)
CASES = {
    "ell_bits": (dict(num_slots=4096, ell_lanes=8, wire="bits"), 5),
    "sparse_bf16_T4": (dict(num_slots=4096, update="sparse", ftrl_state_dtype="bfloat16",
                            steps_per_launch=4), 8),
    "dense_push1_tau4": (dict(num_slots=4096, update="dense", max_delay=4,
                              push_filter=[{"type": "fixing_float", "num_bytes": 1}]), 8),
}


def conf(mod, **sgd):
    c = mod.Config()
    c.penalty = mod.PenaltyConfig(type="l1", lambda_=[0.01])
    c.learning_rate = mod.LearningRateConfig(type="decay", alpha=0.5, beta=1.0)
    c.async_sgd = mod.SGDConfig(algo="ftrl", minibatch=MB, **sgd)
    return c


def bits(state: dict) -> dict:
    """Each leaf's raw bits (bf16 as int16), on the host."""
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            out[k] = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
        else:
            v = np.asarray(v)
            out[k] = v.view(np.int16) if v.dtype.name == "bfloat16" else v
    return out


def assert_bits_equal(a: dict, b: dict):
    a, b = bits(a), bits(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


# -- the bf16 leaf of a checkpoint --


def _bf16(n=6, seed=0):
    return (np.random.default_rng(seed).normal(size=n).astype(np.float32)
            .astype(ml_dtypes.bfloat16))


@pytest.mark.parametrize("writer", ["jax_npz", "np_savez", "port"])
def test_bf16_leaf_restores_bit_for_bit(tmp_path, writer):
    """A bf16 leaf written by the JAX package's npz checkpoints (a ``|V2``
    void array), by ``np.savez`` of an ``ml_dtypes`` array, or by the port
    (float32) restores into a torch bf16 template and into an
    ``ml_dtypes`` template with its bits unchanged."""
    a = _bf16()
    tree = {"seed_counter": np.int64(3), "state": {"sqrt_n": a, "z": np.arange(6, dtype=np.float32)}}
    if writer == "jax_npz":
        jreplica.CheckpointManager(str(tmp_path), use_orbax=False).save(1, tree)
    elif writer == "np_savez":
        d = tmp_path / "step_0000000001"
        d.mkdir()
        np.savez(d / "arrays.npz", np.int64(3), a, np.arange(6, dtype=np.float32),
                 __treedef__=np.zeros(1, np.uint8))
    else:
        CheckpointManager(str(tmp_path)).save(1, tree)
    with np.load(tmp_path / "step_0000000001" / "arrays.npz") as data:
        saved = data["arr_1"].dtype
    assert saved == (np.float32 if writer == "port" else np.dtype("V2"))
    mgr = CheckpointManager(str(tmp_path))
    like = {"seed_counter": np.int64(0),
            "state": {"sqrt_n": torch.zeros(6, dtype=torch.bfloat16), "z": torch.zeros(6)}}
    out = mgr.restore(1, like=like)
    assert out["state"]["sqrt_n"].dtype == torch.bfloat16
    assert np.array_equal(out["state"]["sqrt_n"].view(torch.int16).numpy(), a.view(np.int16))
    assert int(out["seed_counter"]) == 3
    out = mgr.restore(1, like=dict(like, state={"sqrt_n": _bf16(seed=1), "z": np.zeros(6, np.float32)}))
    assert out["state"]["sqrt_n"].dtype == a.dtype
    assert np.array_equal(out["state"]["sqrt_n"].view(np.int16), a.view(np.int16))


@pytest.mark.parametrize("leaf,tmpl", [
    (np.zeros(4, np.dtype("V4")), torch.zeros(4, dtype=torch.bfloat16)),
    (_bf16(4), torch.zeros(4)),
    (_bf16(4), np.zeros(4, np.float32)),
    (_bf16(4), 0),
], ids=["void4_into_bf16", "void2_into_f32_tensor", "void2_into_f32_array", "void2_into_int"])
def test_other_void_leaves_raise_naming_the_leaf(tmp_path, leaf, tmpl):
    d = tmp_path / "step_0000000001"
    d.mkdir()
    np.savez(d / "arrays.npz", leaf, __treedef__=np.zeros(1, np.uint8))
    with pytest.raises(ValueError, match="'/state/sqrt_n'"):
        CheckpointManager(str(tmp_path)).restore(1, like={"state": {"sqrt_n": tmpl}})


# -- resume --


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_is_bit_identical(tmp_path, w_true, case):
    """An unbroken run against a run checkpointed after ``k`` ministeps
    and resumed in a fresh worker on the same tail: state, seed counter
    and every tail ministep's progress bit-equal."""
    sgd, k = CASES[case]
    head, tail = batches(k, w_true), batches(8, w_true, seed0=50)
    mgr = CheckpointManager(str(tmp_path))
    w1 = tsgd.AsyncSGDWorker(conf(tcfg, **sgd), device="cpu")
    w1.train(head)
    w1.checkpoint(mgr, step=k)
    before = len(w1.progress.objective)
    w1.train(tail)
    want_obj = w1.progress.objective[before:]
    w2 = tsgd.AsyncSGDWorker(conf(tcfg, **sgd), device="cpu")
    assert w2.restore(mgr) == k
    w2.train(tail)
    assert_bits_equal(w2.state_host()["state"], w1.state_host()["state"])
    assert w2.state_host()["seed_counter"] == w1.state_host()["seed_counter"]
    assert w2.progress.objective == want_obj
    assert np.array_equal(w2.weights_dense(), w1.weights_dense())


def test_resume_without_the_seed_counter_differs(tmp_path, w_true):
    """The quantized push's noise follows the seed counter: a resume
    that drops it (forced to 0) leaves a different state."""
    sgd, k = CASES["dense_push1_tau4"]
    mgr = CheckpointManager(str(tmp_path))
    w1 = tsgd.AsyncSGDWorker(conf(tcfg, **sgd), device="cpu")
    w1.train(batches(k, w_true))
    w1.checkpoint(mgr, step=k)
    tail = batches(4, w_true, seed0=50)
    w1.train(tail)
    w2 = tsgd.AsyncSGDWorker(conf(tcfg, **sgd), device="cpu")
    w2.restore(mgr)
    w2._seed_counter = 0
    w2.train(tail)
    assert not np.array_equal(w2.weights_dense(), w1.weights_dense())


def test_restore_fits_the_padding_and_raises_without_a_checkpoint(tmp_path, w_true):
    """A checkpoint of a larger table restores into a smaller worker with
    its tail cut (dead padding); an empty directory raises."""
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tsgd.AsyncSGDWorker(conf(tcfg, num_slots=1024), device="cpu").restore(mgr)
    big = tsgd.AsyncSGDWorker(conf(tcfg, num_slots=2048), device="cpu")
    big.train(batches(2, w_true))
    big.checkpoint(mgr, step=2)
    small = tsgd.AsyncSGDWorker(conf(tcfg, num_slots=1024), device="cpu")
    assert small.restore(mgr, step=2) == 2
    for key, leaf in small.state.items():
        assert leaf.shape[0] == 1024
        assert torch.equal(leaf, big.state[key][:1024])


# -- across the packages --


XCASES = [("sparse", "float32"), ("sparse", "bfloat16"), ("dense", "float32"),
          ("dense", "bfloat16")]


@pytest.mark.parametrize("update,dtype", XCASES, ids=[f"{u}-{d}" for u, d in XCASES])
def test_jax_checkpoint_restores_into_the_port(tmp_path, mesh1, w_true, update, dtype):
    sgd = dict(num_slots=4096, update=update, ftrl_state_dtype=dtype)
    jw = jsgd.AsyncSGDWorker(conf(jcfg, **sgd), mesh=mesh1)
    jw.train(iter(batches(3, w_true, mod=jsparse)))
    jw.checkpoint(jreplica.CheckpointManager(str(tmp_path), use_orbax=False), step=3)
    tw = tsgd.AsyncSGDWorker(conf(tcfg, **sgd), device="cpu")
    assert tw.restore(CheckpointManager(str(tmp_path))) == 3
    snap = jw.state_host()
    assert tw.state["sqrt_n"].dtype == getattr(torch, dtype)
    assert_bits_equal(tw.state, snap["state"])
    assert tw._seed_counter == int(snap["seed_counter"]) == 3


@pytest.mark.parametrize("update,dtype", XCASES, ids=[f"{u}-{d}" for u, d in XCASES])
def test_port_checkpoint_restores_into_the_jax_worker(tmp_path, mesh1, w_true, update, dtype):
    sgd = dict(num_slots=4096, update=update, ftrl_state_dtype=dtype)
    tw = tsgd.AsyncSGDWorker(conf(tcfg, **sgd), device="cpu")
    tw.train(batches(3, w_true))
    tw.checkpoint(CheckpointManager(str(tmp_path)), step=3)
    jw = jsgd.AsyncSGDWorker(conf(jcfg, **sgd), mesh=mesh1)
    assert jw.restore(jreplica.CheckpointManager(str(tmp_path), use_orbax=False)) == 3
    want = {k: v.float() for k, v in tw.state.items()}  # bf16 comes back widened, exactly
    assert_bits_equal({k: np.asarray(v) for k, v in jw.state.items()}, want)
    assert int(jw.state_host()["seed_counter"]) == tw._seed_counter == 3


# -- checkpoint_async --


def test_checkpoint_async_snapshots_at_the_call(tmp_path):
    class Toy(Checkpointable):
        def __init__(self):
            self.w = np.arange(6.0)

        def state_host(self):
            return {"w": self.w}

        def load_state_host(self, snap):
            self.w = np.asarray(snap["w"])

    t = Toy()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    t.checkpoint_async(mgr, step=2)
    t.w += 50.0  # changed at once: the saved snapshot is owned
    mgr.wait()
    t2 = Toy()
    assert t2.restore(mgr) == 2
    np.testing.assert_array_equal(t2.w, np.arange(6.0))


def test_worker_checkpoint_async_holds_the_state_of_the_call(tmp_path, w_true):
    mgr = CheckpointManager(str(tmp_path))
    w = tsgd.AsyncSGDWorker(conf(tcfg, **CASES["ell_bits"][0]), device="cpu")
    w.train(batches(3, w_true))
    at_call = w.state_host()
    w.checkpoint_async(mgr, step=3)
    w.train(batches(3, w_true, seed0=20))  # updates the state in place meanwhile
    mgr.wait()
    fresh = tsgd.AsyncSGDWorker(conf(tcfg, **CASES["ell_bits"][0]), device="cpu")
    fresh.restore(mgr)
    assert_bits_equal(fresh.state, at_call["state"])


# -- the worker as a customer --


GROUPS = {
    "bits_T4": dict(num_slots=4096, ell_lanes=8, wire="bits", steps_per_launch=4),
    "sparse_T4": dict(num_slots=4096, update="sparse", steps_per_launch=4),
    "dense_exact": dict(num_slots=4096, update="dense", steps_per_launch=4),
}


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_submit_group_pairs_equal_the_jax_workers(mesh1, w_true, case):
    """Fresh workers, the same groups: the same (timestamp, ministeps)
    pairs; a group with a ragged row falls back to one step a minibatch
    on the bits wire."""
    jw = jsgd.AsyncSGDWorker(conf(jcfg, **GROUPS[case]), mesh=mesh1)
    tw = tsgd.AsyncSGDWorker(conf(tcfg, **GROUPS[case]), device="cpu")
    jb, tb = batches(8, w_true, mod=jsparse), batches(8, w_true)
    ragged = [jsparse.random_sparse(MB, KEYS, NNZ - 1, seed=90, w_true=w_true, binary=True),
              tsparse.random_sparse(MB, KEYS, NNZ - 1, seed=90, w_true=w_true, binary=True)]
    jpairs = jw.submit_group(jb[:4]) + jw.submit_group(jb[4:7] + [ragged[0]])
    tpairs = tw.submit_group(tb[:4]) + tw.submit_group(tb[4:7] + [ragged[1]])
    assert tpairs == jpairs
    assert sum(n for _, n in tpairs) == 8
    for (jts, _), (tts, _) in zip(jpairs, tpairs):
        jp, tp = jw.collect(jts), tw.collect(tts)
        assert tp.num_examples_processed == jp.num_examples_processed
        assert len(tp.auc) == len(jp.auc)  # one AUC a ministep


def test_process_minibatch_returns_a_timestamp(w_true):
    w = tsgd.AsyncSGDWorker(conf(tcfg, num_slots=4096), device="cpu")
    b = batches(2, w_true)
    ts = w.process_minibatch(b[0])
    assert isinstance(ts, int) and ts == 0
    prog = w.collect(ts)
    assert prog.num_examples_processed == MB and len(prog.auc) == 1
    m = w.wait(w.process_minibatch(b[1], report=False))
    assert float(m["num_ex"]) == MB
    assert w.progress.num_examples_processed == MB  # only collected steps count


def test_the_worker_is_an_app_customer_and_checkpointable(w_true):
    w = tsgd.AsyncSGDWorker(conf(tcfg, num_slots=4096, max_delay=3), device="cpu")
    assert all(isinstance(w, c) for c in (ISGDCompNode, App, Customer, Checkpointable))
    assert w.po.manager.get_customer(w.id) is w
    assert w.executor.max_in_flight == 4
    assert w.wait(w.submit(lambda: 41 + 1)) == 42  # Customer.submit
    w.collect(w.process_minibatch(batches(1, w_true)[0]))
    w.remove()
    assert w.po.manager.get_customer(w.id) is None
    thread = w.executor._thread
    assert w.executor._stopped and (thread is None or not thread.is_alive())


def test_worker_device_follows_the_started_postoffice(monkeypatch):
    """device=None: the started postoffice's device; with none started
    and no card, the worker raises (never the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsgd.AsyncSGDWorker(conf(tcfg, num_slots=1024))
    Postoffice.instance().start(device="cpu")
    assert tsgd.AsyncSGDWorker(conf(tcfg, num_slots=1024)).device.type == "cpu"


def test_unpack_u24_inverts_pack_u24():
    idx = np.random.default_rng(0).integers(0, 1 << 24, size=(4, 39)).astype(np.int32)
    packed = tsgd.pack_u24(idx)
    assert np.array_equal(packed, jsgd.pack_u24(idx))
    out = tsgd.unpack_u24(torch.from_numpy(packed))
    assert np.array_equal(out.numpy(), idx)
    assert np.array_equal(out.numpy(), np.asarray(jsgd.unpack_u24(packed)))


def test_progress_merge_matches_the_jax_rule():
    from parameter_server_tpu.learner.sgd import SGDProgress as JProgress

    mine, theirs = SGDProgress(nnz=5, weight_sum=1.5), JProgress(nnz=5, weight_sum=1.5)
    for rec in (dict(objective=[1.0], nnz=0, weight_sum=0.25, delta_sum=0.5),
                dict(objective=[2.0], nnz=7, delta_sum=0.125, num_examples_processed=3)):
        mine.merge(SGDProgress(**rec))
        theirs.merge(JProgress(**rec))
    assert vars(mine) == vars(theirs)
    assert (mine.nnz, mine.weight_sum, mine.delta_sum) == (7, 1.75, 0.625)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_host_is_a_snapshot_on_the_cpu(w_true, dtype):
    """``state_host`` copies: on the CPU a bf16 leaf was a numpy view of
    the live tensor, which the next steps (in place) changed."""
    w = tsgd.AsyncSGDWorker(conf(tcfg, num_slots=4096, update="sparse", ftrl_state_dtype=dtype),
                            device="cpu")
    w.train(batches(2, w_true))
    snap = w.state_host()
    frozen = {k: np.array(v, copy=True) for k, v in snap["state"].items()}
    w.train(batches(2, w_true, seed0=9))
    assert_bits_equal(snap["state"], frozen)
    assert not np.array_equal(bits(w.state)["sqrt_n"], bits(frozen)["sqrt_n"])
