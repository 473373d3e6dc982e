"""PyTorch port: the host side of the main path, against the JAX package.

- ``utils/concurrent.py``: ``OrderedStagePool``, ``ProducerConsumer`` and
  ``iter_on_thread``, the port's and the JAX package's, on the same
  seeded sources: the same order, errors at the same position, no live
  thread after ``close()`` (the cases of ``tests/test_ingest.py``).
- ``learner/ingest.py::IngestPipeline`` and ``MinibatchReader``: the
  lifecycle errors, and the pipelined stream equal to the serial one and
  to the JAX package's.
- The pipelined worker (``train(pipelined=True)``): feeder, ordered prep
  pool, ``DeviceUploader`` and executor; state bits and progress
  identical to the serial train for headline-shaped sparse T = 8, dense,
  and the CTR conf at τ 4 with the 1-byte push, and within ``TRAJ_TOL``
  of the JAX worker's ``train(pipelined=True)``.
- On the card: ``tests/test_torch_host_cuda.py``.

Tolerances: exact everywhere except against the JAX worker
(``TRAJ_TOL``, ``OBJ_RTOL``: XLA contracts the FTRL step into fused
multiply-adds, eager PyTorch does not; ``tests/test_torch_linear_step.py``).
"""

import dataclasses
import os
import random
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.learner import ingest as jingest
from parameter_server_tpu.learner import sgd as jlearner
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu.parameter import parameter as jparam
from parameter_server_tpu.system.postoffice import Postoffice
from parameter_server_tpu.utils import concurrent as jconc
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.apps.linear import main as tmain
from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, write_ctr_shards
from parameter_server_tpu_torch.data.stream_reader import StreamReader
from parameter_server_tpu_torch.filter.frequency import FrequencyFilter
from parameter_server_tpu_torch.learner import ingest as tingest
from parameter_server_tpu_torch.learner import sgd as tlearner
from parameter_server_tpu_torch.parameter.parameter import KeyDirectory
from parameter_server_tpu_torch.utils import concurrent as tconc
from parameter_server_tpu_torch.utils import sparse as tsparse
from parameter_server_tpu_torch.system.postoffice import Postoffice as TPostoffice

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "ingest_parity.libsvm")
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
OBJ_RTOL = 1e-5
IMPLS = {"port": tconc, "jax": jconc}


@pytest.fixture(autouse=True)
def _release_port_workers():
    """A port worker registers with the port's postoffice, whose manager
    keeps it (and its executor's thread) alive: reset that postoffice
    after each test, as the JAX tests reset theirs."""
    yield
    TPostoffice.reset()


@pytest.fixture(params=sorted(IMPLS))
def conc(request):
    return IMPLS[request.param]


def _settle_threads(before, timeout=5.0):
    t0 = time.time()
    while threading.active_count() > before and time.time() - t0 < timeout:
        time.sleep(0.02)
    return threading.active_count()


# -- the concurrency primitives --


def _jittered(x):
    time.sleep(0.001 * ((x * 7) % 5))
    return x * x


def test_ordered_pool_in_order_under_jitter(conc):
    assert list(conc.OrderedStagePool(_jittered, range(50), num_workers=4)) == [x * x for x in range(50)]


def test_ordered_pool_port_equals_jax_on_a_seeded_source():
    rng = np.random.default_rng(0)
    items = [rng.integers(0, 1000, 17) for _ in range(40)]

    def fn(a):
        time.sleep(0.0005 * (int(a[0]) % 3))
        return np.sort(a)

    t = list(tconc.OrderedStagePool(fn, items, num_workers=3, capacity=2))
    j = list(jconc.OrderedStagePool(fn, items, num_workers=3, capacity=2))
    assert len(t) == len(j) == 40
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_ordered_pool_fn_exception_at_its_position(conc):
    def boom(x):
        if x == 3:
            raise ValueError("item three")
        return x

    it = iter(conc.OrderedStagePool(boom, range(8), num_workers=3))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="item three"):
        next(it)


def test_ordered_pool_source_exception_after_its_items(conc):
    def poisoned():
        yield 1
        yield 2
        raise RuntimeError("source died")

    it = iter(conc.OrderedStagePool(lambda x: x, poisoned(), num_workers=2))
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="source died"):
        next(it)


def test_ordered_pool_early_exit_leaks_no_threads(conc):
    before = threading.active_count()
    it = iter(conc.OrderedStagePool(lambda x: x, range(1000), num_workers=3, capacity=2))
    assert next(it) == 0
    it.close()
    assert _settle_threads(before) <= before


def test_ordered_pool_close_is_idempotent_and_joins(conc):
    before = threading.active_count()
    pool = conc.OrderedStagePool(lambda x: x, range(100), num_workers=2)
    assert list(pool) == list(range(100))
    pool.close()
    pool.close()
    assert _settle_threads(before) <= before


def test_ordered_pool_close_wakes_a_consumer_on_another_thread(conc):
    def trickle():
        yield 0
        time.sleep(30)
        yield 1

    pool = conc.OrderedStagePool(lambda x: x, trickle(), num_workers=2)
    got, done = [], threading.Event()

    def consume():
        for x in pool:
            got.append(x)
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t0 = time.time()
    while not got and time.time() - t0 < 5:
        time.sleep(0.01)
    assert got == [0]
    pool.close()
    assert done.wait(5), "consumer stayed blocked after close()"
    t.join(5)
    assert not t.is_alive()


def test_ordered_pool_window_is_bounded(conc):
    started, lock, release = [], threading.Lock(), threading.Event()

    def slow(x):
        with lock:
            started.append(x)
        release.wait(5)
        return x

    it = iter(conc.OrderedStagePool(slow, range(100), num_workers=2, capacity=3))
    time.sleep(0.3)
    with lock:
        assert len(started) <= 3 + 2
    release.set()
    assert next(it) == 0
    it.close()


def test_ordered_pool_stress_more_workers_than_cores():
    """16 workers on a 2000-item stream with a short switch interval: the
    order holds and every item comes out once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = list(tconc.OrderedStagePool(lambda x: (x, x * 3), range(2000),
                                          num_workers=16, capacity=5))
    finally:
        sys.setswitchinterval(old)
    assert out == [(x, x * 3) for x in range(2000)]


def test_producer_consumer_exception_forwarded_and_kept(conc):
    state = {"n": 0}

    def produce():
        state["n"] += 1
        if state["n"] > 3:
            raise RuntimeError("producer died")
        return state["n"]

    pc = conc.ProducerConsumer(capacity=4)
    pc.start_producer(produce)
    assert [pc.pop(), pc.pop(), pc.pop()] == [1, 2, 3]
    for _ in range(2):
        with pytest.raises(RuntimeError, match="producer died"):
            pc.pop()


def test_producer_consumer_close_leaks_no_threads(conc):
    before = threading.active_count()
    pc = conc.ProducerConsumer(capacity=2)
    pc.start_producer(lambda: 7)
    assert pc.pop() == 7
    pc.close()
    assert _settle_threads(before) <= before


def test_producer_consumer_end_of_stream_stays_none(conc):
    it = iter([1, 2])
    pc = conc.ProducerConsumer(capacity=4)
    pc.start_producer(lambda: next(it, None))
    assert [pc.pop(), pc.pop(), pc.pop(), pc.pop()] == [1, 2, None, None]
    pc.close()


def test_iter_on_thread_order_and_error_position(conc):
    def src():
        yield from range(5)
        raise KeyError("gone")

    it = conc.iter_on_thread(src(), maxsize=2)
    assert [next(it) for _ in range(5)] == list(range(5))
    with pytest.raises(KeyError, match="gone"):
        next(it)


def test_iter_on_thread_early_close_joins(conc):
    before = threading.active_count()
    it = conc.iter_on_thread(iter(range(10_000)), maxsize=1)
    assert next(it) == 0
    it.close()
    assert _settle_threads(before) <= before


# -- the ingest pipeline and the reader --


def _fixture_batches(rows=64):
    return list(StreamReader([FIXTURE], "libsvm").minibatches(rows))


def _prep(b):
    return tsgd.prep_batch_hashed(b, KeyDirectory(4096), 2, 32, max(b.nnz, 1), 4096)


def _assert_prepped_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_pipeline_stream_equals_serial_and_jax(workers):
    """Prep on the pool (or, with 0 workers, on one prefetching thread):
    the serial stream, and the JAX pipeline's with the JAX prep."""
    src = _fixture_batches()
    assert len(src) == 6
    serial = [_prep(b) for b in src]
    with tingest.IngestPipeline(src, prep_fn=_prep, workers=workers, capacity=2) as pipe:
        piped = list(pipe)
    jdir = jparam.KeyDirectory(4096, hashed=True)
    jpipe = jingest.IngestPipeline(
        src, prep_fn=lambda b: jsgd.prep_batch_hashed(b, jdir, 2, 32, max(b.nnz, 1), 4096),
        workers=max(workers, 1), capacity=2).start()
    jpiped = list(jpipe)
    assert len(piped) == len(jpiped) == 6
    for s, p, j in zip(serial, piped, jpiped):
        _assert_prepped_equal(s, p)
        _assert_prepped_equal(p, j)


def test_pipeline_filter_runs_serially_in_order():
    """A stateful filter (each batch stamped with a running count) sees
    the batches one at a time, in stream order, as on the serial path."""
    seen = []

    def stamp(x):
        seen.append(x)
        return (x, len(seen))

    with tingest.IngestPipeline(range(40), filter_fn=stamp, prep_fn=lambda t: t[0] * 1000 + t[1],
                                workers=4, capacity=3) as pipe:
        out = list(pipe)
    assert out == [x * 1000 + x + 1 for x in range(40)]
    assert seen == list(range(40))


def test_pipeline_prep_exception_at_its_position_and_no_thread_left():
    before = threading.active_count()

    def prep(x):
        if x == 5:
            raise ValueError("bad batch 5")
        return x

    pipe = tingest.IngestPipeline(range(20), prep_fn=prep, workers=3).start()
    it = iter(pipe)
    assert [next(it) for _ in range(5)] == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="bad batch 5"):
        next(it)
    pipe.close()
    assert _settle_threads(before) <= before


def test_pipeline_lifecycle():
    pipe = tingest.IngestPipeline(range(3))
    with pytest.raises(RuntimeError, match="before start"):
        next(iter(pipe))
    assert not pipe.started
    assert pipe.start() is pipe.start()
    assert pipe.started and list(pipe) == [0, 1, 2]
    with pytest.raises(RuntimeError, match="after close"):
        pipe.start()


def _reader_batches(n=4):
    rng = np.random.default_rng(0)
    for _ in range(n):
        idx = np.sort(rng.choice(1 << 20, 32, replace=False))
        yield tsparse.SparseBatch(y=rng.choice((-1.0, 1.0), 8).astype(np.float32),
                                  indptr=np.arange(0, 33, 4, dtype=np.int64),
                                  indices=idx.astype(np.int64), values=np.ones(32, np.float32))


def test_reader_read_before_start_raises():
    reader = tlearner.MinibatchReader(batches=_reader_batches())
    with pytest.raises(RuntimeError, match="before start"):
        reader.read()
    with pytest.raises(RuntimeError, match="before start"):
        next(iter(reader))


def test_reader_start_is_idempotent_and_close_joins():
    before = threading.active_count()
    reader = tlearner.MinibatchReader(batches=_reader_batches(3))
    reader.start()
    pipe = reader._pipe
    reader.start()
    assert reader._pipe is pipe
    assert len(list(reader)) == 3
    reader.close()
    assert _settle_threads(before) <= before


def test_reader_close_guards():
    before = threading.active_count()
    reader = tlearner.MinibatchReader(batches=_reader_batches(100))
    reader.start()
    assert reader.read() is not None
    reader.close()
    assert _settle_threads(before) <= before
    with pytest.raises(RuntimeError, match="after close"):
        reader.read()
    with pytest.raises(RuntimeError, match="after close"):
        reader.start()


def test_reader_init_filter_after_start_raises():
    reader = tlearner.MinibatchReader(batches=_reader_batches(1))
    reader.start()
    with pytest.raises(RuntimeError, match="after start"):
        reader.init_filter(1 << 10, 2, 1)
    reader.close()


def test_reader_feeder_exception_reaches_read():
    def poisoned():
        yield from _reader_batches(2)
        raise OSError("disk gone")

    with tlearner.MinibatchReader(batches=poisoned()) as reader:
        assert reader.read() is not None and reader.read() is not None
        with pytest.raises(OSError, match="disk gone"):
            reader.read()


@pytest.mark.parametrize("freq", [0, 2])
def test_filtered_reader_equals_serial_filter_and_jax(freq):
    """The reader (native byte path, filter on the feeder) against the
    filter applied inline to the line path, and the JAX reader."""
    filt = FrequencyFilter(1 << 14, 2)
    serial = [tlearner.apply_tail_filter(b, filt, freq) if freq else b
              for b in StreamReader([FIXTURE], "libsvm").minibatches(64)]
    out = {}
    for name, mod in (("port", tlearner), ("jax", jlearner)):
        reader = mod.MinibatchReader(files=[FIXTURE], minibatch_size=64)
        if freq:
            reader.init_filter(1 << 14, 2, freq)
        with reader:
            out[name] = list(reader)
    assert len(out["port"]) == len(out["jax"]) == len(serial) == 6
    for s, p, j in zip(serial, out["port"], out["jax"]):
        for name in ("y", "indptr", "indices", "values"):
            np.testing.assert_array_equal(getattr(p, name), getattr(s, name))
            np.testing.assert_array_equal(getattr(p, name), getattr(j, name))


# -- the uploader on the CPU --


def test_device_uploader_order_error_and_close():
    before = threading.active_count()

    def src():
        for i in range(4):
            yield i, 1
        raise RuntimeError("prep died")

    up = tsgd.DeviceUploader(src(), lambda x: x * 10, depth=2)
    it = iter(up)
    assert [next(it) for _ in range(4)] == [(0, 1), (10, 1), (20, 1), (30, 1)]
    with pytest.raises(RuntimeError, match="prep died"):
        next(it)
    up.close()
    assert _settle_threads(before) <= before


# -- the pipelined worker --


MB, KEYS, NNZ, SLOTS = 256, 1 << 14, 39, 1 << 12


def make_batch(seed, n=MB, nnz=NNZ, mod=tsparse):
    b = mod.random_sparse(n, KEYS, nnz, seed=seed, binary=True)
    b.y = np.where((b.indices.reshape(n, -1) % 1024 < 256).mean(1) > 0.24, 1.0, -1.0).astype(np.float32)
    return b


def _conf(mod, update, steps, **sgd):
    c = mod.Config()
    c.penalty = mod.PenaltyConfig(type="l1", lambda_=[1.0])
    c.learning_rate = mod.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = mod.SGDConfig(**dict(dict(algo="ftrl", minibatch=MB, num_slots=SLOTS, max_delay=0,
                                            update=update, steps_per_launch=steps), **sgd))
    return c


def _assert_same_bits(a, b):
    for k in a.state:
        x, y = a.state[k], b.state[k]
        assert torch.equal(x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32),
                           y.view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32)), k
    pa, pb = a.progress, b.progress
    assert pa.objective == pb.objective and pa.accuracy == pb.accuracy and pa.auc == pb.auc
    assert pa.num_examples_processed == pb.num_examples_processed
    assert a._seed_counter == b._seed_counter


# headline-shaped sparse T = 8 (three launches, the last short), dense
# T = 1 with padding that grows on later, wider batches, bf16 √n sparse,
# and τ 4 sparse T = 2
PIPE_CASES = {
    "sparse-T8": (dict(update="sparse", steps=8), [make_batch(i) for i in range(20)]),
    "dense": (dict(update="dense", steps=1),
              [make_batch(i, nnz=20 + 4 * i) for i in range(8)]),
    "sparse-bf16-T4": (dict(update="sparse", steps=4, ftrl_state_dtype="bfloat16"),
                       [make_batch(i) for i in range(9)]),
    "sparse-tau4-T2": (dict(update="sparse", steps=2, max_delay=4), [make_batch(i) for i in range(10)]),
}


@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_pipelined_train_is_bit_identical_to_serial(case):
    kw, batches = PIPE_CASES[case]
    kw = dict(kw)
    update, steps = kw.pop("update"), kw.pop("steps")
    serial = tsgd.AsyncSGDWorker(_conf(tcfg, update, steps, **kw), device="cpu")
    piped = tsgd.AsyncSGDWorker(_conf(tcfg, update, steps, **kw), device="cpu")
    serial.train(iter(batches), pipelined=False)
    piped.train(iter(batches), pipelined=True)
    assert piped.progress.num_examples_processed == len(batches) * MB
    _assert_same_bits(serial, piped)
    assert serial._pads == piped._pads


def test_pipelined_train_any_worker_count_and_default():
    batches = [make_batch(i) for i in range(12)]
    ref = tsgd.AsyncSGDWorker(_conf(tcfg, "sparse", 4), device="cpu")
    ref.train(iter(batches), pipelined=False)
    for workers in (1, 3, 6):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, "sparse", 4, ingest_workers=workers), device="cpu")
        assert w.ingest_workers() == workers
        w.train(iter(batches))  # T > 1: pipelined by default
        _assert_same_bits(ref, w)
    w = tsgd.AsyncSGDWorker(_conf(tcfg, "sparse", 4), device="cpu")
    assert w.ingest_workers() == max(1, min(4, (os.cpu_count() or 2) - 1))


def test_pipelined_train_forwards_a_source_error_and_leaves_no_thread():
    w = tsgd.AsyncSGDWorker(_conf(tcfg, "sparse", 2), device="cpu")
    w.train(iter([make_batch(0), make_batch(1)]), pipelined=True)  # the executor's thread
    before = threading.active_count()

    def poisoned():
        yield from (make_batch(i) for i in range(5))
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        w.train(poisoned(), pipelined=True)
    assert _settle_threads(before) <= before
    assert w.executor.tracker.in_flight() == 0 and not w.executor.pending_count()
    # the launches before the error ran: [0, 1] of the first pass, then
    # [0, 1] and [2, 3] (batch 4 was still being grouped)
    assert w._seed_counter == 6


def test_a_prep_error_reaches_train_at_its_batch():
    batches = [make_batch(i) for i in range(6)]
    w = tsgd.AsyncSGDWorker(_conf(tcfg, "sparse", 2, rows_pad=MB, nnz_pad=MB * NNZ), device="cpu")
    batches[4] = make_batch(4, nnz=NNZ + 1)  # outgrows the fixed padding
    with pytest.raises(ValueError, match="exceeds padding"):
        w.train(iter(batches), pipelined=True)
    assert w._seed_counter == 4  # the groups before the failing one ran


@pytest.fixture
def mesh():
    Postoffice.reset()
    yield meshlib.make_mesh(num_data=1, num_server=1, devices=jax.devices()[:1])
    Postoffice.reset()


@pytest.mark.parametrize("update,steps", [("sparse", 4), ("dense", 1)])
def test_pipelined_train_matches_the_jax_pipelined_train(mesh, update, steps):
    batches = [make_batch(i) for i in range(8)]
    jw = jsgd.AsyncSGDWorker(_conf(jcfg, update, steps), mesh=mesh)
    tw = tsgd.AsyncSGDWorker(_conf(tcfg, update, steps), device="cpu")
    jp = jw.train(iter([make_batch(i, mod=jsparse) for i in range(8)]), pipelined=True)
    tp = tw.train(iter(batches), pipelined=True)
    assert tp.num_examples_processed == jp.num_examples_processed == 8 * MB
    np.testing.assert_allclose(tp.objective, jp.objective, rtol=OBJ_RTOL)
    np.testing.assert_array_equal(tp.accuracy, jp.accuracy)
    np.testing.assert_allclose(tp.auc, jp.auc, atol=1e-4)
    js, ts = jw.state_host()["state"], tw.state_host()["state"]
    for k in js:
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), **TRAJ_TOL, err_msg=k)


def _ctr_stream(tmp_path, rows=12_000):
    write_ctr_shards(str(tmp_path / "ctr"), 1, rows, seed=3, key_bits=14)
    text = ctr_conf(str(tmp_path / "ctr" / "part.*"), str(tmp_path / "model"), minibatch=1000,
                    num_slots=4096, countmin_n=1 << 16, num_data_pass=1)
    conf = tcfg.parse_conf(text)
    s = conf.async_sgd
    reader = tlearner.MinibatchReader(files=conf.training_data.file, minibatch_size=s.minibatch,
                                      data_format=conf.training_data.text)
    reader.init_filter(s.countmin_n, s.countmin_k, s.tail_feature_freq)
    with reader:
        return list(reader), text


def test_ctr_conf_pipelined_is_bit_identical_to_serial(tmp_path):
    """The CTR conf (1-byte FIXING_FLOAT push, τ 4, dense update, the
    tail filter's growing padding) through both train paths."""
    batches, text = _ctr_stream(tmp_path)
    assert len(batches) == 12 and batches[-1].nnz > batches[0].nnz
    workers = [tsgd.AsyncSGDWorker(tcfg.parse_conf(text), device="cpu") for _ in range(2)]
    assert workers[0].sgd.max_delay == 4 and workers[0]._wire["push_quant"] == 1
    workers[0].train(iter(batches), pipelined=False)
    workers[1].train(iter(batches), pipelined=True)
    _assert_same_bits(*workers)


def test_ctr_cli_objectives_equal_a_serial_read(tmp_path):
    """The CLI reads on the reader's feeder thread; its ministep
    objectives equal those of the same worker fed by a serial read
    (line parse, the tail filter inline, one minibatch at a time)."""
    write_ctr_shards(str(tmp_path / "ctr"), 2, 4000, seed=5, key_bits=14)
    text = ctr_conf(str(tmp_path / "ctr" / "part.*"), str(tmp_path / "model"), minibatch=1000,
                    num_slots=4096, countmin_n=1 << 16, num_data_pass=2)
    conf_path = tmp_path / "ctr.conf"
    conf_path.write_text(text)
    made = []
    init = tsgd.AsyncSGDWorker.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    tsgd.AsyncSGDWorker.__init__ = spy
    try:
        random.seed(11)
        assert tmain.main([str(conf_path)], device="cpu") == 0
    finally:
        tsgd.AsyncSGDWorker.__init__ = init
    (cli,) = made
    conf = tcfg.parse_conf(text)
    s = conf.async_sgd
    ref = tsgd.AsyncSGDWorker(conf, device="cpu")
    random.seed(11)
    from parameter_server_tpu_torch.learner.workload_pool import Workload, WorkloadPool

    pool = WorkloadPool(Workload(files=list(conf.training_data.file), replica=s.num_data_pass,
                                 shuffle=True))
    while (load := pool.assign()) is not None:
        filt = FrequencyFilter(s.countmin_n, s.countmin_k)
        for b in StreamReader(load.files, "ps_sparse_binary").minibatches(s.minibatch):
            ref.collect(ref.process_minibatch(tlearner.apply_tail_filter(b, filt, s.tail_feature_freq)))
    assert len(ref.progress.objective) == 16
    assert cli.progress.objective == ref.progress.objective
    _assert_same_bits(cli, ref)
