"""PyTorch port: the remaining host modules and names, each held to its
JAX counterpart on the same inputs (CPU, numpy, no card).

- ``utils/bitmap.py``, ``utils/assign_op.py``, ``utils/ordered_match.py``
  (``tests/test_utils.py``): the same bits, values and match counts;
  the localizer's ``match_positions`` is the one of ``ordered_match``;
- ``utils/sketch.py::BloomFilter``: the same bit array after the same
  inserts, the same answers, no false negatives;
- ``utils/concurrent.py::ThreadPool`` (``tests/test_aux_units.py``);
- ``SparseBatch.pad_device`` / ``PaddedBatch``: bit-equal arrays;
- ``FrequencyFilter.resize`` / ``clear`` / ``empty``
  (``tests/test_filters.py``): the same kept keys;
- ``Executor.pop_result``, ``Van.send`` / ``recv`` (the filter chain's
  encode and decode alone), ``Workload.finished``,
  ``DataConfig.range_begin`` / ``range_end``, ``CompressedBatch.encoding``;
- ``utils/file.py``'s remote registry (``tests/test_remote_io.py``): a
  local adapter and ``HadoopCliFS`` over a fake ``hadoop`` script, gzip
  over a remote read, globs, the stream reader, an unregistered scheme;
- ``utils/subproc.py::run_graceful``: TERM within the grace, KILL after
  it, reaped on an interrupt (``tests/test_utils.py``); the probe
  child's source;
- ``utils/device_lock.py``: held, busy, blocking past the bound, the
  priority markers and the no-op under ``PS_DEVICE_LOCK_HELD``.

Tolerance: exact everywhere (the same host arithmetic on the same data).
"""

import fcntl
import gzip
import os
import pathlib
import stat
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from parameter_server_tpu import cpp as jcpp
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.filter import frequency as jfreq
from parameter_server_tpu.learner import wire as jwire
from parameter_server_tpu.learner import workload_pool as jpool
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.system import message as jmsg
from parameter_server_tpu.system import van as jvan
from parameter_server_tpu.utils import assign_op as jassign
from parameter_server_tpu.utils import bitmap as jbitmap
from parameter_server_tpu.utils import concurrent as jconc
from parameter_server_tpu.utils import ordered_match as jom
from parameter_server_tpu.utils import sketch as jsketch
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu.utils import subproc as jsubproc
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.data.stream_reader import StreamReader
from parameter_server_tpu_torch.filter import frequency as tfreq
from parameter_server_tpu_torch.learner import wire as twire
from parameter_server_tpu_torch.learner import workload_pool as tpool
from parameter_server_tpu_torch.system import message as tmsg
from parameter_server_tpu_torch.system import van as tvan
from parameter_server_tpu_torch.system.executor import Executor
from parameter_server_tpu_torch.utils import assign_op as tassign
from parameter_server_tpu_torch.utils import bitmap as tbitmap
from parameter_server_tpu_torch.utils import concurrent as tconc
from parameter_server_tpu_torch.utils import device_lock as dl
from parameter_server_tpu_torch.utils import file as psfile
from parameter_server_tpu_torch.utils import localizer as tloc
from parameter_server_tpu_torch.utils import ordered_match as tom
from parameter_server_tpu_torch.utils import sketch as tsketch
from parameter_server_tpu_torch.utils import sparse as tsparse
from parameter_server_tpu_torch.utils import subproc

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# -- bitmap, assign_op, ordered_match --


def test_bitmap_matches_the_jax_bitmap():
    seq = [("set", 3), ("clear", 0), ("fill", True), ("clear", 7), ("set", 7), ("clear", 2),
           ("resize", 12), ("set", 11), ("fill", False), ("set", 5)]
    maps = [jbitmap.Bitmap(10, True), tbitmap.Bitmap(10, True)]
    for op, arg in seq:
        for bm in maps:
            getattr(bm, op)(arg)
        a, b = maps
        assert a.nnz() == b.nnz() and a.size == b.size
        assert np.array_equal(a.array(), b.array())
        assert [a.test(i) for i in range(a.size)] == [b.test(i) for i in range(b.size)]


@pytest.mark.parametrize("op", list(jassign.AssignOp), ids=lambda o: o.name)
def test_assign_ops_match(rng, op):
    dst, src = rng.integers(0, 3, 16).astype(np.float32), rng.integers(1, 3, 16).astype(np.float32)
    want = jassign.apply_op(op, dst.copy(), src)
    got = tassign.apply_op(tassign.AssignOp[op.name], dst.copy(), src)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert tassign.AssignOp[op.name].value == op.value
    with pytest.raises(ValueError):
        tassign.apply_op("plus", dst, src)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("op", ["ASSIGN", "PLUS", "MINUS", "TIMES"])
def test_ordered_match_matches(rng, k, op):
    dst_k = np.unique(rng.integers(0, 200, 60))
    src_k = np.unique(rng.integers(0, 200, 40))
    src_v = rng.normal(size=len(src_k) * k).astype(np.float32)
    out = []
    for mod, amod in ((jom, jassign), (tom, tassign)):
        dv = np.ones(len(dst_k) * k, np.float32)
        n = mod.ordered_match(dst_k, dv, src_k, src_v, op=amod.AssignOp[op], k=k)
        out.append((n, dv))
    assert out[0][0] == out[1][0] > 0
    assert out[0][1].tobytes() == out[1][1].tobytes()
    assert tloc.match_positions is tom.match_positions
    for a, b in zip(jom.match_positions(dst_k, src_k), tom.match_positions(dst_k, src_k)):
        assert np.array_equal(a, b)
    for a, b in zip(jom.match_positions(dst_k[:0], src_k), tom.match_positions(dst_k[:0], src_k)):
        assert np.array_equal(a, b)


def test_ordered_match_examples():
    dst_k, src_k = np.array([1, 3, 5, 7]), np.array([3, 5, 9])
    dst_v = np.zeros(4, np.float32)
    src_v = np.array([30.0, 50.0, 90.0], np.float32)
    assert tom.ordered_match(dst_k, dst_v, src_k, src_v) == 2
    np.testing.assert_array_equal(dst_v, [0, 30, 50, 0])
    tom.ordered_match(dst_k, dst_v, src_k, src_v, op=tassign.AssignOp.PLUS)
    np.testing.assert_array_equal(dst_v, [0, 60, 100, 0])
    wide = np.zeros((2, 3), np.float32)
    tom.ordered_match(np.array([2, 4]), wide, np.array([4]), np.array([[1.0, 2.0, 3.0]]), k=3)
    np.testing.assert_array_equal(wide[1], [1, 2, 3])


# -- BloomFilter --


@pytest.mark.parametrize("num_bits,num_hash", [(1 << 16, 3), (1 << 18, 3), (1000, 2)])
def test_bloom_filter_sets_the_jax_bits(rng, num_bits, num_hash):
    keys = rng.integers(0, 1 << 60, size=1000).astype(np.uint64)
    other = rng.integers(1 << 61, 1 << 62, size=10000).astype(np.uint64)
    mine, theirs = tsketch.BloomFilter(num_bits, num_hash), jsketch.BloomFilter(num_bits, num_hash)
    mine.insert(keys)
    theirs.insert(keys)
    assert np.array_equal(mine.bits, theirs.bits)
    assert mine.query(keys).all()  # no false negatives
    assert np.array_equal(mine.query(other), theirs.query(other))
    if num_bits >= 1 << 18:
        assert mine.query(other).mean() < 0.01
    assert int(keys[0]) in mine and (int(other[0]) in mine) == (int(other[0]) in theirs)
    with pytest.raises(ValueError):
        tsketch.BloomFilter(0)


# -- ThreadPool --


@pytest.mark.parametrize("mod", [jconc, tconc], ids=["jax", "port"])
def test_thread_pool_runs_everything(mod):
    done, lock = [], threading.Lock()

    def work(i):
        def run():
            with lock:
                done.append(i)
        return run

    pool = mod.ThreadPool(4)
    for i in range(32):
        pool.add(work(i))
    pool.start_workers()
    assert sorted(done) == list(range(32))


def test_thread_pool_reraises_a_task_error():
    pool = tconc.ThreadPool(2)
    pool.add(lambda: None)
    pool.add(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        pool.start_workers()
    pool.start_workers()  # the queue was cleared


# -- PaddedBatch --


@pytest.mark.parametrize("binary,pad_col", [(False, None), (True, None), (False, 7)])
def test_pad_device_arrays_bit_equal(binary, pad_col):
    jb = jsparse.random_sparse(10, 20, 3, seed=2, binary=binary)
    tb = tsparse.random_sparse(10, 20, 3, seed=2, binary=binary)
    jp = jb.pad_device(nnz_pad=64, rows_pad=16, pad_col=pad_col)
    tp = tb.pad_device(nnz_pad=64, rows_pad=16, pad_col=pad_col)
    for f in ("y", "rows", "cols", "vals", "row_mask"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert (tp.rows_pad, tp.nnz_pad) == (jp.rows_pad, jp.nnz_pad) == (16, 64)
    w = np.random.default_rng(0).normal(size=tb.cols + 1).astype(np.float32)
    w[-1] = 123.0  # the sentinel's weight adds nothing (value 0)
    xw = np.zeros(16, np.float32)
    np.add.at(xw, tp.rows, tp.vals * w[tp.cols])
    np.testing.assert_allclose(xw[:10], tb.to_dense() @ w[:-1], rtol=1e-4)
    with pytest.raises(ValueError):
        tb.pad_device(nnz_pad=4)
    with pytest.raises(ValueError):
        tb.pad_device(nnz_pad=64, rows_pad=4)


# -- FrequencyFilter --


def test_frequency_filter_methods_match(rng):
    hot = rng.integers(0, 1 << 40, 100).astype(np.uint64)
    cold = rng.integers(1 << 41, 1 << 42, 100).astype(np.uint64)
    both = np.concatenate([hot, cold])
    fs = [jfreq.FrequencyFilter(1 << 16, 2), tfreq.FrequencyFilter(1 << 16, 2)]
    for f in fs:
        assert f.empty
        f.insert_keys(hot, 10)
        f.insert_keys(cold, 1)
        assert not f.empty
    kept = [f.query_keys(both, 5) for f in fs]
    assert np.array_equal(*kept) and set(hot.tolist()) <= set(kept[1].tolist())
    assert len(kept[1]) < 150
    for f in fs:
        f.clear()
        assert f.empty
        assert len(f.query_keys(both, 1)) == 0
        f.resize(1 << 10, 3)
        f.insert_keys(cold, 2)
    assert np.array_equal(fs[0].query_keys(both, 2), fs[1].query_keys(both, 2))
    assert np.array_equal(fs[1].query_keys(both, 0), both)


# -- the small names --


def test_executor_pop_result():
    ex = Executor("pop")
    try:
        ts = ex.submit(lambda: 7)
        assert ex.pop_result(ts) == 7
        assert ex.result(ts) is None  # taken out
    finally:
        ex.stop()


def _msg(m, values, specs):
    msg = m.Message(task=m.Task(key_channel=0))
    msg.key = np.arange(0, 64, 2, dtype=np.uint64)
    msg.values = [v.copy() for v in values]
    msg.task.filters = [m.FilterSpec(**s) for s in specs]
    return msg


def _jax_native_loaded(monkeypatch):
    """The JAX package's native library, loaded, so that its codec writes
    the native LZ frames the port's are held to (without it the JAX codec
    writes zlib frames). The JAX loader latches to None for the rest of
    the process when one build or load fails, as it does when several
    processes build the library into its one path at once: the latch is
    re-armed and the load retried, one process of this suite at a time,
    until the library loads or two minutes pass."""
    lock_path = ROOT / "build" / "jax_native.lock"
    lock_path.parent.mkdir(exist_ok=True)
    deadline = time.monotonic() + 120.0
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        while jcpp.native() is None and time.monotonic() < deadline:
            monkeypatch.setattr(jcpp, "_tried", False)
            time.sleep(0.5)  # another process may be writing the library
    if jcpp.native() is None:
        pytest.fail("the JAX package's native library did not build or load: its codec "
                    "would write zlib frames, not the native LZ frames compared here")


@pytest.mark.parametrize("specs", [
    [{"type": "sparse"}],
    [{"type": "compressing"}],
    [{"type": "sparse"}, {"type": "compressing"}],
], ids=["sparse", "compressing", "sparse+compressing"])
def test_van_send_recv_match_the_jax_van(rng, specs, monkeypatch):
    _jax_native_loaded(monkeypatch)
    values = [np.where(rng.random(32) < 0.5, 0.0, rng.normal(size=32)).astype(np.float32)]
    jv = jvan.Van(jmesh.make_mesh(num_data=1, num_server=1))
    tv = tvan.Van("cpu")
    jenc = jv.send(_msg(jmsg, values, specs))
    tenc = tv.send(_msg(tmsg, values, specs))
    # a native frame (LZ, or stored where LZ does not shrink), never zlib's
    assert not any(np.asarray(v).tobytes()[:1] == b"\x02" for v in jenc.values
                   if any(s["type"] == "compressing" for s in specs))
    assert [np.asarray(v).tobytes() for v in tenc.values] == \
        [np.asarray(v).tobytes() for v in jenc.values]
    tdec = tv.recv(tenc)
    jdec = jv.recv(jenc)
    assert [v.tobytes() for v in tdec.values] == [v.tobytes() for v in jdec.values]
    np.testing.assert_array_equal(tdec.values[0], values[0])
    # explicit filters win over the task's
    plain = tv.send(_msg(tmsg, values, []), filters=[tmsg.FilterSpec(type="sparse")])
    assert plain.values[0].size == np.count_nonzero(values[0])


def test_workload_and_data_config_fields_match():
    assert vars(jpool.Workload()) == vars(tpool.Workload())
    assert tpool.Workload(finished=[1, 2]).finished == [1, 2]
    j, t = jcfg.DataConfig(), tcfg.DataConfig()
    assert (t.range_begin, t.range_end) == (j.range_begin, j.range_end) == (0, 0)
    assert tcfg.DataConfig(range_begin=5, range_end=9).range_end == 9


def test_compressed_batch_carries_its_encoding():
    prepped = tsparse.random_sparse(8, 64, 3, seed=1)
    from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
    from parameter_server_tpu_torch.parameter.parameter import KeyDirectory

    batch = tsgd.prep_batch_hashed(prepped, KeyDirectory(256, hashed=True), 1, 8, 64, 256)
    assert twire.compress_batch(batch).encoding == ""
    cb = twire.compress_batch(batch, encoding="raw")
    assert cb.encoding == "raw"
    back = twire.decompress_batch(cb)
    for name in twire.array_fields(batch):
        assert getattr(back, name).tobytes() == getattr(batch, name).tobytes()
    assert "encoding" in jwire.CompressedBatch.__slots__
    assert tsgd._wire_encoding_name(batch) == "raw"


# -- remote filesystems --


class LocalFakeFS(psfile.RemoteFS):
    """mock:// over a local directory."""

    def __init__(self, root):
        self.root = str(root)

    def _local(self, path):
        return os.path.join(self.root, path.split("://", 1)[1])

    def open_read(self, path):
        return open(self._local(path), "rb")

    def open_write(self, path):
        local = self._local(path)
        os.makedirs(os.path.dirname(local), exist_ok=True)
        return open(local, "wb")

    def list(self, pattern):
        import glob

        return sorted("mock://" + os.path.relpath(h, self.root)
                      for h in glob.glob(self._local(pattern)))


@pytest.fixture
def mockfs(tmp_path):
    fs = LocalFakeFS(tmp_path / "remote")
    psfile.register_filesystem("mock", fs)
    yield fs
    psfile.register_filesystem("mock", None)


def test_unregistered_scheme_raises_as_the_jax_one():
    from parameter_server_tpu.utils import file as jfile

    for mod in (jfile, psfile):
        with pytest.raises(NotImplementedError, match="register"):
            mod.open_read("hdfs://nn/some/file.txt")
        with pytest.raises(NotImplementedError):
            mod.open_write("s3://bucket/key")
        assert mod.expand_globs(["hdfs://nn/part-*"]) == ["hdfs://nn/part-*"]
        assert mod.get_filesystem("hdfs") is None


def test_registered_fs_text_gzip_and_globs(mockfs, tmp_path):
    assert psfile.get_filesystem("mock://x") is mockfs
    with psfile.open_write("mock://a/b.txt") as f:
        f.write("hello\nworld\n")
    assert list(psfile.read_lines("mock://a/b.txt")) == ["hello", "world"]
    local = tmp_path / "remote" / "z.gz"
    with gzip.open(local, "wt") as f:
        f.write("1 1:0.5\n-1 2:1.5\n")
    assert list(psfile.read_lines("mock://z.gz")) == ["1 1:0.5", "-1 2:1.5"]
    root = tmp_path / "remote" / "train"
    os.makedirs(root)
    for i in range(3):
        (root / f"part-{i}").write_text("1 1:1\n")
    assert psfile.expand_globs(["mock://train/part-*"]) == [f"mock://train/part-{i}" for i in range(3)]


def test_stream_reader_over_a_remote_fs(mockfs, tmp_path):
    root = tmp_path / "remote" / "d"
    os.makedirs(root)
    (root / "p0").write_text("1 1:0.5\n-1 3:2\n")
    (root / "p1").write_text("1 2:1\n")
    batch = StreamReader(["mock://d/p*"], "libsvm").read_all()
    assert batch is not None and batch.n == 3 and batch.nnz == 3


FAKE_HADOOP = """#!/bin/sh
# a `hadoop fs` stand-in: hdfs://fake/<p> is $FAKE_HDFS_ROOT/<p>
shift
while [ "$1" = "-D" ]; do shift 2; done
op="$1"; shift
strip() { echo "$1" | sed 's|hdfs://fake/||'; }
case "$op" in
  -cat) cat "$FAKE_HDFS_ROOT/$(strip "$1")" ;;
  -put) dst="$FAKE_HDFS_ROOT/$(strip "$2")"
        mkdir -p "$(dirname "$dst")"; cat > "$dst" ;;
  -ls)  for f in "$FAKE_HDFS_ROOT"/$(strip "$1"); do
          [ -e "$f" ] || exit 1
          echo "-rw-r--r-- 1 u g 0 2026-01-01 00:00 hdfs://fake/$(basename "$f")"
        done ;;
  *) exit 2 ;;
esac
"""


@pytest.fixture
def hadoop_cli(tmp_path, monkeypatch):
    binary = tmp_path / "hadoop"
    binary.write_text(FAKE_HADOOP)
    binary.chmod(binary.stat().st_mode | stat.S_IEXEC)
    root = tmp_path / "hdfs_root"
    os.makedirs(root)
    monkeypatch.setenv("FAKE_HDFS_ROOT", str(root))
    psfile.register_filesystem("hdfs", psfile.HadoopCliFS(binary=str(binary), namenode="hdfs://fake",
                                                          ugi="u,g"))
    yield root
    psfile.register_filesystem("hdfs", None)


def test_hadoop_cli_roundtrip_ls_and_missing(hadoop_cli):
    fs = psfile.get_filesystem("hdfs")
    assert fs._cmd()[-4:] == ["-D", "fs.default.name=hdfs://fake", "-D", "hadoop.job.ugi=u,g"]
    with psfile.open_write("hdfs://fake/out/data.txt") as f:
        f.write("alpha\nbeta\n")
    assert (hadoop_cli / "out" / "data.txt").read_text() == "alpha\nbeta\n"
    assert list(psfile.read_lines("hdfs://fake/out/data.txt")) == ["alpha", "beta"]
    for i in range(2):
        (hadoop_cli / f"part-{i}").write_text("x\n")
    assert psfile.expand_globs(["hdfs://fake/part-*"]) == ["hdfs://fake/part-0", "hdfs://fake/part-1"]
    f = psfile.open_read("hdfs://fake/nope.txt")
    with pytest.raises(IOError):
        f.read()
        f.close()


def test_hadoop_cli_command_matches_the_jax_adapter(monkeypatch):
    from parameter_server_tpu.utils import file as jfile

    monkeypatch.setenv("HADOOP_HOME", "/hadoop-home")
    for kw in (dict(), dict(namenode="hdfs://nn:9000"), dict(home="/h", ugi="a,b"),
               dict(binary="/bin/hadoop")):
        assert psfile.HadoopCliFS(**kw)._cmd() == jfile.HadoopCliFS(**kw)._cmd()


# -- run_graceful --


def test_run_graceful_term_then_exit():
    child = ("import signal, sys, time\n"
             "signal.signal(signal.SIGTERM, lambda *a: sys.exit(143))\n"
             "time.sleep(60)\n")
    t0 = time.perf_counter()
    with pytest.raises(subprocess.TimeoutExpired):
        subproc.run_graceful([sys.executable, "-c", child], timeout_s=1.0)
    assert time.perf_counter() - t0 < 8.0
    rc, err, out = subproc.run_graceful([sys.executable, "-c", "print('x')"], timeout_s=30,
                                        capture_stdout=True)
    assert (rc, out.strip()) == (0, b"x")
    assert jsubproc.run_graceful([sys.executable, "-c", "print('x')"], timeout_s=30,
                                 capture_stdout=True)[::2] == (rc, out)


def test_run_graceful_kills_a_stubborn_child_after_the_grace(tmp_path):
    for timeout_s in (3.0, 8.0, 20.0):
        sentinel = tmp_path / f"ign_{timeout_s}"
        child = ("import pathlib, signal, time\n"
                 "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                 f"pathlib.Path({str(sentinel)!r}).write_text('x')\n"
                 "time.sleep(60)\n")
        t0 = time.perf_counter()
        with pytest.raises(subprocess.TimeoutExpired):
            subproc.run_graceful([sys.executable, "-c", child], timeout_s=timeout_s,
                                 term_grace_s=1.0)
        took = time.perf_counter() - t0
        if sentinel.exists():  # SIG_IGN was in place before the SIGTERM
            break
    assert sentinel.exists()
    assert timeout_s + 0.9 < took < timeout_s + 15.0


def test_run_graceful_reaps_on_an_interrupt(monkeypatch):
    spawned = []
    real_popen = subprocess.Popen

    class InterruptingPopen(real_popen):
        def communicate(self, *a, **kw):
            if not spawned:
                spawned.append(self.pid)
                raise KeyboardInterrupt
            return real_popen.communicate(self, *a, **kw)

    monkeypatch.setattr(subprocess, "Popen", InterruptingPopen)
    with pytest.raises(KeyboardInterrupt):
        subproc.run_graceful([sys.executable, "-c", "import time; time.sleep(60)"], timeout_s=5.0)
    for _ in range(50):
        try:
            os.kill(spawned[0], 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        raise AssertionError("child still alive after the interrupt")


def test_run_graceful_interrupt_in_the_grace_window_reaps(monkeypatch):
    events = []

    class FakePopen:
        returncode = None

        def __init__(self, argv, **kw):
            self._calls = 0

        def communicate(self, timeout=None):
            self._calls += 1
            if self._calls == 1:
                raise subprocess.TimeoutExpired("x", timeout)
            if self._calls == 2:
                raise KeyboardInterrupt
            events.append("reaped")
            return b"", b""

        def terminate(self):
            events.append("terminate")

        def kill(self):
            events.append("kill")

    monkeypatch.setattr(subproc.subprocess, "Popen", FakePopen)
    with pytest.raises(KeyboardInterrupt):
        subproc.run_graceful(["x"], timeout_s=0.1, term_grace_s=0.1)
    assert events == ["terminate", "kill", "reaped"]


def test_probe_child_initialises_torch_not_jax():
    src = subproc.PROBE_CHILD_SRC
    assert "jax" not in src and "torch.cuda.init()" in src and "device_count()" in src
    compile(src, "<probe>", "exec")
    # no card here: the child reports failure with 1, not a hang or a crash
    rc, err, _ = subproc.run_graceful([sys.executable, "-c", src], timeout_s=120,
                                      env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert rc == 1 and err


# -- device_lock --


@pytest.fixture
def lock_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PS_DEVICE_LOCK", str(tmp_path / "dev.lock"))
    monkeypatch.delenv("PS_DEVICE_LOCK_HELD", raising=False)
    return tmp_path / "dev.lock"


def test_device_lock_exclusive_then_busy(lock_env):
    env = {k: v for k, v in os.environ.items() if k != "PS_DEVICE_LOCK_HELD"}
    child = (
        "import os, sys; sys.path.insert(0, %r); os.environ['PS_DEVICE_LOCK'] = %r\n"
        "from parameter_server_tpu_torch.utils.device_lock import device_lock\n"
        "with device_lock(timeout_s=0.1, poll_s=0.05) as got: ok = got\n"
        "sys.exit(0 if (not ok and ok.reason == 'busy') else 3)"
    ) % (str(ROOT), str(lock_env))
    with dl.device_lock() as got:
        assert got and got.reason == "acquired"
        assert subprocess.run([sys.executable, "-c", child], timeout=60, env=env).returncode == 0
    with dl.device_lock(timeout_s=0) as again:  # free after release
        assert again


def test_device_lock_is_a_noop_under_held_env(lock_env, monkeypatch):
    monkeypatch.setenv("PS_DEVICE_LOCK_HELD", "1")
    with dl.device_lock(timeout_s=0) as a, dl.device_lock(timeout_s=0) as b:
        assert a and b and a.reason == "held-by-parent"
    assert not lock_env.exists()
    assert dl.held_env()["PS_DEVICE_LOCK_HELD"] == "1"


def test_device_lock_blocks_past_the_bound_until_released(lock_env):
    release = threading.Event()

    def holder():
        with dl.device_lock(timeout_s=0) as got:
            assert got
            release.wait(5)

    th = threading.Thread(target=holder)
    th.start()
    time.sleep(0.1)
    threading.Timer(0.4, release.set).start()
    with dl.device_lock(timeout_s=0.1, poll_s=0.02, block_after_timeout=True) as got:
        assert got and got.reason == "acquired"
    th.join()


def test_device_lock_priority_markers(lock_env, monkeypatch):
    assert dl.foreign_priority() is None
    dl.request_priority("chip")
    assert dl.foreign_priority() is None  # our own
    with open(dl._request_path(), "w") as f:
        f.write(f"{os.getpid() + 1} {time.time():.0f} chip\n")
    seen = dl.foreign_priority()
    assert seen and "chip" in seen
    assert dl.foreign_priority(ignore_pid=os.getpid() + 1) is None
    with open(dl._request_path(), "w") as f:
        f.write(f"{os.getpid() + 1} {time.time() - 1e6:.0f} chip\n")
    assert dl.foreign_priority() is None  # stale
    with open(dl._request_path(), "w") as f:
        f.write(f"{os.getpid() + 1} {time.time():.0f} chip\n")
    dl.clear_priority()
    assert dl.foreign_priority() is not None  # a foreign marker stays
    dl.request_priority("chip")
    dl.clear_priority()
    assert not os.path.exists(dl._request_path())
    monkeypatch.setenv("PS_DEVICE_LOCK_HELD", "1")
    dl.request_priority("child")
    assert not os.path.exists(dl._request_path())


def test_device_lock_default_path_is_in_the_temporary_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("PS_DEVICE_LOCK", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert dl._lock_path() == str(tmp_path / "ps_cuda_device.lock")
