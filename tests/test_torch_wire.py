"""PyTorch port: the encoded wires against the JAX package.

- the decode ops (``ops/wire_codec.py``) against the JAX package's on
  the same encoded arrays, bit for bit, including bit widths whose
  values straddle two words and lengths that are no multiple of the
  stream's period;
- ``learner/wire.encode_exact``: the same bytes as the JAX encoder for
  binary, valued, ragged and regression batches in every mode; decoded
  on the CPU it equals the raw PreppedBatch, dtype for dtype;
- training on the encoded exact wire: the port's state bit-identical to
  its raw wire, serial and pipelined with the upload cache, and within
  ``TRAJ_TOL`` of the JAX worker on the encoded wire;
- ``UploadCache``: hits, misses, saved bytes, eviction, a signature
  collision, the single owner;
- the stream wire: the statics and the encoded bytes equal the JAX
  package's (native and plain numpy encode); decoded slots equal the
  hashed ones; the port's stream and bits steps leave state bit-identical
  to its hashed per-entry step, and within ``TRAJ_TOL`` of the JAX
  worker's bits, stream, u24 and i32 steps on the same batches;
- the staging leg's LZ frames round-trip (``tests/test_torch_codec.py``
  holds the frames to the JAX package's).

``TRAJ_TOL``: XLA contracts the FTRL step into fused multiply-adds and
sums the ELL lanes in another order; eager PyTorch does neither.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.linear import async_sgd as jsgd
from parameter_server_tpu.apps.linear import config as jcfg
from parameter_server_tpu.learner import wire as jwire
from parameter_server_tpu.ops import wire_codec as jwc
from parameter_server_tpu.parallel import mesh as meshlib
from parameter_server_tpu.parameter.parameter import KeyDirectory as JKeyDirectory
from parameter_server_tpu.system.postoffice import Postoffice
from parameter_server_tpu.utils import bitpack as jbitpack
from parameter_server_tpu.utils import sparse as jsparse
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.learner import wire as twire
from parameter_server_tpu_torch.ops import wire_codec as twc
from parameter_server_tpu_torch.parameter.parameter import KeyDirectory
from parameter_server_tpu_torch.utils import bitpack as tbitpack
from parameter_server_tpu_torch.utils import sparse as tsparse

torch.set_num_threads(1)

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
PREPPED = [f.name for f in dataclasses.fields(tsgd.PreppedBatch)]


@pytest.fixture
def mesh():
    Postoffice.reset()
    yield meshlib.make_mesh(num_data=1, num_server=1, devices=jax.devices()[:1])
    Postoffice.reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(tsgd._wire_view(np.asarray(a))))


def _eq(got: torch.Tensor, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=name)


# -- the decode ops --


@pytest.mark.parametrize("bits", [1, 3, 7, 13, 22, 23, 26, 31])
@pytest.mark.parametrize("n", [1, 33, 1000, 4096 + 7])
def test_decode_bitstream_matches_jax(bits, n):
    rng = np.random.default_rng(bits * 1000 + n)
    vals = rng.integers(0, 1 << bits, n).astype(np.int32)
    words = tbitpack.stream_to_words(tbitpack.pack_bits(vals, bits), n, bits)
    np.testing.assert_array_equal(words, jbitpack.stream_to_words(jbitpack.pack_bits(vals, bits), n, bits))
    got = twc.decode_bitstream(_t(words), n, bits)
    _eq(got, jwc.decode_bitstream(jnp.asarray(words), n, bits), "bits")
    np.testing.assert_array_equal(got.numpy(), vals)


def test_decode_small_ops_match_jax():
    rng = np.random.default_rng(0)
    b = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    _eq(twc.decode_u24(_t(b)), jwc.decode_u24(jnp.asarray(b)), "u24")
    y = rng.choice((-1.0, 1.0), 77)
    yb = np.packbits(y > 0, bitorder="little")
    for count in (0, 40, 77):
        _eq(twc.decode_sign_labels(_t(yb), torch.tensor(count), 80),
            jwc.decode_sign_labels(jnp.asarray(yb), count, 80), "labels")
        _eq(twc.decode_mask(torch.tensor(count), 80), jwc.decode_mask(count, 80), "mask")
        _eq(twc.decode_binary_vals(torch.tensor(count), 96), jwc.decode_binary_vals(count, 96))
    for rc, nnz_pad in (([3, 0, 2, 0, 0, 5, 1], 16), ([0, 0, 4], 4), ([2, 2], 8), ([0, 0], 4)):
        for dt in (np.uint8, np.uint16):
            arr = np.asarray(rc, dt)
            nnz = int(arr.sum())
            _eq(twc.decode_row_ids(_t(arr), torch.tensor(nnz), nnz_pad),
                jwc.decode_row_ids(jnp.asarray(arr), nnz, nnz_pad), f"rows {rc}")
    deltas = np.asarray([5, 1, 7, 65535, 2, 0, 0, 0], np.uint16)
    _eq(twc.decode_sorted_deltas(_t(deltas), torch.tensor(5), 1 << 20),
        jwc.decode_sorted_deltas(jnp.asarray(deltas), 5, 1 << 20), "deltas")
    for nb, dt in ((1, np.uint8), (2, np.uint16)):
        q = rng.integers(0, 1 << (8 * nb), 500).astype(dt)
        lo, hi = np.float32(-0.37), np.float32(1.9)
        _eq(twc.decode_fixed_point(_t(q), torch.tensor(lo), torch.tensor(hi), nb),
            jwc.decode_fixed_point(jnp.asarray(q), lo, hi, nb), f"fixed {nb}")
    v = rng.normal(size=300).astype(np.float32)
    bf = twire._bf16_bits(v)
    import ml_dtypes

    np.testing.assert_array_equal(bf, v.astype(ml_dtypes.bfloat16).view(np.uint16))
    _eq(twc.decode_bf16(_t(bf)), jwc.decode_bf16(jnp.asarray(v.astype(ml_dtypes.bfloat16))), "bf16")


def test_unpack_sign_bits_matches_jax():
    rng = np.random.default_rng(2)
    yb = rng.integers(0, 256, 13).astype(np.uint8)
    _eq(tbitpack.unpack_sign_bits(_t(yb), 100), jbitpack.unpack_sign_bits(jnp.asarray(yb), 100))


# -- the compact exact wire --


def synth_batch(mod, n=64, lanes=8, seed=0, binary=True, ragged=False, regression=False):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 2 * lanes, n) if ragged else np.full(n, lanes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    keys = rng.integers(0, 1 << 31, int(indptr[-1])).astype(np.int64)
    y = (rng.normal(size=n) if regression else rng.choice((-1.0, 1.0), n)).astype(np.float32)
    vals = None if binary else (rng.random(keys.size) + 0.5).astype(np.float32)
    return mod.SparseBatch(y=y, indptr=indptr, indices=keys, values=vals)


def _prep_both(kw, slots=1 << 12):
    jb, tb = synth_batch(jsparse, **kw), synth_batch(tsparse, **kw)
    nnz_pad = max(64, -(-int(tb.nnz * 1.25) // 64) * 64)
    uniq = -(-min(nnz_pad, slots) // 1024) * 1024
    jp = jsgd.prep_batch_shared(jb, JKeyDirectory(slots, hashed=True), 1, jb.n, nnz_pad, uniq, slots)
    tp = tsgd.prep_batch_shared(tb, KeyDirectory(slots), 1, tb.n, nnz_pad, uniq, slots)
    return jp, tp


BATCHES = {
    "binary": dict(),
    "valued": dict(binary=False, seed=1),
    "ragged": dict(ragged=True, seed=2),
    "regression": dict(binary=False, regression=True, seed=3),
}


@pytest.mark.parametrize("mode", ["exact", "int8", "u16", "bf16"])
@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_encode_exact_bytes_match_jax(kind, mode):
    jp, tp = _prep_both(BATCHES[kind])
    for f in PREPPED:
        np.testing.assert_array_equal(getattr(tp, f), np.asarray(getattr(jp, f)), err_msg=f)
    je = jwire.encode_exact(jp, 1 << 12, mode=mode)
    te = twire.encode_exact(tp, 1 << 12, mode=mode)
    assert te is not None and je is not None
    assert te.static_key() == je.static_key()
    for f in dataclasses.fields(te):
        a, b = getattr(te, f.name), getattr(je, f.name)
        if f.metadata.get("static"):
            assert a == b, f.name
        elif a is None or b is None:
            assert a is None and b is None, f.name
        else:
            b = np.asarray(b)
            assert a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
    # decoded on the CPU: the raw wire, dtype for dtype, where lossless
    if te.vals_mode in ("binary", "f32"):
        for name, got in zip(PREPPED, twire.decode_exact_host(te, 1 << 12)):
            want = getattr(tp, name)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    else:  # the narrowed values: JAX's decode, bit for bit
        got = twire.decode_exact_host(te, 1 << 12)
        want = jwire.decode_exact_host(je, 1 << 12)
        for name, g, w in zip(PREPPED, got, want):
            np.testing.assert_array_equal(g.view(np.uint8), np.asarray(w).view(np.uint8), err_msg=name)


def test_encode_exact_refuses_outside_its_domain():
    _, tp = _prep_both(dict())
    bad = dataclasses.replace(tp, mask=tp.mask.copy())
    bad.mask[0, 3] = 0.0  # a hole in the row mask: not a live-row count
    assert twire.encode_exact(bad, 1 << 12) is None
    with pytest.raises(ValueError, match="wire_encode"):
        twire.encode_exact(tp, 1 << 12, mode="zstd")
    assert twire.encode_exact(object(), 1 << 12) is None


def test_encoded_superbatch_stack():
    parts = [twire.encode_exact(_prep_both(dict(seed=s))[1], 1 << 12) for s in range(3)]
    sb = twire.stack_encoded_batches(parts)
    assert sb.steps == 3 and sb.ucols_words.shape[0] == 3 and sb.vals is None
    other = twire.encode_exact(_prep_both(dict(binary=False))[1], 1 << 12)
    with pytest.raises(ValueError, match="uniform static"):
        twire.stack_encoded_batches([parts[0], other])


HEAD = dict(minibatch=256, num_slots=1 << 12)


def _conf(mod, **sgd):
    c = mod.Config()
    c.penalty = mod.PenaltyConfig(type="l1", lambda_=[1.0])
    c.learning_rate = mod.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = mod.SGDConfig(**dict(dict(algo="ftrl", max_delay=0, **HEAD), **sgd))
    return c


def _headline(mod, seed, n=256, nnz=39):
    b = mod.random_sparse(n, 1 << 14, nnz, seed=seed, binary=True)
    b.y = np.where((b.indices.reshape(n, -1) % 1024 < 256).mean(1) > 0.24, 1.0, -1.0).astype(np.float32)
    return b


def _bits(w):
    return {k: v.view(torch.int16 if v.dtype == torch.bfloat16 else torch.int32).clone()
            for k, v in w.state.items()}


def _assert_same_bits(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("steps,dtype", [(1, "float32"), (4, "float32"), (4, "bfloat16")])
def test_encoded_training_bit_identical_to_raw(steps, dtype):
    batches = [_headline(tsparse, i) for i in range(8)]
    runs = {}
    for enc in ("", "exact"):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, update="sparse", steps_per_launch=steps, wire_encode=enc,
                                      ftrl_state_dtype=dtype), device="cpu")
        w.train(iter(batches), pipelined=False)
        runs[enc] = (_bits(w), list(w.progress.objective))
    _assert_same_bits(runs[""][0], runs["exact"][0])
    assert runs[""][1] == runs["exact"][1]


def test_encoded_pipelined_cache_and_lz_bit_identical():
    batches = [_headline(tsparse, i) for i in range(8)] * 2  # the second pass repeats
    ref = tsgd.AsyncSGDWorker(_conf(tcfg, update="sparse", steps_per_launch=4), device="cpu")
    ref.train(iter(batches), pipelined=False)
    for kw in (dict(wire_cache_mb=64), dict(wire_cache_mb=64, wire_compress="lz")):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, update="sparse", steps_per_launch=4, wire_encode="exact",
                                      **kw), device="cpu")
        w.train(iter(batches), pipelined=True)
        _assert_same_bits(_bits(ref), _bits(w))
        assert ref.progress.objective == w.progress.objective
        c = w.upload_cache
        assert c.hits > 0 and c.misses > 0 and c.saved_bytes > 0


def test_encoded_training_matches_jax(mesh):
    jw = jsgd.AsyncSGDWorker(_conf(jcfg, update="sparse", steps_per_launch=4, wire_encode="exact"),
                             mesh=mesh)
    tw = tsgd.AsyncSGDWorker(_conf(tcfg, update="sparse", steps_per_launch=4, wire_encode="exact"),
                             device="cpu")
    jp = jw.train(iter([_headline(jsparse, i) for i in range(8)]), pipelined=False)
    jw.executor.stop()
    tp = tw.train(iter([_headline(tsparse, i) for i in range(8)]), pipelined=False)
    np.testing.assert_allclose(tp.objective, jp.objective, rtol=1e-5)
    js, ts = jw.state_host()["state"], tw.state_host()["state"]
    for k in js:
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), **TRAJ_TOL, err_msg=k)


def test_encoded_kkt_feedback_matches_raw():
    runs = []
    for enc in ("", "exact"):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, update="sparse", wire_encode=enc, kkt_filter=True,
                                      kkt_drop_after=2, ingest_workers=1), device="cpu")
        w.train(iter([_headline(tsparse, i) for i in range(6)]))
        runs.append((_bits(w), w._consistency.tracker.summary()))
    _assert_same_bits(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] and runs[0][1]["suppressed"] > 0


# -- the upload cache --


def _cache(max_bytes=1 << 20, min_leaf_bytes=4096):
    return twire.UploadCache(lambda b: twire.as_tensors(b), max_bytes=max_bytes,
                             min_leaf_bytes=min_leaf_bytes)


@dataclasses.dataclass
class _Leaves:
    a: np.ndarray
    b: np.ndarray
    small: np.ndarray


def test_upload_cache_hits_misses_and_saved_bytes():
    c = _cache()
    x = _Leaves(np.arange(2048, dtype=np.int32), np.ones(2048, np.float32), np.zeros(4, np.int32))
    first = c(x)
    assert (c.hits, c.misses) == (0, 2)
    second = c(_Leaves(x.a.copy(), x.b + 1, x.small))
    assert (c.hits, c.misses) == (1, 3) and c.saved_bytes == x.a.nbytes
    assert second.a is first.a  # the device tensor is reused
    torch.testing.assert_close(second.b, torch.from_numpy(x.b + 1))
    assert c.hit_share == 0.25


def test_upload_cache_collision_never_serves_wrong_bytes(monkeypatch):
    c = _cache()
    monkeypatch.setattr(twire.UploadCache, "_sig", staticmethod(lambda arr: ("same", arr.shape, arr.dtype.str)))
    a = np.arange(2048, dtype=np.int32)
    c(_Leaves(a, a, a[:4]))
    got = c(_Leaves(a + 1, a + 1, a[:4]))
    np.testing.assert_array_equal(got.a.numpy(), a + 1)
    assert c._bytes == (a + 1).nbytes  # the displaced entry's bytes released


def test_upload_cache_evicts_to_its_bound_and_has_one_owner():
    c = _cache(max_bytes=3 * 8192)
    for i in range(6):
        c(_Leaves(np.full(2048, i, np.int32), np.full(2048, -i, np.int32), np.zeros(1)))
    assert c._bytes <= 3 * 8192 and len(c._cache) == 3
    err = []
    t = threading.Thread(target=lambda: err.append(pytest.raises(RuntimeError, c, _Leaves(
        np.zeros(2048, np.int32), np.zeros(2048, np.int32), np.zeros(1)))))
    t.start()
    t.join()
    assert err and "single-owner" in str(err[0].value)


def test_upload_cache_signature_matches_jax():
    from parameter_server_tpu.utils import crc32c as jcrc
    from parameter_server_tpu_torch.utils import crc32c as tcrc

    rng = np.random.default_rng(5)
    for arr in (rng.integers(0, 1 << 30, 5000).astype(np.int32),
                rng.integers(0, 255, (3, 2, 900)).astype(np.uint8),
                rng.normal(size=(8, 1, 700)).astype(np.float32)):
        for max_len in (16, 2048, 1 << 20):
            assert tcrc.array_signature(arr, max_len) == jcrc.array_signature(arr, max_len)


# -- the stream wire --


def _criteo_like(mod, n_batches, rows=256, lanes=8, vocab_small=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        small = rng.integers(0, vocab_small, (rows, lanes // 2))
        wide = rng.integers(0, 1 << 40, (rows, lanes - lanes // 2))
        keys = np.concatenate([small + (np.arange(lanes // 2) << 50), wide], axis=1).astype(np.int64)
        y = rng.choice((-1.0, 1.0), rows).astype(np.float32)
        out.append(mod.SparseBatch(y=y, indptr=np.arange(0, rows * lanes + 1, lanes),
                                   indices=keys.ravel()))
    return out


SSLOTS = 1 << 18


@pytest.mark.parametrize("rows", [4, 256, 1024])
def test_stream_statics_match_jax(rows):
    b = _criteo_like(tsparse, 1, rows=rows)[0]
    t = twire.derive_stream_statics(b.indices, 8, SSLOTS, SSLOTS)
    j = jwire.derive_stream_statics(b.indices, 8, SSLOTS, SSLOTS)
    assert (t is None) == (j is None) and (t is None) == (rows == 4)
    if t is not None:
        assert dataclasses.asdict(t) == dataclasses.asdict(j) and t.dict_lanes == (0, 1, 2, 3)
    wide = np.random.default_rng(1).integers(0, 1 << 40, 256 * 8).astype(np.int64)
    assert twire.derive_stream_statics(wide, 8, SSLOTS, SSLOTS) is None


@pytest.mark.parametrize("rows,rows_pad", [(256, 256), (1024, 1100), (300, 320)])
def test_stream_encode_bytes_and_decode(rows, rows_pad):
    from parameter_server_tpu_torch.utils.murmur import hash_slots

    b = _criteo_like(tsparse, 1, rows=rows)[0]
    st = twire.derive_stream_statics(b.indices, 8, SSLOTS, SSLOTS)
    jst = jwire.StreamStatics(**dataclasses.asdict(st))
    t = twire.encode_stream_shard(b.indices, rows, rows_pad, SSLOTS, st)
    j = jwire.encode_stream_shard(b.indices, rows, rows_pad, SSLOTS, jst)
    r = twire.encode_stream_shard_ref(hash_slots(b.indices, SSLOTS), rows, rows_pad, st)
    for x, y, z in zip(t, j, r):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes() == np.asarray(z).tobytes()
    enc = tsgd.prep_batch_ell_stream(b, KeyDirectory(SSLOTS), 1, rows_pad, 8, SSLOTS, st)
    y, mask, slots = twire.decode_stream_shard(twire.as_tensors(enc), 0)
    want = hash_slots(b.indices, SSLOTS).reshape(rows, 8)
    np.testing.assert_array_equal(slots.numpy()[:rows], want)
    assert slots.dtype == torch.int32 and y.dtype == mask.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy()[:rows], b.y)
    assert float(mask.sum()) == rows and float(y[rows:].abs().sum()) == 0.0
    jenc = jsgd.prep_batch_ell_stream(_criteo_like(jsparse, 1, rows=rows)[0],
                                      JKeyDirectory(SSLOTS, hashed=True), 1, rows_pad, 8, SSLOTS, jst)
    for got, want in zip(twire.decode_stream_shard(twire.as_tensors(enc), 0),
                         jwire.decode_stream_shard(jenc, 0)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_refuses_outside_its_statics():
    b = _criteo_like(tsparse, 1)[0]
    st = twire.derive_stream_statics(b.indices, 8, SSLOTS, SSLOTS)
    d = KeyDirectory(SSLOTS)
    big = _criteo_like(tsparse, 1, vocab_small=5000, seed=3)[0]  # the tables overflow
    assert tsgd.prep_batch_ell_stream(big, d, 1, 256, 8, SSLOTS, st) is None
    ragged = tsparse.SparseBatch(y=b.y[:2], indptr=np.array([0, 3, 8]), indices=b.indices[:8])
    assert tsgd.prep_batch_ell_stream(ragged, d, 1, 256, 8, SSLOTS, st) is None


# -- the ELL wires: the port's steps against the JAX worker's --


ELL_CASES = {
    "bits": (dict(ell_lanes=8, wire="bits"), "uniform"),
    "stream": (dict(ell_lanes=8, wire="stream"), "criteo"),
    "u24": (dict(ell_lanes=12, wire="u24"), "ragged"),
    "i32-valued": (dict(ell_lanes=12, wire="i32"), "valued"),
    "bits-T4": (dict(ell_lanes=8, wire="bits", steps_per_launch=4), "uniform"),
    "stream-T4-tau2": (dict(ell_lanes=8, wire="stream", steps_per_launch=4, max_delay=2), "criteo"),
}


def _ell_batches(mod, kind, n=8):
    if kind == "criteo":
        return _criteo_like(mod, n)
    out = []
    for i in range(n):
        if kind == "uniform":
            out.append(_headline(mod, i, nnz=8))
        else:
            out.append(synth_batch(mod, n=256, lanes=6, seed=i, ragged=True,
                                   binary=kind != "valued"))
    return out


@pytest.mark.parametrize("case", sorted(ELL_CASES))
def test_ell_wire_training_matches_jax(mesh, case):
    kw, kind = ELL_CASES[case]
    jw = jsgd.AsyncSGDWorker(_conf(jcfg, update="dense", **kw), mesh=mesh)
    tw = tsgd.AsyncSGDWorker(_conf(tcfg, update="dense", **kw), device="cpu")
    jprep = jw.prep(_ell_batches(jsparse, kind)[0], device_put=False)
    tprep = tw.prep(_ell_batches(tsparse, kind)[0], device_put=False)
    assert type(tprep).__name__ == type(jprep).__name__
    jp = jw.train(iter(_ell_batches(jsparse, kind)), pipelined=False)
    jw.executor.stop()
    tp = tw.train(iter(_ell_batches(tsparse, kind)), pipelined=False)
    np.testing.assert_allclose(tp.objective, jp.objective, rtol=1e-5)
    js, ts = jw.state_host()["state"], tw.state_host()["state"]
    for k in js:
        np.testing.assert_allclose(ts[k], np.asarray(js[k]), **TRAJ_TOL, err_msg=k)


@pytest.mark.parametrize("kind,kw", [("uniform", dict(ell_lanes=8, wire="bits")),
                                     ("criteo", dict(ell_lanes=8, wire="stream")),
                                     ("ragged", dict(ell_lanes=12, wire="u24")),
                                     ("ragged", dict(ell_lanes=12, wire="i32"))])
def test_ell_wires_bit_identical_to_the_hashed_path(kind, kw):
    """On the port the ELL wires' state equals the hashed per-entry
    wire's bit for bit: the same entries in the same order, the same
    sums."""
    runs = []
    for sgd in (dict(), kw):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, update="dense", max_delay=2, **sgd), device="cpu")
        w.train(iter(_ell_batches(tsparse, kind)), pipelined=False)
        runs.append((_bits(w), list(w.progress.objective)))
    _assert_same_bits(runs[0][0], runs[1][0])
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-6)


def test_ell_pipelined_stream_pins_statics_on_the_feeder():
    batches = _ell_batches(tsparse, "criteo")
    runs = []
    for pipelined in (False, True):
        w = tsgd.AsyncSGDWorker(_conf(tcfg, update="dense", ell_lanes=8, wire="stream",
                                      steps_per_launch=4, wire_compress="lz"), device="cpu")
        w.train(iter(batches), pipelined=pipelined)
        runs.append(_bits(w))
        assert w._stream_statics is not None
    _assert_same_bits(*runs)


def test_ell_widest_row_takes_the_hashed_wire():
    w = tsgd.AsyncSGDWorker(_conf(tcfg, update="dense", ell_lanes=4, wire="bits"), device="cpu")
    assert isinstance(w.prep(_headline(tsparse, 0, nnz=8), device_put=False), tsgd.HashedBatch)
    with pytest.raises(ValueError, match="lane budget"):
        tsgd.prep_batch_ell(_headline(tsparse, 0, nnz=8), KeyDirectory(64), 1, 256, 4, 64)


def test_pack_u24_and_bits_prep_match_jax():
    b_t, b_j = _headline(tsparse, 3, nnz=8), _headline(jsparse, 3, nnz=8)
    idx = np.random.default_rng(0).integers(0, 1 << 24, (5, 7)).astype(np.int32)
    np.testing.assert_array_equal(tsgd.pack_u24(idx), jsgd.pack_u24(idx))
    t = tsgd.prep_batch_ell_bits(b_t, KeyDirectory(1 << 12), 1, 256, 8, 1 << 12)
    j = jsgd.prep_batch_ell_bits(b_j, JKeyDirectory(1 << 12, hashed=True), 1, 256, 8, 1 << 12)
    np.testing.assert_array_equal(t.y_bits, j.y_bits)
    np.testing.assert_array_equal(t.counts, j.counts)
    nbytes = (256 * 8 * 12 + 7) // 8
    assert t.slots_words.view(np.uint8)[:, :nbytes].tobytes() == \
        np.asarray(j.slots_words).view(np.uint8)[:, :nbytes].tobytes()
    sb = tsgd.stack_bits_batches([t, t])
    assert sb.steps == 2 and sb.rows == 256
    valued = synth_batch(tsparse, n=256, lanes=8, binary=False)
    assert tsgd.prep_batch_ell_bits(valued, KeyDirectory(64), 1, 256, 8, 64) is None


# -- the staging leg --


def test_compress_batch_round_trip():
    _, tp = _prep_both(dict(binary=False, seed=4))
    enc = twire.encode_exact(tp, 1 << 12)
    for batch in (tp, enc):
        cb = twire.compress_batch(batch)
        assert cb.num_examples == batch.num_examples and cb.wire_nbytes < cb.raw_nbytes
        back = twire.maybe_decompress(cb)
        assert type(back) is type(batch)
        for f in dataclasses.fields(batch):
            a, b = getattr(back, f.name), getattr(batch, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
            else:
                assert a == b, f.name
    assert twire.maybe_decompress(tp) is tp
