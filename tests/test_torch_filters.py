"""PyTorch port: the host message filters and ``MessageWireCodec`` against
the JAX package's, on the CPU.

Each filter runs in both packages on a ``Message`` built from the same
numpy arrays (seeded), through a sender chain and a receiver chain:

- key caching: the keys leave the wire on the second send of the same
  key array and come back from the receiver's cache; a miss raises;
  every encoded and decoded array and signature bit-equal;
- compressing: the frames are equal where the JAX package loads its
  native LZ codec (the port always does), and decode to the input in any
  case;
- sparse: zeros dropped, NaN marks kept, bit-equal;
- add_noise: the same ``default_rng(0)`` stream, bit-equal;
- fixing_float: the numpy ``quantize`` / ``dequantize`` and the filter's
  codes and ranges bit-equal, the error within one step, the rounding
  unbiased;
- the whole chain (``wire_filter_specs``) in the reference's order and
  swapped, caches independent a peer, non-float arrays passing through,
  an unknown filter type raising;
- ``MessageWireCodec`` across the packages: the port encodes and the JAX
  package decodes, and the other way round, the decoded arrays equal. An
  encoded message crosses by its fields (task, filter specs with their
  ``extra``, key, values): each package frames only its own types.
"""

import copy
import dataclasses

import numpy as np
import pytest

from parameter_server_tpu.cpp import native as jnative
from parameter_server_tpu.filter import base as jbase
from parameter_server_tpu.filter import fixing_float as jff
from parameter_server_tpu.filter import sparse as jsparse
from parameter_server_tpu.learner import wire as jwire
from parameter_server_tpu.system import message as jmsg
from parameter_server_tpu.utils import range as jrange
from parameter_server_tpu_torch.filter import base as tbase
from parameter_server_tpu_torch.filter import fixing_float as tff
from parameter_server_tpu_torch.filter import sparse as tsparse
from parameter_server_tpu_torch.learner import wire as twire
from parameter_server_tpu_torch.system import message as tmsg
from parameter_server_tpu_torch.utils import range as trange

PKGS = {"jax": (jbase, jmsg, jrange), "port": (tbase, tmsg, trange)}


def msg_with(pkg, values, key=None, channel=0, specs=()):
    _, m, r = PKGS[pkg]
    msg = m.Message(task=m.Task(key_channel=channel, key_range=r.Range(0, 100)))
    msg.values = [v.copy() for v in values]
    msg.key = None if key is None else key.copy()
    msg.task.filters = [m.FilterSpec(**spec) for spec in specs]
    return msg


def cross(msg, pkg):
    """``msg`` (either package's) rebuilt from its fields in ``pkg``'s types."""
    _, m, r = PKGS[pkg]
    t = msg.task
    task = m.Task(key_channel=t.key_channel, key_range=r.Range(t.key_range.begin, t.key_range.end),
                  more=t.more)
    task.filters = [m.FilterSpec(**{f.name: copy.deepcopy(getattr(s, f.name))
                                    for f in dataclasses.fields(s)}) for s in t.filters]
    return m.Message(task=task, key=msg.key, values=list(msg.values))


def run_both(values, key=None, specs=(), sends=1):
    """Each package's sender and receiver chain over ``sends`` messages of
    the same arrays; returns {pkg: [(encoded, key_on_wire, decoded)]}."""
    out = {}
    for pkg, (b, _, _) in PKGS.items():
        sender, receiver = b.FilterChain(), b.FilterChain()
        runs = []
        for _ in range(sends):
            enc = sender.encode(msg_with(pkg, values, key, specs=specs))
            wire = (None if enc.key is None else enc.key.copy(), [v.copy() for v in enc.values],
                    copy.deepcopy([s.extra for s in enc.task.filters]))
            dec = receiver.decode(enc)
            runs.append((wire, dec.key, list(dec.values)))
        out[pkg] = runs
    return out


def assert_bits_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def assert_runs_equal(out, extras=True):
    for (jw, jk, jv), (tw, tk, tv) in zip(out["jax"], out["port"], strict=True):
        assert_bits_equal(jw[0], tw[0])
        for a, b in zip(jw[1], tw[1], strict=True):
            assert_bits_equal(a, b)
        if extras:
            assert jw[2] == tw[2] or repr(jw[2]) == repr(tw[2])
        assert_bits_equal(jk, tk)
        for a, b in zip(jv, tv, strict=True):
            assert_bits_equal(a, b)


def test_every_filter_type_is_registered():
    assert sorted(tbase._REGISTRY) == sorted(jbase._REGISTRY) == [
        "add_noise", "compressing", "fixing_float", "key_caching", "sparse"]
    with pytest.raises(ValueError, match="unknown filter type"):
        tbase.create("no_such_filter")
    m = msg_with("port", [np.ones(3, np.float32)], specs=[dict(type="no_such_filter")])
    with pytest.raises(ValueError, match="no_such_filter"):
        tbase.FilterChain().encode(m)


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_key_caching_equals_the_jax_filter(dtype):
    rng = np.random.default_rng(1)
    keys = np.sort(rng.choice(1 << 40, 300, replace=False)).astype(dtype)
    vals = [rng.normal(size=300).astype(np.float32)]
    out = run_both(vals, keys, specs=[dict(type="key_caching")], sends=3)
    assert_runs_equal(out)
    wires = [w for w, _, _ in out["port"]]
    assert wires[0][0] is not None and wires[1][0] is None and wires[2][0] is None
    for _, k, _ in out["port"]:
        np.testing.assert_array_equal(k, keys)


def test_key_caching_clears_when_done_and_misses_raise():
    keys = np.arange(50, dtype=np.int64)
    spec = dict(type="key_caching", clear_cache_if_done=True)
    out = run_both([np.ones(50, np.float32)], keys, specs=[spec], sends=2)
    assert_runs_equal(out)
    # task.more is False: each send clears the cache, so keys cross every time
    assert all(w[0] is not None for w, _, _ in out["port"])
    for pkg, (b, m, _) in PKGS.items():
        spec = m.FilterSpec(type="key_caching")
        spec.extra["signature"] = 12345
        msg = msg_with(pkg, [np.ones(3, np.float32)])
        msg.task.filters = [spec]
        with pytest.raises(KeyError):
            b.FilterChain().decode(msg)


@pytest.mark.parametrize("kind", ["sparse_ones", "normal", "empty", "ints"])
def test_compressing_round_trips_and_frames_as_the_jax_filter(kind):
    rng = np.random.default_rng(2)
    vals = {
        "sparse_ones": [(rng.random(4000) < 0.05).astype(np.float32)],
        "normal": [rng.normal(size=1000).astype(np.float32), np.arange(7, dtype=np.int32)],
        "empty": [np.zeros(0, np.float32)],
        "ints": [rng.integers(0, 5, (40, 3)).astype(np.int64)],
    }[kind]
    out = run_both(vals, specs=[dict(type="compressing")])
    for pkg in PKGS:
        (_, _, dec), = out[pkg]
        for a, b in zip(dec, vals, strict=True):
            assert_bits_equal(a, b)
    if kind == "sparse_ones":
        assert out["port"][0][0][1][0].nbytes < vals[0].nbytes
    if jnative() is not None:
        assert_runs_equal(out)  # the same LZ frames, meta and decoded arrays


def test_sparse_equals_the_jax_filter():
    v = np.array([0, 1.5, 0, 0, 2.5, 0, -0.0, 3.0], dtype=np.float32)
    jv, tv = v.copy(), v.copy()
    jsparse.mark(jv, 2)
    tsparse.mark(tv, 2)
    assert_bits_equal(jv, tv)
    ints = np.arange(5, dtype=np.int32)
    out = run_both([tv, ints], specs=[dict(type="sparse")])
    assert_runs_equal(out, extras=False)
    (wire, _, dec), = out["port"]
    assert len(wire[1][0]) == 4  # 1.5, the mark, 2.5, 3.0
    assert tsparse.marked(dec[0])[2] and np.isnan(tsparse.MARK)
    np.testing.assert_array_equal(np.nan_to_num(dec[0]), np.nan_to_num(tv))
    assert_bits_equal(dec[1], ints)
    for (jm, tm) in zip(out["jax"][0][0][2][0]["meta"], out["port"][0][0][2][0]["meta"]):
        assert (jm is None) == (tm is None)
        if tm is not None:
            assert jm[0] == tm[0] and np.array_equal(jm[1], tm[1])


def test_add_noise_equals_the_jax_filter():
    rng = np.random.default_rng(4)
    vals = [np.zeros(1000, np.float32), rng.normal(size=(20, 3)).astype(np.float32),
            np.arange(4, dtype=np.int64)]
    out = run_both(vals, specs=[dict(type="add_noise", std=0.1, mean=0.5)], sends=2)
    assert_runs_equal(out)
    (wire, _, dec), _ = out["port"]
    assert 0.05 < dec[0].std() < 0.2 and abs(dec[0].mean() - 0.5) < 0.02
    assert_bits_equal(dec[2], vals[2])
    # std 0: nothing added
    out = run_both(vals, specs=[dict(type="add_noise", std=0.0)])
    for a, b in zip(out["port"][0][2], vals):
        assert_bits_equal(a, b)


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_numpy_quantize_equals_the_jax_package(num_bytes):
    v = np.random.default_rng(5).normal(size=10000).astype(np.float32)
    q_j, lo_j, hi_j = jff.quantize(v, num_bytes, np.random.default_rng(6))
    q_t, lo_t, hi_t = tff.quantize(v, num_bytes, np.random.default_rng(6))
    assert_bits_equal(q_j, q_t)
    assert (lo_j, hi_j) == (lo_t, hi_t)
    back = tff.dequantize(q_t, lo_t, hi_t, num_bytes)
    assert_bits_equal(back, jff.dequantize(q_j, lo_j, hi_j, num_bytes))
    step = (hi_t - lo_t) / ((1 << (8 * num_bytes)) - 1)
    assert np.abs(back - v).max() <= step + 1e-6
    # a constant array: hi = lo + 1, as in the JAX package
    c = np.full(10, 2.5, np.float32)
    assert tff.quantize(c, num_bytes, np.random.default_rng(0))[1:] == (2.5, 3.5)


def test_stochastic_rounding_is_unbiased():
    v = np.full(20000, 0.3, dtype=np.float32)
    v[0], v[1] = 0.0, 1.0  # pin the range
    q, lo, hi = tff.quantize(v, 1, np.random.default_rng(0))
    assert abs(tff.dequantize(q, lo, hi, 1)[2:].mean() - 0.3) < 1e-3


@pytest.mark.parametrize("num_bytes", [0, 1, 2])
def test_fixing_float_filter_equals_the_jax_filter(num_bytes):
    rng = np.random.default_rng(7)
    vals = [rng.normal(size=500).astype(np.float32), np.zeros(0, np.float32),
            np.arange(6, dtype=np.int32), rng.normal(size=64).astype(np.float64)]
    out = run_both(vals, specs=[dict(type="fixing_float", num_bytes=num_bytes)], sends=2)
    assert_runs_equal(out)
    (wire, _, dec), _ = out["port"]
    if num_bytes:
        assert wire[1][0].dtype == (np.uint8 if num_bytes == 1 else np.uint16)
        lo, hi = wire[2][0]["ranges"][0]
        assert np.abs(dec[0] - vals[0]).max() <= (hi - lo) / ((1 << (8 * num_bytes)) - 1) + 1e-6
        assert wire[2][0]["ranges"][1] is None and wire[2][0]["ranges"][2] is None
    else:
        assert_bits_equal(dec[0], vals[0])
    assert_bits_equal(dec[2], vals[2])


# -- the whole chain --


def test_reference_order_quantizes_then_compresses():
    rng = np.random.default_rng(8)
    keys = np.sort(rng.choice(1 << 30, 300, replace=False)).astype(np.int64)
    vals = [rng.normal(size=300).astype(np.float32)]
    specs = [dataclasses.asdict(s) for s in twire.wire_filter_specs(num_bytes=2)]
    assert [s["type"] for s in specs] == ["key_caching", "fixing_float", "compressing"]
    assert specs == [dataclasses.asdict(s) for s in jwire.wire_filter_specs(num_bytes=2)]
    out = run_both(vals, keys, specs=specs, sends=2)
    if jnative() is not None:
        assert_runs_equal(out)
    (w1, k1, d1), (w2, k2, d2) = out["port"]
    assert w1[0] is not None and w2[0] is None  # the repeat crosses without its keys
    np.testing.assert_array_equal(k1, keys)
    np.testing.assert_array_equal(k2, keys)
    step = (vals[0].max() - vals[0].min()) / 65535
    assert np.abs(d1[0] - vals[0]).max() <= step + 1e-6


def test_swapped_order_still_round_trips():
    specs = [dict(type="compressing"), dict(type="key_caching"),
             dict(type="fixing_float", num_bytes=1)]
    keys = np.arange(64, dtype=np.int64)
    v = np.zeros(512, np.float32)
    v[::7] = 1.0
    out = run_both([v], keys, specs=specs)
    if jnative() is not None:
        assert_runs_equal(out)
    (wire, k, dec), = out["port"]
    assert wire[0] is not None
    np.testing.assert_array_equal(k, keys)
    assert_bits_equal(dec[0], v)  # fixing_float saw byte frames: lossless


def test_per_peer_caches_are_independent():
    sender = tbase.FilterChain()
    recv_a, recv_b = tbase.FilterChain(), tbase.FilterChain()
    keys = np.arange(128, dtype=np.int64)
    specs = [dataclasses.asdict(s) for s in twire.wire_filter_specs()]
    for _ in range(2):
        dec = recv_a.decode(sender.encode(msg_with("port", [np.ones(128, np.float32)], keys,
                                                   specs=specs)))
        np.testing.assert_array_equal(dec.key, keys)
    wire_form = sender.encode(msg_with("port", [np.ones(128, np.float32)], keys, specs=specs))
    assert wire_form.key is None  # the sender's cache still holds them
    with pytest.raises(KeyError):
        recv_b.decode(wire_form)  # peer B never saw them: a loud miss


def test_mixed_dtype_values_pass_through():
    rng = np.random.default_rng(9)
    ints = np.arange(100, dtype=np.int32)
    floats = rng.normal(size=100).astype(np.float32)
    specs = [dataclasses.asdict(s) for s in twire.wire_filter_specs(num_bytes=1)]
    out = run_both([ints, floats], specs=specs)
    if jnative() is not None:
        assert_runs_equal(out)
    (_, _, dec), = out["port"]
    assert_bits_equal(dec[0], ints)
    assert np.abs(dec[1] - floats).max() <= (floats.max() - floats.min()) / 255 + 1e-6


def test_stacked_sparse_and_compressing_decode_in_reverse():
    rng = np.random.default_rng(10)
    v = np.zeros(500, dtype=np.float32)
    v[::50] = rng.normal(size=10)
    out = run_both([v], specs=[dict(type="sparse"), dict(type="compressing")])
    (_, _, dec), = out["port"]
    assert_bits_equal(dec[0], v)
    assert_bits_equal(out["jax"][0][2][0], v)


# -- MessageWireCodec across the packages --


def headline_like(seed, n=4000):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 24, n).astype(np.uint64))
    return keys, [rng.normal(size=keys.size).astype(np.float32)]


@pytest.mark.parametrize("num_bytes", [0, 1, 2])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_message_wire_codec_decodes_across_the_packages(num_bytes, direction):
    src, dst, dst_pkg = ((twire, jwire, "jax") if direction == "port_to_jax"
                         else (jwire, twire, "port"))
    enc_codec, dec_codec = src.MessageWireCodec(num_bytes), dst.MessageWireCodec(num_bytes)
    # the receiving package's own pair: its codes come from the same
    # default_rng(0) stream, so it decodes the same arrays
    mine_s, mine_r = dst.MessageWireCodec(num_bytes), dst.MessageWireCodec(num_bytes)
    keys, vals = headline_like(11)
    for send in range(3):
        msg = enc_codec.encode(keys.copy(), [v.copy() for v in vals])
        assert (msg.key is None) == (send > 0)  # repeats cross as the signature
        k, got = dec_codec.decode(cross(msg, dst_pkg))
        np.testing.assert_array_equal(k, keys)
        assert k.dtype == np.uint64
        if num_bytes == 0:
            assert_bits_equal(got[0], vals[0])
        else:
            step = (vals[0].max() - vals[0].min()) / ((1 << (8 * num_bytes)) - 1)
            assert np.abs(got[0] - vals[0]).max() <= step * (1 + 1e-6)
        k2, got2 = mine_r.decode(mine_s.encode(keys.copy(), [v.copy() for v in vals]))
        np.testing.assert_array_equal(k2, keys)
        assert_bits_equal(got2[0], got[0])


def test_message_wire_codec_values_only_and_new_keys():
    codec_s, codec_r = twire.MessageWireCodec(1), twire.MessageWireCodec(1)
    keys, vals = headline_like(12)
    k, got = codec_r.decode(codec_s.encode(None, vals))
    assert k is None and got[0].dtype == np.float32
    codec_r.decode(codec_s.encode(keys, vals))
    other, _ = headline_like(13)
    msg = codec_s.encode(other, vals[:0] + [np.ones(other.size, np.float32)])
    assert msg.key is not None  # a new key set crosses whole
    k, got = codec_r.decode(msg)
    np.testing.assert_array_equal(k, other)
    assert_bits_equal(got[0], np.ones(other.size, np.float32))
