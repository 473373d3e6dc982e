"""PyTorch port: FTRL math, dither hash and row updates against the JAX
package.

The same numpy inputs (fixed seeds) go through the JAX functions and
their counterparts in ``parameter_server_tpu_torch``. The JAX kernels
run as the JAX package's own tests run them on the CPU: Pallas in
interpret mode (``force_pallas=True, interpret=True``) and the plain
references. The port's wrappers take their plain PyTorch versions here,
because the tensors lie on the CPU.

Tolerances, each with its reason:

- f32 state and per-call results: ``rtol=1e-6, atol=1e-7``. XLA on the
  CPU contracts ``z + g - sigma * w`` into a fused multiply-add under
  jit; eager PyTorch rounds each operation.
- bf16 sqrt_n: equal except for at most 0.1% of entries, which may
  differ by one bf16 ulp: a last-bit f32 difference can flip the
  dithered truncation.
- integer results (the dither hash, the bf16 bit patterns where no f32
  rounding is involved): exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from parameter_server_tpu.apps.linear import learning_rate as jlr
from parameter_server_tpu.apps.linear import penalty as jpen
from parameter_server_tpu.apps.linear import updaters as jupd
from parameter_server_tpu.ops import ftrl as jftrl
from parameter_server_tpu.ops import ftrl_sparse as jsparse
from parameter_server_tpu_torch.apps.linear import learning_rate as tlr
from parameter_server_tpu_torch.apps.linear import penalty as tpen
from parameter_server_tpu_torch.apps.linear import updaters as tupd
from parameter_server_tpu_torch.ops import ftrl as tftrl
from parameter_server_tpu_torch.ops import ftrl_sparse as tsparse

torch.set_num_threads(1)

KW = dict(alpha=0.5, beta=1.0, l1=0.05, l2=0.01)
F32_TOL = dict(rtol=1e-6, atol=1e-7)  # FMA contraction in jitted XLA
P = 1 << 13


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_bits(x) -> np.ndarray:
    """uint16 bit patterns of a bf16 array from either framework."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def assert_bf16_close(got, want):
    """At most 0.1% of entries differ, each by one bf16 ulp."""
    g = _bf16_bits(got).astype(np.int32)
    w = _bf16_bits(want).astype(np.int32)
    diff = np.abs(g - w)
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() <= 1e-3, (diff != 0).mean()


def _state_np(p, rng):
    return (
        rng.normal(size=p).astype(np.float32),
        (rng.random(p) * 2).astype(np.float32),
    )


def _dense_inputs(p, rng, frac=0.3):
    z, n = _state_np(p, rng)
    g = rng.normal(size=p).astype(np.float32)
    g[rng.random(p) > frac] = 0.0
    touched = (g != 0) | (rng.random(p) < 0.05)  # mask wider than support
    return z, n, g, touched


def _touch(p, u, rng, *, tail="high", alias_last=False, zero_g_at=()):
    """localize-shaped sparse inputs: sorted unique owned ids, non-ok
    clip entries (``high``: the one-past-the-end sentinel clips to p-1;
    ``low``: the -1 sentinel clips to 0), g = 0 padding excluded by ok.
    ``alias_last`` makes a genuine ok entry own the slot the non-ok
    tail clips onto -- the write the tail must never clobber."""
    n_live = u - max(2, u // 8)
    live = np.unique(rng.integers(1, p - 1, n_live))
    if alias_last:
        live = np.unique(np.r_[live[:-1], p - 1 if tail == "high" else 0])
    clip = p - 1 if tail == "high" else 0
    rel = np.full(u, clip, np.int32)
    rel[: len(live)] = live.astype(np.int32)
    ok = np.zeros(u, bool)
    ok[: len(live)] = True
    g = rng.normal(size=u).astype(np.float32)
    for i in zero_g_at:
        g[i] = 0.0
    return rel, ok, g


# -- the dither hash and the bf16 narrow --


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_dither_hash_bit_equal(seed):
    i = np.arange(1 << 20, dtype=np.uint32)
    want = np.asarray(jftrl.dither_hash_u32(jnp.asarray(i), jnp.uint32(seed)))
    got = tftrl.dither_hash_u32(torch.arange(1 << 20), seed).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


@pytest.mark.parametrize("seed", [3, 123456789])
def test_stochastic_round_bf16_bit_equal(seed, rng):
    x = (rng.random(1 << 14) * 50).astype(np.float32)
    x[::7] = np.asarray(
        jnp.asarray(x[::7]).astype(jnp.bfloat16).astype(jnp.float32)
    )  # bf16-exact entries must round-trip unchanged
    want = jftrl.stochastic_round_bf16(jnp.asarray(x), seed)
    got = tftrl.stochastic_round_bf16(_t(x), seed)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))
    exact = _bf16_bits(got)[::7].astype(np.uint32) << 16
    np.testing.assert_array_equal(exact.view(np.float32), x[::7])


# -- dense update: port plain version vs JAX kernel (interpret) and ref --


DENSE_CASES = [
    ("f32", True, None),
    ("f32", False, None),
    ("bf16", True, 11),
    ("bf16", False, 11),
    ("bf16", False, None),  # unseeded: round to nearest (JAX ref only)
]


@pytest.mark.parametrize("dtype,masked,seed", DENSE_CASES)
def test_ftrl_update_vs_jax(dtype, masked, seed, rng):
    z, n, g, touched = _dense_inputs(P, rng)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jn = jnp.asarray(n).astype(jdt)
    jt = jnp.asarray(touched.astype(np.float32)) if masked else None
    js = None if seed is None else jnp.uint32(seed)
    wants = [jftrl.ftrl_update_ref(jnp.asarray(z), jn, jnp.asarray(g), jt,
                                   **KW, seed=js)]
    if dtype == "f32" or seed is not None:  # shapes the Pallas kernel takes
        wants.append(jftrl.ftrl_update(
            jnp.asarray(z), jn, jnp.asarray(g), jt, **KW, seed=js,
            force_pallas=True, interpret=True,
        ))
    tz, tn = _t(z.copy()), _t(n.copy()).to(tdt)
    out = tftrl.ftrl_update(
        tz, tn, _t(g), _t(touched) if masked else None, **KW, seed=seed
    )
    assert out[0] is tz and out[1] is tn  # updated in place
    for wz, wn in wants:
        np.testing.assert_allclose(tz.numpy(), np.asarray(wz), **F32_TOL)
        if dtype == "bf16":
            assert_bf16_close(tn, wn)
        else:
            np.testing.assert_allclose(tn.numpy(), np.asarray(wn), **F32_TOL)
    # untouched slots pass through bit-for-bit
    keep = touched if masked else g != 0
    np.testing.assert_array_equal(tz.numpy()[~keep], z[~keep])


def test_ftrl_update_rejects_bad_shapes():
    z = torch.zeros(16)
    with pytest.raises(ValueError):
        tftrl.ftrl_update(z, torch.zeros(8), torch.zeros(16), **KW)
    with pytest.raises(ValueError):
        tftrl.ftrl_update(z, torch.zeros(16), torch.zeros(16, dtype=torch.float64), **KW)
    with pytest.raises(ValueError):
        tftrl.ftrl_update(z, torch.zeros(16, dtype=torch.float16), torch.zeros(16), **KW)


# -- sparse update: port plain version vs JAX kernel (interpret) and ref --


SPARSE_CASES = [
    ("f32", "high", False),
    ("f32", "low", False),
    ("f32", "high", True),
    ("bf16", "high", False),
    ("bf16", "low", True),
]


@pytest.mark.parametrize("dtype,tail,alias", SPARSE_CASES)
def test_ftrl_sparse_update_vs_jax(dtype, tail, alias, rng):
    u = 512
    z, n = _state_np(P, rng)
    rel, ok, g = _touch(P, u, rng, tail=tail, alias_last=alias, zero_g_at=(3,))
    seed = 7 if dtype == "bf16" else None
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jargs = (jnp.asarray(z), jnp.asarray(n).astype(jdt), jnp.asarray(rel),
             jnp.asarray(ok), jnp.asarray(g))
    js = None if seed is None else jnp.uint32(seed)
    wants = [
        jsparse.ftrl_sparse_rows_ref(*jargs, **KW, seed=js),
        jsparse.ftrl_sparse_update(*jargs, **KW, seed=js, force_pallas=True,
                                   interpret=True),
    ]
    tz, tn = _t(z.copy()), _t(n.copy()).to(tdt)
    tsparse.ftrl_sparse_update(tz, tn, _t(rel), _t(ok), _t(g), **KW, seed=seed)
    for wz, wn in wants:
        np.testing.assert_allclose(tz.numpy(), np.asarray(wz), **F32_TOL)
        if dtype == "bf16":
            assert_bf16_close(tn, wn)
        else:
            np.testing.assert_allclose(tn.numpy(), np.asarray(wn), **F32_TOL)
    # only ok entries with g != 0 change; everything else is bit-untouched
    live = np.zeros(P, bool)
    live[rel[ok & (g != 0)]] = True
    np.testing.assert_array_equal(tz.numpy()[~live], z[~live])
    assert (tz.numpy()[live] != z[live]).mean() > 0.9
    if alias:  # the clipped tail's slot took its genuine update
        clip = P - 1 if tail == "high" else 0
        assert tz.numpy()[clip] != z[clip]


def test_ftrl_sparse_update_rejects_duplicate_ok_rows():
    z, n = torch.zeros(64), torch.zeros(64)
    rel = torch.tensor([3, 3, 5], dtype=torch.int32)
    ok = torch.tensor([True, True, True])
    with pytest.raises(ValueError, match="duplicate-free"):
        tsparse.ftrl_sparse_update(z, n, rel, ok, torch.ones(3), **KW)
    # duplicates among non-ok entries (clip artifacts) are fine
    ok = torch.tensor([True, False, True])
    tsparse.ftrl_sparse_update(z, n, rel, ok, torch.ones(3), **KW)


def test_resolve_update_path():
    r = tsparse.resolve_update_path
    assert r("sparse", on_cuda=True) == "cuda_sparse"
    assert r("dense", on_cuda=True) == "cuda_dense"
    assert r("sparse", on_cuda=False) == "torch_ref"
    assert r("dense", on_cuda=False) == "torch_ref"
    with pytest.raises(ValueError):
        r("auto", on_cuda=True)


# -- apply_state_rows for every updater --


def _updaters(kind):
    if kind.startswith("ftrl"):
        dt = "bfloat16" if kind == "ftrl_bf16" else "float32"
        jl, tl = jlr.LearningRate("decay", KW["alpha"], KW["beta"]), \
            tlr.LearningRate("decay", KW["alpha"], KW["beta"])
        return (jupd.FTRLUpdater(jl, jpen.ElasticNet(KW["l1"], KW["l2"]), dt),
                tupd.FTRLUpdater(tl, tpen.ElasticNet(KW["l1"], KW["l2"]), dt))
    jl, tl = jlr.LearningRate("decay", 0.3, 1.0), tlr.LearningRate("decay", 0.3, 1.0)
    jp, tp = jpen.ElasticNet(0.01, 0.001), tpen.ElasticNet(0.01, 0.001)
    if kind == "adagrad":
        return jupd.AdaGradUpdater(jl, jp), tupd.AdaGradUpdater(tl, tp)
    if kind == "ftrl_const":
        jl, tl = jlr.LearningRate("constant", 0.3), tlr.LearningRate("constant", 0.3)
        return jupd.FTRLUpdater(jl, jp), tupd.FTRLUpdater(tl, tp)
    return jupd.SGDUpdater(jl, jp), tupd.SGDUpdater(tl, tp)


def _np_state(kind, rng):
    if kind.startswith("ftrl"):
        z, n = _state_np(P, rng)
        return {"z": z, "sqrt_n": n}
    st = {"w": rng.normal(size=P).astype(np.float32)}
    if kind == "adagrad":
        st["sum_sq"] = (rng.random(P) * 2).astype(np.float32)
    else:
        st["t"] = np.float32(5.0)
    return st


@pytest.mark.parametrize("kind", ["ftrl", "ftrl_bf16", "ftrl_const", "adagrad", "sgd"])
def test_apply_state_rows_vs_jax(kind, rng):
    jup, tup = _updaters(kind)
    st = _np_state(kind, rng)
    rel, ok, g = _touch(P, 384, rng, alias_last=True)
    bf16 = kind == "ftrl_bf16"
    seed = 5 if bf16 else None
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.tensor(v) for k, v in st.items()}
    if bf16:
        jst["sqrt_n"] = jst["sqrt_n"].astype(jnp.bfloat16)
        tst["sqrt_n"] = tst["sqrt_n"].to(torch.bfloat16)
    want = jupd.apply_state_rows(
        jup, jst, rel, ok, jnp.asarray(g),
        seed=None if seed is None else jnp.uint32(seed),
    )
    got = tupd.apply_state_rows(tup, tst, _t(rel), _t(ok), _t(g), seed=seed)
    assert got is tst  # in place
    for k in st:
        if bf16 and k == "sqrt_n":
            assert_bf16_close(got[k], want[k])
        else:
            np.testing.assert_allclose(
                got[k].numpy(), np.asarray(want[k]), **F32_TOL
            )


@pytest.mark.parametrize("kind", ["adagrad", "sgd", "ftrl_const"])
def test_updater_apply_dense_vs_jax(kind, rng):
    """The whole-shard apply of the updaters that do not take a kernel."""
    jup, tup = _updaters(kind)
    st = _np_state(kind, rng)
    g = rng.normal(size=P).astype(np.float32)
    g[rng.random(P) > 0.3] = 0.0
    want = jup.apply({k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(g), None)
    got = tup.apply({k: torch.tensor(v) for k, v in st.items()}, _t(g), None)
    for k in st:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **F32_TOL)


# -- kv_ops: the slot-id helpers the row path relies on --


@pytest.mark.parametrize("num_slots", [1 << 12, 1000003, 1 << 31])
def test_kv_ops_match_jax(num_slots, rng):
    from parameter_server_tpu.ops import kv_ops as jkv
    from parameter_server_tpu_torch.ops import kv_ops as tkv

    sentinel = tkv.slot_sentinel(num_slots)
    assert sentinel == jkv.slot_sentinel(num_slots)
    ids = rng.integers(0, min(num_slots, 1 << 31), 256).astype(np.int32)
    ids[-16:] = sentinel
    np.testing.assert_array_equal(
        tkv.valid_slots(_t(ids), num_slots).numpy(),
        np.asarray(jkv.valid_slots(jnp.asarray(ids), num_slots)),
    )
    # localize on one server shard: rel clips onto a REAL slot, ok drops it
    rel, ok = tkv.localize(_t(ids), num_slots)
    assert rel.dtype == torch.int32
    np.testing.assert_array_equal(ok.numpy(), ids != sentinel)
    want_rel = np.clip(ids, 0, min(num_slots, 1 << 31) - 1)
    np.testing.assert_array_equal(rel.numpy(), want_rel)
    assert 0 <= int(rel.min()) and int(rel.max()) < num_slots
