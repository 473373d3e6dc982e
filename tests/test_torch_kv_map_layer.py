"""PyTorch port: KVMap and KVLayer against the JAX package's.

Both sides run on the CPU; the JAX stores sit on a 1x1 mesh
(``make_mesh(num_data=1, num_server=1)``). KVMap's push adds a
request's rows in entry order on both sides (XLA's scatter on the CPU,
``index_add_`` here, the segment sum on the card), so pushes, pulls and
``values`` are held bit-equal, duplicate keys and the unknown keys of an
exact directory included (``AddEntry`` adds each row into the value,
``(t + a) + b``, the order XLA folds the JAX entry's ``value + grad``
into). The KVLayer updater ``w - lr * g`` is one multiply-add: XLA
contracts it into a fused multiply-add on the CPU and torch rounds the
product first, so layers are held within ``UPDATER_RTOL`` (ROADMAP
Queue C's FMA-contraction divergence); so are the optimizer updater's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.parameter import kv_layer as jlayer
from parameter_server_tpu.parameter import kv_map as jmap
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.ops import kv_ops
from parameter_server_tpu_torch.ops import segment_sum as tseg
from parameter_server_tpu_torch.parameter import kv_layer as tlayer
from parameter_server_tpu_torch.parameter import kv_map as tmap
from parameter_server_tpu_torch.system.postoffice import Postoffice

torch.set_num_threads(1)

ENTRIES = ["assign", "add"]
# w - lr * g: a fused multiply-add in XLA, two roundings in torch (a few
# ulps apart after several pushes)
UPDATER_RTOL = 1e-6


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


def bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def maps(mesh, entry, **kw):
    j = {"assign": jmap.AssignEntry, "add": jmap.AddEntry}[entry]()
    t = {"assign": tmap.AssignEntry, "add": tmap.AddEntry}[entry]()
    return jmap.KVMap(j, mesh=mesh, name="j", **kw), tmap.KVMap(t, name="t", device="cpu", **kw)


def pushes(seed, n_push, n_keys, key_space, k):
    """Pushes with many duplicate keys, values over many magnitudes (so
    the order of the adds shows in the bits)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_push):
        keys = rng.integers(0, key_space, n_keys)
        vals = (rng.normal(size=(n_keys, k)) * np.exp(rng.normal(size=(n_keys, 1)) * 3)).astype(
            np.float32)
        yield keys, vals


def push_both(j, t, keys, vals):
    j.wait(j.push(j.request(), keys, vals))
    t.wait(t.push(t.request(), keys, vals))


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("k,num_slots", [(1, 257), (4, 1 << 10)])
def test_hashed_kv_map_push_pull_values_bit_equal(mesh1, entry, k, num_slots):
    j, t = maps(mesh1, entry, k=k, num_slots=num_slots)
    for keys, vals in pushes(k, 4, 3000, 1 << 40, k):
        push_both(j, t, keys, vals)
    assert len(np.unique(t.directory.slots(keys))) < len(keys)  # duplicates really occur
    for name, arr in j.get_replica().items():
        assert np.array_equal(bits(arr), bits(t.get_replica()[name]))
    probe = np.random.default_rng(9).integers(0, 1 << 40, 500)
    assert np.array_equal(bits(j.values(probe)), bits(t.values(probe)))
    jp = np.asarray(j.wait_pull(j.pull(j.request(), probe)))
    tp = t.wait_pull(t.pull(t.request(), probe)).numpy()
    assert np.array_equal(bits(jp), bits(tp))
    t.executor.stop()


@pytest.mark.parametrize("entry", ENTRIES)
def test_exact_kv_map_drops_unknown_keys_as_jax(mesh1, entry):
    known = np.unique(np.random.default_rng(1).integers(0, 1 << 50, 60))
    j, t = maps(mesh1, entry, k=3, num_slots=50 + len(known), keys=known)
    assert t.num_slots == j.num_slots and t.directory.num_slots == t.num_slots
    rng = np.random.default_rng(2)
    for _ in range(3):
        keys = np.concatenate([rng.choice(known, 400), rng.integers(0, 1 << 50, 100)])
        vals = rng.normal(size=(500, 3)).astype(np.float32)
        push_both(j, t, keys, vals)
    probe = np.concatenate([known, rng.integers(0, 1 << 50, 20)])
    got = t.values(probe)
    assert np.array_equal(bits(np.asarray(j.values(probe))), bits(got))
    assert not got[len(known):].any()  # unknown keys pull zero


def test_kv_map_card_route_equals_cpu(monkeypatch):
    """The push's card route (a stable sort, the segment sum in entry
    order) run on the CPU with the kernel's plain version: the same bits
    as ``index_add_``."""
    plain = lambda d, i, m: tseg.segment_sum_sorted_ref(*tseg.sort_by_segment(d, i, m), m)  # noqa: E731
    stream = list(pushes(5, 3, 2000, 1 << 40, 4))
    cpu = tmap.KVMap(tmap.AddEntry(), k=4, num_slots=300, device="cpu")
    for keys, vals in stream:
        cpu.wait(cpu.push(cpu.request(), keys, vals))
    card = tmap.KVMap(tmap.AddEntry(), k=4, num_slots=300, device="cpu")
    push = tmap.make_push(card.entry, card.num_slots)
    monkeypatch.setattr(tmap, "scatter_add_in_order",
                        lambda tb, r, v: kv_ops.scatter_add_by_segments(tb, r, v, plain))
    for keys, vals in stream:
        card.state = push(card.state, card.slots(keys), torch.from_numpy(vals))
    assert np.array_equal(bits(cpu.get_replica()["value"]), bits(card.get_replica()["value"]))
    monkeypatch.setattr(kv_ops, "segment_sum", plain)  # AssignEntry's gradient: scatter_sum
    assign = [tmap.KVMap(tmap.AssignEntry(), k=4, num_slots=300, device="cpu") for _ in range(2)]
    for keys, vals in stream:
        assign[0].wait(assign[0].push(assign[0].request(), keys, vals))
    push = tmap.make_push(assign[1].entry, assign[1].num_slots)
    for keys, vals in stream:
        assign[1].state = push(assign[1].state, assign[1].slots(keys), torch.from_numpy(vals))
    assert np.array_equal(bits(assign[0].get_replica()["value"]),
                          bits(assign[1].get_replica()["value"]))


def test_kv_map_replica_write_and_convert(mesh1, tmp_path):
    j, t = maps(mesh1, "add", k=2, num_slots=64, keys=np.array([1, 2, 7]))
    push_both(j, t, np.array([1, 2, 2]), np.arange(6, dtype=np.float32).reshape(3, 2))
    snap = t.get_replica()
    t.wait(t.push(t.request(), np.array([1]), np.ones((1, 2), np.float32)))
    assert float(snap["value"][0, 0]) == 0.0  # the snapshot is a copy
    t.set_replica(convert.tree_from_numpy(j.get_replica(), "cpu"))
    assert np.array_equal(t.values(np.array([1, 2, 7])), np.asarray(j.values(np.array([1, 2, 7]))))
    pj, pt = tmp_path / "j.txt", tmp_path / "t.txt"
    j.write_to_file(str(pj))
    t.write_to_file(str(pt))
    assert pj.read_text() == pt.read_text() and pt.read_text()


@pytest.mark.parametrize("num_rows,k,n", [(64, 1, 4000), (50, 3, 2500), (7, 8, 300)])
def test_scatter_sum_bit_equal_to_xla(num_rows, k, n):
    """``kv_ops.scatter_sum`` against ``jnp.zeros(...).at[rel].add``
    (XLA's CPU scatter, entry order): the CPU route and the card's route
    (sort, then the segment sum's plain version), duplicates, values over
    many magnitudes, zeros of both signs."""
    rng = np.random.default_rng(n)
    rel = rng.integers(0, num_rows, n)
    v = (rng.normal(size=(n, k)) * np.exp(rng.normal(size=(n, 1)) * 4)).astype(np.float32)
    v[::7] = 0.0
    v[3::11] = -0.0
    want = np.asarray(jnp.zeros((num_rows, k), jnp.float32).at[rel].add(v))
    got = kv_ops.scatter_sum(num_rows, torch.from_numpy(rel), torch.from_numpy(v))
    assert got.shape == (num_rows, k) and np.array_equal(bits(got.numpy()), bits(want))
    ids = (torch.from_numpy(rel)[:, None] * k + torch.arange(k)).reshape(-1)
    routed = tseg.segment_sum_sorted_ref(*tseg.sort_by_segment(
        torch.from_numpy(v).reshape(-1), ids, num_rows * k), num_rows * k)
    assert np.array_equal(bits(routed.view(num_rows, k).numpy()), bits(want))


def test_kv_map_limits():
    with pytest.raises(NotImplementedError, match="A9"):
        tmap.KVMap(tmap.AddEntry(), num_slots=64, device="cpu", num_server=2)


def _layers(mesh, donate, lr=0.5):
    return (jlayer.KVLayer(partition_thr=4, updater=jlayer.SGDUpdater(lr=lr), mesh=mesh,
                           donate=donate),
            tlayer.KVLayer(partition_thr=4, updater=tlayer.SGDUpdater(lr=lr), donate=donate,
                           device="cpu"))


@pytest.mark.parametrize("donate", [True, False])
def test_kv_layer_updater_bit_equal(mesh1, donate):
    j, t = _layers(mesh1, donate, lr=0.037)
    rng = np.random.default_rng(4)
    j.init_layer("w", (8, 3))
    t.init_layer("w", (8, 3))
    for _ in range(4):
        g = rng.normal(size=(8, 3)).astype(np.float32)
        j.wait(j.push(j.request(), "w", jnp.asarray(g)))
        t.wait(t.push(t.request(), "w", torch.from_numpy(g)))
    g = rng.normal(size=(5,)).astype(np.float32)  # a layer made by its first push
    jp = np.asarray(j.wait_pull(j.push_pull(j.request(), "b", jnp.asarray(g))))
    tp = t.wait_pull(t.push_pull(t.request(), "b", g)).numpy()
    np.testing.assert_allclose(tp, jp, rtol=UPDATER_RTOL, atol=0)
    for key, arr in j.get_replica().items():
        np.testing.assert_allclose(t.get_replica()[key], arr, rtol=UPDATER_RTOL, atol=0)
    assert t.partition_thr == 4


def test_kv_layer_donate_false_keeps_pull_values(mesh1):
    _, t = _layers(mesh1, donate=False)
    t.init_layer("w", (8,))
    t.wait(t.push(t.request(), "w", torch.ones(8)))
    view = t.wait_pull(t.pull(t.request(), "w"))
    t.wait(t.push(t.request(), "w", torch.ones(8)))
    assert torch.equal(view, torch.full((8,), -0.5))
    assert torch.equal(t.layer("w"), torch.full((8,), -1.0))


def test_kv_layer_donate_true_updates_in_place(mesh1):
    """Under donate the layer is written in place: a pulled tensor reads
    the next push (the JAX store raises on such a stale view instead);
    the replica is a copy taken before it."""
    _, t = _layers(mesh1, donate=True)
    t.init_layer("w", (8,))
    t.wait(t.push(t.request(), "w", torch.ones(8)))
    view = t.wait_pull(t.pull(t.request(), "w"))
    snap = t.get_replica()
    t.wait(t.push(t.request(), "w", torch.ones(8)))
    assert view is t.layer("w") and torch.equal(view, torch.full((8,), -1.0))
    assert np.array_equal(snap["w"], np.full(8, -0.5, np.float32))


def test_kv_layer_push_pull_matches_sequenced(mesh1):
    _, a = _layers(mesh1, donate=True)
    a.init_layer("w", (8, 2))
    a.wait(a.push(a.request(), "w", torch.ones((8, 2))))
    want = a.wait_pull(a.pull(a.request(), "w")).clone()
    _, b = _layers(mesh1, donate=True)
    b.init_layer("w", (8, 2))
    assert torch.equal(b.wait_pull(b.push_pull(b.request(), "w", torch.ones((8, 2)))), want)


def test_torch_optim_updater_matches_optax_updater(mesh1):
    """The port's optimizer-backed updater against the JAX ``OptaxUpdater``
    with ``optax.sgd(0.05, momentum=0.9)`` (a fresh state each update)."""
    optax = pytest.importorskip("optax")
    from parameter_server_tpu.apps.nn.trainer import OptaxUpdater
    from parameter_server_tpu_torch.apps.nn.trainer import TorchOptimUpdater

    ju = OptaxUpdater(optax.sgd(0.05, momentum=0.9))
    tu = TorchOptimUpdater()
    rng = np.random.default_rng(6)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    g = rng.normal(size=(6, 4)).astype(np.float32)
    want = np.asarray(ju.update("w", jnp.asarray(w), jnp.asarray(g)))
    got = tu.update("w", torch.from_numpy(w), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=UPDATER_RTOL, atol=0)
    t = tlayer.KVLayer(updater=tu, device="cpu")
    t.init_layer("w", (6, 4))
    got = t.wait_pull(t.push_pull(t.request(), "w", torch.from_numpy(g))).numpy()
    want = np.asarray(ju.update("w", jnp.zeros((6, 4)), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=UPDATER_RTOL, atol=0)
