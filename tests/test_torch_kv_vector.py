"""PyTorch port: KVVector and the key-value ops against the JAX package.

Both sides run on the CPU; the JAX store sits on a mesh with ONE server
(``make_mesh(num_data=1, num_server=1)``): the slot count, and so the
hash modulus, depends on the server count (``pad_slots``). Tables are
held bit-equal: the port's push adds colliding entries in entry order,
``(t + a) + b``, as XLA's scatter does on the CPU, on the CPU route
(``index_add_``) and on the card's route run here with the segment sum's
plain version.
"""

import numpy as np
import pytest
import torch

from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.ops import kv_ops
from parameter_server_tpu_torch.ops import segment_sum as tseg
from parameter_server_tpu_torch.parameter.kv_vector import KVVector
from parameter_server_tpu_torch.parameter.parameter import KeyDirectory
from parameter_server_tpu_torch.system.postoffice import Postoffice

torch.set_num_threads(1)


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


def _pair(mesh, **kw):
    return JKVVector(mesh=mesh, name="j", **kw), KVVector(name="t", device="cpu", **kw)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32)


def _stream(seed, n_push, n_keys, key_space, k):
    """Pushes whose keys collide: far more keys than slots, values over
    many magnitudes (so the order of the adds shows in the bits)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_push):
        keys = rng.integers(0, key_space, n_keys)
        vals = (rng.normal(size=(n_keys, k)) * np.exp(rng.normal(size=(n_keys, 1)) * 3)).astype(
            np.float32)
        yield keys, vals


def _sync(jkv, tkv, keys, vals, ch=0):
    jkv.wait(jkv.push(jkv.request(channel=ch), keys=keys, values=vals))
    tkv.wait(tkv.push(tkv.request(channel=ch), keys=keys, values=vals))


@pytest.mark.parametrize("k,num_slots", [(1, 257), (3, 1 << 10)])
def test_push_with_forced_collisions_bit_equal(mesh1, k, num_slots):
    jkv, tkv = _pair(mesh1, k=k, num_slots=num_slots, hashed=True)
    for keys, vals in _stream(0, 4, 3000, 1 << 40, k):
        _sync(jkv, tkv, keys, vals)
    slots = tkv.channel(0).directory.slots(np.arange(3000))
    assert len(np.unique(slots)) < 3000  # collisions really happen
    assert np.array_equal(_bits(np.asarray(jkv.table(0))), _bits(tkv.table(0).numpy()))
    probe = np.random.default_rng(9).integers(0, 1 << 40, 500)
    assert np.array_equal(_bits(jkv.values(0, probe)), _bits(tkv.values(0, probe)))
    tkv.executor.stop()


def test_card_route_in_entry_order_equals_jax(mesh1):
    """The card's route of the push (each touched slot's value first in
    its run, then its entries, summed by the segment sum), run on the
    CPU with the kernel's plain version, gives XLA's bits."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    for p, k, n in ((64, 1, 4000), (50, 2, 2500), (7, 3, 300)):
        t = (rng.normal(size=(p, k)) * 10).astype(np.float32)
        t[::5] = 0.0
        idx = rng.integers(-1, p + 2, n).astype(np.int32)
        v = (rng.normal(size=(n, k)) * np.exp(rng.normal(size=(n, 1)) * 4)).astype(np.float32)
        rel, ok = np.clip(idx, 0, p - 1), (idx >= 0) & (idx < p)
        want = np.asarray(jnp.asarray(t).at[rel].add(jnp.where(ok[:, None], v, 0), mode="drop"))
        got = torch.from_numpy(t.copy())
        trel, tok = kv_ops.localize(torch.from_numpy(idx), p)
        kv_ops.scatter_add_by_segments(
            got, trel, torch.where(tok[:, None], torch.from_numpy(v), 0.0),
            lambda d, i, m: tseg.segment_sum_sorted_ref(*tseg.sort_by_segment(d, i, m), m))
        assert np.array_equal(_bits(got.numpy()), _bits(want))
        assert torch.equal(kv_ops.push(torch.from_numpy(t), torch.from_numpy(idx),
                                       torch.from_numpy(v)), got)


def test_pull_and_push_pull_bit_equal(mesh1):
    jkv, tkv = _pair(mesh1, k=2, num_slots=1 << 9, hashed=True)
    stream = list(_stream(1, 3, 1500, 1 << 30, 2))
    for keys, vals in stream[:2]:
        _sync(jkv, tkv, keys, vals)
    keys, vals = stream[2]
    pull_keys = keys[::3]
    jp = np.asarray(jkv.wait_pull(jkv.push_pull(jkv.request(channel=0), keys=keys, values=vals,
                                                pull_keys=pull_keys)))
    tp = tkv.wait_pull(tkv.push_pull(tkv.request(channel=0), keys=keys, values=vals,
                                     pull_keys=pull_keys))
    assert np.array_equal(_bits(jp), _bits(tp.numpy()))
    assert np.array_equal(_bits(np.asarray(jkv.table(0))), _bits(tkv.table(0).numpy()))
    # the pulled rows are a fresh tensor: a later push leaves them as they were
    before = tp.clone()
    tkv.wait(tkv.push(tkv.request(channel=0), keys=pull_keys,
                      values=np.ones((len(pull_keys), 2), np.float32)))
    assert torch.equal(tp, before)
    tkv.executor.stop()


def test_exact_directory_and_channels(mesh1):
    jkv, tkv = _pair(mesh1, k=1, num_slots=64, hashed=False)
    keys = np.array([40, 3, 17, 3, 99, 8])
    for kv in (jkv, tkv):
        kv.set_keys(0, keys)
        kv.set_keys(1, keys[:3])
    np.testing.assert_array_equal(tkv.channel(0).key, np.unique(keys))
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(5, 1)).astype(np.float32)
    _sync(jkv, tkv, np.unique(keys), vals, ch=0)
    _sync(jkv, tkv, np.array([3, 17]), vals[:2], ch=1)
    probe = np.array([3, 8, 12345, 99, 40, 17])  # 12345 is not in the set: reads 0
    for ch in (0, 1):
        j, t = jkv.values(ch, probe), tkv.values(ch, probe)
        assert np.array_equal(_bits(j), _bits(t))
    assert tkv.values(0, probe)[2, 0] == 0.0
    tkv.executor.stop()


def test_buffered_channel_stages_per_timestamp(mesh1):
    jkv, tkv = _pair(mesh1, k=1, num_slots=128, hashed=True, buffer_value=True)
    keys = np.arange(0, 600, 7)
    vals = np.linspace(-2, 2, len(keys)).astype(np.float32)[:, None]
    for kv in (jkv, tkv):
        for ts in (5, 6):
            kv.wait(kv.push(kv.request(channel=0, ts=ts), keys=keys, values=vals * ts))
        kv.wait(kv.push(kv.request(channel=0, ts=9), keys=keys, values=vals))
        kv.wait(kv.push(kv.request(channel=0), keys=keys[:4], values=vals[:4]))  # live table
    for ts in (5, 6, 9):
        assert np.array_equal(_bits(np.asarray(jkv.buffer(0, ts))), _bits(tkv.buffer(0, ts).numpy()))
    assert np.array_equal(_bits(np.asarray(jkv.table(0))), _bits(tkv.table(0).numpy()))
    assert tkv.buffer(0, 7) is None
    tkv.clear_buffer(0, 5)
    assert tkv.buffer(0, 5) is None
    with pytest.raises(ValueError, match="buffer_value"):
        tkv.push_pull(tkv.request(channel=0, ts=3), keys=keys, values=vals)
    tkv.executor.stop()


def test_snapshot_is_a_copy_in_timestamp_order(mesh1):
    _, tkv = _pair(mesh1, k=1, num_slots=1 << 16, hashed=True)
    keys = np.arange(100)
    assert len(np.unique(tkv.channel(0).directory.slots(keys))) == 100  # no collision here
    tkv.push(tkv.request(channel=0), keys=keys, values=np.full((100, 1), 7.0, np.float32))
    snap_ts = tkv.snapshot(0)  # submitted after the push: holds it
    tkv.push(tkv.request(channel=0), keys=keys, values=np.ones((100, 1), np.float32))
    snap = tkv.executor.wait(snap_ts)
    slots = tkv.channel(0).directory.slots(keys)
    live = tkv.values(0, keys)
    assert (live[:, 0] >= 8.0).all()  # the live table took the second push
    np.testing.assert_array_equal(snap.numpy()[slots], live - 1.0)
    copy = tkv.table(0, copy=True)
    tkv.wait(tkv.push(tkv.request(channel=0), keys=keys, values=np.ones((100, 1), np.float32)))
    assert not torch.equal(copy, tkv.table(0)) and torch.equal(copy[slots], torch.from_numpy(live))
    tkv.executor.stop()


def test_replica_carried_across_both_ways(mesh1, tmp_path):
    jkv, tkv = _pair(mesh1, k=2, num_slots=512, hashed=True)
    stream = list(_stream(5, 4, 800, 1 << 20, 2))
    for keys, vals in stream[:2]:
        jkv.wait(jkv.push(jkv.request(channel=0), keys=keys, values=vals))
    tkv.set_replica(convert.kv_replica_from_jax(jkv.get_replica(), device="cpu"))
    for keys, vals in stream[2:]:
        _sync(jkv, tkv, keys, vals)
    snap, barrier = tkv.get_replica_consistent()
    assert set(barrier) == {0}
    assert np.array_equal(_bits(jkv.get_replica()[0]), _bits(snap[0]))
    back = convert.kv_replica_to_numpy({0: tkv.table(0)})
    assert back[0].dtype == np.float32 and np.array_equal(_bits(back[0]), _bits(snap[0]))
    jkv2 = JKVVector(mesh=mesh1, k=2, num_slots=512, hashed=True, name="j2")
    jkv2.set_replica(back)
    assert np.array_equal(_bits(np.asarray(jkv2.table(0))), _bits(snap[0]))
    jkv.write_to_file(str(tmp_path / "j.txt"))
    tkv.write_to_file(str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt").read_text()
    tkv.executor.stop()


def test_slot_cache_serves_repeated_key_sets(mesh1):
    _, tkv = _pair(mesh1, k=1, num_slots=1 << 12, hashed=True)
    d = tkv.channel(0).directory
    keys = np.arange(50, 90)
    a, b = d.slots_device(keys, "cpu"), d.slots_device(keys.copy(), "cpu")
    assert a is b  # the second call skips the hash and the upload
    other = keys.copy()
    other[-1] += 1  # same signature prefix, different keys: a byte compare decides
    assert not torch.equal(d.slots_device(other, "cpu"), a)
    from parameter_server_tpu.parameter.parameter import KeyDirectory as JKeyDirectory

    np.testing.assert_array_equal(d.slots(keys), JKeyDirectory(1 << 12, hashed=True).slots(keys))


def test_one_card_limits_raise_naming_their_items():
    """More server shards need a mesh of that many (the sharded store is
    held to JAX in ``tests/test_torch_parallel_blocks.py``); over them a
    live migration is a collective of the data row
    (``tests/test_torch_rebalance.py`` runs it in gloo worlds), whose
    ``perm`` is checked on each rank before any collective; on one card
    live migration and its hooks (A13's first part) run alone."""
    from parameter_server_tpu_torch.parallel.mesh import Mesh

    tkv = KVVector(k=1, num_slots=64, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        KVVector(k=1, num_slots=64, device="cpu", num_server=2)
    two = KVVector(k=1, num_slots=64, mesh=Mesh(1, 2, "cpu"), num_server=2)
    assert two.table(0).shape == (32, 1)  # this rank's server shard
    with pytest.raises(ValueError, match="bijection"):  # no world: refused before the row meets
        two.migrate(np.zeros(64, dtype=np.int64))
    two.executor.stop()
    assert tkv.layout() is None
    tkv.note_external_restore()
    assert tkv._generation() == 1
    identity = tkv.migrate(np.arange(64))
    assert identity["rows_moved"] == 0 and identity["attempts"] == 1
    np.testing.assert_array_equal(tkv.layout(), np.arange(64))
    d = KeyDirectory(64, hashed=True)
    before = d.slots(np.arange(10))
    d.set_remap(np.arange(64)[::-1].copy())
    np.testing.assert_array_equal(d.slots(np.arange(10)), 63 - before)
    tkv.executor.stop()


def test_store_follows_the_started_postoffice():
    po = Postoffice.instance().start(device="cpu")
    tkv = KVVector(k=1, num_slots=64)
    assert tkv.device == po.device and po.manager.get_customer(tkv.id) is tkv


def test_concurrent_first_use_makes_one_channel():
    """A channel is made at its first use: a pusher and a puller that
    reach a fresh store at once share one channel, so the push lands in
    the table that later reads see (a made-twice channel lost the first
    push of a stream that a puller raced)."""
    import threading
    import time

    tkv = KVVector(k=1, num_slots=256, device="cpu")
    zeros = tkv._zeros

    def slow_zeros():
        # both threads find no channel; the puller's table is made last,
        # so a second channel would replace the pusher's after its push
        time.sleep(0.1 if threading.current_thread().name == "puller" else 0.02)
        return zeros()

    tkv._zeros = slow_zeros
    keys = np.arange(32)
    gate = threading.Barrier(2)

    def push():
        gate.wait()
        tkv.wait(tkv.push(tkv.request(channel=0), keys=keys, values=np.ones((32, 1), np.float32)))

    def pull():
        gate.wait()
        tkv.wait_pull(tkv.pull(tkv.request(channel=0), keys=keys))

    threads = [threading.Thread(target=push, name="pusher"),
               threading.Thread(target=pull, name="puller")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(tkv._channels) == 1
    ref = KVVector(k=1, num_slots=256, device="cpu")
    ref.wait(ref.push(ref.request(channel=0), keys=keys, values=np.ones((32, 1), np.float32)))
    np.testing.assert_array_equal(tkv.values(0, keys), ref.values(0, keys))
    assert tkv.values(0, keys).min() >= 1.0
    tkv.executor.stop()
    ref.executor.stop()
