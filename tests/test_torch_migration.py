"""PyTorch port: live slot migration (``KVVector.migrate``, the push
journal and its replay, ``KeyDirectory.set_remap``) against the JAX
package.

Both sides run on the CPU; the JAX store sits on a 1x1 mesh
(``make_mesh(num_data=1, num_server=1)``), as in
``tests/test_torch_kv_vector.py``, so the padded slot count and the hash
modulus match. The contracts are those of ``tests/test_rebalance.py``:
after a migration the table, in the base layout, is bit-identical to an
undisturbed run; pushes that land while the migration's snapshot is open
are journaled and replay in order; pulls never fail across the move; a
recovery landing mid-migration makes it snapshot again. Every table
comparison here is bit for bit (no tolerance): both packages add a
slot's entries in entry order, and a migration moves rows, it adds
nothing. The card's push route (each touched row first in its run, then
the segment sum) is run on the CPU with the kernel's plain version in
the cases parametrized ``card_route``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector
from parameter_server_tpu.parameter.parameter import KeyDirectory as JKeyDirectory
from parameter_server_tpu.system import faults as jfaults
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch.ops import kv_ops
from parameter_server_tpu_torch.ops import segment_sum as tseg
from parameter_server_tpu_torch.parameter.kv_vector import KVVector
from parameter_server_tpu_torch.parameter.parameter import KeyDirectory
from parameter_server_tpu_torch.parameter.replica import ReplicaManager
from parameter_server_tpu_torch.system import faults
from parameter_server_tpu_torch.system.postoffice import Postoffice

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(num_data=1, num_server=1)


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    Postoffice.reset()
    JPostoffice.reset()


@pytest.fixture(params=["cpu_route", "card_route"])
def route(request, monkeypatch):
    """The push's CPU route (``index_add_``), or the card's route run on
    the CPU with the segment sum's plain version."""
    if request.param == "card_route":
        def card(table, rel, vals):
            kv_ops.scatter_add_by_segments(
                table, rel, vals,
                lambda d, i, m: tseg.segment_sum_sorted_ref(*tseg.sort_by_segment(d, i, m), m))

        monkeypatch.setattr(kv_ops, "scatter_add_in_order", card)
    return request.param


def _store(num_slots=64, k=2, hashed=True, name="reb", keys=None):
    kv = KVVector(k=k, num_slots=num_slots, hashed=hashed, name=name, device="cpu")
    if keys is not None:
        kv.set_keys(0, keys)
    return kv


def _jstore(mesh, num_slots=64, k=2, hashed=True, name="jreb", keys=None):
    kv = JKVVector(mesh=mesh, k=k, num_slots=num_slots, hashed=hashed, name=name)
    if keys is not None:
        kv.set_keys(0, keys)
    return kv


def _batches(n, k=2, seed=3, n_keys=40, key_space=997):
    """``tests/test_rebalance.py``'s stream: sorted distinct keys, normal
    values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = np.sort(rng.choice(key_space, size=n_keys, replace=False)).astype(np.int64)
        vals = rng.normal(size=(n_keys, k)).astype(np.float32)
        out.append((keys, vals))
    return out


def _colliding(n, k=2, seed=5, n_keys=300, key_space=1 << 40):
    """Pushes whose hashed slots collide (many more keys than slots) with
    values over many magnitudes, so the order of the adds shows."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        keys = rng.integers(0, key_space, n_keys).astype(np.int64)
        vals = (rng.normal(size=(n_keys, k)) * np.exp(rng.normal(size=(n_keys, 1)) * 3)).astype(
            np.float32)
        yield keys, vals


def _push_all(kv, batches):
    for keys, vals in batches:
        kv.push(kv.request(channel=0), keys=keys, values=vals)
    kv.executor.wait_all(pop=False)


def _perm(num_slots, seed=11):
    return np.random.default_rng(seed).permutation(num_slots).astype(np.int64)


def _pulled(kv, keys) -> bytes:
    return np.asarray(kv.wait_pull(kv.pull(kv.request(channel=0), keys=keys))).tobytes()


def test_rejects_non_bijection():
    kv = _store(name="rej")
    with pytest.raises(ValueError, match="bijection"):
        kv.migrate(np.zeros(kv.num_slots, dtype=np.int64))
    with pytest.raises(ValueError, match="bijection"):
        kv.migrate(np.arange(kv.num_slots - 1))
    assert kv.layout(0) is None
    kv.executor.stop()


def test_directory_remap_matches_jax_and_drops_stale_cache():
    """``set_remap`` composes as the JAX directory's does, the sentinel
    passes through, and a slot tensor cached before a flip is never
    served after it, even when it was computed before the flip and
    stored after."""
    keys = np.array([5, 40, 77, 3, 1000], dtype=np.int64)  # 1000: a miss
    exact = np.arange(0, 200, 5, dtype=np.int64)
    j = JKeyDirectory(64, keys=exact, hashed=False)
    t = KeyDirectory(64, keys=exact, hashed=False)
    before = t.slots_device(keys, "cpu").clone()
    for seed in (1, 2):
        p = _perm(64, seed)
        j.set_remap(p)
        t.set_remap(p)
        np.testing.assert_array_equal(t.slots(keys), j.slots(keys))
        np.testing.assert_array_equal(t.slots_device(keys, "cpu").numpy(), j.slots(keys))
    assert t.slots(keys)[-1] == 64  # the miss sentinel, untouched
    assert not torch.equal(t.slots_device(keys, "cpu"), before)

    # a flip while a miss computes: that call is served its own result,
    # the entry is not stored, and the next call maps afresh
    h = KeyDirectory(128, hashed=True)
    jh = JKeyDirectory(128, hashed=True)
    p = _perm(128, 3)
    base = h._base_slots

    def racing(k):
        out = base(k)
        h.set_remap(p)
        return out

    h._base_slots = racing
    stale = h.slots_device(keys, "cpu")
    h._base_slots = base
    jh.set_remap(p)
    np.testing.assert_array_equal(stale.numpy(), JKeyDirectory(128, hashed=True).slots(keys))
    np.testing.assert_array_equal(h.slots_device(keys, "cpu").numpy(), jh.slots(keys))


def test_bit_parity_vs_undisturbed_hashed(mesh1, route):
    """Migrating mid-stream leaves the base-layout table bit-identical to
    a run that never migrated, and to the JAX store migrated the same
    way, on colliding hashed slots."""
    batches = list(_colliding(6))
    perm = _perm(64)

    def run(kv, migrate_at):
        for i, (keys, vals) in enumerate(batches):
            if i == migrate_at:
                mig = kv.migrate(perm)
                assert mig["rows_moved"] > 0 and mig["attempts"] == 1
            kv.push(kv.request(channel=0), keys=keys, values=vals)
        kv.executor.wait_all(pop=False)
        return kv.get_replica()[0]

    undisturbed = run(_store(name="und"), None)
    migrated = run(_store(name="mig"), 3)
    jax_migrated = run(_jstore(mesh1, name="jmig"), 3)
    assert undisturbed.tobytes() == migrated.tobytes() == jax_migrated.tobytes()


@pytest.mark.parametrize("op", ["push", "push_pull", "pull"])
def test_slots_resolved_before_a_flip_are_resolved_again(mesh1, op):
    """A push or pull resolves its slots outside ``remap_lock`` (the hash
    pass does not serialize callers); a migration that flips between that
    and the submit makes it resolve again under the lock, so it lands on
    the moved rows. The base-layout table and the answer equal the JAX
    store's, which never migrated, bit for bit."""
    batches = list(_colliding(3))
    kv = _store(name=f"race_{op}")
    jref = _jstore(mesh1, name=f"race_ref_{op}")
    _push_all(kv, batches[:2])
    _push_all(jref, batches[:2])
    d = kv.channel(0).directory

    def racing(keys, device):
        out = d.__class__.slots_device_at(d, keys, device)
        del d.slots_device_at  # once
        kv.migrate(_perm(kv.num_slots, seed=9))
        return out

    d.slots_device_at = racing
    keys, vals = batches[2]
    if op == "pull":
        got = kv.wait_pull(kv.pull(kv.request(channel=0), keys=keys))
        want = jref.wait_pull(jref.pull(jref.request(channel=0), keys=keys))
    elif op == "push_pull":
        got = kv.wait_pull(kv.push_pull(kv.request(channel=0), keys=keys, values=vals))
        want = jref.wait_pull(jref.push_pull(jref.request(channel=0), keys=keys, values=vals))
    else:
        got = want = np.zeros(0)
        _push_all(kv, [(keys, vals)])
        _push_all(jref, [(keys, vals)])
    kv.executor.wait_all(pop=False)
    assert "slots_device_at" not in vars(d) and kv.layout(0) is not None
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    assert kv.get_replica()[0].tobytes() == np.asarray(jref.get_replica()[0]).tobytes()


def test_pull_routing_and_values_survive_migration_exact_dir(mesh1):
    """Exact directory: pulls by key return the same bytes before and
    after the move, the physical table really is permuted, and both
    layouts equal the JAX store's."""
    keys = np.arange(40, dtype=np.int64)
    stream = [(keys, b) for _, b in _batches(3, n_keys=40)]
    kv = _store(hashed=False, name="exact", keys=keys)
    jkv = _jstore(mesh1, hashed=False, name="jexact", keys=keys)
    _push_all(kv, stream)
    _push_all(jkv, stream)
    before = _pulled(kv, keys)
    perm = _perm(kv.num_slots, seed=5)
    mig = kv.migrate(perm)
    jkv.migrate(perm)
    assert mig["attempts"] == 1 and kv.layout(0) is not None
    assert _pulled(kv, keys) == before == _pulled(jkv, keys)
    base = kv.get_replica()[0]
    cur = kv.table(0, copy=True).numpy()
    assert base.tobytes() != cur.tobytes()
    np.testing.assert_array_equal(cur[kv.layout(0)], base)
    assert cur.tobytes() == np.asarray(jkv.table(0, copy=True)).tobytes()


def test_composed_migrations_stack(mesh1):
    """Two migrations compose (``perm2[perm1]``); ``layout()`` equals the
    JAX store's, and pulls and the base-layout replica equal an
    undisturbed run's."""
    keys = np.arange(40, dtype=np.int64)
    batches = _batches(4, n_keys=40)
    kv = _store(hashed=False, name="twice", keys=keys)
    jkv = _jstore(mesh1, hashed=False, name="jtwice", keys=keys)
    for store in (kv, jkv):
        _push_all(store, [(keys, b) for _, b in batches[:2]])
        store.migrate(_perm(kv.num_slots, seed=1))
        _push_all(store, [(keys, b) for _, b in batches[2:]])
        store.migrate(_perm(kv.num_slots, seed=2))
    np.testing.assert_array_equal(kv.layout(0), jkv.layout(0))
    ref = _store(hashed=False, name="twice_ref", keys=keys)
    _push_all(ref, [(keys, b) for _, b in batches])
    assert kv.get_replica()[0].tobytes() == ref.get_replica()[0].tobytes()
    assert kv.get_replica()[0].tobytes() == np.asarray(jkv.get_replica()[0]).tobytes()
    assert _pulled(kv, keys) == _pulled(ref, keys)
    assert kv.channel(0).migrations == 2


def test_snapshot_roundtrip_across_migration(mesh1):
    """Backups are in the base layout: one taken before a move restores
    after it, and a JAX store's backup installs into the migrated port
    store."""
    keys = np.arange(40, dtype=np.int64)
    batches = _batches(3, n_keys=40)
    kv = _store(hashed=False, name="roundtrip", keys=keys)
    _push_all(kv, [(keys, b) for _, b in batches])
    snap = kv.get_replica()
    kv.migrate(_perm(kv.num_slots, seed=9))
    kv.set_replica(snap)
    kv.executor.wait_all(pop=False)
    assert kv.get_replica()[0].tobytes() == snap[0].tobytes()
    ref = _store(hashed=False, name="roundtrip_ref", keys=keys)
    _push_all(ref, [(keys, b) for _, b in batches])
    assert _pulled(kv, keys) == _pulled(ref, keys)
    jkv = _jstore(mesh1, hashed=False, name="jroundtrip", keys=keys)
    _push_all(jkv, [(keys, b) for _, b in batches[:2]])
    kv.set_replica(jkv.get_replica())
    assert kv.get_replica()[0].tobytes() == np.asarray(jkv.get_replica()[0]).tobytes()
    assert _pulled(kv, keys) == _pulled(jkv, keys)


def test_pushes_landing_mid_migration_replay_bit_identically(mesh1, route):
    """The migration stalls between its snapshot and its install
    (``rebalance.migrate``) while pushes land: they are journaled as
    copies (the caller's value buffer is rewritten after each push) and
    replay past the barrier with translated slots; the table equals the
    undisturbed JAX run's bit for bit."""
    keys = np.arange(40, dtype=np.int64)
    batches = _batches(4, n_keys=40)
    kv = _store(hashed=False, name="journal", keys=keys)
    _push_all(kv, [(keys, batches[0][1])])

    faults.arm("rebalance.migrate", kind="delay", delay_s=0.5, once=True)
    result = {}
    t = threading.Thread(target=lambda: result.update(kv.migrate(_perm(kv.num_slots, seed=4))))
    t.start()
    time.sleep(0.1)  # the migration reaches its stalled window
    buf = np.empty((40, 2), np.float32)  # one buffer, reused as a staging ring is
    for _, vals in batches[1:]:
        buf[:] = vals
        kv.executor.wait(kv.push(kv.request(channel=0), keys=keys, values=buf))
        buf[:] = np.nan
    t.join(timeout=30)
    assert not t.is_alive()
    kv.executor.wait_all(pop=False)
    assert result["journaled"] >= 1
    assert result["replayed"] == result["journaled"]

    jref = _jstore(mesh1, hashed=False, name="journal_ref", keys=keys)
    _push_all(jref, [(keys, b) for _, b in batches])
    assert kv.get_replica()[0].tobytes() == np.asarray(jref.get_replica()[0]).tobytes()


def test_push_pull_is_journaled_too(mesh1):
    """A fused push_pull landing mid-migration replays like a push."""
    keys = np.arange(40, dtype=np.int64)
    batches = _batches(3, n_keys=40)
    kv = _store(hashed=False, name="journal_pp", keys=keys)
    _push_all(kv, [(keys, batches[0][1])])
    faults.arm("rebalance.migrate", kind="delay", delay_s=0.4, once=True)
    result = {}
    t = threading.Thread(target=lambda: result.update(kv.migrate(_perm(kv.num_slots, seed=7))))
    t.start()
    time.sleep(0.1)
    for _, vals in batches[1:]:
        kv.wait_pull(kv.push_pull(kv.request(channel=0), keys=keys, values=vals))
    t.join(timeout=30)
    assert result["replayed"] == result["journaled"] >= 1
    jref = _jstore(mesh1, hashed=False, name="journal_pp_ref", keys=keys)
    _push_all(jref, [(keys, b) for _, b in batches])
    assert kv.get_replica()[0].tobytes() == np.asarray(jref.get_replica()[0]).tobytes()


def test_pull_stream_across_migration_completes_every_request():
    """Pulls issued while the migration stalls and flips all return the
    pre-migration bytes (no pushes meanwhile, so any other answer is a
    routing fault) and none fails."""
    keys = np.arange(40, dtype=np.int64)
    kv = _store(hashed=False, name="serve", keys=keys)
    _push_all(kv, [(keys, b) for _, b in _batches(2, n_keys=40)])
    expect = _pulled(kv, keys)

    faults.arm("rebalance.migrate", kind="delay", delay_s=0.4, once=True)
    done = threading.Event()
    stats = {"ok": 0, "failed": 0}

    def serve():
        while not done.is_set():
            try:
                assert _pulled(kv, keys) == expect
                stats["ok"] += 1
            except Exception:
                stats["failed"] += 1

    server = threading.Thread(target=serve)
    server.start()
    try:
        mig = kv.migrate(_perm(kv.num_slots, seed=6))
    finally:
        done.set()
        server.join(timeout=30)
    assert mig["attempts"] == 1
    assert stats["failed"] == 0
    assert stats["ok"] > 0


def test_restore_landing_mid_migration_forces_resnapshot(mesh1):
    """A recovery during a live migration bumps the generation; the
    stalled migration discards its image and snapshots again, and the
    table equals the same timeline without a migration, and the JAX
    store's migrated timeline, bit for bit."""
    from parameter_server_tpu.parameter.replica import ReplicaManager as JReplicaManager

    keys = np.arange(40, dtype=np.int64)
    batches = _batches(6, n_keys=40)

    def timeline(kv, rm, fmod, migrate):
        _push_all(kv, [(keys, b) for _, b in batches[:2]])
        rm.backup_consistent(kv)
        result = {}
        t = None
        if migrate:
            fmod.arm("rebalance.migrate", kind="delay", delay_s=0.6, once=True)
            t = threading.Thread(target=lambda: result.update(
                kv.migrate(_perm(kv.num_slots, seed=8))))
            t.start()
            time.sleep(0.1)  # the migration is stalled past its snapshot
        _push_all(kv, [(keys, batches[2][1])])  # wiped by the recovery
        assert rm.recover(kv, through_executor=True)
        for _, vals in batches[3:]:  # acknowledged after it: must survive
            kv.push(kv.request(channel=0), keys=keys, values=vals)
        if t is not None:
            t.join(timeout=30)
            assert not t.is_alive()
        kv.executor.wait_all(pop=False)
        return result

    ref = _store(hashed=False, name="rec_ref", keys=keys)
    timeline(ref, ReplicaManager(), faults, migrate=False)
    kv = _store(hashed=False, name="rec_mig", keys=keys)
    result = timeline(kv, ReplicaManager(), faults, migrate=True)
    assert result["attempts"] >= 2  # the stale image was discarded
    assert kv.layout(0) is not None  # and the move still landed
    assert kv.get_replica()[0].tobytes() == ref.get_replica()[0].tobytes()
    jkv = _jstore(mesh1, hashed=False, name="jrec_mig", keys=keys)
    timeline(jkv, JReplicaManager(), jfaults, migrate=True)
    assert kv.get_replica()[0].tobytes() == np.asarray(jkv.get_replica()[0]).tobytes()


def test_migrate_gives_up_after_max_attempts():
    kv = _store(name="giveup")
    _push_all(kv, list(_colliding(1)))
    orig = kv.snapshot

    def poisoned(ch=0, callback=None):
        kv.note_external_restore()  # every snapshot is born stale
        return orig(ch, callback)

    kv.snapshot = poisoned
    with pytest.raises(RuntimeError, match="could not complete"):
        kv.migrate(_perm(kv.num_slots), max_attempts=2)
    kv.snapshot = orig
    kv.executor.wait_all(pop=False)
    assert kv.layout(0) is None
    assert kv.channel(0).journal is None  # the journal closed with the last attempt


def test_write_to_file_identical_to_jax_after_migration(mesh1, tmp_path):
    """``write_to_file`` writes base-layout rows: the exact directory's
    keys line up with their values after a move, in the JAX store's text."""
    keys = np.array([3, 8, 17, 40, 99, 150], dtype=np.int64)
    stream = [(keys, b) for _, b in _batches(2, n_keys=len(keys), seed=9)]
    kv = _store(hashed=False, name="dump", keys=keys)
    jkv = _jstore(mesh1, hashed=False, name="jdump", keys=keys)
    perm = _perm(kv.num_slots, seed=12)
    for store in (kv, jkv):
        _push_all(store, stream[:1])
        store.migrate(perm)
        _push_all(store, stream[1:])
    kv.write_to_file(str(tmp_path / "t.txt"))
    jkv.write_to_file(str(tmp_path / "j.txt"))
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text()
    assert len(text.splitlines()) == len(keys)
