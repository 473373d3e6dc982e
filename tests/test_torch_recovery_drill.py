"""PyTorch port: the kill-one-shard recovery drill
(``benchmarks/components.py::recovery_drill``) on the CPU, against the
JAX package's drill.

The smoke drill (2^10 slots, 120 batches) runs on the CPU with
``device="cpu"``: correctness fields only, no assertion on a wall time
(the times depend on the host's load). The undisturbed table the drill
holds itself to is compared bit for bit with a JAX ``KVVector`` on a 1x1
mesh fed the same ``_drill_batch`` stream (both add a slot's entries in
entry order), and the record's fields with the JAX record's names.
"""

import numpy as np
import pytest
import torch

from parameter_server_tpu.benchmarks import components as jcomp
from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch.benchmarks import components as tcomp
from parameter_server_tpu_torch.ops import kv_ops
from parameter_server_tpu_torch.system.postoffice import Postoffice

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    Postoffice.reset()
    JPostoffice.reset()


def _keys(rec, prefix=""):
    """Every key path of a nested record, down to the fixed sections."""
    out = set()
    for k, v in rec.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k in ("config", "serve", "update_accounting",
                                         "disarmed_overhead"):
            out |= _keys(v, prefix + k + "/")
    return out


def test_drill_batch_equals_jax():
    for i in (0, 1, 57):
        jk, jv = jcomp._drill_batch(7, i, 1 << 16, 64, 4)
        tk, tv = tcomp._drill_batch(7, i, 1 << 16, 64, 4)
        assert np.array_equal(jk, tk) and jv.tobytes() == tv.tobytes()


def test_undisturbed_table_bit_equal_to_jax_store():
    shape = tcomp.drill_shape(True)
    jkv = JKVVector(mesh=make_mesh(num_data=1, num_server=1), k=tcomp.DRILL_K,
                    num_slots=shape["num_slots"], hashed=True, name="jdrill_ref")
    for i in range(shape["n_batches"]):
        keys, vals = jcomp._drill_batch(tcomp.DRILL_SEED, i, tcomp.DRILL_KEY_SPACE,
                                        tcomp.DRILL_KEYS_PER_BATCH, tcomp.DRILL_K)
        jkv.executor.wait(jkv.push(jkv.request(channel=0), keys=keys, values=vals))
    want = np.asarray(jkv.table(0, copy=True))
    got = tcomp.undisturbed_table(smoke=True, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert np.count_nonzero(got) > 0


@pytest.fixture(scope="module")
def drill_record():
    """One smoke drill on the CPU, read by the tests below; its
    ``on_live`` events are kept with the count of table pushes
    (``kv_ops.push_donated`` calls) made by then."""
    Postoffice.reset()
    real = kv_ops.push_donated
    pushes = [0]
    events = []

    def counted(*args, **kwargs):
        pushes[0] += 1
        return real(*args, **kwargs)

    kv_ops.push_donated = counted
    try:
        out = tcomp.recovery_drill(smoke=True, device="cpu",
                                   on_live=lambda event: events.append((event, pushes[0])))
        return dict(out, on_live_events=events)
    finally:
        kv_ops.push_donated = real
        Postoffice.reset()


def test_recovery_drill_smoke_loses_no_acknowledged_update(drill_record):
    """Injected shard death under live train and serve load, detected and
    recovered with no acknowledged update lost: the drilled table bit
    for bit the undisturbed one, the trainer parked mid-stream, serving
    degraded and never failed, the replayed keys metered."""
    out = drill_record
    assert out["trajectory_bit_identical"] is True
    assert out["trainer_parked"] is True
    assert out["replayed_updates"] >= 1
    assert out["acked_updates"] == tcomp.drill_shape(True)["n_batches"]
    assert out["detection_ms"] > 0 and out["mttr_ms"] >= out["detection_ms"]
    serve = out["serve"]
    assert serve["requests"] > 0 and serve["failed"] == 0
    assert serve["degraded_served"] >= 1
    assert out["backup_version_used"] >= 1 and out["barrier_ts"] >= 0
    acct = out["update_accounting"]
    assert acct["metered_matches"] and acct["replayed_updates"] == out["replayed_updates"]
    assert out["blackbox"]["captured"] is not False
    assert out["blackbox"]["trigger"]["kind"] == "node_death"
    assert out["disarmed_overhead"]["ratio_median"] > 0


def test_on_live_brackets_the_drilled_stores_pushes_alone(drill_record):
    """``on_live`` fires "start" after the reference run and "end" before
    the overhead pair: between them the table pushes are the drilled
    store's acknowledged updates and replays, and nothing else (a caller
    reads the kernel counters there)."""
    events = drill_record["on_live_events"]
    assert [e for e, _ in events] == ["start", "end"]
    n_batches = tcomp.drill_shape(True)["n_batches"]
    assert events[0][1] == n_batches  # the reference run came first
    assert events[1][1] - events[0][1] == n_batches + drill_record["replayed_updates"]


def test_record_has_the_jax_records_fields(drill_record):
    theirs = jcomp.recovery_drill(smoke=True)
    assert _keys(drill_record) - {"on_live_events"} == _keys(theirs)
    assert drill_record["config"] == theirs["config"]
