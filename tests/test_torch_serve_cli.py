"""PyTorch port: the serve CLI (``apps/serve/main.py``) against the JAX
package's, on the CPU.

Both CLIs run at ``--num-slots 4096 --duration 0.2`` and print the same
records: the same metric names in the same order, the same keys in each
record, and the same non-timing fields (the replica mode, the worker
count, the flags echoed). The values served are held to the JAX
frontend's in ``tests/test_torch_serving.py``; here the CLI's own table
is held to the JAX CLI's: the same warm push from the same seed.
"""

import json

import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.serve import main as jmain
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch.apps.serve import main as tmain
from parameter_server_tpu_torch.system.postoffice import Postoffice

torch.set_num_threads(1)

ARGS = ["--num-slots", "4096", "--duration", "0.2"]


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    Postoffice.reset()
    JPostoffice.reset()


def _records(capsys, fn, argv):
    assert fn(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


TIMING = {"value", "offered_rate", "achieved_offered_rate", "duration_s", "offered", "accepted",
          "completed", "shed_rate", "shed_queue", "shed_frac", "goodput_per_sec", "latency_ms",
          "admission_rate", "age_s", "in_flight", "coalescer", "replica"}


@pytest.mark.parametrize("replica", ["full", "off"])
def test_records_match_the_jax_cli(capsys, replica):
    argv = ARGS + ["--replica", replica]
    theirs = _records(capsys, jmain.main, argv)
    ours = _records(capsys, tmain.main, argv + ["--device", "cpu"])
    assert [r["metric"] for r in ours] == [r["metric"] for r in theirs] == [
        "serve_closed_loop_capacity", "serve_open_loop_point", "serve_open_loop_point",
        "serve_frontend_stats"]
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k not in TIMING} == {
            k: v for k, v in b.items() if k not in TIMING}
    stats, jstats = ours[-1], theirs[-1]
    assert list(stats["coalescer"]) == list(jstats["coalescer"])
    if replica == "full":
        assert list(stats["replica"]) == list(jstats["replica"])
        assert stats["replica"]["nbytes"] == jstats["replica"]["nbytes"] == 4096 * 4
        assert stats["replica"]["device"] is False
    for p in ours[1:3]:
        assert p["n_errors"] == 0 and p["completed"] == p["accepted"]
    assert ours[2]["shed_frac"] > 0  # the 3x point sheds under admission


def test_warm_table_equals_the_jax_cli(capsys):
    """The CLI's table after its warm push, bit-equal to the JAX CLI's
    (the same seed, the same 2^14 draws, colliding slots included)."""
    from parameter_server_tpu.parallel.mesh import make_mesh
    from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector

    kv, rng = tmain.warm_store(4096, 1 << 24, 0, "cpu")
    jkv = JKVVector(mesh=make_mesh(num_data=1, num_server=1), k=1, num_slots=4096, hashed=True)
    jrng = np.random.default_rng(0)
    warm = np.unique(jrng.integers(0, 1 << 24, 1 << 14))
    jkv.wait(jkv.push(jkv.request(channel=0), keys=warm,
                      values=jrng.normal(size=(len(warm), 1)).astype(np.float32)))
    assert len(warm) > 4096  # more keys than slots: slots are shared
    assert np.array_equal(np.asarray(jkv.table(0)).view(np.uint32),
                          kv.table(0).numpy().view(np.uint32))
    u = jrng.random((512, 32))
    np.testing.assert_array_equal(tmain.request_pool(rng, 32, 1 << 24),
                                  (u * u * u * (1 << 24)).astype(np.int64))
    kv.executor.stop()


def test_decode_lane_and_training_through_the_cli(capsys):
    recs = _records(capsys, tmain.main, ARGS + [
        "--device", "cpu", "--replica", "hot", "--train-while-serving", "--decode",
        "--batch-slots", "4", "--gamma", "2"])
    by = {r["metric"]: r for r in recs}
    assert [r["metric"] for r in recs] == [
        "serve_closed_loop_capacity", "serve_open_loop_point", "serve_open_loop_point",
        "serve_decode_latency_ms", "serve_frontend_stats"]
    dec = by["serve_decode_latency_ms"]
    assert dec["draft"] == "random" and dec["tokens_per_request"] == 128 and dec["gamma"] == 2
    assert dec["batcher"]["joins"] == dec["batcher"]["retired"] == 16  # 4 requests x 4 rows
    assert 0.0 <= dec["accepted_frac"] <= 1.0
    for p in recs[1:3]:
        assert p["train_while_serving"] is True and p["n_errors"] == 0
        assert p["completed"] == p["accepted"]
    assert by["serve_frontend_stats"]["degraded_served"] == 0
    assert by["serve_frontend_stats"]["batcher"] == dec["batcher"]


def test_sequential_decode_lane(capsys):
    recs = _records(capsys, tmain.main, ARGS + ["--device", "cpu", "--decode", "--gamma", "2"])
    dec = [r for r in recs if r["metric"] == "serve_decode_latency_ms"][0]
    assert "batcher" not in dec and dec["value"] > 0


def test_failed_push_stream_fails_the_cli(monkeypatch):
    """A push that raises on the trainer thread fails the CLI after the
    load window, instead of leaving the table quietly still."""
    import threading

    from parameter_server_tpu_torch.parameter.kv_vector import KVVector

    push = KVVector.push

    def failing_push(self, *a, **kw):
        if threading.current_thread().name == "serve-trainer":
            raise OSError("push lost")
        return push(self, *a, **kw)

    monkeypatch.setattr(KVVector, "push", failing_push)
    with pytest.raises(RuntimeError, match="push stream failed") as e:
        tmain.main(ARGS + ["--device", "cpu", "--replica", "off", "--train-while-serving"])
    assert isinstance(e.value.__cause__, OSError)
