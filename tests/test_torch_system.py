"""PyTorch port: the system core (message, retry, faults, customer,
manager, van, postoffice) against the JAX package's modules.

Pickled headers name their package's module, so a frame of the port
cannot equal a frame of the JAX package: the round trip and the
restricted unpickler's refusals are held instead. The retry backoffs and
the fault registry's firing decisions are held equal to the JAX
modules' on the same seeds.
"""

import pickle
import random
import struct
import threading

import numpy as np
import pytest
import torch

from parameter_server_tpu.system import faults as jfaults
from parameter_server_tpu.utils import retry as jretry
from parameter_server_tpu_torch import ps
from parameter_server_tpu_torch.system import faults, manager
from parameter_server_tpu_torch.system.customer import Customer
from parameter_server_tpu_torch.system.executor import Executor
from parameter_server_tpu_torch.system.executor import Task as ExecutorTask
from parameter_server_tpu_torch.system.message import (
    Command,
    FilterSpec,
    Message,
    Task,
    slice_message,
)
from parameter_server_tpu_torch.system.postoffice import Postoffice
from parameter_server_tpu_torch.system.van import init_distributed
from parameter_server_tpu_torch.utils import retry
from parameter_server_tpu_torch.utils.range import Range

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    Postoffice.reset()


def _msg():
    return Message(task=Task(filters=[FilterSpec(type="compressing")], cmd=Command.SAVE_MODEL),
                   sender="W0", recver="S0", key=np.arange(4, dtype=np.int64),
                   values=[np.ones(3, np.float32), np.arange(6, dtype=np.int32).reshape(2, 3)])


class TestMessage:
    def test_one_task_serves_executor_and_message(self):
        assert ExecutorTask is Task
        ex = Executor(name="t")
        ts = ex.submit(lambda: 7, Task(time=5, wait_time=[], key_channel=3))
        assert ts == 5 and ex.wait(ts) == 7
        ex.stop()

    def test_roundtrip(self):
        m = Message.from_bytes(_msg().to_bytes())
        assert m.sender == "W0" and m.recver == "S0"
        assert m.task.filters[0].type == "compressing" and m.task.cmd is Command.SAVE_MODEL
        np.testing.assert_array_equal(m.key, np.arange(4))
        np.testing.assert_array_equal(m.values[1], np.arange(6).reshape(2, 3))
        assert m.values[1].dtype == np.int32

    def test_task_payload_roundtrip(self):
        m = Message(task=Task(payload={"r": Range(3, 9), "x": np.float64(2.5)}))
        out = Message.from_bytes(m.to_bytes())
        assert out.task.payload["r"] == Range(3, 9) and out.task.payload["x"] == 2.5

    def test_truncated_and_flipped_frames_are_value_errors(self):
        blob = _msg().to_bytes()
        for cut in (0, 2, len(blob) // 2, len(blob) - 1):
            with pytest.raises(ValueError):
                Message.from_bytes(blob[:cut])
        bad = bytearray(blob)
        bad[0] = 0xFF
        with pytest.raises(ValueError):
            Message.from_bytes(bytes(bad))

    def test_reduce_payload_rejected(self):
        evil = pickle.dumps((__import__("os").system, ("true",)))
        with pytest.raises(ValueError, match="forbidden global|malformed"):
            Message.from_bytes(struct.pack("<I", len(evil)) + evil)

    @pytest.mark.parametrize("module,name", [
        ("os", "system"),
        ("parameter_server_tpu_torch.native", "subprocess.run"),
        ("parameter_server_tpu_torch.native", "library"),
        ("numpy", "save"),
        ("numpy.ctypeslib", "load_library"),
        ("numpy", "memmap"),
        ("parameter_server_tpu_torch.system.customer", "Customer"),
        # the JAX package's wire types are not the port's
        ("parameter_server_tpu.system.message", "Task"),
    ])
    def test_unpickler_bypasses_rejected(self, module, name):
        frame = (pickle.PROTO + bytes([4])
                 + pickle.SHORT_BINUNICODE + bytes([len(module)]) + module.encode()
                 + pickle.SHORT_BINUNICODE + bytes([len(name)]) + name.encode()
                 + pickle.STACK_GLOBAL + pickle.STOP)
        with pytest.raises(ValueError, match="forbidden|malformed"):
            Message.from_bytes(struct.pack("<I", len(frame)) + frame)

    @pytest.mark.parametrize("trace", [{"flow": "evil"}, {"other": 1}, [1, 2],
                                       {"node": "x" * 100}, {"t_send": 1e20}])
    def test_hostile_trace_rejected(self, trace):
        m = _msg()
        m.task.trace = trace
        with pytest.raises(ValueError):
            Message.from_bytes(m.to_bytes())

    def test_fresh_copy_isolates_filter_extra(self):
        t = Task(filters=[FilterSpec(type="compressing")])
        c = t.fresh_copy()
        c.filters[0].extra["meta"] = ["poison"]
        assert "meta" not in t.filters[0].extra

    def test_slice_message_matches_jax(self):
        from parameter_server_tpu.system import message as jmsg
        from parameter_server_tpu.utils.range import Range as JRange

        keys = np.array([1, 4, 9, 10, 17, 30], np.int64)
        vals = np.arange(12, dtype=np.float32)
        ranges = [(0, 5), (5, 17), (17, 64)]
        ours = slice_message(Message(key=keys, values=[vals]), [Range(*r) for r in ranges])
        theirs = jmsg.slice_message(jmsg.Message(key=keys, values=[vals]),
                                    [JRange(*r) for r in ranges])
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.key, b.key)
            np.testing.assert_array_equal(a.values[0], b.values[0])
            assert (a.task.key_range.begin, a.task.key_range.end) == (b.task.key_range.begin,
                                                                        b.task.key_range.end)


class TestRetry:
    @pytest.mark.parametrize("seed", [0, 1, 12345])
    def test_backoffs_equal_jax(self, seed):
        kw = dict(max_attempts=6, base_delay_s=0.01, max_delay_s=0.2, jitter=0.3)
        got = {}
        for name, mod in (("port", retry), ("jax", jretry)):
            sleeps = []
            calls = [0]

            def fn():
                calls[0] += 1
                if calls[0] < 6:
                    raise OSError("flaky")
                return calls[0]

            assert mod.call_with_retry(fn, mod.RetryPolicy(**kw), seed=seed,
                                       sleep=sleeps.append) == 6
            got[name] = sleeps
        assert got["port"] == got["jax"] and len(got["port"]) == 5

    def test_deadline_exceeded_is_timeout_and_carries_op(self):
        now = [0.0]
        policy = retry.RetryPolicy(max_attempts=5, base_delay_s=1.0, jitter=0.0, deadline_s=1.5)

        def boom():
            raise OSError("down")

        with pytest.raises(retry.DeadlineExceeded) as ei:
            retry.call_with_retry(boom, policy, op="probe", sleep=lambda s: None,
                                  clock=lambda: now[0])
        assert isinstance(ei.value, TimeoutError) and ei.value.op == "probe"
        d = retry.Deadline(2.0, clock=lambda: now[0])
        now[0] = 3.0
        assert d.expired() and retry.Deadline(None).remaining() is None

    def test_non_retryable_propagates_at_once(self):
        calls = []

        def fn():
            calls.append(1)
            raise KeyError("no")

        with pytest.raises(KeyError):
            retry.call_with_retry(fn, retry.RetryPolicy(retry_on=(OSError,)),
                                  sleep=lambda s: None)
        assert len(calls) == 1


class TestFaults:
    @pytest.mark.parametrize("seed", [0, 7, 2024])
    def test_firing_pattern_equals_jax(self, seed):
        kw = dict(after_n_calls=3, probability=0.4, delay_s=0.0)
        pats = {}
        for name, mod in (("port", faults), ("jax", jfaults)):
            reg = mod.FaultRegistry(seed=seed)
            reg.arm("serve.pull", "raise", **kw)
            reg.arm("van.transfer", "drop", match="S0", probability=0.5)
            pats[name] = [(reg.check("serve.pull") is not None,
                           reg.check("van.transfer", detail="W0->S0") is not None,
                           reg.check("van.transfer", detail="W0->S1") is not None)
                          for _ in range(200)]
        assert pats["port"] == pats["jax"]
        assert any(p[0] for p in pats["port"]) and not any(p[2] for p in pats["port"])

    def test_unknown_point_and_bad_probability_raise(self):
        with pytest.raises(ValueError, match="unknown fault point"):
            faults.arm("no_such_point")
        with pytest.raises(ValueError):
            faults.arm("serve.pull", probability=1.5)
        assert faults.POINTS == jfaults.POINTS

    def test_inject_once_and_scoped(self):
        faults.arm("serve.refresh", once=True)
        with pytest.raises(faults.FaultError, match="serve.refresh"):
            faults.inject("serve.refresh")
        assert faults.inject("serve.refresh") is None  # disarmed after once
        with faults.scoped("serve.pull", kind="stall", delay_s=0.0) as sp:
            assert faults.inject("serve.pull") is sp
        assert faults.check("serve.pull") is None and faults.default_registry().n_armed == 0


class _Echo(Customer):
    def __init__(self, name):
        super().__init__(name=name)
        self.got = []

    def process_response(self, response):
        self.got.append(response)


class TestCustomerPostoffice:
    def test_registration_ids_and_lookup(self):
        po = Postoffice.instance()
        a, b = Customer(name="a"), Customer(name="b")
        assert a.id != b.id and po.manager.get_customer(a.id) is a
        assert po.manager.find_customer_by_name("b") is b
        with pytest.raises(ValueError, match="already exists"):
            Customer(id=a.id)
        b.remove()
        assert po.manager.find_customer_by_name("b") is None
        assert Customer().name == f"customer_{a.id + 2}"  # an explicit id takes none

    def test_submit_wait_and_reply_cross_the_van(self):
        po = Postoffice.instance().start(device="cpu")
        assert po.device == torch.device("cpu") and [n.id for n in po.manager.nodes] == [
            "H0", "S0", "W0"]
        server, worker = _Echo("server"), _Echo("worker")
        ts = server.submit(lambda: 41 + 1)
        assert server.wait(ts) == 42
        req = Message(task=Task(time=ts), sender="worker", recver="server")
        server.reply(req, Message(values=[np.arange(3, dtype=np.float32)]))
        resp = worker.last_response()
        assert worker.got == [resp] and resp.task.request is False and resp.task.time == ts
        assert resp.sender == "server" and resp.recver == "worker"
        np.testing.assert_array_equal(resp.values[0], np.arange(3))
        assert po.van.wire_sent_bytes == po.van.wire_recv_bytes > 0
        server.executor.stop()
        worker.executor.stop()

    def test_van_places_on_its_device_and_counts(self):
        po = Postoffice.instance().start(device="cpu")
        t = po.van.put_table(np.zeros((8, 2), np.float32))
        po.van.put_batch(np.zeros(4, np.int64))
        assert t.device.type == "cpu" and po.van.placed_bytes == 64 + 32

    def test_van_fault_point_drops_and_duplicates(self):
        po = Postoffice.instance().start(device="cpu")
        m = _msg()
        with faults.scoped("van.transfer", kind="drop"):
            with pytest.raises(faults.FaultError):
                po.van.transfer(m)
        # the transfer stamped its trace context on the task: the frame
        # that was sent is the message as it now stands
        assert m.task.trace is not None
        n = len(m.to_bytes())
        assert po.van.wire_sent_bytes == n and po.van.wire_recv_bytes == 0
        with faults.scoped("van.transfer", kind="duplicate"):
            out = po.van.transfer(m)
        assert out.sender == "W0" and po.van.wire_recv_bytes == 2 * n

    def test_one_card_limits_raise_naming_their_items(self):
        with pytest.raises(NotImplementedError, match="A9"):
            Postoffice.instance().start(num_server=2, device="cpu")
        with pytest.raises(NotImplementedError, match="A9"):
            Postoffice.instance().start(num_data=4, device="cpu")
        with pytest.raises(NotImplementedError, match="A9"):
            init_distributed()
        # the ps.h layer's node table is the card's: H0, S0, W0
        with pytest.raises(NotImplementedError, match="A9"):
            ps.start_system(num_servers=2, device="cpu")
        with pytest.raises(NotImplementedError, match="A9"):
            ps.start_system(num_workers=2, device="cpu")

    def test_manager_node_events(self):
        m = manager.Manager()
        seen = []
        m.subscribe_nodes(lambda ev, node: seen.append((ev, node.id)))
        m.init_nodes(2, 1, Range(0, 100))
        assert [n.key_range for n in m.nodes if n.role == "server"] == [Range(0, 50),
                                                                        Range(50, 100)]
        m.add_node(manager.Node(manager.Node.WORKER, 1))
        m.remove_node("W1")
        assert seen == [("add", "W1"), ("remove", "W1")]

    def test_customer_ids_unique_across_threads(self):
        ids = []
        lock = threading.Lock()

        def make():
            c = Customer()
            with lock:
                ids.append(c.id)

        threads = [threading.Thread(target=make) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(set(ids)) == 16
