"""PyTorch port: the host side of the main path on the card.

These tests need an NVIDIA GPU (``cuda`` marker; they skip elsewhere).
The card has no JAX, so this file imports none (``tests/conftest.py``
does: run it with ``python -m pytest --noconftest
tests/test_torch_host_cuda.py``).

- The uploader's route: host arrays copied into pinned staging buffers
  and sent in one non-blocking copy on a side stream, bit-equal to a
  plain ``.to("cuda")``; a staging buffer is never rewritten before the
  event of its last copy has completed.
- The executor waits on a step's CUDA work through an event recorded
  after the step on its stream.
- The pipelined train on the card leaves the serial train's state bits.

Tolerance: none; every comparison is exact.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.system import executor as texecutor
from parameter_server_tpu_torch.utils import sparse as tsparse

pytestmark = pytest.mark.cuda

MB, KEYS, NNZ, SLOTS = 256, 1 << 14, 39, 1 << 12


def make_batch(seed, n=MB):
    b = tsparse.random_sparse(n, KEYS, NNZ, seed=seed, binary=True)
    b.y = np.where((b.indices.reshape(n, -1) % 1024 < 256).mean(1) > 0.24, 1.0, -1.0).astype(np.float32)
    return b


def _conf(update, steps):
    c = tcfg.Config()
    c.penalty = tcfg.PenaltyConfig(type="l1", lambda_=[1.0])
    c.learning_rate = tcfg.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = tcfg.SGDConfig(algo="ftrl", minibatch=MB, num_slots=SLOTS, max_delay=0,
                                 update=update, steps_per_launch=steps)
    return c


def _assert_same_bits(a, b):
    for k in a.state:
        x, y = a.state[k], b.state[k]
        assert torch.equal(x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32),
                           y.view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32)), k
    assert a.progress.objective == b.progress.objective
    assert a.progress.auc == b.progress.auc


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_pinned_side_stream_upload_equals_a_plain_copy(card):
    w = tsgd.AsyncSGDWorker(_conf("sparse", 1), device=card)
    for seed in range(3):
        host = w.prep(make_batch(seed), device_put=False)
        staged = w.upload(host, w.upload_stream)
        staged.ready.synchronize()
        for f in dataclasses.fields(host):
            plain = torch.as_tensor(getattr(host, f.name)).to("cuda")
            got = getattr(staged, f.name)
            assert got.dtype == plain.dtype and got.shape == plain.shape
            assert torch.equal(got, plain), f.name
    assert all(b.is_pinned() for b in w.staging.buffers if b is not None)


def test_a_staging_buffer_is_not_rewritten_before_its_copy(card):
    """The side stream is held busy, so each copy waits there while the
    host stages the next batches into the same two buffers: every device
    batch must still hold its own host batch's values."""
    w = tsgd.AsyncSGDWorker(_conf("sparse", 1), device=card)
    stream = w.upload_stream
    hosts = [w.prep(make_batch(seed), device_put=False) for seed in range(6)]
    with torch.cuda.stream(stream):
        torch.cuda._sleep(100_000_000)  # ~50 ms before the first copy runs
    staged = [w.upload(h, stream) for h in hosts]
    torch.cuda.synchronize()
    for h, s in zip(hosts, staged):
        for f in dataclasses.fields(h):
            assert torch.equal(getattr(s, f.name).cpu(), torch.as_tensor(getattr(h, f.name))), f.name


@pytest.mark.parametrize("update,steps", [("sparse", 8), ("dense", 1)])
def test_pipelined_train_on_the_card_is_bit_identical_to_serial(card, update, steps):
    batches = [make_batch(i) for i in range(17)]
    ws = [tsgd.AsyncSGDWorker(_conf(update, steps), device=card) for _ in range(2)]
    ws[0].train(iter(batches), pipelined=False)
    ws[1].train(iter(batches), pipelined=True)
    _assert_same_bits(*ws)


def test_wait_waits_for_the_steps_cuda_work(card):
    """A step that launches a long kernel returns at once; ``wait``
    returns only when the kernel is done (its event, recorded after the
    step on the dispatch thread's stream, has completed)."""
    ex = texecutor.Executor(max_in_flight=1)
    x = torch.ones(1 << 20, device="cuda")
    marks = []

    def step():
        torch.cuda._sleep(200_000_000)  # ~0.1 s of device time
        y = x * 2
        marks.append(torch.cuda.Event())
        marks[-1].record()
        return {"y": y}

    t0 = time.perf_counter()
    ts = ex.submit(step)
    y = ex.wait(ts)["y"]
    assert marks[0].query(), "wait returned before the step's kernels finished"
    assert time.perf_counter() - t0 > 0.02
    assert float(y.sum()) == 2.0 * (1 << 20)
    ex.stop()
