"""PyTorch port: the continuous batcher (serving/batcher.py) and the
round-stepped speculative API it drives, on the CPU.

The contract is greedy token parity: every session's output equals its
own solo ``speculative_generate`` run in the port, token for token,
whoever shared the batch and whenever they joined or left. Against the
JAX batcher, with the JAX ``init_lm`` parameters carried across
(``convert.lm_params_from_jax``, float32): the same tokens for the same
requests under the same churn. The two sides' float32 logits differ by
rounding only; ``test_tokens_equal_the_jax_batcher`` states the gap it
reads on the batched streams (teacher-forced) and holds it under 1e-4.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.models.transformer import LMConfig as JLMConfig
from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.models.transformer import init_lm as j_init_lm
from parameter_server_tpu.models.transformer import lm_forward as j_lm_forward
from parameter_server_tpu.serving import BatcherConfig as JBatcherConfig
from parameter_server_tpu.serving import ContinuousBatcher as JContinuousBatcher
from parameter_server_tpu.serving import DecodeRequest as JDecodeRequest
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.models.speculative import speculative_generate
from parameter_server_tpu_torch.models.transformer import LMConfig, lm_forward
from parameter_server_tpu_torch.parameter.kv_vector import KVVector
from parameter_server_tpu_torch.serving import (
    BatcherConfig,
    ContinuousBatcher,
    DecodeRequest,
    RejectedError,
    ServeConfig,
    ServeFrontend,
)
from parameter_server_tpu_torch.system.postoffice import Postoffice

torch.set_num_threads(1)

SHAPES = dict(target=dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64),
              draft=dict(vocab=64, d_model=16, n_heads=2, n_layers=1, d_ff=32))
TCFG, DCFG = LMConfig(**SHAPES["target"]), LMConfig(**SHAPES["draft"])
GAMMA = 2


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    yield
    Postoffice.reset()


@pytest.fixture(scope="module")
def jax_models():
    """The JAX package's random-init pair (the JAX batcher tests' seeds)."""
    tp = j_init_lm(jax.random.PRNGKey(0), JLMConfig(**SHAPES["target"]))
    dp = j_init_lm(jax.random.PRNGKey(1), JLMConfig(**SHAPES["draft"]))
    return tp, dp


@pytest.fixture(scope="module")
def models(jax_models):
    """The same parameters in the port (float32, on the CPU)."""
    tp, dp = jax_models
    return (convert.lm_params_from_jax({k: np.asarray(v) for k, v in tp.items()}, TCFG, "cpu"),
            convert.lm_params_from_jax({k: np.asarray(v) for k, v in dp.items()}, DCFG, "cpu"))


def _batcher(models, slots=4, max_prompt=8, max_new=16):
    tp, dp = models
    return ContinuousBatcher(tp, TCFG, dp, DCFG, BatcherConfig(
        slots=slots, max_prompt=max_prompt, max_new=max_new, gamma=GAMMA))


def _prompt(seed, b, p):
    return np.random.default_rng(seed).integers(0, TCFG.vocab, (b, p))


def _sequential(models, req):
    """The per-session reference: this request decoded alone."""
    tp, dp = models
    with torch.no_grad():
        return speculative_generate(tp, TCFG, dp, DCFG, req.prompt, int(req.steps), gamma=GAMMA,
                                    prompt_lengths=req.prompt_lengths,
                                    eos_id=req.eos_id).numpy()


def _drain(b, done, max_rounds=500):
    for _ in range(max_rounds):
        if b.active_sessions() == 0:
            return
        done.extend(b.step())
    raise AssertionError("batch failed to drain")


def _churn(b, reqs, block=True):
    """Sessions join in waves as slots free; returns handles in request
    order."""
    handles, pending = [], list(reqs)
    for _ in range(500):
        wave = []
        while pending and len(wave) < b.free_slots():
            wave.append((pending.pop(0), None))
        handles += b.admit_many(wave)
        b.step_block() if block else b.step()
        if not pending and b.active_sessions() == 0:
            return handles
    raise AssertionError("batch failed to drain")


class TestTokenParity:
    def test_identity_under_join_leave_churn(self, models):
        """Six sessions of different lengths and budgets through a
        4-slot batch, one admit and one round at a time: late joiners
        enter as early finishers retire."""
        reqs = [DecodeRequest(prompt=_prompt(10 + i, 1, 3 + (i % 5)), steps=4 + 3 * (i % 4))
                for i in range(6)]
        b = _batcher(models)
        b.warmup()
        done, pending, admitted = [], list(reqs), []
        for _ in range(500):
            while pending and b.free_slots() >= pending[0].prompt.shape[0]:
                admitted.append(b.admit(pending.pop(0)))
            if not pending and b.active_sessions() == 0:
                break
            done.extend(b.step())
        assert len(done) == 6 and b.stats()["joins"] == 6 and b.stats()["retired"] == 6
        for h in admitted:
            np.testing.assert_array_equal(h.out, _sequential(models, h.req))

    def test_wave_admit_and_block_step_identity(self, models):
        reqs = [DecodeRequest(prompt=_prompt(40 + i, 1, 3 + (i % 4)), steps=5 + 2 * (i % 3),
                              eos_id=(63 if i == 2 else None)) for i in range(7)]
        b = _batcher(models)
        b.warmup()
        for h in _churn(b, reqs):
            np.testing.assert_array_equal(h.out, _sequential(models, h.req))

    def test_block_step_runs_the_bounded_count_of_rounds(self, models):
        """With no eos-armed session resident, step_block runs exactly
        ceil(min_remaining / (gamma + 1)) rounds."""
        b = _batcher(models)
        b.admit_many([(DecodeRequest(prompt=_prompt(50 + i, 1, 4), steps=12), None)
                      for i in range(4)])
        before = b.stats()["rounds"]
        b.step_block()
        # after the join committed = length + 1: 11 left, at most 3 a round
        assert b.stats()["rounds"] - before == 4

    def test_multi_row_ragged_request(self, models):
        req = DecodeRequest(prompt=_prompt(3, 3, 6), steps=5, prompt_lengths=np.array([6, 3, 4]))
        b = _batcher(models)
        h = b.admit(req)
        done = []
        _drain(b, done)
        assert done == [h]
        np.testing.assert_array_equal(h.out, _sequential(models, req))

    def test_eos_retires_mid_batch_without_stalling_rest(self, models):
        short = DecodeRequest(prompt=_prompt(7, 1, 4), steps=12)
        eos = int(_sequential(models, short)[0, 4 + 2])  # its 3rd generated token
        short = DecodeRequest(prompt=short.prompt, steps=12, eos_id=eos)
        long = DecodeRequest(prompt=_prompt(8, 1, 4), steps=16)
        b = _batcher(models, slots=2)
        hs, hl = b.admit(short), b.admit(long)
        order = []
        for _ in range(500):
            if b.active_sessions() == 0:
                break
            order.extend(b.step())
        assert order[0] is hs and b.stats()["retired"] == 2
        np.testing.assert_array_equal(hs.out, _sequential(models, short))
        np.testing.assert_array_equal(hl.out, _sequential(models, long))
        row = hs.out[0]
        cut = 4 + int(np.argmax(row[4:] == eos))
        assert (row[cut + 1:] == 0).all()

    def test_tokens_equal_the_jax_batcher(self, models, jax_models):
        reqs = [(_prompt(60 + i, 1, 3 + (i % 4)), 5 + 3 * (i % 3)) for i in range(6)]
        jtp, jdp = jax_models
        jb = JContinuousBatcher(jtp, JLMConfig(**SHAPES["target"]), jdp,
                                JLMConfig(**SHAPES["draft"]),
                                JBatcherConfig(slots=4, max_prompt=8, max_new=16, gamma=GAMMA,
                                               max_block=1))
        jh = _churn(jb, [JDecodeRequest(prompt=p.astype(np.int32), steps=s) for p, s in reqs],
                    block=False)
        th = _churn(_batcher(models), [DecodeRequest(prompt=p, steps=s) for p, s in reqs])
        mesh = make_mesh(num_data=1, num_server=1)
        gaps = []
        for a, b in zip(jh, th):
            np.testing.assert_array_equal(a.out, b.out)
            toks = b.out
            want = np.asarray(j_lm_forward(jtp, jnp.asarray(toks, jnp.int32),
                                           JLMConfig(**SHAPES["target"]), mesh))
            with torch.no_grad():
                got = lm_forward(models[0], torch.from_numpy(toks), TCFG).numpy()
            gaps.append(float(np.abs(want - got).max()))
        print(f"# readings: target logits on the batched streams, JAX vs port, max |diff| "
              f"{max(gaps):.3g}")
        assert max(gaps) < 1e-4


class TestSchedulerContract:
    def test_single_owner_enforced(self, models):
        b = _batcher(models)
        b.admit(DecodeRequest(prompt=_prompt(1, 1, 4), steps=3))
        errs = []

        def intruder():
            try:
                b.step()
            except RuntimeError as e:
                errs.append(e)

        t = threading.Thread(target=intruder)
        t.start()
        t.join(timeout=30)
        assert errs and "single-owner" in str(errs[0])
        done = []
        _drain(b, done)  # the owner thread still drives it
        assert len(done) == 1

    def test_validate_rejects_before_consuming_slots(self, models):
        b = _batcher(models, slots=2, max_prompt=8, max_new=16)
        bad = [
            DecodeRequest(prompt=_prompt(1, 1, 9), steps=4),   # too wide
            DecodeRequest(prompt=_prompt(1, 3, 4), steps=4),   # B > slots
            DecodeRequest(prompt=_prompt(1, 1, 4), steps=17),  # > max_new
            DecodeRequest(prompt=_prompt(1, 1, 4), steps=0),
            DecodeRequest(prompt=_prompt(1, 1, 4), steps=4, eos_id=64),
            DecodeRequest(prompt=_prompt(1, 1, 4), steps=4, prompt_lengths=np.array([5])),
        ]
        for req in bad:
            with pytest.raises(ValueError):
                b.admit(req)
        good = DecodeRequest(prompt=_prompt(1, 1, 4), steps=4)
        with pytest.raises(ValueError, match="steps"):
            b.admit_many([(good, None), (bad[2], None)])  # one bad request fails the wave
        assert b.free_slots() == 2 and b.active_sessions() == 0
        b.admit(DecodeRequest(prompt=_prompt(1, 1, 4), steps=8))
        b.admit(DecodeRequest(prompt=_prompt(2, 1, 4), steps=8))
        with pytest.raises(RuntimeError, match="batch full"):
            b.admit(DecodeRequest(prompt=_prompt(3, 1, 4), steps=8))

    def test_state_rejects_mismatched_vocab(self, models):
        with pytest.raises(ValueError, match="vocab"):
            ContinuousBatcher(models[0], TCFG, models[1], LMConfig(vocab=32, d_model=16,
                                                                   n_heads=2, n_layers=1))


def _store():
    kv = KVVector(k=1, num_slots=1 << 10, hashed=True, name="batch_serve", device="cpu")
    keys = np.unique(np.random.default_rng(0).integers(0, 1 << 16, 128))
    kv.wait(kv.push(kv.request(channel=0), keys=keys, values=np.ones((len(keys), 1), np.float32)))
    return kv


class TestFrontendBatched:
    def test_concurrent_sessions_match_solo_runs(self, models):
        fe = ServeFrontend(_store(), ServeConfig(replica="off", workers=1),
                           batcher=_batcher(models)).start()
        try:
            reqs = [DecodeRequest(prompt=_prompt(20 + i, 1, 3 + (i % 5)), steps=4 + 3 * (i % 4))
                    for i in range(6)]
            tickets = [fe.submit(r) for r in reqs]
            for r, tk in zip(reqs, tickets):
                np.testing.assert_array_equal(tk.result(300), _sequential(models, r))
            st = fe.stats()["batcher"]
            assert st["joins"] == 6 and st["retired"] == 6 and st["rounds"] >= 1
            assert fe.stats()["completed"] == 6
        finally:
            fe.close()

    def test_admission_sheds_while_batch_full(self, models):
        fe = ServeFrontend(_store(), ServeConfig(replica="off", workers=1, max_queue_depth=2),
                           batcher=_batcher(models, slots=1, max_new=16)).start()
        try:
            t1 = fe.submit(DecodeRequest(prompt=_prompt(1, 1, 4), steps=16))
            t2 = fe.submit(DecodeRequest(prompt=_prompt(2, 1, 4), steps=16))
            with pytest.raises(RejectedError) as ei:
                fe.submit(DecodeRequest(prompt=_prompt(3, 1, 4), steps=4))
            assert ei.value.reason == "queue" and ei.value.retry_after_s >= 0
            for tk in (t1, t2):  # the resident sessions still finish
                assert tk.result(300).shape == (1, 4 + 16)
        finally:
            fe.close()

    def test_paused_frontend_keeps_stepping_resident_sessions(self, models):
        """Decode rounds touch only model state, never the store: a pause
        holds new joins, while resident sessions finish."""
        fe = ServeFrontend(_store(), ServeConfig(replica="off", workers=1),
                           batcher=_batcher(models, slots=1)).start()
        try:
            req0 = DecodeRequest(prompt=_prompt(30, 1, 4), steps=12)
            t0 = fe.submit(req0)
            while fe.stats()["batcher"]["joins"] == 0:
                pass
            fe.pause()
            req1 = DecodeRequest(prompt=_prompt(31, 1, 5), steps=8)
            t1 = fe.submit(req1)
            np.testing.assert_array_equal(t0.result(300), _sequential(models, req0))
            assert fe.stats()["batcher"]["joins"] == 1  # held at the door while paused
            fe.resume()
            np.testing.assert_array_equal(t1.result(300), _sequential(models, req1))
        finally:
            fe.resume()
            fe.close()

    def test_a_bad_request_fails_alone(self, models):
        fe = ServeFrontend(_store(), ServeConfig(replica="off", workers=1),
                           batcher=_batcher(models)).start()
        try:
            fe.pause()
            good = DecodeRequest(prompt=_prompt(5, 1, 4), steps=6)
            tg = fe.submit(good)
            tb = fe.submit(DecodeRequest(prompt=_prompt(6, 1, 4), steps=99))
            fe.resume()
            with pytest.raises(ValueError, match="steps"):
                tb.result(300)
            np.testing.assert_array_equal(tg.result(300), _sequential(models, good))
        finally:
            fe.close()
