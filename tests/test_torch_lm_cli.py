"""PyTorch port: the LM CLI and its optimizer chain against the JAX package.

``parameter_server_tpu_torch.apps.lm.main`` is the JAX CLI's counterpart
on one device. Its optimizer chain (``apps/lm/optim.py``) is held to the
optax chain the JAX CLI builds (``apps/lm/main.py:306-331``): the same
gradients, computed from the port's own trajectory, are fed to both for 6
steps from the same weights, and the parameters must agree within 1e-6 of
their scale and 1e-5 relative. Both compute the same float32 operations;
they part only where the two libraries' ``sqrt``, ``cos`` and ``pow``
round their last bit, or where a sum is taken in another order (the
global norm).

The CLI itself runs on ``--device cpu``: it trains, writes its report and
log lines, evaluates held-out batches and generates. Its flag mistakes
fail as the JAX CLI's do (argparse's ``SystemExit``), and each flag it
cannot serve yet raises ``NotImplementedError`` naming its ROADMAP item.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from parameter_server_tpu.apps.lm import main as jax_main
from parameter_server_tpu_torch.apps.lm import main as lm_main
from parameter_server_tpu_torch.apps.lm import optim
from parameter_server_tpu_torch.models import transformer as T

torch.set_num_threads(1)

CFG = T.LMConfig(vocab=256, d_model=32, n_heads=2, n_layers=2, d_ff=64)


def _optax_chain(lr, steps, warmup, clip_norm, grad_accum):
    """The JAX CLI's chain, as its main() builds it."""
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=max(1, warmup // grad_accum),
        decay_steps=max(2, steps // grad_accum), end_value=0.1 * lr) if warmup else lr
    chain = ([optax.clip_by_global_norm(clip_norm)] if clip_norm else []) + [optax.adam(sched)]
    tx = optax.chain(*chain)
    return optax.MultiSteps(tx, every_k_schedule=grad_accum) if grad_accum > 1 else tx


@pytest.mark.parametrize("warmup,clip_norm,grad_accum", [
    (0, None, 1), (0, 0.05, 1), (3, None, 1), (0, None, 2), (2, 0.05, 3),
])
def test_optimizer_chain_matches_optax(warmup, clip_norm, grad_accum):
    lr, steps = 3e-2, 6
    params = T.init_lm(0, CFG, "cpu")
    rng = np.random.default_rng(1)
    tx = optim.build(lr, steps, warmup, clip_norm, grad_accum)
    state = tx.init(params)
    jtx = _optax_chain(lr, steps, warmup, clip_norm, grad_accum)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jstate = jtx.init(jp)
    for _ in range(steps):
        toks = torch.tensor(rng.integers(0, 256, (2, 16)))
        _, grads = T.value_and_grad(lambda p: T.lm_loss(p, toks, CFG), params)
        with torch.no_grad():
            updates, state = tx.update(grads, state)
            params = optim.apply_updates(params, updates)
        jupdates, jstate = jtx.update({k: jnp.asarray(g.numpy()) for k, g in grads.items()},
                                      jstate, jp)
        jp = optax.apply_updates(jp, jupdates)
    for k, v in params.items():
        want = np.asarray(jp[k])
        np.testing.assert_allclose(v.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)


def test_clip_leaves_small_gradients_alone_and_scales_large_ones():
    g = {"a": torch.tensor([3.0, 4.0])}
    tx = optim.Adam(1.0, clip_norm=10.0)
    assert tx._clip(g)["a"] is g["a"]
    torch.testing.assert_close(optim.Adam(1.0, clip_norm=1.0)._clip(g)["a"],
                               torch.tensor([0.6, 0.8]), rtol=0, atol=1e-7)


def test_schedule_reads_the_count_before_the_increment():
    sched = optim.warmup_cosine_decay(1.0, 2, 6, 0.1)
    osched = optax.warmup_cosine_decay_schedule(0.0, 1.0, 2, 6, 0.1)
    for n in range(8):
        got = float(sched(torch.tensor(n, dtype=torch.int32)))
        assert abs(got - float(osched(n))) <= 1e-6, n
    assert float(sched(torch.tensor(0, dtype=torch.int32))) == 0.0  # the first update moves nothing


@pytest.mark.parametrize("seed", [0, 5])
def test_corpus_and_batches_equal_the_jax_clis(seed):
    a = lm_main._load_corpus(None, np.random.default_rng(seed))
    b = jax_main._load_corpus(None, np.random.default_rng(seed))
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _run(capsys, *argv):
    rc = lm_main.main(["--device", "cpu", "--seq-len", "32", "--batch", "2", *argv])
    out = capsys.readouterr().out
    losses = [float(line.split()[1]) for line in out.splitlines()
              if line.split() and line.split()[0].isdigit()]
    return rc, out, losses


def test_cli_trains_and_generates_on_the_cpu(capsys):
    rc, out, losses = _run(capsys, "--steps", "20", "--report-every", "5", "--lr", "1e-2",
                           "--prompt", "ab", "--gen-tokens", "8", "--eos-byte", "255")
    assert rc == 0 and len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    gen = out.split("--- generation (8 tokens, greedy) ---\n", 1)[1]
    assert gen.startswith("ab")


def test_cli_sampled_generation_and_steps_per_launch(capsys):
    rc, out, losses = _run(capsys, "--steps", "4", "--steps-per-launch", "2", "--report-every",
                           "2", "--prompt", "x", "--gen-tokens", "4", "--temperature", "0.8",
                           "--top-k", "20", "--top-p", "0.9", "--grad-accum", "2",
                           "--warmup", "2", "--clip-norm", "1.0")
    assert rc == 0 and len(losses) == 2
    assert "--- generation (4 tokens, sampled) ---" in out


def test_cli_log_file_and_held_out_eval(capsys, tmp_path):
    log = tmp_path / "log.jsonl"
    rc, out, _ = _run(capsys, "--steps", "6", "--report-every", "4", "--eval-every", "3",
                      "--eval-frac", "0.2", "--log-file", str(log))
    assert rc == 0
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [3, 4, 6]
    assert "eval_loss" in recs[0] and "tokens_per_sec" not in recs[0]  # eval off the report grid
    assert recs[1]["tokens_per_sec"] > 0 and "eval_loss" not in recs[1]
    assert {"loss", "bits_per_byte", "tokens_per_sec", "eval_loss"} <= set(recs[2])
    assert abs(recs[2]["bits_per_byte"] - recs[2]["loss"] / np.log(2)) < 1e-5
    assert out.count(" eval@") == 2 and "held out" in out


@pytest.mark.parametrize("argv", [
    ["--top-k", "3"],                                  # top_k without sampling
    ["--temperature", "-1"],                           # negative temperature
    ["--steps-per-launch", "3"],                       # launch must divide the step budget
    ["--steps-per-launch", "0"],
    ["--warmup", "5"],                                 # warmup must fit inside the run
    ["--grad-accum", "0"],                             # accumulation must be positive
    ["--grad-accum", "10"],                            # ...and fit inside the run
    ["--grad-accum", "2"],                             # ...and divide it (no partial window)
    ["--clip-norm", "-1"],                             # negative clip flips gradients
    ["--eval-every", "2", "--eval-frac", "1.5"],       # eval fraction out of range
    ["--eval-every", "-10"],                           # negative eval cadence
    ["--attention", "ring", "--window", "8"],          # window needs a flash mode
    ["--window", "0"],                                 # window must be >= 1
    ["--top-p", "0.5", "--temperature", "1", "--top-k", "300"],
    ["--num-servers", "0"],
])
def test_cli_flag_mistakes_fail_fast(argv):
    """The mistakes of ``tests/test_lm_app.py::test_lm_cli_flag_mistakes_fail_fast``
    that one device can make, and the invalid configs, as argparse errors;
    the same argv fails the JAX CLI too."""
    base = ["--steps", "5", "--seq-len", "64", "--batch", "2"]
    with pytest.raises(SystemExit) as e:
        lm_main.main([*base, *argv, "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        jax_main.main([*base, *argv])


def test_cli_tiny_corpus_rejected(tmp_path):
    f = tmp_path / "tiny.txt"
    f.write_bytes(b"x" * 32)
    with pytest.raises(SystemExit):
        lm_main.main(["--steps", "2", "--seq-len", "64", "--data", str(f), "--device", "cpu"])


UNPORTED = [
    (["--zero1"], "A9"),
    (["--fsdp"], "A9"),
    (["--num-servers", "2"], "A9"),
    (["--profile", "/nonexistent/prof"], "A12"),
    (["--attention", "ring_zigzag"], "A9"),
    (["--attention", "a2a"], "A9"),
]


@pytest.mark.parametrize("argv,item", UNPORTED, ids=[" ".join(a) for a, _ in UNPORTED])
def test_unported_flags_raise_naming_their_roadmap_item(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        lm_main.main(["--steps", "2", *argv, "--device", "cpu"])


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_main.main(["--steps", "2", "--seq-len", "32"])
