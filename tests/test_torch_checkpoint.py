"""PyTorch port: LM checkpoints and the LM CLI's new flags against the JAX package.

``parameter/replica.py::CheckpointManager`` writes the JAX package's
NumPy checkpoint format (``arrays.npz`` of positional arrays beside
``__treedef__``), so a params-only tree saved by either package restores
in the other: the JAX side here is its ``CheckpointManager(use_orbax=
False)``, and every round trip is bit for bit. The ``checkpoint.write``
fault point leaves a torn ``.tmp`` that is never listed, an async
failure re-raises from ``wait()``, and a template of another shape fails
loudly, as ``tests/test_faults.py`` holds the JAX manager.

The LM CLI: the cases of ``tests/test_lm_app.py`` that its checkpoint
flags cover (a resumed run prints ``resumed from step 30`` and reports
only rows 35 and 40; the schedule and accumulation counters resume; an
async save failure fails a clean run and never masks the loop's own
error), and a resumed run's losses against the JAX CLI's resumed run
from the same seed (both start the batch stream over). ``--moe-every``,
``--optimizer adafactor|lion`` and ``--beam`` train and generate on the
CPU, and the flag mistakes the JAX CLI refuses are refused.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parameter_server_tpu.apps.lm import main as jax_main
from parameter_server_tpu.models import transformer as J
from parameter_server_tpu.parameter import replica as jreplica
from parameter_server_tpu.system import faults as jfaults
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.lm import main as lm_main
from parameter_server_tpu_torch.apps.lm import optim
from parameter_server_tpu_torch.models import transformer as T
from parameter_server_tpu_torch.parameter import replica
from parameter_server_tpu_torch.system import faults

torch.set_num_threads(1)

CFG = T.LMConfig(vocab=61, d_model=32, n_heads=2, n_layers=2, d_ff=64, moe_every=2, n_experts=4)


def _tree(v=1.0):
    return {"w": torch.full((4, 2), v), "step": np.array([v], np.float64)}


@pytest.fixture(autouse=True)
def _hermetic_faults():
    faults.reset()
    yield
    faults.reset()


def test_round_trip_of_params_and_optimizer_state(tmp_path):
    params = T.init_lm(0, CFG, "cpu")
    tx = optim.build(1e-2, 10, grad_accum=2)
    opt = tx.init(params)
    toks = torch.tensor(np.random.default_rng(0).integers(0, 61, (2, 12)))
    _, grads = T.value_and_grad(lambda p: T.lm_loss(p, toks, CFG), params)
    _, opt = tx.update(grads, opt, params)  # a mid-window state: mini_step 1
    cm = replica.CheckpointManager(str(tmp_path / "ck"))
    cm.save(3, {"params": params, "opt": opt, "note": None})
    like = {"params": T.init_lm(1, CFG, "cpu"), "opt": tx.init(params), "note": None}
    out = cm.restore(3, like=like)
    assert list(out["params"]) == list(like["params"])  # the template's key order
    for k, v in params.items():
        assert torch.equal(out["params"][k], v), k
    assert out["opt"]["mini_step"] == 1 and isinstance(out["opt"]["mini_step"], int)
    assert out["opt"]["inner"]["count"].dtype == torch.int32
    for part in ("acc",):
        for k, v in opt[part].items():
            assert torch.equal(out["opt"][part][k], v)
    assert cm.latest_step() == 3


def test_a_params_tree_crosses_the_packages_both_ways(tmp_path):
    params = T.init_lm(0, CFG, "cpu")
    jlike = {"params": {k: jnp.zeros(tuple(v.shape)) for k, v in params.items()}}
    # port -> JAX
    replica.CheckpointManager(str(tmp_path / "a")).save(7, {"params": params})
    jm = jreplica.CheckpointManager(str(tmp_path / "a"), use_orbax=False)
    assert jm.latest_step() == 7
    got = jm.restore(7, like=jlike)["params"]
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy(), err_msg=k)
    # JAX -> port
    jtree = {"params": {k: jnp.asarray(v.numpy() * 2.0) for k, v in params.items()}}
    jreplica.CheckpointManager(str(tmp_path / "b"), use_orbax=False).save(9, jtree)
    tm = replica.CheckpointManager(str(tmp_path / "b"))
    back = tm.restore(tm.latest_step(), like={"params": T.init_lm(1, CFG, "cpu")})["params"]
    for k, v in params.items():
        assert torch.equal(back[k], v * 2.0), k


def test_sync_die_mid_write_never_surfaces_a_torn_dir(tmp_path):
    cm = replica.CheckpointManager(str(tmp_path / "ck"))
    cm.save(1, _tree(1.0))
    with faults.scoped("checkpoint.write", kind="die", once=True):
        with pytest.raises(faults.FaultError):
            cm.save(2, _tree(2.0))
    assert any(n.endswith(".tmp") for n in os.listdir(cm.directory))
    assert cm.latest_step() == 1
    cm.save(2, _tree(2.0))  # a later save heals: fresh tmp, rename
    assert cm.latest_step() == 2
    assert torch.equal(cm.restore(2, like=_tree())["w"], _tree(2.0)["w"])


def test_async_die_reraises_from_wait_and_heals(tmp_path):
    cm = replica.CheckpointManager(str(tmp_path / "ck"))
    cm.save(5, _tree(5.0))
    with faults.scoped("checkpoint.write", kind="die", once=True):
        cm.save_async(6, _tree(6.0))
        with pytest.raises(RuntimeError, match="async checkpoint"):
            cm.wait()
    assert cm.latest_step() == 5
    cm.save_async(6, _tree(6.0))
    cm.wait()
    assert cm.latest_step() == 6


def test_async_snapshot_is_taken_at_the_call(tmp_path):
    cm = replica.CheckpointManager(str(tmp_path / "ck"))
    t = _tree(1.0)
    cm.save_async(1, t)
    t["w"].fill_(9.0)  # the caller changes its tensor in place at once
    cm.wait()
    assert torch.equal(cm.restore(1, like=_tree())["w"], torch.full((4, 2), 1.0))


def test_template_mismatch_is_loud_in_both_packages(tmp_path):
    cm = replica.CheckpointManager(str(tmp_path / "ck"))
    cm.save(1, _tree(1.0))
    wrong = {"w": torch.zeros(4, 2), "step": np.zeros(1), "extra_moment": np.zeros(3)}
    with pytest.raises(ValueError, match="different model/optimizer"):
        cm.restore(1, like=wrong)
    with pytest.raises(ValueError, match="different model/optimizer"):
        jreplica.CheckpointManager(cm.directory, use_orbax=False).restore(
            1, like={k: np.asarray(v) for k, v in wrong.items()})
    with pytest.raises(ValueError, match="template"):
        cm.restore(1)


def test_the_fault_point_is_the_jax_packages():
    assert "checkpoint.write" in faults.POINTS and "checkpoint.write" in jfaults.POINTS


# -- the LM CLI --

BASE = ["--seq-len", "64", "--batch", "4", "--d-model", "32", "--n-heads", "2", "--d-ff", "64",
        "--device", "cpu"]


def _rows(out):
    return [line.split() for line in out.splitlines() if line and line.split()[0].isdigit()]


def run_cli(capsys, *extra):
    rc = lm_main.main(["--steps", "30", *BASE, "--report-every", "10", "--prompt", "ab",
                       "--gen-tokens", "8", *extra])
    assert rc == 0
    out = capsys.readouterr().out
    return out, [float(r[1]) for r in _rows(out)]


def resume_cli(capsys, ck, *extra):
    rc = lm_main.main(["--steps", "40", *BASE, "--report-every", "5", "--ckpt-dir", ck,
                       "--resume", *extra])
    assert rc == 0
    return capsys.readouterr().out


def test_lm_cli_checkpoint_resume(capsys, tmp_path):
    """Save (the final step, 30), resume and train on: only the
    remaining steps, 35 and 40 reported."""
    ck = str(tmp_path / "ck")
    run_cli(capsys, "--ckpt-dir", ck)
    assert replica.CheckpointManager(ck).latest_step() == 30
    out = resume_cli(capsys, ck)
    assert "resumed from step 30" in out
    assert [int(r[0]) for r in _rows(out)] == [35, 40]
    assert replica.CheckpointManager(ck).latest_step() == 40


def test_lm_cli_resume_with_schedule_and_accum(capsys, tmp_path):
    ck = str(tmp_path / "ck")
    hygiene = ["--warmup", "5", "--clip-norm", "1.0", "--grad-accum", "2"]
    run_cli(capsys, "--ckpt-dir", ck, *hygiene)
    out = resume_cli(capsys, ck, *hygiene)
    assert "resumed from step 30" in out


def _resumed_losses(main, ck, log, argv):
    """A 4-step run saving its last step, then ``--resume`` to step 10:
    the resumed run's ``--log-file`` losses by step."""
    assert main(argv + ["--steps", "4", "--ckpt-dir", str(ck)]) == 0
    assert main(argv + ["--steps", "10", "--ckpt-dir", str(ck), "--resume",
                        "--log-file", str(log)]) == 0
    return {r["step"]: r["loss"] for r in map(json.loads, log.read_text().splitlines())}


@pytest.mark.parametrize("extra", [[], ["--optimizer", "adafactor", "--warmup", "3",
                                        "--grad-accum", "2", "--steps-per-launch", "2"]],
                         ids=["adam", "adafactor_warmup_accum"])
def test_resumed_run_equals_the_jax_clis(capsys, tmp_path, monkeypatch, extra):
    """Each package resumes from its own step-4 checkpoint: the counters
    and optimizer state go on from it and the batch stream starts over
    from the seed, so the two CLIs' losses for steps 5-10 agree (within
    1e-4: float32 sums in another order, which Adam's first steps can
    amplify for gradients near 0). The port's CLI starts from the JAX
    CLI's initial weights for its seed, carried across."""
    def jax_init(seed, cfg, device):
        jcfg = J.LMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(J.LMConfig)})
        npp = {k: np.asarray(v) for k, v in J.init_lm(jax.random.PRNGKey(seed), jcfg).items()}
        return convert.lm_params_from_jax(npp, cfg, device)

    monkeypatch.setattr(T, "init_lm", jax_init)
    argv = ["--seq-len", "32", "--batch", "8", "--d-model", "32", "--n-heads", "2",
            "--d-ff", "64", "--report-every", "1", *extra]
    ours = _resumed_losses(lm_main.main, tmp_path / "port", tmp_path / "port.jsonl",
                           argv + ["--device", "cpu"])
    assert "resumed from step 4" in capsys.readouterr().out
    theirs = _resumed_losses(jax_main.main, tmp_path / "jax", tmp_path / "jax.jsonl", argv)
    assert "resumed from step 4" in capsys.readouterr().out
    assert sorted(ours) == sorted(theirs) and min(ours) > 4 and len(ours) >= 3, (ours, theirs)
    for step, loss in theirs.items():
        assert abs(ours[step] - loss) <= 1e-4, (step, ours, theirs)


def test_save_every_lands_on_its_steps(tmp_path):
    ck = tmp_path / "ck"
    assert lm_main.main(["--steps", "6", *BASE, "--seq-len", "32", "--save-every", "2",
                         "--ckpt-dir", str(ck)]) == 0
    assert sorted(os.listdir(ck)) == [f"step_{s:010d}" for s in (2, 4, 6)]


def test_lm_cli_async_save_failure_fails_clean_run(tmp_path, monkeypatch):
    def boom(self, path, flat, structure):
        raise OSError("disk full (simulated)")

    monkeypatch.setattr(replica.CheckpointManager, "_write", boom)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        lm_main.main(["--steps", "4", *BASE, "--batch", "2", "--report-every", "4",
                      "--ckpt-dir", str(tmp_path / "ck")])


def test_a_failed_save_never_masks_the_loops_own_error(tmp_path, monkeypatch, capsys):
    def boom(self, path, flat, structure):
        raise OSError("disk full (simulated)")

    calls = []

    def fail_second(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return orig(*a, **k)

    orig = optim.apply_updates
    monkeypatch.setattr(replica.CheckpointManager, "_write", boom)
    monkeypatch.setattr(optim, "apply_updates", fail_second)
    with pytest.raises(KeyboardInterrupt):
        lm_main.main(["--steps", "4", *BASE, "--batch", "2", "--save-every", "1",
                      "--ckpt-dir", str(tmp_path / "ck")])
    assert "async checkpoint failure during shutdown" in capsys.readouterr().err


@pytest.mark.parametrize("extra,note", [
    (["--moe-every", "2"], "greedy"),
    (["--optimizer", "lion", "--lr", "3e-4"], "greedy"),
    (["--optimizer", "adafactor", "--moe-every", "1"], "greedy"),
    (["--beam", "3", "--eos-byte", "10"], "beam 3, logprob"),
], ids=["moe", "lion", "adafactor_moe", "beam_eos"])
def test_new_flags_train_and_generate(capsys, extra, note):
    out, losses = run_cli(capsys, *extra)
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert f"--- generation (8 tokens, {note}" in out


def test_beam_prints_the_best_beam_and_its_logprob(capsys):
    out, _ = run_cli(capsys, "--beam", "2", "--steps", "10")
    head, text = out.split("--- generation (8 tokens, beam 2, logprob ", 1)[1].split("\n", 1)
    assert float(head.split(")")[0]) < 0 and text.startswith("ab")


@pytest.mark.parametrize("argv", [
    ["--save-every", "2"],                                      # needs --ckpt-dir
    ["--resume"],                                               # needs --ckpt-dir
    ["--steps", "6", "--steps-per-launch", "3", "--save-every", "4", "--ckpt-dir", "UNUSED"],
])
def test_checkpoint_flag_mistakes_fail_fast(argv, tmp_path):
    argv = [str(tmp_path / "ck") if a == "UNUSED" else a for a in argv]
    base = ["--steps", "6", "--seq-len", "64", "--batch", "2"]
    with pytest.raises(SystemExit) as e:
        lm_main.main([*base, *argv, "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        jax_main.main([*base, *argv])


def test_resume_remaining_steps_must_divide_the_launch(tmp_path):
    ck = str(tmp_path / "ck")
    assert lm_main.main(["--steps", "3", *BASE, "--seq-len", "32", "--ckpt-dir", ck]) == 0
    with pytest.raises(SystemExit):
        lm_main.main(["--steps", "8", *BASE, "--seq-len", "32", "--ckpt-dir", ck, "--resume",
                      "--steps-per-launch", "2"])


def test_jax_tree_flatten_order_is_the_ports():
    tree = {"b": {"z": 1, "a": 2}, "a": [3, (4, 5)], "c": None}
    assert replica._leaves(tree) == jax.tree.leaves(tree)
