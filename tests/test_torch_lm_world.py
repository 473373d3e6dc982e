"""PyTorch port: the LM CLI inside a launcher's world of 4 CPU ranks,
against the JAX CLI on a data axis of 4, and inside a world of 8 on a
``data 4 x server 2`` mesh with its parameters and optimizer state placed
(``--num-servers``, ``--zero1``, ``--fsdp``), against the JAX CLI on 8
devices.

``parallel/launch.run_world`` starts 4 ranks, each running the port's
``apps/lm/main.main`` (rank function ``tests/torch_seq_parallel_ranks.
cli_world``): the CLI trains on its 4 x 1 mesh, every rank sampling the
same global batch and keeping its shard of the sequence, and rank 0
prints and writes the log. The JAX CLI runs in this process with the
same flags on 4 of the suite's virtual devices (``jax.devices`` cut to
4, so its mesh is 4 x 1). Each port rank's ``init_lm`` returns the JAX
CLI's initial weights (its ``init_lm`` at the run's seed, carried across
by ``convert``), so the two trajectories start alike: the same corpus
and batches for the seed, the same Adam chain. Each run's logged losses
(6 decimals) are held within 1e-4 of the JAX CLI's, the tolerance the
repo holds the CLI's card run to its CPU run by (float32 sums in another
order, which Adam's first steps can amplify for gradients near zero).
"""

import json

import jax
import numpy as np
import pytest

import contextlib
import os
import shutil

from parameter_server_tpu.apps.lm import main as jax_main
from parameter_server_tpu.models import transformer as J
from parameter_server_tpu.parameter import replica as jreplica
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.models import transformer as T
from parameter_server_tpu_torch.parallel import launch
from tests import torch_seq_parallel_ranks as ranks
from tests import torch_sharded_ranks as sharded_ranks

N = 4
BASE = ["--seq-len", "32", "--batch", "2", "--d-model", "32", "--n-heads", "4", "--d-ff", "64",
        "--lr", "1e-2", "--report-every", "1", "--seed", "3"]
RUNS = {
    "ring_flash": ["--steps", "4"],
    "ring_zigzag": ["--steps", "4", "--attention", "ring_zigzag"],
    "a2a": ["--steps", "4", "--attention", "a2a"],
    "moe_every 2": ["--steps", "4", "--moe-every", "2"],
    "eval and clip": ["--steps", "4", "--attention", "ring", "--eval-every", "2",
                      "--clip-norm", "0.5", "--grad-accum", "2"],
    "checkpoint": ["--steps", "4", "--save-every", "2"],
    "resume": ["--steps", "6", "--resume"],
}
TOL = 1e-4


def _cfg(argv):
    """The JAX CLI's config for ``argv``: :data:`BASE`'s widths, its
    default 2 layers, and ``--moe-every``."""
    moe = int(argv[argv.index("--moe-every") + 1]) if "--moe-every" in argv else 0
    return J.LMConfig(vocab=256, d_model=32, n_heads=4, n_layers=2, d_ff=64, moe_every=moe)


def _argv(name, tmp_path):
    argv = BASE + RUNS[name] + ["--log-file", str(tmp_path / f"{name}.jsonl")]
    if name in ("checkpoint", "resume"):
        argv += ["--ckpt-dir", str(tmp_path / "ckpt")]
    return argv


def _losses(path):
    with open(path) as f:
        return [(r["step"], r.get("loss"), r.get("eval_loss")) for r in map(json.loads, f)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    devices = jax.devices()
    real = jax.devices
    jax.devices = lambda *a, **k: devices[:N] if not a and not k else real(*a, **k)
    try:
        theirs = {}
        for name in RUNS:
            argv = _argv(name, jdir)
            assert jax_main.main(argv) == 0
            theirs[name] = _losses(jdir / f"{name}.jsonl")
    finally:
        jax.devices = real
    work = []
    for name in RUNS:
        argv = _argv(name, tdir) + ["--device", "cpu"]
        cfg = _cfg(argv)
        jp = {k: np.asarray(v) for k, v in J.init_lm(jax.random.PRNGKey(3), cfg).items()}
        tcfg = T.LMConfig(vocab=256, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                          moe_every=cfg.moe_every)
        tp = convert.lm_params_to_numpy(convert.lm_params_from_jax(jp, tcfg, "cpu"))
        path = tdir / f"{name}.npz"
        np.savez(path, **tp)
        work.append((argv, str(path)))
    outs = launch.run_world(ranks.cli_world, N, args=(work,), device_type="cpu", timeout=300)
    ours = {name: _losses(tdir / f"{name}.jsonl") for name in RUNS}
    return theirs, ours, outs


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_losses_in_a_world_of_four_match_the_jax_cli(runs, name):
    theirs, ours, _ = runs
    assert [s for s, _, _ in ours[name]] == [s for s, _, _ in theirs[name]]
    for (s, a, ea), (_, b, eb) in zip(ours[name], theirs[name]):
        for x, y in ((a, b), (ea, eb)):
            assert (x is None) == (y is None)
            if x is not None:
                assert abs(x - y) <= TOL, (name, s, x, y)


def test_rank_zero_alone_prints_and_the_world_is_named(runs):
    _, _, outs = runs
    i = list(RUNS).index("resume")
    for rank, per_run in enumerate(outs):
        for code, text in per_run:
            assert code == 0
            assert (text != "") == (rank == 0)
    lines = outs[0][0][1].splitlines()
    assert lines[0].startswith("devices=4 (data=4 x server=1) attention=ring_flash")
    assert lines[0].endswith(" on cpu")
    assert "resumed from step 4" in outs[0][i][1]


# -- a world of 8: the parameters and optimizer state placed --

#: the cases of tests/test_lm_app.py:95-157 on a 4 x 2 world (8 x 1 without
#: --num-servers), 4 Adam steps each, resumes to step 6
RUNS8 = {
    "num-servers 2": ["--steps", "4", "--num-servers", "2"],
    "num-servers 2 checkpoint": ["--steps", "4", "--num-servers", "2"],
    "num-servers 2 resume": ["--steps", "6", "--num-servers", "2", "--resume"],
    "fsdp zero1": ["--steps", "4", "--fsdp", "--zero1"],
    "fsdp num-servers 2 checkpoint": ["--steps", "4", "--fsdp", "--num-servers", "2"],
    "fsdp num-servers 2 resume": ["--steps", "6", "--fsdp", "--num-servers", "2", "--resume"],
    # the flags of the world of 4 under the placements
    "num-servers 2 ring_zigzag zero1": ["--steps", "4", "--num-servers", "2", "--attention",
                                        "ring_zigzag", "--zero1"],
    "num-servers 2 a2a fsdp": ["--steps", "4", "--num-servers", "2", "--attention", "a2a",
                               "--fsdp"],
    "num-servers 2 moe remat fsdp zero1": ["--steps", "4", "--num-servers", "2", "--moe-every",
                                           "2", "--remat", "--fsdp", "--zero1"],
    "num-servers 2 adafactor clip accum eval fsdp zero1": [
        "--steps", "4", "--num-servers", "2", "--optimizer", "adafactor", "--clip-norm", "0.5",
        "--grad-accum", "2", "--steps-per-launch", "2", "--eval-every", "2", "--fsdp", "--zero1"],
}
#: the port's runs only: the replicated run's checkpoint, the JAX CLI's
#: checkpoint resumed, decoding on the placed weights, a flag error
PORT8 = {
    "replicated checkpoint": ["--steps", "4"],
    "resume the JAX CLI's checkpoint": ["--steps", "6", "--fsdp", "--num-servers", "2",
                                        "--resume"],
    "generate replicated": ["--steps", "2", "--prompt", "ab", "--gen-tokens", "6"],
    "generate placed": ["--steps", "2", "--fsdp", "--num-servers", "2", "--prompt", "ab",
                        "--gen-tokens", "6"],
    "beam replicated": ["--steps", "2", "--prompt", "ab", "--gen-tokens", "6", "--beam", "2"],
    "beam placed": ["--steps", "2", "--num-servers", "2", "--zero1", "--prompt", "ab",
                    "--gen-tokens", "6", "--beam", "2"],
    "num-servers 3": ["--steps", "2", "--num-servers", "3"],
}
CKPT8 = {"num-servers 2 checkpoint": "tp", "num-servers 2 resume": "tp",
         "fsdp num-servers 2 checkpoint": "fsdp", "fsdp num-servers 2 resume": "fsdp",
         "replicated checkpoint": "replicated", "resume the JAX CLI's checkpoint": "from_jax"}


def _argv8(name, d):
    argv = BASE + (RUNS8.get(name) or PORT8[name]) + ["--log-file", str(d / f"{name}.jsonl")]
    if name in CKPT8:
        argv += ["--ckpt-dir", str(d / CKPT8[name])]
    return argv


@contextlib.contextmanager
def _npz_checkpoints():
    """The JAX CLI's checkpoints in the package's npz format (the port's
    format; orbax's is the JAX manager's default when installed)."""
    real = jreplica.CheckpointManager.__init__

    def npz(self, directory, use_orbax=True):
        real(self, directory, use_orbax=False)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreplica.CheckpointManager, "__init__", npz)
        yield


def _step4_copy(src, dst):
    """The checkpoint directory ``src`` as it stood at step 4."""
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        if name != f"step_{4:010d}":
            shutil.rmtree(dst / name)
    return dst


@pytest.fixture(scope="module")
def runs8(tmp_path_factory):
    """The JAX CLI's runs (8 devices), then the port's world of 8, then
    the JAX CLI resuming the port's FSDP x TP checkpoint at step 4."""
    jdir, tdir = tmp_path_factory.mktemp("jax8"), tmp_path_factory.mktemp("port8")
    theirs = {}
    with _npz_checkpoints():
        for name in RUNS8:
            assert jax_main.main(_argv8(name, jdir)) == 0
            theirs[name] = _losses(jdir / f"{name}.jsonl")
            if name == "fsdp num-servers 2 checkpoint":
                _step4_copy(jdir / "fsdp", tdir / "from_jax")
    names = list(RUNS8) + list(PORT8)
    work = []
    for name in names:
        argv = _argv8(name, tdir) + ["--device", "cpu"]
        cfg = _cfg(argv)
        path = tdir / f"init_moe{cfg.moe_every}.npz"
        if not path.exists():
            jp = {k: np.asarray(v) for k, v in J.init_lm(jax.random.PRNGKey(3), cfg).items()}
            np.savez(path, **convert.lm_params_to_numpy(convert.lm_params_from_jax(
                jp, T.LMConfig(vocab=256, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                               moe_every=cfg.moe_every), "cpu")))
        work.append((argv, str(path)))
    outs = launch.run_world(sharded_ranks.cli_world, 8, args=(work,), device_type="cpu",
                            timeout=400)
    ours = {name: _losses(tdir / f"{name}.jsonl") if os.path.exists(tdir / f"{name}.jsonl")
            else [] for name in names}
    jres = jdir / "resume_port"
    _step4_copy(tdir / "fsdp", jres)
    with _npz_checkpoints():
        argv = BASE + RUNS8["fsdp num-servers 2 resume"] + [
            "--ckpt-dir", str(jres), "--log-file", str(jdir / "resume_port.jsonl")]
        assert jax_main.main(argv) == 0
    theirs["resume the port's checkpoint"] = _losses(jdir / "resume_port.jsonl")
    return theirs, ours, dict(zip(names, zip(*outs))), tdir


@pytest.mark.parametrize("name", list(RUNS8))
def test_placed_cli_losses_in_a_world_of_eight_match_the_jax_cli(runs8, name):
    theirs, ours, _, _ = runs8
    assert [s for s, _, _ in ours[name]] == [s for s, _, _ in theirs[name]]
    for (s, a, ea), (_, b, eb) in zip(ours[name], theirs[name]):
        for x, y in ((a, b), (ea, eb)):
            assert (x is None) == (y is None)
            if x is not None:
                assert abs(x - y) <= TOL, (name, s, x, y)


def test_each_package_resumes_the_others_placed_checkpoint(runs8):
    """The port's FSDP x TP checkpoint at step 4 resumed by the JAX CLI,
    and the JAX CLI's by the port: each resumed run's losses those of the
    run that resumed its own package's checkpoint (whole leaves, the same
    npz layout)."""
    theirs, ours, outs, _ = runs8
    assert [s for s, _, _ in ours["resume the JAX CLI's checkpoint"]] == [5, 6]
    assert "resumed from step 4" in outs["resume the JAX CLI's checkpoint"][0][1]
    for a, b in ((ours["resume the JAX CLI's checkpoint"], theirs["fsdp num-servers 2 resume"]),
                 (theirs["resume the port's checkpoint"], ours["fsdp num-servers 2 resume"])):
        assert [s for s, _, _ in a] == [s for s, _, _ in b] == [5, 6]
        for (s, x, _), (_, y, _) in zip(a, b):
            assert abs(x - y) <= TOL, (s, x, y)


def test_a_placed_checkpoint_holds_the_replicated_runs_leaves(runs8):
    """The port's checkpoint of an FSDP x TP run at step 4 against its
    replicated run's: the same tree, leaf for leaf of the same shape and
    dtype in the same order (whole leaves, gathered), each within the
    CLI's 1e-4 of the other's (the two runs sum in other orders)."""
    _, _, _, tdir = runs8
    step = f"step_{4:010d}"
    with np.load(tdir / "fsdp" / step / "arrays.npz") as a, \
            np.load(tdir / "replicated" / step / "arrays.npz") as b:
        assert a.files == b.files
        np.testing.assert_array_equal(a["__treedef__"], b["__treedef__"])
        for k in a.files:
            if k == "__treedef__":
                continue
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("mode", ["generate", "beam"])
def test_placed_weights_generate_the_replicated_runs_text(runs8, mode):
    _, _, outs, _ = runs8
    placed, replicated = outs[f"{mode} placed"], outs[f"{mode} replicated"]
    for rank, ((code, text), (code_r, _)) in enumerate(zip(placed, replicated)):
        assert code == code_r == 0
        assert (text != "") == (rank == 0)
    assert "--- generation (6 tokens" in placed[0][1]
    assert placed[0][1].split("---")[-1] == replicated[0][1].split("---")[-1]


def test_num_servers_that_does_not_divide_the_world_is_a_flag_error(runs8):
    _, _, outs, _ = runs8
    assert [code for code, _ in outs["num-servers 3"]] == [2] * 8
    with pytest.raises(SystemExit):  # 3 does not divide the JAX CLI's 8 devices either
        jax_main.main(["--steps", "2", "--seq-len", "64", "--num-servers", "3"])


def test_the_world_of_eight_names_its_mesh(runs8):
    _, _, outs, _ = runs8
    lines = outs["num-servers 2"][0][1].splitlines()
    assert lines[0].startswith("devices=8 (data=4 x server=2) attention=ring_flash")
    assert outs["fsdp zero1"][0][1].startswith("devices=8 (data=8 x server=1)")
    assert all(text == "" for code, text in outs["num-servers 2"][1:])
