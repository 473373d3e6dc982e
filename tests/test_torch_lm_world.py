"""PyTorch port: the LM CLI inside a launcher's world of 4 CPU ranks,
against the JAX CLI on a data axis of 4.

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

from parameter_server_tpu.apps.lm import main as jax_main
from parameter_server_tpu.models import transformer as J
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.models import transformer as T
from parameter_server_tpu_torch.parallel import launch
from tests import torch_seq_parallel_ranks as ranks

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
    assert lines[0].startswith("devices=4 (cpu) attention=ring_flash")
    assert "resumed from step 4" in outs[0][i][1]
