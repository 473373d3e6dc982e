"""PyTorch port: the serve CLI inside a launcher's world of CPU ranks,
against the JAX CLI.

``parallel/launch.run_world`` starts 4 ranks, each running
``parameter_server_tpu_torch.apps.serve.main.main`` by its import name
(the launcher's environment on every rank): the table is built on the
postoffice's auto-shaped 4 x 1 mesh, as the JAX CLI builds it over every
device; rank 0 serves and prints, the other ranks follow its store
calls. The records hold the JAX CLI's (run here on one process with the
same flags): the same metrics in the same order, the same keys, the same
non-timing fields; the last one adds the mesh's shape and the digest of
the table, which the ranks agreed at the end (the CLI raises on every
rank where two replicas of the table differ).
"""

import json

import pytest

from parameter_server_tpu.apps.serve import main as jmain
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch.apps.serve import main as tmain
from parameter_server_tpu_torch.parallel import launch
from tests.test_torch_serve_cli import ARGS, TIMING


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("flags", [["--replica", "full", "--train-while-serving"],
                                   ["--replica", "off"]])
def test_serve_cli_in_a_world_of_four(capfd, flags):
    argv = ARGS + flags
    JPostoffice.reset()
    try:
        assert jmain.main(argv) == 0
    finally:
        JPostoffice.reset()
    theirs = _lines(capfd.readouterr().out)
    codes = launch.run_world(tmain.main, 4, args=(argv + ["--device", "cpu"],),
                             device_type="cpu", timeout=180)
    ours = _lines(capfd.readouterr().out)  # rank 0 alone prints
    assert codes == [0, 0, 0, 0]
    assert [r["metric"] for r in ours] == [r["metric"] for r in theirs] == [
        "serve_closed_loop_capacity", "serve_open_loop_point", "serve_open_loop_point",
        "serve_frontend_stats"]
    for a, b in zip(ours, theirs):
        extra = set(a) - set(b)
        assert set(b) <= set(a) and extra <= {"mesh", "table_digest"}
        assert {k: v for k, v in a.items() if k not in TIMING | extra} == {
            k: v for k, v in b.items() if k not in TIMING}
    stats = ours[-1]
    assert stats["mesh"] == {"data": 4, "server": 1}
    assert len(stats["table_digest"]) == 16
    assert stats["degraded_served"] == 0
    for p in ours[1:3]:
        assert p["n_errors"] == 0 and p["completed"] == p["accepted"]
        assert p["train_while_serving"] is ("--train-while-serving" in flags)
