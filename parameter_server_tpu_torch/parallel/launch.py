"""Start a world of ranks on this host, each in a process of its own.

The port's counterpart of ``script/local.sh`` for one host: rank ``r``
of ``world`` runs ``fn(*args)`` in a fresh Python process (a new
interpreter, never a ``fork``: a CUDA context does not survive one, and
the caller's main script is not run again), on ``cuda:(r mod
device_count)`` or the device type the caller names, after joining the
world through ``distributed.initialize`` over a ``FileStore`` in a
private directory (no port to collide with another world). ``fn`` is a
function of an importable module (the ranks import it by name, with the
caller's ``sys.path``); each rank's return value comes back pickled, in
rank order.

No rank hangs the caller: the world has a time limit; when a rank fails
or the limit passes, every rank still running is killed and
:class:`WorldError` carries each failed rank's traceback.

    from parameter_server_tpu_torch.parallel import launch
    results = launch.run_world(my_module.fn, 4, args=(...,), device_type="cpu")
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

__all__ = ["run_world", "WorldError"]

#: after a rank fails, how long the others have to report their own
#: failures (a peer's often follows from it) before every rank is killed
FAIL_GRACE_S = 5.0


class WorldError(RuntimeError):
    """A rank of a world failed, died or ran past the world's time limit."""


def _rank_main(job: str, rank: int) -> None:
    """One rank: read the job, join the world, run ``fn``, and write its
    result (or its traceback) where the caller reads it, before leaving
    the world (a rank that fails is reported before its peers see it go)."""
    path = os.path.join(os.path.dirname(job), f"rank{rank}.pkl")

    def report(result) -> None:
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)

    try:
        with open(job, "rb") as f:
            spec = pickle.load(f)
        import torch

        from . import distributed

        if spec["threads"]:
            torch.set_num_threads(spec["threads"])
        distributed.initialize()
        try:
            result = ("ok", spec["fn"](*spec["args"]))
        except BaseException:  # noqa: BLE001 — the traceback goes back to the caller
            result = ("err", traceback.format_exc())
        report(result)
        distributed.shutdown()
    except BaseException:  # noqa: BLE001 — a failure to start, or to leave, the world
        if not os.path.exists(path):
            report(("err", traceback.format_exc()))


def run_world(fn: Callable, world: int, args: Sequence = (), timeout: Optional[float] = 300.0,
              device_type: Optional[str] = None, threads: int = 1, quiet: bool = False) -> List:
    """Run ``fn(*args)`` on every rank of a new world of ``world`` ranks
    and return their results in rank order. ``fn`` and ``args`` must
    pickle (``fn`` a module-level function of an importable module).
    ``device_type``: ``"cpu"`` or ``"cuda"`` (default: the card; a rank
    raises without one); the backend is ``distributed.choose_backend``'s;
    ``threads``: each rank's torch threads (0 leaves the default);
    ``quiet``: ranks past 0 print nothing. Raises :class:`WorldError`
    when a rank fails or the world outlives ``timeout`` seconds (None:
    no limit, a failing rank still fails it)."""
    work = tempfile.mkdtemp(prefix="ps_world_")
    job = os.path.join(work, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"fn": fn, "args": tuple(args), "threads": threads}, f)
    env = dict(os.environ, PS_COORDINATOR_ADDRESS="file://" + os.path.join(work, "store"),
               PS_NUM_PROCESSES=str(world),
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share this host
    if device_type:
        env["PS_DEVICE"] = device_type
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys; from parameter_server_tpu_torch.parallel "
                 "import launch; launch._rank_main(sys.argv[1], int(sys.argv[2]))", job, str(r)],
                env=dict(env, PS_PROCESS_ID=str(r)),
                stdout=subprocess.DEVNULL if quiet and r else None))
        deadline = time.monotonic() + (timeout if timeout is not None else float("inf"))
        results: dict = {}
        failed: dict = {}
        grace = None  # once a rank fails: when to stop waiting for the others' reports
        while len(results) + len(failed) < world:
            if grace is None and failed:
                grace = time.monotonic() + FAIL_GRACE_S
            if grace is not None and time.monotonic() > grace:
                break
            for r, p in enumerate(procs):
                if r in results or r in failed:
                    continue
                path = os.path.join(work, f"rank{r}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        status, value = pickle.load(f)
                    (results if status == "ok" else failed)[r] = value
                elif p.poll() is not None and not os.path.exists(path):
                    failed[r] = f"rank {r} died with exit code {p.returncode}"
            if time.monotonic() > deadline and grace is None:
                missing = [r for r in range(world) if r not in results]
                raise WorldError(f"world of {world} ranks ran past {timeout:.0f} s; ranks "
                                 f"{missing} had not finished")
            time.sleep(0.02)
        if failed:
            detail = "\n".join(f"--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items()))
            raise WorldError(f"{len(failed)} of {world} ranks failed:\n{detail}")
        for p in procs:
            p.wait(30)
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        shutil.rmtree(work, ignore_errors=True)
