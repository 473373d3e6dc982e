"""Where the card and the CPU part on a mesh step: the CTR conf's first
ministeps through the linear CLI at ``--num-servers 2 --num-workers 2``,
once in a world of 4 ranks on the card and once on the CPU, every stage
of each rank's dense step recorded and held card to CPU.

    python -m parameter_server_tpu_torch.benchmarks.mesh_stages [--rows N] [--out PATH]

The stages, in the order the step runs them (``apps/linear/async_sgd.py``,
``_make_entry_mini_step`` and the push wire): the weights pulled over the
server axis (``pull_psum``), Xw by row (``xw``), the loss's row gradient
(``row_grad``), the shard gradient by slot (``g_shard``), the push
filter's codes (``codes``), the data axis's sum of the decoded
contributions and the touched masks (``push_psum``), the metrics' folds
(``fold_psum``), and the FTRL state after the update (``state``). Each
is recorded on the host as it leaves its function; for each rank and
ministep the script prints the first stage of the state's path whose
bits differ between the card and the CPU (every stage before it
bit-equal, so that stage made the difference), how many of its elements
differ and by how much, and how many of the metric folds differ. The ranks share the card over gloo, so this measures what
the card's arithmetic and gloo's reductions of CUDA tensors do, not
NCCL. Writes the summary to ``chiprun_out/mesh_stages.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import types
from typing import List

import numpy as np
import torch

#: the stages a ministep's state depends on, in the order the step runs
#: them; the metric folds (``fold_psum``: objective, counts and norms,
#: reduced after the update) are compared apart
STATE_PATH = ("pull_psum", "xw", "row_grad", "g_shard", "codes", "push_psum", "state")
FOLD_MAX = 64  # a psum of at most this many elements is a metric fold


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


@contextlib.contextmanager
def recorded_stages(sink: List[tuple]):
    """Patch the linear step's stage functions (their module names; the
    kernels and their launch counts are untouched) to append ``(stage,
    array)`` to ``sink`` on the host, in call order."""
    from ..apps.linear import async_sgd
    from ..apps.linear import loss as loss_mod
    from ..apps.linear import updaters

    saved = (async_sgd.psum, async_sgd._segment_sum, async_sgd.qops, loss_mod.LogitLoss.row_grad,
             updaters.FTRLUpdater.apply)
    qops = async_sgd.qops

    def psum(x, axis, mesh):
        out = saved[0](x, axis, mesh)
        if x.numel() <= FOLD_MAX:
            stage = "fold_psum"
        else:
            stage = "pull_psum" if axis == "server" else "push_psum"
        sink.append((stage, _host(out)))
        return out

    def segment_sum(data, ids, n, presorted=False):
        out = saved[1](data, ids, n, presorted=presorted)
        sink.append(("xw" if presorted else "g_shard", _host(out)))
        return out

    def quantize(x, seed, num_bytes=1):
        q, lo, hi = qops.quantize(x, seed, num_bytes)
        sink.append(("codes", np.concatenate([_host(q).astype(np.float64),
                                              np.array([float(lo), float(hi)])])))
        return q, lo, hi

    def row_grad(self, y, xw):
        out = saved[3](self, y, xw)
        sink.append(("row_grad", _host(out)))
        return out

    def apply(self, state, g, touched=None, **kw):
        out = saved[4](self, state, g, touched, **kw)
        sink.append(("state", np.concatenate([_host(state[k]).astype(np.float64).reshape(-1)
                                              for k in sorted(state)])))
        return out

    async_sgd.psum, async_sgd._segment_sum = psum, segment_sum
    async_sgd.qops = types.SimpleNamespace(quantize=quantize, dequantize=qops.dequantize)
    loss_mod.LogitLoss.row_grad, updaters.FTRLUpdater.apply = row_grad, apply
    try:
        yield sink
    finally:
        (async_sgd.psum, async_sgd._segment_sum, async_sgd.qops, loss_mod.LogitLoss.row_grad,
         updaters.FTRLUpdater.apply) = saved


def stage_rank(argv: List[str]) -> dict:
    """The linear CLI on this rank with every stage recorded."""
    from ..apps.linear import main as linear_main
    from ..parallel import distributed

    sink: List[tuple] = []
    with contextlib.redirect_stdout(io.StringIO()), recorded_stages(sink):
        rc = linear_main.main(argv)
    return {"rc": rc, "rank": distributed.dist.get_rank(), "stages": sink}


def _ministeps(stages: List[tuple]) -> List[List[tuple]]:
    """A rank's records cut into ministeps, each from its weights' pull
    to the metric folds after its update."""
    out = []
    for rec in stages:
        if rec[0] == "pull_psum" or not out:
            out.append([])
        out[-1].append(rec)
    return out


def compare(card: List[dict], cpu: List[dict]) -> List[dict]:
    """For each rank and ministep: the first stage of the state's path
    whose bits differ between the two worlds (None: the state's whole path
    bit-equal), its differing elements and largest |diff|, and how many
    of the metric folds differ."""
    rows = []
    for rc, rh in zip(card, cpu):
        for i, (mc, mh) in enumerate(zip(_ministeps(rc["stages"]), _ministeps(rh["stages"]))):
            row = {"rank": rc["rank"], "ministep": i, "first": None}
            if [s for s, _ in mc] != [s for s, _ in mh]:
                row["first"] = "stage order"
                rows.append(row)
                continue
            folds = [(a, b) for (name, a), (_, b) in zip(mc, mh) if name == "fold_psum"]
            row["folds_differing"] = sum(a.tobytes() != b.tobytes() for a, b in folds)
            row["folds"] = len(folds)
            for (name, a), (_, b) in zip(mc, mh):
                if name in STATE_PATH and a.tobytes() != b.tobytes():
                    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
                    row.update(first=name, elements=int(a.size),
                               differing=int(np.count_nonzero(diff)),
                               max_abs_diff=float(diff.max()))
                    break
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=70_000, help="CTR rows (10,000 a ministep)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "mesh_stages.json"))
    ap.add_argument("--devices", default="cuda,cpu", help="the two worlds' device types")
    args = ap.parse_args(argv)
    import importlib

    from ..parallel import launch
    from .ctr import ctr_conf, write_ctr_shards

    # the ranks import the rank function by its module's name (run as -m,
    # this file is __main__, which a rank cannot import)
    rank_fn = importlib.import_module(__spec__.name if __spec__ else __name__).stage_rank

    kinds = args.devices.split(",")
    worlds = {}
    with tempfile.TemporaryDirectory(prefix="mesh_stages_") as tmp:
        write_ctr_shards(os.path.join(tmp, "data"), 1, args.rows, args.seed)
        for kind in kinds:
            path = os.path.join(tmp, f"{kind}.conf")
            with open(path, "w") as f:
                f.write(ctr_conf(os.path.join(tmp, "data", "part.*"),
                                 os.path.join(tmp, kind, "model"), num_data_pass=1))
            worlds[kind] = launch.run_world(
                rank_fn, 4, args=([path, "--num-servers", "2", "--num-workers", "2"],),
                device_type=kind, timeout=900, threads=0 if kind == "cuda" else 2)
    for kind, ranks in worlds.items():
        if any(r["rc"] != 0 for r in ranks):
            print(f"mesh_stages: the {kind} world failed", file=sys.stderr)
            return 1
    rows = compare(worlds[kinds[0]], worlds[kinds[1]])
    firsts = {}
    for r in rows:
        key = r["first"] or "none"
        firsts[key] = firsts.get(key, 0) + 1
    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {"worlds": kinds, "ministeps": len(rows) // 4, "first_differing_stage": firsts,
               "rows": rows}
    if torch.cuda.is_available():
        summary["device"] = torch.cuda.get_device_name(0)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"first_differing_stage": firsts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
