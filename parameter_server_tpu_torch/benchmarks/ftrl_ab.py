"""The two FTRL kernels of this checkout against another build of the
same C interface (an earlier commit's source), in one process on one
card, timed in turns: other, this, this, other.

    python3 -m parameter_server_tpu_torch.benchmarks.ftrl_ab --other DIR [--reps 20]

DIR holds the other ``ftrl_dense.cu`` / ``ftrl_sparse.cu`` and the
headers they include, for example ``git archive <commit>
parameter_server_tpu_torch/kernels/csrc`` unpacked; it is built with the
port's own flags into DIR. The cases are the main paths' shapes:

- dense, P 2^22, ``g != 0`` at 19% of the slots (a headline batch), f32
  and bf16 √n with a seed;
- dense with a mask, P 2^22, f32, the mask ``g != 0`` at 0.0055 of the
  slots (the CTR step's measured share);
- dense, P 2^26, f32, ``g != 0`` at 19%;
- dense with a mask, P 2^22, the mask ``g != 0`` at 19% and 5% more
  (``chip_smoke.py``'s dense masked cases), f32 and bf16 √n with a seed;
- sparse on a real headline batch (U 798,720, sorted ``rel`` with its
  sentinel tail), f32 and bf16 √n with a seed.

Each turn gives each case's median time over ``--reps`` launches on a
cold L2 (CUDA events, ``timing.median_ms``), its GB/s over the bound's
bytes and its share of the bound, beside the sector floor
(``ftrl_bytes.py`` counts both from the inputs; the same count in 64-byte
granules beside it), and the host's
time to launch it (the C entry point through ctypes: the median over 5
rounds of 100 back-to-back launches, host clock, taken before the card
is waited for). Every build's output of each case, from the same state, must be
bit-equal to the plain version's (and so to each other's); the exit code
is 1 if one is not. Prints one
line a turn and writes ``chiprun_out/ftrl_ab.json``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

import torch

from .. import kernels
from ..ops import ftrl, ftrl_sparse
from . import ftrl_bytes
from .flash_ab import build_other, nvidia_smi, turn_order
from .headline import ALPHA, BETA, L1, SLOTS, sparse_update_inputs
from .kernel_report import ROOT
from .timing import median_ms

KW = dict(alpha=ALPHA, beta=BETA, l1=L1, l2=0.0)
SEED = 7  # the bf16 dither's
# dense cases: (name, P, √n dtype, masked, seed, share of slots with a
# gradient, share the mask adds where the gradient is zero)
DENSE = [
    ("dense 2^22 f32", 1 << 22, torch.float32, False, None, 0.19, 0.0),
    ("dense 2^22 bf16 seed", 1 << 22, torch.bfloat16, False, SEED, 0.19, 0.0),
    ("dense 2^22 f32 mask 0.0055", 1 << 22, torch.float32, True, None, 0.0055, 0.0),
    ("dense 2^26 f32", 1 << 26, torch.float32, False, None, 0.19, 0.0),
    ("dense 2^22 f32 mask 0.23", 1 << 22, torch.float32, True, None, 0.19, 0.05),
    ("dense 2^22 bf16 seed mask 0.23", 1 << 22, torch.bfloat16, True, SEED, 0.19, 0.05),
]
SPARSE = [("sparse U 798720 f32", torch.float32, None),
          ("sparse U 798720 bf16 seed", torch.bfloat16, SEED)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _seed_args(seed):
    return int(seed is not None), 0 if seed is None else seed


def dense_case(name, p, n_dtype, masked, seed, frac, extra, gen) -> dict:
    z0 = torch.randn(p, device="cuda", generator=gen)
    n0 = (torch.rand(p, device="cuda", generator=gen) * 2).to(n_dtype)
    g = torch.randn(p, device="cuda", generator=gen)
    g[torch.rand(p, device="cuda", generator=gen) > frac] = 0.0
    mask = (g != 0) | (torch.rand(p, device="cuda", generator=gen) < extra) if masked else None
    stream = torch.cuda.current_stream().cuda_stream
    z, n = z0.clone(), n0.clone()

    def run(lib, z=z, n=n):
        kernels.check(lib.ftrl_dense_launch(
            z.data_ptr(), n.data_ptr(), int(n_dtype == torch.bfloat16), g.data_ptr(),
            None if mask is None else mask.data_ptr(), p, *KW.values(), *_seed_args(seed),
            stream), name)

    def plain(z, n):
        ftrl.ftrl_update_ref(z, n, g, mask, **KW, seed=seed)

    keep = g != 0 if mask is None else mask
    need = ftrl_bytes.dense_counts(keep, n0.element_size(), masked)
    need["granule64_bytes"] = ftrl_bytes.dense_counts(keep, n0.element_size(), masked,
                                                      granule=64)["sector_bytes"]
    return dict(name=name, run=run, plain=plain, state=(z0, n0), work=(z, n), p=p, **need)


def sparse_case(name, n_dtype, seed, rel, ok, g_u, gen) -> dict:
    z0 = torch.randn(SLOTS, device="cuda", generator=gen)
    n0 = (torch.rand(SLOTS, device="cuda", generator=gen) * 2).to(n_dtype)
    stream = torch.cuda.current_stream().cuda_stream
    z, n = z0.clone(), n0.clone()

    def run(lib, z=z, n=n):
        kernels.check(lib.ftrl_sparse_launch(
            z.data_ptr(), n.data_ptr(), int(n_dtype == torch.bfloat16), rel.data_ptr(),
            ok.data_ptr(), g_u.data_ptr(), rel.numel(), *KW.values(), *_seed_args(seed),
            stream), name)

    def plain(z, n):
        ftrl_sparse.ftrl_sparse_rows_ref(z, n, rel, ok, g_u, **KW, seed=seed)

    need = ftrl_bytes.sparse_counts(rel, ok, g_u, n0.element_size())
    need["granule64_bytes"] = ftrl_bytes.sparse_counts(rel, ok, g_u, n0.element_size(),
                                                       granule=64)["sector_bytes"]
    return dict(name=name, run=run, plain=plain, state=(z0, n0), work=(z, n), u=rel.numel(),
                **need)


def bit_equal(case: dict, libs: dict) -> dict:
    """Build -> whether its result from the case's first state equals the
    plain version's, bit for bit."""
    ref = [t.clone() for t in case["state"]]
    case["plain"](*ref)
    same = {}
    for build, lib in libs.items():
        z, n = (t.clone() for t in case["state"])
        case["run"](lib, z=z, n=n)
        torch.cuda.synchronize()
        same[build] = torch.equal(_bits(z), _bits(ref[0])) and torch.equal(_bits(n), _bits(ref[1]))
    return same


def host_us(fn, launches: int = 100, rounds: int = 5) -> float:
    """Median host microseconds a launch of ``fn`` over ``rounds`` runs of
    ``launches`` back-to-back launches (the card is waited for after each
    round, outside the clock)."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        times.append((time.perf_counter() - t0) / launches * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="directory with the other kernel sources and their headers")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ftrl_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi, flush=True)
    libs = {}
    for lib_name in ("ftrl_dense", "ftrl_sparse"):
        libs[lib_name] = {"other": build_other(lib_name, args.other.resolve()),
                          "this": kernels.library(lib_name)}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cases = [dense_case(*c, gen) for c in DENSE]
    rel, ok, g_u = sparse_update_inputs(args.seed + 1_000_000, gen)
    cases += [sparse_case(*c, rel, ok, g_u, gen) for c in SPARSE]
    rows = {}
    for case in cases:
        lib_name = "ftrl_dense" if case["name"].startswith("dense") else "ftrl_sparse"
        case["libs"] = libs[lib_name]
        rows[case["name"]] = dict(
            members=case["members"], bytes=case["bytes"], sector_bytes=case["sector_bytes"],
            granule64_bytes=case["granule64_bytes"], bound_ms=ftrl_bytes.ms(case["bytes"]),
            sector_floor_ms=ftrl_bytes.ms(case["sector_bytes"]),
            bit_equal=bit_equal(case, case["libs"]))
    turns = []
    for build in turn_order([]):
        t = {"build": build}
        for case in cases:
            r = rows[case["name"]]
            ms = median_ms(lambda: case["run"](case["libs"][build]), args.reps)
            t[case["name"]] = dict(ms=ms, gb_per_s=case["bytes"] / ms / 1e6,
                                   share_of_bound=r["bound_ms"] / ms,
                                   share_of_sector_floor=r["sector_floor_ms"] / ms,
                                   host_us=host_us(lambda: case["run"](case["libs"][build])))
        turns.append(t)
        print(f"# turn {len(turns)} ({build}): " + "; ".join(
            f"{name} {v['ms']:.4f} ms ({v['gb_per_s']:.0f} GB/s, {v['share_of_bound']:.3f} of its "
            f"bound, {v['share_of_sector_floor']:.3f} of its sector floor, host {v['host_us']:.2f} us "
            f"a launch)"
            for name, v in t.items() if name != "build") + f" [{smi}]", flush=True)
    for name, r in rows.items():
        print(f"# {name}: members {r['members']}, bound {r['bound_ms']:.4f} ms ({r['bytes']} B), "
              f"sector floor {r['sector_floor_ms']:.4f} ms ({r['sector_bytes']} B; in 64-byte "
              f"granules {r['granule64_bytes']} B); bit-equal to the "
              f"plain version, by build: {r['bit_equal']} [{smi}]", flush=True)
    record = dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0), reps=args.reps,
                  cases=rows, turns=turns)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ftrl_ab.json"), "w") as f:
        json.dump(record, f, indent=1)
    return 0 if all(all(r["bit_equal"].values()) for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
