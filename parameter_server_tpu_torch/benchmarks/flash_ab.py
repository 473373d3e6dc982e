"""The flash-attention kernels of this checkout against another build of
the same C interface (an earlier commit's source), in one process on one
card, timed in turns: other, this, this, other (with ``--variant``, those
builds in between).

    python3 -m parameter_server_tpu_torch.benchmarks.flash_ab --kernel fwd|bwd --other DIR
        [--reps 20] [--variant MACRO ...]

DIR holds the other ``flash_fwd.cu`` / ``flash_bwd.cu`` and the headers
they include, for example ``git archive <commit>
parameter_server_tpu_torch/kernels/csrc`` unpacked; it is built with the
port's own flags into DIR. Each turn gives each kernel's median time over
``--reps`` launches on a cold L2 (CUDA events, ``timing.median_ms``), its
TFLOP/s over the (query, key) pairs the causal mask keeps and its share of
its bound (the larger of its operations at 989 TFLOP/s bf16 and its bytes
at 3.35 TB/s).

``--kernel bwd``: ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the LM training
shape (B·H 32, S 8192, D 64, bf16, causal); beside them, once, SDPA's
backward and forward (``torch.nn.functional.scaled_dot_product_attention``,
``is_causal``) and ``flash_fwd``.

``--kernel fwd``: ``flash_fwd`` at the training shape, at the serving
prefill (B·H 64, S 2048, D 64, K/V shared by groups of 4) and at D 128 (B·H
64, S 2048); beside them, once a shape, SDPA's forward, and the MUFU floor:
one exponential a kept pair, 16 a clock on each of the 132 SMs, at the
card's top SM clock (``nvidia-smi clocks.max.sm``).

The builds' outputs at each shape are compared (max |diff|, all finite).
A ``FLASH_*_CLOCKS`` variant also prints its consumers' cycles a tile by
phase. Prints one line a turn and writes ``chiprun_out/flash_ab_<kernel>.json``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys

import torch

from .. import kernels
from ..ops import flash_attention as fa
from .kernel_report import ROOT
from .timing import median_ms

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
EXP_PER_CLOCK = 16 * 132  # MUFU ex2 a clock: 16 on each SM of an H100 SXM
# consumer cycle phases of a FLASH_*_CLOCKS build, by slot (csrc/flash_common.cuh)
_PHASES = {
    "bwd": {0: "wait", 1: "s_dp", 2: "softmax", 3: "grad_products", 7: "release",
            8: "own_wait", 9: "loop_top", 10: "before_math"},
    "fwd": {0: "tile_wait", 1: "s", 2: "softmax", 3: "pv_wait", 7: "release", 11: "pack",
            8: "q_wait", 9: "loop_gap"},
}
# fwd shapes: (name, B·H, S, D, group)
FWD_SHAPES = [("training", 32, 8192, 64, 1), ("prefill", 64, 2048, 64, 4), ("D128", 64, 2048, 128, 1)]


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def build_other(name: str, src_dir: pathlib.Path, signatures=None):
    """The other ``<name>.cu`` built with the port's flags, loaded with
    the same C signatures (or ``signatures``, where they differ)."""
    lib = src_dir / f"{name}_other.so"
    cmd = [kernels._nvcc(), *kernels._flags(name), "-I", str(src_dir), "-o", str(lib),
           str(src_dir / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return kernels._load(name, lib, signatures)


def consumer_clocks(lib, kernel: str):
    """For a FLASH_*_CLOCKS build: zero its cycle sums and return a
    function that reads them, as mean cycles a computed tile by phase and
    of a consumer warpgroup's whole life; else None."""
    fn = getattr(lib, f"flash_{kernel}_clocks", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_ulonglong * 12)()
    kernels.check(fn(ctypes.addressof(buf)), "clocks")

    def read() -> dict:
        torch.cuda.synchronize()
        kernels.check(fn(ctypes.addressof(buf)), "clocks")
        tiles = max(buf[4], 1)
        return {phase: buf[i] / tiles for i, phase in _PHASES[kernel].items()} | {
            "life": buf[5] / tiles, "tiles": buf[4], "warpgroups": buf[6]}
    return read


def kept_pairs(s: int) -> int:
    return s * (s + 1) // 2  # causal, no offsets: query i keeps keys 0..i


def bound_ms(flop: float, nbytes: float) -> float:
    return max(flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def turn_order(variants):
    return ("other", "this", *variants, *variants[::-1], "this", "other")


def timed(name: str, lib, kernel: str, what: str, run, reps: int, t: dict) -> None:
    """t[what_ms] = the median time of run(lib); a clocks build also
    records its cycles a tile."""
    clocks = consumer_clocks(lib, kernel)
    t[f"{what}_ms"] = median_ms(lambda: run(lib), reps)
    if clocks is not None:
        t[f"{what}_cycles_per_tile"] = clocks()
        print(f"# {name} {what}: consumer cycles a tile {t[f'{what}_cycles_per_tile']}", flush=True)


def run_bwd(args, libs, smi: str) -> dict:
    bh, s, d = 32, 8192, 64
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.launch_kernel(q, k, v, causal=True)
    c = (do.float() * out.float()).sum(-1)
    dims = fa._dims(q, k, 0, 0, True, None, 1)
    stream = torch.cuda.current_stream().cuda_stream
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

    def run_dq(lib):
        kernels.check(lib.flash_bwd_dq_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                              lse.data_ptr(), c.data_ptr(), dq.data_ptr(), *dims,
                                              stream), "flash_bwd_dq")

    def run_dkv(lib):
        kernels.check(lib.flash_bwd_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               do.data_ptr(), lse.data_ptr(), c.data_ptr(),
                                               dk.data_ptr(), dv.data_ptr(), *dims, stream),
                      "flash_bwd_dkv")

    grads = {}
    for name in ("other", "this"):
        run_dq(libs[name])
        run_dkv(libs[name])
        torch.cuda.synchronize()
        grads[name] = [t.clone() for t in (dq, dk, dv)]
    finite = all(bool(torch.isfinite(t.float()).all()) for g in grads.values() for t in g)
    apart = {n: float((x.float() - y.float()).abs().max())
             for n, x, y in zip(("dq", "dk", "dv"), grads["this"], grads["other"])}

    pairs = kept_pairs(s) * bh
    inputs = 4 * bh * s * d * 2 + 2 * bh * s * 4  # q, k, v, do; lse, c
    flop = {"dq": 6 * d * pairs, "dkv": 8 * d * pairs}  # S, dP, dQ; S, dP, dV, dK
    nbytes = {"dq": inputs + bh * s * d * 2, "dkv": inputs + 2 * bh * s * d * 2}
    bound = {kname: bound_ms(flop[kname], nbytes[kname]) for kname in flop}
    turns = []
    for name in turn_order(args.variant):
        t = {"build": name}
        for kname, run in (("dq", run_dq), ("dkv", run_dkv)):
            timed(name, libs[name], "bwd", kname, run, args.reps, t)
        for kname in ("dq", "dkv"):
            t[f"{kname}_tflop_per_s"] = flop[kname] / t[f"{kname}_ms"] / 1e9
            t[f"{kname}_share_of_bound"] = bound[kname] / t[f"{kname}_ms"]
        t["pair_ms"] = t["dq_ms"] + t["dkv_ms"]
        turns.append(t)
        print(f"# turn {len(turns)} ({name}): flash_bwd_dq {t['dq_ms']:.4f} ms "
              f"({t['dq_tflop_per_s']:.1f} TFLOP/s, {t['dq_share_of_bound']:.3f} of its bound), "
              f"flash_bwd_dkv {t['dkv_ms']:.4f} ms ({t['dkv_tflop_per_s']:.1f} TFLOP/s, "
              f"{t['dkv_share_of_bound']:.3f} of its bound), pair {t['pair_ms']:.4f} ms [{smi}]",
              flush=True)

    qs, ks, vs = (t[None].detach().requires_grad_() for t in (q, k, v))
    sdpa_fwd_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs.detach(), ks.detach(), vs.detach(), is_causal=True), args.reps)
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa_bwd_ms = median_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do[None],
                                                        retain_graph=True), args.reps)
    del sdpa_out
    fwd_ms = median_ms(lambda: fa.launch_kernel(q, k, v, causal=True), args.reps)
    print(f"# bounds (operations): dq {bound['dq']:.4f} ms, dkv {bound['dkv']:.4f} ms; SDPA backward "
          f"{sdpa_bwd_ms:.4f} ms, SDPA forward {sdpa_fwd_ms:.4f} ms, flash_fwd {fwd_ms:.4f} ms; this vs "
          f"other build max |diff| {apart}, all finite {finite} [{smi}]", flush=True)
    return dict(bh=bh, s=s, d=d, pairs=pairs, dq_bound_ms=bound["dq"], dkv_bound_ms=bound["dkv"],
                turns=turns, sdpa_bwd_ms=sdpa_bwd_ms, sdpa_fwd_ms=sdpa_fwd_ms, flash_fwd_ms=fwd_ms,
                builds_max_abs_apart=apart, all_finite=finite)


def run_fwd(args, libs, smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    clock_hz = max_sm_clock_hz()
    shapes, runs = {}, {}
    for name, bh, s, d, group in FWD_SHAPES:
        q = torch.randn(bh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
        k, v = (torch.randn(bh // group, s, d, device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(2))
        out, lse = torch.empty_like(q), torch.empty(bh, s, device="cuda")
        dims = fa._dims(q, k, 0, 0, True, None, group)

        def run(lib, q=q, k=k, v=v, out=out, lse=lse, dims=dims):
            kernels.check(lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               out.data_ptr(), lse.data_ptr(), *dims, stream),
                          "flash_fwd")

        got = {}
        for build in ("other", "this"):
            run(libs[build])
            torch.cuda.synchronize()
            got[build] = (out.clone(), lse.clone())
        pairs = kept_pairs(s) * bh
        nbytes = (2 * bh * s * d + 2 * (bh // group) * s * d) * 2 + bh * s * 4
        gqa = {"enable_gqa": True} if group > 1 else {}
        shapes[name] = dict(
            bh=bh, s=s, d=d, group=group, pairs=pairs, flop=4 * d * pairs, bytes=nbytes,
            bound_ms=bound_ms(4 * d * pairs, nbytes), mufu_floor_ms=pairs / (EXP_PER_CLOCK * clock_hz) * 1e3,
            sdpa_ms=median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True, **gqa), args.reps),
            builds_max_abs_apart=dict(
                out=float((got["this"][0].float() - got["other"][0].float()).abs().max()),
                lse=float((got["this"][1] - got["other"][1]).abs().max())),
            all_finite=all(bool(torch.isfinite(x.float()).all()) for g in got.values() for x in g))
        runs[name] = run
    turns = []
    for build in turn_order(args.variant):
        t = {"build": build}
        for name, run in runs.items():
            timed(build, libs[build], "fwd", name, run, args.reps, t)
            sh = shapes[name]
            t[f"{name}_tflop_per_s"] = sh["flop"] / t[f"{name}_ms"] / 1e9
            t[f"{name}_share_of_bound"] = sh["bound_ms"] / t[f"{name}_ms"]
        turns.append(t)
        print(f"# turn {len(turns)} ({build}): " + ", ".join(
            f"{name} {t[f'{name}_ms']:.4f} ms ({t[f'{name}_tflop_per_s']:.1f} TFLOP/s, "
            f"{t[f'{name}_share_of_bound']:.3f} of its bound)" for name in runs) + f" [{smi}]", flush=True)
    for name, sh in shapes.items():
        print(f"# {name} (B*H {sh['bh']}, S {sh['s']}, D {sh['d']}, group {sh['group']}): bound "
              f"{sh['bound_ms']:.4f} ms (tensor FLOP), MUFU floor {sh['mufu_floor_ms']:.4f} ms at "
              f"{clock_hz / 1e6:.0f} MHz, SDPA forward {sh['sdpa_ms']:.4f} ms; this vs other build "
              f"max |diff| {sh['builds_max_abs_apart']}, all finite {sh['all_finite']} [{smi}]",
              flush=True)
    return dict(shapes=shapes, turns=turns, max_sm_clock_hz=clock_hz)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="bwd")
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="directory with the other kernel source and its headers")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", action="append", default=[], metavar="MACRO",
                    help="also time this checkout built with -DMACRO (A+B: both; timing "
                         "diagnostics such as FLASH_BWD_NO_LOAD, FLASH_BWD_NO_MATH, "
                         "FLASH_BWD_CLOCKS, FLASH_FWD_CLOCKS, FLASH_FWD_NO_SOFTMAX, "
                         "FLASH_FWD_NO_PV, FLASH_FWD_NO_LOAD; their results are not checked)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi, flush=True)
    lib_name = f"flash_{args.kernel}"
    libs = {"other": build_other(lib_name, args.other.resolve()), "this": kernels.library(lib_name)}
    for macro in args.variant:
        libs[macro] = kernels.variant(lib_name, *macro.split("+"))
    record = (run_fwd if args.kernel == "fwd" else run_bwd)(args, libs, smi)
    record = dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0), kernel=args.kernel,
                  dtype="bfloat16", causal=True, reps=args.reps, **record)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"flash_ab_{args.kernel}.json"), "w") as f:
        json.dump(record, f, indent=1)
    finite = record["all_finite"] if args.kernel == "bwd" else \
        all(sh["all_finite"] for sh in record["shapes"].values())
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
