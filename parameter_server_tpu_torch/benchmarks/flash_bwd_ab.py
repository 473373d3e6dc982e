"""The backward kernels ``flash_bwd_dq`` and ``flash_bwd_dkv`` of this
checkout against another build of the same C interface (an earlier
commit's ``flash_bwd.cu``), in one process on one card, timed in turns:
other, this, this, other (with ``--variant``, those builds in between).

    python3 -m parameter_server_tpu_torch.benchmarks.flash_bwd_ab --other DIR [--reps 20]

DIR holds the other ``flash_bwd.cu`` and the headers it includes, for
example ``git archive <commit> parameter_server_tpu_torch/kernels/csrc``
unpacked; it is built with the port's own flags into DIR. At the LM
training shape (B·H 32, S 8192, D 64, bf16, causal) each turn gives each
kernel's median time over ``--reps`` launches on a cold L2 (CUDA
events), its TFLOP/s over the (query, key) pairs the mask keeps and its
share of its bound (the larger of its operations at 989 TFLOP/s bf16
and its bytes at 3.35 TB/s). Beside them, once: SDPA's backward and
forward (``torch.nn.functional.scaled_dot_product_attention``,
``is_causal``) and ``flash_fwd``. The two builds' gradients at that shape
are compared (max |diff|, all finite). Prints one line a turn and writes
``chiprun_out/flash_bwd_ab.json``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from .. import kernels
from ..ops import flash_attention as fa
from .kernel_report import ROOT

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
WARMUP = 3
_flush = None


def nvidia_smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after
    256 MB written (the 50 MB L2 holds none of the inputs)."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _flush.fill_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def build_other(src_dir: pathlib.Path):
    """The other ``flash_bwd.cu`` built with the port's flags, loaded with
    the same C signatures."""
    lib = src_dir / "flash_bwd_other.so"
    cmd = [kernels._nvcc(), *kernels._flags("flash_bwd"), "-I", str(src_dir), "-o", str(lib),
           str(src_dir / "flash_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return kernels._load("flash_bwd", lib)


def consumer_clocks(lib):
    """For a FLASH_BWD_CLOCKS build: zero its cycle sums and return a
    function that reads them, as mean cycles a computed tile by phase and
    of a consumer warpgroup's whole life; else None."""
    fn = getattr(lib, "flash_bwd_clocks", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_ulonglong * 11)()
    kernels.check(fn(ctypes.addressof(buf)), "flash_bwd_clocks")

    def read() -> dict:
        torch.cuda.synchronize()
        kernels.check(fn(ctypes.addressof(buf)), "flash_bwd_clocks")
        tiles = max(buf[4], 1)
        return {phase: buf[i] / tiles for i, phase in
                enumerate(("wait", "s_dp", "softmax", "grad_products"))} | {
                    "life": buf[5] / tiles, "release": buf[7] / tiles, "own_wait": buf[8] / tiles,
                    "loop_top": buf[9] / tiles, "before_math": buf[10] / tiles,
                    "tiles": buf[4], "warpgroups": buf[6]}
    return read


def kept_pairs(s: int) -> int:
    return s * (s + 1) // 2  # causal, no offsets: query i keeps keys 0..i


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="directory with the other flash_bwd.cu and its headers")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", action="append", default=[], metavar="MACRO",
                    help="also time this checkout built with -DMACRO (timing diagnostics such "
                         "as FLASH_BWD_NO_LOAD, FLASH_BWD_NO_MATH, FLASH_BWD_CLOCKS; their gradients "
                         "are not checked)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(smi, flush=True)
    libs = {"other": build_other(args.other.resolve()), "this": kernels.library("flash_bwd")}
    for macro in args.variant:
        libs[macro] = kernels.variant("flash_bwd", macro)

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
    for name, lib in (("other", libs["other"]), ("this", libs["this"])):
        run_dq(lib)
        run_dkv(lib)
        torch.cuda.synchronize()
        grads[name] = [t.clone() for t in (dq, dk, dv)]
    finite = all(bool(torch.isfinite(t.float()).all()) for g in grads.values() for t in g)
    apart = {n: float((x.float() - y.float()).abs().max())
             for n, x, y in zip(("dq", "dk", "dv"), grads["this"], grads["other"])}

    pairs = kept_pairs(s) * bh
    inputs = 4 * bh * s * d * 2 + 2 * bh * s * 4  # q, k, v, do; lse, c
    flop = {"dq": 6 * d * pairs, "dkv": 8 * d * pairs}  # S, dP, dQ; S, dP, dV, dK
    nbytes = {"dq": inputs + bh * s * d * 2, "dkv": inputs + 2 * bh * s * d * 2}
    bound = {kname: max(flop[kname] / BF16_FLOP_PER_S, nbytes[kname] / HBM_BYTES_PER_S) * 1e3
             for kname in flop}
    turns = []
    for name in ("other", "this", *args.variant, *args.variant[::-1], "this", "other"):
        lib = libs[name]
        t = {"build": name}
        for kname, run in (("dq", run_dq), ("dkv", run_dkv)):
            clocks = consumer_clocks(lib)
            t[f"{kname}_ms"] = median_ms(lambda: run(lib), args.reps)
            if clocks is not None:
                t[f"{kname}_cycles_per_tile"] = clocks()
                print(f"# {name} {kname}: consumer cycles a 64 x 64 tile {t[f'{kname}_cycles_per_tile']}",
                      flush=True)
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
    record = dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0), bh=bh, s=s, d=d,
                  dtype="bfloat16", causal=True, reps=args.reps, pairs=pairs,
                  dq_bound_ms=bound["dq"], dkv_bound_ms=bound["dkv"], turns=turns,
                  sdpa_bwd_ms=sdpa_bwd_ms, sdpa_fwd_ms=sdpa_fwd_ms, flash_fwd_ms=fwd_ms,
                  builds_max_abs_apart=apart, all_finite=finite)
    print(f"# bounds (operations): dq {bound['dq']:.4f} ms, dkv {bound['dkv']:.4f} ms; SDPA backward "
          f"{sdpa_bwd_ms:.4f} ms, SDPA forward {sdpa_fwd_ms:.4f} ms, flash_fwd {fwd_ms:.4f} ms; this vs "
          f"other build max |diff| {apart}, all finite {finite} [{smi}]", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "flash_bwd_ab.json"), "w") as f:
        json.dump(record, f, indent=1)
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
