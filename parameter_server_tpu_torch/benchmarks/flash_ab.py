"""The flash-attention kernels of this checkout against another build of
the same C interface (an earlier commit's source), in one process on one
card, timed in turns: other, this, this, other (with ``--variant``, those
builds in between).

    python3 -m parameter_server_tpu_torch.benchmarks.flash_ab --kernel fwd|bwd --other DIR
        [--dtype bfloat16|float32] [--reps 20] [--shape NAME ...] [--variant MACRO ...]

DIR holds the other ``flash_fwd.cu`` / ``flash_bwd.cu`` and the headers
they include, for example ``git archive <commit>
parameter_server_tpu_torch/kernels/csrc`` unpacked; it is built with the
port's own flags into DIR. Each turn gives each kernel's median time over
``--reps`` launches on a cold L2 (CUDA events, ``timing.median_ms``), its
TFLOP/s over the (query, key) pairs the causal mask keeps and its share of
its bound: bf16, the larger of its operations at 989 TFLOP/s and its bytes
at 3.35 TB/s; float32, the largest of its operations in 3xTF32 (three TF32
passes, 495 / 3 TFLOP/s: the least an f32-accurate product takes on the
tensor cores), its bytes and its MUFU floor. float32 also measures the
rate of the kernel's own instruction, mma.sync m16n8k8 TF32, alone
(``flash_fwd_tf32_mma_rate``), and prints each shape's products at a third
of it.

``--kernel bwd``: ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the LM training
shape (B·H 32, S 8192, D 64, bf16, causal); float32 (the LM CLI's default
dtype): at B·H 64 × S 2048 × D 64, at the LM's full width (B·H 32 × S
8192 × D 64), at the LM CLI's default (B·H 32 × S 256 × D 16) and at D 128
(B·H 64 × S 2048). Beside them, once a shape, SDPA's backward and forward
(``torch.nn.functional.scaled_dot_product_attention``, ``is_causal``) and
``flash_fwd``; in float32 also each kernel's products at a third of
mma.sync's TF32 rate.

``--kernel fwd``: ``flash_fwd`` at the training shape, at the serving
prefill (B·H 64, S 2048, D 64, K/V shared by groups of 4) and at D 128 (B·H
64, S 2048); float32: at B·H 64, S 2048, D 64, at a batcher join (B·H 128,
S 8, D 64), at the serve CLI's decode-lane prefill (B·H 16, S 64, D 16),
at D 128 (B·H 64, S 2048) and at S 8192 (B·H 8, D 64).
Beside them, once a shape, SDPA's forward and the MUFU floor: one
exponential a kept pair, 16 a clock on each of the 132 SMs, at the card's
top SM clock (``nvidia-smi clocks.max.sm``).

The builds' outputs at each shape are compared with each other (max
|diff|, bit-identical or not, all finite) and each build's with the plain
version (the backward's as a share of each gradient's largest |plain|).
A ``FLASH_*_CLOCKS`` variant also prints its consumers' cycles a tile by
phase. ``--shape`` times a subset of the shapes; a header line and the
JSON (``shapes_timed``, ``all_shapes``) name the shapes timed. Prints one
line a turn and writes ``chiprun_out/flash_ab_<kernel>.json``
(``flash_ab_<kernel>_float32.json`` with ``--dtype float32``).
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
F32_TC_FLOP_PER_S = 495e12 / 3  # 3xTF32: three TF32 passes a product
HBM_BYTES_PER_S = 3.35e12
EXP_PER_CLOCK = 16 * 132  # MUFU ex2 a clock: 16 on each SM of an H100 SXM
# consumer cycle phases of a FLASH_*_CLOCKS build, by slot (csrc/flash_common.cuh)
_PHASES = {
    "bwd": {0: "wait", 1: "s_dp", 2: "softmax", 3: "grad_products", 7: "release",
            8: "own_wait", 9: "loop_top", 10: "before_math"},
    "fwd": {0: "tile_wait", 1: "s", 2: "softmax", 3: "pv_wait", 7: "release", 11: "pack",
            8: "q_wait", 9: "loop_gap"},
}
# fwd shapes by dtype: (name, B·H, S, D, group)
FWD_SHAPES = {
    "bfloat16": [("training", 32, 8192, 64, 1), ("prefill", 64, 2048, 64, 4),
                 ("D128", 64, 2048, 128, 1)],
    "float32": [("prefill", 64, 2048, 64, 1), ("batcher_join", 128, 8, 64, 1),
                ("decode_lane_prefill", 16, 64, 16, 1), ("D128", 64, 2048, 128, 1),
                ("S8192", 8, 8192, 64, 1)],
}
# bwd shapes by dtype: (name, B·H, S, D)
BWD_SHAPES = {
    "bfloat16": [("training", 32, 8192, 64)],
    "float32": [("S2048", 64, 2048, 64), ("S8192", 32, 8192, 64), ("cli_default", 32, 256, 16),
                ("D128", 64, 2048, 128)],
}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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


def tf32_mma_tflop_per_s(lib, reps: int) -> float:
    """The card's mma.sync m16n8k8 TF32 rate in TFLOP/s: 8 blocks of 4
    warps an SM, each warp 4,096 rounds of 8 independent products
    (``flash_fwd_tf32_mma_rate``), timed by ``median_ms``."""
    fn = lib.flash_fwd_tf32_mma_rate
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    blocks, iters = 8 * 132, 4096
    sink = torch.empty(blocks, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = median_ms(lambda: kernels.check(fn(sink.data_ptr(), blocks, iters, stream), "tf32_mma_rate"),
                   reps)
    return blocks * 4 * iters * 8 * 2048 / ms / 1e9


def max_abs_vs_plain(q, k, v, group: int, got: dict, heads: int = 8) -> dict:
    """Each build's max |diff| from the plain version (causal), out and
    lse; the plain version runs about ``heads`` query heads at a time
    (whole groups)."""
    worst = {build: dict(out=0.0, lse=0.0) for build in got}
    heads = group * max(1, heads // group)
    for h in range(0, q.shape[0], heads):
        kv = slice(h // group, (h + heads) // group)
        want_out, want_lse = fa._flash_plain(q[h:h + heads], k[kv], v[kv], 0, 0, True, None, group)
        for build, (out, lse) in got.items():
            w = worst[build]
            w["out"] = max(w["out"], float((out[h:h + heads].float() - want_out.float()).abs().max()))
            w["lse"] = max(w["lse"], float((lse[h:h + heads] - want_lse).abs().max()))
    return worst


def kept_pairs(s: int) -> int:
    return s * (s + 1) // 2  # causal, no offsets: query i keeps keys 0..i


def bound_ms(flop: float, nbytes: float, dtype: str = "bfloat16", mufu_ms: float = 0.0) -> float:
    rate = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_TC_FLOP_PER_S
    t = max(flop / rate, nbytes / HBM_BYTES_PER_S) * 1e3
    return t if dtype == "bfloat16" else max(t, mufu_ms)


def bit_identical(xs, ys) -> bool:
    return all(torch.equal(x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32),
                           y.view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32))
               for x, y in zip(xs, ys))


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


def bwd_vs_plain(q, k, v, do, lse, c, got: dict, heads: int) -> dict:
    """Each build's largest |diff| from the plain backward (causal), as a
    share of each gradient's largest |plain|; the plain version runs
    ``heads`` query heads at a time."""
    worst = {build: dict(dq=0.0, dk=0.0, dv=0.0) for build in got}
    scale = dict(dq=0.0, dk=0.0, dv=0.0)
    diff = {build: dict(dq=0.0, dk=0.0, dv=0.0) for build in got}
    for h in range(0, q.shape[0], heads):
        sl = slice(h, h + heads)
        with torch.no_grad():
            want = fa.flash_attention_bwd_ref(q[sl], k[sl], v[sl], do[sl], lse[sl], c[sl], causal=True)
        for name, w in zip(("dq", "dk", "dv"), want):
            scale[name] = max(scale[name], float(w.float().abs().max()))
        for build, grads in got.items():
            for name, x, w in zip(("dq", "dk", "dv"), grads, want):
                diff[build][name] = max(diff[build][name], float((x[sl].float() - w.float()).abs().max()))
    for build in got:
        for name in worst[build]:
            worst[build][name] = diff[build][name] / max(scale[name], 1e-30)
    return dict(max_abs=diff, share_of_scale=worst, scale=scale)


def run_bwd(args, libs, smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    clock_hz = max_sm_clock_hz()
    mma_rate = None
    if args.dtype == "float32":  # the products' floor at the rate mma.sync reaches
        mma_rate = tf32_mma_tflop_per_s(kernels.library("flash_fwd"), args.reps)
        print(f"# mma.sync m16n8k8 TF32: {mma_rate:.1f} TFLOP/s on this card (3xTF32: "
              f"{mma_rate / 3:.1f} TFLOP/s of f32 products) [{smi}]", flush=True)
    shapes, runs = {}, {}
    for name, bh, s, d in BWD_SHAPES[args.dtype]:
        if args.shape and name not in args.shape:
            continue
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(DTYPES[args.dtype])
                       for _ in range(4))
        out, lse = fa.launch_kernel(q, k, v, causal=True)
        c = (do.float() * out.float()).sum(-1)
        del out
        dims = fa._dims(q, k, 0, 0, True, None, 1)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

        def run_dq(lib, q=q, k=k, v=v, do=do, lse=lse, c=c, dq=dq, dims=dims):
            kernels.check(lib.flash_bwd_dq_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                  do.data_ptr(), lse.data_ptr(), c.data_ptr(),
                                                  dq.data_ptr(), *dims, stream), "flash_bwd_dq")

        def run_dkv(lib, q=q, k=k, v=v, do=do, lse=lse, c=c, dk=dk, dv=dv, dims=dims):
            kernels.check(lib.flash_bwd_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                   do.data_ptr(), lse.data_ptr(), c.data_ptr(),
                                                   dk.data_ptr(), dv.data_ptr(), *dims, stream),
                          "flash_bwd_dkv")

        grads = {}
        for build in libs:
            run_dq(libs[build])
            run_dkv(libs[build])
            torch.cuda.synchronize()
            grads[build] = [t.clone() for t in (dq, dk, dv)]
        finite = all(bool(torch.isfinite(t.float()).all()) for b in ("other", "this") for t in grads[b])
        apart = {n: float((x.float() - y.float()).abs().max())
                 for n, x, y in zip(("dq", "dk", "dv"), grads["this"], grads["other"])}
        identical = bit_identical(grads["this"], grads["other"])
        vs_plain = bwd_vs_plain(q, k, v, do, lse, c, grads, max(1, (1 << 29) // (s * s)))
        del grads
        pairs = kept_pairs(s) * bh
        elt = q.element_size()
        inputs = 4 * bh * s * d * elt + 2 * bh * s * 4  # q, k, v, do; lse, c
        flop = {"dq": 6 * d * pairs, "dkv": 8 * d * pairs}  # S, dP, dQ; S, dP, dV, dK
        nbytes = {"dq": inputs + bh * s * d * elt, "dkv": inputs + 2 * bh * s * d * elt}
        mufu = pairs / (EXP_PER_CLOCK * clock_hz) * 1e3  # P recomputed in each kernel
        sh = dict(bh=bh, s=s, d=d, pairs=pairs, flop=flop, bytes=nbytes, mufu_floor_ms=mufu,
                  bound_ms={kname: bound_ms(flop[kname], nbytes[kname], args.dtype, mufu)
                            for kname in flop},
                  builds_max_abs_apart=apart, builds_bit_identical=identical, all_finite=finite,
                  vs_plain=vs_plain)
        if mma_rate is not None:
            sh["mma_sync_floor_ms"] = {kname: 3 * f / (mma_rate * 1e12) * 1e3 for kname, f in flop.items()}
        qs, ks, vs = (t[None].detach().requires_grad_() for t in (q, k, v))
        with torch.no_grad():
            sh["sdpa_fwd_ms"] = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), args.reps)
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        sh["sdpa_bwd_ms"] = median_ms(lambda: torch.autograd.grad(
            sdpa_out, (qs, ks, vs), do[None], retain_graph=True), args.reps)
        del sdpa_out, qs, ks, vs
        sh["flash_fwd_ms"] = median_ms(lambda: fa.launch_kernel(q, k, v, causal=True), args.reps)
        shapes[name] = sh
        runs[name] = (run_dq, run_dkv)
    turns = []
    for build in turn_order(args.variant):
        t = {"build": build}
        for name, (run_dq, run_dkv) in runs.items():
            sh = shapes[name]
            for kname, run in (("dq", run_dq), ("dkv", run_dkv)):
                what = f"{name}_{kname}"
                timed(build, libs[build], "bwd", what, run, args.reps, t)
                t[f"{what}_tflop_per_s"] = sh["flop"][kname] / t[f"{what}_ms"] / 1e9
                t[f"{what}_share_of_bound"] = sh["bound_ms"][kname] / t[f"{what}_ms"]
            t[f"{name}_pair_ms"] = t[f"{name}_dq_ms"] + t[f"{name}_dkv_ms"]
        turns.append(t)
        print(f"# turn {len(turns)} ({build}): " + ", ".join(
            f"{name} dq {t[f'{name}_dq_ms']:.4f} ms ({t[f'{name}_dq_tflop_per_s']:.1f} TFLOP/s, "
            f"{t[f'{name}_dq_share_of_bound']:.3f} of its bound), dkv {t[f'{name}_dkv_ms']:.4f} ms "
            f"({t[f'{name}_dkv_tflop_per_s']:.1f} TFLOP/s, {t[f'{name}_dkv_share_of_bound']:.3f}), "
            f"pair {t[f'{name}_pair_ms']:.4f} ms" for name in runs) + f" [{smi}]", flush=True)
    for name, sh in shapes.items():
        floor = sh.get("mma_sync_floor_ms")
        print(f"# {name} (B*H {sh['bh']}, S {sh['s']}, D {sh['d']}, {args.dtype}, causal): bounds dq "
              f"{sh['bound_ms']['dq']:.4f} ms, dkv {sh['bound_ms']['dkv']:.4f} ms; "
              + (f"3xTF32 at mma.sync's rate dq {floor['dq']:.4f} ms, dkv {floor['dkv']:.4f} ms; "
                 if floor else "")
              + f"MUFU floor {sh['mufu_floor_ms']:.4f} ms at {clock_hz / 1e6:.0f} MHz; SDPA backward "
              f"{sh['sdpa_bwd_ms']:.4f} ms, SDPA forward {sh['sdpa_fwd_ms']:.4f} ms, flash_fwd "
              f"{sh['flash_fwd_ms']:.4f} ms; this vs other build max |diff| {sh['builds_max_abs_apart']}, "
              f"bit-identical {sh['builds_bit_identical']}, all finite {sh['all_finite']}; largest "
              f"|diff| from the plain version as a share of the gradient's scale by build "
              f"{sh['vs_plain']['share_of_scale']} [{smi}]", flush=True)
    return dict(shapes=shapes, turns=turns, max_sm_clock_hz=clock_hz, tf32_mma_sync_tflop_per_s=mma_rate)


def run_fwd(args, libs, smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    clock_hz = max_sm_clock_hz()
    dtype = DTYPES[args.dtype]
    shapes, runs = {}, {}
    for name, bh, s, d, group in FWD_SHAPES[args.dtype]:
        if args.shape and name not in args.shape:
            continue
        q = torch.randn(bh, s, d, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(bh // group, s, d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        out, lse = torch.empty_like(q), torch.empty(bh, s, device="cuda")
        dims = fa._dims(q, k, 0, 0, True, None, group)

        def run(lib, q=q, k=k, v=v, out=out, lse=lse, dims=dims):
            kernels.check(lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               out.data_ptr(), lse.data_ptr(), *dims, stream),
                          "flash_fwd")

        got = {}
        for build in libs:
            run(libs[build])
            torch.cuda.synchronize()
            got[build] = (out.clone(), lse.clone())
        vs_plain = max_abs_vs_plain(q, k, v, group, got)
        pairs = kept_pairs(s) * bh
        nbytes = (2 * bh * s * d + 2 * (bh // group) * s * d) * q.element_size() + bh * s * 4
        mufu = pairs / (EXP_PER_CLOCK * clock_hz) * 1e3
        gqa = {"enable_gqa": True} if group > 1 else {}
        shapes[name] = dict(
            bh=bh, s=s, d=d, group=group, pairs=pairs, flop=4 * d * pairs, bytes=nbytes,
            bound_ms=bound_ms(4 * d * pairs, nbytes, args.dtype, mufu), mufu_floor_ms=mufu,
            sdpa_ms=median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True, **gqa), args.reps),
            builds_max_abs_apart=dict(
                out=float((got["this"][0].float() - got["other"][0].float()).abs().max()),
                lse=float((got["this"][1] - got["other"][1]).abs().max())),
            builds_bit_identical=bit_identical(got["this"], got["other"]),
            max_abs_vs_plain=vs_plain,
            all_finite=all(bool(torch.isfinite(x.float()).all()) for b in ("other", "this")
                           for x in got[b]))
        runs[name] = run
    mma_rate = None
    if args.dtype == "float32":  # the products' floor at the rate mma.sync reaches
        mma_rate = tf32_mma_tflop_per_s(libs["this"], args.reps)
        for sh in shapes.values():
            sh["mma_sync_floor_ms"] = 3 * sh["flop"] / (mma_rate * 1e12) * 1e3
        print(f"# mma.sync m16n8k8 TF32: {mma_rate:.1f} TFLOP/s on this card (3xTF32: "
              f"{mma_rate / 3:.1f} TFLOP/s of f32 products) [{smi}]", flush=True)
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
        print(f"# {name} (B*H {sh['bh']}, S {sh['s']}, D {sh['d']}, group {sh['group']}, "
              f"{args.dtype}): bound {sh['bound_ms']:.4f} ms, MUFU floor {sh['mufu_floor_ms']:.4f} ms "
              f"at {clock_hz / 1e6:.0f} MHz, "
              + (f"3xTF32 at mma.sync's rate {sh['mma_sync_floor_ms']:.4f} ms, " if mma_rate else "")
              + f"SDPA forward {sh['sdpa_ms']:.4f} ms; this vs other build "
              f"max |diff| {sh['builds_max_abs_apart']}, bit-identical {sh['builds_bit_identical']}, "
              f"all finite {sh['all_finite']}; max |diff| from the plain version by build "
              f"{sh['max_abs_vs_plain']} [{smi}]", flush=True)
    return dict(shapes=shapes, turns=turns, max_sm_clock_hz=clock_hz,
                tf32_mma_sync_tflop_per_s=mma_rate)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="bwd")
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="directory with the other kernel source and its headers")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", action="append", default=[], metavar="NAME",
                    help="time only these shapes (FWD_SHAPES / BWD_SHAPES names; default all; the JSON "
                         "names the shapes timed and whether they were all)")
    ap.add_argument("--variant", action="append", default=[], metavar="MACRO",
                    help="also time this checkout built with -DMACRO (A+B: both; timing "
                         "diagnostics such as FLASH_BWD_NO_LOAD, FLASH_BWD_NO_MATH, "
                         "FLASH_BWD_CLOCKS, FLASH_FWD_CLOCKS, FLASH_FWD_NO_SOFTMAX, "
                         "FLASH_FWD_NO_PV, FLASH_FWD_NO_LOAD, FLASH_FWD_F32_ONE_PASS, "
                         "FLASH_BWD_F32_ONE_PASS, FLASH_BWD_F32_SUM_IN_MMA; their results "
                         "are not checked)")
    args = ap.parse_args(argv)
    names = [sh[0] for sh in (FWD_SHAPES if args.kernel == "fwd" else BWD_SHAPES)[args.dtype]]
    unknown = sorted(set(args.shape) - set(names))
    if unknown:
        ap.error(f"--shape {unknown}: the {args.kernel} {args.dtype} shapes are {names}")
    shapes_timed = [n for n in names if not args.shape or n in args.shape]
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"# shapes timed: {shapes_timed} of {names}"
          + (" (a subset: --shape)" if shapes_timed != names else ""), flush=True)
    lib_name = f"flash_{args.kernel}"
    libs = {"other": build_other(lib_name, args.other.resolve()), "this": kernels.library(lib_name)}
    for macro in args.variant:
        libs[macro] = kernels.variant(lib_name, *macro.split("+"))
    record = (run_fwd if args.kernel == "fwd" else run_bwd)(args, libs, smi)
    record = dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0), kernel=args.kernel,
                  dtype=args.dtype, causal=True, reps=args.reps, shapes_timed=shapes_timed,
                  all_shapes=shapes_timed == names, **record)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    tag = "" if args.dtype == "bfloat16" else f"_{args.dtype}"
    with open(os.path.join(ROOT, "chiprun_out", f"flash_ab_{args.kernel}{tag}.json"), "w") as f:
        json.dump(record, f, indent=1)
    return 0 if all(sh["all_finite"] for sh in record["shapes"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
