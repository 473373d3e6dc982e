"""Where a ministep's time goes on the card.

``--cell headline`` (the default) trains the headline configuration
(2^22-slot FTRL sparse logistic regression, 16384-row minibatches of 39
binary keys from 2^24, T=8 minibatches per launch, ``update="sparse"``)
and traces two launches after two warm-up launches. ``--cell ctr``
trains the CTR conf (``configs/ctr/online_l1lr.conf`` on generated data,
``benchmarks/ctr.py``: 2^22 slots, 10000-row minibatches through the
tail filter, the 1-byte push filter, τ = 4) and traces eight ministeps
after four warm-up ones. Each traced launch is upload plus step, as the
worker's ``submit`` runs it. ``--cell lm_serve`` traces one greedy
``lm_generate`` call at the serving configuration (``benchmarks/lm_serve.py``:
batch 8, 2048-token prompts) of one prefill and 16 decode steps, after
a warm-up call of the same shape. It also splits the device time by
kernel kind (``flash_fwd``, the decode attention's batched GEMVs, the
other matmuls, softmax, the rest) and, through profiler labels put
around the port's functions, by part (the prefill, the decode steps,
and within them the cache writes and the token pick), each with the
host time spent in it. ``--cell lm_train`` traces one SGD step of the
LM training configuration (``benchmarks/lm_train.py``: d_model 512, 8
layers, batch 4 x 8192 tokens, bf16, remat, ``ring_flash``) after a
warm-up step, and splits its device time by kernel kind (``flash_fwd``,
``flash_bwd_dq``, ``flash_bwd_dkv``, matrix products, copies and casts,
the other elementwise kernels) with the launches of each. Prints device
time by kernel, the device's busy share of the traced window and the
``torch.sort`` calls a unit (the linear step's segment sums sort on the
card unless their ids come grouped), and writes the same to
``chiprun_out/profile_step_<cell>.json``.

    python3 -m parameter_server_tpu_torch.benchmarks.profile_step [--cell ctr|lm_serve|lm_train]

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType

from ..apps.linear.async_sgd import AsyncSGDWorker, stack_prepped_batches
from ..models import transformer
from .ctr import ctr_minibatches
from .headline import T, conf, make_batch
from .lm_serve import SERVE_CFG, make_prompt, serve_params
from . import lm_train

LM_DECODE_STEPS = 16
# device time of the LM cell by kernel kind: name patterns, first match
# wins (the decode attention's f32 einsums run as cuBLAS batched GEMVs)
_LM_KERNELS = {"flash_fwd": ("flash_fwd",), "decode attention GEMV": ("gemv", "gemmsn"),
               "matmuls": ("gemm", "cutlass", "xmma", "nvjet", "splitk"), "softmax": ("softmax",)}
# the port's functions that lm_serve_run labels, by part
_LM_RANGES = {"prefill": ("_prefill",), "decode steps": ("_decode_step",),
              "cache writes": ("_cache_write", "_cache_write_rows"), "sampling": ("_pick_token",)}
_LM_LABELS = {f"lm.{n}" for names in _LM_RANGES.values() for n in names}
# device time of the training step by kernel kind, first match wins
_TRAIN_KERNELS = {"flash_fwd": ("flash_fwd",), "flash_bwd_dq": ("flash_bwd_dq",),
                  "flash_bwd_dkv": ("flash_bwd_dkv",),
                  "matmuls": ("gemm", "cutlass", "xmma", "nvjet", "splitk", "gemv"),
                  "copies and casts": ("copy", "memcpy", "memset", "cast")}


def headline_launches():
    """Two warm-up and two traced launches of T=8 headline minibatches."""
    worker = AsyncSGDWorker(conf(), device="cuda")
    launches = []
    for k in range(4):
        group = [make_batch(k * T + i) for i in range(T)]
        launches.append(stack_prepped_batches([worker.prep(b, device_put=False) for b in group]))
    return worker, launches[:2], launches[2:], False


def ctr_launches():
    """Four warm-up and eight traced CTR ministeps, read as the CLI reads
    them (count-min tail filter) and prepped on the host beforehand."""
    with tempfile.TemporaryDirectory(prefix="ctr_profile_") as tmp:
        batches, c = ctr_minibatches(tmp, 12 * 10_000, seed=0)
    worker = AsyncSGDWorker(c, device="cuda")
    prepped = [worker.prep(b, device_put=False) for b in batches]
    return worker, prepped[:4], prepped[4:], True


def _labelled(fn, label):
    from torch.profiler import record_function

    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)
    return wrapped


def lm_serve_run():
    """One prefill of the serving config's 8 x 2048 prompts and 16 greedy
    decode steps; a warm-up call of the same shape first. The functions
    of ``_LM_RANGES`` run under profiler labels (rebound in the module
    for the rest of this process)."""
    params = serve_params(0, "cuda")
    prompt = make_prompt(1, device="cuda")
    for names in _LM_RANGES.values():
        for name in names:
            setattr(transformer, name, _labelled(getattr(transformer, name), f"lm.{name}"))

    def run():
        transformer.lm_generate(params, prompt, SERVE_CFG, LM_DECODE_STEPS + 1)
    run()
    return run


def lm_train_run():
    """One SGD step of the training configuration (batch 4 x 8192 tokens);
    a warm-up step first."""
    params = transformer.init_lm(0, lm_train.TRAIN_CFG, "cuda")
    tokens = lm_train.make_tokens(device="cuda")[0]
    step = transformer.make_lm_train_step(lm_train.TRAIN_CFG, lr=lm_train.LR, donate=True)
    state = {"params": step(params, tokens)[0]}

    def run():
        state["params"], _ = step(state["params"], tokens)
    return run


def by_kind(rows, kinds) -> dict:
    """Device µs and launches by kernel kind (name patterns, first match
    wins; the rest is "elementwise and other")."""
    out = {kind: dict(device_us=0.0, launches=0) for kind in (*kinds, "elementwise and other")}
    for r in rows:
        name = r["name"].lower()
        kind = next((k for k, keys in kinds.items() if any(p in name for p in keys)),
                    "elementwise and other")
        out[kind]["device_us"] += r["device_us"]
        out[kind]["launches"] += r["count"]
    return out


def lm_split(prof, rows) -> dict:
    """Device µs of the LM cell by kernel kind, and by labelled part: the
    device time of the kernels each part launched and the host time
    spent in it (µs, whole traced call)."""
    parts = {}
    for part, names in _LM_RANGES.items():
        # the host-side range events: their device time is the sum of the
        # kernels launched inside them (the device-side range would be
        # its span, idle gaps included)
        evs = [e for e in prof.events() if e.name in {f"lm.{n}" for n in names}
               and e.device_type == DeviceType.CPU]
        parts[part] = dict(calls=len(evs), device_us=sum(e.device_time_total for e in evs),
                           host_us=sum(e.cpu_time_total for e in evs))
    return dict(kinds=by_kind(rows, _LM_KERNELS), parts=parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", choices=("headline", "ctr", "lm_serve", "lm_train"),
                    default="headline")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    if args.cell == "lm_serve":
        run, unit, units = lm_serve_run(), "decode step", LM_DECODE_STEPS
    elif args.cell == "lm_train":
        run, unit, units = lm_train_run(), "SGD step", 1
    else:
        worker, warm, traced, with_aux = (ctr_launches if args.cell == "ctr" else headline_launches)()
        for p in warm:
            worker.submit(p, with_aux=with_aux)

        def run():
            for p in traced:
                worker.submit(worker.upload(p), with_aux=with_aux)
        unit, units = "ministep", sum(getattr(p, "steps", 1) for p in traced)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): an aten op's own row
        # repeats the device time of the kernels it launched, and a label's
        # device-side row is its span
        if e.device_type != DeviceType.CUDA or e.key in _LM_LABELS:
            continue
        dev_us = float(getattr(e, "self_device_time_total", 0.0))
        if dev_us > 0:
            rows.append(dict(name=e.key, device_us=dev_us, count=int(e.count)))
    rows.sort(key=lambda r: -r["device_us"])
    busy_us = sum(r["device_us"] for r in rows)
    # the segment sums' stable sorts (torch.sort calls; each launches several kernels)
    sorts = sum(e.count for e in prof.key_averages()
                if e.key == "aten::sort" and e.device_type == DeviceType.CPU)
    out = dict(nvidia_smi=smi, cell=args.cell, unit=unit, units=units,
               wall_ms_per_unit=wall_us / units / 1e3, device_ms_per_unit=busy_us / units / 1e3,
               wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               device_busy_share=busy_us / wall_us if wall_us else None,
               sorts_per_unit=sorts / units, kernels=rows)
    print(smi)
    if not rows:
        print("# profiler recorded no device time")
    print(f"# traced {units} {unit}s (profiler on): wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({out['device_ms_per_unit']:.3f} ms/{unit}), busy share "
          f"{out['device_busy_share']:.3f}, torch.sort calls {sorts / units:g}/{unit}")
    if args.cell == "lm_serve":
        out["split_us"] = split = lm_split(prof, rows)
        print(f"# whole traced call (prefill + {units} decode steps), device time by kernel kind: "
              + ", ".join(f"{k} {v['device_us']:.1f} us" for k, v in split["kinds"].items()))
        print("# by part (calls, device us, host us): " + ", ".join(
            f"{k} ({v['calls']}, {v['device_us']:.1f}, {v['host_us']:.1f})" for k, v in split["parts"].items()))
    if args.cell == "lm_train":
        out["by_kind"] = kinds = by_kind(rows, _TRAIN_KERNELS)
        out["launches_per_unit"] = sum(r["count"] for r in rows) / units
        print(f"# one SGD step, {out['launches_per_unit']:.0f} device launches; device time by "
              "kernel kind: " + ", ".join(f"{k} {v['device_us'] / 1e3:.3f} ms ({v['launches']} "
                                         "launches)" for k, v in kinds.items()))
    for r in rows[:20]:
        print(f"#   {r['device_us'] / units:9.1f} us/{unit}  x{r['count'] / units:5.1f}  {r['name'][:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"profile_step_{args.cell}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
