"""Where a ministep's time goes on the card.

``--cell headline`` (the default) trains the headline configuration
(2^22-slot FTRL sparse logistic regression, 16384-row minibatches of 39
binary keys from 2^24, T=8 minibatches per launch, ``update="sparse"``)
and traces two launches after two warm-up launches. ``--cell ctr``
trains the CTR conf (``configs/ctr/online_l1lr.conf`` on generated data,
``benchmarks/ctr.py``: 2^22 slots, 10000-row minibatches through the
tail filter, the 1-byte push filter, τ = 4) and traces eight ministeps
after four warm-up ones. Each traced launch is upload plus step, as the
worker's ``submit`` runs it. Prints device time by kernel and the
device's busy share of the traced window, and writes the same to
``chiprun_out/profile_step_<cell>.json``.

    python3 -m parameter_server_tpu_torch.benchmarks.profile_step [--cell ctr]

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

from ..apps.linear.async_sgd import AsyncSGDWorker, stack_prepped_batches
from ..apps.linear.config import parse_conf
from ..learner.sgd import MinibatchReader
from .ctr import ctr_conf, write_ctr_shards
from .headline import T, conf, make_batch


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
        write_ctr_shards(tmp, 1, 12 * 10_000, seed=0)
        c = parse_conf(ctr_conf(os.path.join(tmp, "part.*"), os.path.join(tmp, "model")))
        s = c.async_sgd
        reader = MinibatchReader(files=c.training_data.file, minibatch_size=s.minibatch,
                                 data_format=c.training_data.text)
        reader.init_filter(s.countmin_n, s.countmin_k, s.tail_feature_freq)
        with reader:
            batches = list(reader)
    worker = AsyncSGDWorker(c, device="cuda")
    prepped = [worker.prep(b, device_put=False) for b in batches]
    return worker, prepped[:4], prepped[4:], True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", choices=("headline", "ctr"), default="headline")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    worker, warm, traced, with_aux = (ctr_launches if args.cell == "ctr" else headline_launches)()
    for p in warm:
        worker.submit(p, with_aux=with_aux)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in traced:
            worker.submit(worker.upload(p), with_aux=with_aux)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): an aten op's own row
        # repeats the device time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = float(getattr(e, "self_device_time_total", 0.0))
        if dev_us > 0:
            rows.append(dict(name=e.key, device_us=dev_us, count=int(e.count)))
    rows.sort(key=lambda r: -r["device_us"])
    ministeps = sum(getattr(p, "steps", 1) for p in traced)
    busy_us = sum(r["device_us"] for r in rows)
    out = dict(nvidia_smi=smi, cell=args.cell, ministeps=ministeps, wall_ms_per_ministep=wall_us / ministeps / 1e3,
               device_ms_per_ministep=busy_us / ministeps / 1e3,
               device_busy_share=busy_us / wall_us if wall_us else None, kernels=rows)
    print(smi)
    if not rows:
        print("# profiler recorded no device time")
    print(f"# traced {ministeps} ministeps (profiler on): wall {out['wall_ms_per_ministep']:.3f} ms/ministep, "
          f"device busy {out['device_ms_per_ministep']:.3f} ms/ministep, busy share {out['device_busy_share']:.3f}")
    for r in rows[:20]:
        print(f"#   {r['device_us'] / ministeps:9.1f} us/ministep  x{r['count'] / ministeps:5.1f}  {r['name'][:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"profile_step_{args.cell}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
