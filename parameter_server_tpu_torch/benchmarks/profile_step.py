"""Where a headline ministep's time goes on the card.

Trains the headline configuration (2^22-slot FTRL sparse logistic
regression, 16384-row minibatches of 39 binary keys from 2^24, T=8
minibatches per launch, ``update="sparse"``) and traces two launches
with ``torch.profiler``: upload and step, after two warm-up launches.
Prints device time by kernel and the device's busy share of the traced
window, and writes the same to ``chiprun_out/profile_step.json``.

    python3 -m parameter_server_tpu_torch.benchmarks.profile_step

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from ..apps.linear.async_sgd import AsyncSGDWorker, stack_prepped_batches
from .headline import T, conf, make_batch

WARM, TRACED = 2, 2


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    worker = AsyncSGDWorker(conf(), device="cuda")
    launches = []
    for k in range(WARM + TRACED):
        group = [make_batch(k * T + i) for i in range(T)]
        launches.append(stack_prepped_batches([worker.prep(b, device_put=False) for b in group]))
    for sb in launches[:WARM]:
        worker.submit(sb, with_aux=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for sb in launches[WARM:]:
            worker.submit(worker.upload(sb), with_aux=False)
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
    ministeps = TRACED * T
    busy_us = sum(r["device_us"] for r in rows)
    out = dict(nvidia_smi=smi, ministeps=ministeps, wall_ms_per_ministep=wall_us / ministeps / 1e3,
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
    with open(os.path.join("chiprun_out", "profile_step.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
