"""What telemetry costs the port's main paths on one card: this checkout
with telemetry on and off, beside another checkout (an earlier commit's),
in turns.

    python3 -m parameter_server_tpu_torch.benchmarks.telemetry_ab [--other DIR]
        [--rounds 2] [--seed 0]

DIR holds the other ``parameter_server_tpu_torch`` package, for example
``git archive <commit> parameter_server_tpu_torch`` unpacked; its kernels
build into DIR. Each turn is a process of its own that imports one
package. In this checkout's turns ``telemetry.registry.set_enabled`` is
called before anything else is imported, as every instrument is decided
when it is built; the other checkout runs as it is. A turn measures, each
on the host clock to a synchronize:

- the headline (``benchmarks/headline.py``) through
  ``AsyncSGDWorker.train``, serial and pipelined: a warm-up launch, then
  8 launches of T minibatches, in examples/s (``chip_smoke.py``'s
  phase 4 without its per-stage timers);
- the serve CLI at 2^22 slots with ``--replica full --train-while-serving
  --decode --batch-slots 8`` (``chip_smoke.py``'s phase A): its closed-loop
  capacity in requests/s and the p99 of its first load point;
- LM serving at ``benchmarks/lm_serve.py``'s configuration: time to first
  token and decode tokens/s, as ``serve_ab.py`` measures them.

Each round runs the turns other, on, off, off, on, other. Prints one line
a turn and the median of each arm, and writes
``chiprun_out/telemetry_ab.json``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
LAUNCHES = 8
SERVE_ARGV = ["--num-slots", str(1 << 22), "--replica", "full", "--train-while-serving",
              "--decode", "--batch-slots", "8", "--device", "cuda"]


def headline(seed: int) -> dict:
    import torch

    from parameter_server_tpu_torch.apps.linear.async_sgd import AsyncSGDWorker
    from parameter_server_tpu_torch.benchmarks.headline import MB, T, conf, make_batch

    batches = [make_batch(seed + i) for i in range(T * (LAUNCHES + 1))]
    out = {}
    for pipelined in (False, True):
        worker = AsyncSGDWorker(conf("sparse"), device="cuda")
        worker.train(batches[:T], pipelined=pipelined)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        worker.train(batches[T:], pipelined=pipelined)
        torch.cuda.synchronize()
        out["pipelined_ex_s" if pipelined else "serial_ex_s"] = \
            LAUNCHES * T * MB / (time.perf_counter() - t0)
        worker.executor.stop()
        del worker
    return out


def serve_cli(seed: int) -> dict:
    from parameter_server_tpu_torch.apps.serve import main as serve_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_main.main(SERVE_ARGV + ["--seed", str(seed)])
    if rc != 0:
        raise RuntimeError(f"serve CLI exited {rc}")
    recs = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    cap = next(r for r in recs if r["metric"] == "serve_closed_loop_capacity")
    first = next(r for r in recs if r["metric"] == "serve_open_loop_point")
    return dict(serve_capacity_req_s=float(cap["value"]),
                serve_p99_ms=float(first["latency_ms"]["p99_ms"]))


def lm_serving(seed: int) -> dict:
    import torch

    from parameter_server_tpu_torch.benchmarks import lm_serve
    from parameter_server_tpu_torch.models import transformer

    cfg, b, steps = lm_serve.SERVE_CFG, lm_serve.B, lm_serve.STEPS
    params = lm_serve.serve_params(seed, "cuda")
    prompt = lm_serve.make_prompt(seed + 1, device="cuda")
    transformer.lm_generate(params, prompt, cfg, 4)  # warm-up at the timed shapes

    def timed(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transformer.lm_generate(params, prompt, cfg, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ttft_s, wall_s = timed(1), timed(steps)
    return dict(lm_ttft_ms=ttft_s * 1e3, lm_decode_tokens_s=b * (steps - 1) / (wall_s - ttft_s))


def turn(root: pathlib.Path, telemetry: str, seed: int) -> dict:
    """One turn in this process: the numbers of the package under ``root``."""
    sys.path.insert(0, str(root))
    if telemetry != "as_is":
        from parameter_server_tpu_torch.telemetry import registry

        registry.set_enabled(telemetry == "on")
    import parameter_server_tpu_torch as pkg

    out = dict(package=str(pathlib.Path(pkg.__file__).parent))
    out.update(headline(seed))
    # the headline's workers may be registered customers of the package's
    # postoffice: release them, so both packages' later phases start alike
    from parameter_server_tpu_torch.system.postoffice import Postoffice

    Postoffice.reset()
    gc.collect()
    out.update(serve_cli(seed))
    out.update(lm_serving(seed))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=pathlib.Path, help="directory holding the other package")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)  # one turn, in a child
    ap.add_argument("--telemetry", default="as_is", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(turn(args.turn, args.telemetry, args.seed)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    arms = {"on": (ROOT, "on"), "off": (ROOT, "off")}
    order = ("on", "off", "off", "on")
    if args.other is not None:
        arms["other"] = (args.other.resolve(), "as_is")
        order = ("other",) + order + ("other",)
    turns = []
    for name in order * args.rounds:
        root, telemetry = arms[name]
        res = subprocess.run([sys.executable, __file__, "--turn", str(root), "--telemetry",
                              telemetry, "--seed", str(args.seed)],
                             capture_output=True, text=True, cwd=root)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], sep="\n", file=sys.stderr)
            raise RuntimeError(f"turn {name} exited {res.returncode}")
        t = dict(arm=name, **json.loads(res.stdout.strip().splitlines()[-1]))
        turns.append(t)
        print(f"# turn {len(turns)} ({name}, {t['package']}): "
              + ", ".join(f"{k} {v:.2f}" for k, v in t.items() if isinstance(v, float))
              + f" [{smi}]", flush=True)
    median = {}
    for name in arms:
        rows = [t for t in turns if t["arm"] == name]
        median[name] = {k: statistics.median(t[k] for t in rows)
                        for k, v in rows[0].items() if isinstance(v, float)}
        print(f"# {name}: median of {len(rows)} turns: "
              + ", ".join(f"{k} {v:.2f}" for k, v in median[name].items()) + f" [{smi}]",
              flush=True)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "telemetry_ab.json", "w") as f:
        json.dump(dict(nvidia_smi=smi, turns=turns, median=median), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
