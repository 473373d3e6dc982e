"""Time to first token and decode tokens/s of this checkout's port against
another checkout's (an earlier commit's), on one card, in turns: other,
this, this, other, repeated ``--rounds`` times.

    python3 -m parameter_server_tpu_torch.benchmarks.serve_ab --other DIR
        [--rounds 2] [--reps 3] [--seed 0]

DIR holds the other ``parameter_server_tpu_torch`` package, for example
``git archive <commit> parameter_server_tpu_torch`` unpacked; its kernels
build into DIR. Each turn is a process of its own that imports one
package: it builds the serving configuration of
``benchmarks/lm_serve.py`` (d_model 512, 8 layers, GQA 2, bf16, int8
cache; random weights from ``--seed``), warms up at the timed shapes and
then, ``--reps`` times, measures as ``chip_smoke.py`` does: TTFT is one
``lm_generate(..., steps=1)`` at batch 8 x 2048-token prompts, decode
tokens/s is B x (steps - 1) over (a 256-step call - TTFT), each on the
host clock to a synchronize. Prints one line a turn, the median of each
build over all its turns, and writes ``chiprun_out/serve_ab.json``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def serve_times(root: pathlib.Path, reps: int, seed: int) -> dict:
    """One turn: the serving numbers of the package under ``root``."""
    sys.path.insert(0, str(root))
    import torch

    import parameter_server_tpu_torch as pkg
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

    rows = []
    for _ in range(reps):
        ttft_s, wall_s = timed(1), timed(steps)
        rows.append(dict(ttft_ms=ttft_s * 1e3, decode_tokens_per_s=b * (steps - 1) / (wall_s - ttft_s)))
    return dict(package=str(pathlib.Path(pkg.__file__).parent), reps=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=pathlib.Path, help="directory holding the other package")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)  # one turn, in a child
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(serve_times(args.turn, args.reps, args.seed)))
        return 0
    if args.other is None:
        ap.error("--other is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    roots = {"other": args.other.resolve(), "this": ROOT}
    turns = []
    for name in ("other", "this", "this", "other") * args.rounds:
        res = subprocess.run([sys.executable, __file__, "--turn", str(roots[name]), "--reps",
                              str(args.reps), "--seed", str(args.seed)],
                             check=True, capture_output=True, text=True, cwd=roots[name])
        turn = dict(build=name, **json.loads(res.stdout.strip().splitlines()[-1]))
        turns.append(turn)
        print(f"# turn {len(turns)} ({name}, {turn['package']}): TTFT "
              + " / ".join(f"{r['ttft_ms']:.2f}" for r in turn["reps"]) + " ms, decode "
              + " / ".join(f"{r['decode_tokens_per_s']:.1f}" for r in turn["reps"])
              + f" tokens/s [{smi}]", flush=True)
    summary = {}
    for name in roots:
        reps = [r for t in turns if t["build"] == name for r in t["reps"]]
        summary[name] = {k: statistics.median(r[k] for r in reps) for k in reps[0]}
        print(f"# {name}: median of {len(reps)} TTFT {summary[name]['ttft_ms']:.2f} ms, decode "
              f"{summary[name]['decode_tokens_per_s']:.1f} tokens/s [{smi}]")
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "serve_ab.json", "w") as f:
        json.dump(dict(nvidia_smi=smi, turns=turns, median=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
