"""The LM training configuration and its workload, shared by the scripts
that drive it on the card (``chip_smoke.py``, :mod:`.profile_step`).

The model is the JAX package's byte-LM training shape
(``script/onchip.py::_lm_base``, as ``task_lm`` trains it with
``attention="ring_flash"``): byte vocab 256, d_model 512, 8 heads of
dim 64 (no GQA), 8 layers, d_ff 2048, ``remat``, bf16 activations,
25,305,600 float32 parameters. The workload is ``task_lm``'s: SGD at lr
0.3 (``make_lm_train_step``) on seeded random tokens ``[SPL, BATCH, SEQ]``
from ``numpy.random.default_rng(0)``, 8 steps a launch of batch 4 at
sequence 8192. Model FLOP a step are ``task_lm``'s formula: 6 x params x
tokens for the matrix products, plus 12 x layers x batch x heads x pairs x
head dim for causal attention (pairs = S^2 / 2); MFU is that over the
step time and the H100's dense bf16 peak (989 TFLOP/s).

    python3 -m parameter_server_tpu_torch.benchmarks.lm_train

times one warm-up launch and three timed launches on the card (host
clock to a synchronize, median launch) and prints tokens/s, step ms and
MFU beside the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from ..device import resolve
from ..models.transformer import LMConfig, init_lm, make_lm_train_step

TRAIN_CFG = LMConfig(vocab=256, d_model=512, n_heads=8, n_layers=8, d_ff=2048,
                     attention="ring_flash", remat=True, compute_dtype="bfloat16")
SEQ, BATCH, SPL, LR = 8192, 4, 8, 0.3
BF16_PEAK_FLOP_PER_S = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)


def make_tokens(seed: int = 0, spl: int = SPL, batch: int = BATCH, seq: int = SEQ,
                device=None) -> torch.Tensor:
    """Seeded random tokens ``[spl, batch, seq]``, as ``task_lm`` draws them."""
    tokens = np.random.default_rng(seed).integers(0, TRAIN_CFG.vocab, (spl, batch, seq), np.int32)
    return torch.as_tensor(tokens, device=resolve(device))


def n_params(cfg: LMConfig = TRAIN_CFG) -> int:
    d, kv_w = cfg.d_model, cfg.kv_heads * cfg.head_dim
    layer = 2 * d + d * d + 2 * d * kv_w + d * d + 2 * d * cfg.d_ff
    return cfg.vocab * d + d + cfg.n_layers * layer


def step_flop(cfg: LMConfig = TRAIN_CFG, batch: int = BATCH, seq: int = SEQ) -> float:
    """``task_lm``'s model FLOP of one training step."""
    w = min(cfg.window or seq, seq)
    pairs = seq * w - w * w / 2.0
    return 6.0 * n_params(cfg) * batch * seq + 12.0 * cfg.n_layers * batch * cfg.n_heads * pairs \
        * cfg.head_dim


def nvidia_smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def timed_launches(params, tokens, timed: int = 3, cfg: LMConfig = TRAIN_CFG):
    """One warm-up launch of ``make_lm_train_step(steps_per_launch=T)``,
    then ``timed`` launches, each timed on the host clock to a
    synchronize. Returns (params, losses of the last launch, launch
    seconds)."""
    step = make_lm_train_step(cfg, lr=LR, donate=True, steps_per_launch=len(tokens))
    params, losses = step(params, tokens)
    torch.cuda.synchronize()
    secs = []
    for _ in range(timed):
        t0 = time.perf_counter()
        params, losses = step(params, tokens)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return params, losses, secs


def summarize(secs, spl: int = SPL, batch: int = BATCH, seq: int = SEQ,
              cfg: LMConfig = TRAIN_CFG) -> dict:
    """tokens/s, step ms and MFU from the median launch."""
    sec = float(np.median(secs)) / spl
    return dict(step_ms=sec * 1e3, tokens_per_s=batch * seq / sec,
                mfu=step_flop(cfg, batch, seq) / sec / BF16_PEAK_FLOP_PER_S,
                launch_s=list(secs), launch_spread=(max(secs) - min(secs)) / float(np.median(secs)))


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_train: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    params = init_lm(0, TRAIN_CFG, "cuda")
    _, losses, secs = timed_launches(params, make_tokens(device="cuda"))
    r = summarize(secs)
    print(f"# LM training, d_model 512, 8 layers, seq {SEQ}, batch {BATCH}, bf16, remat, "
          f"ring_flash, SGD: {r['tokens_per_s']:.0f} tokens/s, {r['step_ms']:.1f} ms a step, MFU "
          f"{r['mfu']:.4f}, last loss {float(losses[-1]):.4f} [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
