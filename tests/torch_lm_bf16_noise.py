#!/usr/bin/env python3
"""Measure the serving config's bf16 noise on the JAX reference.

``chip_smoke.py`` holds the port's LM logits (card against the plain
attention, card against the CPU) to a multiple of the config's own bf16
rounding noise. That noise must not come from the code under test, so it
is measured here, on the JAX package alone: the largest |logit| gap
between the reference's bfloat16 and float32 ``lm_generate`` runs of the
same weights, teacher-forced on the same tokens. The weights are the
port's ``benchmarks/lm_serve.serve_params(seed)`` (what ``chip_smoke.py``
serves), carried into the JAX package; the tokens are one row of its
prompt cut to 256 bytes plus the reference's own 32 greedy bf16 tokens
(the shape of ``chip_smoke.py``'s card-against-CPU check). Width and depth
are the serving config's; only the batch (1 row) and the sequence (288
tokens) are cut.

Run on the CPU, from the root of a checkout:

    JAX_PLATFORMS=cpu python3 tests/torch_lm_bf16_noise.py [--seed 0]

It prints one JSON object; ``chip_smoke.py``'s ``REF_BF16_NOISE`` is its
``jax_bf16_vs_f32_logit_gap`` at seed 0.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from parameter_server_tpu.models import transformer as jtr  # noqa: E402
from parameter_server_tpu_torch import convert  # noqa: E402
from parameter_server_tpu_torch.benchmarks import lm_serve  # noqa: E402

PROMPT, STEPS = 256, 32  # chip_smoke.py's CPU_PROMPT, CPU_STEPS


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    c = lm_serve.SERVE_CFG
    jc = jtr.LMConfig(vocab=c.vocab, d_model=c.d_model, n_heads=c.n_heads, n_layers=c.n_layers,
                      d_ff=c.d_ff, compute_dtype=c.compute_dtype, n_kv_heads=c.n_kv_heads,
                      kv_cache_dtype=c.kv_cache_dtype)
    jc32 = dataclasses.replace(jc, compute_dtype="float32", kv_cache_dtype=None)
    params = {k: jnp.asarray(v) for k, v in
              convert.lm_params_to_numpy(lm_serve.serve_params(args.seed, "cpu")).items()}
    row = jnp.asarray(lm_serve.make_prompt(args.seed + 1, device="cpu")[:1, :PROMPT].numpy())
    toks = jtr.lm_generate(params, row, jc, STEPS)
    _, l16 = jtr.lm_generate(params, toks, jc, 0, return_logits=True)
    _, l32 = jtr.lm_generate(params, toks, jc32, 0, return_logits=True)
    gap = np.abs(np.asarray(l16) - np.asarray(l32))
    print(json.dumps(dict(seed=args.seed, prompt=PROMPT, steps=STEPS,
                          jax_bf16_vs_f32_logit_gap=float(gap.max()),
                          generated_rows_gap=float(gap[:, PROMPT - 1:].max()),
                          logit_abs_max=float(np.abs(np.asarray(l32)).max()))))


if __name__ == "__main__":
    main()
