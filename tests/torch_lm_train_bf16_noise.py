#!/usr/bin/env python3
"""Measure the LM training config's bf16 gradient noise on the JAX reference.

``chip_smoke.py`` holds one SGD step of the port on the card (the flash
kernels) to the same step with the plain attention on the card, loss and
every gradient, to a multiple of the config's own bf16 rounding noise.
That noise must not come from the code under test, so it is measured
here, on the JAX package alone: the gaps between the reference's bfloat16
and float32 ``jax.value_and_grad(lm_loss)`` on the same weights and
tokens, for the loss and for each kind of parameter (the largest |gap|
over its layers). The weights are the port's
``init_lm(seed, benchmarks/lm_train.TRAIN_CFG)`` carried into the JAX
package; the tokens are row 0 of ``lm_train.make_tokens(seed)``'s first
batch, cut to 2048 (what ``chip_smoke.py`` steps). Width and depth are the
training config's; the batch (1 row) and the sequence are cut.

Run on the CPU, from the root of a checkout:

    JAX_PLATFORMS=cpu python3 tests/torch_lm_train_bf16_noise.py [--seed 0]

It prints one JSON object; ``chip_smoke.py``'s ``REF_TRAIN_BF16_NOISE`` is
its ``gaps`` at seed 0.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parameter_server_tpu.models import transformer as jtr  # noqa: E402
from parameter_server_tpu.parallel import mesh as meshlib  # noqa: E402
from parameter_server_tpu_torch import convert  # noqa: E402
from parameter_server_tpu_torch.benchmarks import lm_train  # noqa: E402
from parameter_server_tpu_torch.models.transformer import init_lm  # noqa: E402

SEQ = 2048  # chip_smoke.py's TRAIN_AGREE_SEQ


def kind(name: str) -> str:
    """``l3/wq`` -> ``wq``; ``emb``, ``ln_f`` as they are."""
    return name.split("/")[-1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    c = lm_train.TRAIN_CFG
    jc = jtr.LMConfig(vocab=c.vocab, d_model=c.d_model, n_heads=c.n_heads, n_layers=c.n_layers,
                      d_ff=c.d_ff, attention=c.attention, remat=c.remat,
                      compute_dtype=c.compute_dtype)
    jc32 = dataclasses.replace(jc, compute_dtype="float32")
    mesh = meshlib.make_mesh(num_data=1, num_server=1)
    params = {k: jnp.asarray(v) for k, v in
              convert.lm_params_to_numpy(init_lm(args.seed, c, "cpu")).items()}
    toks = lm_train.make_tokens(args.seed, device="cpu")[0, :1, :SEQ].numpy()
    toks = jtr.shard_tokens(toks, mesh)
    l16, g16 = jax.value_and_grad(jtr.lm_loss)(params, toks, jc, mesh)
    l32, g32 = jax.value_and_grad(jtr.lm_loss)(params, toks, jc32, mesh)
    gaps = {"loss": abs(float(l16) - float(l32))}
    scale = {}
    for k in params:
        gap = float(np.abs(np.asarray(g16[k]) - np.asarray(g32[k])).max())
        gaps[kind(k)] = max(gaps.get(kind(k), 0.0), gap)
        scale[kind(k)] = max(scale.get(kind(k), 0.0), float(np.abs(np.asarray(g32[k])).max()))
    print(json.dumps(dict(seed=args.seed, seq=SEQ, loss_f32=float(l32), loss_bf16=float(l16),
                          gaps=gaps, grad_abs_max=scale)))


if __name__ == "__main__":
    main()
