"""The LM serving configuration and its traffic, shared by the scripts
that drive it on the card (``chip_smoke.py``, :mod:`.profile_step`).

The model is the serving configuration ``doc/SERVING.md`` documents: byte
vocab 256, d_model 512, 8 heads (head dim 64), 2 KV heads (GQA), 8
layers, d_ff 2048, bf16 activations, an int8 KV cache. The traffic is
the shape the JAX package's serving capture used
(``script/onchip.py::task_serve``): batch 8, 2048-token prompts of random
bytes, 256 generated tokens, greedy or with the documented sampling
options. The draft for speculative decoding is that script's
speculative-decoding draft (d_model 256, 2 heads of dim 128, 1 layer,
d_ff 1024, bf16), proposing GAMMA tokens a round. Weights are random,
from a seed (nothing is downloaded).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..models.transformer import LMConfig, init_lm

SERVE_CFG = LMConfig(vocab=256, d_model=512, n_heads=8, n_layers=8, d_ff=2048,
                     compute_dtype="bfloat16", n_kv_heads=2, kv_cache_dtype="int8")
DRAFT_CFG = LMConfig(vocab=256, d_model=256, n_heads=2, n_layers=1, d_ff=1024,
                     compute_dtype="bfloat16")
B, P, STEPS, GAMMA = 8, 2048, 256, 4
SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95)


def make_prompt(seed: int, b: int = B, p: int = P, device=None) -> torch.Tensor:
    """[b, p] prompt bytes from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, SERVE_CFG.vocab, (b, p)), device=resolve(device))


def serve_params(seed: int = 0, device=None):
    """Random serving-config weights from ``seed``."""
    return init_lm(seed, SERVE_CFG, device)


def draft_params(seed: int = 1, device=None):
    """Random draft weights from ``seed``."""
    return init_lm(seed, DRAFT_CFG, device)
