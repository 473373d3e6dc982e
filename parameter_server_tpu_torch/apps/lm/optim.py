"""The LM CLI's optimizer chain, as the JAX CLI builds it with optax.

``parameter_server_tpu/apps/lm/main.py`` chains an optional
``optax.clip_by_global_norm``, ``optax.adam`` with a constant rate or
``optax.warmup_cosine_decay_schedule``, and wraps the lot in
``optax.MultiSteps`` for gradient accumulation. This module writes each
piece out in optax's own arithmetic, operation for operation in float32,
over dicts of tensors:

- clipping leaves the gradients alone when their global norm is below
  ``max_norm`` and otherwise multiplies them by ``max_norm / norm`` as
  ``(g / norm) * max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides
  by ``norm + 1e-6`` and always scales);
- the schedule is a function of the update count read BEFORE the
  optimizer increments it: linear warmup from 0, then a cosine decay to
  ``end_value``;
- Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0): ``mu = (1 - b1) g + b1
  mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias corrections ``1 - b^t``
  computed in float32, update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``;
- accumulation keeps the running mean ``acc + (g - acc) / (n + 1)`` and
  applies the inner step on the k-th micro-step only, leaving the
  parameters unchanged in between.

Held to optax over 6 steps from the same weights and gradients by
``tests/test_torch_lm_cli.py``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ...device import scalar_like

Tensors = Dict[str, torch.Tensor]


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int,
                        end_value: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, end_value)`` of an int32 count tensor, in float32."""
    alpha = 0.0 if peak == 0.0 else end_value / peak
    cos_steps = float(decay_steps - warmup_steps)
    if cos_steps <= 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps - warmup_steps}.")

    def warm(count):
        frac = 1 - torch.clamp(count, 0, warmup_steps).to(torch.float32) / scalar_like(
            warmup_steps, count)
        return (0.0 - peak) * frac + peak

    def cosine(count):
        steps = scalar_like(cos_steps, count)
        c = torch.minimum(count.to(torch.float32), steps)
        decay = 0.5 * (1 + torch.cos(math.pi * c / steps))
        return peak * ((1 - alpha) * decay + alpha)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.where(count < warmup_steps, warm(count), cosine(count - warmup_steps))

    return schedule


class Adam:
    """Adam over a dict of float32 tensors, with optional global-norm
    clipping before it and a constant or scheduled learning rate."""

    def __init__(self, lr, clip_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.clip_norm, self.b1, self.b2, self.eps = lr, clip_norm, b1, b2, eps

    def init(self, params: Tensors) -> dict:
        like = next(iter(params.values()))
        zero = torch.zeros((), dtype=torch.int32, device=like.device)
        return dict(count=zero, mu={k: torch.zeros_like(v) for k, v in params.items()},
                    nu={k: torch.zeros_like(v) for k, v in params.items()})

    def _clip(self, grads: Tensors) -> Tensors:
        # summed over the parameters in sorted order, as jax.tree.leaves
        norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in sorted(grads)))
        if bool(norm < self.clip_norm):
            return grads
        return {k: (g / norm) * self.clip_norm for k, g in grads.items()}

    def update(self, grads: Tensors, state: dict):
        """(updates, new state) from the gradients, as optax's chain."""
        if self.clip_norm is not None:
            grads = self._clip(grads)
        count = state["count"]
        t = count + 1
        mu = {k: (1 - self.b1) * g + self.b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - self.b2) * (g * g) + self.b2 * state["nu"][k] for k, g in grads.items()}
        bc1 = 1 - scalar_like(self.b1, count) ** t
        bc2 = 1 - scalar_like(self.b2, count) ** t
        lr = self.lr(count) if callable(self.lr) else scalar_like(self.lr, count)
        step = -1 * lr
        updates = {k: step * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)) for k in mu}
        return updates, dict(count=t, mu=mu, nu=nu)


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)``: the running mean
    of k micro-step gradients feeds one inner step on the k-th; the
    updates in between are zeros."""

    def __init__(self, inner: Adam, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params: Tensors) -> dict:
        return dict(mini_step=0, acc={k: torch.zeros_like(v) for k, v in params.items()},
                    inner=self.inner.init(params))

    def update(self, grads: Tensors, state: dict):
        n = state["mini_step"]
        acc = {k: a + (grads[k] - a) / scalar_like(n + 1, a) for k, a in state["acc"].items()}
        if n + 1 < self.k:
            zeros = {k: torch.zeros_like(g) for k, g in grads.items()}
            return zeros, dict(mini_step=n + 1, acc=acc, inner=state["inner"])
        updates, inner = self.inner.update(acc, state["inner"])
        return updates, dict(mini_step=0, acc={k: torch.zeros_like(a) for k, a in acc.items()},
                             inner=inner)


def build(lr: float, steps: int, warmup: int = 0, clip_norm: Optional[float] = None,
          grad_accum: int = 1):
    """The JAX CLI's chain for its flags: schedule -> clip -> adam ->
    (MultiSteps when ``grad_accum > 1``)."""
    rate = warmup_cosine_decay(lr, max(1, warmup // grad_accum), max(2, steps // grad_accum),
                               0.1 * lr) if warmup else lr
    tx = Adam(rate, clip_norm)
    return MultiSteps(tx, grad_accum) if grad_accum > 1 else tx


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """``optax.apply_updates``: ``p + u`` in the parameters' dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
