"""The LM CLI's optimizer chain, as the JAX CLI builds it with optax.

``parameter_server_tpu/apps/lm/main.py`` chains an optional
``optax.clip_by_global_norm``, ``optax.adam``, ``optax.adafactor`` or
``optax.lion`` with a constant rate or
``optax.warmup_cosine_decay_schedule``, and wraps the lot in
``optax.MultiSteps`` for gradient accumulation. This module writes each
piece out in optax 0.2.6's own arithmetic, operation for operation in
float32, over dicts of tensors:

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
- Adafactor and Lion at optax's defaults (:class:`Adafactor`,
  :class:`Lion`); both read the parameters, so ``update`` takes them;
- accumulation keeps the running mean ``acc + (g - acc) / (n + 1)`` and
  applies the inner step on the k-th micro-step only, leaving the
  parameters unchanged in between.

Held to optax over 6 steps from the same weights and gradients by
``tests/test_torch_lm_cli.py`` (Adam) and ``tests/test_torch_lm_family.py``
(Adafactor and Lion).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
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


class _Chain:
    """Optional global-norm clipping, then the optimizer's own step, at a
    constant or scheduled learning rate read from the update count."""

    def __init__(self, lr, clip_norm: Optional[float] = None):
        self.lr, self.clip_norm = lr, clip_norm

    def _clip(self, grads: Tensors) -> Tensors:
        # summed over the parameters in sorted order, as jax.tree.leaves
        norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in sorted(grads)))
        if bool(norm < self.clip_norm):
            return grads
        return {k: (g / norm) * self.clip_norm for k, g in grads.items()}

    def _rate(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate of this update, a float32 tensor."""
        return self.lr(count) if callable(self.lr) else scalar_like(self.lr, count)

    def init(self, params: Tensors) -> dict:
        like = next(iter(params.values()))
        return dict(count=torch.zeros((), dtype=torch.int32, device=like.device),
                    **self._init(params))

    def update(self, grads: Tensors, state: dict, params: Optional[Tensors] = None):
        """(updates, new state) from the gradients (and, for Adafactor
        and Lion, the parameters), as optax's chain."""
        if self.clip_norm is not None:
            grads = self._clip(grads)
        return self._step(grads, state, params)


class Adam(_Chain):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over a dict of float32 tensors."""

    def __init__(self, lr, clip_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(lr, clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _init(self, params: Tensors) -> dict:
        return dict(mu={k: torch.zeros_like(v) for k, v in params.items()},
                    nu={k: torch.zeros_like(v) for k, v in params.items()})

    def _step(self, grads: Tensors, state: dict, params):
        count = state["count"]
        t = count + 1
        mu = {k: (1 - self.b1) * g + self.b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - self.b2) * (g * g) + self.b2 * state["nu"][k] for k, g in grads.items()}
        bc1 = 1 - scalar_like(self.b1, count) ** t
        bc2 = 1 - scalar_like(self.b2, count) ** t
        step = -1 * self._rate(count)
        updates = {k: step * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)) for k in mu}
        return updates, dict(count=t, mu=mu, nu=nu)


def _needs_params(params) -> None:
    if params is None:
        # optax's NO_PARAMS_MSG
        raise ValueError("You are using a transformation that requires the current value of "
                         "parameters, but you are not passing `params` when calling `update`.")


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest) when the second largest has at least the minimum size, else
    None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(_Chain):
    """``optax.adafactor(lr)`` at its defaults: a second moment factored
    into row and column means over the two largest axes of each tensor of
    which both have at least ``min_dim_size_to_factor`` entries (a full
    moment otherwise), decay ``1 - (t + 1) ** -decay_rate``, ``eps``
    1e-30 added to the squared gradient; then each tensor's update
    clipped to an RMS of ``clipping_threshold``, scaled by the rate and
    by the RMS of its parameter (at least 1e-3), and negated."""

    def __init__(self, lr, clip_norm: Optional[float] = None, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0, eps: float = 1e-30):
        super().__init__(lr, clip_norm)
        self.min_dim, self.decay_rate = min_dim_size_to_factor, decay_rate
        self.clipping_threshold, self.eps = clipping_threshold, eps

    def _init(self, params: Tensors) -> dict:
        state = dict(v_row={}, v_col={}, v={})
        for k, p in params.items():
            dims = _factored_dims(tuple(p.shape), self.min_dim)
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            if dims is None:
                state["v_row"][k], state["v_col"][k] = one, one.clone()
                state["v"][k] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"][k] = torch.zeros(np.delete(p.shape, d0).tolist(), dtype=p.dtype,
                                                device=p.device)
                state["v_col"][k] = torch.zeros(np.delete(p.shape, d1).tolist(), dtype=p.dtype,
                                                device=p.device)
                state["v"][k] = one
        return state

    def _step(self, grads: Tensors, state: dict, params):
        _needs_params(params)
        count = state["count"]
        decay = 1.0 - (count + 1).to(torch.float32) ** -self.decay_rate
        rate = self._rate(count)
        updates, new = {}, dict(count=count + 1, v_row={}, v_col={}, v={})
        for k, g in grads.items():
            p = params[k]
            grad_sqr = g * g + self.eps
            dims = _factored_dims(tuple(p.shape), self.min_dim)
            if dims is None:
                v = decay * state["v"][k] + (1.0 - decay) * grad_sqr
                new["v"][k] = v
                new["v_row"][k], new["v_col"][k] = state["v_row"][k], state["v_col"][k]
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                v_row = decay * state["v_row"][k] + (1.0 - decay) * grad_sqr.mean(d0)
                v_col = decay * state["v_col"][k] + (1.0 - decay) * grad_sqr.mean(d1)
                new["v_row"][k], new["v_col"][k], new["v"][k] = v_row, v_col, state["v"][k]
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            u = u / torch.clamp_min(torch.sqrt(torch.mean(u * u)) / self.clipping_threshold, 1.0)
            u = rate * u
            rms = torch.sqrt(torch.mean(p * p))
            u = u * torch.where(rms <= 1e-3, scalar_like(1e-3, rms), rms)
            updates[k] = -1 * u
        return updates, new


class Lion(_Chain):
    """``optax.lion(lr)`` at its defaults (b1 0.9, b2 0.99, weight decay
    1e-3): the update ``sign((1 - b1) g + b1 m) + wd * p``, scaled by
    ``-lr``; the momentum ``m`` moves as ``(1 - b2) g + b2 m``."""

    def __init__(self, lr, clip_norm: Optional[float] = None, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 1e-3):
        super().__init__(lr, clip_norm)
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay

    def _init(self, params: Tensors) -> dict:
        return dict(mu={k: torch.zeros_like(v) for k, v in params.items()})

    def _step(self, grads: Tensors, state: dict, params):
        _needs_params(params)
        count = state["count"]
        step = -1 * self._rate(count)
        updates, mu = {}, {}
        for k, g in grads.items():
            m = state["mu"][k]
            u = torch.sign((1.0 - self.b1) * g + self.b1 * m) + self.weight_decay * params[k]
            updates[k] = step * u
            mu[k] = (1 - self.b2) * g + self.b2 * m
        return updates, dict(count=count + 1, mu=mu)


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)``: the running mean
    of k micro-step gradients feeds one inner step on the k-th; the
    updates in between are zeros."""

    def __init__(self, inner: _Chain, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params: Tensors) -> dict:
        return dict(mini_step=0, acc={k: torch.zeros_like(v) for k, v in params.items()},
                    inner=self.inner.init(params))

    def update(self, grads: Tensors, state: dict, params: Optional[Tensors] = None):
        n = state["mini_step"]
        acc = {k: a + (grads[k] - a) / scalar_like(n + 1, a) for k, a in state["acc"].items()}
        if n + 1 < self.k:
            zeros = {k: torch.zeros_like(g) for k, g in grads.items()}
            return zeros, dict(mini_step=n + 1, acc=acc, inner=state["inner"])
        updates, inner = self.inner.update(acc, state["inner"], params)
        return updates, dict(mini_step=0, acc={k: torch.zeros_like(a) for k, a in acc.items()},
                             inner=inner)


OPTIMIZERS = {"adam": Adam, "adafactor": Adafactor, "lion": Lion}


def build(lr: float, steps: int, warmup: int = 0, clip_norm: Optional[float] = None,
          grad_accum: int = 1, optimizer: str = "adam"):
    """The JAX CLI's chain for its flags: schedule -> clip -> adam,
    adafactor or lion -> (MultiSteps when ``grad_accum > 1``)."""
    rate = warmup_cosine_decay(lr, max(1, warmup // grad_accum), max(2, steps // grad_accum),
                               0.1 * lr) if warmup else lr
    tx = OPTIMIZERS[optimizer](rate, clip_norm)
    return MultiSteps(tx, grad_accum) if grad_accum > 1 else tx


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """``optax.apply_updates``: ``p + u`` in the parameters' dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
