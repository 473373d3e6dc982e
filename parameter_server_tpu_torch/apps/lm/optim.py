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
from ...parallel import placement

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


class _Where:
    """Where the leaves of one step lie: the parameters' placement (a
    :class:`...parallel.placement.Placed` tree's specs, keyed ``(name,)``)
    and the state's (keyed by path below ``prefix``), on ``mesh``. With
    neither placed every move is the identity."""

    def __init__(self, mesh, pspecs, sspecs, prefix=()):
        self.mesh, self.pspecs, self.sspecs, self.prefix = mesh, pspecs, sspecs, prefix

    @classmethod
    def of(cls, *trees) -> "_Where":
        grads, state, params = trees
        mesh = next((t.mesh for t in (state, params, grads)
                     if isinstance(t, placement.Placed) and t.mesh is not None), None)
        pspecs = getattr(params, "specs", None) or getattr(grads, "specs", None) or {}
        return cls(mesh, pspecs, getattr(state, "specs", None) or {})

    def sub(self, key: str) -> "_Where":
        return _Where(self.mesh, self.pspecs, self.sspecs, self.prefix + (key,))

    def pspec(self, k: str, t: torch.Tensor):
        return self.pspecs.get((k,), (None,) * t.dim())

    def sspec(self, path, t: torch.Tensor):
        return self.sspecs.get(self.prefix + path, (None,) * t.dim())

    def to_state(self, x, k: str, path, leaf):
        """``x``, placed as parameter ``k``, as the state leaf at ``path``
        (``leaf``) is placed: ZeRO-1's slice of a whole gradient."""
        return placement.reshard(x, self.pspec(k, x), self.sspec(path, leaf), self.mesh)

    def to_param(self, x, path, k: str):
        """``x``, placed as the state leaf at ``path``, as parameter ``k``:
        ZeRO-1's update slices gathered over ``data``."""
        return placement.reshard(x, self.sspec(path, x), self.pspec(k, x), self.mesh)


def _restate(state, new: dict):
    """``new`` with the placement of the state it replaces."""
    return placement.like(state, new)


def _init_placed(tx, params) -> dict:
    """``tx``'s state for ``params``, a :class:`...parallel.placement.Placed`
    tree when they are (each leaf placed as its parameter's, or as a
    reduction of it)."""
    specs: dict = {}
    state = tx._init_tree(params, _Where.of(None, None, params), specs, ())
    if isinstance(params, placement.Placed):
        return placement.Placed(state, specs, params.mesh)
    return state


class _Chain:
    """Optional global-norm clipping, then the optimizer's own step, at a
    constant or scheduled learning rate read from the update count."""

    def __init__(self, lr, clip_norm: Optional[float] = None):
        self.lr, self.clip_norm = lr, clip_norm

    def _clip(self, grads: Tensors, where: Optional[_Where] = None) -> Tensors:
        # summed over the parameters in sorted order, as jax.tree.leaves; a
        # split leaf's square sum added over the ranks that hold its pieces
        where = where if where is not None else _Where(None, {}, {})
        keys = sorted(grads)
        sq = placement.sum_all([grads[k] * grads[k] for k in keys],
                               [where.pspec(k, grads[k]) for k in keys], where.mesh)
        norm = torch.sqrt(sum(sq))
        if bool(norm < self.clip_norm):
            return grads
        return {k: (g / norm) * self.clip_norm for k, g in grads.items()}

    def _rate(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate of this update, a float32 tensor."""
        return self.lr(count) if callable(self.lr) else scalar_like(self.lr, count)

    def init(self, params: Tensors) -> dict:
        """The state of ``params``; placed as they are when they are placed
        (ZeRO-1 then splits it: ``models/transformer.zero1_shard_opt_state``)."""
        return _init_placed(self, params)

    def _init_tree(self, params, where: _Where, specs: dict, prefix) -> dict:
        like = next(iter(params.values()))
        return dict(count=torch.zeros((), dtype=torch.int32, device=like.device),
                    **self._init(params, where, specs, prefix))

    @staticmethod
    def _inherit(params, where: _Where, specs: dict, prefix, name: str) -> Tensors:
        """``zeros_like`` of every parameter, each placed as it is."""
        for k, v in params.items():
            s = where.pspec(k, v)
            if any(s):
                specs[prefix + (name, k)] = s
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, grads: Tensors, state: dict, params: Optional[Tensors] = None,
               where: Optional[_Where] = None):
        """(updates, new state) from the gradients (and, for Adafactor
        and Lion, the parameters), as optax's chain. Placed trees step on
        this rank's blocks: each state leaf's slice from the gradient's,
        the update gathered back to the parameter's placement, a split
        leaf's reductions summed over the ranks that hold it."""
        where = where if where is not None else _Where.of(grads, state, params)
        if self.clip_norm is not None:
            grads = self._clip(grads, where)
        updates, new = self._step(grads, state, params, where)
        return updates, _restate(state, new)


class Adam(_Chain):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over a dict of float32 tensors."""

    def __init__(self, lr, clip_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(lr, clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _init(self, params: Tensors, where, specs, prefix) -> dict:
        return dict(mu=self._inherit(params, where, specs, prefix, "mu"),
                    nu=self._inherit(params, where, specs, prefix, "nu"))

    def _step(self, grads: Tensors, state: dict, params, where: _Where):
        count = state["count"]
        t = count + 1
        bc1 = 1 - scalar_like(self.b1, count) ** t
        bc2 = 1 - scalar_like(self.b2, count) ** t
        step = -1 * self._rate(count)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            g = where.to_state(g, k, ("mu", k), state["mu"][k])
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            u = step * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps))
            updates[k] = where.to_param(u, ("mu", k), k)
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
    by the RMS of its parameter (at least 1e-3), and negated.

    On a placed parameter the factored dimensions are chosen from its
    whole shape; a row or column mean over a split dimension, each RMS
    and the row factor's mean are summed over the ranks that hold the
    pieces."""

    def __init__(self, lr, clip_norm: Optional[float] = None, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0, eps: float = 1e-30):
        super().__init__(lr, clip_norm)
        self.min_dim, self.decay_rate = min_dim_size_to_factor, decay_rate
        self.clipping_threshold, self.eps = clipping_threshold, eps

    def _dims(self, p, s, mesh):
        shape = placement.whole_shape(p, s, mesh) if mesh is not None else tuple(p.shape)
        return _factored_dims(shape, self.min_dim)

    def _init(self, params: Tensors, where, specs, prefix) -> dict:
        state = dict(v_row={}, v_col={}, v={})
        for k, p in params.items():
            s = where.pspec(k, p)
            dims = self._dims(p, s, where.mesh)
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            if dims is None:
                state["v_row"][k], state["v_col"][k] = one, one.clone()
                state["v"][k] = torch.zeros_like(p)
                if any(s):
                    specs[prefix + ("v", k)] = s
            else:
                d1, d0 = dims
                state["v_row"][k] = torch.zeros(np.delete(p.shape, d0).tolist(), dtype=p.dtype,
                                                device=p.device)
                state["v_col"][k] = torch.zeros(np.delete(p.shape, d1).tolist(), dtype=p.dtype,
                                                device=p.device)
                for name, d in (("v_row", d0), ("v_col", d1)):
                    if any(placement.drop_dim(s, d)):
                        specs[prefix + (name, k)] = placement.drop_dim(s, d)
                state["v"][k] = one
        return state

    def _step(self, grads: Tensors, state: dict, params, where: _Where):
        _needs_params(params)
        mesh = where.mesh
        count = state["count"]
        decay = 1.0 - (count + 1).to(torch.float32) ** -self.decay_rate
        rate = self._rate(count)
        updates, new = {}, dict(count=count + 1, v_row={}, v_col={}, v={})
        for k, g in grads.items():
            p = params[k]
            s = where.pspec(k, p)
            grad_sqr = g * g + self.eps
            dims = self._dims(p, s, mesh)
            if dims is None:
                v = decay * state["v"][k] + (1.0 - decay) * where.to_state(grad_sqr, k, ("v", k),
                                                                           state["v"][k])
                new["v"][k] = v
                new["v_row"][k], new["v_col"][k] = state["v_row"][k], state["v_col"][k]
                u = where.to_param(where.to_state(g, k, ("v", k), v) * v ** -0.5, ("v", k), k)
            else:
                d1, d0 = dims
                s_row, s_col = placement.drop_dim(s, d0), placement.drop_dim(s, d1)
                r0, c0 = state["v_row"][k], state["v_col"][k]
                v_row = decay * r0 + (1.0 - decay) * placement.reshard(
                    placement.mean_dim(grad_sqr, s, d0, mesh), s_row,
                    where.sspec(("v_row", k), r0), mesh)
                v_col = decay * c0 + (1.0 - decay) * placement.reshard(
                    placement.mean_dim(grad_sqr, s, d1, mesh), s_col,
                    where.sspec(("v_col", k), c0), mesh)
                new["v_row"][k], new["v_col"][k], new["v"][k] = v_row, v_col, state["v"][k]
                v_row = placement.reshard(v_row, where.sspec(("v_row", k), v_row), s_row, mesh)
                v_col = placement.reshard(v_col, where.sspec(("v_col", k), v_col), s_col, mesh)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / placement.mean_dim(v_row, s_row, reduced_d1, mesh,
                                                         keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            u = u / torch.clamp_min(torch.sqrt(placement.mean_all(u * u, s, mesh))
                                    / self.clipping_threshold, 1.0)
            u = rate * u
            rms = torch.sqrt(placement.mean_all(p * p, s, mesh))
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

    def _init(self, params: Tensors, where, specs, prefix) -> dict:
        return dict(mu=self._inherit(params, where, specs, prefix, "mu"))

    def _step(self, grads: Tensors, state: dict, params, where: _Where):
        _needs_params(params)
        count = state["count"]
        step = -1 * self._rate(count)
        updates, mu = {}, {}
        for k, g in grads.items():
            m = state["mu"][k]
            g = where.to_state(g, k, ("mu", k), m)
            p = where.to_state(params[k], k, ("mu", k), m)
            u = torch.sign((1.0 - self.b1) * g + self.b1 * m) + self.weight_decay * p
            updates[k] = where.to_param(step * u, ("mu", k), k)
            mu[k] = (1 - self.b2) * g + self.b2 * m
        return updates, dict(count=count + 1, mu=mu)


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)``: the running mean
    of k micro-step gradients feeds one inner step on the k-th; the
    updates in between are zeros."""

    def __init__(self, inner: _Chain, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params: Tensors) -> dict:
        return _init_placed(self, params)

    def _init_tree(self, params, where: _Where, specs: dict, prefix) -> dict:
        return dict(mini_step=0, acc=_Chain._inherit(params, where, specs, prefix, "acc"),
                    inner=self.inner._init_tree(params, where, specs, prefix + ("inner",)))

    def update(self, grads: Tensors, state: dict, params: Optional[Tensors] = None,
               where: Optional[_Where] = None):
        where = where if where is not None else _Where.of(grads, state, params)
        n = state["mini_step"]
        acc = {k: a + (where.to_state(grads[k], k, ("acc", k), a) - a) / scalar_like(n + 1, a)
               for k, a in state["acc"].items()}
        if n + 1 < self.k:
            zeros = {k: torch.zeros_like(g) for k, g in grads.items()}
            return zeros, _restate(state, dict(mini_step=n + 1, acc=acc, inner=state["inner"]))
        mean = {k: where.to_param(a, ("acc", k), k) for k, a in acc.items()}
        updates, inner = self.inner.update(mean, state["inner"], params, where.sub("inner"))
        return updates, _restate(state, dict(
            mini_step=0, acc={k: torch.zeros_like(a) for k, a in acc.items()}, inner=inner))


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
    """``optax.apply_updates``: ``p + u`` in the parameters' dtype (a
    placed tree keeps its placement)."""
    return placement.like(params, {k: (p + updates[k]).to(p.dtype) for k, p in params.items()})
