"""Server-side updaters: FTRL, AdaGrad, SGD.

Counterparts of ``parameter_server_tpu/apps/linear/updaters.py``. State
is a dict of tensors (the JAX updaters' struct-of-arrays). ``apply``
updates the state IN PLACE and returns it: FTRL with a decaying rate
goes through the fused update (``ops/ftrl.py``: the CUDA kernel on the
card), the others are plain PyTorch.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...device import scalar_like
from ...ops.ftrl import ftrl_update, stochastic_round_bf16
from ...ops.ftrl_sparse import assert_ok_unique, ftrl_sparse_update
from .learning_rate import LearningRate
from .penalty import ElasticNet

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FTRLUpdater:
    """FTRL-proximal: n' = sqrt(n² + g²); σ = (n' − n)/α; z += g − σ w;
    w = prox(−z·η, η), η = α/(n + β). ``sqrt_n_dtype="bfloat16"`` stores
    the accumulator at half width (math stays f32; the narrow is
    stochastically rounded when a seed is given). z is always f32."""

    def __init__(self, lr: LearningRate, penalty: ElasticNet,
                 sqrt_n_dtype="float32"):
        self.lr = lr
        self.penalty = penalty
        self.sqrt_n_dtype = (
            _DTYPES[sqrt_n_dtype] if isinstance(sqrt_n_dtype, str) else sqrt_n_dtype
        )

    def init(self, num_slots: int, device) -> Dict[str, torch.Tensor]:
        return {
            "z": torch.zeros(num_slots, dtype=torch.float32, device=device),
            "sqrt_n": torch.zeros(num_slots, dtype=self.sqrt_n_dtype, device=device),
        }

    def weights(self, state):
        eta = self.lr.eval(state["sqrt_n"].to(torch.float32))
        return self.penalty.proximal(-state["z"] * eta, eta)

    def apply(self, state, grad, touched, seed=None):
        z = state["z"]
        if self.lr.type == LearningRate.DECAY and z.dim() == 1:
            ftrl_update(
                z, state["sqrt_n"], grad, touched,
                alpha=self.lr.alpha, beta=self.lr.beta,
                l1=self.penalty.lambda1, l2=self.penalty.lambda2, seed=seed,
            )
            return state
        if touched is None:  # unquantized push: membership == support
            touched = grad != 0
        sqrt_n = state["sqrt_n"].to(torch.float32)
        w = self.weights(state)
        sqrt_n_new = torch.sqrt(sqrt_n * sqrt_n + grad * grad)
        sigma = torch.div(sqrt_n_new - sqrt_n, scalar_like(self.lr.alpha, z))
        z_new = z + grad - sigma * w
        masked_n = torch.where(touched, sqrt_n_new, sqrt_n)
        if self.sqrt_n_dtype == torch.bfloat16 and seed is not None:
            masked_n = stochastic_round_bf16(masked_n, seed)
        z.copy_(torch.where(touched, z_new, z))
        state["sqrt_n"].copy_(masked_n.to(self.sqrt_n_dtype))
        return state


class AdaGradUpdater:
    """AdaGrad: sum_sq += g²; w = prox(w − η g, η), η = lr.eval(√sum_sq)."""

    def __init__(self, lr: LearningRate, penalty: ElasticNet):
        self.lr = lr
        self.penalty = penalty

    def init(self, num_slots: int, device) -> Dict[str, torch.Tensor]:
        return {
            "w": torch.zeros(num_slots, dtype=torch.float32, device=device),
            "sum_sq": torch.zeros(num_slots, dtype=torch.float32, device=device),
        }

    def weights(self, state):
        return state["w"]

    def apply(self, state, grad, touched, seed=None):
        if touched is None:
            touched = grad != 0
        sum_sq = state["sum_sq"] + grad * grad
        eta = self.lr.eval(torch.sqrt(sum_sq))
        w = self.penalty.proximal(state["w"] - eta * grad, eta)
        state["w"].copy_(torch.where(touched, w, state["w"]))
        state["sum_sq"].copy_(torch.where(touched, sum_sq, state["sum_sq"]))
        return state


class SGDUpdater:
    """Proximal SGD with a global step count: w = prox(w − η g, η),
    η = lr.eval(√t)."""

    def __init__(self, lr: LearningRate, penalty: ElasticNet):
        self.lr = lr
        self.penalty = penalty

    def init(self, num_slots: int, device) -> Dict[str, torch.Tensor]:
        return {
            "w": torch.zeros(num_slots, dtype=torch.float32, device=device),
            "t": torch.zeros((), dtype=torch.float32, device=device),
        }

    def weights(self, state):
        return state["w"]

    def apply(self, state, grad, touched, seed=None):
        if touched is None:
            touched = grad != 0
        t = state["t"] + 1.0
        eta = self.lr.eval(torch.sqrt(t))
        w = self.penalty.proximal(state["w"] - eta * grad, eta)
        state["w"].copy_(torch.where(touched, w, state["w"]))
        state["t"].copy_(t)
        return state


def apply_state_rows(updater, state, rel, ok, g_u, seed=None):
    """Sparse-touched update, IN PLACE: run the updater on just the
    gathered rows ``rel`` of the shard and scatter the results back.

    ``rel`` must be duplicate-free among ``ok`` entries (asserted on
    host-resident inputs). Non-``ok`` entries point at real slots after
    clipping; their gradient is zeroed for the gathered math and their
    rows are never written. Scalar state (SGD's step count) takes the
    updated value directly. FTRL with a decaying rate takes the fused
    sparse update (the CUDA kernel on the card)."""
    ok = ok.to(torch.bool)
    if (
        isinstance(updater, FTRLUpdater)
        and updater.lr.type == LearningRate.DECAY
        and state["z"].dim() == 1
    ):
        ftrl_sparse_update(
            state["z"], state["sqrt_n"], rel, ok, g_u,
            alpha=updater.lr.alpha, beta=updater.lr.beta,
            l1=updater.penalty.lambda1, l2=updater.penalty.lambda2, seed=seed,
        )
        return state
    assert_ok_unique(rel, ok)
    idx = rel.to(torch.int64)
    state_u = {k: (v[idx] if v.dim() >= 1 else v.clone()) for k, v in state.items()}
    new_u = updater.apply(state_u, torch.where(ok, g_u, torch.zeros_like(g_u)), None, seed=seed)
    dst = idx[ok]
    for k, full in state.items():
        if full.dim() < 1:
            full.copy_(new_u[k])
        else:
            full.index_copy_(0, dst, new_u[k][ok].to(full.dtype))
    return state


def create_updater(algo: str, ada_grad: bool, lr: LearningRate,
                   penalty: ElasticNet, ftrl_state_dtype: str = "float32"):
    a = algo.lower()
    if a == "ftrl":
        return FTRLUpdater(lr, penalty, sqrt_n_dtype=ftrl_state_dtype)
    if a == "standard":
        return AdaGradUpdater(lr, penalty) if ada_grad else SGDUpdater(lr, penalty)
    raise ValueError(f"unknown sgd algo: {algo}")
