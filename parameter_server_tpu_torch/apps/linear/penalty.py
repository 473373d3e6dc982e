"""Elastic net ``λ1 |x| + λ2 x²`` and its proximal step
``prox(z, η) = soft(z, λ1 η) / (1 + λ2 η)``."""

from __future__ import annotations

import torch


class ElasticNet:
    def __init__(self, lambda1: float = 0.0, lambda2: float = 0.0):
        if lambda1 < 0 or lambda2 < 0:
            raise ValueError(f"penalties must be >= 0, got {lambda1}, {lambda2}")
        self.lambda1 = float(lambda1)
        self.lambda2 = float(lambda2)

    def eval(self, w: torch.Tensor) -> torch.Tensor:
        return self.lambda1 * w.abs().sum() + self.lambda2 * (w * w).sum()

    def proximal(self, z: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
        """argmin_x 0.5/η (x-z)² + h(x)."""
        leta = self.lambda1 * eta
        shrunk = torch.sign(z) * torch.clamp_min(z.abs() - leta, 0.0)
        return shrunk / (1.0 + self.lambda2 * eta)


def create_penalty(type_: str, lambdas) -> ElasticNet:
    """L1 -> (λ1[, λ2]), L2 -> (0, λ)."""
    t = type_.lower()
    lambdas = list(lambdas)
    if t == "l1":
        return ElasticNet(lambdas[0], lambdas[1] if len(lambdas) > 1 else 0.0)
    if t == "l2":
        return ElasticNet(0.0, lambdas[0])
    raise ValueError(f"unknown penalty type: {type_}")
