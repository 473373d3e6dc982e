"""Learning-rate schedules: CONSTANT η = α; DECAY η(x) = α / (x + β),
where x is the per-coordinate scale (√n in FTRL/AdaGrad)."""

from __future__ import annotations

import torch

from ...device import scalar_like


class LearningRate:
    CONSTANT = "constant"
    DECAY = "decay"

    def __init__(self, type_: str = DECAY, alpha: float = 0.1, beta: float = 1.0):
        if not (alpha > 0 and beta >= 0):
            raise ValueError(f"need alpha > 0 and beta >= 0, got {alpha}, {beta}")
        self.type = type_.lower()
        if self.type not in (self.CONSTANT, self.DECAY):
            raise ValueError(f"unknown learning rate type: {type_}")
        self.alpha = float(alpha)
        self.beta = float(beta)

    def eval(self, x: torch.Tensor) -> torch.Tensor:
        if self.type == self.CONSTANT:
            return scalar_like(self.alpha, x)
        return torch.div(scalar_like(self.alpha, x), x + self.beta)
