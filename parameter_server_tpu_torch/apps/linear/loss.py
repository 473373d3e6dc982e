"""Scalar losses for linear methods: objective, per-row gradient
dL/d(Xw) and per-row curvature, as in the JAX package's ``loss.py``."""

from __future__ import annotations

import torch


class LogitLoss:
    """L(y, Xw) = sum log(1 + exp(-y Xw)), y ∈ {-1, +1}."""

    def row_loss(self, y, xw):
        m = -y * xw
        return torch.logaddexp(torch.zeros_like(m), m)

    def evaluate(self, y, xw):
        return self.row_loss(y, xw).sum()

    def row_grad(self, y, xw):
        tau = torch.reciprocal(1.0 + torch.exp(y * xw))
        return -y * tau

    def row_hess(self, y, xw):
        tau = torch.reciprocal(1.0 + torch.exp(y * xw))
        return tau * (1.0 - tau)


class SquareHingeLoss:
    """L = sum max(0, 1 - y Xw)^2."""

    def row_loss(self, y, xw):
        return torch.clamp_min(1.0 - y * xw, 0.0) ** 2

    def evaluate(self, y, xw):
        return self.row_loss(y, xw).sum()

    def row_grad(self, y, xw):
        return -2.0 * y * torch.clamp_min(1.0 - y * xw, 0.0)

    def row_hess(self, y, xw):
        return torch.where(y * xw < 1.0, 2.0, 0.0)


class SquareLoss:
    """L = 0.5 sum (Xw - y)^2 (regression)."""

    def row_loss(self, y, xw):
        return 0.5 * (xw - y) ** 2

    def evaluate(self, y, xw):
        return self.row_loss(y, xw).sum()

    def row_grad(self, y, xw):
        return xw - y

    def row_hess(self, y, xw):
        return torch.ones_like(y)


def create_loss(type_: str):
    t = type_.lower()
    if t == "logit":
        return LogitLoss()
    if t in ("square_hinge", "squarehinge"):
        return SquareHingeLoss()
    if t == "square":
        return SquareLoss()
    raise ValueError(f"unknown loss type: {type_}")
