"""Convolutional network and MLP for the KVLayer NN worker.

Counterpart of ``parameter_server_tpu/models/convnet.py`` (flax modules)
as ``nn.Module``s with the flax modules' layer names (``Conv_0``,
``Conv_1``, ``Dense_0``, ``Dense_1``). Inputs stay NHWC as in flax; the
3x3 convolutions pad SAME (one pixel a side), the 2x2 average pools are
VALID, and the feature map is flattened in NHWC order, so a flax Dense
kernel carries across by a transpose alone (``convert.
nn_params_from_flax``). The products are ``F.conv2d`` and
``F.linear``: the JAX package computes these in XLA, not in Pallas.

Like flax's ``init``, :meth:`ConvNet.init` / :meth:`MLP.init` build the
layers for an input shape and draw the weights (flax's default
``lecun_normal``: a normal of variance 1/fan_in truncated at two standard
deviations; zero biases) from a ``torch.Generator`` seeded with ``seed``,
on the CPU and then moved, so every device starts from the same bits.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(module: nn.Module, gen: torch.Generator) -> None:
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
                continue
            fan_in = p[0].numel()  # [out, in] or [out, in, kh, kw]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _finish(module: nn.Module, seed: int, device) -> nn.Module:
    _lecun_normal_(module, torch.Generator().manual_seed(int(seed)))
    return module.to(resolve(device))


class ConvNet(nn.Module):
    """conv(width) -> relu -> avgpool -> conv(2 width) -> relu -> avgpool
    -> dense(128) -> relu -> dense(num_classes), on NHWC input."""

    def __init__(self, num_classes: int = 10, width: int = 32):
        super().__init__()
        self.num_classes = int(num_classes)
        self.width = int(width)

    def init(self, seed: int, input_shape: Tuple[int, ...], device=None) -> "ConvNet":
        """Build the layers for ``input_shape`` (H, W, C) and draw the
        weights; returns the module on ``device`` (the card unless
        named)."""
        h, w, c = input_shape
        self.Conv_0 = nn.Conv2d(c, self.width, 3, padding=1)
        self.Conv_1 = nn.Conv2d(self.width, 2 * self.width, 3, padding=1)
        self.Dense_0 = nn.Linear((h // 4) * (w // 4) * 2 * self.width, 128)
        self.Dense_1 = nn.Linear(128, self.num_classes)
        return _finish(self, seed, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: [B, H, W, C]
        x = x.permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        return self.Dense_1(F.relu(self.Dense_0(x)))


class MLP(nn.Module):
    """Small dense net: flatten -> dense(hidden) -> relu ->
    dense(num_classes)."""

    def __init__(self, num_classes: int = 10, hidden: int = 64):
        super().__init__()
        self.num_classes = int(num_classes)
        self.hidden = int(hidden)

    def init(self, seed: int, input_shape: Tuple[int, ...], device=None) -> "MLP":
        self.Dense_0 = nn.Linear(math.prod(input_shape), self.hidden)
        self.Dense_1 = nn.Linear(self.hidden, self.num_classes)
        return _finish(self, seed, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x)))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over rows of ``-sum(onehot * log_softmax(logits))``."""
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))
