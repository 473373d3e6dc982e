"""Device selection for the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    CUDA device. With no choice and no GPU this raises instead of
    running on the CPU, so a missing card never passes for a slow run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor beside ``like``. Dividing by
    (or into) it is a true division on every device: with a Python
    number PyTorch multiplies by a reciprocal instead (``__rtruediv__``
    on every device, a CPU-scalar divisor on CUDA), which rounds twice
    and would part the plain version from its kernel and from JAX.
    Cached per (value, device), so a step pays no host-to-device copy
    for it; callers must not write to the returned tensor."""
    return _scalar(float(value), like.device)


@functools.lru_cache(maxsize=256)
def _scalar(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)
