"""Carry optimizer state between the JAX package and the port.

The JAX worker's ``state_host()["state"]`` is a dict of numpy arrays
(``{"z", "sqrt_n"}`` for FTRL; a bf16 ``sqrt_n`` arrives as an
``ml_dtypes.bfloat16`` array). :func:`state_from_jax` turns it into the
port's dict of tensors, :func:`state_to_numpy` goes back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import resolve


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # owned and writable
    if arr.dtype.name == "bfloat16":  # ml_dtypes array: move the raw bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def state_from_jax(np_state: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """numpy state dict -> tensors on ``device`` (CUDA by default). The
    tensors own their memory: the port updates state in place."""
    dev = resolve(device)
    return {k: _to_tensor(v).to(dev) for k, v in np_state.items()}


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """tensors -> numpy state dict. bf16 tensors come back as
    ``ml_dtypes.bfloat16`` arrays when that package is installed (the
    JAX package's own form), else widened exactly to float32."""
    out = {}
    for k, t in state.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            try:
                import ml_dtypes
            except ImportError:
                out[k] = t.to(torch.float32).numpy()
            else:
                out[k] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[k] = t.numpy().copy()
    return out
