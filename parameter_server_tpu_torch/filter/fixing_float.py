"""Randomized fixed-point quantization of the device wire.

Counterpart of ``quantize_jax`` and ``dequantize_jax`` in
``parameter_server_tpu/filter/fixing_float.py``: a 1-D float32 array is
normalized by its own ``[lo, hi]``, stochastically rounded to
``2^(8b) - 1`` levels and stored in ``b`` bytes (uint8 or uint16).
:func:`quantize_range` and :func:`quantize_codes` are the plain PyTorch
version of ``ops/quantize.py``, whose CUDA kernel ``quantize_kernel``
(``kernels/csrc/quantize.cu``) computes the same range and codes of a
CUDA tensor in one launch.

The noise is the TPU kernel's form, the top 24 bits of a random word
times 2^-24, with the word taken from the counter hash
:func:`~..ops.ftrl.dither_hash_u32` of (flat position, seed) instead of
an on-core generator, so the plain version and the kernel agree bit for
bit. Neither can match ``jax.random``'s stream: parity with the JAX
package is statistical.

Where ``hi == lo`` (a constant nonzero array: ``lo + 1e-12`` rounds back
to ``lo``), ``(x - lo) / (hi - lo)`` is 0/0; the code is then 0, which
dequantizes to ``lo`` exactly. The message-level ``FixingFloatFilter``
(the Van layer) is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import scalar_like
from ..ops.ftrl import dither_hash_u32

_NOISE_SCALE = 1.0 / (1 << 24)


def levels_of(num_bytes: int) -> float:
    """The top code of a ``num_bytes`` fixed-point value (255 or 65535)."""
    if num_bytes not in (1, 2):
        raise ValueError(f"fixed-point width must be 1 or 2 bytes, got {num_bytes}")
    return float((1 << (8 * num_bytes)) - 1)


def code_dtype(num_bytes: int) -> torch.dtype:
    return torch.uint8 if num_bytes == 1 else torch.uint16


def quantize_range(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lo = min(x) + 0.0``, ``hi = max(max(x), lo + 1e-12) + 0.0`` as
    0-dim float32 tensors beside ``x``, over the whole (unpadded) input.

    The ``+ 0.0`` makes the bits independent of the reduction's order:
    ``aminmax`` keeps the second operand of a tie, so the sign of a zero
    min or max of an input holding both +0.0 and -0.0 depends on its
    reduction tree; after the add a zero ``lo`` or ``hi`` is +0.0. A NaN
    anywhere makes both NaN (the card's add returns its canonical NaN).
    Neither changes a code or a decoded value."""
    lo, top = torch.aminmax(x)
    lo = lo + 0.0
    return lo, torch.maximum(top, lo + 1e-12) + 0.0


def quantize_noise(n: int, seed: int, device) -> torch.Tensor:
    """Uniform [0, 1) noise for flat positions ``0..n-1``: the top 24 bits
    of ``dither_hash_u32(position, seed)`` times 2^-24 (exact in f32)."""
    pos = torch.arange(n, device=device, dtype=torch.int64)
    return (dither_hash_u32(pos, seed) >> 8).to(torch.float32) * _NOISE_SCALE


def quantize_codes(x, lo, hi, seed: int, num_bytes: int) -> torch.Tensor:
    """The elementwise part, given ``lo``/``hi``: the plain twin of
    ``quantize_kernel``, operation for operation."""
    levels = levels_of(num_bytes)
    scaled = (x - lo) / (hi - lo) * levels
    v = torch.floor(scaled + quantize_noise(x.numel(), seed, x.device))
    v = torch.where(v >= 0, v, 0.0)  # negatives, and NaN where hi == lo
    return torch.clamp_max(v, levels).to(code_dtype(num_bytes))


def dequantize_torch(q: torch.Tensor, lo, hi, num_bytes: int) -> torch.Tensor:
    """``q / levels * (hi - lo) + lo`` in float32, bit-equal to
    ``dequantize_jax``. The division takes ``levels`` as a 0-dim tensor:
    with a Python number PyTorch would multiply by its reciprocal."""
    levels = scalar_like(levels_of(num_bytes), lo)
    return q.to(torch.float32) / levels * (hi - lo) + lo
