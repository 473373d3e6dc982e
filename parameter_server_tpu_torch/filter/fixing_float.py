"""Randomized fixed-point quantization (the reference's
``src/filter/fixing_float.h``), on the host and on the device wire.

On the host, :func:`quantize`, :func:`dequantize` and the message filter
:class:`FixingFloatFilter` are copies of the JAX package's numpy forms:
``[lo, hi]`` from the array, ``floor(scaled + U[0, 1))`` in float64 with
the noise from a numpy ``Generator`` (the filter's own ``default_rng(0)``),
so the codes and ranges are the JAX package's bit for bit.

On the device, the counterparts of ``quantize_jax`` and
``dequantize_jax`` in ``parameter_server_tpu/filter/fixing_float.py``
carry the 1-byte push of the linear step: a 1-D float32 array is
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
dequantizes to ``lo`` exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import scalar_like
from ..ops.ftrl import dither_hash_u32
from ..system.message import FilterSpec, Message
from .base import Filter, register

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


# -- the host form: numpy, the JAX package's bits --


def quantize(arr: np.ndarray, num_bytes: int,
             rng: np.random.Generator) -> Tuple[np.ndarray, float, float]:
    """Codes (uint8 or uint16), lo and hi of ``arr`` (``hi = lo + 1``
    where the array is constant), stochastically rounded with ``rng``."""
    assert num_bytes in (1, 2), "fixed-point width must be 1 or 2 bytes"
    lo, hi = float(arr.min()), float(arr.max())
    if hi <= lo:
        hi = lo + 1.0
    levels = float((1 << (8 * num_bytes)) - 1)
    scaled = (arr.astype(np.float64) - lo) / (hi - lo) * levels
    q = np.floor(scaled + rng.random(arr.shape))  # stochastic rounding (ref boolrand)
    dt = np.uint8 if num_bytes == 1 else np.uint16
    return np.clip(q, 0, levels).astype(dt), lo, hi


def dequantize(q: np.ndarray, lo: float, hi: float, num_bytes: int) -> np.ndarray:
    levels = float((1 << (8 * num_bytes)) - 1)
    return (q.astype(np.float64) / levels * (hi - lo) + lo).astype(np.float32)


@register
class FixingFloatFilter(Filter):
    """Each nonempty float value array as ``num_bytes`` codes; its range
    rides in the spec (``extra["ranges"]``). Other arrays pass through."""

    TYPE = "fixing_float"

    def __init__(self) -> None:
        self._rng = np.random.default_rng(0)

    def encode(self, msg: Message, spec: FilterSpec) -> Message:
        if spec.num_bytes == 0:
            return msg
        ranges = []
        out = []
        for v in msg.values:
            if v.dtype.kind != "f" or v.size == 0:
                out.append(v)
                ranges.append(None)
                continue
            q, lo, hi = quantize(v, spec.num_bytes, self._rng)
            out.append(q)
            ranges.append((lo, hi))
        msg.values = out
        spec.extra["ranges"] = ranges
        return msg

    def decode(self, msg: Message, spec: FilterSpec) -> Message:
        if spec.num_bytes == 0 or "ranges" not in spec.extra:
            return msg
        out = []
        for v, r in zip(msg.values, spec.extra["ranges"]):
            out.append(v if r is None else dequantize(v, r[0], r[1], spec.num_bytes))
        msg.values = out
        return msg
