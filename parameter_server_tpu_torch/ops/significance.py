"""KKT significance filter of the sparse update path.

Counterpart of ``parameter_server_tpu/ops/significance.py``. For an
L1-regularized objective the FTRL-proximal weight of a slot is zero iff
``|z| <= lambda1``, so a slot at ``w == 0`` whose accumulator after this
step's gradient stays inside the dead zone (``|z + g| <= lambda1 *
margin``) takes an update that cannot move its weight. :func:`kkt_mask`
marks those slots suppressed; the step zeroes their gradient and leaves
their rows bit-untouched (``ok & keep`` reaches the sparse FTRL kernel).

A seeded fraction ``escape`` of the suppressed slots ships anyway, so a
feature whose per-step gradient never leaves the dead zone still
accumulates z. The decision is a counter hash of (position in the padded
unique-slot vector, seed ^ 0x5EED5EED), the dither stream of
``ops/ftrl.py``, so it is bit-equal to the JAX package's given the same
padding. ``escape >= 1`` keeps every slot and changes nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from .ftrl import dither_hash_u32

_ESCAPE_SALT = 0x5EED5EED
_U32_SPAN = 4294967296.0  # 2^32: escape probability -> hash threshold


@dataclasses.dataclass(frozen=True)
class SignificanceSpec:
    """Constants of the filter: ``l1`` the penalty's lambda1 (the dead
    zone's radius), ``margin`` its scale (1.0 suppresses only provable
    no-ops), ``escape`` the share of suppressed slots that ship anyway,
    ``feedback`` whether the step returns the per-slot keep vector and
    slot ids for the host's drop set (scan supersteps turn it off: their
    metrics fold sums over ministeps)."""

    l1: float
    margin: float = 1.0
    escape: float = 1.0 / 64.0
    feedback: bool = False

    def without_feedback(self) -> "SignificanceSpec":
        return dataclasses.replace(self, feedback=False)


def kkt_mask(z_u: torch.Tensor, g_u: torch.Tensor, w_u: torch.Tensor,
             umask: torch.Tensor, seed: int, *, spec: SignificanceSpec):
    """``(keep, suppressed)`` over the unique-slot vectors of a sparse
    ministep: ``z_u`` the pulled z (0 where not owned), ``g_u`` the
    summed gradient, ``w_u`` the pulled weights, ``umask`` the real-slot
    mask. ``keep`` is bool; ``suppressed`` the float32 count of real
    slots suppressed. Padding slots always keep."""
    if spec.escape >= 1.0:
        return torch.ones_like(umask, dtype=torch.bool), torch.zeros((), device=umask.device)
    at_zero = (w_u == 0.0) & (umask > 0)
    # the z fold at w == 0 is z + g: the slot stays a no-op iff that
    # lands inside the scaled dead zone (the threshold rounded to f32,
    # as the JAX package's np.float32 constant is)
    limit = torch.tensor(spec.l1 * spec.margin, dtype=torch.float32, device=z_u.device)
    suppress = at_zero & ((z_u + g_u).abs() <= limit)
    if spec.escape > 0.0:
        pos = torch.arange(z_u.shape[0], device=z_u.device)
        h = dither_hash_u32(pos, (int(seed) ^ _ESCAPE_SALT) & 0xFFFFFFFF)
        suppress = suppress & ~(h < int(spec.escape * _U32_SPAN))
    return ~suppress, suppress.to(torch.float32).sum()
