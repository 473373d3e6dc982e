"""Ring collectives over an axis of the mesh.

Counterpart of ``parameter_server_tpu/parallel/ring.py``. The JAX
functions run inside ``shard_map`` over a named axis and hop by
``ppermute``; here every rank of the axis group calls them with its own
shard and the mesh (``mesh=``), and each hop is :func:`..mesh.shift`
(one send and one receive a rank), whose gradient comes back the other
way. Every rank of the group must make the same calls, in the same
order.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import mesh as meshlib
from .mesh import Mesh


def ring_next(x: torch.Tensor, axis: str, shift: int = 1, *, mesh: Mesh) -> torch.Tensor:
    """Send to the next rank on the ring (``shift`` on); receive from the
    previous."""
    return meshlib.shift(x, axis, mesh, shift)


def ring_allreduce(x: torch.Tensor, axis: str, *, mesh: Mesh) -> torch.Tensor:
    """Allreduce as an explicit ring schedule: rotate and add, n - 1 hops.
    Semantically :func:`..mesh.psum`; this form lets a schedule put
    compute between the hops (:func:`ring_scan`)."""
    n = mesh.shape[axis]
    total = x
    rotated = x
    for _ in range(n - 1):
        rotated = ring_next(rotated, axis, mesh=mesh)
        total = total + rotated
    return total


def ring_allgather(x: torch.Tensor, axis: str, *, mesh: Mesh) -> torch.Tensor:
    """All-gather by n - 1 neighbour hops: ``[n, *x.shape]``, the ranks'
    shards in coordinate order."""
    n = mesh.shape[axis]
    pieces = [x]
    cur = x
    for _ in range(n - 1):
        cur = ring_next(cur, axis, mesh=mesh)
        pieces.append(cur)
    idx = meshlib.axis_index(axis, mesh)
    # hop t holds the shard of coordinate (idx - t) mod n
    order = [pieces[(idx - j) % n] for j in range(n)]
    return torch.stack(order)


def ring_scan(x: torch.Tensor, axis: str, fn: Callable, init: torch.Tensor, *,
              mesh: Mesh) -> torch.Tensor:
    """Stream every rank's shard past a local accumulator: ``acc = fn(acc,
    block, step)`` for each of the n ring steps (``step`` a Python int),
    the skeleton under ring attention (block = a remote K/V shard)."""
    n = mesh.shape[axis]
    acc = init
    block = x
    for step in range(n):
        acc = fn(acc, block, step)
        if step + 1 < n:
            block = ring_next(block, axis, mesh=mesh)
    return acc
