"""The bytes the two FTRL updates need, counted from their inputs.

Shared by ``chip_smoke.py`` and :mod:`.ftrl_ab`; plain PyTorch on
tensors of any device, no card needed.

Two counts for each call:

- ``bytes``, the bound's (what the inputs need: each input read once,
  each output written once, at the members only):

  - dense with a mask: ``P`` mask bytes + members × (4 of ``g`` + 4 + 4
    of ``z`` + 2 × size(``n``));
  - dense without one: ``4P`` of ``g`` + members × (8 + 2 × size(``n``));
  - sparse: ``U`` bytes of ``ok`` + 4 of ``g_u`` at each ``ok`` position
    (a zero there ends the work) + live × (4 of ``rel`` + 8 + 2 ×
    size(``n``)); the sentinel tail (``ok`` false) needs its ``ok`` byte
    only.

- ``sector_bytes``, the floor of the card's DRAM traffic: the same
  streams, plus every distinct 32-byte sector of ``g``, ``z`` and ``n``
  that a member touches, read once and written once (``g`` read only,
  and only with a mask: without one it is in the stream); for the sparse
  update the sectors of ``g_u`` at the ``ok`` positions and of ``rel`` at
  the live ones stand in for their streams. A 4-byte
  access moves a whole sector, so members scattered at random cost up to
  8 times their bytes. Sectors are counted exactly from the index set,
  with each array starting on a sector boundary. ``granule=64`` counts the
  same in 64-byte granules (two sectors), the unit in which the card's
  DRAM may move data in practice.
"""

from __future__ import annotations

import torch

SECTOR = 32  # bytes of the smallest DRAM access
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
STATE_BYTES = 8  # z read and written, float32


def sectors(idx: torch.Tensor, size: int, granule: int = SECTOR) -> int:
    """Distinct ``granule``-byte sectors that the elements ``idx`` of an
    array of ``size``-byte elements touch."""
    return int(torch.unique(idx.to(torch.int64) * size // granule).numel())


def _table_sectors(idx: torch.Tensor, n_size: int, granule: int) -> int:
    """Sector bytes of z and n at ``idx``, each read and written."""
    return 2 * granule * (sectors(idx, 4, granule) + sectors(idx, n_size, granule))


def dense_counts(keep: torch.Tensor, n_size: int, masked: bool, granule: int = SECTOR) -> dict:
    """Counts of the dense update over a shard of ``keep.numel()`` slots
    whose members are ``keep`` (the mask, or ``g != 0``)."""
    p = keep.numel()
    idx = torch.nonzero(keep.reshape(-1)).reshape(-1)
    members = idx.numel()
    stream = p if masked else 4 * p
    g_at_members = 4 * members if masked else 0
    g_sectors = granule * sectors(idx, 4, granule) if masked else 0
    return dict(
        members=members,
        bytes=stream + g_at_members + members * (STATE_BYTES + 2 * n_size),
        sector_bytes=stream + g_sectors + _table_sectors(idx, n_size, granule),
    )


def sparse_counts(rel: torch.Tensor, ok: torch.Tensor, g_u: torch.Tensor, n_size: int,
                  granule: int = SECTOR) -> dict:
    """Counts of the sparse update over U = ``rel.numel()`` positions;
    live are the ``ok`` positions with a nonzero gradient. ``ok`` is read
    at every position, ``g_u`` where ``ok`` holds, ``rel`` and the table
    at the live ones (sentinels touch no table bytes)."""
    u = rel.numel()
    ok = ok.to(torch.bool)
    live = ok & (g_u != 0)
    at_ok = torch.nonzero(ok).reshape(-1)
    at_live = torch.nonzero(live).reshape(-1)
    idx = rel[live]
    members = idx.numel()
    return dict(
        members=members,
        bytes=u + 4 * at_ok.numel() + members * (4 + STATE_BYTES + 2 * n_size),
        sector_bytes=u + granule * (sectors(at_ok, 4, granule) + sectors(at_live, 4, granule))
        + _table_sectors(idx, n_size, granule),
    )


def ms(nbytes: float) -> float:
    """Milliseconds to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3
