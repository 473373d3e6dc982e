"""Slot-id helpers of the key-value data plane, single server shard.

Counterparts of ``localize``, ``slot_sentinel`` and ``valid_slots`` in
``parameter_server_tpu/ops/kv_ops.py``. The port runs one server shard
per process, so the shard's key range starts at 0; the sharded pull and
push collectives are not ported yet.
"""

from __future__ import annotations

import torch


def localize(idx: torch.Tensor, shard: int):
    """Shard-relative index + ownership mask (shard range starts at 0).

    ``rel = clip(idx, 0, shard - 1)``: a non-owned id (the sentinel
    ``num_slots``, or -1 at 2^31 slots) clips onto a REAL slot, so every
    consumer must mask it with ``ok`` before writing."""
    if shard > (1 << 31):
        raise ValueError(
            f"shard of {shard} slots exceeds int32 slot ids; "
            "spread the table over more server shards"
        )
    if shard == (1 << 31):
        return torch.clamp(idx, 0, (1 << 31) - 1), idx >= 0
    ok = (idx >= 0) & (idx < shard)
    return torch.clamp(idx, 0, shard - 1), ok


def slot_sentinel(num_slots: int) -> int:
    """Padding slot id: one-past-the-end when that fits int32, else -1."""
    return num_slots if num_slots < (1 << 31) else -1


def valid_slots(slots: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Mask of non-sentinel slot ids."""
    if num_slots >= (1 << 31):
        return slots >= 0
    return slots < num_slots
