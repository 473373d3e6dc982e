"""Key → slot directory (hashed) and table padding.

Counterpart of ``KeyDirectory`` and ``pad_slots`` in
``parameter_server_tpu/parameter/parameter.py``, cut to the hashed
directory the linear worker uses: no exact-key mode, no slot cache, no
migration remap.
"""

from __future__ import annotations

import numpy as np

from ..utils.murmur import hash_slots


class KeyDirectory:
    """Host-side key → slot mapping for one channel (hashed only)."""

    def __init__(self, num_slots: int, hashed: bool = True):
        if not hashed:
            raise NotImplementedError(
                "the port's KeyDirectory is hashed only; exact-key "
                "directories are not ported yet"
            )
        self.num_slots = int(num_slots)
        self.hashed = True

    def slots(self, keys: np.ndarray) -> np.ndarray:
        """Map global keys to int32 slot ids in ``[0, num_slots)``."""
        return hash_slots(np.asarray(keys), self.num_slots)


def pad_slots(num_slots: int, num_shards: int) -> int:
    """Round slots up so every server shard is equal-sized."""
    per = -(-num_slots // num_shards)
    return per * num_shards
