"""Ordered key matching and merging (host, numpy).

Counterpart of ``parameter_server_tpu/utils/ordered_match.py`` (the
reference's ``parallel_ordered_match.h``): for two sorted unique key
arrays, the positions of the source keys in the destination, and the
merge of the source values into the matching destination rows by an
:class:`~.assign_op.AssignOp`. ``searchsorted`` does what the
reference's recursive, threaded match does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .assign_op import AssignOp, apply_op


def match_positions(dst_keys: np.ndarray, src_keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """For each src key present in dst, its position in dst: returns
    ``(src_hit_mask, dst_pos_of_hits)``. Both arrays sorted and unique."""
    pos = np.searchsorted(dst_keys, src_keys)
    posc = np.minimum(pos, max(len(dst_keys) - 1, 0))
    hit = (
        (pos < len(dst_keys)) & (dst_keys[posc] == src_keys)
        if len(dst_keys)
        else np.zeros(len(src_keys), dtype=bool)
    )
    return hit, pos[hit]


def ordered_match(dst_keys: np.ndarray, dst_vals: np.ndarray, src_keys: np.ndarray,
                  src_vals: np.ndarray, op: AssignOp = AssignOp.ASSIGN, k: int = 1) -> int:
    """Merge ``src_vals`` into ``dst_vals`` (in place) where the keys
    match; returns the number matched. ``k`` values a key, laid out
    ``[nkeys, k]`` or flat."""
    hit, pos = match_positions(dst_keys, src_keys)
    dv = dst_vals.reshape(len(dst_keys), k)
    sv = src_vals.reshape(len(src_keys), k)
    dv[pos] = apply_op(op, dv[pos], sv[hit])
    return int(hit.sum())
