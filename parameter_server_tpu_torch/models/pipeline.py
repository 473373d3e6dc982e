"""Pipeline parallelism's stage stack, on one card.

Counterpart of ``parameter_server_tpu/models/pipeline.py``. There a deep
stack of identical stages is sharded over a mesh axis, each device
holding a contiguous block of stages, and microbatches stream through
the GPipe fill-drain schedule with activations hopping between devices.
On one card the axis has size 1: the one stage block holds every stage,
and each tick chains the whole stack on one microbatch, which is
:func:`sequential_apply`. The schedule across cards (the ``ppermute``
hop) is ROADMAP A9 (multi-GPU): :func:`pipeline_apply` with more than
one stage group raises ``NotImplementedError`` naming it.

``stage_params`` is a tree (dicts, lists, tuples) of tensors with a
leading dim of one slice per stage; ``stage_fn(params_slice, x_mb)``
applies one stage; ``x`` is ``[M, mb, ...]`` microbatches.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _leading(tree: Any) -> int:
    """The stage count: the leading dim of the tree's first leaf."""
    if isinstance(tree, dict):
        return _leading(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _leading(tree[0])
    return tree.shape[0]


def _stage(tree: Any, s: int) -> Any:
    """Stage ``s``'s slice of every leaf."""
    if isinstance(tree, dict):
        return {k: _stage(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage(v, s) for v in tree)
    return tree[s]


def sequential_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor) -> torch.Tensor:
    """Dense reference: the stages in order on every microbatch."""
    n = _leading(stage_params)

    def one(mb):
        for s in range(n):
            mb = stage_fn(_stage(stage_params, s), mb)
        return mb

    return torch.stack([one(x[m]) for m in range(x.shape[0])])


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor, *,
                   n_groups: int = 1) -> torch.Tensor:
    """``x`` through the stage stack split into ``n_groups`` contiguous
    stage groups, one a card. The stage count must be a multiple of
    ``n_groups`` (``ValueError``, as JAX's check against the mesh axis).
    One group is the one-card pipeline: every tick chains the whole
    stack on its microbatch. More groups need the schedule across cards
    (ROADMAP A9) and raise ``NotImplementedError``."""
    n_stages = _leading(stage_params)
    if n_groups < 1 or n_stages == 0 or n_stages % n_groups:
        raise ValueError(f"stage count {n_stages} must be a MULTIPLE of the stage groups "
                         f"{n_groups} (each card holds one contiguous stage block)")
    if n_groups > 1:
        raise NotImplementedError(
            f"pipeline_apply over {n_groups} stage groups runs the fill-drain schedule across "
            "cards, which the PyTorch package does not do yet (ROADMAP A9, multi-GPU)")
    return sequential_apply(stage_fn, stage_params, x)
