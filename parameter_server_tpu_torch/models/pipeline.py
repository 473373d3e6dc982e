"""Pipeline parallelism: stage-sharded layers, microbatched fill-drain.

Counterpart of ``parameter_server_tpu/models/pipeline.py``. A deep stack
of identical stages is sharded over an axis of the mesh: rank ``r`` of
the axis group holds the contiguous block of ``k = n_stages / n`` stages
starting at ``r * k``, and ``M`` microbatches stream through the GPipe
fill-drain schedule, ``M + n - 1`` ticks, activations hopping to the
next rank by :func:`..parallel.mesh.shift` after every tick. As in the
JAX schedule every rank runs every tick (the first rank feeds the next
microbatch, the others what they received; a tick outside a rank's
``M`` valid ones computes on what it holds and is discarded), so every
rank builds the same autograd graph and the backward's shifts pair up;
the last rank's outputs are shared with every rank by a
:func:`..parallel.mesh.psum_invariant`. The tables arrive whole
(replicated, as the JAX ``in_specs=P(axis)`` takes them) and each rank
uses its block, so a rank's gradient is nonzero in its block alone and
the data axis's sum of the ranks' gradients is the JAX one. With no mesh
(or an axis of size 1) every tick chains the whole stack: the one-card
program, :func:`sequential_apply`.

``stage_params`` is a tree (dicts, lists, tuples) of tensors with a
leading dim of one slice per stage; ``stage_fn(params_slice, x_mb)``
applies one stage (it must keep the microbatch's shape); ``x`` is
``[M, mb, ...]`` microbatches, the same on every rank.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..parallel import mesh as meshlib


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


def _block(tree: Any, lo: int, hi: int) -> Any:
    """Stages ``lo:hi`` of every leaf."""
    if isinstance(tree, dict):
        return {k: _block(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_block(v, lo, hi) for v in tree)
    return tree[lo:hi]


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor, *, mesh=None,
                   axis: str = "data") -> torch.Tensor:
    """``x`` through the stage stack sharded over ``axis``: this rank runs
    its contiguous block of ``n_stages / n`` stages each tick. The stage
    count must be a multiple of the axis size (``ValueError``, as JAX's
    check). Returns the ``[M, mb, ...]`` outputs on every rank."""
    n, stage = meshlib.axis_extent(mesh, axis)
    n_stages = _leading(stage_params)
    if n_stages == 0 or n_stages % n:
        raise ValueError(f"stage count {n_stages} must be a MULTIPLE of mesh axis {axis}={n} "
                         "(each device holds one contiguous stage block)")
    if n == 1:
        return sequential_apply(stage_fn, stage_params, x)
    k = n_stages // n
    params = _block(stage_params, stage * k, (stage + 1) * k)
    m = x.shape[0]
    is_first = torch.tensor(stage == 0, device=x.device)
    held = torch.zeros_like(x[0])
    out = [torch.zeros_like(x[0]) for _ in range(m)]
    for t in range(m + n - 1):
        # stage 0 ingests microbatch t (while valid); the others take the
        # activation handed over by the previous tick's shift
        y = torch.where(is_first, x[min(t, m - 1)], held)
        for j in range(k):
            y = stage_fn(_stage(params, j), y)
        # the last stage completed microbatch t - (n - 1) this tick
        done = t - (n - 1)
        if done >= 0:
            out[done] = torch.where(torch.tensor(stage == n - 1, device=x.device), y, out[done])
        # hand activations on around the ring (stage s -> s + 1); the
        # wrap-around into stage 0 is ignored (it feeds from x)
        held = meshlib.shift(y, axis, mesh, 1)
    # only the last stage holds real outputs: share them with every rank
    return meshlib.psum_invariant(torch.stack(out), axis, mesh)
