"""Where the leaves of a tree of tensors lie on the ``(data, server)``
mesh: the port's counterpart of the JAX package's ``NamedSharding``
placements (``models/transformer.py::shard_lm_params``,
``_shard_tree_over_axis``, ``zero1_shard_opt_state``,
``fsdp_shard_lm_params``).

JAX places a whole array and lets each device hold a block; here each
rank holds only its block, and a :class:`Placed` tree records, for each
leaf, the mesh axis its every dimension is split over, as a
``PartitionSpec`` does (a tuple of axis names or None, one a dimension;
a leaf with no entry is whole on every rank). A leaf's whole shape is its
block's with each split dimension multiplied by its axis's size (every
split is even).

Leaves are addressed by their path in the tree, a tuple of dict keys
(``("l0/wq",)`` in the LM's flat parameters, ``("mu", "l0/wq")`` in
Adam's state). Every function here that gathers is a collective: every
rank of the axes involved calls it, with the same tree, leaves in
sorted-path order.

The helpers every placement needs: :func:`block` (this rank's block of a
whole leaf), :func:`gather` (the whole leaves from the blocks),
:func:`place` (a whole tree cut to its blocks), :func:`reshard` (a block
moved from one placement to another), and the reductions of a split
leaf (:func:`mean_dim`, :func:`mean_all`, :func:`sum_all`), which sum over
the ranks that hold its pieces and count a whole leaf once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from . import mesh as meshlib

Spec = Tuple[Optional[str], ...]
Path = Tuple[str, ...]


class Placed(dict):
    """A dict tree of this rank's blocks (nested dicts of tensors, other
    leaves kept as they are) with ``specs`` (path -> :data:`Spec`, whole
    leaves left out) and the ``mesh`` they lie on."""

    def __init__(self, tree: dict, specs: Optional[Dict[Path, Spec]] = None, mesh=None):
        super().__init__(tree)
        self.specs = {p: tuple(s) for p, s in (specs or {}).items() if any(s)}
        self.mesh = mesh


def like(tree, new: dict):
    """``new`` with ``tree``'s placement when ``tree`` is :class:`Placed`
    (a step's new parameters, a gradient tree), else ``new`` itself."""
    if isinstance(tree, Placed):
        return Placed(new, tree.specs, tree.mesh)
    return new


def spec(tree, path, ndim: int) -> Spec:
    """The spec of the leaf at ``path`` (a key of a flat dict, or a tuple
    path): all None when ``tree`` is not :class:`Placed` or the leaf is
    whole."""
    path = path if isinstance(path, tuple) else (path,)
    specs = getattr(tree, "specs", None) or {}
    return specs.get(path, (None,) * ndim)


def axes_of(s: Spec) -> Tuple[str, ...]:
    return tuple(a for a in s if a is not None)


def leaves(tree: Any, prefix: Path = ()) -> Iterator[Tuple[Path, torch.Tensor]]:
    """``(path, tensor)`` of every tensor leaf, in sorted-path order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def map_tree(tree: Any, fn: Callable[[Path, torch.Tensor], Any], prefix: Path = ()) -> Any:
    """``tree`` (nested dicts, as plain dicts) with ``fn(path, t)`` for
    every tensor leaf; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    return tree


def whole_shape(t: torch.Tensor, s: Spec, mesh) -> Tuple[int, ...]:
    return tuple(n * (mesh.shape[a] if a else 1) for n, a in zip(t.shape, s))


def block(x: torch.Tensor, s: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under ``s``."""
    for dim, a in enumerate(s):
        if a is not None and mesh.shape[a] > 1:
            x = meshlib._block(x, a, mesh, dim)
    return x.contiguous()


def gather_leaf(x: torch.Tensor, s: Spec, mesh, axes=None) -> torch.Tensor:
    """The leaf whole along the dims split over ``axes`` (default: every
    axis of ``s``), gathered over those axes (no gradient)."""
    for dim, a in enumerate(s):
        if a is not None and mesh.shape[a] > 1 and (axes is None or a in axes):
            x = meshlib._gather_dim_raw(x, a, mesh, dim)
    return x


def reshard(x: torch.Tensor, src: Spec, dst: Spec, mesh) -> torch.Tensor:
    """A block under ``src`` as its block under ``dst``: gathered along
    the dims ``src`` splits and ``dst`` does not, cut along those ``dst``
    splits and ``src`` does not. ``x`` itself when the two agree."""
    if tuple(src) == tuple(dst):
        return x
    for dim, (a, b) in enumerate(zip(src, dst)):
        if a is not None and a != b and mesh.shape[a] > 1:
            x = meshlib._gather_dim_raw(x, a, mesh, dim)
    for dim, (a, b) in enumerate(zip(src, dst)):
        if b is not None and a != b and mesh.shape[b] > 1:
            x = meshlib._block(x, b, mesh, dim)
    return x.contiguous()


def place(tree: dict, specs: Dict[Path, Spec], mesh) -> Placed:
    """The whole ``tree`` cut to this rank's blocks under ``specs``."""
    specs = {p: tuple(s) for p, s in specs.items()}
    out = map_tree(tree, lambda p, t: block(t, specs[p], mesh) if p in specs else t)
    return Placed(out, specs, mesh)


def place_like(whole: Any, tree: Any) -> Any:
    """The whole tree ``whole`` (a restored checkpoint) placed as ``tree``
    is (``whole`` itself when ``tree`` is not :class:`Placed`)."""
    if not isinstance(tree, Placed):
        return whole
    return place(whole, tree.specs, tree.mesh)


def gather(tree: Any) -> Any:
    """Every leaf of a :class:`Placed` tree whole, as a plain tree (a
    collective over each leaf's axes, leaves in sorted-path order); any
    other tree as it is."""
    if not isinstance(tree, Placed) or not tree.specs:
        return dict(tree) if isinstance(tree, Placed) else tree
    whole = {p: gather_leaf(t, tree.specs[p], tree.mesh) for p, t in leaves(tree)
             if p in tree.specs}
    return map_tree(tree, lambda p, t: whole.get(p, t))


def gather_axis(tree: Any, axis: str) -> Any:
    """A :class:`Placed` tree with its leaves whole along ``axis`` (the
    other splits kept): FSDP's parameters made whole over ``data`` for
    decoding on one data row. Any other tree as it is."""
    if not isinstance(tree, Placed):
        return tree
    specs = {}
    whole = {}
    for p, t in leaves(tree):
        s = tree.specs.get(p)
        if s is None:
            continue
        whole[p] = gather_leaf(t, s, tree.mesh, (axis,))
        specs[p] = tuple(None if a == axis else a for a in s)
    return Placed(map_tree(tree, lambda p, t: whole.get(p, t)), specs, tree.mesh)


def template(tree: Any) -> Any:
    """A plain tree of uninitialized whole-shaped tensors of each leaf's
    dtype and device: the template a whole checkpoint restores into."""
    if not isinstance(tree, Placed):
        return tree
    return map_tree(tree, lambda p, t: t.new_empty(whole_shape(t, tree.specs[p], tree.mesh))
                    if p in tree.specs else t)


def nbytes(tree: Any) -> int:
    """This rank's bytes of the tensor leaves of ``tree``."""
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))


def shard_tree_over_axis(tree: Any, mesh, axis: str) -> Placed:
    """JAX's ``_shard_tree_over_axis``: every tensor leaf split over
    ``axis`` on its largest whole dimension that is free and divides by the
    axis size (the lowest such index among equal sizes: a stable sort);
    a leaf already split over ``axis`` keeps its placement, one split
    over the other axis gains ``axis`` on another dimension, scalars and
    indivisible leaves stay as they are, and on an axis of size 1 nothing
    moves (a tensor-parallel placement is kept)."""
    n = mesh.shape[axis]
    specs = dict(getattr(tree, "specs", {}) or {})

    def one(path, x):
        s = list(spec(tree, path, x.dim()))
        if x.dim() == 0 or n == 1 or axis in s:
            return x
        shape = whole_shape(x, tuple(s), mesh)
        for d in sorted(range(x.dim()), key=lambda d: -shape[d]):
            if s[d] is None and shape[d] % n == 0:
                s[d] = axis
                specs[path] = tuple(s)
                return meshlib._block(x, axis, mesh, d).contiguous()
        return x

    out = map_tree(tree, one)
    return Placed(out, specs, mesh)


# -- reductions of a split leaf --


def sum_all(xs, specs, mesh) -> list:
    """``x.sum()`` of each of ``xs`` over the whole leaf: each block's sum,
    then one ``psum`` over each axis set that splits some leaf (the sums
    of the leaves that share it in one tensor). A whole leaf's sum is its
    own, counted once."""
    sums = [x.sum() for x in xs]
    groups: Dict[Tuple[str, ...], list] = {}
    for i, s in enumerate(specs):
        axes = tuple(a for a in axes_of(s) if mesh is not None and mesh.shape[a] > 1)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        t = torch.stack([sums[i] for i in idx])
        for a in axes:
            t = meshlib._psum_raw(t, a, mesh)
        for j, i in enumerate(idx):
            sums[i] = t[j]
    return sums


def mean_all(x: torch.Tensor, s: Spec, mesh) -> torch.Tensor:
    """``torch.mean`` of the whole leaf ``x`` is a block of (``torch.mean``
    itself when it is whole)."""
    axes = [a for a in axes_of(s) if mesh is not None and mesh.shape[a] > 1]
    if not axes:
        return torch.mean(x)
    total = x.sum()
    n = x.numel()
    for a in axes:
        total = meshlib._psum_raw(total, a, mesh)
        n *= mesh.shape[a]
    return total / n


def mean_dim(x: torch.Tensor, s: Spec, dim: int, mesh, keepdim: bool = False) -> torch.Tensor:
    """The mean over ``dim`` of the whole leaf ``x`` is a block of: the
    block's own ``mean`` when ``dim`` is whole, else the blocks' sums
    added over the dim's axis over its whole length. The result is split
    as ``s`` without ``dim``."""
    a = s[dim]
    if a is None or mesh is None or mesh.shape[a] == 1:
        return x.mean(dim, keepdim=keepdim)
    total = meshlib._psum_raw(x.sum(dim, keepdim=keepdim), a, mesh)
    return total / (x.shape[dim] * mesh.shape[a])


def drop_dim(s: Spec, dim: int, keepdim: bool = False) -> Spec:
    """The spec of a reduction of a leaf under ``s`` over ``dim``."""
    if keepdim:
        return tuple(None if i == dim else a for i, a in enumerate(s))
    return tuple(a for i, a in enumerate(s) if i != dim)
