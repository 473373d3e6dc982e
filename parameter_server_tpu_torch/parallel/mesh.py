"""The ``(data, server)`` mesh, one process a mesh position.

Counterpart of ``parameter_server_tpu/parallel/mesh.py``. The JAX
package runs one SPMD program over a ``jax.sharding.Mesh`` whose devices
are the mesh's positions; the port runs one process (rank) a position,
``world = num_data * num_server``, every rank running the same program:

- rank ``r`` sits at ``(d, s) = divmod(r, num_server)``;
- ``server`` axis ≙ the reference's kServerGroup: rank ``(d, s)`` holds
  server shard ``s`` of every table, a contiguous key range
  (``Range<Key>::EvenDivide`` in manager.cc);
- ``data`` axis ≙ kWorkerGroup: rank ``(d, s)`` feeds data row ``d`` of
  every minibatch.

The ranks of one data row form its *server group*, the ranks of one
server column its *data group*. The JAX step's collectives map one for
one onto these groups:

- ``jax.lax.psum(x, SERVER_AXIS)`` → :func:`psum` ``(x, SERVER_AXIS,
  mesh)``, an ``all_reduce`` over the server group;
- ``jax.lax.psum(x, DATA_AXIS)`` → an ``all_reduce`` over the data group;
- ``jax.lax.all_gather(x, DATA_AXIS, tiled=True)`` → :func:`all_gather`,
  the data ranks' tensors concatenated in data order;
- ``jax.lax.axis_index(axis)`` → :func:`axis_index`, the rank's
  coordinate;
- tensor and data parallelism's own (what GSPMD inserts for a placed
  weight): :func:`pvary` (identity forward, ``psum`` backward: Megatron's
  ``f`` before a column-split projection), :func:`all_gather_dim` (along
  any dim, backward :func:`psum_scatter`: an FSDP weight's gather),
  :func:`psum_scatter` (reduce-scatter, under gloo too), and the pair
  :func:`all_gather_invariant` / :func:`split` for a tensor that every rank
  then holds alike;
- ``jax.lax.ppermute`` around the ring → :func:`shift` (:func:`shift_all`
  for several tensors in one exchange), ``jax.lax.all_to_all`` →
  :func:`all_to_all`.

On an axis of size 1 each collective is the identity and runs nothing,
so a ``1 x 1`` mesh (no process group at all) is the one-card program.

**Gradients.** JAX differentiates through its collectives by transposing
them; ``torch.distributed``'s have no gradient. :func:`psum`,
:func:`shift` and :func:`all_to_all` are ``torch.autograd.Function``\\ s
whose backwards are JAX's transposes under ``shard_map(check_vma=False)``:
the cotangents' ``psum``, the shift the other way, the inverse
all-to-all. A result that
every rank then uses alike (a loss, a replicated output) is
:func:`psum_invariant`, whose backward passes each rank's cotangent
through once. Each rank's autograd runs the backward's collectives, so
every rank must build the same graph and run the same backward.

**Backends** (chosen once, in ``distributed.initialize``): NCCL when
every rank has a card of its own, gloo when ranks share a card or run on
the CPU. gloo reduces CUDA tensors itself (``all_reduce``, ``broadcast``)
but gathers and sends only host tensors, so :func:`all_gather` and
:func:`shift` of a CUDA tensor under gloo copy it through pinned host
memory (:func:`_gather_through_host`, :func:`_host_copy`).

**Two sets of groups.** A process group must see its collectives in
the same order on every rank, and one thread that blocks in a
collective of one group while its peer blocks in another's hangs both.
The steps' collectives run on a store's or a worker's executor, one
dispatch thread a rank, in timestamp order; a collective that a
caller's own thread runs beside them (a live migration's gather, a
consistent backup, while a serve stream pulls through the executor)
goes over the mesh's *side* groups instead (:attr:`Mesh.side`: the
same rows and columns, groups of their own), which only those callers
use, each call made by every rank in the same order.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SERVER_AXIS = "server"
AXES = (DATA_AXIS, SERVER_AXIS)


def mesh_shape(n: int, num_data: Optional[int] = None, num_server: int = 1) -> Tuple[int, int]:
    """``(num_data, num_server)`` over ``n`` positions, by the JAX
    package's auto-shape rules: with ``num_data`` None, the server count
    steps down to the largest divisor of ``n`` at or under the request
    and the data axis takes the rest (no position idles); an explicit
    shape may leave positions idle (a prefix is used) and raises
    ``ValueError`` when it needs more than ``n``."""
    log = logging.getLogger(__name__)
    if num_data is None:
        num_server = max(1, min(int(num_server), n))
        if n % num_server != 0:
            adjusted = next(d for d in range(num_server, 0, -1) if n % d == 0)
            log.warning(
                "auto-shape: %d server shards do not divide %d devices; using %d server "
                "shards (largest divisor <= requested) so no chip idles",
                num_server, n, adjusted,
            )
            num_server = adjusted
        num_data = n // num_server
        log.info("auto-shaped mesh %dx%d (data x server) over %d devices, 0 idle",
                 num_data, num_server, n)
    num_data, num_server = int(num_data), int(num_server)
    need = num_data * num_server
    if need > n:
        raise ValueError(f"mesh {num_data}x{num_server} needs {need} > {n} devices")
    if need < n:
        log.warning("mesh %dx%d leaves %d of %d devices idle", num_data, num_server, n - need, n)
    return num_data, num_server


class Mesh:
    """This rank's view of a ``(data, server)`` mesh: the shape, its
    coordinates (None on a rank the mesh leaves idle), its device, and
    the process groups of its data column and server row (None on an
    axis of size 1, or with no world)."""

    def __init__(self, num_data: int, num_server: int, device: torch.device,
                 rank: int = 0, groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None,
                 side_groups: Optional[Dict[str, object]] = None):
        self.shape = {DATA_AXIS: int(num_data), SERVER_AXIS: int(num_server)}
        self.size = self.shape[DATA_AXIS] * self.shape[SERVER_AXIS]
        self.rank = int(rank)
        self.coords = divmod(self.rank, num_server) if self.rank < self.size else None
        self.device = torch.device(device)
        self.groups = dict(groups or {})
        self.backend = backend
        self._side_groups = dict(side_groups or {})

    @property
    def side(self) -> "Mesh":
        """This mesh with its side groups: the same positions, groups that
        the executors' steps never use (the module's docstring)."""
        return Mesh(self.shape[DATA_AXIS], self.shape[SERVER_AXIS], self.device, self.rank,
                    self._side_groups, self.backend)

    def global_rank(self, data: int, server: int) -> int:
        """The world rank at mesh position ``(data, server)``."""
        return data * self.shape[SERVER_AXIS] + server

    @property
    def active(self) -> bool:
        """Whether this rank holds a position of the mesh."""
        return self.coords is not None

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def server_index(self) -> int:
        return self.coords[1]

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[DATA_AXIS]}x{self.shape[SERVER_AXIS]}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device}, backend={self.backend})")


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(num_data: Optional[int] = None, num_server: int = 1,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """Build this rank's ``(data, server)`` mesh over the world's ranks.

    ``devices``: one device a rank of the world (default: the world's
    size, this rank on ``device``, else the one ``distributed`` chose).
    The shape follows :func:`mesh_shape`. Every rank of the world must
    call this, in the same order, with the same shape: the process groups
    are made collectively (``new_subgroups_by_enumeration``), one a data
    row and one a server column, in rank order; a rank past the shape's
    prefix gets an idle mesh."""
    world, rank = _world()
    n = len(devices) if devices is not None else world
    d, s = mesh_shape(n, num_data, num_server)
    if d * s > world:
        raise RuntimeError(
            f"mesh {d}x{s} needs a world of {d * s} ranks; this process is in a world of "
            f"{world} (join one with parallel.distributed.initialize or parallel.launch)")
    if device is None:
        if devices is not None:
            device = devices[rank]
        else:
            from . import distributed

            device = distributed.rank_device()
    groups: Dict[str, object] = {}
    side: Dict[str, object] = {}
    backend = None
    if world > 1:
        backend = dist.get_backend()
        rows = [[i * s + j for j in range(s)] for i in range(d)]
        cols = [[i * s + j for i in range(d)] for j in range(s)]
        if s > 1:
            groups[SERVER_AXIS], _ = dist.new_subgroups_by_enumeration(rows)
            side[SERVER_AXIS], _ = dist.new_subgroups_by_enumeration(rows)
        if d > 1:
            groups[DATA_AXIS], _ = dist.new_subgroups_by_enumeration(cols)
    return Mesh(d, s, torch.device(device), rank=rank, groups=groups, backend=backend,
                side_groups=side)


# -- the collectives of the JAX step --


def axis_index(axis: str, mesh: Mesh) -> int:
    """``jax.lax.axis_index(axis)``: this rank's coordinate on ``axis``."""
    return mesh.coords[AXES.index(axis)]


def axis_extent(mesh: Optional[Mesh], axis: str) -> Tuple[int, int]:
    """``(size, this rank's coordinate)`` on ``axis``; ``(1, 0)`` with no
    mesh or an axis of size 1 (the one-card program)."""
    if mesh is None or mesh.shape[axis] == 1:
        return 1, 0
    return mesh.shape[axis], axis_index(axis, mesh)


def _psum_raw(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.group(axis))
    return out


class _PSum(torch.autograd.Function):
    """``psum`` under autograd: its backward is the cotangent's ``psum``,
    what JAX transposes ``psum`` to inside ``shard_map(check_vma=False)``
    when the result stays sharded (each rank's cotangent its own)."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return _psum_raw(x, axis, mesh)

    @staticmethod
    def backward(ctx, ct):
        return _psum_raw(ct, *ctx.args), None, None


class _PSumInvariant(torch.autograd.Function):
    """A ``psum`` whose result every rank then uses alike (JAX's
    ``out_specs=P()``): its backward passes each rank's cotangent through,
    as JAX divides the replicated cotangent by the axis size before the
    transposed ``psum`` (the same on every rank, so it adds up to one
    cotangent, never to ``n`` of them)."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        return _psum_raw(x, axis, mesh)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


def psum(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.psum(x, axis)``: the elementwise sum of ``x`` over the
    ranks of this rank's ``axis`` group, a new tensor (``x`` is left as it
    was). Every rank of the group gets the same bits. The identity on an
    axis of size 1. Differentiable: the gradient is the cotangents'
    ``psum`` (:class:`_PSum`)."""
    if mesh.shape[axis] == 1:
        return x
    return _PSum.apply(x, axis, mesh)


def psum_invariant(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """:func:`psum` of a result that every rank of the group then uses
    alike (a loss, a replicated output): its gradient is each rank's own
    cotangent (:class:`_PSumInvariant`), so that a loss every rank
    differentiates counts once."""
    if mesh.shape[axis] == 1:
        return x
    return _PSumInvariant.apply(x, axis, mesh)


def psum_tree(tree: Dict[str, torch.Tensor], axis: str, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The :func:`psum` of every tensor of a flat dict, in one
    ``all_reduce`` a dtype (the tensors flattened into one buffer): how a
    step sums its gradients over the data axis. New tensors; ``tree``
    itself on an axis of size 1."""
    if mesh.shape[axis] == 1:
        return tree
    out: Dict[str, torch.Tensor] = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for k, v in tree.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([tree[k].detach().reshape(-1) for k in keys])
        dist.all_reduce(flat, group=mesh.group(axis))
        for k, part in zip(keys, flat.split([tree[k].numel() for k in keys])):
            out[k] = part.view(tree[k].shape)
    return out


def all_gather(x: torch.Tensor, axis: str, mesh: Mesh, tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, tiled=tiled)``: the group's tensors
    in coordinate order, concatenated along dim 0 (``tiled``) or stacked
    on a new leading dim. A CUDA tensor under gloo goes through
    :func:`_gather_through_host`."""
    if mesh.shape[axis] == 1:
        return x if tiled else x[None]
    x = x.contiguous()
    if mesh.backend == "gloo" and x.is_cuda:
        parts = _gather_through_host(x, mesh.group(axis), mesh.shape[axis])
    else:
        parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts) if tiled else torch.stack(parts)


def _block(x: torch.Tensor, axis: str, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``: the ``axis`` coordinate's
    one of ``mesh.shape[axis]`` equal parts."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks of "
                         f"{axis!r}")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(axis, mesh) * size, size)


def _gather_dim_raw(x: torch.Tensor, axis: str, mesh: Mesh, dim: int) -> torch.Tensor:
    return all_gather(x.movedim(dim, 0).contiguous(), axis, mesh).movedim(0, dim)


def _psum_scatter_raw(x: torch.Tensor, axis: str, mesh: Mesh, dim: int) -> torch.Tensor:
    """The sum over the group, this rank's block of it along ``dim``. NCCL
    reduce-scatters; gloo has no reduce-scatter, so it all-reduces the
    whole and keeps the block (every rank's block summed in the same order
    as the rest)."""
    if mesh.backend == "nccl":
        moved = x.movedim(dim, 0).contiguous()
        out = moved.new_empty((moved.shape[0] // mesh.shape[axis],) + moved.shape[1:])
        dist.reduce_scatter_tensor(out, moved, group=mesh.group(axis))
        return out.movedim(0, dim)
    return _block(_psum_raw(x, axis, mesh), axis, mesh, dim).contiguous()


class _PVary(torch.autograd.Function):
    """Identity forward, the cotangents' ``psum`` backward (Megatron's
    ``f``; ``jax.lax.pvary``, whose transpose is the ``psum``)."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _psum_raw(ct, *ctx.args), None, None


def pvary(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``axis``: how a tensor that
    every rank of the group holds alike enters a computation that each
    rank does on its own slice of a weight (a column-split projection), so
    that the partial input gradients add up. The identity on an axis of
    size 1."""
    if mesh.shape[axis] == 1:
        return x
    return _PVary.apply(x, axis, mesh)


class _GatherDim(torch.autograd.Function):
    """``all_gather`` along ``dim`` whose backward is the cotangent's
    reduce-scatter along it (JAX's transpose of a tiled ``all_gather``)."""

    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _gather_dim_raw(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, ct):
        return _psum_scatter_raw(ct, *ctx.args), None, None, None


class _PSumScatter(torch.autograd.Function):
    """``psum_scatter`` along ``dim`` whose backward gathers the
    cotangents along it."""

    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _psum_scatter_raw(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, ct):
        return _gather_dim_raw(ct, *ctx.args), None, None, None


class _GatherInvariant(torch.autograd.Function):
    """``all_gather`` along ``dim`` of a result that every rank then uses
    alike: its backward keeps this rank's block of the cotangent (which
    every rank holds alike), so that it counts once."""

    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _gather_dim_raw(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, ct):
        return _block(ct, *ctx.args).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor every rank holds alike;
    the backward gathers the blocks' cotangents, the whole one on every
    rank (Megatron's split: the transpose of :class:`_GatherInvariant`)."""

    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _block(x, axis, mesh, dim).contiguous()

    @staticmethod
    def backward(ctx, ct):
        return _gather_dim_raw(ct, *ctx.args), None, None, None


def all_gather_dim(x: torch.Tensor, axis: str, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the group's
    blocks concatenated along ``dim`` in coordinate order, differentiable:
    the gradient is the cotangents' :func:`psum_scatter` along ``dim``
    (each rank's block of the sum), as when each rank uses the gathered
    tensor on data of its own (an FSDP weight). A CUDA tensor under gloo
    goes through pinned host memory. ``x`` itself on an axis of size 1."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherDim.apply(x, axis, mesh, dim % x.dim())


def psum_scatter(x: torch.Tensor, axis: str, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
    tiled=True)``: the sum of ``x`` over the group, this rank's block of
    it along ``dim``. One ``reduce_scatter_tensor`` under NCCL; under gloo,
    which has none, an ``all_reduce`` and the block. Differentiable: the
    gradient gathers the cotangents along ``dim``."""
    if mesh.shape[axis] == 1:
        return x
    return _PSumScatter.apply(x, axis, mesh, dim % x.dim())


def all_gather_invariant(x: torch.Tensor, axis: str, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather_dim` of a result every rank of the group then uses
    alike (a projection's heads gathered to run attention whole on every
    rank): the gradient is this rank's block of the cotangent, not the
    sum of the ranks' alike cotangents."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherInvariant.apply(x, axis, mesh, dim % x.dim())


def split(x: torch.Tensor, axis: str, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor every rank of the group
    holds alike; the gradient gathers the blocks' cotangents, so that
    every rank gets the whole. ``x`` itself on an axis of size 1."""
    if mesh.shape[axis] == 1:
        return x
    return _Split.apply(x, axis, mesh, dim % x.dim())


def _gather_through_host(x: torch.Tensor, group, n: int):
    """gloo gathers host tensors only: copy ``x`` into pinned host memory,
    gather there, and copy the parts back to ``x``'s card."""
    host = _host_copy(x)
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return [p.to(x.device, non_blocking=True) for p in parts]


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return host.copy_(x)


def _peer(axis: str, mesh: Mesh, j: int) -> int:
    """The world rank of coordinate ``j`` (cyclic) on ``axis`` in this
    rank's group."""
    d, s = mesh.coords
    j %= mesh.shape[axis]
    return mesh.global_rank(j, s) if axis == DATA_AXIS else mesh.global_rank(d, j)


def _shift_raw(xs, axis: str, mesh: Mesh, offset: int):
    """Each of ``xs`` shifted by ``offset`` coordinates on ``axis``, all in
    one ``batch_isend_irecv`` (one send and one receive a tensor, tagged by
    its place in ``xs``)."""
    n = mesh.shape[axis]
    if offset % n == 0:
        return [x.clone() for x in xs]
    i = axis_index(axis, mesh)
    group = mesh.group(axis)
    ops, outs, staged = [], [], []
    for tag, x in enumerate(xs):
        host = mesh.backend == "gloo" and x.is_cuda
        src = _host_copy(x.contiguous()) if host else x.contiguous()
        out = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, _peer(axis, mesh, i + offset), group, tag),
                dist.P2POp(dist.irecv, out, _peer(axis, mesh, i - offset), group, tag)]
        outs.append(out)
        staged.append(host)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(x.device, non_blocking=True) if host else o
            for o, x, host in zip(outs, xs, staged)]


class _Shift(torch.autograd.Function):
    """:func:`shift_all` under autograd: the backward shifts the
    cotangents the other way (JAX's transpose of a ``ppermute``)."""

    @staticmethod
    def forward(ctx, axis, mesh, offset, *xs):
        ctx.args = (axis, mesh, offset)
        return tuple(_shift_raw(xs, axis, mesh, offset))

    @staticmethod
    def backward(ctx, *cts):
        axis, mesh, offset = ctx.args
        return (None, None, None, *_shift_raw(cts, axis, mesh, -offset))


def shift_all(xs, axis: str, mesh: Mesh, offset: int = 1) -> tuple:
    """:func:`shift` of several tensors in one exchange (ring attention's
    K/V chunk pair). Differentiable (:class:`_Shift`): every rank of the
    group must make the same calls, forward and backward alike."""
    return _Shift.apply(axis, mesh, offset, *xs)


def shift(x: torch.Tensor, axis: str, mesh: Mesh, offset: int = 1) -> torch.Tensor:
    """``jnp.roll`` of a sharded array by ``offset`` shards along ``axis``
    (a ``ppermute`` over the ring): this rank gets the tensor of the rank
    ``offset`` coordinates before it on the axis (cyclically), and sends
    its own ``offset`` after. One send and one receive a rank; a CUDA
    tensor under gloo goes through pinned host memory. A new tensor; on
    an axis of size 1 (or a whole turn) a copy of ``x``. Differentiable:
    the gradient comes back the other way."""
    return shift_all((x,), axis, mesh, offset)[0]


def _all_to_all_raw(x: torch.Tensor, axis: str, mesh: Mesh, split_axis: int,
                    concat_axis: int, tiled: bool) -> torch.Tensor:
    n = mesh.shape[axis]
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not split "
                             f"over {n} ranks of {axis!r}")
        parts = x.chunk(n, split_axis)
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all(tiled=False): dim {split_axis} of {tuple(x.shape)} must "
                             f"be the axis size {n}")
        parts = x.unbind(split_axis)
    send = torch.stack(parts).contiguous()
    if n > 1:
        host = mesh.backend == "gloo" and x.is_cuda
        src = _host_copy(send) if host else send
        recv = torch.empty_like(src)
        dist.all_to_all_single(recv, src, group=mesh.group(axis))
        send = recv.to(x.device, non_blocking=True) if host else recv
    parts = send.unbind(0)
    return torch.cat(parts, concat_axis) if tiled else torch.stack(parts, concat_axis)


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` under autograd: the backward is the inverse
    all-to-all (the split and concat axes swapped), JAX's transpose."""

    @staticmethod
    def forward(ctx, x, axis, mesh, split_axis, concat_axis, tiled):
        ctx.args = (axis, mesh, concat_axis, split_axis, tiled)
        return _all_to_all_raw(x, axis, mesh, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, ct):
        return _all_to_all_raw(ct, *ctx.args), None, None, None, None, None


def all_to_all(x: torch.Tensor, axis: str, mesh: Mesh, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled)``:
    ``x`` cut into the group's size of chunks along ``split_axis`` (with
    ``tiled=False`` that dim is the group's size, and goes), chunk ``j``
    sent to coordinate ``j``, the chunks received concatenated along
    ``concat_axis`` in coordinate order (``tiled=False``: stacked there on
    a new dim). One ``all_to_all_single``; a CUDA tensor under gloo goes
    through pinned host memory. Differentiable (:class:`_AllToAll`)."""
    return _AllToAll.apply(x, axis, mesh, split_axis % x.dim(), concat_axis % x.dim(), tiled)


def agree_max(values, axis: str, mesh: Mesh):
    """The largest of ``values`` (an int, or a sequence of ints taken
    elementwise) over this rank's ``axis`` group, in one ``all_reduce``:
    the ranks' agreement on a count or a flag. ``values`` itself on an
    axis of size 1."""
    one = isinstance(values, (int, np.integer))
    vals = [int(values)] if one else [int(v) for v in values]
    if mesh.shape[axis] > 1:
        t = torch.tensor(vals, dtype=torch.int64, device=mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group(axis))
        vals = [int(v) for v in t.tolist()]
    return vals[0] if one else vals


def num_servers(mesh: Mesh) -> int:
    return mesh.shape[SERVER_AXIS]


def num_workers(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


def table_sharding(mesh: Mesh):
    """Parameter tables: rows by server key range, replicated over data
    (the spec owned by ``partition.py``)."""
    from . import partition

    return partition.for_mesh(mesh).table_sharding()


def batch_sharding(mesh: Mesh):
    """Example batches: rows over the data axis, replicated over server."""
    from . import partition

    return partition.for_mesh(mesh).batch_sharding()


def replicated(mesh: Mesh):
    from . import partition

    return partition.for_mesh(mesh).replicated()


def init_sharded(init_fn, mesh: Mesh, num_rows: int, axis: str = SERVER_AXIS):
    """This rank's shard of a row-sharded pytree, made on its own device
    and never whole first: ``init_fn(rows, device)`` builds the leaves of
    ``rows = num_rows // mesh.shape[axis]`` rows (the JAX package writes
    its init straight into the sharded buffers; here each rank builds
    only its own). The init must not depend on the row's position, as
    no updater's does (they start from zeros)."""
    n = mesh.shape[axis]
    if num_rows % n:
        raise ValueError(f"{num_rows} rows do not split over {n} shards of {axis!r}")
    return init_fn(num_rows // n, mesh.device)
