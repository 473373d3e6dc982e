"""The key-value data plane: pull, push, push_pull, on one card or a mesh.

Counterpart of ``parameter_server_tpu/ops/kv_ops.py``. Indices are int32
slot ids from the host directory; padding or foreign ids (the sentinel
``num_slots``, or -1 at 2^31 slots) are masked by :func:`localize`.
With no ``mesh`` (or a ``1 x 1`` one) the table is the whole key space
and every collective below is the identity. On a ``(data, server)``
mesh (``parallel/mesh.py``) each rank passes its own server shard of
the table, and the JAX package's ``shard_map`` bodies run one a rank:

- a **pull** gathers the slots this shard owns (``localize`` against the
  shard's range ``[s * shard, (s + 1) * shard)``) and zero elsewhere,
  then ``psum`` over the server axis assembles the rows: each slot has
  one owner, so the sum is an assembly, ``x + 0 + ...``, exact;
- a **push** with ``batch_sharded`` (each data row pushes its own keys)
  first all-gathers the ids and values over the data axis, in data
  order, and with ``average`` divides by the data rows; then every
  server shard adds the entries it owns, in entry order.
  ``batch_sharded=False`` (every rank pushes the same keys, as
  ``KVVector`` does) adds only the rank's own entries.

- **pull** gathers ``table[idx]`` into a fresh tensor (never a view of
  the table, so a pulled value survives later pushes), zero where the
  id is not owned.
- **push** adds ``vals`` at ``idx``. Hashed slots collide, so several
  entries may add into one slot; the JAX package's scatter on the CPU
  adds them in entry order, ``(t + a) + b``. The port keeps that order
  on every device. On the CPU it is ``index_add_``, which adds entry by
  entry in index order. On the card ``index_add_`` adds with atomics in
  an order that changes from run to run, so the card takes the
  deterministic segment sum instead (``ops/segment_sum.py``, the
  ``segment_sum.cu`` kernel): each touched slot's current value is put
  first in its run, ahead of the slot's entries in entry order, so the
  kernel's sum from +0.0 is ``((0 + t) + a) + b``, the same bits. (The
  one case it does not cover: a table holding -0.0 that is pushed only
  -0.0 comes back +0.0 on the card, as the sum starts from +0.0.)
- **push_pull** is a push then a pull of the updated table, in one call.

The JAX package's ``push`` copies the table and ``push_donated`` donates
it (in place). Here ``push`` copies too, and ``push_donated`` writes the
caller's table in place: there is no donated buffer to invalidate, so an
owner that hands out its table must hand out a copy (``KVVector.table(
copy=True)``, ``KVVector.snapshot``) — a live view reads the next push.

Every public entry point is an entry point of the device inventory
(``telemetry/device.py``) under the JAX package's names (``kv_pull``,
``kv_push``, ``kv_push_donated``, ``kv_push_pull``,
``kv_push_pull_donated``), each declaring the least bytes it moves; the
in-place pushes count in ``ps_kvops_donated_pushes_total`` and the fused
push_pull's host dispatch time in ``ps_kvops_fused_dispatch_seconds``.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..device import scalar_like
from ..parallel.mesh import DATA_AXIS, SERVER_AXIS, Mesh, all_gather, axis_index, psum
from ..parallel.partition import BATCH_SPEC, REPLICATED_SPEC
from ..telemetry import device as _device
from ..telemetry.instruments import cached_kvops_instruments as _tel
from .segment_sum import segment_sum


def index_spec(batch_sharded: bool):
    """The slot-index spec: per-worker key sets ride the data axis,
    replicated otherwise (``parallel/partition.py`` owns the specs)."""
    return BATCH_SPEC if batch_sharded else REPLICATED_SPEC


def localize(idx: torch.Tensor, shard: int, mesh: Optional[Mesh] = None):
    """Shard-relative index + ownership mask for this rank's server key
    range, ``lo = axis_index(server) * shard`` (0 with no mesh).

    ``rel = clip(idx - lo, 0, shard - 1)``: a non-owned id (another
    shard's, the sentinel ``num_slots``, or -1 at 2^31 slots) clips onto
    a REAL slot, so every consumer must mask it with ``ok`` before
    writing."""
    if shard > (1 << 31):
        raise ValueError(
            f"shard of {shard} slots exceeds int32 slot ids; "
            "spread the table over more server shards"
        )
    if shard == (1 << 31):
        return torch.clamp(idx, 0, (1 << 31) - 1), idx >= 0
    lo = 0 if mesh is None else axis_index(SERVER_AXIS, mesh) * shard
    if lo:
        idx = idx - lo
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


def _owned_rows(table: torch.Tensor, idx: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    rel, ok = localize(idx, table.shape[0], mesh)
    rows = table.index_select(0, rel)
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype, device=table.device))


def _pull_impl(table: torch.Tensor, idx: torch.Tensor, mesh: Optional[Mesh] = None,
               batch_sharded: bool = True) -> torch.Tensor:
    del batch_sharded  # each rank gathers its own ids either way
    rows = _owned_rows(table, idx, mesh)
    return rows if mesh is None else psum(rows, SERVER_AXIS, mesh)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _pull_cost(table, idx, **_):
    """Least bytes of a pull: the ids read, a row read and a row written each."""
    row = _nbytes(table) // max(1, table.shape[0])
    return {"bytes_accessed": float(_nbytes(idx) + 2 * idx.numel() * row)}


def _push_cost(table, idx, vals, pull_idx=None, copy=False, **_):
    """Least bytes of a push: the ids and values read (and, for a copying
    push, the table read and written once); a push_pull's pulled rows
    read and written too."""
    total = _nbytes(idx) + _nbytes(vals) + (2 * _nbytes(table) if copy else 0)
    if pull_idx is not None:
        total += _pull_cost(table, pull_idx)["bytes_accessed"]
    return {"bytes_accessed": float(total)}


_STATICS = ("mesh", "batch_sharded", "average", "combine_data")
pull = _device.instrument("kv_pull", _pull_impl, static_argnames=_STATICS[:2], cost=_pull_cost)
pull.__doc__ = """Rows ``table[idx]`` as a fresh ``[n, k]`` tensor; zero where an
id is not owned. On a ``mesh``: ``table`` is this rank's server shard,
and the rows are assembled over the server axis."""


def scatter_add_in_order(table: torch.Tensor, rel: torch.Tensor, vals: torch.Tensor) -> None:
    """``table[rel[i]] += vals[i]`` in place, for i in entry order (the
    module's docstring): ``index_add_`` on the CPU, the segment sum on
    the card."""
    if table.device.type == "cpu":
        table.index_add_(0, rel, vals)
    else:
        scatter_add_by_segments(table, rel, vals, segment_sum)


def scatter_sum(num_rows: int, rel: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``zeros([num_rows, k]).at[rel].add(vals)``: each row's entries
    summed in entry order from +0.0. One ``segment_sum`` over the
    flattened ids ``rel * k + col`` (on the CPU ``index_add_``, on the
    card the stable sort and the kernel); a fresh zero table needs none
    of :func:`scatter_add_by_segments`' table rows in front."""
    k = vals.shape[1]
    ids = (rel.long()[:, None] * k + torch.arange(k, device=rel.device)).reshape(-1)
    return segment_sum(vals.reshape(-1), ids, num_rows * k).view(num_rows, k)


def scatter_add_by_segments(table: torch.Tensor, rel: torch.Tensor, vals: torch.Tensor,
                            sum_fn) -> None:
    """The card's route of :func:`scatter_add_in_order`, on any device:
    each touched slot's value and then its entries, in entry order, go
    to ``sum_fn(data, ids, num_segments)`` (``segment_sum``, or a plain
    version of it in tests), whose sums replace the touched rows."""
    if rel.numel() == 0:
        return
    k = table.shape[1]
    uniq, inv = torch.unique(rel.long(), sorted=True, return_inverse=True)
    u = uniq.numel()
    cols = torch.arange(k, device=table.device)
    data = torch.cat([table.index_select(0, uniq).reshape(-1).float(), vals.reshape(-1).float()])
    ids = torch.cat([torch.arange(u * k, device=table.device),
                     (inv[:, None] * k + cols).reshape(-1)])
    sums = sum_fn(data, ids, u * k)
    table.index_copy_(0, uniq, sums.view(u, k).to(table.dtype))


def _push_into(table, idx, vals, mesh: Optional[Mesh] = None, batch_sharded: bool = True,
               average: bool = False, combine_data: bool = True):
    if mesh is not None:
        n_data = mesh.shape[DATA_AXIS]
        if batch_sharded and combine_data and n_data > 1:
            idx = all_gather(idx, DATA_AXIS, mesh)
            vals = all_gather(vals, DATA_AXIS, mesh)
            if average:  # only when contributions were combined
                vals = vals / scalar_like(n_data, vals)
    rel, ok = localize(idx, table.shape[0], mesh)
    vals = torch.where(ok[:, None], vals.to(table.dtype), torch.zeros((), dtype=table.dtype,
                                                                        device=table.device))
    scatter_add_in_order(table, rel, vals)
    return table


def _push_impl(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, **kw) -> torch.Tensor:
    return _push_into(table.clone(), idx, vals, **kw)


push = _device.instrument("kv_push", _push_impl, static_argnames=_STATICS,
                          cost=lambda t, i, v, **kw: _push_cost(t, i, v, copy=True))
push.__doc__ = """A new table: ``table`` with ``vals [n, k]`` added at ``idx``
(the caller's table is left as it was). On a ``mesh`` (``table`` this
rank's server shard): with ``batch_sharded`` and ``combine_data`` the
data rows' entries are all-gathered first (``average`` divides them by
the data rows), and each shard adds the entries it owns."""

_push_donated = _device.instrument("kv_push_donated", _push_into, static_argnames=_STATICS,
                                   cost=lambda t, i, v, **kw: _push_cost(t, i, v))


def push_donated(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 **kw) -> torch.Tensor:
    """:func:`push` in place: adds into the caller's ``table`` and
    returns it. Same bits as ``push``."""
    tel = _tel()
    if tel is not None:
        tel["donated_pushes"].inc()
    return _push_donated(table, idx, vals, **kw)


def _push_pull_impl(table, idx, vals, pull_idx, **kw):
    return _push_pull_donated_impl(table.clone(), idx, vals, pull_idx, **kw)


def _push_pull_donated_impl(table, idx, vals, pull_idx, **kw):
    new = _push_into(table, idx, vals, **kw)
    return new, _pull_impl(new, pull_idx, kw.get("mesh"))


_push_pull = _device.instrument(
    "kv_push_pull", _push_pull_impl, static_argnames=_STATICS,
    cost=lambda t, i, v, p, **kw: _push_cost(t, i, v, pull_idx=p, copy=True))
_push_pull_donated = _device.instrument(
    "kv_push_pull_donated", _push_pull_donated_impl, static_argnames=_STATICS,
    cost=lambda t, i, v, p, **kw: _push_cost(t, i, v, pull_idx=p))


def _dispatch_fused(fn, table, idx, vals, pull_idx, kw):
    if pull_idx is None:
        pull_idx = idx
    tel = _tel()
    if tel is None:
        return fn(table, idx, vals, pull_idx, **kw)
    t0 = time.perf_counter()
    out = fn(table, idx, vals, pull_idx, **kw)
    # host dispatch time, not device completion
    tel["fused_dispatch"].observe(time.perf_counter() - t0)
    return out


def push_pull(table, idx, vals, pull_idx=None, **kw):
    """``(new_table, pulled)`` with ``pulled = pull(push(table, idx,
    vals), pull_idx)``; ``pull_idx`` defaults to ``idx``. Copies the
    table; owners use :func:`push_pull_donated`. ``kw``: the mesh
    arguments of :func:`push`."""
    return _dispatch_fused(_push_pull, table, idx, vals, pull_idx, kw)


def push_pull_donated(table, idx, vals, pull_idx=None, **kw):
    """:func:`push_pull` in place on the caller's ``table``."""
    tel = _tel()
    if tel is not None:
        tel["donated_pushes"].inc()
    return _dispatch_fused(_push_pull_donated, table, idx, vals, pull_idx, kw)


def scatter_grad_dense(idx: torch.Tensor, vals: torch.Tensor, p_total: int,
                       k: int) -> torch.Tensor:
    """Densify a sparse push into a ``[p_total, k]`` gradient table: each
    slot's entries summed in entry order from +0.0; an id outside
    ``[0, p_total)`` (the padding slot ``p_total``) is dropped, as the JAX
    scatter's ``mode="drop"`` drops it."""
    vals = vals.reshape(-1, k)
    keep = (idx >= 0) & (idx < p_total)
    rel = torch.where(keep, idx, p_total)  # a dump row past the table
    return scatter_sum(p_total + 1, rel, vals)[:p_total]
