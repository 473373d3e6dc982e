"""Multi-process rendezvous and the control-plane store.

Counterpart of ``parameter_server_tpu/parallel/distributed.py``. The
reference joins its nodes through a scheduler (``Van::Connect``,
bootstrapped by ``script/local.sh``); the JAX package through
``jax.distributed``; the port through ``torch.distributed`` on a store:

- :func:`initialize` joins the world named by ``PS_COORDINATOR_ADDRESS``
  (``host:port`` of rank 0's ``TCPStore``, or ``file:///path`` of a
  ``FileStore`` on a shared disk), ``PS_NUM_PROCESSES`` and
  ``PS_PROCESS_ID``, with the backend chosen by :func:`choose_backend`
  and logged: NCCL when every rank has a card of its own, else gloo.
- :func:`post_bytes` / :func:`fetch_bytes` carry control-plane frames
  over the same store, as the JAX package uses the coordination
  service's key-value store; tensors go over the collectives, never
  here.
- :func:`local_data_shards` / :func:`global_from_local`: the data rows
  a process feeds, and the global batch assembled from them.

**Who feeds which rows.** In the JAX package one process owns whole data
rows of the mesh, and it raises when a row's devices span processes:
two processes feeding one row could feed it different batches, and
nothing would notice. In the port every process is one mesh position,
so a data row always spans its ``num_server`` ranks. They agree by
construction: every rank runs the same program on the same stream (the
same conf, the same scheduler order, the same reader, the same prep),
and keeps row ``d`` of each global minibatch. The check's intent stays:
:func:`assert_row_agrees` compares a digest of the rows over the server
group, and of the parts prepped alike for every row (the sparse update's
global unique slots, whose gradients the data psum adds slot by slot)
over the data group; the linear worker runs it on its first batch, and
on every batch whose host decisions changed (:func:`agree_on` holds
those decisions alike on every rank at every launch).

**Devices.** A rank runs on the card unless the launcher names another
device type (``PS_DEVICE``); with no card it raises, as every entry
point of the port does, and never falls back to the CPU on its own.
"""

from __future__ import annotations

import datetime
import hashlib
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve
from . import mesh as meshlib

_LOG = logging.getLogger(__name__)
_store = None  # the rendezvous store, reused for control-plane frames
_device: Optional[torch.device] = None  # this rank's device, as initialize chose it
TIMEOUT_S = 300.0  # a collective waits this long for its peers, then raises


def rank_device(rank: Optional[int] = None, device_type: Optional[str] = None) -> torch.device:
    """The device a rank runs on: the one :func:`initialize` chose, else
    one of ``device_type`` (default ``cuda``), a card
    ``cuda:(rank mod device_count)``. Raises when it names the card and
    there is none."""
    if rank is None and _device is not None and device_type is None:
        return _device
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if (device_type or "cuda") == "cuda":
        resolve(None)  # raises without a card
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def choose_backend(world: int, device: torch.device) -> str:
    """NCCL when the ranks run on cards and every rank has one of its own
    (NCCL refuses two ranks on one card), gloo otherwise."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _make_store(addr: str, n: int, pid: int):
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if addr.startswith("file://"):
        return dist.FileStore(addr[len("file://"):], n)
    host, _, port = addr.rpartition(":")
    return dist.TCPStore(host or "localhost", int(port), n, is_master=pid == 0, timeout=timeout)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the world. Returns True in a world of several processes,
    False for a plain single process (no address, or one process).

    Arguments default from the environment a launcher sets
    (``PS_COORDINATOR_ADDRESS``, ``PS_NUM_PROCESSES``,
    ``PS_PROCESS_ID``); the rank runs on :func:`rank_device` (``PS_DEVICE``
    naming the device type, else the card when there is one) over
    :func:`choose_backend`'s backend, which it logs."""
    global _store, _device
    addr = coordinator_address or os.environ.get("PS_COORDINATOR_ADDRESS")
    if not addr:
        return False
    if dist.is_initialized():
        return True
    n = int(num_processes or os.environ.get("PS_NUM_PROCESSES", "1"))
    pid = int(process_id if process_id is not None else os.environ.get("PS_PROCESS_ID", "0"))
    if n <= 1:
        return False
    device = rank_device(pid, os.environ.get("PS_DEVICE") or None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = choose_backend(n, device)
    _store = _make_store(addr, n, pid)
    dist.init_process_group(backend, store=_store, rank=pid, world_size=n,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _device = device
    _LOG.info("rank %d of %d joined over %s on %s", pid, n, backend, device)
    return True


def shutdown() -> None:
    """Leave the world (every rank calls it once its work is done)."""
    global _store, _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _store, _device = None, None


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


# -- control-plane byte transport (ref van.cc ZMQ send/recv) --


def _kv_store():
    if _store is None:
        raise RuntimeError(
            "no rendezvous store: control-plane messaging needs a multi-process world "
            "(PS_COORDINATOR_ADDRESS et al.)")
    return _store


def post_bytes(tag: str, blob: bytes) -> None:
    """Publish one control-plane frame under a unique tag (include the
    sender and a sequence number, e.g. ``"w0/3"``)."""
    _kv_store().set(f"psmsg/{tag}", blob)


def fetch_bytes(tag: str, timeout_ms: int = 120_000) -> bytes:
    """Block until the frame tagged ``tag`` is published, and return it."""
    store = _kv_store()
    key = f"psmsg/{tag}"
    store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
    return store.get(key)


# -- data rows --


def local_data_shards(mesh: "meshlib.Mesh") -> int:
    """The data rows this process feeds: one for a rank of the mesh (its
    row ``d``), and a rank the mesh leaves idle raises, as in the JAX
    package a process that owns no row does."""
    if not mesh.active:
        raise ValueError(
            f"process {mesh.rank} owns no data-axis rows of mesh {mesh.shape} (its position "
            "was left idle by the mesh layout); grow num_data or shrink the job")
    return 1


def local_from_global(mesh: "meshlib.Mesh", tree, axis_dim: int = 0):
    """This rank's data row of a host batch prepped for every row:
    each array leaf's dim ``axis_dim`` (0 for ``[D, ...]`` batches, 1 for
    ``[T, D, ...]`` superbatches) cut to ``[d:d + 1]``."""
    d = mesh.data_index
    cut = (slice(None),) * axis_dim + (slice(d, d + 1),)
    return _map_arrays(lambda a: a[cut], tree)


def global_from_local(mesh: "meshlib.Mesh", tree, axis_name: str = None, axis_dim: int = 0):
    """The global batch the JAX step sees, assembled from every data
    row's local leaves: each tensor leaf all-gathered over the data axis
    along ``axis_dim`` (a collective: every rank of the mesh calls it).
    The step itself never needs the global batch."""
    axis = axis_name or meshlib.DATA_AXIS

    def gather(t):
        t = torch.as_tensor(t).to(mesh.device)
        moved = t.movedim(axis_dim, 0).contiguous()
        return meshlib.all_gather(moved, axis, mesh).movedim(0, axis_dim)

    return _map_arrays(gather, tree)


def _map_arrays(fn, tree):
    import dataclasses

    if tree is None:
        return None
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_arrays(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def batch_digest(tree) -> int:
    """A 63-bit digest of a batch's arrays or tensors (their bytes, in
    field order; a tensor is read on the host)."""
    h = hashlib.blake2b(digest_size=8)

    def feed(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(a).tobytes())
        return a

    _map_arrays(feed, tree)
    return int.from_bytes(h.digest(), "little") >> 1


def _digests(mesh: "meshlib.Mesh", tree, axis: str) -> list:
    mine = torch.tensor([batch_digest(tree)], dtype=torch.int64, device=mesh.device)
    return meshlib.all_gather(mine, axis, mesh).cpu().tolist()


def digest_ints(*parts) -> int:
    """A 63-bit digest of a few values (their ``repr``s, in order): a
    signature that :func:`agree_on` can compare over the mesh."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def agree_on(mesh: "meshlib.Mesh", values, names, flag: bool = False,
             axes=(meshlib.SERVER_AXIS, meshlib.DATA_AXIS)) -> bool:
    """Raise unless every rank of the mesh (of this rank's groups of
    ``axes``) holds the same ``values`` (ints of 63 bits, one a name of
    ``names``), and return whether any rank raised ``flag``: one
    ``all_reduce`` (MAX) over this rank's server group, then one over its
    data group, of the values, their negations and the flag. Every rank
    ends with the same maxima and minima, so a disagreement raises on
    every rank at the same call and no rank is left waiting in a later
    collective. A collective of each axis of more than one rank: every
    rank calls it at the same point of the same thread's order of
    collectives."""
    vals = [int(v) for v in values]
    packed = vals + [-v for v in vals] + [int(bool(flag))]
    for axis in axes:
        packed = meshlib.agree_max(packed, axis, mesh)
    n = len(vals)
    hi, lo = packed[:n], [-v for v in packed[n:2 * n]]
    if hi != lo:
        apart = [name for name, a, b in zip(names, hi, lo) if a != b]
        raise ValueError(
            f"the ranks of mesh {mesh.shape} disagree on {', '.join(apart)} (rank "
            f"{mesh.rank} holds {dict(zip(names, vals))}): every rank must make the same "
            "decisions from the same stream")
    return bool(packed[-1])


def assert_row_agrees(mesh: "meshlib.Mesh", tree, shared=None) -> None:
    """Raise unless every rank of this rank's data row (its server group)
    holds the same batch ``tree`` and, with ``shared``, every rank of its
    server column (its data group) the same ``shared``: the parts of a
    batch prepped alike for every data row. A collective over each group
    of more than one rank."""
    if mesh.shape[meshlib.SERVER_AXIS] > 1:
        seen = _digests(mesh, tree, meshlib.SERVER_AXIS)
        if len(set(seen)) != 1:
            raise ValueError(
                f"the ranks of data row {mesh.data_index} fed different batches (digests "
                f"{seen}): every rank must run the same conf over the same data stream")
    if shared is not None and mesh.shape[meshlib.DATA_AXIS] > 1:
        seen = _digests(mesh, shared, meshlib.DATA_AXIS)
        if len(set(seen)) != 1:
            raise ValueError(
                f"the data rows of server column {mesh.server_index} prepped different shared "
                f"parts of one batch (digests {seen}): every rank must read the same data "
                "stream in the same order")
