"""One order of store calls for threads that come and go, decided by rank 0.

A serving frontend's request workers, its coalescer's flusher, its
replica's refresher and a trainer streaming pushes all call one store
whenever their work comes, so the order of those calls differs from rank
to rank. On a mesh it must not (``parallel/turns.py``): a pull or a
whole-table snapshot is a collective of the data row, paired by position
with the same call on the row's other ranks, and a push must reach every
replica of the shard in the same order. :mod:`turns` fixes the order of
fixed member threads; here the threads are not fixed, so one rank decides:

- **rank 0 sequences.** Its threads call an :class:`Order` in place of
  the store (the store's protocol: ``pull``, ``push``, ``snapshot`` and
  ``values``; every other attribute is rank 0's store's own).
  Each call takes the order's lock, is numbered, runs on rank 0's store
  (where it only submits to the store's executor), and is then published
  to every other rank over a gloo group of the whole world that the
  order owns (no other thread of any rank uses it). A call that raises
  on rank 0 before it is submitted (a failing store, a fault) is never
  published, so no other rank enters a collective rank 0 abandoned.
- **every other rank follows.** :meth:`Order.follow` receives the calls
  in their numbers' order and makes each on its own store (a rank the
  mesh leaves idle holds none and only counts them), so every rank's
  executor sees the same submissions in the same order.
- **the order is checked, not trusted.** Each call runs inside
  :func:`turns.sequenced`, so the store folds the call's number into the
  order digest that a pull agrees over the server axis before its
  collective (``turns.check_order``); at :meth:`Order.close` the whole
  world agrees the count and the digest of the calls. A rank that
  disagrees raises on every rank at the same call instead of pairing the
  wrong collectives.
- **world-wide steps.** :meth:`Order.sync` holds rank 0 until every rank
  has finished the calls before it (a frontend's ``quiesce``), and
  :meth:`Order.call` runs a handler that every rank registered
  (:meth:`Order.handle`) at its place in the order, after every call
  before it has finished on each rank: an elastic resize, whose state
  gather is a collective of the world. A handler may :meth:`rebind` the
  order to the store it serves next.

Every rank of the world builds its :class:`Order` at the same point of
its program (the group is made collectively); rank 0 closes it and every
other rank's :meth:`follow` returns then.
"""

from __future__ import annotations

import datetime
import threading
from collections import deque
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from . import distributed, turns

#: how long a follower waits for rank 0's next call, and every rank for
#: the others at a sync: rank 0 may serve from its replica for long
#: stretches without a store call (the world's own time limit bounds a
#: rank that died)
IDLE_S = 6 * 3600.0
#: submitted calls a follower leaves in flight before it waits for the oldest
IN_FLIGHT = 16


class OrderError(RuntimeError):
    """The ranks of a world disagree on a sequenced order."""


def _world() -> "tuple[int, int]":
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def needed(store) -> bool:
    """Whether calls to ``store`` from threads that come and go need an
    :class:`Order`: in a world of several ranks, a store on a mesh (or
    None, on a rank the mesh leaves idle)."""
    if isinstance(store, Order) or _world()[0] == 1:
        return False
    return store is None or getattr(store, "mesh", None) is not None


def require(store, who: str) -> None:
    """Raise unless ``store`` may be called by ``who``'s own thread: a
    store on a mesh is called through an :class:`Order`."""
    if needed(store):
        raise ValueError(
            f"{who} over a store on a mesh must call it through a parallel.sequence.Order "
            "built on every rank (rank 0 passes the order, the others follow it): its "
            "threads' calls would otherwise reach the ranks in different orders")


class Order:
    """Rank 0's order of the calls to ``store`` (the module's docstring).

    Built on every rank of the world at the same point. On rank 0 it
    stands in for the store; every other rank calls :meth:`follow`."""

    def __init__(self, store, name: str = "serve"):
        world, rank = _world()
        self.name = name
        self.world = world
        self.rank = rank
        self.leader = rank == 0
        self.store = store
        self.group = (dist.new_group(list(range(world)), backend="gloo",
                                     timeout=datetime.timedelta(seconds=IDLE_S))
                      if world > 1 else None)
        self._handlers: Dict[str, Callable] = {}
        self._lock = threading.Lock()
        self.calls = 0  # guarded-by: _lock (leader); the follower's loop
        self.digest = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._in_flight: deque = deque()  # the follower's submitted, unwaited calls

    def __getattr__(self, attr: str):
        store = self.__dict__.get("store")
        if store is None or attr.startswith("__"):
            raise AttributeError(attr)
        return getattr(store, attr)

    @property
    def active(self) -> bool:
        """Whether calls still go through this order (not closed)."""
        with self._lock:
            return not self._closed

    # -- registration (every rank) --

    def handle(self, op: str, fn: Callable) -> None:
        """Register ``fn(**kw)`` as the handler of :meth:`call` ``op``
        (every rank, before rank 0 calls it)."""
        self._handlers[op] = fn

    def rebind(self, store) -> None:
        """Serve ``store`` from here on (a handler's new store)."""
        self.store = store

    # -- rank 0: the calls --

    def _check_leader(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(
                f"rank {self.rank} follows order {self.name!r}: {what} is called on rank 0")

    def _publish(self, msg) -> None:
        if self.group is not None:
            dist.broadcast_object_list([msg], src=0, group=self.group)

    def _count(self, number: int, op: str) -> None:
        self.calls = number
        self.digest = distributed.digest_ints(self.digest, number, op)

    def _sequence(self, op: str, args: tuple, local: Callable):
        """Number the call, make it on this rank, then publish it: a call
        that raises here is never published."""
        self._check_leader(op)
        with self._lock:
            if self._closed:
                raise RuntimeError(f"order {self.name!r} is closed")
            number = self.calls + 1
            with turns.sequenced(number):
                out = local()
            self._count(number, op)
            self._publish((number, op, args))
        return out

    def pull(self, task, keys=None, slots=None, callback=None) -> int:
        if slots is not None:
            raise ValueError("a sequenced pull names its keys (slots are this rank's)")
        ch = task.key_channel
        keys = None if keys is None else np.asarray(keys)
        return self._sequence("pull", (ch, keys),
                              lambda: self.store.pull(task, keys=keys, callback=callback))

    def push(self, task, keys=None, values=None, slots=None, callback=None) -> int:
        if slots is not None:
            raise ValueError("a sequenced push names its keys (slots are this rank's)")
        ch = task.key_channel
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        return self._sequence("push", (ch, keys, values),
                              lambda: self.store.push(task, keys=keys, values=values,
                                                      callback=callback))

    def snapshot(self, ch: int = 0, callback=None) -> int:
        return self._sequence("snapshot", (ch,),
                              lambda: self.store.snapshot(ch, callback=callback))

    def values(self, ch: int, keys):
        ts = self.pull(self.store.request(channel=ch), keys=keys)
        return self.store.wait_pull(ts).cpu().numpy()

    def call(self, op: str, **kw):
        """Run the handler ``op`` on every rank at this place of the
        order, after every earlier call has finished on each rank;
        returns rank 0's result."""
        self._check_leader(op)
        with self._lock:
            if self._closed:
                raise RuntimeError(f"order {self.name!r} is closed")
            number = self.calls + 1
            self._publish((number, "call", (op, kw)))
            self._count(number, "call:" + op)
            if self.store is not None:
                self.store.executor.wait_all(pop=False)
            return self._handlers[op](**kw)

    def sync(self) -> None:
        """Return once every rank has finished every call before this one."""
        self._check_leader("sync")
        with self._lock:
            if self._closed or self.group is None:
                return
            number = self.calls + 1
            self._publish((number, "sync", ()))
            self._count(number, "sync")
            dist.barrier(group=self.group)

    def close(self) -> None:
        """End the order (rank 0): every follower's :meth:`follow`
        returns, and the world agrees the calls' count and digest."""
        self._check_leader("close")
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._publish((self.calls + 1, "end", ()))
        self._agree()

    # -- every other rank --

    def _drain_store(self, keep: int = 0) -> None:
        while len(self._in_flight) > keep:
            ts = self._in_flight.popleft()
            if self.store is not None:
                self.store.executor.wait(ts)

    def follow(self) -> None:
        """Make rank 0's calls on this rank's store, in their order, until
        rank 0 closes the order; then agree the calls with the world."""
        if self.leader:
            raise RuntimeError("rank 0 sequences the order; the other ranks follow it")
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.group)
            number, op, args = box[0]
            if op == "end":
                break
            if number != self.calls + 1:
                raise OrderError(
                    f"rank {self.rank} of order {self.name!r} received call {number} after "
                    f"call {self.calls}")
            self._replay(number, op, args)
        self._drain_store()
        with self._lock:
            self._closed = True
        self._agree()

    def _replay(self, number: int, op: str, args: tuple) -> None:
        store = self.store
        if op == "call":
            name, kw = args
            self._count(number, "call:" + name)
            self._drain_store()
            self._handlers[name](**kw)
            return
        self._count(number, op)
        if op == "sync":
            self._drain_store()
            dist.barrier(group=self.group)
            return
        if store is None:  # a rank the mesh leaves idle: it only counts
            return
        with turns.sequenced(number):
            if op == "pull":
                ch, keys = args
                ts = store.pull(store.request(channel=ch), keys=keys)
            elif op == "push":
                ch, keys, values = args
                ts = store.push(store.request(channel=ch), keys=keys, values=values)
            elif op == "snapshot":
                (ch,) = args
                ts = store.snapshot(ch)
            else:
                raise OrderError(f"order {self.name!r}: unknown call {op!r}")
        self._in_flight.append(ts)
        self._drain_store(IN_FLIGHT)

    def _agree(self) -> None:
        """Every rank holds the same count and digest of calls (one
        ``all_reduce`` of the values and their negations over the
        order's group); raises on every rank otherwise."""
        if self.group is None:
            return
        vals = [self.calls, self.digest]
        t = torch.tensor(vals + [-v for v in vals], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        hi, lo = t[:2].tolist(), [-v for v in t[2:].tolist()]
        if hi != lo:
            raise OrderError(
                f"the ranks of order {self.name!r} disagree on its calls (rank {self.rank} "
                f"made {self.calls}, digest {self.digest}; the world's range {lo} .. {hi})")
