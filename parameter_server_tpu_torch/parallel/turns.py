"""One order of submissions that every rank of a world shares.

Threads of one process that feed a sharded store (``ps.run_system``'s
worker apps, each on a thread of its own) submit to the store's executor
in whatever order the threads happen to run, and that order differs from
rank to rank. On a mesh it must not: a pull assembles the data row's
shards with a collective, paired by position with the pulls of the
row's other ranks, and a push adds into a rank's shard, whose replicas
on the other data rows must add the same pushes in the same order.

:class:`Turns` fixes the order for a set of member threads named in a
fixed order (the program's worker nodes, W0, W1, ...). Each submission
of a member is a turn, taken round robin: member ``i`` takes its turn
when the members before it have taken theirs in this round, a member
that has finished leaving the round. :func:`take` waits for the calling
thread's turn on a condition (no clock) and passes the turn on when the
body is done; a thread that is no member (or with no :class:`Turns`
active) takes no turn, and a turn's body may take a nested one freely.

What a store's submissions were, in its executor's order, folds into a
digest (:func:`note`: the submitting member, or the thread's name, the
call and its key count). A pull agrees it over the server axis before
its collective (:func:`check_order`, on the store's dispatch thread),
and :meth:`Turns.check` agrees every store's and the turns' own over the
whole mesh at the end, so ranks whose submissions differ fail loudly
(``parallel/distributed.agree_on``) instead of pairing the wrong pulls.
A member that waits for another member's next submission would wait
for ever: the members must not depend on one another between turns, as
the programs of ``tests/test_ps_api.py`` do not.

Threads that are no fixed members (a serving frontend's request workers,
its coalescer and refresher, a trainer) get their order from rank 0
instead (``parallel/sequence.py``): a call made there runs inside
:func:`sequenced`, and :func:`note` folds the call's sequence number as
its origin, the same on every rank whatever thread made the call.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import weakref
from typing import List, Optional

from . import distributed
from . import mesh as meshlib

_tls = threading.local()
_active: Optional["Turns"] = None  # the process's turns, set by activate()


class Turns:
    """The round-robin order of the submissions of ``names``' threads."""

    def __init__(self, names: List[str]):
        self.names = list(names)
        self._cv = threading.Condition()
        self._next = 0  # guarded by _cv: the member whose turn it is
        self._finished: set = set()  # guarded by _cv
        self.digest = 0  # the turns taken: (member, call) in order; guarded by _cv
        self._stores: "weakref.WeakSet" = weakref.WeakSet()

    @contextlib.contextmanager
    def member(self, name: str):
        """Run the body as member ``name`` (on its own thread); the member
        leaves the round when the body ends, however it ends."""
        i = self.names.index(name)
        _tls.member = (self, i)
        _tls.depth = 0
        try:
            yield
        finally:
            _tls.member = None
            with self._cv:
                self._finished.add(i)
                if self._next == i:
                    self._advance_locked()
                self._cv.notify_all()

    def _advance_locked(self) -> None:  # holds _cv
        n = len(self.names)
        for step in range(1, n + 1):
            j = (self._next + step) % n
            if j not in self._finished:
                self._next = j
                return

    @contextlib.contextmanager
    def _turn(self, i: int, what: str):
        with self._cv:
            while self._next != i:
                self._cv.wait()
            self.digest = distributed.digest_ints(self.digest, self.names[i], what)
        try:
            yield
        finally:
            with self._cv:
                self._advance_locked()
                self._cv.notify_all()

    def check(self, mesh: "meshlib.Mesh") -> None:
        """Agree the turns' digest and every noted store's over the mesh
        (every rank calls it, once the stores' executors are idle)."""
        stores = sorted(self._stores, key=lambda s: s.name)
        for s in stores:
            s.executor.wait_all(pop=False)
        values = [self.digest] + [getattr(s, "_order_digest", 0) for s in stores]
        names = ["the turns taken"] + [f"the order of store {s.name!r}'s submissions"
                                       for s in stores]
        distributed.agree_on(mesh, values, names)


def activate(turns: Optional[Turns]) -> None:
    """Make ``turns`` the process's (None: none)."""
    global _active
    _active = turns


@contextlib.contextmanager
def take(what: str):
    """The calling thread's turn around the body, when it is a member of
    the active :class:`Turns` (and holds no turn already)."""
    member = getattr(_tls, "member", None)
    if member is None or member[0] is not _active or getattr(_tls, "depth", 0):
        yield
        return
    turns, i = member
    with turns._turn(i, what):
        _tls.depth = 1
        try:
            yield
        finally:
            _tls.depth = 0


def in_turn(what: str):
    """Decorate a method so that its body runs in the calling thread's
    turn (:func:`take`)."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with take(what):
                return fn(*args, **kw)
        return run
    return deco


@contextlib.contextmanager
def sequenced(number: int):
    """Run the body as call ``number`` of a sequenced order
    (``parallel/sequence.py``): the submissions it makes fold that
    number as their origin (:func:`note`)."""
    _tls.sequenced = number
    try:
        yield
    finally:
        _tls.sequenced = None


def note(store, what: str, num_keys: int) -> Optional[int]:
    """Fold one submission to ``store`` into its order digest (call it
    where the submission gets its executor timestamp, under the store's
    lock) and return the digest; None while no :class:`Turns` is active
    and the call is no sequenced one."""
    turns = _active
    number = getattr(_tls, "sequenced", None)
    if turns is None and number is None:
        return None
    member = getattr(_tls, "member", None)
    if number is not None:
        origin = ("sequenced", number)
    elif member is not None and member[0] is turns:
        origin = turns.names[member[1]]
    else:
        origin = threading.current_thread().name
    store._order_digest = distributed.digest_ints(getattr(store, "_order_digest", 0), origin,
                                                  what, int(num_keys))
    if turns is not None:
        turns._stores.add(store)
    return store._order_digest


def check_order(mesh: "meshlib.Mesh", digest: int, name: str) -> None:
    """Before a pull's collective (its dispatch thread): the ranks of the
    data row hold the same order of ``name``'s submissions up to it."""
    distributed.agree_on(mesh, [digest], [f"the order of store {name!r}'s submissions"],
                         axes=(meshlib.SERVER_AXIS,))
