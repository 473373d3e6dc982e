"""KVVector: key-value vectors on one card.

Counterpart of ``parameter_server_tpu/parameter/kv_vector.py`` (the
reference's ``src/parameter/kv_vector.h``, KVVector<K,V>): values are
fixed-length-k vectors per key, in isolated channels; push merges by
addition, pull returns the current values. Each channel owns

- a host :class:`KeyDirectory` (ordered global keys, or a hash), and
- a table ``[P, k]`` on the card (one server shard: the whole table),

and push/pull are the steps of ``ops/kv_ops.py``, submitted to the
store's executor, so they run in timestamp order on its dispatch thread.
The reference's ``buffer_value`` mode (stash pushes per timestamp for a
later merge) stages pushes into per-timestamp buffers.

**In-place contract.** Pushes add into the channel table in place (the
JAX package donates it). There is no donated buffer whose stale use
raises, so a stale read here would see a later push without any error;
every read path therefore copies:

- a pull returns a fresh tensor (a gather), never a view of the table;
- :meth:`snapshot` is a submitted copy step, in timestamp order with the
  pushes: it holds every push submitted before it and none after;
- ``table(copy=True)`` copies; the default ``table()`` is the live
  tensor, which the next push changes;
- ``get_replica`` and ``write_to_file`` drain the executor, then copy to
  the host.

**Live migration** (:meth:`migrate`) moves rows to a new layout while
pushes and pulls go on: a journal opens, a submitted snapshot is
permuted on the table's device (one index op), then, under the
channel's ``remap_lock``, the image is installed through the executor,
the journaled pushes past the snapshot replay in timestamp order through
the same push path with their slots translated, and the directory's
remap flips. A push or pull resolves its slots outside that lock (the
hash pass and the upload do not serialize callers), then under it checks
the directory's remap generation, resolving again if a flip came
between, and submits: it falls wholly before or wholly after the flip.
The directory holds the composed layout. Snapshots
(``get_replica``, ``get_replica_consistent``, ``write_to_file``) are in
the base layout, and ``set_replica`` re-applies the live one, so a
backup taken before a migration restores after it. A recovery install
calls :meth:`note_external_restore` first; a migration whose snapshot
predates it discards its image and snapshots again.

**On a mesh** (``mesh=``, or the started postoffice's): each rank holds
its server shard of the ``pad_slots(num_slots, num_server)`` rows, and
pushes and pulls go through ``ops/kv_ops.py`` with ``batch_sharded=False``
(every rank of the mesh makes the same calls with the same keys, as the
JAX package's replicated key sets; each data row holds a replica). A
push adds the rank's own entries and runs no collective; a pull is
assembled over the server axis (a collective on the executor's dispatch
thread); :meth:`snapshot` and ``table(copy=True)`` are the whole channel
table, as the JAX calls' global arrays are: a submitted step gathers the
row's shards over the server axis on the dispatch thread, between two
pushes in timestamp order (every rank of the row submits it at the same
point of its order, as a pull); the default ``table()`` stays this rank's
live shard. :meth:`migrate`, :meth:`get_replica`,
:meth:`get_replica_consistent` and :meth:`write_to_file` are
collectives of the data row: every rank calls them, in the same order,
with the same arguments. They run on the caller's thread over the
mesh's *side* groups (``parallel/mesh.py``), never the groups the
executor's pulls use, so a serve stream pulling through the executor
and a migration on another thread cannot interleave their collectives
differently on two ranks. The ranks of a row snapshot their shards at
barriers of their own (each rank's push stream runs at its own pace);
the row agrees on the latest barrier, counted in pushes (a push's
sequence number on its channel: every rank submits the same pushes in
the same order), and each rank brings its copy up to it from its
journal, so the gathered table holds the same pushes on every shard.
A pull assembles the row's shards, so the row flips its layout between
the same two reads on every rank: a migration holds this rank's reads
at the row's agreed count while it installs and flips
(:meth:`_flip_in_step`). Threads of one process that push and pull
(``ps.run_system``'s worker apps) take turns in one order that every
rank shares (``parallel/turns.py``); while turns are active each
submission folds into the store's order digest, and a pull agrees it
over the server axis before its collective. Threads that come and go (a
serving frontend's workers, its coalescer and refresher, a trainer) take
no turns: rank 0 orders their calls and the other ranks replay them
(``parallel/sequence.py``), each call's place in that order folding into
the same digest. A recovery install has no such gate: a pull
beside it may read some shards before it and others after (each key's
row whole from one side). :meth:`set_replica` installs each rank's rows
of a base-layout snapshot, whatever server count took it.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from ..ops import kv_ops
from ..parallel import mesh as meshlib
from ..parallel import turns
from ..system.message import Task
from ..utils import file as psfile
from .parameter import KeyDirectory, Parameter, pad_slots


class _Channel:
    def __init__(self, directory: KeyDirectory, table: torch.Tensor):
        self.directory = directory
        self.table = table
        self.key: Optional[np.ndarray] = None  # last key set (ref data_[chl].key)
        self.buffers: Dict[int, torch.Tensor] = {}  # ts -> staged pushes
        # -- live migration (KVVector.migrate) --
        # serializes a push's or pull's generation check + submit against
        # a migration's install + directory flip: it is wholly before the
        # flip (old slots, ts < install) or wholly after it
        self.remap_lock = threading.Lock()
        #: the open push journal of a migration: (ts, seq, slots, values),
        #: owned copies; the entries past the snapshot replay onto the new image
        self.journal: Optional[List[Tuple[int, int, torch.Tensor, torch.Tensor]]] = None  # guarded-by: remap_lock
        #: pushes submitted into the live table (push and push_pull): the
        #: sequence number of the last one
        self.pushes = 0  # guarded-by: remap_lock
        #: reads submitted (pull and push_pull): on a mesh each is a
        #: collective of the data row, so a flip must fall between the same
        #: two reads on every rank of it
        self.reads = 0  # guarded-by: remap_lock
        #: while a mesh migration flips: the count of reads allowed before
        #: the flip (None: reads flow)
        self.read_gate: Optional[int] = None  # guarded-by: remap_lock
        self.gate_moved = threading.Condition(self.remap_lock)
        self.migrations = 0  # guarded-by: remap_lock


class KVVector(Parameter):
    def __init__(self, k: int = 1, num_slots: int = 1 << 20, hashed: bool = True,
                 dtype: torch.dtype = torch.float32, buffer_value: bool = False,
                 id: Optional[int] = None, name: str = "", device=None, num_server: int = 1,
                 mesh: Optional[meshlib.Mesh] = None):
        super().__init__(id=id, name=name)
        if mesh is None and self.po.started:
            mesh = self.po.mesh
        if mesh is not None and mesh.size == 1:
            mesh = None  # one card: every collective is the identity
        if num_server != 1 and (mesh is None or num_server != meshlib.num_servers(mesh)):
            raise ValueError(
                f"KVVector over {num_server} server shards needs a mesh with that many "
                f"(got {mesh!r}): start the postoffice on one, or pass mesh=")
        #: the mesh the table is sharded over (None: one card, the whole table)
        self.mesh = mesh
        num_server = 1 if mesh is None else meshlib.num_servers(mesh)
        if mesh is not None:
            device = mesh.device
        elif device is None and self.po.started:
            device = self.po.device
        self.device = resolve(device)
        self.k = int(k)
        self.dtype = dtype
        self.buffer_value = buffer_value
        # hashed directories use the configured modulus, exact ones the
        # padded capacity (so the miss sentinel lands outside the table)
        self.num_slots_config = int(num_slots)
        self.num_slots = pad_slots(num_slots, num_server)
        #: the rows this rank holds: its server shard
        self.shard_rows = self.num_slots // num_server
        self.hashed = hashed
        self._channels: Dict[int, _Channel] = {}  # guarded-by: _channels_lock (writes)
        # a channel is made at its first use, which may come from several
        # threads at once (a pusher and a puller): one of them makes it
        self._channels_lock = threading.Lock()
        # serializes migrations, and consistent snapshots against them
        self._migration_lock = threading.Lock()
        #: bumped by note_external_restore() before a recovery install is
        #: submitted; a migration whose snapshot predates it snapshots again
        self._restore_generation = 0  # guarded-by: _gen_lock
        self._gen_lock = threading.Lock()

    # -- channel management (ref operator[]/Clear) --

    def channel(self, ch: int = 0) -> _Channel:
        c = self._channels.get(ch)
        if c is None:
            with self._channels_lock:
                c = self._channels.get(ch)
                if c is None:
                    directory = KeyDirectory(
                        self.num_slots_config if self.hashed else self.num_slots,
                        hashed=self.hashed)
                    c = self._channels[ch] = _Channel(directory, self._zeros())
        return c

    def __getitem__(self, ch: int) -> _Channel:
        return self.channel(ch)

    def clear(self, ch: int) -> None:
        with self._channels_lock:
            self._channels.pop(ch, None)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((self.shard_rows, self.k), dtype=self.dtype, device=self.device)

    def _kv(self) -> dict:
        """The mesh arguments of a kv_ops call: the replicated key sets of
        a store (none with one card)."""
        return {} if self.mesh is None else {"mesh": self.mesh, "batch_sharded": False}

    def set_keys(self, ch: int, keys: np.ndarray) -> None:
        """Install an exact ordered key set for a channel (ref: the
        worker assigns ``model_[ch].key = key`` before pulling). The
        input is sorted and de-duplicated first; the installed key array
        is kept on ``channel(ch).key``."""
        c = self.channel(ch)
        keys = np.unique(np.asarray(keys, dtype=np.int64))
        with c.remap_lock:
            directory = KeyDirectory(self.num_slots, keys=keys, hashed=False)
            layout = c.directory.remap()
            if layout is not None:  # a new directory routes into the migrated layout
                directory.set_remap(layout)
            c.directory = directory
            c.key = keys

    # -- push/pull --

    def slots(self, ch: int, keys: np.ndarray) -> torch.Tensor:
        """Slot ids of ``keys`` on the card (cached per key set)."""
        return self.channel(ch).directory.slots_device(keys, self.device)

    def _values(self, values) -> torch.Tensor:
        v = torch.as_tensor(values.cpu() if isinstance(values, torch.Tensor) else
                            np.asarray(values))
        return v.to(self.dtype).reshape(-1, self.k).to(self.device)

    @turns.in_turn("pull")
    def pull(self, task: Task, keys: Optional[np.ndarray] = None,
             slots: Optional[torch.Tensor] = None, callback=None) -> int:
        """Async pull; returns the timestamp. Result via ``wait_pull``."""
        ch = task.key_channel
        c = self.channel(ch)
        if slots is None and keys is not None:
            c.key = np.asarray(keys, dtype=np.int64)
        pre = self._resolve(c, keys, slots)
        with c.remap_lock:  # wholly before or after a migration's flip
            self._read_slot(c)
            resolved = self._current(c, keys, pre)
            order = turns.note(self, "pull", len(resolved))

            def step():
                if order is not None and self.mesh is not None:
                    turns.check_order(self.mesh, order, self.name)
                return kv_ops.pull(c.table, resolved, **self._kv())

            return self.instrumented_submit("pull", ch, len(resolved), step, task, callback)

    def wait_pull(self, ts: int) -> torch.Tensor:
        """The pulled rows of step ``ts`` (on the store's device), once
        its device work is done."""
        return self.executor.wait(ts)

    @turns.in_turn("push")
    def push(self, task: Task, keys: Optional[np.ndarray] = None, values=None,
             slots: Optional[torch.Tensor] = None, callback=None) -> int:
        """Async additive push; returns the timestamp."""
        ch = task.key_channel
        c = self.channel(ch)
        staged = self.buffer_value and task.time >= 0
        # wholly before or after a migration's flip; while a migration's
        # snapshot is open the push is also journaled, and replays onto
        # the migrated image if it lands past the snapshot
        pre = self._resolve(c, keys, slots)
        vals = self._values(values)
        with c.remap_lock:
            resolved = self._current(c, keys, pre)

            if staged:
                # stage into a per-timestamp buffer (ref buffer_[timestamp])
                def step():
                    buf = c.buffers.get(task.time)
                    if buf is None:
                        buf = self._zeros()
                    c.buffers[task.time] = kv_ops.push_donated(buf, resolved, vals, **self._kv())
                    return c.buffers[task.time]
            else:
                def step():
                    c.table = kv_ops.push_donated(c.table, resolved, vals, **self._kv())
                    return c.table

            turns.note(self, "push", len(resolved))
            ts = self.instrumented_submit("push", ch, len(resolved), step, task, callback)
            if not staged:
                self._count_push(c, ts, resolved, vals)
            return ts

    @turns.in_turn("push_pull")
    def push_pull(self, task: Task, keys: Optional[np.ndarray] = None, values=None,
                  slots: Optional[torch.Tensor] = None, pull_keys: Optional[np.ndarray] = None,
                  callback=None) -> int:
        """Push ``values`` into the live table and return the updated
        rows in one step (ref: the server's "aggregate then reply").
        ``pull_keys`` defaults to the pushed keys; the result (via
        ``wait_pull``) equals ``push`` followed by ``pull``. A
        ``buffer_value`` store with ``task.time >= 0`` stages pushes
        instead, so it raises here."""
        if self.buffer_value and task.time >= 0:
            raise ValueError(
                "push_pull applies to the live table; a buffer_value store with task.time >= 0 "
                "stages pushes instead — use push() + buffer()/pull"
            )
        ch = task.key_channel
        c = self.channel(ch)
        pre = self._resolve(c, keys, slots)
        pre_pull = None if pull_keys is None else self._resolve(c, pull_keys, None)
        vals = self._values(values)
        with c.remap_lock:  # as push: atomic against a flip, journaled
            self._read_slot(c)
            resolved = self._current(c, keys, pre)
            pull_slots = None if pull_keys is None else self._current(c, pull_keys, pre_pull)
            order = turns.note(self, "push_pull", len(resolved))

            def step():
                if order is not None and self.mesh is not None:
                    turns.check_order(self.mesh, order, self.name)
                c.table, pulled = kv_ops.push_pull_donated(c.table, resolved, vals, pull_slots,
                                                           **self._kv())
                return pulled

            ts = self.instrumented_submit("push_pull", ch, len(resolved), step, task, callback)
            self._count_push(c, ts, resolved, vals)
            return ts

    def _resolve(self, c: _Channel, keys: Optional[np.ndarray],
                 slots: Optional[torch.Tensor]) -> tuple:
        """Slots of ``keys`` on the card, resolved outside ``remap_lock``,
        with the directory and the remap generation they hold for
        (:meth:`_current` re-checks both); caller-given slots pass as
        they are."""
        if slots is not None:
            return slots, None, 0
        if keys is None:
            raise ValueError("pass keys or slots")
        d = c.directory
        t, gen = d.slots_device_at(keys, self.device)
        return t, d, gen

    def _current(self, c: _Channel, keys: Optional[np.ndarray], pre: tuple) -> torch.Tensor:  # holds-lock: c.remap_lock
        """The slots of :meth:`_resolve` if no flip or key-set change came
        since, else resolved again (the flips are rare)."""
        slots, d, gen = pre
        if d is None or (d is c.directory and d.generation == gen):
            return slots
        return c.directory.slots_device(keys, self.device)

    @staticmethod
    def _read_slot(c: _Channel) -> None:  # holds-lock: c.remap_lock
        """Count a read about to be submitted, first waiting while a mesh
        migration's gate holds reads back (:meth:`_flip_in_step`)."""
        while c.read_gate is not None and c.reads >= c.read_gate:
            c.gate_moved.wait()
        c.reads += 1
        if c.read_gate is not None:  # a migration waits for this count
            c.gate_moved.notify_all()

    @staticmethod
    def _count_push(c: _Channel, ts: int, slots: torch.Tensor, vals: torch.Tensor) -> None:  # holds-lock: c.remap_lock
        """Number a table push and, while a journal is open, journal it as
        owned copies: callers and the pinned staging ring reuse their
        buffers, and a CPU tensor may share a caller's numpy array."""
        c.pushes += 1
        if c.journal is not None:
            c.journal.append((ts, c.pushes, torch.as_tensor(slots).clone(), vals.clone()))

    def snapshot(self, ch: int = 0, callback=None) -> int:
        """Async copy of the whole channel table; returns the timestamp
        (the copy via ``executor.wait``). A submitted step, so it lands
        between two pushes in timestamp order and no later push touches
        the copy: the read replica's refresh. On a mesh of several server
        shards the step gathers the row's shards over the server axis (a
        collective of the data row, as a pull: every rank of the row
        submits it at the same point of its order, and it counts as a
        read against a migration's flip), so every rank of the row gets
        the whole table."""
        if self._side() is None:
            return self._shard_snapshot(ch, callback)
        c = self.channel(ch)
        with c.remap_lock:
            self._read_slot(c)
            order = turns.note(self, "snapshot", 0)

            def step():
                if order is not None:
                    turns.check_order(self.mesh, order, self.name)
                return meshlib.all_gather(c.table, meshlib.SERVER_AXIS, self.mesh)

            return self.submit(step, self.request(channel=ch), callback)

    def _shard_snapshot(self, ch: int = 0, callback=None) -> int:
        """Async copy of this rank's shard of the channel table (the whole
        table off a mesh); returns the timestamp."""
        c = self.channel(ch)
        return self.submit(lambda: c.table.clone(), self.request(channel=ch), callback)

    def buffer(self, ch: int, ts: int) -> Optional[torch.Tensor]:
        """Staged pushes for a timestamp (ref KVVector::buffer)."""
        return self.channel(ch).buffers.get(ts)

    def clear_buffer(self, ch: int, ts: int) -> None:
        self.channel(ch).buffers.pop(ts, None)

    # -- direct (synchronous) access used by learners and tests --

    def values(self, ch: int, keys: np.ndarray) -> np.ndarray:
        ts = self.pull(self.request(channel=ch), keys=keys)
        return self.wait_pull(ts).cpu().numpy()

    def table(self, ch: int = 0, copy: bool = False) -> torch.Tensor:
        """The channel table: the live tensor (this rank's shard on a
        mesh), which the next push changes in place, or with ``copy=True``
        a private copy of the whole table (on a mesh of several server
        shards a :meth:`snapshot`, waited for: a collective of the data
        row)."""
        if copy and self._side() is not None:
            return self.executor.wait(self.snapshot(ch))
        t = self.channel(ch).table
        return t.clone() if copy else t

    def set_table(self, ch: int, table: torch.Tensor) -> None:
        self.channel(ch).table = table

    # -- live migration --

    @staticmethod
    def _to_base(c: _Channel, arr: np.ndarray) -> np.ndarray:
        """A current-layout host table in the base (pre-migration) slot
        order: snapshots are stored in the base layout."""
        perm = c.directory.remap()
        return arr if perm is None else np.asarray(arr)[perm]

    def layout(self, ch: int = 0) -> Optional[np.ndarray]:
        """The channel's composed base -> current slot permutation (a
        copy), or None while the layout is the base one."""
        perm = self.channel(ch).directory.remap()
        return None if perm is None else perm.copy()

    def note_external_restore(self) -> None:
        """Call before submitting a recovery install
        (``ReplicaManager.recover`` does): a migration in flight whose
        snapshot predates this discards its image and snapshots again, so
        pre-recovery bytes never overwrite the recovery."""
        with self._gen_lock:
            self._restore_generation += 1

    def _generation(self) -> int:
        with self._gen_lock:
            return self._restore_generation

    def _submit_push_locked(self, c: _Channel, ch: int, slots: torch.Tensor,
                            vals: torch.Tensor) -> int:  # holds-lock: c.remap_lock
        """Replay one journaled push through the live push path
        (``kv_ops.push_donated``: the same adds in the same order, so the
        same bits)."""
        def step():
            c.table = kv_ops.push_donated(c.table, slots, vals, **self._kv())
            return c.table

        return self.instrumented_submit("push", ch, len(slots), step, self.request(channel=ch), None)

    # -- the row's consistent snapshot (a collective on a mesh) --

    def _side(self) -> Optional[meshlib.Mesh]:
        """The mesh of this store's row collectives: its side groups
        (None off a mesh or with one server shard, where they are local)."""
        if self.mesh is None or meshlib.num_servers(self.mesh) == 1:
            return None
        return self.mesh.side

    def _barrier(self, c: _Channel, ch: int) -> Tuple[int, int]:
        """Submit a :meth:`snapshot` of channel ``ch``: its timestamp and
        the sequence number of the last push before it."""
        with c.remap_lock:
            return self._shard_snapshot(ch), c.pushes

    def _align(self, c: _Channel, snap: torch.Tensor, seq: int, upto: int) -> int:
        """Add to ``snap`` (this rank's shard, holding the pushes up to
        ``seq``) the journaled pushes ``seq + 1 .. upto``, in order, through
        the live push path, waiting for this rank's stream to submit them;
        returns the timestamp of the last push added (0 for none). The
        journal is open."""
        if upto <= seq:
            return 0
        from ..parallel import distributed

        deadline = time.monotonic() + distributed.TIMEOUT_S
        while True:
            with c.remap_lock:
                if c.pushes >= upto:
                    todo = [e for e in c.journal if seq < e[1] <= upto]
                    break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"KVVector {self.name!r}: this rank's push stream did not reach push {upto} "
                    f"(the row's barrier) in {distributed.TIMEOUT_S:.0f} s; every rank must "
                    "submit the same pushes")
            time.sleep(0.001)
        for _, _, slots, vals in todo:
            kv_ops.push_donated(snap, slots, vals, **self._kv())
        return todo[-1][0]

    def _whole(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole table from every server shard of the row (the side
        groups' gather), or ``shard`` itself with one."""
        side = self._side()
        return shard if side is None else meshlib.all_gather(shard, meshlib.SERVER_AXIS, side)

    def _agree(self, *values: int) -> Tuple[int, ...]:
        """The largest of each value over the row (one ``all_reduce``)."""
        side = self._side()
        if side is None:
            return tuple(int(v) for v in values)
        return tuple(meshlib.agree_max(list(values), meshlib.SERVER_AXIS, side))

    def _mine(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's server shard of a whole-table tensor."""
        if self.mesh is None:
            return whole
        lo = meshlib.axis_index(meshlib.SERVER_AXIS, self.mesh) * self.shard_rows
        return whole[lo:lo + self.shard_rows]

    def _flip_in_step(self, c: _Channel) -> None:
        """Hold this rank's reads of channel ``c`` at the row's agreed count
        before a mesh migration flips it: every rank of the row flips
        between the same two reads (a pull assembles the row's shards, so
        a read on the new layout on one rank and on the old on another
        would add a key's row twice or not at all). The gate closes, the
        row agrees on the most reads any rank has submitted, and this rank
        lets its reads through up to that count; the caller flips and
        opens it."""
        from ..parallel import distributed

        with c.remap_lock:
            c.read_gate = c.reads
        (agreed,) = self._agree(c.reads)
        deadline = time.monotonic() + distributed.TIMEOUT_S
        with c.remap_lock:
            c.read_gate = agreed
            c.gate_moved.notify_all()
            while c.reads < agreed:
                if not c.gate_moved.wait(timeout=max(0.0, deadline - time.monotonic())):
                    c.read_gate = None
                    c.gate_moved.notify_all()
                    raise RuntimeError(
                        f"KVVector {self.name!r}: this rank's reads did not reach read {agreed} "
                        f"(the row's flip point) in {distributed.TIMEOUT_S:.0f} s; every rank "
                        "must submit the same reads")

    def migrate(self, perm: np.ndarray, ch: int = 0, max_attempts: int = 5) -> dict:
        """Move rows to the layout ``perm`` (row ``j`` to row ``perm[j]``)
        while the push and pull stream goes on.

        1. open the channel's push journal, then take a submitted
           :meth:`snapshot`: its timestamp is the barrier, every push
           before it is in the copy; the ``rebalance.migrate`` fault
           point fires next, and a stall there widens the journal window;
        2. on a mesh the data row agrees on the latest barrier (in
           pushes) and on whether a recovery landed, each rank brings its
           copy up to that barrier from its journal, and the shards are
           gathered over the side groups;
        3. permute the copy on the table's device (one index op);
        4. on a mesh hold the reads at the row's agreed count; under
           ``remap_lock``: submit the install of this rank's rows of the
           image, replay the journaled pushes past the barrier in order
           with translated slots, and flip the directory's remap.

        It returns once its install and replays have run, without waiting
        for the pushes other threads submit after the flip.
        A recovery that lands meanwhile (:meth:`note_external_restore`)
        makes the migration snapshot again, up to ``max_attempts`` times;
        on a mesh the row retries together when any of its ranks saw one.
        The table after it, in the base layout, is bit-identical to an
        undisturbed run. On a mesh every rank of the data row calls it
        with the same ``perm`` (checked). Returns the barrier and install
        timestamps, the journaled and replayed push counts, the rows
        moved and the attempts."""
        from ..system import faults

        perm = np.asarray(perm, dtype=np.int64)
        n = self.num_slots
        bad = ValueError(f"perm must be a bijection over the padded slot capacity ({n})")
        if perm.shape != (n,):
            raise bad
        perm_dev = torch.from_numpy(perm).to(self.device)
        # a bijection: n values in [0, n), each once; counted on the
        # table's device (a count, not a sort)
        if n and not (bool(perm_dev.min() >= 0) and bool(perm_dev.max() < n)
                      and bool(torch.bincount(perm_dev, minlength=n).max() == 1)):
            raise bad
        digest = int.from_bytes(hashlib.blake2b(perm.tobytes(), digest_size=8).digest(),
                                "little") >> 1
        hi, neg_lo = self._agree(digest, -digest)
        if hi != -neg_lo:
            raise ValueError("migrate: the ranks of the data row were given different perms")
        c = self.channel(ch)
        rows_moved = int(torch.count_nonzero(perm_dev != torch.arange(n, device=self.device)))
        on_mesh = self._side() is not None
        with self._migration_lock:
            attempts = 0
            while True:
                attempts += 1
                if attempts > max_attempts:
                    raise RuntimeError(
                        f"migration could not complete: a recovery interleaved {max_attempts} times")
                gen0 = self._generation()
                with c.remap_lock:
                    c.journal = []
                barrier_ts, seq = self._barrier(c, ch)
                snap = self.executor.wait(barrier_ts)
                # the drill stalls here to widen the window, or to land a
                # recovery mid-migration
                faults.inject("rebalance.migrate")
                upto, stale = self._agree(seq, int(self._generation() != gen0))
                if on_mesh and stale:
                    with c.remap_lock:
                        c.journal = None
                    continue  # a recovery landed on a rank of the row: the image is stale
                self._align(c, snap, seq, upto)
                whole = self._whole(snap)
                del snap
                img = torch.empty_like(whole).index_copy_(0, perm_dev, whole)
                del whole
                if self.mesh is not None:
                    img = self._mine(img).clone()
                if on_mesh:
                    self._flip_in_step(c)
                try:
                    with c.remap_lock:
                        if not on_mesh and self._generation() != gen0:
                            c.journal = None
                            continue  # a recovery landed first: the image is stale
                        journal, c.journal = c.journal, None

                        def install(t=img):
                            c.table = t
                            return c.table

                        install_ts = self.submit(install, self.request(channel=ch))
                        own = [install_ts]  # the migration's own steps
                        for _, pseq, slots, vals in journal:
                            if pseq <= upto:
                                continue  # already in the image
                            s64 = slots.to(self.device, torch.int64)
                            owned = (s64 >= 0) & (s64 < n)
                            moved = perm_dev.index_select(0, torch.clamp(s64, 0, n - 1))
                            new_slots = torch.where(owned, moved, s64).to(torch.int32)
                            own.append(self._submit_push_locked(c, ch, new_slots, vals))
                        replayed = len(own) - 1
                        # the directory composes the layout and owns it
                        c.directory.set_remap(perm)
                        c.migrations += 1
                        break
                finally:
                    with c.remap_lock:
                        c.read_gate = None
                        c.gate_moved.notify_all()
        # the install and the replays have run (in timestamp order); the
        # pushes other threads submitted after the flip are not waited for
        for ts in own:
            self.executor.wait(ts)
        return {"barrier_ts": barrier_ts, "install_ts": install_ts, "journaled": len(journal),
                "replayed": replayed, "rows_moved": rows_moved, "attempts": attempts}

    # -- replica hooks --

    @turns.in_turn("get_replica")
    def get_replica(self) -> dict:
        """Host copies of every channel table, whole and in the base
        layout, once the in-flight steps are done (the caller stops
        submitting first). On a mesh a collective of the data row: every
        rank gets the whole tables."""
        with self._migration_lock:
            self.executor.wait_all(pop=False)
            return {ch: self._to_base(self._channels[ch],
                                      self._whole(self._channels[ch].table).cpu().numpy().copy())
                    for ch in sorted(self._channels)}

    def get_replica_consistent(self) -> "tuple[dict, dict]":
        """A host snapshot through the executor: one submitted
        :meth:`snapshot` step a channel, safe under a live push stream.
        Returns ``(snapshot, barrier)``; barrier maps channel → the
        snapshot step's timestamp (every push before it is in the
        snapshot, every later one is not). The migration lock keeps the
        copy and its translation to the base layout on one layout. On a
        mesh a collective of the data row, whose shards agree on one
        barrier in pushes (the module's docstring); a rank's barrier is
        then the timestamp of the last push its copy holds, if later than
        its snapshot."""
        snap, barrier = {}, {}
        with self._migration_lock:
            for ch in sorted(self._channels):
                c = self._channels[ch]
                on_mesh = self._side() is not None
                if on_mesh:
                    with c.remap_lock:
                        c.journal = []
                try:
                    ts, seq = self._barrier(c, ch)
                    shard = self.executor.wait(ts)
                    if on_mesh:
                        (upto,) = self._agree(seq)
                        ts = max(ts, self._align(c, shard, seq, upto))
                finally:
                    if on_mesh:
                        with c.remap_lock:
                            c.journal = None
                barrier[ch] = ts
                snap[ch] = self._to_base(c, self._whole(shard).cpu().numpy())
        return snap, barrier

    def set_replica(self, snapshot: dict) -> None:
        """Install base-layout channel tables (host arrays or tensors, as
        copies) in each channel's live layout. A table of another padded
        size (taken at another server count) keeps its rows that fit and
        zero-extends; on a mesh each rank installs its own shard's rows,
        so a snapshot taken at one server count installs at another."""
        for ch, arr in snapshot.items():
            c = self.channel(ch)
            if isinstance(arr, torch.Tensor):
                t = arr.to(device=self.device, dtype=self.dtype).clone()
            else:
                t = torch.from_numpy(np.array(arr)).to(device=self.device, dtype=self.dtype)
            t = t.reshape(-1, self.k)
            if t.shape[0] != self.num_slots:
                fitted = torch.zeros((self.num_slots, self.k), dtype=self.dtype,
                                     device=self.device)
                m = min(self.num_slots, t.shape[0])
                fitted[:m] = t[:m]
                t = fitted
            perm = c.directory.remap()
            if perm is not None:
                perm_dev = torch.tensor(perm, device=self.device)  # remap() is read-only
                t = torch.empty_like(t).index_copy_(0, perm_dev, t)
            c.table = self._mine(t).clone() if self.mesh is not None else t

    @turns.in_turn("write_to_file")
    def write_to_file(self, path: str, ch: int = 0) -> None:
        """Dump nonzero (key, value) pairs as text (ref WriteToFile), in
        the base layout (an exact directory's key order lines up with the
        rows after a migration moved them). On a mesh every rank of the
        data row calls it: the shards are gathered and rank 0 writes."""
        with self._migration_lock:
            self.executor.wait_all(pop=False)
            c = self.channel(ch)
            tbl = self._to_base(c, self._whole(c.table).cpu().numpy())
        if self.mesh is not None and self.mesh.rank != 0:
            return
        if c.directory.keys is not None:
            keys = c.directory.keys
            vals = tbl[: len(keys)]
        else:
            keys = np.arange(self.num_slots, dtype=np.int64)
            vals = tbl
        nz = np.any(vals != 0, axis=1)
        with psfile.open_write(path) as f:
            for key, val in zip(keys[nz], vals[nz]):
                f.write(f"{key}\t" + "\t".join(str(x) for x in val) + "\n")
