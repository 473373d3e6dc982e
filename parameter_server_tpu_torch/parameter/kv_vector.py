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

One card: ``num_server`` must be 1 (more is ROADMAP A9).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from ..ops import kv_ops
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
        #: the open push journal of a migration: (ts, slots, values), owned
        #: copies; the entries past the snapshot replay onto the new image
        self.journal: Optional[List[Tuple[int, torch.Tensor, torch.Tensor]]] = None  # guarded-by: remap_lock
        self.migrations = 0  # guarded-by: remap_lock


class KVVector(Parameter):
    def __init__(self, k: int = 1, num_slots: int = 1 << 20, hashed: bool = True,
                 dtype: torch.dtype = torch.float32, buffer_value: bool = False,
                 id: Optional[int] = None, name: str = "", device=None, num_server: int = 1):
        super().__init__(id=id, name=name)
        if num_server != 1:
            raise NotImplementedError(
                f"KVVector over {num_server} server shards: the port holds a table on one card "
                "(the sharded tables are ROADMAP A9)"
            )
        if device is None and self.po.started:
            device = self.po.device
        self.device = resolve(device)
        self.k = int(k)
        self.dtype = dtype
        self.buffer_value = buffer_value
        # hashed directories use the configured modulus, exact ones the
        # padded capacity (so the miss sentinel lands outside the table)
        self.num_slots_config = int(num_slots)
        self.num_slots = pad_slots(num_slots, num_server)
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
        return torch.zeros((self.num_slots, self.k), dtype=self.dtype, device=self.device)

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

    def pull(self, task: Task, keys: Optional[np.ndarray] = None,
             slots: Optional[torch.Tensor] = None, callback=None) -> int:
        """Async pull; returns the timestamp. Result via ``wait_pull``."""
        ch = task.key_channel
        c = self.channel(ch)
        if slots is None and keys is not None:
            c.key = np.asarray(keys, dtype=np.int64)
        pre = self._resolve(c, keys, slots)
        with c.remap_lock:  # wholly before or after a migration's flip
            resolved = self._current(c, keys, pre)

            def step():
                return kv_ops.pull(c.table, resolved)

            return self.instrumented_submit("pull", ch, len(resolved), step, task, callback)

    def wait_pull(self, ts: int) -> torch.Tensor:
        """The pulled rows of step ``ts`` (on the store's device), once
        its device work is done."""
        return self.executor.wait(ts)

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
                    c.buffers[task.time] = kv_ops.push_donated(buf, resolved, vals)
                    return c.buffers[task.time]
            else:
                def step():
                    c.table = kv_ops.push_donated(c.table, resolved, vals)
                    return c.table

            ts = self.instrumented_submit("push", ch, len(resolved), step, task, callback)
            if c.journal is not None and not staged:
                self._journal(c, ts, resolved, vals)
            return ts

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
            resolved = self._current(c, keys, pre)
            pull_slots = None if pull_keys is None else self._current(c, pull_keys, pre_pull)

            def step():
                c.table, pulled = kv_ops.push_pull_donated(c.table, resolved, vals, pull_slots)
                return pulled

            ts = self.instrumented_submit("push_pull", ch, len(resolved), step, task, callback)
            if c.journal is not None:
                self._journal(c, ts, resolved, vals)
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
    def _journal(c: _Channel, ts: int, slots: torch.Tensor, vals: torch.Tensor) -> None:  # holds-lock: c.remap_lock
        """Journal a push as owned copies: callers and the pinned staging
        ring reuse their buffers, and a CPU tensor may share a caller's
        numpy array."""
        c.journal.append((ts, torch.as_tensor(slots).clone(), vals.clone()))

    def snapshot(self, ch: int = 0, callback=None) -> int:
        """Async copy of the channel table; returns the timestamp (the
        copy via ``executor.wait``). A submitted step, so it lands
        between two pushes in timestamp order and no later push touches
        the copy: the read replica's refresh."""
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
        """The channel table: the live tensor, which the next push
        changes in place, or with ``copy=True`` a private copy."""
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
            c.table = kv_ops.push_donated(c.table, slots, vals)
            return c.table

        return self.instrumented_submit("push", ch, len(slots), step, self.request(channel=ch), None)

    def migrate(self, perm: np.ndarray, ch: int = 0, max_attempts: int = 5) -> dict:
        """Move rows to the layout ``perm`` (row ``j`` to row ``perm[j]``)
        while the push and pull stream goes on.

        1. open the channel's push journal, then take a submitted
           :meth:`snapshot`: its timestamp is the barrier, every push
           before it is in the copy;
        2. permute the copy on the table's device (one index op); the
           ``rebalance.migrate`` fault point fires before, and a stall
           there widens the journal window;
        3. under ``remap_lock``: submit the install of the image, replay
           the journaled pushes past the barrier in timestamp order with
           translated slots, and flip the directory's remap.

        A recovery that lands meanwhile (:meth:`note_external_restore`)
        makes the migration snapshot again, up to ``max_attempts`` times.
        The table after it, in the base layout, is bit-identical to an
        undisturbed run. Returns the barrier and install timestamps, the
        journaled and replayed push counts, the rows moved and the
        attempts."""
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
        c = self.channel(ch)
        rows_moved = int(torch.count_nonzero(perm_dev != torch.arange(n, device=self.device)))
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
                barrier_ts = self.snapshot(ch)
                snap = self.executor.wait(barrier_ts)
                # the drill stalls here to widen the window, or to land a
                # recovery mid-migration
                faults.inject("rebalance.migrate")
                img = torch.empty_like(snap).index_copy_(0, perm_dev, snap)
                del snap
                with c.remap_lock:
                    if self._generation() != gen0:
                        c.journal = None
                        continue  # a recovery landed first: the image is stale
                    journal, c.journal = c.journal, None

                    def install(t=img):
                        c.table = t
                        return c.table

                    install_ts = self.submit(install, self.request(channel=ch))
                    replayed = 0
                    for ts, slots, vals in journal:
                        if ts <= barrier_ts:
                            continue  # already in the snapshot
                        s64 = slots.to(self.device, torch.int64)
                        owned = (s64 >= 0) & (s64 < n)
                        moved = perm_dev.index_select(0, torch.clamp(s64, 0, n - 1))
                        new_slots = torch.where(owned, moved, s64).to(torch.int32)
                        self._submit_push_locked(c, ch, new_slots, vals)
                        replayed += 1
                    # the directory composes the layout and owns it
                    c.directory.set_remap(perm)
                    c.migrations += 1
                    break
        self.executor.wait_all(pop=False)
        return {"barrier_ts": barrier_ts, "install_ts": install_ts, "journaled": len(journal),
                "replayed": replayed, "rows_moved": rows_moved, "attempts": attempts}

    # -- replica hooks --

    def get_replica(self) -> dict:
        """Host copies of every channel table in the base layout, once
        the in-flight steps are done (the caller stops submitting
        first)."""
        self.executor.wait_all(pop=False)
        return {ch: self._to_base(c, c.table.cpu().numpy().copy())
                for ch, c in self._channels.items()}

    def get_replica_consistent(self) -> "tuple[dict, dict]":
        """A host snapshot through the executor: one submitted
        :meth:`snapshot` step a channel, safe under a live push stream.
        Returns ``(snapshot, barrier)``; barrier maps channel → the
        snapshot step's timestamp (every push before it is in the
        snapshot, every later one is not). The migration lock keeps the
        copy and its translation to the base layout on one layout."""
        with self._migration_lock:
            barrier = {ch: self.snapshot(ch) for ch in list(self._channels)}
            snap = {ch: self._to_base(self._channels[ch], self.executor.wait(ts).cpu().numpy())
                    for ch, ts in barrier.items()}
        return snap, barrier

    def set_replica(self, snapshot: dict) -> None:
        """Install base-layout channel tables (host arrays or tensors, as
        copies) in each channel's live layout."""
        for ch, arr in snapshot.items():
            c = self.channel(ch)
            if isinstance(arr, torch.Tensor):
                t = arr.to(device=self.device, dtype=self.dtype).clone()
            else:
                t = torch.from_numpy(np.array(arr)).to(device=self.device, dtype=self.dtype)
            perm = c.directory.remap()
            if perm is None:
                c.table = t
            else:
                perm_dev = torch.tensor(perm, device=self.device)  # remap() is read-only
                c.table = torch.empty_like(t).index_copy_(0, perm_dev, t)

    def write_to_file(self, path: str, ch: int = 0) -> None:
        """Dump nonzero (key, value) pairs as text (ref WriteToFile)."""
        self.executor.wait_all(pop=False)
        c = self.channel(ch)
        # the base layout: an exact directory's key order lines up with
        # the rows after a migration moved them
        tbl = self._to_base(c, c.table.cpu().numpy())
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
