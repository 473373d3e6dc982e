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

One card: ``num_server`` must be 1 (more is ROADMAP A9). Live migration
(``migrate``, ``note_external_restore``) and its push journal are
ROADMAP A13; ``layout`` is always the base layout (None).
"""

from __future__ import annotations

from typing import Dict, Optional

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


def _migration_not_ported(what: str):
    return NotImplementedError(
        f"KVVector.{what}: live slot migration (the push journal and its replay) is not "
        "ported (ROADMAP A13)"
    )


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
        self._channels: Dict[int, _Channel] = {}

    # -- channel management (ref operator[]/Clear) --

    def channel(self, ch: int = 0) -> _Channel:
        if ch not in self._channels:
            directory = KeyDirectory(self.num_slots_config if self.hashed else self.num_slots,
                                     hashed=self.hashed)
            self._channels[ch] = _Channel(directory, self._zeros())
        return self._channels[ch]

    def __getitem__(self, ch: int) -> _Channel:
        return self.channel(ch)

    def clear(self, ch: int) -> None:
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
        c.directory = KeyDirectory(self.num_slots, keys=keys, hashed=False)
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
        if slots is None:
            if keys is None:
                raise ValueError("pass keys or slots")
            c.key = np.asarray(keys, dtype=np.int64)
            slots = self.slots(ch, keys)
        resolved = slots

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
        if slots is None:
            if keys is None:
                raise ValueError("pass keys or slots")
            slots = self.slots(ch, keys)
        resolved = slots
        vals = self._values(values)

        if self.buffer_value and task.time >= 0:
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

        return self.instrumented_submit("push", ch, len(resolved), step, task, callback)

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
        if slots is None:
            if keys is None:
                raise ValueError("pass keys or slots")
            slots = self.slots(ch, keys)
        resolved = slots
        pull_slots = None if pull_keys is None else self.slots(ch, pull_keys)
        vals = self._values(values)

        def step():
            c.table, pulled = kv_ops.push_pull_donated(c.table, resolved, vals, pull_slots)
            return pulled

        return self.instrumented_submit("push_pull", ch, len(resolved), step, task, callback)

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

    # -- live migration: ROADMAP A13 --

    def layout(self, ch: int = 0) -> Optional[np.ndarray]:
        """The channel's slot permutation: None, the base layout (no
        migration runs in the port)."""
        return None

    def note_external_restore(self) -> None:
        raise _migration_not_ported("note_external_restore")

    def migrate(self, perm: np.ndarray, ch: int = 0, max_attempts: int = 5) -> dict:
        raise _migration_not_ported("migrate")

    # -- replica hooks --

    def get_replica(self) -> dict:
        """Host copies of every channel table, once the in-flight steps
        are done (the caller stops submitting first)."""
        self.executor.wait_all(pop=False)
        return {ch: c.table.cpu().numpy().copy() for ch, c in self._channels.items()}

    def get_replica_consistent(self) -> "tuple[dict, dict]":
        """A host snapshot through the executor: one submitted
        :meth:`snapshot` step a channel, safe under a live push stream.
        Returns ``(snapshot, barrier)``; barrier maps channel → the
        snapshot step's timestamp (every push before it is in the
        snapshot, every later one is not)."""
        barrier = {ch: self.snapshot(ch) for ch in list(self._channels)}
        snap = {ch: self.executor.wait(ts).cpu().numpy() for ch, ts in barrier.items()}
        return snap, barrier

    def set_replica(self, snapshot: dict) -> None:
        """Install channel tables (host arrays or tensors), as copies."""
        for ch, arr in snapshot.items():
            t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr))
            self.channel(ch).table = t.to(device=self.device, dtype=self.dtype).clone()

    def write_to_file(self, path: str, ch: int = 0) -> None:
        """Dump nonzero (key, value) pairs as text (ref WriteToFile)."""
        self.executor.wait_all(pop=False)
        c = self.channel(ch)
        tbl = c.table.cpu().numpy()
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
