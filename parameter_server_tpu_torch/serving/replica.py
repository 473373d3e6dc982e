"""Read replicas: snapshot-consistent read copies refreshed off the push path.

Counterpart of ``parameter_server_tpu/serving/replica.py``. Training
pushes add into the live table in place, so a serving read against the
live table must either go through the store's executor (contending with
training submits) or risk reading a half-applied push. The read replica
breaks the tie: a PRIVATE copy of the table serves all reads, and pushes
never touch it.

Race-freedom is by construction: the refresh rides the store's own
executor (``KVVector.snapshot``, a submitted copy step, or a plain
``pull`` for the hot-key subset), so it lands between two pushes in
timestamp order, and the copy it returns is no view of the table.

Consistency model: **snapshot**. Every read between two ``refresh()``
calls sees one table version (``version`` counts refreshes, ``age_s()``
reports staleness).

``hot_keys`` mode pulls just the hot rows into a compact ``[H, k]``
copy; keys outside the hot set report a miss and the frontend falls
through to the coalesced live pull.

Two homes for the copy:

- **host** (the default): the snapshot is copied to host memory once
  the snapshot step's device work is done (``executor.wait``), and reads
  gather with numpy. ``host_budget_bytes`` bounds what it may pin: a
  refresh whose snapshot exceeds it raises ``MemoryError`` before any
  host copy is made, and the last good snapshot keeps serving;
- **device** (``device=True``): the snapshot stays a tensor on the
  card, and reads are gathers there (``_gather_rows``), copied to the
  host per request. The budget does not apply: capacity scales with the
  card's memory, not the host's.

The refresh latency and the per-key hits and misses count in the
telemetry registry (``ps_serve_replica_*``).

**On a mesh** the store is rank 0's ``parallel/sequence.Order``: a
refresh takes its place in the order every rank follows, and the copy
is the whole table (``KVVector.snapshot`` gathers the data row's shards
over the server axis), held on rank 0, in host memory or on rank 0's
card. The device replica is gathered whole rather than kept sharded: a
read is then one local gather with no collective and no sequenced call
a request, for the whole table's bytes on rank 0's card (16 MiB at
2^22 x 1 float32, 4 GiB at 2^30) where a shard would hold 1/S of them.
A bare store on a mesh is refused.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ..parallel import sequence
from ..system import faults


def _gather_rows(table: torch.Tensor, rows: np.ndarray) -> np.ndarray:
    """``table[rows]`` gathered on the table's device, as a host array."""
    idx = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64)).to(table.device)
    return table.index_select(0, idx).cpu().numpy()


def _nbytes(table) -> int:
    if isinstance(table, torch.Tensor):
        return table.numel() * table.element_size()
    return table.nbytes


class ReadReplica:
    """Snapshot read copy of one store channel.

    ``store`` follows the KVVector protocol (``pull``/``wait_pull``/
    ``request``; ``snapshot(ch)`` when available, else ``table(ch,
    copy=True)`` after an executor drain). Reads (:meth:`pull`) take the
    (table, directory) pair under a small lock and gather outside it: a
    concurrent refresh swaps the table atomically but never mutates a
    published one.
    """

    def __init__(self, store, channel: int = 0, hot_keys: Optional[np.ndarray] = None,
                 device: bool = False, host_budget_bytes: Optional[int] = None):
        sequence.require(store, "ReadReplica")
        self.store = store
        self.channel = int(channel)
        self.hot_keys = (None if hot_keys is None
                         else np.unique(np.asarray(hot_keys, dtype=np.int64)))
        self.device = bool(device)
        self.host_budget_bytes = None if host_budget_bytes is None else int(host_budget_bytes)
        self._lock = threading.Lock()
        # a host numpy snapshot, or a tensor on the card when device=True
        self._table = None  # guarded-by: _lock
        self.version = 0  # guarded-by: _lock
        self._refreshed_at = 0.0  # guarded-by: _lock
        from ..telemetry.instruments import cached_serve_instruments

        self._tel = cached_serve_instruments
        self.refresh()

    def _directory(self):
        return self.store.channel(self.channel).directory

    # -- refresh (the ONLY path that touches the live store) --

    def refresh(self) -> int:
        """Take a fresh snapshot; returns the new version. Both routes
        serialize through the store's executor with the pushes."""
        # fault point: a dead shard's refresh fails; the refresher logs
        # and retries, the last good snapshot keeps serving
        faults.inject("serve.refresh", detail=getattr(self.store, "name", ""))
        t0 = time.perf_counter()
        if self.hot_keys is not None:
            ts = self.store.pull(self.store.request(channel=self.channel), keys=self.hot_keys)
            fresh = self.store.wait_pull(ts)  # a gather: no view of the table
        elif hasattr(self.store, "snapshot"):
            fresh = self.store.executor.wait(self.store.snapshot(self.channel))
        else:
            self.store.executor.wait_all(pop=False)
            fresh = self.store.table(self.channel, copy=True)
        if not self.device:
            if self.host_budget_bytes is not None and _nbytes(fresh) > self.host_budget_bytes:
                raise MemoryError(
                    f"host replica snapshot {_nbytes(fresh)} B exceeds host_budget_bytes="
                    f"{self.host_budget_bytes} — use device=True to hold it on the card instead"
                )
            fresh = fresh.cpu().numpy() if isinstance(fresh, torch.Tensor) else np.asarray(fresh)
        with self._lock:
            self._table = fresh
            self.version += 1
            self._refreshed_at = time.monotonic()
            version = self.version
        tel = self._tel()
        if tel is not None:
            tel["replica_refresh"].observe(time.perf_counter() - t0)
        return version

    def age_s(self) -> float:
        with self._lock:
            return time.monotonic() - self._refreshed_at

    def nbytes(self) -> int:
        with self._lock:
            return 0 if self._table is None else _nbytes(self._table)

    # -- the read path (no store executor, no live-table reads) --

    def _rows(self, table, idx: np.ndarray) -> np.ndarray:
        if not self.device:
            return table[idx]
        return _gather_rows(table, idx)

    def pull(self, keys: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
        """Rows for ``keys`` from the snapshot: ``(values [n, k],
        hit_mask [n])``. Full-table replicas always hit (keys the
        directory does not know read 0); hot-key replicas report misses
        per key, so the caller can live-pull exactly the missed rows."""
        keys = np.asarray(keys, dtype=np.int64).ravel()
        with self._lock:
            table = self._table
        tel = self._tel()
        if self.hot_keys is None:
            slots = self._directory().slots(keys)
            miss = slots >= table.shape[0]
            vals = self._rows(table, np.minimum(slots, table.shape[0] - 1))
            if miss.any():
                vals = np.where(miss[:, None], 0, vals).astype(vals.dtype)
            if tel is not None:
                tel["replica_hits"].inc(len(keys))
            return vals, np.ones(len(keys), dtype=bool)
        pos = np.searchsorted(self.hot_keys, keys)
        posc = np.minimum(pos, len(self.hot_keys) - 1)
        hit = (pos < len(self.hot_keys)) & (self.hot_keys[posc] == keys)
        dtype = (torch.empty((), dtype=table.dtype).numpy().dtype
                 if isinstance(table, torch.Tensor) else table.dtype)
        vals = np.zeros((len(keys), table.shape[1]), dtype)
        if hit.any():
            vals[hit] = self._rows(table, posc[hit])
        if tel is not None:
            n_hit = int(hit.sum())
            tel["replica_hits"].inc(n_hit)
            tel["replica_misses"].inc(len(keys) - n_hit)
        return vals, hit
