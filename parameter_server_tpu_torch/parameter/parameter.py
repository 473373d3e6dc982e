"""Parameter: base class of shared parameters; the key directory.

Counterpart of ``parameter_server_tpu/parameter/parameter.py`` (the
reference's ``src/parameter/parameter.{h,cc}``): request construction
(channel, timestamp, filters, key range — the fields of
``Parameter::Request``), the key directory (global uint64 keys → dense
slot ids) and the replica hooks.

Key directories come in two modes, both host-side:

- **exact**: a sorted global key array per channel; slot =
  searchsorted(key) (the reference's ordered unique key arrays in
  kv_vector.h); a key not in the set maps to the sentinel ``num_slots``;
- **hashed**: slot = mix64(key) % num_slots, the streaming mode where
  the key universe is unbounded (CTR hashing trick).

Push/pull requests record the JAX package's latency histograms and
key-count counters per (store, channel) (``instrumented_submit``), and
the slot cache counts its hits and misses. Left out: the slot remap that
a live migration installs (``set_remap``, ROADMAP A13).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from ..system.customer import Customer
from ..system.message import INVALID_TIME, FilterSpec, Task
from ..telemetry import registry as telemetry_registry
from ..telemetry.instruments import cached_kvops_instruments as _dir_tel
from ..utils import crc32c
from ..utils.murmur import hash_slots
from ..utils.range import Range


class Parameter(Customer):
    def __init__(self, id: Optional[int] = None, name: str = ""):
        super().__init__(id=id, name=name)
        # push/pull telemetry: latency histograms and key-volume
        # counters per (store, channel), decided here
        self._tel = None
        if telemetry_registry.enabled():
            from ..telemetry.instruments import parameter_instruments

            self._tel = parameter_instruments(telemetry_registry.default_registry())

    def instrumented_submit(self, kind: str, channel, num_keys: int, step,
                            task: Optional[Task] = None, callback=None) -> int:
        """Submit a push/pull step with latency and key-count telemetry.
        The latency is submit to finished (queueing, run and the wait for
        its device work), observed from the executor's completion
        callback; ``callback`` still fires after it. ``kind`` is "push"
        or "pull"."""
        tel = self._tel
        if tel is None:
            return self.submit(step, task, callback)
        ch = str(channel)
        tel[f"{kind}_keys"].labels(store=self.name, channel=ch).inc(max(0, int(num_keys)))
        hist = tel[f"{kind}_latency"].labels(store=self.name, channel=ch)
        t0 = time.perf_counter()

        def record_then(cb=callback):
            hist.observe(time.perf_counter() - t0)
            if cb is not None:
                cb()

        return self.submit(step, task, record_then)

    @staticmethod
    def request(channel: int = 0, ts: int = INVALID_TIME, wait: Sequence[int] = (),
                filters: Sequence[FilterSpec] = (), key_range: Optional[Range] = None) -> Task:
        """Build a request task (ref Parameter::Request, parameter.h:24)."""
        return Task(
            request=True,
            time=ts,
            wait_time=list(wait),
            key_channel=channel,
            key_range=key_range if key_range is not None else Range.all(),
            filters=list(filters),
        )

    # -- replica hooks (ref parameter.h SetReplica/GetReplica/Recover) --

    def get_replica(self) -> dict:
        """Snapshot of server-shard state for backup (overridden)."""
        return {}

    def set_replica(self, snapshot: dict) -> None:
        pass

    def get_replica_consistent(self) -> "tuple[dict, dict]":
        """``(snapshot, barrier)``: a snapshot safe under concurrent
        submissions and, per channel, the executor timestamp it was taken
        at. Stores with a submitted snapshot step override this
        (KVVector); this fallback is ``get_replica`` with no barrier,
        correct only for quiesced callers."""
        return self.get_replica(), {}

    def recover(self, snapshot: dict) -> None:
        self.set_replica(snapshot)


class KeyDirectory:
    """Host-side key → slot mapping for one channel.

    **Exact directories require sorted unique keys**: slot lookup is
    ``np.searchsorted``, which silently mismatches on unsorted input.
    The constructor raises on violations; ``KVVector.set_keys`` sorts
    and de-duplicates first.

    **Slot cache** (:meth:`slots_device`): a repeated key set skips the
    hash or searchsorted pass and the host → device index upload (the
    hot replica's refresh and a training push stream repeat theirs).
    Entries are keyed by a crc32c prefix signature and verified against
    a retained copy of the keys, so a signature collision never serves
    wrong slots. LRU over ``CACHE_SLOTS`` entries, behind a lock. The
    host :meth:`slots` maps every call afresh (the JAX package caches it
    too): the linear worker's batches rarely repeat a key set, and a
    cache miss copies the keys.

    ``hashed`` defaults to True here (the JAX package's default is
    False): the port's hashed directory came first, and its callers
    name no mode. An exact directory is one given ``keys`` and
    ``hashed=False``.
    """

    MAX_SIG_LEN = 2048
    CACHE_SLOTS = 8

    def __init__(self, num_slots: int, keys: Optional[np.ndarray] = None, hashed: bool = True):
        self.num_slots = int(num_slots)
        self.hashed = hashed
        self.keys = None if keys is None else np.asarray(keys, dtype=np.int64)
        if self.keys is not None and len(self.keys) > num_slots:
            raise ValueError(f"{len(self.keys)} keys exceed {num_slots} slots")
        if self.keys is not None and len(self.keys) > 1:
            d = np.diff(self.keys)
            if not (d > 0).all():
                kind = "unsorted" if (d < 0).any() else "duplicate"
                raise ValueError(
                    f"exact KeyDirectory requires sorted unique keys ({kind} input): "
                    "searchsorted would silently map keys to wrong slots — np.unique the "
                    "key set first"
                )
        # sig -> [keys_copy, slots, {device: slots tensor}]; MRU at the end
        self._slot_cache: "OrderedDict[tuple, list]" = OrderedDict()  # guarded-by: _slot_cache_lock
        self._slot_cache_lock = threading.Lock()

    def set_remap(self, perm: np.ndarray) -> None:
        raise NotImplementedError(
            "KeyDirectory.set_remap (the slot permutation a live migration installs) is not "
            "ported (ROADMAP A13)"
        )

    def _signature(self, keys: np.ndarray) -> tuple:
        return (crc32c.array_signature(keys, self.MAX_SIG_LEN), keys.shape[0], keys.dtype.str)

    def _cache_entry(self, keys: np.ndarray) -> list:
        sig = self._signature(keys)
        tel = _dir_tel()
        with self._slot_cache_lock:
            entry = self._slot_cache.get(sig)
            if entry is not None and np.array_equal(keys, entry[0]):
                self._slot_cache.move_to_end(sig)
                if tel is not None:
                    tel["slot_cache_hits"].inc()
                return entry
        if tel is not None:
            tel["slot_cache_misses"].inc()
        # computed outside the lock: the hash pass must not serialize callers
        entry = [np.array(keys, copy=True), self._compute_slots(keys), {}]
        with self._slot_cache_lock:
            self._slot_cache[sig] = entry
            self._slot_cache.move_to_end(sig)
            while len(self._slot_cache) > self.CACHE_SLOTS:
                self._slot_cache.popitem(last=False)
        return entry

    def _compute_slots(self, keys: np.ndarray) -> np.ndarray:
        if self.hashed:
            return hash_slots(keys, self.num_slots)
        if self.keys is None:
            raise ValueError("an exact KeyDirectory needs its keys (KVVector.set_keys)")
        pos = np.searchsorted(self.keys, keys)
        if not len(self.keys):
            return np.full(len(keys), self.num_slots, dtype=np.int32)
        posc = np.minimum(pos, len(self.keys) - 1)
        hit = (pos < len(self.keys)) & (self.keys[posc] == keys)
        return np.where(hit, pos, self.num_slots).astype(np.int32)

    def slots(self, keys: np.ndarray) -> np.ndarray:
        """Map global keys to dense int32 slot ids; misses map to the
        sentinel slot ``num_slots`` (dropped by the ownership mask)."""
        return self._compute_slots(np.asarray(keys))

    def slots_device(self, keys: np.ndarray, device) -> torch.Tensor:
        """:meth:`slots` as an int32 tensor on ``device``, cached: a
        repeated key set skips the host → device index upload too."""
        entry = self._cache_entry(np.asarray(keys))
        device = torch.device(device)
        with self._slot_cache_lock:
            t = entry[2].get(device)
        if t is None:
            t = torch.from_numpy(entry[1]).to(device)
            with self._slot_cache_lock:
                entry[2][device] = t
        return t


def pad_slots(num_slots: int, num_shards: int) -> int:
    """Round slots up so every server shard is equal-sized."""
    per = -(-num_slots // num_shards)
    return per * num_shards
