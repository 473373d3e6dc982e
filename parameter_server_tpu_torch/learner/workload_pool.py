"""Workload pool: file workloads handed to a computation node.

Counterpart of ``parameter_server_tpu/learner/workload_pool.py`` (the
reference's ``WorkloadPool``): a workload is cut into one piece per file
pattern per pass, ``replica`` passes (``num_data_pass``), the patterns
of each pass reordered with Python's ``random`` when ``shuffle`` is set,
as the JAX package does; ``assign`` hands the next unassigned,
unfinished piece out, ``finish`` marks one done and ``restore``
re-queues the unfinished pieces of a node declared dead (the recovery
coordinator's worker handler, ``system/recovery.py``). Thread-safe.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import List, Optional


@dataclasses.dataclass
class Workload:
    """A piece of work (the reference's workload.proto): its files, id,
    replica count (passes), shuffle flag, and the ids of its finished
    pieces."""

    files: List[str] = dataclasses.field(default_factory=list)
    id: int = -1
    replica: int = 1
    shuffle: bool = False
    finished: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Info:
    node: str = ""
    load: Optional[Workload] = None
    assigned: bool = False
    finished: bool = False


class WorkloadPool:
    def __init__(self, load: Optional[Workload] = None):
        self._loads: List[_Info] = []  # guarded-by: _lock
        self._num_finished = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        if load is not None:
            self.set(load)

    def set(self, load: Workload) -> None:
        pieces = []
        for _ in range(max(1, load.replica)):
            files = list(load.files)
            if load.shuffle:
                random.shuffle(files)
            pieces.extend(files)
        with self._lock:
            self._loads = [_Info(load=Workload(files=[f], id=i)) for i, f in enumerate(pieces)]
            self._num_finished = 0

    def assign(self, node_id: str = "") -> Optional[Workload]:
        """The next unassigned, unfinished piece (now ``node_id``'s), or
        None when there is none."""
        with self._lock:
            for info in self._loads:
                if not info.assigned and not info.finished:
                    info.assigned = True
                    info.node = node_id
                    return info.load
        return None

    def restore(self, node_id: str) -> None:
        """Re-queue the unfinished pieces of a dead node."""
        with self._lock:
            for info in self._loads:
                if info.node == node_id and info.assigned and not info.finished:
                    info.assigned = False
                    info.node = ""

    def finish(self, load_id: int) -> None:
        with self._lock:
            for info in self._loads:
                if info.load is not None and info.load.id == load_id and not info.finished:
                    info.finished = True
                    self._num_finished += 1
                    self._done.notify_all()
                    return

    def num_pending(self) -> int:
        with self._lock:
            return len(self._loads) - self._num_finished

    def wait_until_done(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            return self._done.wait_for(
                lambda: self._num_finished == len(self._loads), timeout=timeout)
