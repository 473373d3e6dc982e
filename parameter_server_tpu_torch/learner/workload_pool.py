"""Workload pool: file workloads handed to a computation node.

Counterpart of ``parameter_server_tpu/learner/workload_pool.py`` (the
reference's ``WorkloadPool``): a workload is cut into one piece per file
pattern per pass, ``replica`` passes (``num_data_pass``), the patterns
of each pass reordered with Python's ``random`` when ``shuffle`` is set,
as the JAX package does; ``assign`` hands the pieces out in order. One
node takes them all here: sharing pieces among nodes, and re-queueing a
dead node's, wait for the system layer (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional


@dataclasses.dataclass
class Workload:
    files: List[str] = dataclasses.field(default_factory=list)
    id: int = -1
    replica: int = 1
    shuffle: bool = False


class WorkloadPool:
    def __init__(self, load: Optional[Workload] = None):
        self._loads: List[Workload] = []
        self._next = 0
        if load is not None:
            self.set(load)

    def set(self, load: Workload) -> None:
        pieces = []
        for _ in range(max(1, load.replica)):
            files = list(load.files)
            if load.shuffle:
                random.shuffle(files)
            pieces.extend(files)
        self._loads = [Workload(files=[f], id=i) for i, f in enumerate(pieces)]
        self._next = 0

    def assign(self) -> Optional[Workload]:
        """The next piece, or None when all are handed out."""
        if self._next >= len(self._loads):
            return None
        self._next += 1
        return self._loads[self._next - 1]
