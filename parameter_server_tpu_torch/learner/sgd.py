"""Training progress record, as ``SGDProgress`` in the JAX package's
``learner/sgd.py`` (the monitor and scheduler plumbing is not ported)."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class SGDProgress:
    objective: List[float] = dataclasses.field(default_factory=list)
    num_examples_processed: int = 0
    accuracy: List[float] = dataclasses.field(default_factory=list)
    auc: List[float] = dataclasses.field(default_factory=list)

    def merge(self, other: "SGDProgress") -> None:
        self.objective.extend(other.objective)
        self.accuracy.extend(other.accuracy)
        self.auc.extend(other.auc)
        self.num_examples_processed += other.num_examples_processed
