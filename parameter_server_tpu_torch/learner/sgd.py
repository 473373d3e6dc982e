"""SGD learner pieces: the progress record, the tail-feature filter and
the minibatch reader.

Counterparts of ``SGDProgress``, ``apply_tail_filter`` and
``MinibatchReader`` in the JAX package's ``learner/sgd.py``. The reader
runs on the caller's thread: the JAX reader reads and filters on an
``IngestPipeline`` feeder thread, which keeps the (stateful) filter
stage serial, so both yield the same batches in the same order. The
monitor and scheduler plumbing is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

from ..data.stream_reader import StreamReader
from ..filter.frequency import FrequencyFilter
from ..utils.localizer import Localizer
from ..utils.sparse import SparseBatch


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


def apply_tail_filter(batch: SparseBatch, filter_: FrequencyFilter, freq: int) -> SparseBatch:
    """One batch through the count-min tail-feature filter: insert this
    batch's unique keys with their counts, then drop the entries whose
    estimated frequency is below ``freq``. Stateful: batches must pass
    in stream order. Keys stay global."""
    loc = Localizer()
    keys, cnt = loc.count_uniq_index(batch)
    filter_.insert_keys(keys, cnt)
    keep = filter_.query_keys(keys, freq)
    local = loc.remap_index(keep)
    local.indices = keep[local.indices]
    local.num_cols = batch.num_cols
    return local


class MinibatchReader:
    """Minibatches from files (or a given iterator), through the
    tail-feature filter when one is set.

    Lifecycle (enforced): :meth:`init_filter` before :meth:`start`,
    :meth:`start` (idempotent) before reading, no reading after
    :meth:`close`. Usable as a context manager."""

    def __init__(
        self,
        files: Optional[List[str]] = None,
        minibatch_size: int = 1000,
        data_format: str = "libsvm",
        batches: Optional[Iterator[SparseBatch]] = None,
    ):
        self._source = batches
        if self._source is None:
            self._source = StreamReader(files or [], data_format).minibatches(minibatch_size)
        self._filter: Optional[FrequencyFilter] = None
        self._freq = 0
        self._started = False
        self._closed = False

    def init_filter(self, n: int, k: int, freq: int) -> None:
        """Count-min tail-feature filter with ``n`` buckets per row and
        ``k`` rows, keeping keys seen at least ``freq`` times."""
        if self._started:
            raise RuntimeError("init_filter() after start()")
        self._filter = FrequencyFilter(n, k)
        self._freq = freq

    def start(self) -> "MinibatchReader":
        if self._closed:
            raise RuntimeError("MinibatchReader.start() after close()")
        self._started = True
        return self

    def read(self) -> Optional[SparseBatch]:
        """The next minibatch with tail features dropped, or None at the
        end of the stream."""
        if not self._started:
            raise RuntimeError(
                "MinibatchReader.read() before start(): call start() "
                "first, or use the reader as a context manager"
            )
        if self._closed:
            raise RuntimeError("MinibatchReader.read() after close()")
        batch = next(self._source, None)
        if batch is not None and self._filter is not None and self._freq > 0:
            batch = apply_tail_filter(batch, self._filter, self._freq)
        return batch

    def close(self) -> None:
        """Stop reading; idempotent."""
        self._closed = True

    def __enter__(self) -> "MinibatchReader":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator[SparseBatch]:
        while True:
            b = self.read()
            if b is None:
                return
            yield b
