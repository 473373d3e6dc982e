"""SGD learner pieces: the progress record, the tail-feature filter and
the minibatch reader.

Counterparts of ``SGDProgress``, ``apply_tail_filter`` and
``MinibatchReader`` in the JAX package's ``learner/sgd.py``. The reader
reads and filters on an :class:`~.ingest.IngestPipeline` feeder thread,
as the JAX reader does: the (stateful) filter stays serial, in batch
order, so both yield the same batches in the same order. Files are read
on the chunked byte path (``StreamReader.minibatches_bytes``), parsed by
the native library on a small pool. The monitor and scheduler plumbing
is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

from ..data.stream_reader import StreamReader
from ..filter.frequency import FrequencyFilter
from ..utils.localizer import Localizer
from ..utils.sparse import SparseBatch
from .ingest import IngestPipeline


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
    tail-feature filter when one is set, read and filtered on a feeder
    thread behind a bounded queue (``capacity`` batches).

    Lifecycle (enforced): :meth:`init_filter` before :meth:`start`,
    :meth:`start` (idempotent) before reading, no reading after
    :meth:`close`, which joins the feeder. Usable as a context manager."""

    def __init__(
        self,
        files: Optional[List[str]] = None,
        minibatch_size: int = 1000,
        data_format: str = "libsvm",
        capacity: int = 16,
        batches: Optional[Iterator[SparseBatch]] = None,
    ):
        self._source = batches
        if self._source is None:
            # line-aligned byte chunks parsed by the GIL-releasing native
            # parser on two threads (the line path for other formats);
            # the same batches as minibatches()
            self._source = StreamReader(files or [], data_format).minibatches_bytes(
                minibatch_size, threads=2
            )
        self._filter: Optional[FrequencyFilter] = None
        self._freq = 0
        self._capacity = capacity
        self._pipe: Optional[IngestPipeline] = None
        self._it: Optional[Iterator[SparseBatch]] = None
        self._closed = False

    def init_filter(self, n: int, k: int, freq: int) -> None:
        """Count-min tail-feature filter with ``n`` buckets per row and
        ``k`` rows, keeping keys seen at least ``freq`` times."""
        if self._pipe is not None:
            raise RuntimeError("init_filter() after start()")
        self._filter = FrequencyFilter(n, k)
        self._freq = freq

    def start(self) -> "MinibatchReader":
        """Start the feeder thread; a second call does nothing."""
        if self._closed:
            raise RuntimeError("MinibatchReader.start() after close()")
        if self._pipe is not None:
            return self
        filter_fn = None
        if self._filter is not None and self._freq > 0:
            filt, freq = self._filter, self._freq

            def filter_fn(b):
                return apply_tail_filter(b, filt, freq)

        self._pipe = IngestPipeline(self._source, filter_fn=filter_fn,
                                    capacity=self._capacity, name="minibatch_reader").start()
        self._it = iter(self._pipe)
        return self

    def read(self) -> Optional[SparseBatch]:
        """The next minibatch with tail features dropped, or None at the
        end of the stream; re-raises the feeder's exception."""
        if self._pipe is None:
            raise RuntimeError(
                "MinibatchReader.read() before start(): call start() "
                "first, or use the reader as a context manager"
            )
        if self._closed:
            raise RuntimeError("MinibatchReader.read() after close()")
        return next(self._it, None)

    def close(self) -> None:
        """Stop the pipeline and join the feeder; idempotent."""
        self._closed = True
        if self._pipe is not None:
            self._pipe.close()

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
