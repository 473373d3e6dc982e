"""Staged host ingest: read and filter on a feeder thread, prep on an
ordered pool of workers.

Counterpart of ``IngestPipeline`` in the JAX package's
``learner/ingest.py``, without its telemetry and fault point::

    read ──> filter ──> prep (N workers, ordered) ──> consumer
    (feeder thread,     (OrderedStagePool)            (the trainer, or
     serial, in order)                                 a DeviceUploader)

- read: the next batch of the source (the byte path's native parser
  runs inside it, on its own small pool, without the GIL);
- filter: stateful (the count-min tail filter inserts, then queries),
  so it runs serially on the feeder in batch order;
- prep: stateless per batch, fanned out over the pool; the pool emits
  in source order, so the consumer sees the serial path's stream.

An exception of any stage re-raises at the consumer at its position;
``close()`` joins every thread.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

from ..utils.concurrent import OrderedStagePool, iter_on_thread


class IngestPipeline:
    """``filter_fn`` (optional) runs on the feeder in batch order;
    ``prep_fn`` (optional) on ``workers`` pool threads, emitted in
    order. With no ``prep_fn`` or no workers it is one prefetching
    thread (read, filter and prep in turn).

    Lifecycle: ``start()`` is idempotent, iterating before it raises,
    ``start()`` after ``close()`` raises; ``close()`` joins every thread
    and runs when the iteration ends. Usable as a context manager."""

    def __init__(self, source, *, filter_fn: Optional[Callable] = None,
                 prep_fn: Optional[Callable] = None, workers: int = 0,
                 capacity: int = 4, name: str = "ingest"):
        self._source = iter(source)
        self._filter_fn = filter_fn
        self._prep_fn = prep_fn
        self._workers = max(0, int(workers))
        self._capacity = max(1, int(capacity))
        self._name = name
        # start()/__iter__/close() run on the consumer's thread; the pool
        # and the thread iterator synchronise across threads themselves
        self._pool: Optional[OrderedStagePool] = None
        self._thread_it = None
        self._it: Optional[Iterator] = None
        self._closed = False

    def _produced(self) -> Iterator:
        """The feeder's serial stages: read, then filter."""
        for batch in self._source:
            yield batch if self._filter_fn is None else self._filter_fn(batch)

    def start(self) -> "IngestPipeline":
        if self._closed:
            raise RuntimeError(f"{self._name}: start() after close()")
        if self._it is not None:
            return self
        if self._prep_fn is not None and self._workers > 0:
            self._pool = OrderedStagePool(self._prep_fn, self._produced(),
                                          num_workers=self._workers,
                                          capacity=self._capacity, name=self._name).start()
            self._it = iter(self._pool)
        else:
            src = self._produced()
            if self._prep_fn is not None:
                src = map(self._prep_fn, src)
            self._thread_it = iter_on_thread(src, maxsize=self._capacity)
            self._it = self._thread_it
        return self

    @property
    def started(self) -> bool:
        return self._it is not None

    def __iter__(self) -> Iterator:
        if self._it is None:
            raise RuntimeError(
                f"{self._name}: iterated before start(): call start() first "
                "(or use the pipeline as a context manager)"
            )
        try:
            yield from self._it
        finally:
            self.close()

    def close(self) -> None:
        """Stop and join every thread; idempotent."""
        self._closed = True
        if self._pool is not None:
            self._pool.close()
        if self._thread_it is not None:
            self._thread_it.close()

    def __enter__(self) -> "IngestPipeline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
