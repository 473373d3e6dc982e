"""Staged host ingest: read and filter on a feeder thread, prep on an
ordered pool of workers.

Counterpart of ``IngestPipeline`` in the JAX package's
``learner/ingest.py``, with its telemetry (the ``ps_ingest_*`` stage
times, queue depth and volume, and one flow a batch through the stage
spans while a span sink is installed), without its fault point::

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

import time
from typing import Callable, Iterator, Optional

from ..telemetry import spans as telemetry_spans
from ..utils.concurrent import OrderedStagePool, iter_on_thread


def pipeline_instruments():
    """ps_ingest_* instruments against the process registry, or None
    while telemetry is disabled."""
    from ..telemetry import registry as telemetry_registry

    if not telemetry_registry.enabled():
        return None
    from ..telemetry.instruments import ingest_instruments

    return ingest_instruments(telemetry_registry.default_registry())


class IngestPipeline:
    """``filter_fn`` (optional) runs on the feeder in batch order;
    ``prep_fn`` (optional) on ``workers`` pool threads, emitted in
    order. With no ``prep_fn`` or no workers it is one prefetching
    thread (read, filter and prep in turn).

    Lifecycle: ``start()`` is idempotent, iterating before it raises,
    ``start()`` after ``close()`` raises; ``close()`` joins every thread
    and runs when the iteration ends. Usable as a context manager."""

    def __init__(
        self,
        source,
        *,
        filter_fn: Optional[Callable] = None,
        prep_fn: Optional[Callable] = None,
        workers: int = 0,
        capacity: int = 4,
        name: str = "ingest",
    ):
        self._source = iter(source)
        self._filter_fn = filter_fn
        self._prep_fn = prep_fn
        self._workers = max(0, int(workers))
        self._capacity = max(1, int(capacity))
        self._name = name
        self._tel = pipeline_instruments()
        # Single-consumer lifecycle state — deliberately lock-free (in
        # pslint's lock-pass scope, nothing guarded): start()/__iter__/
        # close() all run on the consumer thread; the pool and thread
        # iterator own their cross-thread synchronization internally.
        self._pool: Optional[OrderedStagePool] = None
        self._thread_it = None
        self._it: Optional[Iterator] = None
        self._closed = False
        # timeline tracing (telemetry/timeline.py): decided once at
        # start() — when a span sink is installed, every batch gets a
        # flow id on the feeder and rides it through filter → prep →
        # the consumer (items travel internally as (flow, batch) pairs;
        # the consumer-facing iterator unwraps). Off = zero overhead.
        self._trace = False

    # -- stage bodies --------------------------------------------------

    def _observe(self, stage: str, seconds: float) -> None:
        if self._tel is not None:
            self._tel["stage_seconds"].labels(stage=stage).observe(seconds)

    def _produced(self) -> Iterator:
        """Feeder-side serial stages: read (source next) + filter.
        When tracing, each batch is born here with a flow id and every
        stage span carries it — items flow on as (flow, batch)."""
        src = self._source
        while True:
            t_wall = time.time()
            t0 = time.perf_counter()
            try:
                batch = next(src)
            except StopIteration:
                return
            read_s = time.perf_counter() - t0
            self._observe("read", read_s)
            fid = None
            if self._trace:
                fid = telemetry_spans.new_flow()
                telemetry_spans.emit(
                    {
                        "kind": "span",
                        "name": "ingest.read",
                        "pipeline": self._name,
                        "t_wall": t_wall,
                        "dur_s": read_s,
                        "flow": fid,
                    }
                )
            if self._filter_fn is not None:
                if self._trace:
                    with telemetry_spans.flow_scope(fid):
                        with telemetry_spans.span(
                            "ingest.filter", pipeline=self._name
                        ):
                            t0 = time.perf_counter()
                            batch = self._filter_fn(batch)
                            self._observe(
                                "filter", time.perf_counter() - t0
                            )
                else:
                    t0 = time.perf_counter()
                    batch = self._filter_fn(batch)
                    self._observe("filter", time.perf_counter() - t0)
            yield (fid, batch) if self._trace else batch

    def _prep(self, item):
        if self._trace:
            fid, batch = item
            with telemetry_spans.flow_scope(fid):
                with telemetry_spans.span(
                    "ingest.prep", pipeline=self._name
                ):
                    t0 = time.perf_counter()
                    out = self._prep_fn(batch)
                    self._observe("prep", time.perf_counter() - t0)
            return fid, out
        t0 = time.perf_counter()
        out = self._prep_fn(item)
        self._observe("prep", time.perf_counter() - t0)
        return out

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "IngestPipeline":
        """Idempotent: build and start the pipeline threads once."""
        if self._closed:
            raise RuntimeError(f"{self._name}: start() after close()")
        if self._it is not None:
            return self
        self._trace = telemetry_spans.get_sink() is not None
        if self._prep_fn is not None and self._workers > 0:
            self._pool = OrderedStagePool(
                self._prep,
                self._produced(),
                num_workers=self._workers,
                capacity=self._capacity,
                name=self._name,
            ).start()
            self._it = iter(self._pool)
        else:
            # single producer thread: read + filter (+ prep, serially)
            src = (
                map(self._prep, self._produced())
                if self._prep_fn is not None
                else self._produced()
            )
            self._thread_it = iter_on_thread(src, maxsize=self._capacity)
            self._it = self._thread_it
        return self

    @property
    def started(self) -> bool:
        return self._it is not None

    def qsize(self) -> int:
        """Batches staged ahead of the consumer (0 before start)."""
        return self._pool.qsize() if self._pool is not None else 0

    def __iter__(self) -> Iterator:
        if self._it is None:
            raise RuntimeError(
                f"{self._name}: iterated before start() — call start() "
                "first (or use the pipeline as a context manager)"
            )
        tel = self._tel
        try:
            for item in self._it:
                # tracing wraps items as (flow, batch) internally; the
                # consumer sees the bare batch, with the batch's flow
                # active on its thread until it advances to the next
                # item (so a downstream stage's spans correlate)
                fid = None
                if self._trace:
                    fid, item = item
                if tel is not None:
                    tel["queue_depth"].labels(queue=self._name).set(
                        self.qsize()
                    )
                    # volume counters only for batch-shaped items; a
                    # pipeline emitting groups/parts leaves counting to
                    # the downstream stage (DeviceUploader) so batches
                    # are never double-counted
                    n = getattr(item, "n", None) or getattr(
                        item, "num_examples", None
                    )
                    if n:
                        tel["batches"].labels(pipeline=self._name).inc()
                        tel["examples"].labels(pipeline=self._name).inc(
                            int(n)
                        )
                with telemetry_spans.flow_scope(fid):
                    yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop and join every pipeline thread; safe to call twice."""
        self._closed = True
        if self._pool is not None:
            self._pool.close()
        if self._thread_it is not None:
            self._thread_it.close()

    def __enter__(self) -> "IngestPipeline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
