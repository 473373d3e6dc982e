"""Host-side concurrency primitives: queues, producers, an ordered pool.

Counterparts of ``ThreadsafeQueue``, ``ProducerConsumer``,
``OrderedStagePool`` and ``iter_on_thread`` in the JAX package's
``utils/concurrent.py`` (the reference's ``threadsafe_queue.h`` and
``producer_consumer.h``). They keep the host busy while the card runs:
reading, parsing, filtering and prepping minibatches on threads.

Two contracts hold for every producer here: an exception raised on a
producer thread re-raises at the consumer, at the position it occurred;
and ``close()`` (or the end of the consumer's iteration) stops and joins
every thread, so a consumer that leaves early leaves no thread blocked in
a ``put``. The join is bounded: a thread wedged inside its source (a
stuck read) cannot be interrupted and is left to daemon teardown. A
stream that dies on the pool leaves an ``abandoned`` tombstone span in
the timeline where it died.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Generic, Iterator, Optional, TypeVar

from ..telemetry import spans as telemetry_spans

T = TypeVar("T")


class ThreadsafeQueue(Generic[T]):
    """Unbounded thread-safe FIFO."""

    def __init__(self) -> None:
        self._q: "queue.Queue[T]" = queue.Queue()

    def push(self, item: T) -> None:
        self._q.put(item)

    def wait_and_pop(self, timeout: Optional[float] = None) -> T:
        return self._q.get(timeout=timeout)

    def try_pop(self) -> Optional[T]:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def empty(self) -> bool:
        return self._q.empty()


def _stoppable_put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put ``item``, waking every 0.2 s to check ``stop``; False when
    stopped before the item went in."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


class _ProducerError:
    """A producer's exception on its way through the queue."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class ProducerConsumer(Generic[T]):
    """Bounded producer/consumer: ``start_producer(produce)`` runs
    ``produce`` (the next item, or None at the end) on its own threads;
    ``pop()`` blocks until an item or the end (None, on every later call
    too). A producer's exception re-raises at ``pop()``, and on every
    ``pop()`` after it."""

    _END = object()

    def __init__(self, capacity: int = 16):
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._threads: list = []
        self._live = 0  # producers still running; guarded by _live_lock
        self._live_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None

    def start_producer(self, produce: Callable[[], Optional[T]], num_threads: int = 1) -> None:
        """With ``num_threads`` > 1 the producers drain one source at once
        (``produce`` must be thread-safe) and the order is unspecified."""
        with self._live_lock:
            self._live = num_threads

        def run():
            try:
                while not self._stop.is_set():
                    item = produce()
                    if item is None:
                        break
                    if not _stoppable_put(self._q, item, self._stop):
                        return
            except BaseException as e:  # forwarded to the consumer
                _stoppable_put(self._q, _ProducerError(e), self._stop)
                return
            with self._live_lock:
                self._live -= 1
                if self._live == 0:
                    _stoppable_put(self._q, self._END, self._stop)

        for _ in range(num_threads):
            t = threading.Thread(target=run, daemon=True)
            self._threads.append(t)
            t.start()

    def pop(self) -> Optional[T]:
        if self._error is not None:
            raise self._error
        item = self._q.get()
        if item is self._END:
            # put back: every later pop sees the end too (END goes in only
            # once all producers are done, so no producer races this slot)
            self._q.put(self._END)
            return None
        if isinstance(item, _ProducerError):
            self._error = item.exc
            raise item.exc
        return item

    def __iter__(self) -> Iterator[T]:
        while True:
            item = self.pop()
            if item is None:
                return
            yield item

    def close(self, join_s: float = 2.5) -> None:
        """Stop the producers and join their threads (bounded)."""
        self._stop.set()
        deadline = time.monotonic() + max(0.0, join_s)
        while time.monotonic() < deadline and any(t.is_alive() for t in self._threads):
            try:  # a producer blocked in put wakes at its next tick
                self._q.get_nowait()
            except queue.Empty:
                pass
            for t in self._threads:
                t.join(timeout=0.05)


class _Slot:
    """One in-flight item of an :class:`OrderedStagePool`: its place in
    the emission order, filled by whichever worker takes it."""

    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None


class OrderedStagePool(Generic[T]):
    """``num_workers`` threads apply ``fn`` to the items of ``source``;
    the results come out IN SOURCE ORDER.

    A feeder thread iterates ``source`` (so a slow source runs off the
    consumer's thread too) and gives each item a slot, which enters the
    bounded output queue in source order before any worker sees the
    item; workers fill slots as they finish. ``capacity`` (default twice
    the workers) bounds the items in flight, so the feeder cannot race
    ahead of the consumer.

    An exception of ``source`` ends the stream and re-raises at the
    consumer after the items before it; an exception of ``fn`` on item k
    re-raises when the consumer reaches item k. ``close()``, also called
    when the consumer's iteration ends or is abandoned, stops and joins
    the feeder and the workers."""

    _END = object()
    _WSTOP = object()

    def __init__(self, fn: Callable[[T], object], source, num_workers: int = 2,
                 capacity: Optional[int] = None, name: str = "stage",
                 close_join_s: float = 2.5):
        self._fn = fn
        self._source = iter(source)
        self._num = max(1, int(num_workers))
        self._capacity = max(1, int(capacity if capacity is not None else 2 * self._num))
        self._name = name
        self._close_join_s = close_join_s
        self._out_q: "queue.Queue" = queue.Queue(maxsize=self._capacity)
        self._work_q: "queue.Queue" = queue.Queue(maxsize=self._capacity)
        self._stop = threading.Event()
        self._threads: list = []
        self._started = False

    def _feed(self) -> None:
        try:
            for item in self._source:
                slot = _Slot()
                # the output queue first: the slot takes its place in the
                # emission order before a worker can touch it
                if not _stoppable_put(self._out_q, slot, self._stop):
                    return
                if not _stoppable_put(self._work_q, (item, slot), self._stop):
                    return
            _stoppable_put(self._out_q, self._END, self._stop)
        except BaseException as e:  # the source's error, in order
            # timeline terminator: the stream dies here
            telemetry_spans.abandoned(f"{self._name}.source", reason=type(e).__name__)
            slot = _Slot()
            slot.error = e
            slot.event.set()
            _stoppable_put(self._out_q, slot, self._stop)

    def _work(self) -> None:
        while True:
            task = self._work_q.get()
            if task is self._WSTOP:
                return
            item, slot = task
            if self._stop.is_set():
                slot.event.set()  # the consumer is gone: skip the work
                continue
            try:
                slot.value = self._fn(item)
            except BaseException as e:  # re-raised at the consumer
                # the pool abandons the item: a tombstone in the timeline
                telemetry_spans.abandoned(f"{self._name}.worker", reason=type(e).__name__)
                slot.error = e
            slot.event.set()

    def start(self) -> "OrderedStagePool[T]":
        """Start the feeder and the workers, once."""
        if self._started:
            return self
        self._started = True
        self._threads.append(threading.Thread(target=self._feed, daemon=True,
                                              name=f"{self._name}-feed"))
        self._threads += [threading.Thread(target=self._work, daemon=True,
                                           name=f"{self._name}-w{i}") for i in range(self._num)]
        for t in self._threads:
            t.start()
        return self

    def qsize(self) -> int:
        """Completed-or-in-progress items staged ahead of the consumer."""
        return self._out_q.qsize()

    def __iter__(self) -> Iterator:
        self.start()
        try:
            while True:
                slot = self._out_q.get()
                if slot is self._END:
                    return
                slot.event.wait()
                if slot.error is not None:
                    raise slot.error
                yield slot.value
        finally:
            self.close()

    def close(self) -> None:
        """Stop the feeder and the workers and join them (bounded);
        idempotent."""
        self._stop.set()
        deadline = time.monotonic() + max(0.0, self._close_join_s)
        workers = self._threads[1:]
        # one stop sentinel a worker; once stop is set a full work queue
        # drains fast (workers skip fn), so a short blocking put will do
        for _ in range(self._num):
            while time.monotonic() < deadline and any(t.is_alive() for t in workers):
                try:
                    self._work_q.put(self._WSTOP, timeout=0.05)
                    break
                except queue.Full:
                    continue
        while time.monotonic() < deadline and any(t.is_alive() for t in self._threads):
            # drain, so a feeder blocked in put wakes at its next tick...
            try:
                self._out_q.get_nowait()
            except queue.Empty:
                pass
            # ...and put an END back, so a consumer on another thread
            # blocked in get wakes instead of waiting on a drained slot
            try:
                self._out_q.put_nowait(self._END)
            except queue.Full:
                pass
            for t in self._threads:
                t.join(timeout=0.05)


def iter_on_thread(it, maxsize: int, close_join_s: float = 2.5):
    """Run iterator ``it`` on a daemon thread, started at the first
    ``next``, and yield its items through a bounded queue (the thread
    blocks once ``maxsize`` items wait). An exception of ``it`` re-raises
    at the consumer where it occurred. When the consumer stops early (an
    exception, a break, ``close()``), the thread is told to stop and
    joined within ``close_join_s``."""
    q: "queue.Queue" = queue.Queue(maxsize=maxsize)
    done = object()
    stop = threading.Event()

    def run():
        try:
            for x in it:
                if not _stoppable_put(q, x, stop):
                    return
            _stoppable_put(q, done, stop)
        except BaseException as e:  # forwarded to the consumer
            _stoppable_put(q, _ProducerError(e), stop)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is done:
                return
            if isinstance(x, _ProducerError):
                raise x.exc
            yield x
    finally:
        stop.set()
        deadline = time.monotonic() + max(0.0, close_join_s)
        while t.is_alive() and time.monotonic() < deadline:
            try:  # a producer blocked in put wakes at its next tick
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.1)
