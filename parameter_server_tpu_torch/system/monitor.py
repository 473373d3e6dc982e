"""Progress monitoring (ref ``src/system/monitor.h``).

MonitorMaster collects typed progress reports from slavers and merges
them per node; MonitorSlaver pushes reports. The reference moves these
over messages on a timer (``monitor.h`` MonitorSlaver sends a
``Command::UPDATE`` task every second; the master merges on receipt);
this port keeps the direct-call path for single-process tests AND
offers the message-plane path: a slaver constructed ``over_van`` wraps
each report in a :class:`~parameter_server_tpu_torch.system.message.Message`
(``Command.EVALUATE_PROGRESS``) and ships it through the Van's real
transfer path — filter chains, serialization, byte accounting and the
``van.transfer`` fault point included — and ``start_periodic`` is the
reference's reporting timer.

Progress payloads on the message path must be plain data (dicts /
lists / numbers / numpy arrays): the wire header rides the restricted
unpickler (``message._restricted_loads``), which rejects arbitrary
classes by design.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Generic, Optional, TypeVar

from .message import Command, Message, Task

_LOG = logging.getLogger(__name__)

P = TypeVar("P")


class MonitorMaster(Generic[P]):
    def __init__(self, merger: Optional[Callable[[P, P], None]] = None):
        self._progress: Dict[str, P] = {}  # guarded-by: _lock
        self._merger = merger
        self._printer: Optional[Callable[[float, Dict[str, P]], None]] = None
        self._interval = 1.0
        self._lock = threading.Lock()
        self._start = time.time()
        # guarded-by: _lock — maybe_print used to read-then-write this
        # OUTSIDE the lock: two reporter threads racing the check could
        # both pass it and print the same window twice (pslint
        # guarded-access; regression test in tests/test_system_aux.py)
        self._last_print = 0.0
        # guarded-by: _lock — redelivery idempotence: highest report
        # seq merged per node. The over_van path is at-least-once (a
        # dropped frame is retransmitted; a van `duplicate` fault
        # delivers one frame twice), and a re-merged progress delta
        # would double-count into cluster progress — so a seq at or
        # below the high-water mark is dropped, not merged.
        self._seq: Dict[str, int] = {}
        self._dup_dropped = 0  # guarded-by: _lock

    def set_data_merger(self, fn: Optional[Callable[[P, P], None]]) -> None:
        self._merger = fn

    def set_printer(self, fn: Callable[[float, Dict[str, P]], None], interval: float = 1.0) -> None:
        self._printer = fn
        self._interval = interval

    def report(
        self, node_id: str, progress: P, seq: Optional[int] = None
    ) -> bool:
        """Merge one report; returns False when the seq guard rejected
        it as a redelivery (``seq`` <= the node's high-water mark).
        Direct in-process callers pass no seq and merge unconditionally
        — exactly-once is their call discipline, not the wire's."""
        with self._lock:
            if seq is not None:
                if seq <= self._seq.get(node_id, -1):
                    self._dup_dropped += 1
                    return False
                self._seq[node_id] = seq
            cur = self._progress.get(node_id)
            if cur is None or self._merger is None:
                self._progress[node_id] = progress
            else:
                self._merger(progress, cur)
        self.maybe_print()
        return True

    def duplicates_dropped(self) -> int:
        """Reports the seq guard rejected (redelivery accounting)."""
        with self._lock:
            return self._dup_dropped

    def handle_message(self, msg: Message) -> bool:
        """Receiver side of the message-plane path: unwrap one slaver
        report (``task.payload = {"node": id, "progress": P, "seq":
        n}``) and merge it like a direct call — through the seq guard,
        because this path really does redeliver (van `duplicate`)."""
        payload = msg.task.payload or {}
        return self.report(
            payload["node"], payload["progress"], seq=payload.get("seq")
        )

    def maybe_print(self, force: bool = False) -> None:
        if self._printer is None:
            return
        now = time.time()
        # check-and-claim the print window atomically: the snapshot is
        # taken in the same critical section, the (potentially slow)
        # printer runs outside it
        with self._lock:
            if not force and now - self._last_print < self._interval:
                return
            self._last_print = now
            snapshot = dict(self._progress)
        self._printer(now - self._start, snapshot)

    def progress(self) -> Dict[str, P]:
        with self._lock:
            return dict(self._progress)


class MonitorSlaver(Generic[P]):
    """Node-side reporter.

    ``wire`` is the transport: None (default) calls the master
    directly — the single-process test path; a callable ships the
    wrapped Message (see :meth:`over_van`). ``start_periodic`` reports
    ``progress_fn()`` on a timer like the reference's monitor thread.
    """

    def __init__(
        self,
        master: Optional[MonitorMaster[P]],
        node_id: str,
        wire: Optional[Callable[[Message], None]] = None,
    ):
        self.master = master
        self.node_id = node_id
        self.wire = wire
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guarded-by: _seq_lock — wire-path report sequence (the
        # master's redelivery guard keys on it); the periodic timer and
        # a manual report() may race, so the stamp is lock-claimed
        self._seq = 0
        self._seq_lock = threading.Lock()

    @classmethod
    def over_van(
        cls,
        master: MonitorMaster[P],
        node_id: str,
        van,
        master_id: str = "H0",
        max_attempts: int = 3,
    ) -> "MonitorSlaver[P]":
        """A slaver whose reports ride ``van.transfer`` between a fresh
        RemoteNode endpoint pair (node → scheduler), landing in
        ``master.handle_message`` — the reference's report-over-message
        flow inside one process.

        At-least-once hardening: delivery happens at the
        receiving endpoint's DECODE (``from_wire``), so a van
        ``duplicate`` fault — one frame decoded twice — really does
        redeliver into the master (whose seq guard dedupes it), and a
        ``drop`` fault (FaultError before decode) is retransmitted up
        to ``max_attempts`` times with the SAME seq instead of losing
        the report. Exactly the failure semantics a real wire has, with
        the master idempotent under them (tests/test_system_aux.py).
        """
        from .remote_node import RemoteNode

        class _Delivering(RemoteNode):
            """Receiver endpoint that delivers each decoded report
            frame to the master — at-least-once means delivery count
            == decode count, not transfer-return count."""

            def from_wire(self, blob: bytes) -> Message:
                out = super().from_wire(blob)
                if out.task.cmd == Command.EVALUATE_PROGRESS:
                    master.handle_message(out)
                return out

        tx, rx = RemoteNode(master_id), _Delivering(node_id)

        def wire(msg: Message) -> None:
            from . import faults as faults_mod

            last: Optional[BaseException] = None
            for _ in range(max(1, max_attempts)):
                try:
                    van.transfer(tx, rx, msg)
                    return
                except faults_mod.FaultError as e:
                    # injected drop: the frame died before decode —
                    # retransmit the SAME message (same seq; a
                    # successful earlier delivery is impossible here,
                    # and a duplicated retransmit dedupes at the master)
                    last = e
            if last is not None:
                raise last

        return cls(master, node_id, wire=wire)

    def report(self, progress: P) -> None:
        if self.wire is not None:
            with self._seq_lock:
                self._seq += 1
                seq = self._seq
            self.wire(Message(
                task=Task(
                    cmd=Command.EVALUATE_PROGRESS,
                    payload={
                        "node": self.node_id,
                        "progress": progress,
                        "seq": seq,
                    },
                ),
                sender=self.node_id,
                recver="H0",
            ))
        elif self.master is not None:
            self.master.report(self.node_id, progress)

    # -- the reporting timer (ref monitor.h: slaver reports every sec) --

    def start_periodic(
        self, progress_fn: Callable[[], P], interval: float = 1.0
    ) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.report(progress_fn())
                except Exception:  # noqa: BLE001 — a dropped frame (the
                    # van.transfer fault point) or transient wire error
                    # loses ONE report; the timer must survive to send
                    # the next, else the master's view silently freezes
                    _LOG.exception(
                        "monitor report from %s failed", self.node_id
                    )

        self._thread = threading.Thread(
            target=loop, daemon=True, name=f"monitor-{self.node_id}"
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
