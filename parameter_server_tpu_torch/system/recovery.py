"""Failure detection → recovery orchestration.

Counterpart of the reference manager's dead-node handling
(``src/system/manager.cc``: heartbeat timeouts surface dead nodes; the
scheduler then restores the dead worker's workloads —
``WorkloadPool::Restore`` — and has a replacement server ``Recover()``
from its replica). This module is that glue: a coordinator polls the
HeartbeatCollector and dispatches role-specific recovery callbacks
exactly once per dead node.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from ..telemetry import registry as telemetry_registry
from ..utils.retry import RetryPolicy, call_with_retry
from .heartbeat import HeartbeatCollector
from .manager import Node

_LOG = logging.getLogger(__name__)

#: the recommended handler retry for IDEMPOTENT handlers: a recovery
#: callback that fails transiently (the replacement shard mid-rebuild,
#: an executor briefly wedged) gets three attempts with jittered
#: exponential backoff before the failure is counted — a dead cluster
#: must never get deader because one handler hiccuped once. NOT the
#: default: retrying a partially-completed NON-idempotent handler
#: double-applies it (elastic.handle_server_death shrinks the cluster
#: twice for one death; a replay-based recover double-pushes), so a
#: handler must opt in by being safe to re-run from the top.
DEFAULT_HANDLER_RETRY = RetryPolicy(
    max_attempts=3, base_delay_s=0.05, max_delay_s=0.5
)


class RecoveryCoordinator:
    """Watches liveness and fires per-role recovery handlers.

    Typical wiring (see tests/test_recovery.py):

    - worker dead  → ``workload_pool.restore(node_id)`` so its unfinished
      file assignments go back to the pool for live workers;
    - server dead  → ``replica_manager.recover(parameter)`` on the
      replacement shard (or a CheckpointManager restore).
    """

    def __init__(
        self,
        collector: HeartbeatCollector,
        handler_retry: Optional[RetryPolicy] = None,
    ):
        self.collector = collector
        self._handlers: Dict[str, List[Callable[[str], None]]] = {
            Node.WORKER: [],
            Node.SERVER: [],
            Node.SCHEDULER: [],
        }
        #: retry policy for handler callbacks. None (the default) =
        #: single attempt, the safe choice for non-idempotent handlers
        #: (the pre-existing elastic/workload-pool wiring); pass
        #: DEFAULT_HANDLER_RETRY (or your own policy) for handlers
        #: that are safe to re-run from the top.
        self.handler_retry = handler_retry
        #: cluster context for the node-death diagnostic bundle: the
        #: owning AuxRuntime sets this to itself so the capture gets
        #: Van-fetched rings with staleness, the merged metrics
        #: snapshot, alert states and clock offsets — a standalone
        #: coordinator (drills, tests) captures process-local.
        self.bundle_context = None
        self._recovered: set = set()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # recovery telemetry (doc/OBSERVABILITY.md "Recovery"): deaths
        # by role, handler failures (post-retry), and the wall time of
        # each node's full recovery handling — RecoveryCoordinator.check
        # used to only LOG, leaving MTTR invisible to every snapshot
        self._tel = None
        if telemetry_registry.enabled():
            from ..telemetry.instruments import recovery_instruments

            self._tel = recovery_instruments(
                telemetry_registry.default_registry()
            )

    def on_worker_dead(self, cb: Callable[[str], None]) -> None:
        self._handlers[Node.WORKER].append(cb)

    def on_server_dead(self, cb: Callable[[str], None]) -> None:
        self._handlers[Node.SERVER].append(cb)

    def on_scheduler_dead(self, cb: Callable[[str], None]) -> None:
        self._handlers[Node.SCHEDULER].append(cb)

    @staticmethod
    def _role_of(node_id: str) -> str:
        return {"W": Node.WORKER, "S": Node.SERVER, "H": Node.SCHEDULER}.get(
            node_id[:1], Node.WORKER
        )

    def check(self, now: Optional[float] = None) -> List[str]:
        """One detection pass; returns nodes newly handled this call.

        When :attr:`handler_retry` is set (opt-in — the handler must
        be idempotent), each handler runs under that policy's jittered
        exponential backoff (utils/retry.py) and only a callback that
        exhausts its attempts counts as a failure; either way a
        failing callback never blocks the others (or other dead
        nodes)."""
        handled = []
        for nid in self.collector.dead_nodes(now):
            with self._lock:
                if nid in self._recovered:
                    continue
                self._recovered.add(nid)
            role = self._role_of(nid)
            _LOG.warning("node %s declared dead; running recovery", nid)
            if self._tel is not None:
                self._tel["deaths"].labels(role=role).inc()
            t0 = time.perf_counter()
            for cb in self._handlers[role]:
                try:
                    if self.handler_retry is None:
                        cb(nid)
                    else:
                        call_with_retry(
                            lambda: cb(nid),
                            self.handler_retry,
                            op=f"recovery handler for {nid}",
                            on_retry=lambda a, e, d: _LOG.warning(
                                "recovery handler for %s failed "
                                "(attempt %d, %s: %s); retrying in %.3fs",
                                nid, a + 1, type(e).__name__, e, d,
                            ),
                        )
                except Exception:  # noqa: BLE001 — keep recovering others
                    _LOG.exception("recovery handler failed for %s", nid)
                    if self._tel is not None:
                        self._tel["handler_failures"].inc()
            if self._tel is not None:
                self._tel["seconds"].observe(time.perf_counter() - t0)
            # a node death is a flight-recorder trigger: capture the
            # diagnostic bundle while the pre-death spans are still in
            # every survivor's ring. The dead node is marked STALE by
            # the caller-visible staleness contract — the coordinator
            # knows who died before any aggregator notices the silence.
            # Best-effort + rate-limited (telemetry/blackbox.py).
            from ..telemetry import blackbox

            blackbox.trigger_bundle(
                "node_death",
                detail=nid,
                aux=self.bundle_context,
                stale={nid: "declared dead (heartbeat timeout)"},
            )
            handled.append(nid)
        return handled

    def revive(self, node_id: str) -> None:
        """A node reported again after recovery — allow future detection."""
        with self._lock:
            self._recovered.discard(node_id)

    # -- background polling (the scheduler's heartbeat thread) --

    def start(self, interval: float = 1.0) -> None:
        assert self._thread is None, "already started"
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                self.check()

        self._thread = threading.Thread(target=loop, daemon=True, name="recovery")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
