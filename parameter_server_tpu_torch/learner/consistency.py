"""Adaptive bounded delay and the host half of the KKT filter.

Counterpart of ``parameter_server_tpu/learner/consistency.py``:

- :class:`AdaptiveTauController` moves a worker's live τ between
  submissions (``AsyncSGDWorker.set_effective_tau``; the configured
  ``max_delay`` stays the cap): it starts at 1, widens one ministep
  after every ``stable_steps`` healthy collects, halves on a soft
  gradient-norm spike (``spike_factor`` times its window's median), and
  on a non-finite loss or gradient runs the reaction: τ → 0, the
  learning rate times ``backoff_factor``, and a rollback to its last
  healthy snapshot through ``state_host`` / ``load_state_host``.
- :class:`SignificanceTracker` counts the in-step KKT mask's candidate
  and suppressed slots, and with ``kkt_drop_after > 0`` keeps a drop
  set: a slot suppressed ``drop_after`` collects in a row leaves later
  batches on the host (``filter_batch``, before prep), and every
  ``revisit_every``-th batch ships unfiltered so a dropped slot can
  earn its place back.

Threads: ``on_collect`` runs on the collect thread (the one that calls
``train``), ``filter_batch`` on the prep thread (serial:
``kkt_drop_after > 0`` needs ``ingest_workers=1``). The drop set is
handed across under a lock, with a version (one more at each change)
and an order-free digest of its slots (:meth:`SignificanceTracker.stamp`).
Which version a prep sees is the worker's to fix: ``train`` preps each
launch group with the drop set the collects before it left, on the
pipelined path as on the serial one.

**On a mesh** (the worker's ``mesh``): every rank runs a controller and
a tracker of its own, fed the same folded metrics, so their τ moves and
drop sets agree; the worker checks both at every launch
(``parallel/distributed.agree_on``). The reaction to a non-finite
collect runs on every rank at that collect. A :meth:`ConsistencyRuntime.react`
from outside (an alert, on a rank's own clock) is only a request: the
worker's dispatch thread takes it into the next launch's agreement, and
every rank runs the reaction at that launch's collect, whichever ranks
asked.

The controller reads the signals the JAX controller reads: each
collect's objective, example count and ``grad_sq``. Both record into the
``ps_consistency_*`` family (τ moves, snapshot age, backoffs and
rollbacks, candidate / suppressed / dropped keys) and the tracker
credits the shipped keys to ``ps_push_keys_total`` (store = the worker's
name), so ``pushed + suppressed == candidates`` reconciles in a
snapshot; a reaction captures a flight-recorder bundle when a recorder
is installed. The ``consistency.rollback`` fault point fires first in
a reaction, before any state is touched: a drill that raises there shows
the caller survives the reaction itself failing.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from ..utils.sparse import SparseBatch

STABLE_STEPS = 8  # healthy collects between widenings
SOFT_SPIKE_FACTOR = 4.0  # soft spike: grad norm over this x the window median
SPIKE_WINDOW = 32
SPIKE_MIN_WINDOW = 8  # healthy collects before the spike judge is on
SNAPSHOT_EVERY = 16  # healthy collects between rollback snapshots
BACKOFF_FACTOR = 0.5  # learning-rate factor of the reaction
EPISODE_CAP = 64


class AdaptiveTauController:
    """Moves one worker's live τ from its collects' metrics; holds the
    rollback snapshot (host arrays of ``worker.state_host()``)."""

    def __init__(self, worker, *, stable_steps: int = STABLE_STEPS,
                 spike_factor: float = SOFT_SPIKE_FACTOR,
                 snapshot_every: int = SNAPSHOT_EVERY,
                 backoff_factor: float = BACKOFF_FACTOR,
                 tel: Optional[Dict[str, object]] = None):
        self.worker = worker
        self.tau_max = max(0, int(worker.sgd.max_delay))
        self.stable_steps = max(1, int(stable_steps))
        self.spike_factor = float(spike_factor)
        self.snapshot_every = max(1, int(snapshot_every))
        self.backoff_factor = float(backoff_factor)
        self._tel = tel
        # one ministep of slack to start, widened as stability is earned
        self.tau = worker.set_effective_tau(min(1, self.tau_max))
        self._stable = 0
        self._grad_window: collections.deque = collections.deque(maxlen=SPIKE_WINDOW)
        self._snapshot: Optional[dict] = None
        self._snapshot_age = 0
        self._healthy = 0
        self.episodes: List[Dict[str, Any]] = []
        self.tau_trace: List[int] = [self.tau]

    def on_metrics(self, loss: float, grad_norm: Optional[float], nonfinite: bool) -> None:
        if nonfinite:
            self.react("nonfinite")
            return
        spike = False
        if grad_norm is not None:
            if len(self._grad_window) >= SPIKE_MIN_WINDOW:
                med = float(np.median(self._grad_window))
                spike = med > 0 and grad_norm > self.spike_factor * med
            self._grad_window.append(grad_norm)
        if spike:
            # a leading indicator: halve τ, keep the rate and the state
            self._set_tau(self.tau // 2, "clamp")
            self._stable = 0
            return
        self._healthy += 1
        self._stable += 1
        if self._stable >= self.stable_steps and self.tau < self.tau_max:
            self._set_tau(self.tau + 1, "widen")
            self._stable = 0
        self._snapshot_age += 1
        if self._snapshot is None or self._healthy % self.snapshot_every == 0:
            self._snapshot = self.worker.state_host()  # drains the steps in flight
            self._snapshot_age = 0
        if self._tel is not None:
            self._tel["snapshot_age"].labels(worker=self.worker.name).set(self._snapshot_age)

    def _set_tau(self, tau: int, direction: str = "widen") -> None:
        tau = self.worker.set_effective_tau(tau)
        if tau != self.tau:
            self.tau = tau
            self.tau_trace.append(tau)
            if self._tel is not None:
                self._tel["tau_changes"].labels(worker=self.worker.name,
                                                direction=direction).inc()

    def react(self, reason: str) -> Dict[str, Any]:
        """τ → 0, learning-rate backoff, rollback to the last healthy
        snapshot. Collect thread only."""
        from ..system import faults

        # before any state is touched: a raise here leaves the rate, τ
        # and the episode log as they were (collect propagates it)
        faults.inject("consistency.rollback", detail=reason)
        worker = self.worker
        drain = getattr(worker, "_drain", None)
        if drain is not None:
            # the steps in flight ran at the old rate, as the JAX worker's
            # compiled steps do: they run out before the rate changes
            drain()
        self._set_tau(0, "reset")
        self._stable = 0
        self._grad_window.clear()
        # the steps read the rate when they run; the cached step
        # closures are dropped all the same, as the JAX worker's are
        worker.lr.alpha = float(worker.lr.alpha) * self.backoff_factor
        worker._steps.clear()
        rolled_back = False
        if self._snapshot is not None:
            worker.load_state_host(self._snapshot)  # drains first
            rolled_back = True
        self._snapshot_age = 0
        episode = {
            "reason": reason,
            "healthy_collects": self._healthy,
            "alpha_after": float(worker.lr.alpha),
            "tau_after": self.tau,
            "rolled_back": rolled_back,
        }
        self.episodes.append(episode)
        del self.episodes[:-EPISODE_CAP]
        if self._tel is not None:
            self._tel["backoff"].labels(worker=worker.name).inc()
            if rolled_back:
                self._tel["rollback"].labels(worker=worker.name, reason=reason).inc()
        from ..telemetry import blackbox

        if blackbox.installed_recorder() is not None:
            # an armed flight recorder: the episode, with the evidence
            # before it still in the rings, lands in one bundle
            blackbox.trigger_bundle("consistency_rollback", detail=reason)
        return episode


class SignificanceTracker:
    """Counts of the in-step KKT mask and the host drop set."""

    def __init__(self, worker, *, drop_after: int, revisit_every: int,
                 tel: Optional[Dict[str, object]] = None):
        self.worker = worker
        self.num_slots = int(worker.num_slots)
        self.drop_after = int(drop_after)
        self.revisit_every = max(1, int(revisit_every))
        self._tel = tel
        self._push_keys = None
        if tel is not None:
            from ..telemetry import registry as telemetry_registry
            from ..telemetry.instruments import parameter_instruments

            # the worker-side analog of the stores' pushed-key count:
            # what the filtered step shipped, under this worker's name
            self._push_keys = parameter_instruments(
                telemetry_registry.default_registry()
            )["push_keys"].labels(store=worker.name, channel=0)
        self._streaks: Dict[int, int] = {}  # collect thread only
        self._dropped: set = set()  # guarded by _lock
        self._version = 0  # changes of the drop set; guarded by _lock
        self._digest = 0  # sum of _mix(slot) over the drop set, mod 2^64; guarded by _lock
        self._lock = threading.Lock()
        self._preps = 0  # prep thread only
        self.candidates = 0
        self.suppressed = 0
        self.pushed = 0
        self.dropped_entries = 0
        self.filtered_batches = 0
        self.revisit_batches = 0

    def note_metrics(self, metrics: Mapping[str, Any]) -> None:
        if "kkt_slots" not in metrics:
            return
        cand = int(round(float(metrics["kkt_slots"])))
        sup = int(round(float(metrics["kkt_suppressed"])))
        self.candidates += cand
        self.suppressed += sup
        self.pushed += cand - sup
        if self._tel is not None:
            w = self.worker.name
            self._tel["candidates"].labels(worker=w).inc(cand)
            self._tel["suppressed"].labels(worker=w).inc(sup)
        if self._push_keys is not None:
            self._push_keys.inc(cand - sup)
        if self.drop_after > 0 and "kkt_keep" in metrics:
            # the one device-to-host copy of the feedback: two U-vectors
            self._note_feedback(_host(metrics["kkt_uslots"]), _host(metrics["kkt_keep"]))

    def _note_feedback(self, uslots: np.ndarray, keep: np.ndarray) -> None:
        uslots = uslots.reshape(-1)
        keep = keep.reshape(-1).astype(bool)
        real = (uslots >= 0) & (uslots < self.num_slots)
        sup = uslots[real & ~keep]
        kept = uslots[real & keep]
        undropped = []
        for s in kept.tolist():
            self._streaks.pop(s, None)
            undropped.append(s)
        newly: List[int] = []
        for s in sup.tolist():
            streak = self._streaks.get(s, 0) + 1
            if streak >= self.drop_after:
                self._streaks.pop(s, None)
                newly.append(s)
            else:
                self._streaks[s] = streak
        if newly or undropped:
            with self._lock:
                # a kept sighting (a revisit, or an escape) re-earns the slot
                gone = self._dropped.intersection(undropped)
                self._dropped.difference_update(gone)
                came = set(newly).difference(self._dropped)
                self._dropped.update(came)
                if gone or came:
                    self._version += 1
                    self._digest = (self._digest + sum(_mix(x) for x in came)
                                    - sum(_mix(x) for x in gone)) & _M64

    def stamp(self) -> tuple:
        """``(version, digest)`` of the drop set now: the version counts
        its changes, the digest (63 bits) sums a hash of each slot, so two
        trackers with the same set give the same digest."""
        with self._lock:
            return self._version, self._digest >> 1

    def filter_batch(self, batch: SparseBatch, directory) -> SparseBatch:
        """Drop the dropped slots' entries from one batch (a CSR
        rebuild); every ``revisit_every``-th batch ships unfiltered."""
        self._preps += 1
        if self._preps % self.revisit_every == 0:
            self.revisit_batches += 1
            return batch
        with self._lock:
            if not self._dropped:
                return batch
            dropped = np.fromiter(self._dropped, dtype=np.int64)
        slots = directory.slots(batch.indices)
        keep = ~np.isin(slots, dropped)
        n_drop = int(batch.nnz - keep.sum())
        if n_drop == 0:
            return batch
        counts = np.zeros(batch.n, dtype=np.int64)
        np.add.at(counts, batch.row_ids()[keep], 1)
        indptr = np.zeros(batch.n + 1, dtype=batch.indptr.dtype)
        np.cumsum(counts, out=indptr[1:])
        out = SparseBatch(
            y=batch.y, indptr=indptr, indices=batch.indices[keep],
            values=None if batch.values is None else batch.values[keep],
            num_cols=batch.num_cols,
            slot_ids=None if batch.slot_ids is None else batch.slot_ids[keep],
        )
        self.dropped_entries += n_drop
        self.filtered_batches += 1
        if self._tel is not None:
            self._tel["dropped"].labels(worker=self.worker.name).inc(n_drop)
        return out

    def dropped_slots(self) -> int:
        with self._lock:
            return len(self._dropped)

    def summary(self) -> Dict[str, Any]:
        return {
            "candidates": self.candidates,
            "suppressed": self.suppressed,
            "pushed": self.pushed,
            "reconciled": self.pushed + self.suppressed == self.candidates,
            "dropped_slots": self.dropped_slots(),
            "dropped_entries": self.dropped_entries,
            "filtered_batches": self.filtered_batches,
            "revisit_batches": self.revisit_batches,
        }


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finalizer: a slot id's 64-bit hash for the digest."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class ConsistencyRuntime:
    """One worker's controller and tracker, with the hooks the worker
    calls: :meth:`on_collect` from ``collect``, :meth:`filter_batch`
    from ``prep``."""

    def __init__(self, worker, controller, tracker):
        self.worker = worker
        self.controller: Optional[AdaptiveTauController] = controller
        self.tracker: Optional[SignificanceTracker] = tracker
        #: on a mesh: reaction requests not yet taken into a launch
        self._requests: List[str] = []  # guarded by _lock
        #: each agreed reaction's local reason (None: a peer asked), in
        #: launch order; the dispatch thread appends, the collect pops
        self._agreed: collections.deque = collections.deque()
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, worker, sgd, **kw) -> "ConsistencyRuntime":
        from ..telemetry import registry as telemetry_registry

        tel = None
        if telemetry_registry.enabled():
            from ..telemetry.instruments import consistency_instruments

            tel = consistency_instruments(telemetry_registry.default_registry())
        controller = (AdaptiveTauController(worker, tel=tel, **kw)
                      if sgd.tau_adaptive else None)
        tracker = None
        if sgd.kkt_filter:
            tracker = SignificanceTracker(worker, drop_after=sgd.kkt_drop_after,
                                          revisit_every=sgd.kkt_revisit_every, tel=tel)
        return cls(worker, controller, tracker)

    def on_collect(self, metrics: Mapping[str, Any]) -> None:
        if self.controller is not None and "consistency_react" in metrics:
            # a reaction the mesh agreed on at this launch: every rank runs
            # it here, at the collect of the same launch
            reason = self._agreed.popleft() if self._agreed else None
            self.controller.react(reason or "peer")
        if self.tracker is not None:
            self.tracker.note_metrics(metrics)
        if self.controller is not None:
            loss = float(metrics.get("objective", 0.0)) / max(1, int(float(metrics.get("num_ex", 0))))
            grad_sq = metrics.get("grad_sq")
            grad_norm = None
            if grad_sq is not None:
                g = float(grad_sq)
                grad_norm = math.sqrt(g) if math.isfinite(g) and g >= 0 else g
            nonfinite = not math.isfinite(loss) or (
                grad_norm is not None and not math.isfinite(grad_norm))
            self.controller.on_metrics(loss, grad_norm, nonfinite)

    def filter_batch(self, batch: SparseBatch, directory) -> SparseBatch:
        if self.tracker is None:
            return batch
        return self.tracker.filter_batch(batch, directory)

    def react(self, reason: str = "alert") -> Optional[Dict[str, Any]]:
        """The reaction now, and its episode; on a mesh a request that
        the next launch's agreement takes (the module's docstring), and
        None."""
        if self.controller is None:
            return None
        if getattr(self.worker, "mesh", None) is not None:
            with self._lock:
                self._requests.append(reason)
            return None
        return self.controller.react(reason)

    def take_request(self) -> Optional[str]:
        """The reason of the oldest reaction request not yet taken (all
        of them are taken at once), or None. Dispatch thread."""
        with self._lock:
            reqs, self._requests = self._requests, []
        return reqs[0] if reqs else None

    def note_agreed(self, reason: Optional[str]) -> None:
        """A launch's agreement called for a reaction: remember this
        rank's reason (None if only a peer asked) for its collect.
        Dispatch thread."""
        self._agreed.append(reason)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"worker": self.worker.name}
        if self.controller is not None:
            c = self.controller
            out["tau"] = {
                "live": c.tau, "cap": c.tau_max, "trace": list(c.tau_trace[-64:]),
                "healthy_collects": c._healthy, "snapshot_age": c._snapshot_age,
            }
            out["episodes"] = list(c.episodes)
        if self.tracker is not None:
            out["significance"] = self.tracker.summary()
        return out
