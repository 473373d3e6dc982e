"""Learning truth plane: realized staleness, key heat & shard balance,
and cluster-wide convergence telemetry.

Five observability planes watch the *system* — seconds, bytes, FLOPs,
incidents — but none watch the
*learning*. The bounded-delay contract (``SGDConfig.max_delay`` = τ) is
configured yet never measured; which key ranges run hot is exactly the
input a declarative partitioner needs; and a NaN'd table serves 200s
all day. This module makes those first-class, the way the device plane does for the
chip:

- **Realized staleness** (:meth:`LearningPlane.note_submit`): each
  submitted step is stamped with how many ministeps its weight snapshot
  lags the apply clock — ``ps_learning_staleness_ministeps`` is the
  per-worker histogram — and, separately, the executor logical-clock
  lag between the snapshot-taking submission and this one (the
  ``Executor`` timestamps the worker already holds; disclosed as
  ``executor_clock_lag_max``, not folded into the histogram: τ is a
  ministep bound and the launch-clock lag never exceeds it). The
  observed-max gauge against τ turns the bounded-delay contract into a
  measured invariant — it meters the same counter the snapshot refresh
  enforces, so it is a regression detector for the ENFORCEMENT (a
  skipped or mis-scheduled refresh reads > τ and fires), not an
  independent oracle of it (bench records assert ``observed <= τ``
  in-record; the ``staleness_breach`` rule fires live on
  ``ps_learning_staleness_over_tau > 0``). The bound is
  the LIVE τ: each submission is judged against the effective τ in
  force when it was stamped (:meth:`LearningPlane.set_tau`; the
  adaptive controller moves it between submissions), so a submission
  that was legal under the wide τ of its era never false-fires after
  the controller clamps down — and the current τ itself is exported
  as the ``ps_consistency_tau`` gauge.
- **Key heat & shard balance** (:class:`KeyHeat` /
  :meth:`LearningPlane.note_slots`): a windowed-decay count-min sketch
  (``utils/sketch.DecayCountMin`` — the same CM machinery the ingest
  tail filter rides) over pushed/pulled table slots, fed from the
  single-owner feeder/uploader threads (the stateless-or-feeder rule's
  lock-annotated arm: appends are one lock + vectorized numpy). Slot
  counts fold by server key range (``system/assigner.NodeAssigner``
  Ranges) into per-shard load shares, an imbalance ratio gauge
  (max/mean), and a top-k hot-slot table served in ``/debug/snapshot``.
- **Convergence** (:meth:`LearningPlane.note_step`): per-step loss /
  grad-norm / update-norm / weight-norm arrive as cheap in-jit side
  outputs of the existing step builders (trace-pure scalars on the
  metrics dict — the jit-purity pattern; donation-safe) and are
  metered HERE, host-side, in ``ISGDCompNode.collect``. Divergence is
  judged per collect — non-finite loss/gradient, or a grad norm far
  past its recent median (a seeded LR blow-up) — and ticks
  ``ps_learning_divergence_total``, which the shipped
  ``loss_divergence`` rule fires on (a firing transition captures a
  flight-recorder bundle through the incident trigger plane).

Cluster view: a plane's :meth:`LearningPlane.export` is a plain-dict
registry export of the ``ps_learning_*`` family, wire-safe for the
restricted unpickler; :class:`ClusterFeedMaster` receives those
reports over the typed ``MonitorMaster``/``MonitorSlaver.over_van``
path and feeds the :class:`~.aggregate.ClusterAggregator`, so one
``/metrics`` scrape shows ``ps_learning_*`` node-labeled with the
cluster rollup. ``doc/OBSERVABILITY.md`` ("Learning truth plane")
documents how to read all of it.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from ..utils.sketch import DecayCountMin, add_by_range, unique_counts
from . import registry as telemetry_registry

#: trajectory points kept per plane (loss/grad-norm tail for the bench
#: record's ``learning`` section; the full stream rides the metrics)
TRAJECTORY_CAP = 512

#: grad-norm spike factor: a collected step whose grad norm exceeds
#: this multiple of the recent median counts as divergence
#: (reason="spike"); generous so warmup transients never false-fire
SPIKE_FACTOR = 100.0

#: collected steps needed before the spike judge activates (a median
#: over fewer points is warmup noise, not a baseline)
SPIKE_MIN_WINDOW = 8


def _shard_starts(num_slots: int, num_shards: int) -> np.ndarray:
    """Per-shard slot-range begin offsets, derived through the SAME
    assignment the servers use (system/assigner.NodeAssigner handing
    out Range.even_divide key ranges) — the heat fold must agree with
    the table's actual ownership, not re-derive its own arithmetic."""
    from ..system.assigner import NodeAssigner
    from ..system.manager import Node
    from ..utils.range import Range

    assigner = NodeAssigner(num_shards, Range(0, num_slots))
    starts = []
    for i in range(num_shards):
        node = assigner.assign(Node(Node.SERVER, i))
        starts.append(int(node.key_range.begin))
    return np.asarray(starts, dtype=np.int64)


# owner-thread: feeder
class KeyHeat:
    """Windowed key-heat accounting over table slots.

    One :class:`~..utils.sketch.DecayCountMin` estimates per-slot
    recent frequency (top-k hot-slot table); an exact per-shard count
    vector — folded by the servers' assigned key ranges — carries the
    load shares and the imbalance ratio. ``decay_every`` notes advance
    the window (counters halve), so a key that cooled falls out of the
    view instead of being pinned by its history.

    Thread-safety: ``note`` is called from the worker's feeder/trainer
    thread, reads from scrape/snapshot threads — every member is
    guarded by one small lock (the stateless-or-feeder rule's
    lock-annotated arm; the insert itself is vectorized numpy).
    """

    def __init__(
        self,
        num_slots: int,
        num_shards: int,
        sketch_slots: int = 1 << 16,
        hashes: int = 2,
        top_k: int = 16,
        decay_every: int = 256,
    ):
        if num_slots > 1 << 32:
            raise ValueError(f"KeyHeat counts slots below 2^32, not {num_slots}")
        self.num_slots = int(num_slots)
        self.num_shards = int(num_shards)
        self.top_k = int(top_k)
        self.decay_every = int(decay_every)
        self._starts = _shard_starts(num_slots, num_shards)
        self._sketch = DecayCountMin(n=sketch_slots, k=hashes)  # guarded-by: _lock
        self._shard_counts = np.zeros(num_shards, np.float64)  # guarded-by: _lock
        self._candidates: Dict[int, float] = {}  # guarded-by: _lock
        self._notes = 0  # guarded-by: _lock
        self._slots_total = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    def note(self, slots: np.ndarray) -> int:
        """Fold one batch's slot ids in; returns how many were counted
        (sentinel/padding slots >= num_slots are dropped)."""
        return self.fold(self.prepare(slots))

    def prepare(self, slots: np.ndarray):
        """The part of :meth:`note` that reads no state (any thread):
        the slots in range, their distinct values and counts (np.unique's,
        from the native library: the slots lie below num_slots <= 2^32)
        and the sketch positions of those values; None when no slot
        counts. :meth:`fold` takes it."""
        slots = np.asarray(slots).reshape(-1)
        if slots.size == 0:
            return None
        slots = slots[(slots >= 0) & (slots < self.num_slots)]
        if slots.size == 0:
            return None
        uniq, cnt = unique_counts(slots)
        return int(slots.size), uniq, cnt, self._sketch.positions(uniq)

    def fold(self, prepared) -> int:
        """The rest of :meth:`note`, on what :meth:`prepare` gave, in the
        order of the batches; returns how many slots were counted."""
        if prepared is None:
            return 0
        n, uniq, cnt, pos = prepared
        with self._lock:
            self._sketch.insert_at(pos, cnt)
            est = self._sketch.query_at(pos)
            add_by_range(self._shard_counts, self._starts, uniq, cnt)
            # candidate tracking: this batch's unique slots carry their
            # CURRENT sketch estimates; the dict keeps a generous
            # superset of the top-k and snapshot() re-queries it so the
            # served table reflects decay, not stale insert-time counts
            order = np.argsort(est)[::-1][: 4 * self.top_k]
            for s, e in zip(uniq[order], est[order]):
                self._candidates[int(s)] = float(e)
            if len(self._candidates) > 8 * self.top_k:
                keep = sorted(
                    self._candidates.items(), key=lambda kv: -kv[1]
                )[: 4 * self.top_k]
                self._candidates = dict(keep)
            self._notes += 1
            self._slots_total += n
            if self.decay_every and self._notes % self.decay_every == 0:
                self._decay_locked()
        return n

    def _decay_locked(self) -> None:  # holds-lock: _lock
        self._sketch.decay()
        self._shard_counts *= 0.5
        self._candidates = {
            s: v * 0.5 for s, v in self._candidates.items() if v >= 2.0
        }

    def advance(self) -> None:
        """Explicitly advance one decay window (tests, timers)."""
        with self._lock:
            self._decay_locked()

    def rebase(self, perm: Optional[np.ndarray] = None) -> None:
        """Start a fresh measurement window after a layout change (a
        live rebalance moved rows, so the accumulated per-shard counts
        describe the OLD slot→shard assignment and must not leak into
        the post-rebalance imbalance reading). The sketch and exact
        shard counts reset; with ``perm`` (old slot → new slot) the
        hot-slot candidate set is translated so the hot keys stay
        identified across the move, otherwise it clears too."""
        with self._lock:
            self._sketch.clear()
            self._shard_counts[:] = 0.0
            if perm is None:
                self._candidates = {}
            else:
                perm = np.asarray(perm)
                self._candidates = {
                    int(perm[s]): v
                    for s, v in self._candidates.items()
                    if 0 <= s < len(perm)
                }
            self._notes = 0
            self._slots_total = 0

    def estimate(self, slots: np.ndarray) -> np.ndarray:
        """Sketch frequency estimates for the given slots (upper-biased
        CM semantics; the parity probe compares these against exact
        counts on a small run)."""
        with self._lock:
            return self._sketch.query(np.asarray(slots).reshape(-1))

    def shares(self) -> Dict[str, Any]:
        """Per-shard load shares + the max/mean imbalance ratio."""
        with self._lock:
            counts = self._shard_counts.copy()
        total = float(counts.sum())
        if total <= 0:
            return {
                "total_weight": 0.0,
                "shares": [0.0] * self.num_shards,
                "imbalance": None,
            }
        shares = counts / total
        return {
            "total_weight": round(total, 1),
            "shares": [round(float(s), 5) for s in shares],
            "imbalance": round(float(counts.max() / counts.mean()), 4),
        }

    def top_slots(self, k: Optional[int] = None) -> List[Dict[str, Any]]:
        """The hot-slot table: top-k candidate slots by current sketch
        estimate, with the owning shard."""
        k = self.top_k if k is None else k
        with self._lock:
            cand = np.fromiter(self._candidates, dtype=np.int64)
            if cand.size == 0:
                return []
            est = self._sketch.query(cand)
        order = np.argsort(est)[::-1][:k]
        out = []
        for i in order:
            slot = int(cand[i])
            shard = int(
                np.searchsorted(self._starts, slot, side="right") - 1
            )
            out.append({"slot": slot, "est": float(est[i]), "shard": shard})
        return out


class LearningPlane:
    """One worker's learning-truth accounting against a registry.

    Created by the training workers (``AsyncSGDWorker`` registers one
    under its node name against the process default registry; cluster
    tests hand each logical worker a private registry so the monitor
    path can ship node-distinct exports). All mutable state is guarded
    by one lock; the metered hot paths are a handful of scalar ops per
    submitted/collected step plus one vectorized sketch insert per
    noted batch.
    """

    def __init__(
        self,
        worker: str,
        num_slots: int,
        num_shards: int,
        max_delay: int,
        registry=None,
        heat_every: int = 1,
        spike_factor: float = SPIKE_FACTOR,
    ):
        from .instruments import consistency_instruments, learning_instruments

        self.worker = worker
        self.max_delay = int(max_delay)
        self.tau = int(max_delay)  # live effective τ; see set_tau()
        self.heat_every = max(1, int(heat_every))
        self.spike_factor = float(spike_factor)
        self.registry = (
            registry
            if registry is not None
            else telemetry_registry.default_registry()
        )
        tel = learning_instruments(self.registry)
        self._staleness_hist = tel["staleness"]  # parent: reads
        self._h_staleness = tel["staleness"].labels(worker=worker)
        self._g_staleness_max = tel["staleness_max"].labels(worker=worker)
        self._g_over_tau = tel["staleness_over_tau"].labels(worker=worker)
        self._c_examples = tel["examples"].labels(worker=worker)
        self._g_loss = tel["loss"].labels(worker=worker)
        self._g_grad = tel["grad_norm"].labels(worker=worker)
        self._g_update = tel["update_norm"].labels(worker=worker)
        self._g_weight = tel["weight_norm"].labels(worker=worker)
        self._c_divergence = tel["divergence"]
        self._c_heat = tel["heat_slots"].labels(worker=worker)
        self._g_share = tel["shard_share"]
        self._g_imbalance = tel["shard_imbalance"]
        self._g_tau = consistency_instruments(self.registry)["tau"].labels(
            worker=worker
        )
        self._g_tau.set(self.tau)
        self.heat = KeyHeat(num_slots, num_shards)
        self._staleness_max = 0  # guarded-by: _lock
        self._over_tau_max = -int(max_delay)  # guarded-by: _lock
        self._clock_lag_max = 0  # guarded-by: _lock
        self._submits = 0  # guarded-by: _lock
        self._collects = 0  # guarded-by: _lock
        self._examples = 0  # guarded-by: _lock
        self._divergences: Dict[str, int] = {}  # guarded-by: _lock
        self._trajectory: collections.deque = collections.deque(  # guarded-by: _lock
            maxlen=TRAJECTORY_CAP
        )
        self._grad_window: collections.deque = collections.deque(  # guarded-by: _lock
            maxlen=32
        )
        self._lock = threading.Lock()
        # the observed-vs-τ gauge starts satisfied (nothing observed)
        self._g_over_tau.set(-float(self.max_delay))

    # -- realized staleness (the submit/apply path) --

    def set_tau(self, tau: int) -> None:
        """Move the LIVE effective τ (the adaptive controller's knob).

        Future submissions are judged against the new bound; already
        stamped ones keep the verdict of the τ in force when they were
        submitted (tracked per-submission in :meth:`note_submit`), so a
        clamp-down never retroactively brands legal history a breach.
        Refreshes the ``ps_consistency_tau`` gauge."""
        tau = int(tau)
        with self._lock:
            self.tau = tau
        self._g_tau.set(tau)

    def note_submit(
        self,
        staleness: int,
        n_steps: int = 1,
        clock_lag: int = 0,
        tau: Optional[int] = None,
    ) -> None:
        """Stamp one submitted step (or scan superstep) with its
        realized snapshot staleness in MINISTEPS (comparable to τ) and
        the executor logical-clock lag between the snapshot-taking
        submission and this one. ``tau`` is the effective bound at
        submit time (callers that plumb the live τ pass it explicitly;
        default is the plane's current live τ) — the over-τ gauge
        tracks the worst PER-SUBMISSION margin ``staleness - τ_then``,
        which is what the ``staleness_breach`` rule must fire on once
        τ adapts."""
        staleness = int(staleness)
        self._h_staleness.observe(staleness)
        with self._lock:
            self._submits += 1
            if staleness > self._staleness_max:
                self._staleness_max = staleness
            bound = self.tau if tau is None else int(tau)
            over = staleness - bound
            if over > self._over_tau_max:
                self._over_tau_max = over
            if clock_lag > self._clock_lag_max:
                self._clock_lag_max = int(clock_lag)
            observed = self._staleness_max
            over_max = self._over_tau_max
        self._g_staleness_max.set(observed)
        self._g_over_tau.set(over_max)

    # -- convergence (collect-side metering of in-jit side outputs) --

    def note_step(self, metrics: Mapping[str, Any], n_steps: int = 1) -> None:
        """Fold one collected step's metrics in. ``metrics`` is the
        step's host-materialized dict: ``objective``/``num_ex`` always,
        plus the optional ``grad_sq``/``update_sq``/``weight_sq`` side
        outputs (summed over ministeps for scan supersteps)."""
        objective = float(metrics.get("objective", 0.0))
        num_ex = int(metrics.get("num_ex", 0))
        grad_sq = _opt_float(metrics.get("grad_sq"))
        update_sq = _opt_float(metrics.get("update_sq"))
        weight_sq = _opt_float(metrics.get("weight_sq"))
        loss = objective / max(1, num_ex)
        grad_norm = None if grad_sq is None else _safe_sqrt(grad_sq)
        update_norm = None if update_sq is None else _safe_sqrt(update_sq)
        weight_norm = None if weight_sq is None else _safe_sqrt(weight_sq)

        nonfinite = not math.isfinite(loss) or any(
            v is not None and not math.isfinite(v)
            for v in (grad_norm, update_norm, weight_norm)
        )
        spike = False
        with self._lock:
            self._collects += 1
            self._examples += num_ex
            if not nonfinite and grad_norm is not None:
                if len(self._grad_window) >= SPIKE_MIN_WINDOW:
                    med = float(np.median(self._grad_window))
                    spike = (
                        med > 0 and grad_norm > self.spike_factor * med
                    )
                self._grad_window.append(grad_norm)
            reason = (
                "nonfinite" if nonfinite else ("spike" if spike else None)
            )
            if reason is not None:
                self._divergences[reason] = (
                    self._divergences.get(reason, 0) + 1
                )
            self._trajectory.append({
                "step": self._collects,
                "loss": _json_float(loss),
                "grad_norm": _json_float(grad_norm),
                "update_norm": _json_float(update_norm),
                "weight_norm": _json_float(weight_norm),
            })
        self._c_examples.inc(num_ex)
        if math.isfinite(loss):
            self._g_loss.set(loss)
        for gauge, v in (
            (self._g_grad, grad_norm),
            (self._g_update, update_norm),
            (self._g_weight, weight_norm),
        ):
            if v is not None and math.isfinite(v):
                gauge.set(v)
        if reason is not None:
            self._c_divergence.labels(worker=self.worker, reason=reason).inc()

    # -- key heat (feeder/uploader-thread slot stream) --

    def note_slots(self, slots: np.ndarray) -> None:
        """Fold one batch's table-slot ids into the heat sketch and the
        per-shard load accounting; refreshes the share/imbalance
        gauges. Single-owner feeder/uploader threads only (KeyHeat's
        lock covers scrape-side reads)."""
        self.fold_heat(self.heat.prepare(slots))

    def fold_heat(self, prepared) -> None:
        """:meth:`note_slots` on what ``heat.prepare`` gave (the part of
        the note that reads no state may run on another thread); calls
        come in the order of the batches, from one thread."""
        n = self.heat.fold(prepared)
        if n <= 0:
            return
        self._c_heat.inc(n)
        shares = self.heat.shares()
        for i, s in enumerate(shares["shares"]):
            self._g_share.labels(shard=str(i)).set(s)
        if shares["imbalance"] is not None:
            self._g_imbalance.set(shares["imbalance"])

    # -- reads --

    def staleness_summary(self) -> Dict[str, Any]:
        with self._lock:
            observed = self._staleness_max
            over_max = self._over_tau_max
            live_tau = self.tau
            lag = self._clock_lag_max
            submits = self._submits
        count = self._staleness_hist.count(worker=self.worker)
        # percentile() of an empty histogram is NaN, and a literal NaN
        # in /debug/snapshot is invalid JSON to RFC-compliant clients —
        # a freshly-built worker must serve nulls, not break the scrape
        hist: Dict[str, Any] = {"count": count}
        for key, q in (("p50", 0.5), ("p99", 0.99)):
            hist[key] = (
                round(
                    self._staleness_hist.percentile(q, worker=self.worker),
                    3,
                )
                if count
                else None
            )
        return {
            "configured_tau": self.max_delay,
            "live_tau": live_tau,
            "observed_max": observed,
            # worst per-submission margin vs the τ in force AT SUBMIT
            # (== observed_max - configured_tau while τ never adapts)
            "over_tau_max": over_max,
            "within_bound": over_max <= 0,
            "executor_clock_lag_max": lag,
            "submits": submits,
            "histogram": hist,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The record-embeddable learning view for this worker:
        staleness summary (with the in-record bound verdict), shard
        shares + imbalance + hot slots, the convergence-trajectory
        tail, and divergence accounting."""
        with self._lock:
            traj = list(self._trajectory)
            divergences = dict(self._divergences)
            collects = self._collects
            examples = self._examples
        return {
            "worker": self.worker,
            "staleness": self.staleness_summary(),
            "shards": self.heat.shares(),
            "hot_slots": self.heat.top_slots(),
            "collected_steps": collects,
            "examples": examples,
            "divergence": divergences,
            "trajectory_tail": traj[-32:],
        }

    def export(self) -> Dict[str, dict]:
        """This plane's ``ps_learning_*`` families as a plain-dict
        registry export — the wire payload the monitor path ships to
        the cluster aggregator (restricted-unpickler-safe)."""
        export = self.registry.export_state()
        return {
            name: decl
            for name, decl in export.items()
            if name.startswith("ps_learning_")
        }


def _opt_float(v) -> Optional[float]:
    return None if v is None else float(v)


def _safe_sqrt(v: float) -> float:
    return math.sqrt(v) if math.isfinite(v) and v >= 0 else float(v)


def _json_float(v: Optional[float]) -> Optional[float]:
    """JSON-able scalar: non-finite floats become strings (a bench
    record with a literal NaN would be unparseable JSON)."""
    if v is None:
        return None
    if not math.isfinite(v):
        return str(v)
    return round(v, 6)


# -- the process plane registry --------------------------------------------

_planes_lock = threading.Lock()
_planes: Dict[str, LearningPlane] = {}  # guarded by _planes_lock


def register(plane: LearningPlane) -> LearningPlane:
    """Track a plane under its worker name (latest wins — workers are
    rebuilt per run/test and a fresh plane binds the current registry)."""
    with _planes_lock:
        _planes[plane.worker] = plane
    return plane


def plane(
    worker: str,
    num_slots: int,
    num_shards: int,
    max_delay: int,
    registry=None,
    **kw,
) -> LearningPlane:
    """Create + register a fresh plane for a worker (the AsyncSGDWorker
    entry point)."""
    return register(LearningPlane(
        worker, num_slots, num_shards, max_delay, registry=registry, **kw
    ))


def get_plane(worker: str) -> Optional[LearningPlane]:
    with _planes_lock:
        return _planes.get(worker)


def planes() -> Dict[str, LearningPlane]:
    with _planes_lock:
        return dict(_planes)


def reset() -> None:
    """Test hermeticity: drop every registered plane."""
    with _planes_lock:
        _planes.clear()


def snapshot_all() -> Dict[str, Any]:
    """Every live plane's snapshot, keyed by worker — the ``learning``
    member of ``/debug/snapshot`` (hot-slot tables included)."""
    return {name: p.snapshot() for name, p in sorted(planes().items())}


# -- cluster wiring (the typed monitor path into the aggregator) -----------


def _make_feeding_monitor_class():
    """Subclass the system MonitorMaster lazily (module-level import of
    system/ from telemetry/ would be a layering cycle): reports that
    the seq guard ACCEPTS are forwarded to the cluster aggregator;
    rejected redeliveries never reach it."""
    from ..system.monitor import MonitorMaster

    class _FeedingMonitorImpl(MonitorMaster):
        def __init__(self, cluster):
            # replace-merge (merger None): an export is cumulative
            # state, not a delta
            super().__init__()
            self._cluster = cluster  # set once; read-only afterwards

        def report(self, node_id, progress, seq=None) -> bool:
            merged = super().report(node_id, progress, seq=seq)
            if merged:
                self._cluster.update(node_id, progress)
            return merged

    return _FeedingMonitorImpl


_FeedingMonitorClass = None


def _FeedingMonitor(cluster):
    global _FeedingMonitorClass
    if _FeedingMonitorClass is None:
        _FeedingMonitorClass = _make_feeding_monitor_class()
    return _FeedingMonitorClass(cluster)


class ClusterFeedMaster:
    """Scheduler-side learning-progress master.

    A :class:`~..system.monitor.MonitorMaster` (typed, seq-guarded
    against redelivery) whose merged per-node payloads — each a plane's
    :meth:`LearningPlane.export` — are fed straight into the
    :class:`~.aggregate.ClusterAggregator`, so the next ``/metrics``
    scrape renders ``ps_learning_*`` under each node's label plus the
    cluster rollup. Duplicate reports the seq guard rejects never reach
    the aggregator (the redelivery contract, tier-1-tested)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.monitor = _FeedingMonitor(cluster)

    def handle_message(self, msg) -> bool:
        return self.monitor.handle_message(msg)


def slaver_over_van(master: ClusterFeedMaster, node_id: str, van):
    """Node-side reporter for the learning plane: reports ride the real
    Van transfer path (serialization, byte accounting, the
    ``van.transfer`` fault point) into the feed master. Report with
    ``slaver.report(plane.export())`` or hang it on
    ``start_periodic(plane.export)``."""
    from ..system.monitor import MonitorSlaver

    return MonitorSlaver.over_van(master.monitor, node_id, van)
