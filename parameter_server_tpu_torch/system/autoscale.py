"""Alert-driven autoscaling: the alert→action edge.

Counterpart of ``parameter_server_tpu/system/autoscale.py``, host code
copied as it is. Every plane below this one exists in the port: the
history store evaluates ``serve_p99_burn`` over fast AND slow windows
(``telemetry/history.py``: one latency spike cannot page, a sustained
burn must), the elastic coordinator grows the fleet under live serving
traffic (``system/elastic.py`` and the frontend's pause / quiesce /
rebind / resume), and the flight recorder captures diagnosis bundles
(``telemetry/blackbox.py``). :class:`AlertDrivenScaler` is the edge: an
:meth:`AlertManager.add_listener` hook that, on the watched rule
transitioning to ``firing``, grows the fleet and captures the bundle
arc (overload → resize → resolve), so the page that never happened is
still diagnosable after the fact.

Deliberately conservative:

- **one rule, one action**: grow by one worker per firing, under a
  cooldown, so an oscillating alert cannot saw the fleet;
- **bounded**: ``max_workers`` caps growth; past it the scaler only
  records (capacity exhausted IS the page);
- **never raises into the alert plane**: AlertManager swallows listener
  exceptions by contract, and the scaler also fences its own action
  errors into the action log;
- **evidence first**: every action (and the eventual resolve) triggers a
  rate-limit-respecting flight-recorder bundle, so the whole arc lands in
  ``blackbox.bundles()``.

The default action is ``coordinator.add_worker()`` (a bare resize;
``ElasticCoordinator.add_worker`` is a collective of the world, so in a
world of ranks every rank's scaler must act on the same firing);
serving deployments pass ``grow=`` wiring the full serve-through-resize
sequence (``fe.pause() → fe.quiesce() → co.add_worker() →
fe.rebind(...) → fe.resume()``, ``serving/frontend.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class AlertDrivenScaler:
    """Listener on one alert rule that grows an elastic fleet.

    ``manager`` is the :class:`~..telemetry.alerts.AlertManager` to
    listen on; ``coordinator`` anything with ``add_worker()`` (the
    :class:`~.elastic.ElasticCoordinator` contract). ``grow`` overrides
    the action (called with no args, returns a descriptive value);
    ``cooldown_s`` spaces actions; ``max_workers`` bounds total grows.
    ``clock`` is injectable for deterministic drills.
    """

    def __init__(
        self,
        manager,
        coordinator,
        rule: str = "serve_p99_burn",
        *,
        grow: Optional[Callable[[], object]] = None,
        cooldown_s: float = 60.0,
        max_workers: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.manager = manager
        self.coordinator = coordinator
        self.rule = str(rule)
        self._grow = grow
        self.cooldown_s = float(cooldown_s)
        self.max_workers = max_workers
        self._clock = clock
        self._lock = threading.Lock()
        self._last_action_t: Optional[float] = None  # guarded-by: _lock
        self._grown = 0  # guarded-by: _lock
        self._actions: List[dict] = []  # guarded-by: _lock
        manager.add_listener(self._on_event)

    # -- the listener (runs inside AlertManager.evaluate) ---------------

    def _on_event(self, ev) -> None:
        if ev.rule != self.rule:
            return
        if ev.to == "firing":
            self._act(ev)
        elif ev.to == "resolved":
            self._resolved(ev)

    def _act(self, ev) -> None:
        now = self._clock()
        with self._lock:
            if (
                self._last_action_t is not None
                and now - self._last_action_t < self.cooldown_s
            ):
                self._record_locked("skipped-cooldown", ev, now)
                return
            if (
                self.max_workers is not None
                and self._grown >= self.max_workers
            ):
                # capacity exhausted: nothing left to actuate — this
                # is the state that still needs the human the alert
                # would otherwise have paged
                self._record_locked("skipped-max-workers", ev, now)
                return
            self._last_action_t = now
            self._grown += 1
        try:
            result = (
                self._grow() if self._grow is not None
                else self.coordinator.add_worker()
            )
            outcome = "grew"
        except Exception as e:  # fence: never raise into evaluate()
            result = f"{type(e).__name__}: {e}"
            outcome = "error"
            with self._lock:
                self._grown -= 1
        with self._lock:
            self._record_locked(outcome, ev, now, result=result)
        # evidence: the last seconds of spans/metrics around the
        # overload AND the action, while they are still in the ring
        from ..telemetry import blackbox

        blackbox.trigger_bundle(
            "alert",
            detail=(
                f"{self.rule} firing -> {outcome} "
                f"(value={ev.value}, workers_grown={self.grown()})"
            ),
        )

    def _resolved(self, ev) -> None:
        now = self._clock()
        with self._lock:
            acted = any(a["outcome"] == "grew" for a in self._actions)
            self._record_locked("resolved", ev, now)
        if acted:
            # close the arc: the bundle pair (firing->grew, resolved)
            # is the drill's assertable evidence that no human was in
            # the loop
            from ..telemetry import blackbox

            blackbox.trigger_bundle(
                "alert",
                detail=(
                    f"{self.rule} resolved after autoscale "
                    f"(workers_grown={self.grown()})"
                ),
            )

    # holds-lock: _lock
    def _record_locked(self, outcome, ev, now, result=None) -> None:
        self._actions.append(
            {
                "outcome": outcome,
                "rule": ev.rule,
                "to": ev.to,
                "value": ev.value,
                "t": now,
                **({"result": result} if result is not None else {}),
            }
        )

    # -- introspection --------------------------------------------------

    def grown(self) -> int:
        with self._lock:
            return self._grown

    def actions(self) -> List[dict]:
        with self._lock:
            return list(self._actions)
