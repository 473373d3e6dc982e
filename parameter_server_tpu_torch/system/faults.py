"""Deterministic fault injection: named points, seeded triggers, no-op off.

A copy of ``parameter_server_tpu/system/faults.py``, with the same
point catalog and the same trigger evaluation, so the same seed gives
the same firing decisions. Every layer that claims robustness declares
**named fault points** where real faults land; drills arm them with
deterministic trigger specs to inject drops, delays, stalls and raises
under live load. The port's serving plane declares ``serve.pull`` (the
frontend's live pull) and ``serve.refresh`` (the read replica's
refresh); the other names are kept so a drill written against the JAX
package's catalog arms the same points.

Design rules:

- **Zero overhead disarmed.** A disarmed point costs one function call,
  one module-int truth test and a return.
- **Deterministic under a fixed seed.** Triggers are evaluated against
  a per-point call counter and a per-point ``random.Random`` seeded
  from ``(registry seed, point name)``: the n-th *call* of a point
  fires (or not) identically across runs, whichever thread makes it.
- **The call site owns the semantics.** The registry decides *whether*
  a spec fires; the point's code interprets the spec's ``kind``.
  :func:`inject` covers the common raise/delay interpretation.

Usage (tests and drills; production never arms anything)::

    from parameter_server_tpu_torch.system import faults

    faults.arm("serve.pull", kind="raise")
    with faults.scoped("serve.refresh", kind="raise", once=True):
        ...
    faults.reset()  # hermetic teardown
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
import zlib
from typing import Callable, Dict, Iterator, Optional

#: the canonical point names (doc/ROBUSTNESS.md keeps the prose
#: catalog; arming an unknown name raises so a typo'd drill can't
#: silently test nothing)
POINTS = (
    "van.transfer",        # host wire frames: drop / delay / duplicate
    "executor.step",       # step execution: raise / stall
    "heartbeat.report",    # collector ingress: silence a node
    "checkpoint.write",    # CheckpointManager._write: die mid-write
    "ingest.prep",         # ingest pool workers: raise mid-batch
    "serve.pull",          # serving live-pull store path: raise / stall
    "serve.refresh",       # read-replica refresh store path: raise
    "rebalance.migrate",   # live migration, post-snapshot host phase:
                           # stall (widen the journal window) / raise
    "consistency.rollback",  # divergence reaction, before LR backoff +
                             # snapshot rollback: raise / stall (drill
                             # the recovery path itself failing)
)


class FaultError(RuntimeError):
    """An *injected* failure — distinguishable from organic errors so
    tests can assert the failure they caused is the failure they saw."""

    def __init__(self, point: str, detail: str = ""):
        super().__init__(
            f"injected fault at {point!r}" + (f" ({detail})" if detail else "")
        )
        self.point = point
        self.detail = detail


@dataclasses.dataclass
class FaultSpec:
    """One armed point's trigger + payload. Mutable counters (``calls``,
    ``fired``) are only touched under the owning registry's lock."""

    point: str
    kind: str = "raise"
    after_n_calls: int = 0      # skip the first N matching calls
    probability: float = 1.0    # per-call fire chance (seeded, per point)
    once: bool = False          # disarm after the first firing
    delay_s: float = 0.0        # sleep payload (delay/stall kinds)
    match: Optional[str] = None  # only calls whose detail contains this
    error: Optional[Callable[[], BaseException]] = None  # raise payload
    calls: int = 0
    fired: int = 0

    def make_error(self, detail: str = "") -> BaseException:
        return self.error() if self.error is not None else FaultError(
            self.point, detail
        )


class FaultRegistry:
    """Armed specs + deterministic trigger evaluation.

    Most code uses the process-default registry through the module
    functions below; a private registry is for tests that must not
    share counters.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._specs: Dict[str, FaultSpec] = {}  # guarded-by: _lock
        self._rngs: Dict[str, random.Random] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # lock-free fast-path mirror of len(_specs): the disarmed hot
        # path reads this int and returns. Python int read/write is
        # atomic; a racing arm() is visible by the next call, which is
        # all a fault injector needs.
        self.n_armed = 0

    # -- arming --

    def arm(
        self,
        point: str,
        kind: str = "raise",
        *,
        after_n_calls: int = 0,
        probability: float = 1.0,
        once: bool = False,
        delay_s: float = 0.0,
        match: Optional[str] = None,
        error: Optional[Callable[[], BaseException]] = None,
    ) -> FaultSpec:
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: {', '.join(POINTS)}"
            )
        if not 0.0 <= probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got {probability}")
        spec = FaultSpec(
            point=point, kind=kind, after_n_calls=int(after_n_calls),
            probability=float(probability), once=once,
            delay_s=float(delay_s), match=match, error=error,
        )
        with self._lock:
            self._specs[point] = spec
            # per-point stream seeded from (seed, name): arming order
            # and cross-point interleaving cannot shift the draws
            self._rngs[point] = random.Random(
                (self.seed << 32) ^ zlib.crc32(point.encode())
            )
            self.n_armed = len(self._specs)
        return spec

    def disarm(self, point: str) -> None:
        with self._lock:
            self._specs.pop(point, None)
            self._rngs.pop(point, None)
            self.n_armed = len(self._specs)

    def reset(self) -> None:
        """Disarm everything (hermetic test teardown)."""
        with self._lock:
            self._specs.clear()
            self._rngs.clear()
            self.n_armed = 0

    def spec(self, point: str) -> Optional[FaultSpec]:
        """The armed spec (with its live counters), or None."""
        with self._lock:
            return self._specs.get(point)

    # -- the hot path --

    def check(self, point: str, detail: Optional[str] = None) -> Optional[FaultSpec]:
        """Evaluate one call of ``point``; returns the spec iff it fires.

        Non-matching calls (``match`` miss) are not counted — a spec
        targeting node S0 fires on S0's n-th report no matter how many
        other nodes reported in between.
        """
        if not self.n_armed:
            return None
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return None
            if spec.match is not None and (
                detail is None or spec.match not in str(detail)
            ):
                return None
            spec.calls += 1
            if spec.calls <= spec.after_n_calls:
                return None
            if spec.probability < 1.0:
                if self._rngs[point].random() >= spec.probability:
                    return None
            spec.fired += 1
            if spec.once:
                del self._specs[point]
                self._rngs.pop(point, None)
                self.n_armed = len(self._specs)
        return spec


#: the process-default registry (drills re-seed via :func:`seed`)
_default = FaultRegistry()


def default_registry() -> FaultRegistry:
    return _default


def seed(value: int) -> None:
    """Re-seed the default registry (only affects specs armed after)."""
    _default.seed = int(value)


def arm(point: str, kind: str = "raise", **kw) -> FaultSpec:
    return _default.arm(point, kind, **kw)


def disarm(point: str) -> None:
    _default.disarm(point)


def reset() -> None:
    _default.reset()


def spec(point: str) -> Optional[FaultSpec]:
    return _default.spec(point)


def check(point: str, detail: Optional[str] = None) -> Optional[FaultSpec]:
    """The fault-point hot path: None (the overwhelmingly common case,
    one int test) or the firing spec for the call site to interpret."""
    if not _default.n_armed:
        return None
    return _default.check(point, detail)


def inject(point: str, detail: str = "") -> Optional[FaultSpec]:
    """check() + the common interpretation: sleep ``delay_s`` if set,
    raise on kind ``raise``/``die``; other kinds return the spec for
    the call site. One line for simple sites."""
    sp = check(point, detail)
    if sp is None:
        return None
    if sp.delay_s:
        time.sleep(sp.delay_s)
    if sp.kind in ("raise", "die"):
        raise sp.make_error(detail)
    return sp


@contextlib.contextmanager
def scoped(point: str, kind: str = "raise", **kw) -> Iterator[FaultSpec]:
    """Arm for the duration of a with-block, disarm on exit (even when
    the injected fault propagates out of the block)."""
    sp = arm(point, kind, **kw)
    try:
        yield sp
    finally:
        disarm(point)
