"""Deadlines, retries, jittered exponential backoff.

A copy of ``parameter_server_tpu/utils/retry.py`` (the port keeps its
own, as it imports nothing of the JAX package):

- :class:`DeadlineExceeded` — the explicit deadline miss. Subclasses
  ``TimeoutError`` so ``except TimeoutError`` callers keep working, but
  carries the operation name and budget for diagnostics.
- :class:`RetryPolicy` — immutable retry/backoff parameters (attempts,
  exponential backoff with a seeded jitter, optional overall deadline).
- :func:`call_with_retry` — run a callable under a policy.
- :class:`Deadline` — a countdown budget to thread through multi-step
  waits.

The serving plane raises :class:`DeadlineExceeded` from
``Ticket.result`` and ``PullTicket.result``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type


class DeadlineExceeded(TimeoutError):
    """An operation missed its deadline.

    ``op`` names the operation (e.g. ``"executor:store wait(42)"``),
    ``deadline_s`` the budget that was exceeded. A TimeoutError
    subclass: callers that only care that time ran out need no code
    change; callers that diagnose get the message and fields.
    """

    def __init__(self, message: str, *, op: str = "",
                 deadline_s: Optional[float] = None):
        super().__init__(message)
        self.op = op
        self.deadline_s = deadline_s


class Deadline:
    """A countdown budget: construct once, ask ``remaining()`` at each
    blocking step. ``None`` budget = infinite (every query says so)."""

    __slots__ = ("_t_end", "_clock", "budget_s")

    def __init__(self, budget_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = budget_s
        self._clock = clock
        self._t_end = None if budget_s is None else clock() + budget_s

    def remaining(self) -> Optional[float]:
        """Seconds left (may be <= 0), or None for no deadline."""
        if self._t_end is None:
            return None
        return self._t_end - self._clock()

    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry/backoff parameters.

    Backoff for attempt ``a`` (0-based) is
    ``min(max_delay_s, base_delay_s * multiplier**a)`` scaled by a
    uniform jitter in ``[1 - jitter, 1 + jitter]`` — jitter is drawn
    from a SEEDED generator per :func:`call_with_retry` call, so two
    runs of the same drill back off identically (the determinism
    contract every chaos-plane component keeps). ``deadline_s`` bounds
    the whole attempt sequence: a retry whose backoff would overrun it
    raises :class:`DeadlineExceeded` immediately instead of sleeping
    into a guaranteed miss.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        d = min(self.max_delay_s, self.base_delay_s * self.multiplier ** attempt)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


#: no-retry policy (one attempt, fail fast) for callers that want the
#: deadline bookkeeping without the retries
NO_RETRY = RetryPolicy(max_attempts=1)


def call_with_retry(
    fn: Callable,
    policy: RetryPolicy = RetryPolicy(),
    *,
    op: str = "operation",
    seed: int = 0,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
):
    """Run ``fn()`` under ``policy``; returns its value.

    Exceptions outside ``policy.retry_on`` propagate immediately. The
    final attempt's exception propagates unwrapped (callers see the
    real failure, with the retry history only in ``on_retry``).
    ``on_retry(attempt, error, backoff_s)`` fires before each sleep —
    telemetry/log hook, must not raise.
    """
    rng = random.Random(seed)
    deadline = Deadline(policy.deadline_s, clock)
    for attempt in range(max(1, policy.max_attempts)):
        try:
            return fn()
        except policy.retry_on as e:
            if attempt + 1 >= max(1, policy.max_attempts):
                raise
            delay = policy.backoff_s(attempt, rng)
            remaining = deadline.remaining()
            if remaining is not None and delay >= remaining:
                raise DeadlineExceeded(
                    f"{op}: attempt {attempt + 1} failed "
                    f"({type(e).__name__}: {e}) and the {delay:.3f}s "
                    f"backoff would overrun the {policy.deadline_s}s "
                    "retry deadline",
                    op=op, deadline_s=policy.deadline_s,
                ) from e
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
