"""Fault tolerance runtime: step watchdog, straggler detection, retry,
circuit breaking.

The port's own copy of ``repro/runtime/fault.py`` (the port imports nothing
of the JAX package); the two must stay equal in behaviour.

At 1000+ nodes the common failure modes are (a) a slow chip dragging the
synchronous step (straggler), (b) a hung collective, (c) preemption.  This
module provides the host-side instrumentation: an EMA step timer that flags
outliers, a watchdog thread that aborts a hung step after a deadline (so the
launcher's restart-from-checkpoint path takes over), a bounded-retry
wrapper for transient failures (seeded-deterministic exponential backoff),
and a generic tick-based :class:`CircuitBreaker` that converts persistent
failure into rare, bounded probing instead of retry thrash — the serving
engine uses one instance to gate request re-queues and another to gate
mid-run re-promotion back to the device-resident scheduler.
"""

from __future__ import annotations

import dataclasses
import random as _random
import threading
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StepStats:
    ema: float = 0.0
    n: int = 0
    stragglers: List[dict] = dataclasses.field(default_factory=list)


class StepTimer:
    """EMA step timer; flags steps slower than ``threshold``x the EMA.

    On a real cluster the per-host step times are all-gathered out-of-band
    (out of band) and the arg-max host is the straggler;
    single-host here, the flagged entity is the step itself.
    """

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1):
        self.threshold = threshold
        self.alpha = alpha
        self.stats = StepStats()

    def record(self, step: int, seconds: float) -> bool:
        s = self.stats
        is_straggler = bool(s.n >= 5 and seconds > self.threshold * s.ema)
        if is_straggler:
            s.stragglers.append({"step": step, "seconds": seconds,
                                 "ema": s.ema})
        s.ema = seconds if s.n == 0 else (
            (1 - self.alpha) * s.ema + self.alpha * seconds)
        s.n += 1
        return is_straggler


class Watchdog:
    """Aborts the process if a step exceeds ``deadline_s`` (hung collective).
    The cluster launcher restarts from the latest checkpoint."""

    def __init__(self, deadline_s: float,
                 on_timeout: Optional[Callable] = None):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout or self._default_timeout
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _default_timeout(self):
        self.fired = True

    def __enter__(self):
        self._timer = threading.Timer(self.deadline_s, self.on_timeout)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False


def backoff_delay(base_s: float, attempt: int, *, seed=None,
                  factor: float = 2.0, jitter: float = 0.5,
                  max_s: Optional[float] = None) -> float:
    """Exponential backoff delay with seeded *deterministic* jitter.

    ``base_s * factor**attempt``, optionally capped at ``max_s`` and then
    multiplied by a jitter factor drawn uniformly from
    ``[1 - jitter, 1 + jitter]``.  The draw is keyed on ``(seed, attempt)``
    only — the same pair yields the same delay on every host and every run,
    so retry schedules (and therefore serving traces) stay reproducible
    while still decorrelating independent retriers.  ``seed=None`` disables
    jitter entirely.
    """
    d = float(base_s) * float(factor) ** int(attempt)
    if max_s is not None:
        d = min(d, float(max_s))
    if seed is not None and jitter > 0.0:
        u = _random.Random(f"{seed}:{attempt}").random()
        d *= 1.0 - jitter + 2.0 * jitter * u
    return d


def with_retries(fn: Callable, max_retries: int = 2,
                 retry_on=(RuntimeError,), backoff_s: float = 0.1,
                 seed=None, jitter: float = 0.5,
                 max_backoff_s: Optional[float] = None):
    """Bounded retry for transiently failing steps (e.g. a NaN loss step that
    a data skip resolves, or a flaky interconnect error).

    Backoff is exponential; pass ``seed`` to add deterministic jitter (see
    :func:`backoff_delay`).  The default ``seed=None`` keeps the original
    fixed ``backoff_s * 2**attempt`` schedule.
    """
    def wrapped(*args, **kwargs):
        for attempt in range(max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except retry_on:
                if attempt == max_retries:
                    raise
                d = backoff_delay(backoff_s, attempt, seed=seed,
                                  jitter=jitter, max_s=max_backoff_s)
                if d > 0.0:
                    time.sleep(d)
    return wrapped


class CircuitBreaker:
    """Generic closed / open / half-open circuit breaker over a trip window.

    Time is advanced explicitly by the caller via :meth:`tick` (the serving
    engine ticks once per scheduler beat), so behaviour is deterministic
    under test — no wall-clock dependence.

    - **closed**: calls flow.  ``threshold`` failures within the trailing
      ``window`` ticks trip the breaker open.
    - **open**: :meth:`allow` returns False for ``cooldown`` ticks, then the
      breaker goes half-open.
    - **half-open**: one trial is allowed.  :meth:`record_success` closes
      the breaker and resets the cooldown to its base value;
      :meth:`record_failure` re-opens it with the cooldown multiplied by
      ``cooldown_factor`` (capped at ``max_cooldown``), so a *persistent*
      fault converges to exponentially rarer probing — bounded work —
      instead of retry thrash.
    """

    def __init__(self, threshold: int = 3, window: int = 16,
                 cooldown: int = 4, cooldown_factor: float = 2.0,
                 max_cooldown: int = 256):
        self.threshold = int(threshold)
        self.window = int(window)
        self.cooldown = float(cooldown)
        self.cooldown_factor = float(cooldown_factor)
        self.max_cooldown = float(max_cooldown)
        self._base_cooldown = float(cooldown)
        self._state = "closed"
        self._now = 0
        self._opened_at = 0
        self._fail_ticks: List[int] = []
        self.trips = 0

    @property
    def state(self) -> str:
        return self._state

    def tick(self) -> None:
        self._now += 1
        if (self._state == "open"
                and self._now - self._opened_at >= self.cooldown):
            self._state = "half_open"

    def allow(self) -> bool:
        """Whether a call (or a half-open trial probe) may proceed now."""
        return self._state != "open"

    def record_success(self) -> None:
        if self._state == "half_open":
            self.cooldown = self._base_cooldown
        self._state = "closed"
        self._fail_ticks = []

    def record_failure(self) -> None:
        if self._state == "half_open":
            self.cooldown = min(self.cooldown * self.cooldown_factor,
                                self.max_cooldown)
            self._trip()
            return
        if self._state == "open":
            return
        self._fail_ticks.append(self._now)
        self._fail_ticks = [t for t in self._fail_ticks
                            if self._now - t < self.window]
        if len(self._fail_ticks) >= self.threshold:
            self._trip()

    def _trip(self) -> None:
        self._state = "open"
        self._opened_at = self._now
        self._fail_ticks = []
        self.trips += 1
