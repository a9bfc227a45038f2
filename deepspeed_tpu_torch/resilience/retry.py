"""Retried filesystem operations.

Counterpart of ``deepspeed_tpu/resilience/retry.py`` (``RetryPolicy``,
``retry``, ``NO_RETRY``, ``RestartBackoff``): a checkpoint write that meets
a flaky disk or network filesystem retries with exponential backoff and
jitter under a wall-clock deadline, and re-raises its last error when
either runs out. Each retry bumps the telemetry counter
``resilience/retries{op}`` and a give-up ``resilience/retry_exhausted{op}``,
as in JAX. :class:`RestartBackoff` paces the elastic agent's restarts.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type

from deepspeed_tpu_torch.utils.logging import logger


@dataclasses.dataclass
class RetryPolicy:
    """Attempt ``n`` (1-based) sleeps ``min(max_delay, base_delay *
    multiplier**(n-1))``, scaled by ±``jitter``, before the next try. Gives
    up, re-raising the last exception, after ``max_attempts`` failed calls
    or when the next sleep would pass ``deadline`` seconds since the first
    call. Only exceptions in ``retry_on`` are retried."""
    max_attempts: int = 4
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    deadline: Optional[float] = 30.0
    jitter: float = 0.25
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    # None draws the jitter from OS entropy, so processes that meet the same
    # flaky filesystem do not retry in step; a seed is for tests
    seed: Optional[int] = None

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        d = min(self.max_delay, self.base_delay * self.multiplier ** max(0, attempt - 1))
        if self.jitter:
            d *= 1.0 + self.jitter * rng.uniform(-1.0, 1.0)
        return max(0.0, d)


NO_RETRY = RetryPolicy(max_attempts=1, deadline=None)


def retry(fn: Callable, policy: Optional[RetryPolicy] = None, *, op: str = "",
          sleep: Callable[[float], None] = time.sleep,
          clock: Callable[[], float] = time.monotonic):
    """``fn()`` under ``policy``: its value, or its last exception once the
    attempts or the deadline are used up. ``sleep`` and ``clock`` can be
    replaced in tests."""
    policy = policy or RetryPolicy()
    rng = random.Random(policy.seed)
    start = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except policy.retry_on as e:
            from deepspeed_tpu_torch import telemetry

            labels = {"op": op or "unknown"}
            attempt += 1
            if attempt >= policy.max_attempts:
                telemetry.get_registry().counter("resilience/retry_exhausted",
                                                 labels=labels).inc()
                logger.warning(f"retry[{op}]: giving up after {attempt} attempt(s): {e}")
                raise
            d = policy.delay_for(attempt, rng)
            if policy.deadline is not None and (clock() - start) + d > policy.deadline:
                telemetry.get_registry().counter("resilience/retry_exhausted",
                                                 labels=labels).inc()
                logger.warning(f"retry[{op}]: deadline {policy.deadline}s exhausted "
                               f"after {attempt} attempt(s): {e}")
                raise
            telemetry.get_registry().counter("resilience/retries", labels=labels).inc()
            logger.warning(f"retry[{op}]: attempt {attempt}/{policy.max_attempts} "
                           f"failed ({e}); retrying in {d:.3f}s")
            sleep(d)


@dataclasses.dataclass
class RestartBackoff:
    """The elastic agent's restart pacing: each consecutive failure doubles
    the delay up to ``max_delay``, scaled by ±``jitter``; :meth:`reset`
    after a healthy stretch."""
    base_delay: float = 0.1
    multiplier: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.25
    seed: Optional[int] = None   # None: OS entropy (see RetryPolicy.seed)
    attempt: int = 0
    _rng: random.Random = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def next_delay(self) -> float:
        d = min(self.max_delay, self.base_delay * self.multiplier ** self.attempt)
        self.attempt += 1
        if self.jitter:
            d *= 1.0 + self.jitter * self._rng.uniform(-1.0, 1.0)
        return max(0.0, d)

    def reset(self):
        self.attempt = 0
