"""Retried filesystem operations.

Counterpart of ``deepspeed_tpu/resilience/retry.py`` (``RetryPolicy``,
``retry``, ``NO_RETRY``): a checkpoint write that meets a flaky disk or
network filesystem retries with exponential backoff and jitter under a
wall-clock deadline, and re-raises its last error when either runs out. The
telemetry counters the JAX module bumps are a later slice; the warnings
stay. The elastic agent's ``RestartBackoff`` is a later slice too.
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
            attempt += 1
            if attempt >= policy.max_attempts:
                logger.warning(f"retry[{op}]: giving up after {attempt} attempt(s): {e}")
                raise
            d = policy.delay_for(attempt, rng)
            if policy.deadline is not None and (clock() - start) + d > policy.deadline:
                logger.warning(f"retry[{op}]: deadline {policy.deadline}s exhausted "
                               f"after {attempt} attempt(s): {e}")
                raise
            logger.warning(f"retry[{op}]: attempt {attempt}/{policy.max_attempts} "
                           f"failed ({e}); retrying in {d:.3f}s")
            sleep(d)
