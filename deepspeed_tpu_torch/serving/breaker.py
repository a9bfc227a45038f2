"""Circuit breaker around the inference engine.

Counterpart of ``deepspeed_tpu/serving/breaker.py``. When the engine fails
every tick (a sick card, a poisoned cache), admitting more traffic turns
one failure into a herd of slow ones. The breaker is the three-state
machine, tuned for the serving tick loop:

* **closed**: normal; consecutive tick failures are counted, a success
  resets the count.
* **open**: ``threshold`` consecutive failures tripped it; every admission
  is refused with a retry-after of the remaining cooldown, and the
  front-end sheds what is queued (degraded readiness). Only time moves it
  on.
* **half_open**: the cooldown elapsed; exactly one request (the probe) is
  admitted. Its success closes the circuit, its failure re-opens it and
  restarts the cooldown.

Every transition reaches telemetry through ``on_transition`` (the
front-end counts ``serving/circuit_transitions{from,to}``) and, with the
flight recorder armed, its ring as a ``breaker_transition`` event (error
on a trip to open: a bundle). Thread-safe; the clock is injectable for
tests.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional, Tuple

from deepspeed_tpu_torch.utils import locks as _locks
from deepspeed_tpu_torch.utils.logging import logger

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 on_transition: Optional[Callable[[str, str], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 lock: Optional[threading.RLock] = None):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.on_transition = on_transition
        self._clock = clock
        # the front-end passes ITS lock so breaker state and queue state
        # mutate under one lock — two locks here would be an ABBA deadlock
        # between submit (front-end → breaker) and the worker's
        # record_failure → on_transition shed (breaker → front-end)
        self._lock = lock if lock is not None else _locks.make_rlock("serving.breaker")
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self.transitions: list = []      # (from, to, monotonic) history

    # ------------------------------------------------------------------ state
    @property
    def state(self) -> str:
        """Current state; lazily moves open → half_open once the cooldown
        has elapsed (time is the only thing that can)."""
        with self._lock:
            if self._state == OPEN and \
                    self._clock() - self._opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN)
            return self._state

    def _transition(self, to: str) -> None:
        frm = self._state
        if frm == to:
            return
        self._state = to
        if to == OPEN:
            self._opened_at = self._clock()
            self._probe_in_flight = False
        if to == CLOSED:
            self._consecutive_failures = 0
            self._probe_in_flight = False
        self.transitions.append((frm, to, self._clock()))
        logger.warning(f"serving circuit breaker: {frm} -> {to} "
                       f"(consecutive_failures={self._consecutive_failures})")
        bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
        if bb is not None:
            # tripping open is the incident; the recovering transitions are context
            bb.record("breaker_transition", "error" if to == OPEN else "info",
                      {"from": frm, "to": to,
                       "consecutive_failures": self._consecutive_failures})
        if self.on_transition is not None:
            self.on_transition(frm, to)

    # -------------------------------------------------------------- admission
    def admits(self) -> Tuple[bool, float]:
        """(may this request be admitted, retry-after hint). Half-open
        admits exactly one probe at a time; open refuses with the
        remaining cooldown."""
        with self._lock:
            st = self.state                      # may lazily half-open
            if st == CLOSED:
                return True, 0.0
            if st == HALF_OPEN:
                if self._probe_in_flight:
                    return False, self.cooldown_s
                self._probe_in_flight = True
                return True, 0.0
            remaining = max(0.0, self.cooldown_s -
                            (self._clock() - self._opened_at))
            return False, remaining

    # ---------------------------------------------------------------- results
    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._transition(CLOSED)
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                self._transition(OPEN)           # the probe failed
            elif self._state == CLOSED and \
                    self._consecutive_failures >= self.threshold:
                self._transition(OPEN)
            self._probe_in_flight = False

    def release_probe(self) -> None:
        """Give the half-open probe slot back WITHOUT a verdict — for a
        probe that ended by its own deadline (queue wait, drain) before
        any tick could succeed or fail. Without this, a deadline-expired
        probe would leave ``_probe_in_flight`` set forever and the
        breaker wedged in half_open, shedding every future request."""
        with self._lock:
            self._probe_in_flight = False
