"""Wall-clock and throughput timers.

Counterpart of ``deepspeed_tpu/utils/timer.py`` (the reference's
``deepspeed/utils/timer.py``): ``timers(name).start()/stop()``,
``.elapsed()``, ``.log(names)`` and a ``ThroughputTimer`` for samples/sec.
On a CUDA device a timer records CUDA events on the current stream, so it
measures device time without stalling the host between start and stop;
``elapsed`` waits for the last event. Without a card it uses the host clock.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


class _Timer:
    def __init__(self, name: str, use_events: bool):
        self.name_ = name
        self.started_ = False
        self.use_events = use_events
        self._start = None
        self.elapsed_records: List[float] = []
        self._pending = []          # (start event, end event) not yet read

    def start(self) -> None:
        if self.started_:
            raise RuntimeError(f"timer {self.name_} has already been started")
        if self.use_events:
            self._start = get_accelerator().Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        self.started_ = True

    def stop(self, reset: bool = False, record: bool = True) -> None:
        if not self.started_:
            raise RuntimeError(f"timer {self.name_} is not started")
        self.started_ = False
        if not record:
            return
        if self.use_events:
            end = get_accelerator().Event(enable_timing=True)
            end.record()
            self._pending.append((self._start, end))
        else:
            self.elapsed_records.append(time.perf_counter() - self._start)

    def _collect(self) -> None:
        for start, end in self._pending:
            end.synchronize()
            self.elapsed_records.append(start.elapsed_time(end) / 1e3)
        self._pending = []

    def reset(self) -> None:
        self.started_ = False
        self._pending = []
        self.elapsed_records = []

    def elapsed(self, reset: bool = True) -> float:
        """Total recorded seconds (optionally resetting)."""
        self._collect()
        total = sum(self.elapsed_records)
        if reset:
            self.elapsed_records = []
        return total

    def mean(self) -> float:
        self._collect()
        if not self.elapsed_records:
            return 0.0
        return sum(self.elapsed_records) / len(self.elapsed_records)


class SynchronizedWallClockTimer:
    """Group of named timers; CUDA events when ``use_events`` (default: a
    card is available), else the host clock."""

    def __init__(self, use_events: Optional[bool] = None):
        self.timers: Dict[str, _Timer] = {}
        self.use_events = get_accelerator().is_available() if use_events is None else use_events

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.use_events)
        return self.timers[name]

    def has_timer(self, name: str) -> bool:
        return name in self.timers

    @staticmethod
    def memory_usage() -> str:
        accel = get_accelerator()
        if not accel.is_available():
            return "Device mem stats unavailable"
        return (f"Device mem in-use {accel.memory_allocated() / 2**30:.2f} GB | "
                f"peak {accel.max_memory_allocated() / 2**30:.2f} GB")

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False, ranks: Optional[List[int]] = None) -> None:
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}")
        msg = "time (ms) | " + " | ".join(parts)
        if memory_breakdown:
            msg += " | " + self.memory_usage()
        log_dist(msg, ranks=ranks or [0])

    def get_timers(self):
        return self.timers


class NoopTimer:
    """Used when wall_clock_breakdown is off."""

    class _N:
        def start(self, *a, **k):
            pass

        def stop(self, *a, **k):
            pass

        def reset(self, *a, **k):
            pass

        def elapsed(self, *a, **k):
            return 0.0

        def mean(self):
            return 0.0

    def __init__(self):
        self._n = self._N()

    def __call__(self, name):
        return self._n

    def has_timer(self, name):
        return False

    def log(self, *a, **k):
        pass

    def get_timers(self):
        return {}


class ThroughputTimer:
    """Samples/sec reporting every ``steps_per_output`` global steps, after
    ``start_step`` warm-up steps. It synchronizes the device only on the
    steps that log, unless ``sync_every_step``."""

    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50,
                 logging_fn=None, sync_every_step: bool = True, synchronize=None):
        self.start_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or (lambda m: log_dist(m, ranks=[0]))
        self.sync_every_step = sync_every_step
        self.synchronize = synchronize or get_accelerator().synchronize

    def start(self):
        self.started = True
        if self.global_step_count >= self.start_step:
            self.start_time = time.perf_counter()

    def stop(self, global_step: bool = False, report_speed: bool = True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            will_log = (global_step and report_speed and self.steps_per_output
                        and self.global_step_count % self.steps_per_output == 0)
            if self.sync_every_step or will_log:
                self.synchronize()
            duration = time.perf_counter() - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            self.start_time = 0.0
            if will_log:
                self.logging(
                    f"micro_step={self.micro_step_count}/global_step={self.global_step_count}, "
                    f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.3f}, "
                    f"CurrSamplesPerSec="
                    f"{self.batch_size / self.step_elapsed_time * self.steps_per_output:.3f}")
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        if self.total_elapsed_time > 0 and self.global_step_count > self.start_step:
            samples = self.batch_size * (self.global_step_count - self.start_step)
            return samples / self.total_elapsed_time
        return 0.0
