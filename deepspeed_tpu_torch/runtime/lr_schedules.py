"""Learning-rate schedules.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` (the reference's
LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR and WarmupCosineLR). Each
schedule is a pure ``lr_at(step)`` function — the same formulas, evaluated
in Python floats where the JAX package traces them in fp32 — wrapped in a
class with the reference's ``step()/get_lr()/state_dict()/load_state_dict()``
surface. The engine reads ``lr_at(global step)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


class LRSchedule:
    """Base: pure function core + stateful torch-style wrapper."""

    def __init__(self):
        self.last_batch_iteration = -1

    def lr_at(self, step) -> float:
        raise NotImplementedError

    def __call__(self, step) -> float:
        return self.lr_at(step)

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self) -> List[float]:
        return [float(self.lr_at(max(0, self.last_batch_iteration)))]

    def get_last_lr(self) -> List[float]:
        return self.get_lr()

    def state_dict(self) -> Dict:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(LRSchedule):
    """Linear (or log) warmup from warmup_min_lr to warmup_max_lr, then flat."""

    def __init__(self, optimizer=None, warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000, warmup_type: str = "log",
                 last_batch_iteration: int = -1):
        super().__init__()
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration

    def _warmup_gamma(self, step) -> float:
        step = float(step)
        if self.warmup_type == "log":
            g = math.log(max(step, 1.0)) * self.inverse_log_warm_up
        else:
            g = step / self.warmup_num_steps
        return _clip(g, 0.0, 1.0)

    def lr_at(self, step) -> float:
        g = self._warmup_gamma(step)
        return self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * g


class WarmupDecayLR(WarmupLR):
    """Warmup, then linear decay to 0 at total_num_steps."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", last_batch_iteration: int = -1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps

    def lr_at(self, step) -> float:
        step = float(step)
        if step < self.warmup_num_steps:
            return super().lr_at(step)
        decay = _clip((self.total_num_steps - step)
                      / max(1.0, self.total_num_steps - self.warmup_num_steps), 0.0, 1.0)
        return self.warmup_max_lr * decay


class WarmupCosineLR(WarmupLR):
    """Warmup, then cosine decay towards cos_min_ratio * warmup_max_lr."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000,
                 warmup_min_ratio: float = 0.0, warmup_num_steps: int = 1000,
                 cos_min_ratio: float = 0.0001, warmup_type: str = "linear",
                 warmup_max_lr: float = 0.001, last_batch_iteration: int = -1):
        super().__init__(optimizer, warmup_min_ratio * warmup_max_lr, warmup_max_lr,
                         warmup_num_steps, warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps
        self.cos_min_ratio = cos_min_ratio

    def lr_at(self, step) -> float:
        step = float(step)
        if step < self.warmup_num_steps:
            return super().lr_at(step)
        progress = _clip((step - self.warmup_num_steps)
                         / max(1.0, self.total_num_steps - self.warmup_num_steps), 0.0, 1.0)
        cos = self.cos_min_ratio + (1 - self.cos_min_ratio) * 0.5 * (1 + math.cos(math.pi * progress))
        return self.warmup_max_lr * cos


class LRRangeTest(LRSchedule):
    """LR range-test sweep: lr grows from min by a staircase or a ramp."""

    def __init__(self, optimizer=None, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000, lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False, last_batch_iteration: int = -1):
        super().__init__()
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step) -> float:
        step = float(step)
        interval = math.floor(step / self.step_size) if self.staircase else step / self.step_size
        return self.min_lr * (1 + interval * self.step_rate)


class OneCycle(LRSchedule):
    """1-cycle policy: lr ramps min→max over cycle_first_step_size, back down
    over cycle_second_step_size, then decays."""

    def __init__(self, optimizer=None, cycle_min_lr: float = 0.0, cycle_max_lr: float = 0.001,
                 decay_lr_rate: float = 0.0, cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0, cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, cycle_momentum: bool = True,
                 cycle_min_mom: float = 0.8, cycle_max_mom: float = 0.9,
                 decay_mom_rate: float = 0.0, last_batch_iteration: int = -1):
        super().__init__()
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first = cycle_first_step_size
        self.second = (cycle_second_step_size if cycle_second_step_size is not None
                       else cycle_first_step_size)
        self.decay_step_size = max(1, decay_step_size)
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step) -> float:
        step = float(step)
        if step <= self.first:
            up = _clip(step / self.first, 0.0, 1.0)
            return self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * up
        if step <= self.first + self.second:
            down = _clip((step - self.first) / self.second, 0.0, 1.0)
            return self.cycle_max_lr - (self.cycle_max_lr - self.cycle_min_lr) * down
        if self.decay_lr_rate > 0:
            decay_steps = max(0.0, step - self.first - self.second) / self.decay_step_size
            return self.cycle_min_lr / (1.0 + decay_steps * self.decay_lr_rate)
        return self.cycle_min_lr

    def mom_at(self, step) -> float:
        step = float(step)
        if step <= self.first:
            up = _clip(step / self.first, 0.0, 1.0)
            return self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * up
        down = _clip((step - self.first) / self.second, 0.0, 1.0)
        return self.cycle_min_mom + (self.cycle_max_mom - self.cycle_min_mom) * down


SCHEDULE_REGISTRY = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
}


def build_lr_schedule(name: str, params: dict, optimizer=None) -> LRSchedule:
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"Unknown scheduler {name}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_REGISTRY[name](optimizer, **params)
