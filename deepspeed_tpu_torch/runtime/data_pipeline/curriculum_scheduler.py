"""Curriculum learning scheduler: difficulty as a function of the step.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``
(the reference's ``CurriculumScheduler``), with the schedules
``fixed_linear``, ``fixed_root``, ``fixed_discrete`` and ``custom``; it
serves the legacy ``curriculum_learning`` block and each metric of
``data_efficiency.data_sampling.curriculum_learning``. Host-side step math.
On the card every difficulty is a new sequence length for the attention
kernels, which take any length; ``difficulty_step`` only bounds the padding
of the kernels' 64-row tiles.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger

FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:
    """Config keys: curriculum_type, min_difficulty, max_difficulty,
    schedule_type, schedule_config{...}."""

    def __init__(self, config: Dict):
        for req in ("min_difficulty", "max_difficulty", "schedule_type"):
            if req not in config:
                raise ValueError(f"Curriculum learning requires the config '{req}'")
        self.min_difficulty = int(config["min_difficulty"])
        self.max_difficulty = int(config["max_difficulty"])
        self.curriculum_type = config.get("curriculum_type", "seqlen")
        self.schedule_type = config["schedule_type"]
        self.schedule_config = dict(config.get("schedule_config", {}))
        self.current_difficulty = self.min_difficulty
        self._custom_fn: Optional[Callable[[int], int]] = None

        sc = self.schedule_config
        if self.schedule_type == FIXED_DISCRETE:
            diff = sc.get("difficulty", [])
            max_step = sc.get("max_step", [])
            if not (len(diff) > 0 and len(diff) == len(max_step) + 1):
                raise ValueError("fixed_discrete needs len(difficulty) == len(max_step) + 1")
        elif self.schedule_type in (FIXED_LINEAR, FIXED_ROOT):
            for req in ("total_curriculum_step", "difficulty_step") + (
                    ("root_degree",) if self.schedule_type == FIXED_ROOT else ()):
                if req not in sc:
                    raise ValueError(f"{self.schedule_type} requires schedule_config.{req}")
            if int(sc["difficulty_step"]) % 8 != 0:
                logger.warning("curriculum difficulty_step should be a multiple of 8 to "
                               "limit padding in the attention kernels' tiles")
        elif self.schedule_type != CUSTOM:
            raise ValueError(f"unknown curriculum schedule_type {self.schedule_type!r}")

    # ------------------------------------------------------------- schedules
    def set_custom_get_difficulty(self, fn: Callable[[int], int]):
        self._custom_fn = fn

    def _fixed_root(self, step: int, root_degree: Optional[int] = None) -> int:
        sc = self.schedule_config
        if root_degree is None:
            root_degree = int(sc["root_degree"])
        frac = (float(step) / float(sc["total_curriculum_step"])) ** (1.0 / root_degree)
        nxt = int(math.floor(frac * (self.max_difficulty - self.min_difficulty)
                             + self.min_difficulty))
        nxt -= nxt % int(sc["difficulty_step"])
        return max(self.min_difficulty, min(nxt, self.max_difficulty))

    def _fixed_discrete(self, step: int) -> int:
        diff = self.schedule_config["difficulty"]
        for d, ms in zip(diff, self.schedule_config["max_step"]):
            if step <= ms:
                return int(d)
        return int(diff[-1])

    def get_difficulty(self, global_steps: int) -> int:
        if self.schedule_type == FIXED_LINEAR:
            return self._fixed_root(global_steps, root_degree=1)
        if self.schedule_type == FIXED_ROOT:
            return self._fixed_root(global_steps)
        if self.schedule_type == FIXED_DISCRETE:
            return self._fixed_discrete(global_steps)
        if self._custom_fn is None:
            raise RuntimeError("custom schedule requires set_custom_get_difficulty(fn)")
        return int(self._custom_fn(global_steps))

    def update_difficulty(self, global_steps: int) -> int:
        self.current_difficulty = self.get_difficulty(global_steps)
        return self.current_difficulty

    def get_current_difficulty(self) -> int:
        return self.current_difficulty

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> Dict:
        return {"current_difficulty": self.current_difficulty}

    def load_state_dict(self, sd: Dict):
        self.current_difficulty = int(sd["current_difficulty"])
