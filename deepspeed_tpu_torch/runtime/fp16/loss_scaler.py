"""FP16 loss scaling.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (the
reference's LossScaler / DynamicLossScaler): on an inf/nan gradient the step
is skipped and the scale halves once ``delayed_shift`` consecutive overflows
have used up the hysteresis; after ``scale_window`` clean steps it doubles;
it never drops below ``min_scale``. The JAX package keeps this state on the
device so its compiled step never waits on the host; the port's eager
engine reads the step's overflow verdict on the host (one sync per fp16
step, as the reference does), so the state is a small tuple of Python
numbers and the transition a pure function.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
CONSECUTIVE_HYSTERESIS = "consecutive_hysteresis"
MIN_LOSS_SCALE = "min_scale"


class LossScaleState(NamedTuple):
    scale: float
    good_steps: int   # clean steps since the last overflow or raise
    hysteresis: int   # overflows still tolerated before halving
    overflows: int    # total skipped steps


def make_state(init_scale: float) -> LossScaleState:
    return LossScaleState(scale=float(init_scale), good_steps=0, hysteresis=1, overflows=0)


def grads_finite(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor on the grads' device: every element of every gradient
    is finite. One fused reduction per tensor; nothing waits on the host."""
    if not grads:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


class DynamicLossScaler:
    """Stateless policy object; the state is a LossScaleState."""

    def __init__(self, init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 1000, min_scale: float = 1.0,
                 delayed_shift: int = 1, consecutive_hysteresis: bool = False,
                 raise_error_at_min_scale: bool = False, dtype=torch.float16):
        self.init_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = max(1, delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis
        self.dtype = dtype

    def initial_state(self) -> LossScaleState:
        return make_state(self.init_scale)._replace(hysteresis=self.delayed_shift)

    def update(self, state: LossScaleState, finite: bool) -> LossScaleState:
        """Pure transition: apply one step's overflow verdict."""
        overflow = not finite
        hys = max(state.hysteresis - 1, 0) if overflow else state.hysteresis
        scale = state.scale
        halve = overflow and hys == 0
        if halve:
            scale = max(scale / self.scale_factor, self.min_scale)
            hys = self.delayed_shift
        elif finite and self.consecutive_hysteresis:
            hys = self.delayed_shift
        good = state.good_steps + 1 if finite else 0
        if finite and good >= self.scale_window:
            scale, good = scale * self.scale_factor, 0
        return LossScaleState(scale=scale, good_steps=good, hysteresis=hys,
                              overflows=state.overflows + int(overflow))


class LossScaler(DynamicLossScaler):
    """Static scaling: the scale never changes."""

    def __init__(self, scale: float = 1.0):
        super().__init__(init_scale=scale)

    def update(self, state: LossScaleState, finite: bool) -> LossScaleState:
        return state._replace(overflows=state.overflows + int(not finite))


def CreateLossScaler(dtype, static_loss_scale: float, dynamic_scaling: bool,
                     dynamic_loss_args=None):
    """The reference's factory: dynamic scaling for fp16 when asked, else a
    static scale (1.0 outside fp16)."""
    if dtype == torch.float16 and dynamic_scaling:
        kwargs = dynamic_loss_args or {}
        return DynamicLossScaler(
            dtype=dtype,
            init_scale=kwargs.get(INITIAL_LOSS_SCALE, 2.0 ** 16),
            scale_window=kwargs.get(SCALE_WINDOW, 1000),
            min_scale=kwargs.get(MIN_LOSS_SCALE, 1.0),
            delayed_shift=kwargs.get(DELAYED_SHIFT, 1),
            consecutive_hysteresis=kwargs.get(CONSECUTIVE_HYSTERESIS, False))
    scale = static_loss_scale if (dtype == torch.float16 and static_loss_scale > 0) else 1.0
    return LossScaler(scale=scale)
