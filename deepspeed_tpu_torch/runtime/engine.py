"""DeepSpeedEngine — the training engine, single-device path.

Counterpart of ``deepspeed_tpu/runtime/engine.py``. The JAX engine is
functional: all training state lives in one ``TrainState`` pytree and one
compiled program advances it. Here the state is the model's own parameters
(in the compute type, on the card), an fp32 master copy of them whenever the
compute type is not fp32, the optimizer's fp32 state, the loss scaler's
state and the step counters; PyTorch runs the step eagerly.

``train_batch(batch)`` splits the global batch into gradient-accumulation
microbatches, runs each one's forward and backward, and applies the
optimizer once, as the JAX ``_apply_grads`` does: finite check (fp16), the
unscaled global norm taken from the scaled grads, clip coefficient
min(1, clip / (norm + 1e-6)), the optimizer update on the masters, the copy
back to the compute type; on overflow params and optimizer state are kept,
the step counter advances and the loss scale backs off. The reference's
three-call API (``forward`` / ``backward`` / ``step``) runs the same pieces.

Gradients never accumulate in the compute type: a post-accumulate hook on
each parameter moves its gradient into an fp32 buffer (or
``data_types.grad_accum_dtype``) as soon as autograd has it, and the buffers
are freed after the step. The tied GPT-2 embedding is one parameter, so
autograd sums its two contributions before the hook sees them.

The engine runs on CUDA unless it is given ``device="cpu"``; without a card
it raises. One process only: ZeRO placement and communication over
``torch.distributed``, checkpoints, the data loader, offload and the
observability blocks are later slices and raise when configured.
"""

from __future__ import annotations

import functools
import weakref
from typing import Any, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.ops.optimizers import Optimizer, build_optimizer
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler, grads_finite
from deepspeed_tpu_torch.runtime.lr_schedules import LRSchedule, build_lr_schedule
from deepspeed_tpu_torch.runtime.utils import get_grad_norm
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER, NoopTimer,
                                             SynchronizedWallClockTimer, ThroughputTimer)


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: later slice of the port")


def _grad_hook(acc: List[Optional[torch.Tensor]], i: int, dtype: torch.dtype):
    """A post-accumulate hook for parameter ``i``: move its fresh gradient
    into ``acc[i]`` (in ``dtype``) and free ``param.grad``. It holds the
    buffer list, not the engine, so a deleted engine frees its state."""
    def hook(p):
        g, p.grad = p.grad, None
        if acc[i] is None:
            acc[i] = g if g.dtype == dtype else g.to(dtype)
        else:
            acc[i].add_(g)
    return hook


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    lr: float
    loss_scale: float
    overflow: bool


class DeepSpeedEngine:
    def __init__(self, args=None, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config=None, config_class: Optional[DeepSpeedConfig] = None,
                 dont_change_device=False, device=None):
        if config_class is None:
            config_class = DeepSpeedConfig(config if config is not None else {})
        self._config = config_class

        # ---- world: one process ------------------------------------------
        world = torch.distributed.get_world_size() if (
            torch.distributed.is_available() and torch.distributed.is_initialized()) else 1
        if world > 1:
            raise _later(f"training over {world} processes (ZeRO placement and "
                         "communication over torch.distributed)")
        if mpu is not None:
            raise _later("model parallelism (mpu)")
        if training_data is not None:
            raise _later("the data loader (training_data)")
        self.dp_world_size = self.mp_world_size = 1
        self._config._configure_train_batch_size(self.dp_world_size)

        # ---- model protocol ----------------------------------------------
        if not (isinstance(model, torch.nn.Module) and hasattr(model, "loss")):
            raise ValueError("model must be an nn.Module with .loss(batch)")
        self.module = model
        self.device = resolve_device(device)
        self.train_dtype = self._config.train_dtype
        self.fp16_enabled = self._config.fp16.enabled
        self.bf16_enabled = self._config.bf16.enabled
        self.zero_stage = self._config.zero_optimization_stage

        # ---- state -------------------------------------------------------
        if model_parameters is not None:
            if not isinstance(model_parameters, Mapping):
                raise ValueError("model_parameters must be a state dict for the model")
            model.load_state_dict(model_parameters, assign=True)
        if any(p.is_meta for p in model.parameters()):
            # no weights given: random weights from the config's seed, as
            # the JAX engine draws them from PRNGKey(seed)
            model.init_params(torch.Generator(device=self.device).manual_seed(self._config.seed))
        model.to(device=self.device)
        self._params: List[torch.nn.Parameter] = [p for p in model.parameters()
                                                  if p.requires_grad]
        if not self._params:
            raise ValueError("the model has no trainable parameters")
        # fp32 master copy whenever the compute type is not fp32, taken before
        # the params are cast so it keeps the fp32 values
        self._keep_master = self.train_dtype != torch.float32 and (
            self.fp16_enabled or self._config.bf16.master_weights)
        self.master = ([p.detach().float().clone() for p in self._params]
                       if self._keep_master else None)
        model.to(dtype=self.train_dtype)

        # ---- optimizer, schedule, loss scaler ----------------------------
        self.optimizer = self._configure_optimizer(optimizer)
        self.opt_state = self.optimizer.init(self._targets())
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.loss_scaler = None
        self.scaler_state = None
        if self.fp16_enabled:
            f = self._config.fp16
            self.loss_scaler = CreateLossScaler(
                self.train_dtype, f.loss_scale, f.loss_scale == 0.0,
                dynamic_loss_args={"init_scale": 2.0 ** f.initial_scale_power,
                                   "scale_window": f.loss_scale_window,
                                   "min_scale": f.min_loss_scale,
                                   "delayed_shift": f.hysteresis,
                                   "consecutive_hysteresis": f.consecutive_hysteresis})
            self.scaler_state = self.loss_scaler.initial_state()

        # ---- gradient accumulation ---------------------------------------
        self._grad_acc: List[Optional[torch.Tensor]] = [None] * len(self._params)
        hooks = [p.register_post_accumulate_grad_hook(
            _grad_hook(self._grad_acc, i, self._config.grad_accum_dtype))
            for i, p in enumerate(self._params)]
        # the model outlives the engine: its hooks go with the engine
        weakref.finalize(self, lambda: [h.remove() for h in hooks])

        # ---- counters and timers -----------------------------------------
        self._global_step = 0
        self._skipped_steps = 0
        self._last_metrics: Optional[StepMetrics] = None
        self._micro_loss = None
        self.micro_steps = 0
        self.global_samples = 0
        on_card = self.device.type == "cuda"
        self.wall_clock_breakdown = self._config.wall_clock_breakdown
        self.timers = (SynchronizedWallClockTimer(use_events=on_card)
                       if self.wall_clock_breakdown else NoopTimer())
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(), steps_per_output=self._config.steps_per_print,
            sync_every_step=self.wall_clock_breakdown,
            synchronize=functools.partial(torch.cuda.synchronize, self.device) if on_card
            else (lambda: None))
        log_dist(f"engine ready: dtype={self.train_dtype}, zero={self.zero_stage}, "
                 f"device={self.device}, micro_batch={self.train_micro_batch_size_per_gpu()}, "
                 f"gas={self._config.gradient_accumulation_steps}", ranks=[0])

    # ------------------------------------------------------------- plumbing
    def _configure_optimizer(self, client) -> Optimizer:
        if client is not None:
            if not isinstance(client, Optimizer):
                raise ValueError("client optimizer must be a "
                                 "deepspeed_tpu_torch.ops.optimizers.Optimizer")
            log_dist("Using client optimizer", ranks=[0])
            return client
        name = self._config.optimizer_name
        if name is None:
            raise ValueError("No optimizer in ds_config and none passed to initialize()")
        log_dist(f"Using DeepSpeed optimizer: {name}", ranks=[0])
        return build_optimizer(name, dict(self._config.optimizer_params or {}))

    def _configure_lr_scheduler(self, client) -> Optional[LRSchedule]:
        if client is not None:
            return client
        if self._config.scheduler_name is not None:
            return build_lr_schedule(self._config.scheduler_name,
                                     self._config.scheduler_params or {})
        return None

    def _base_lr(self) -> float:
        return float((self._config.optimizer_params or {}).get("lr", 1e-3))

    def _lr_at(self, step: int) -> float:
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler.lr_at(step))
        return self._base_lr()

    def _targets(self) -> List[torch.Tensor]:
        """What the optimizer updates: the fp32 masters, else the params."""
        return self.master if self.master is not None else [p.data for p in self._params]

    def _scale(self) -> float:
        return self.scaler_state.scale if self.scaler_state is not None else 1.0

    def _to_device(self, batch):
        def put(x):
            if not torch.is_tensor(x):
                x = torch.from_numpy(np.asarray(x))
            if not x.is_floating_point():
                x = x.long()
            return x.to(self.device, non_blocking=True)

        if isinstance(batch, Mapping):
            return {k: put(v) for k, v in batch.items()}
        return put(batch)

    def _split(self, batch, gas: int):
        """The global batch as ``gas`` microbatches of consecutive rows."""
        first = next(iter(batch.values())) if isinstance(batch, Mapping) else batch
        rows = first.shape[0]
        if rows % gas:
            raise ValueError(f"batch of {rows} rows does not split into {gas} microbatches")
        m = rows // gas
        take = lambda x, i: x[i * m:(i + 1) * m]
        for i in range(gas):
            if isinstance(batch, Mapping):
                yield {k: take(v, i) for k, v in batch.items()}
            else:
                yield take(batch, i)

    def _backward(self, loss) -> None:
        (loss.float() * self._scale()).backward()

    @torch.no_grad()
    def _apply_grads(self, loss, gas: int) -> StepMetrics:
        """The optimizer phase: mean over microbatches, finite check, unscale
        and clip, update the masters, copy back, scale bookkeeping."""
        acc_dtype = self._config.grad_accum_dtype
        grads = [g if g is not None else torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                 for g, p in zip(self._grad_acc, self._params)]
        self._grad_acc[:] = [None] * len(self._params)
        if gas > 1:
            for g in grads:
                g.div_(gas)
        scale = self._scale()
        # the one host sync of a step, and only with fp16 loss scaling
        finite = bool(grads_finite(grads).item()) if self.loss_scaler is not None else True
        inv_scale = 1.0 / scale
        grad_norm = get_grad_norm(grads) * inv_scale          # unscaled global norm
        coef = torch.full((), inv_scale, dtype=torch.float32, device=grad_norm.device)
        clip = self._config.gradient_clipping
        if clip > 0:
            coef = coef * torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(coef)
        lr = self._lr_at(self._global_step)
        if finite:
            self.opt_state = self.optimizer.update(grads, self.opt_state, self._targets(), lr=lr)
            if self.master is not None:
                for p, m in zip(self._params, self.master):
                    p.copy_(m)
        del grads
        if self.loss_scaler is not None:
            self.scaler_state = self.loss_scaler.update(self.scaler_state, finite)
        self._global_step += 1
        self._skipped_steps += int(not finite)
        self.global_samples += self.train_batch_size()
        metrics = StepMetrics(loss=loss, grad_norm=grad_norm, lr=lr, loss_scale=scale,
                              overflow=not finite)
        self._last_metrics = metrics
        self._post_step(metrics)
        return metrics

    def _post_step(self, metrics: StepMetrics) -> None:
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        step = self._global_step
        if self._config.steps_per_print and step % self._config.steps_per_print == 0:
            log_dist(f"step={step} loss={float(metrics.loss):.4f} lr={metrics.lr:.3e} "
                     f"gnorm={float(metrics.grad_norm):.3f}"
                     + (f" scale={metrics.loss_scale:.0f}" if self.fp16_enabled else ""),
                     ranks=[0])
            if self.wall_clock_breakdown:
                self.timers.log([TRAIN_BATCH_TIMER, FORWARD_GLOBAL_TIMER,
                                 BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER])

    # ----------------------------------------------------------- public API
    def train_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        """Consume one global batch (all microbatches) and take one step.
        Returns the mean loss over the microbatches (a 0-d fp32 tensor)."""
        gas = self._config.gradient_accumulation_steps
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs a batch or data_iter")
            batch = next(data_iter)
        batch = self._to_device(batch)
        self.timers(TRAIN_BATCH_TIMER).start()
        self.tput_timer.start()
        losses = []
        for mb in self._split(batch, gas):
            loss = self.module.loss(mb)
            self._backward(loss)
            losses.append(loss.detach().float())
        mean_loss = torch.stack(losses).mean()
        self._apply_grads(mean_loss, gas)
        self.timers(TRAIN_BATCH_TIMER).stop()
        self.tput_timer.stop(global_step=True)
        return mean_loss

    def forward(self, batch):
        """The loss of one microbatch, with its autograd graph."""
        self.timers(FORWARD_GLOBAL_TIMER).start()
        loss = self.module.loss(self._to_device(batch))
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss, allreduce_gradients=True, release_loss=False):
        """Backpropagate one microbatch's (scaled) loss into the fp32
        accumulation buffers."""
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        self._backward(loss)
        self._micro_loss = loss.detach().float()
        self.micro_steps += 1
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def gradient_accumulation_steps(self) -> int:
        return self._config.gradient_accumulation_steps

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self._config.gradient_accumulation_steps == 0

    def step(self):
        """Apply the optimizer at a gradient-accumulation boundary; a no-op
        mid-accumulation, as in the reference."""
        if not self.is_gradient_accumulation_boundary():
            return
        if self._micro_loss is None:
            raise RuntimeError("step() called with no accumulated gradients")
        self.timers(STEP_GLOBAL_TIMER).start()
        self._apply_grads(self._micro_loss, self._config.gradient_accumulation_steps)
        self._micro_loss = None
        self.timers(STEP_GLOBAL_TIMER).stop()

    def eval_batch(self, batch) -> torch.Tensor:
        """Loss without gradients (for eval loops)."""
        with torch.no_grad():
            return self.module.loss(self._to_device(batch))

    def train_batch_size(self) -> int:
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self._config.train_micro_batch_size_per_gpu

    def get_lr(self) -> List[float]:
        return [self._lr_at(self._global_step)]

    def get_global_grad_norm(self) -> Optional[float]:
        return float(self._last_metrics.grad_norm) if self._last_metrics else None

    def get_loss_scale(self) -> float:
        return self._scale()

    @property
    def skipped_steps(self) -> int:
        return self._skipped_steps

    @property
    def global_steps(self) -> int:
        return self._global_step

    def zero_optimization(self) -> bool:
        return self.zero_stage > 0

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def get_data_parallel_world_size(self) -> int:
        return self.dp_world_size

    def get_model_parallel_world_size(self) -> int:
        return self.mp_world_size

    def module_state_dict(self) -> dict:
        """The params in the compute type, on the host."""
        return {k: v.detach().cpu() for k, v in self.module.state_dict().items()}

    def save_checkpoint(self, *args, **kwargs):
        raise _later("checkpoints (save_checkpoint)")

    def load_checkpoint(self, *args, **kwargs):
        raise _later("checkpoints (load_checkpoint)")
