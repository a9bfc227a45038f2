"""DeepSpeedEngine — the training engine, over one or many processes.

Counterpart of ``deepspeed_tpu/runtime/engine.py``. The JAX engine is
functional: all training state lives in one ``TrainState`` pytree and one
compiled program advances it over a device mesh. Here each process holds
its rank's share of the state on its card (the model's parameters in the
compute type, the fp32 copy the optimizer updates, which a checkpoint saves
as the masters when the compute type is not fp32, the optimizer's fp32
state, the loss scaler's state, the step counters) and
PyTorch runs the step eagerly, with the collectives of its ZeRO stage
issued over ``torch.distributed``.

``train_batch(batch)`` takes this rank's rows of the global batch (the
loader gives rank ``r`` rows ``r::world``), splits them into
gradient-accumulation microbatches, runs each one's forward and backward,
and applies the optimizer once, as the JAX ``_apply_grads`` does: the
gradients averaged over the microbatches and the ranks and moved to their
ZeRO placement, finite check (fp16; the group's verdict), the unscaled
global norm from the scaled grads, clip coefficient min(1, clip / (norm +
1e-6)), the optimizer update on one fp32 tensor per unit (one module's
masters, flat: the whole unit at stage 0, the rank's shard at stages 1–3),
the copy back to the compute type; on overflow params and
optimizer state are kept, the step counter advances and the loss scale
backs off. It returns the world's mean loss on every rank: with a
``loss_mask`` whose token count differs between ranks, each rank's loss
and gradients are weighted by its share of the microbatch's tokens, so the
result is the JAX engine's loss over the global batch. The reference's
three-call API (``forward`` / ``backward`` / ``step``) runs the same pieces.

ZeRO (``runtime/zero/``): ``partition.py`` plans where each parameter's
state sits at the configured stage, in one flat unit per module;
``state.py`` holds the units' buffers and issues the collectives:
gradients all-reduced (stage 0) or reduce-scattered (stage 1) at the
accumulation boundary, or reduce-scattered unit by unit during each
backward (stages 2, 3); updated shards all-gathered (1, 2), and under
stage 3 each module's parameters gathered just before it runs, in forward
and again in backward. Gradients never accumulate in the compute type: a
post-accumulate hook moves each one into its unit's fp32 buffer (or
``data_types.grad_accum_dtype``) as soon as autograd has it. The tied GPT-2
embedding is one parameter, so its two contributions are summed before
they reach the buffer.

``training_data`` becomes the engine's resumable ``DeepSpeedDataLoader``
(``deepspeed_io``), with the metric curriculum sampler when the ds_config
``data_efficiency`` block names analyzer index files; the seqlen curriculum
(the legacy ``curriculum_learning`` block or a ``seqlen`` metric) truncates
each batch on the host before it goes to the card. ``save_checkpoint`` and
``load_checkpoint`` write and verify the JAX package's tag layout
(``runtime/checkpoint_engine/engine.py``), the same whole tensors at every
world size and stage.

The engine runs on CUDA unless it is given ``device="cpu"``; without a card
it raises. Its process group is the default one when one is initialized
(NCCL for a CUDA engine, gloo for a CPU one; any other pairing raises), and
without one it is a world of one that issues no collective. Model
parallelism, offload and the observability blocks are later slices and
raise when configured.
"""

from __future__ import annotations

import functools
import weakref
from typing import Any, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.ops.optimizers import Optimizer, build_optimizer
from deepspeed_tpu_torch.parallel.topology import ParallelGrid
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import (apply_seqlen_curriculum,
                                                                     curriculum_config_from_ds)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler, grads_finite
from deepspeed_tpu_torch.runtime.lr_schedules import LRSchedule, build_lr_schedule
from deepspeed_tpu_torch.runtime.utils import get_grad_norm
from deepspeed_tpu_torch.runtime.zero.partition import partition_report, plan_partition
from deepspeed_tpu_torch.runtime.zero.state import PARAMS, ZeroState
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER, NoopTimer,
                                             SynchronizedWallClockTimer, ThroughputTimer)


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: later slice of the port")


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

        # ---- world ----------------------------------------------------
        if mpu is not None:
            raise _later("model parallelism (mpu)")
        self.device = resolve_device(device)
        self.grid = ParallelGrid()
        self._group = self.grid.get_data_parallel_group()   # None: no process group
        if self._group is not None:
            want = "gloo" if self.device.type == "cpu" else "nccl"
            if comm.get_backend() != want:
                raise RuntimeError(f"a {comm.get_backend()} process group for an engine on "
                                   f"{self.device}: the port runs {want} there")
        self.global_rank = self.grid.get_data_parallel_rank()
        self.dp_world_size = self.grid.get_data_parallel_world_size()
        self.mp_world_size = self.grid.get_model_parallel_world_size()
        self._config._configure_train_batch_size(self.dp_world_size)
        comm.configure(self._config)

        # ---- model protocol ----------------------------------------------
        if not (isinstance(model, torch.nn.Module) and hasattr(model, "loss")):
            raise ValueError("model must be an nn.Module with .loss(batch)")
        self.module = model
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
        owner = {id(p): (mname, m) for mname, m in model.named_modules()
                 for p in m.parameters(recurse=False)}
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self._param_names: List[str] = [n for n, _ in named]
        self._params: List[torch.nn.Parameter] = [p for _, p in named]
        if not self._params:
            raise ValueError("the model has no trainable parameters")
        self._plan = plan_partition(
            [(n, tuple(p.shape), owner[id(p)][0]) for n, p in named], self.zero_stage,
            self.dp_world_size, self._config.zero_config.param_persistence_threshold)
        # the fp32 values, taken before the params are cast and laid out
        # in units; every rank starts from rank 0's
        fp32_values = [p.detach() for p in self._params]
        # the optimizer updates an fp32 copy (ZeroState.fp32), which a
        # checkpoint saves as the masters when the compute type is not fp32
        self._keep_master = self.train_dtype != torch.float32 and (
            self.fp16_enabled or self._config.bf16.master_weights)
        model.to(dtype=self.train_dtype)
        self._zero = ZeroState(self._plan, self._params, [owner[id(p)][1] for p in self._params],
                               fp32_values, self.train_dtype, self._config.grad_accum_dtype,
                               self.device, self._group, self.global_rank)
        del fp32_values
        if any(u.partitioned for u in self._plan.units):
            if not hasattr(model, "param_gatherer"):
                raise NotImplementedError(f"ZeRO stage 3 on {type(model).__name__}: the model "
                                          "must gather its modules' parameters "
                                          "(param_gatherer)")
            model.param_gatherer = self._zero
        log_dist(partition_report(self._plan), ranks=[0])

        # ---- optimizer, schedule, loss scaler ----------------------------
        self.optimizer = self._configure_optimizer(optimizer)
        self.opt_state = self.optimizer.init(self._zero.fp32)
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

        # ---- gradient accumulation: hooks into the units' buffers --------
        hooks = [p.register_post_accumulate_grad_hook(self._zero.grad_hook(i))
                 for i, p in enumerate(self._params)
                 if not self._plan.params[i].partitioned]
        # the model outlives the engine: its hooks go with the engine
        weakref.finalize(self, lambda: [h.remove() for h in hooks])
        self._pending_weight = None

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
        self._last_save = None
        self._last_recovery = None

        # ---- data: the loader and the curricula --------------------------
        self.collate_fn = collate_fn
        self._data_sampler = None
        self._pending_sampler_state = None
        self.dataloader = None
        if training_data is not None:
            self.dataloader = self.deepspeed_io(training_data, route="train")
        self.curriculum_scheduler = None
        cl_cfg = curriculum_config_from_ds(self._config._param_dict)
        if cl_cfg.get("enabled"):
            self.curriculum_scheduler = CurriculumScheduler(cl_cfg)
        log_dist(f"engine ready: dtype={self.train_dtype}, zero={self.zero_stage}, "
                 f"device={self.device}, dp={self.dp_world_size}, "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()}, "
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

    def _forward(self, batch):
        with self._zero.forward_context():
            return self.module.loss(batch)

    def _backward(self, loss) -> None:
        (loss.float() * self._scale()).backward()
        self._zero.end_backward()

    def _token_weights(self, microbatches) -> Optional[torch.Tensor]:
        """Each microbatch's weight, world × this rank's share of its valid
        target tokens over the world's (the model's ``loss_tokens``), when
        a loss mask makes the shares differ; None otherwise. Ranks average
        their gradients, so the weighted losses make the global token mean."""
        count = getattr(self.module, "loss_tokens", None)
        if self.dp_world_size == 1 or count is None:
            return None
        local = [count(mb) for mb in microbatches]
        if any(c is None for c in local):
            return None
        local = torch.stack(local).float()
        total = comm.all_reduce(local.clone(), group=self._group)
        return self.dp_world_size * local.clamp(min=1.0) / total.clamp(min=1.0)

    def _world_mean(self, loss: torch.Tensor) -> torch.Tensor:
        if self._group is None:
            return loss
        return comm.all_reduce(loss.clone(), op=comm.ReduceOp.AVG, group=self._group)

    @torch.no_grad()
    def _apply_grads(self, loss, gas: int) -> StepMetrics:
        """The optimizer phase: the mean over microbatches and ranks at the
        ZeRO placement, finite check, unscale and clip, update the fp32
        copy, refresh the params, scale bookkeeping."""
        z = self._zero
        grads = z.reduced_grads(gas)
        group = self._group if z.sharded else None        # the grads' sharding
        scale = self._scale()
        # the one host sync of a step, and only with fp16 loss scaling
        finite = bool(grads_finite(grads, self._group).item()) \
            if self.loss_scaler is not None else True
        inv_scale = 1.0 / scale
        grad_norm = get_grad_norm(grads, group=group) * inv_scale   # unscaled global norm
        coef = torch.full((), inv_scale, dtype=torch.float32, device=grad_norm.device)
        clip = self._config.gradient_clipping
        if clip > 0:
            coef = coef * torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(coef)
        lr = self._lr_at(self._global_step)
        if finite:
            flat = {"segments": z.segments(), "num_params": len(self._params),
                    "group": group} if self.optimizer.per_tensor else {}
            self.opt_state = self.optimizer.update(grads, self.opt_state, z.fp32, lr=lr,
                                                   **flat)
            z.refresh_params()
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
        """Consume this rank's rows of one global batch (all microbatches)
        and take one step. Returns the world's mean loss over the
        microbatches (a 0-d fp32 tensor, the same on every rank)."""
        gas = self._config.gradient_accumulation_steps
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs a batch or data_iter")
            batch = next(data_iter)
        if self.curriculum_scheduler is not None:
            difficulty = self.curriculum_scheduler.update_difficulty(self._global_step + 1)
            batch = apply_seqlen_curriculum(batch, difficulty)
        batch = self._to_device(batch)
        self.timers(TRAIN_BATCH_TIMER).start()
        self.tput_timer.start()
        microbatches = list(self._split(batch, gas))
        weights = self._token_weights(microbatches)
        losses = []
        for i, mb in enumerate(microbatches):
            loss = self._forward(mb)
            if weights is not None:
                loss = loss * weights[i]
            self._backward(loss)
            losses.append(loss.detach().float())
        mean_loss = self._world_mean(torch.stack(losses).mean())
        self.micro_steps += gas
        self._apply_grads(mean_loss, gas)
        self.timers(TRAIN_BATCH_TIMER).stop()
        self.tput_timer.stop(global_step=True)
        return mean_loss

    def forward(self, batch):
        """The loss of one microbatch (this rank's), with its autograd graph."""
        self.timers(FORWARD_GLOBAL_TIMER).start()
        batch = self._to_device(batch)
        weights = self._token_weights([batch])
        self._pending_weight = None if weights is None else weights[0]
        loss = self._forward(batch)
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss, allreduce_gradients=True, release_loss=False):
        """Backpropagate one microbatch's (scaled) loss into the fp32
        accumulation buffers, weighted by the microbatch's token share."""
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        if self._pending_weight is not None:
            loss = loss * self._pending_weight
            self._pending_weight = None
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
        self._apply_grads(self._world_mean(self._micro_loss),
                          self._config.gradient_accumulation_steps)
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
        """The params in the compute type, whole, on the host (a collective
        under ZeRO stage 3)."""
        sd = {k: v.detach().cpu() for k, v in self.module.state_dict().items()}
        if self.zero_stage >= 3:
            sd.update(zip(self._param_names, self._zero.to_host(PARAMS)))
        return sd

    @property
    def training_dataloader(self):
        return self.dataloader

    # ------------------------------------------------------------ curricula
    def curriculum_learning_enabled(self) -> bool:
        return self.curriculum_scheduler is not None

    def set_custom_curriculum_learning_schedule(self, schedule_func_dict):
        """Install a custom difficulty function ({'get_difficulty': fn(step)})."""
        if self.curriculum_scheduler is None:
            raise ValueError("curriculum learning is not enabled in this config")
        fn = schedule_func_dict["get_difficulty"] \
            if isinstance(schedule_func_dict, dict) else schedule_func_dict
        self.curriculum_scheduler.set_custom_get_difficulty(fn)

    # ------------------------------------------------------------ dataloader
    def _file_based_curriculum(self):
        """The data_efficiency block's metric curriculum with analyzer index
        files (the sampler's; the seqlen truncation has none), or None."""
        de = self._config.data_efficiency_config or {}
        ds = de.get("data_sampling", {})
        cl = ds.get("curriculum_learning", {})
        file_based = {n: m for n, m in cl.get("curriculum_metrics", {}).items()
                      if "index_to_sample_path" in m
                      or m.get("clustering_type") == "single_cluster"}
        if de.get("enabled", True) and ds.get("enabled", True) and cl.get("enabled") \
                and file_based:
            return de, cl, file_based
        return None

    def deepspeed_io(self, dataset, batch_size=None, route=None, data_sampler=None,
                     **kwargs):
        """A ``DeepSpeedDataLoader`` over ``dataset``.

        Only ``route="train"`` builds the metric curriculum sampler and makes
        it the engine's checkpointed state, so an eval loader built first
        cannot bind the curriculum to the wrong dataset. A sampler passed in
        also binds on ``route=None``; ``route="eval"`` keeps even that one
        local to its loader. The engine's own ``training_data`` loader is
        built with ``route="train"``."""
        bs = batch_size or self.train_batch_size()
        if data_sampler is None and route == "train" and self._data_sampler is None:
            found = self._file_based_curriculum()
            if found:
                from deepspeed_tpu_torch.runtime.data_pipeline.data_sampler import \
                    DeepSpeedDataSampler

                de, cl, file_based = found
                cfg = dict(de)
                cfg["data_sampling"] = dict(de["data_sampling"])
                cfg["data_sampling"]["curriculum_learning"] = {
                    **cl, "curriculum_metrics": file_based}
                data_sampler = DeepSpeedDataSampler(cfg, len(dataset), bs)
                if self._pending_sampler_state:
                    data_sampler.load_state_dict(self._pending_sampler_state)
                    self._pending_sampler_state = None
        elif (route is None and data_sampler is None and self._data_sampler is None
              and (self._pending_sampler_state is not None
                   or self._file_based_curriculum() is not None)):
            logger.warning(
                "a metric-based curriculum is configured but this loader was built with "
                "route=None, which does NOT engage the curriculum sampler; pass "
                "route='train' on the training loader (or route='eval' to silence this "
                "for eval loaders)")
        if data_sampler is not None and route in (None, "train") and self._data_sampler is None:
            self._data_sampler = data_sampler
        dl_kwargs = {}
        if self._config.dataloader_drop_last is not None:
            dl_kwargs["drop_last"] = bool(self._config.dataloader_drop_last)
        return DeepSpeedDataLoader(dataset, batch_size=bs, collate_fn=self.collate_fn,
                                   data_sampler=data_sampler, **dl_kwargs)

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import \
            save_engine_checkpoint

        return save_engine_checkpoint(self, save_dir, tag=tag, client_state=client_state,
                                      save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False, custom_load_fn=None):
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import \
            load_engine_checkpoint

        return load_engine_checkpoint(self, load_dir, tag=tag,
                                      load_optimizer_states=load_optimizer_states,
                                      load_module_only=load_module_only)
