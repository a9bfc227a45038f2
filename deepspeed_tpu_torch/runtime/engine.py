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

ZeRO-Offload and ZeRO-Infinity (the ``offload_optimizer`` and
``offload_param`` blocks): the state is built unit by unit straight into
its placement (``runtime/zero/init.py``, the engine's ``zero.Init``), so a
model whose state does not fit on the card is never whole on it.
``offload_optimizer: cpu`` keeps the optimizer state in pinned host memory,
and the fp32 master too when the card cannot hold it next to the params
and gradients (the JAX engine's capacity policy, on the card's memory and
the port's fp32 gradients); the card still does the math, on the whole
state at once when it fits or streamed unit by unit in chunks
(``runtime/zero/offload.py``). ``offload_param: cpu`` keeps the
compute-type params in pinned host memory, each unit brought to the card
just before its module runs. ``offload_optimizer: nvme`` keeps the master
and the Adam moments in files (``runtime/swap_tensor/``), stepped on the
host after the gradients come to it unit by unit; ``offload_param: nvme``
is ``runtime/zero/infinity.py``'s engine, which ``initialize`` returns.
The JAX package's knobs ``DS_TPU_OFFLOAD_MASTER``,
``DS_TPU_FORCE_STREAMED_OFFLOAD``, ``DS_TPU_OFFLOAD_CHUNK_BYTES`` and
``DS_TPU_OFFLOAD_OVERLAP`` (or the block's ``stream_overlap``) keep their
meanings. On ``device="cpu"`` the host is the same memory; the offload path
still runs, as copies between CPU tensors.

The engine runs on CUDA unless it is given ``device="cpu"``; without a card
it raises. Its process group is the default one when one is initialized
(NCCL for a CUDA engine, gloo for a CPU one; any other pairing raises), and
without one it is a world of one that issues no collective. Model
parallelism and the observability blocks are later slices and raise when
configured.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import weakref
from typing import Any, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.ops.optimizers import AdamState, Optimizer, build_optimizer
from deepspeed_tpu_torch.parallel.topology import ParallelGrid
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import (apply_seqlen_curriculum,
                                                                     curriculum_config_from_ds)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler, grads_finite
from deepspeed_tpu_torch.runtime.lr_schedules import LRSchedule, build_lr_schedule
from deepspeed_tpu_torch.runtime.utils import get_grad_norm
from deepspeed_tpu_torch.runtime.zero.init import build_state, trainable
from deepspeed_tpu_torch.runtime.zero.offload import (CHUNK_BYTES, HostOffload, env_flag,
                                                      host_opt_state)
from deepspeed_tpu_torch.runtime.zero.partition import partition_report
from deepspeed_tpu_torch.runtime.zero.state import PARAMS
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER, NoopTimer,
                                             SynchronizedWallClockTimer, ThroughputTimer)


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: later slice of the port")


def _resolve_stream_overlap(off_opt) -> bool:
    """Double-buffered streaming of the offloaded update: the
    ``stream_overlap`` field when set, else the ``DS_TPU_OFFLOAD_OVERLAP``
    environment knob (also without an offload_optimizer block)."""
    cfg = off_opt.stream_overlap if off_opt is not None else None
    return env_flag("DS_TPU_OFFLOAD_OVERLAP") if cfg is None else bool(cfg)


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

        # ---- state, built in its placement -------------------------------
        if model_parameters is not None:
            if not isinstance(model_parameters, Mapping):
                raise ValueError("model_parameters must be a state dict for the model")
            model.load_state_dict(model_parameters, assign=True)
        named = trainable(model)
        self._param_names: List[str] = [n for n, _, _, _ in named]
        # the optimizer updates an fp32 copy (ZeroState.fp32), which a
        # checkpoint saves as the masters when the compute type is not fp32
        self._keep_master = self.train_dtype != torch.float32 and (
            self.fp16_enabled or self._config.bf16.master_weights)
        placement = self._offload_placement(model)
        if self.device.type == "cpu" and (placement["fp32_host"] or placement["param_host"]):
            log_dist("offload on a CPU engine: the host is the same memory; the offload "
                     "path runs as copies between CPU tensors", ranks=[0])
        self._zero = build_state(
            model, self.zero_stage, self._config.zero_config.param_persistence_threshold,
            self.train_dtype, self.device, self._config.grad_accum_dtype,
            generator=torch.Generator(device=self.device).manual_seed(self._config.seed),
            group=self._group, rank=self.global_rank, world=self.dp_world_size, **placement)
        self._plan = self._zero.plan
        self._params: List[torch.nn.Parameter] = self._zero.params
        if any(self._zero.fetched):
            if not hasattr(model, "param_gatherer"):
                raise NotImplementedError(f"ZeRO stage 3 or offload_param on "
                                          f"{type(model).__name__}: the model must gather "
                                          "its modules' parameters (param_gatherer)")
            model.param_gatherer = self._zero
        log_dist(partition_report(self._plan), ranks=[0])

        # ---- optimizer, schedule, loss scaler ----------------------------
        self.optimizer = self._configure_optimizer(optimizer)
        self._offload = None
        if self._nvme_optimizer is not None:
            from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import SwapUnits

            units = self._nvme_names
            self._zero.fp32 = SwapUnits(self._nvme_optimizer, units, "w")
            self.opt_state = AdamState(count=0, mu=SwapUnits(self._nvme_optimizer, units, "m"),
                                       nu=SwapUnits(self._nvme_optimizer, units, "v"))
        elif self._host_offload_opt:
            self.opt_state = host_opt_state(self.optimizer, [t.numel() for t in self._zero.fp32],
                                            pin=self.device.type == "cuda")
            self._offload = HostOffload(self._zero, self._offload_master_host,
                                        self._offload_streamed(), self._stream_overlap,
                                        int(os.environ.get("DS_TPU_OFFLOAD_CHUNK_BYTES",
                                                           CHUNK_BYTES)))
        else:
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
                 if not self._zero.fetched[self._plan.params[i].unit]]
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

    # -------------------------------------------------------------- offload
    def _hbm_bytes(self) -> int:
        """The card's memory; 16 GiB on a CPU engine (the JAX engine's
        figure when it cannot read the device's)."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_properties(self.device).total_memory
        return 16 << 30

    def _offload_placement(self, model) -> dict:
        """The ZeRO-Offload policy (the JAX engine's, on the card's memory
        and the port's own resident bytes): where the fp32 master and the
        compute-type params live, and the NVMe optimizer when asked for."""
        zc = self._config.zero_config
        off_opt, off_param = zc.offload_optimizer, zc.offload_param
        if off_param is not None and off_param.device == "nvme":
            raise ValueError("offload_param to nvme is the ZeRO-Infinity engine "
                             "(runtime/zero/infinity.py): build it through initialize")
        self._host_offload_opt = bool(off_opt and off_opt.device == "cpu")
        self._host_offload_param = bool(off_param and off_param.device == "cpu")
        self._stream_overlap = _resolve_stream_overlap(off_opt)
        made = getattr(model, "param_gatherer", None)
        self._numel = sum(p.numel for p in made.plan.params) if hasattr(made, "plan") \
            else sum(p.numel() for _, p, _, _ in trainable(model))
        # Moments only: the fp32 master stays on the card when it fits there
        # next to the compute-type params and the gradients, and only the
        # moments stream (the reference's offload_optimizer.ratio role,
        # decided by capacity); DS_TPU_OFFLOAD_MASTER=host|hbm overrides
        self._offload_master_host = self._host_offload_opt
        if self._host_offload_opt:
            mode = os.environ.get("DS_TPU_OFFLOAD_MASTER", "auto").lower()
            if mode in ("hbm", "device", "resident"):
                self._offload_master_host = False
            elif mode in ("host", "pinned", "cpu"):
                self._offload_master_host = True
            else:
                n, shards, stage = self._numel, self.dp_world_size, self.zero_stage
                resident = (4 * n / shards
                            + self.train_dtype.itemsize * n / (shards if stage >= 3 else 1)
                            + self._config.grad_accum_dtype.itemsize * n
                            / (shards if stage >= 2 else 1))
                self._offload_master_host = resident > 0.55 * self._hbm_bytes()
            if not self._offload_master_host:
                log_dist("ZeRO-Offload: fp32 master stays on the card; streaming moments "
                         "only (DS_TPU_OFFLOAD_MASTER=host to force full offload)", ranks=[0])
        self._nvme_optimizer = None
        fp32_sink = None
        if off_opt is not None and off_opt.device == "nvme":
            from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import \
                SwappedOptimizer

            if self.fp16_enabled:
                raise ValueError("NVMe optimizer offload supports bf16/fp32 only (fp16 dynamic "
                                 "loss scaling would need the state back on overflow)")
            folder = off_opt.nvme_path or os.path.join(tempfile.gettempdir(),
                                                       "ds_tpu_nvme_swap")
            if self.dp_world_size > 1:
                folder = os.path.join(folder, f"rank{self.global_rank}")
            self._nvme_optimizer = SwappedOptimizer(
                swap_folder=folder, optimizer_name=self._config.optimizer_name or "adamw",
                optimizer_params=dict(self._config.optimizer_params or {}),
                aio_config=dataclasses.asdict(self._config.aio_config),
                buffer_count=off_opt.buffer_count)
            fp32_sink = lambda u, t: self._nvme_optimizer.add_tensor(f"unit{u:05d}", t)
        return dict(fp32_host=self._host_offload_opt and self._offload_master_host,
                    param_host=self._host_offload_param, pin=self.device.type == "cuda",
                    fp32_sink=fp32_sink)

    @property
    def _nvme_names(self) -> List[str]:
        return [f"unit{u:05d}" for u in range(len(self._plan.units))]

    def _offload_streamed(self) -> bool:
        """Whole-state stream-in when the fp32 state fits on the card next to
        the model; streamed unit by unit in chunks otherwise (the only way a
        model whose optimizer state exceeds the card steps at all)."""
        if env_flag("DS_TPU_FORCE_STREAMED_OFFLOAD"):
            return True
        n, shards = self._numel, self.dp_world_size
        # master + mu + nu = 12 bytes/param streamed, or mu + nu = 8 when the
        # master stays on the card (which also shrinks the room they stream into)
        stream_bytes = (12 if self._offload_master_host else 8) * n / shards
        budget = self._hbm_bytes() - (0 if self._offload_master_host else 4 * n / shards)
        streamed = stream_bytes > 0.6 * budget
        if streamed:
            log_dist(f"ZeRO-Offload: streamed optimizer update ({stream_bytes / 2**30:.1f}G "
                     f"streamed fp32/device vs {budget / 2**30:.1f}G free on the card)",
                     ranks=[0])
        return streamed

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
        copy (on the card, streamed through it from host memory, or on the
        host from the NVMe files), refresh the params, scale bookkeeping."""
        z = self._zero
        grads = z.reduced_grads(gas)
        group = self._group if z.sharded else None        # the grads' sharding
        scale = self._scale()
        # the one host sync of a step, and only with fp16 loss scaling
        finite = bool(grads_finite(grads, self._group).item()) \
            if self.loss_scaler is not None else True
        inv_scale = 1.0 / scale
        grad_norm = get_grad_norm(grads, group=group) * inv_scale   # unscaled global norm
        lr = self._lr_at(self._global_step)
        clip = self._config.gradient_clipping
        if self._nvme_optimizer is not None:           # fp16 is refused: always finite
            self._step_nvme(grads, float(grad_norm), lr)
        else:
            coef = torch.full((), inv_scale, dtype=torch.float32, device=grad_norm.device)
            if clip > 0:
                coef = coef * torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(coef)
            if finite:
                flat = {"segments": z.segments(), "num_params": len(self._params),
                        "group": group} if self.optimizer.per_tensor else {}
                if self._offload is not None:          # the state in host memory
                    self.opt_state = self._offload.update(self.optimizer, grads,
                                                          self.opt_state, lr, **flat)
                else:
                    self.opt_state = self.optimizer.update(grads, self.opt_state, z.fp32,
                                                           lr=lr, **flat)
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

    def _step_nvme(self, grads, grad_norm: float, lr: float) -> None:
        """The NVMe optimizer's step (the JAX ``_train_batch_nvme``): each
        unit's gradient to the host as its window comes, clipped there by
        the JAX rule (scaled by clip / (norm + 1e-6) when the norm exceeds
        it), AdamW on the host, and each unit's new params back to the card
        while its window is in memory."""
        clip = self._config.gradient_clipping
        scale = clip / (grad_norm + 1e-6) if clip > 0 and grad_norm > clip else 1.0
        names = self._nvme_names
        unit = {n: u for u, n in enumerate(names)}
        self._nvme_optimizer.step(dict(zip(names, grads)), lr=lr, grad_scale=scale,
                                  on_update=lambda n, w: self._zero.store_params(unit[n], w))
        self.opt_state = self.opt_state._replace(count=self._nvme_optimizer.step_count)

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
        if any(self._zero.fetched):
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
