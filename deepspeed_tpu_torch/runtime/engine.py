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
``data_types.grad_accum_dtype``) as soon as autograd has it. A tied
embedding (GPT-2's and llama3.2-1b's head, BERT's MLM decoder) is one
parameter, so its two contributions are summed before they reach the
buffer.

Expert parallelism (the ds_config ``tpu`` block's ``expert`` axis, inside
``data``: ``parallel/topology.py``, ``utils/groups.py``): the batch is
split over every rank as before; a MoE model's layers route over the
global micro-batch and split their experts over the ranks that share a
``data`` coordinate (``moe/sharded_moe.py``), and each bank of this rank's
experts is a ZeRO unit of its own, whole on the rank (``runtime/zero/``).
The gradient norm counts each such unit once: its squares summed over the
expert-parallel group, the others' over the world.

The model protocol (``models/``: GPT-2, MoE GPT-2, llama, BERT): an
``nn.Module`` with ``loss(batch)``, which may also take ``generator`` (a
``torch.Generator`` seeded from the seed, the step and the microbatch, as
the JAX engine passes its ``rng``) and ``loss_weight`` (the weight the
engine gives the rank's loss, below); ``loss_tokens(batch)``, what the
loss averages over when ranks may hold different counts (None: every row
the same); ``expert_module_names()`` and ``expert_groups`` on a MoE model;
a ``pld_theta`` argument of ``loss``, which receives progressive layer
drop's keep probability θ(t) of the step when the ds_config
``progressive_layer_drop`` block is enabled (a loss without it is refused,
as in JAX);
``param_chunks(generator)`` or ``init_params(generator)``, its random
initial values, when its weights are not loaded; and ``param_gatherer``,
the attribute ZeRO stage 3 and ``offload_param`` set to gather each
module's parameters around its use (``models/common.py``
``GatheredModule``).

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

Compression training (the ``compression_training`` block, or
``compression.init_compression(engine, ...)``): the transform of
``compression/compress.py`` computes each step's compressed weights once,
at the engine's step, into static buffers that the model reads through its
``param_gatherer`` in ``train_batch``, ``forward`` / ``backward`` /
``step``, ``eval_batch`` and a hybrid engine's ``generate``; the gradient
at the compressed weights updates the raw ones, as in JAX. With the ``eigenvalue``
block, after each ``train_batch`` at a gradient-accumulation boundary
(outside the train-batch timer) the engine estimates each layer's Hessian
eigenvalue on the first microbatch with the raw weights
(``runtime/eigenvalue.py``) and stretches MoQ's per-layer quantization
periods, as the JAX ``_maybe_update_eigenvalue`` does. Under ZeRO stage 3
or ``offload_param`` (fetched units) the transform reads each stacked leaf
whole on the card, one leaf at a time, and keeps the rank's elements of
its compressed values, on the card at stage 3 and in host memory under
``offload_param``, which the units' gathers then hand out in place of the
raw ones (``ZeroState.serve``); the eigenvalue reads whole raw copies.
``offload_param: nvme`` is the layerwise ZeRO-Infinity engine, which
refuses the block.

The ``activation_checkpointing`` block configures
``runtime/activation_checkpointing/checkpointing.py`` when it asks for
partitioned or host-kept activations, as in JAX; the models keep their own
``remat``. Each advisory key a config sets is logged with why it changes
nothing here (``runtime/config.py``), ``dump_state`` prints the config, and
``memory_breakdown`` logs the card's and the host's memory on the steps
that print.

The resilience blocks, each a strict no-op when absent (as in JAX):
``watchdog`` arms a ``StepWatchdog`` around each ``train_batch`` (the data
fetch included) and ``step``, touches the heartbeat file every
``heartbeat_interval`` steps and runs the consistency guard (the startup
fingerprint, the step agreement); ``resilience.sentinel`` rewinds a bad
streak through the snapshot ladder; ``rewind`` snapshots the state into the
host-RAM ring every ``ram_interval`` healthy steps
(``resilience/rewind.py``) and makes ``load_checkpoint`` walk the ladder;
an enabled ``resilience.chaos`` installs the injector, whose
``train_step`` hook runs before any launch. A step that stops part way (a
timeout or a fault after its first launch) leaves the state half updated:
the engine then refuses ``train_batch`` and ``step`` until a whole-state
restore (``load_checkpoint``, which the sentinel's rewind also is).
``blackbox`` arms the flight recorder (``blackbox/``): a ring of the
producers' incident events (the sentinel's rewind is one), a per-step
tail appended after the sentinel and the RAM snapshot, and an incident
bundle on an error event or SIGUSR1; all on the host.

Monitoring and profiling, each a strict no-op when its block is absent (as
in JAX): the ``tensorboard``, ``wandb`` and ``csv_monitor`` blocks make the
engine's ``MonitorMaster`` (``monitor/``) write ``Train/Samples/train_loss``
and ``Train/Samples/lr`` at ``global_samples`` every step, on process 0, and
``telemetry.monitor`` fans the telemetry series out through it;
``flops_profiler`` counts the matmul and convolution flops of the step that
becomes ``profile_step`` while it runs (``profiling/flops_profiler/``),
prints the profile after it and gives the count to the throughput timer's
EstTFLOPs and the ``train/flops_per_batch`` gauge; ``profiling`` samples the
census of the card's memory by the engine's state after the telemetry step
and wraps the telemetry tracer for per-span peaks
(``profiling/memory.py``); ``memory_census()`` takes a census on demand.
``goodput`` arms the goodput meter after telemetry (``goodput/recorder.py``):
each step's wall time in the closed taxonomy, from the telemetry spans, as
the ``goodput/*`` series one step behind, and the kernel builds, library
loads and graph captures as compile spans.

The engine runs on CUDA unless it is given ``device="cpu"``; without a card
it raises. Its process group is the default one when one is initialized
(NCCL for a CUDA engine, gloo for a CPU one; any other pairing raises), and
without one it is a world of one that issues no collective. Model
parallelism is a later slice and raises when configured.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import os
import sys
import tempfile
import time
import types
import weakref
from typing import Any, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch import telemetry as _telemetry
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
from deepspeed_tpu_torch.ops.optimizers import AdamState, Optimizer, build_optimizer
from deepspeed_tpu_torch.parallel.topology import ParallelGrid
from deepspeed_tpu_torch.resilience import chaos as _chaos
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import (apply_seqlen_curriculum,
                                                                     curriculum_config_from_ds)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler, grads_finite
from deepspeed_tpu_torch.runtime.lr_schedules import LRSchedule, build_lr_schedule
from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop, theta_at
from deepspeed_tpu_torch.runtime.utils import get_grad_norm, see_memory_usage
from deepspeed_tpu_torch.runtime.zero.init import build_state, trainable
from deepspeed_tpu_torch.runtime.zero.offload import CHUNK_BYTES, HostOffload, host_opt_state
from deepspeed_tpu_torch.runtime.zero.partition import partition_report
from deepspeed_tpu_torch.runtime.zero.state import PARAMS
from deepspeed_tpu_torch.utils import env_flag
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


class _WholeParams:
    """A ``param_gatherer`` handing each module the tensors of ``named``
    (its parameters by full name) in place of its own."""

    def __init__(self, model: torch.nn.Module, named: Mapping[str, torch.Tensor]):
        self._of = {}
        for mname, module in model.named_modules():
            prefix = f"{mname}." if mname else ""
            own = {a: named[prefix + a] for a in module._parameters if prefix + a in named}
            if own:
                self._of[id(module)] = own

    def gather(self, module):
        own = self._of.get(id(module))
        if own is None:
            return module
        return types.SimpleNamespace(**{a: own.get(a, getattr(module, a))
                                        for a in module._parameters})

    def release(self, module) -> None:
        pass


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
        self.grid = ParallelGrid(self._config.mesh_config.expert_size(comm.get_world_size()))
        self._group = self.grid.get_data_parallel_group()   # None: no process group
        if self._group is not None:
            want = "gloo" if self.device.type == "cpu" else "nccl"
            if comm.get_backend() != want:
                raise RuntimeError(f"a {comm.get_backend()} process group for an engine on "
                                   f"{self.device}: the port runs {want} there")
        self.global_rank = self.grid.get_data_parallel_rank()
        self.dp_world_size = self.grid.get_data_parallel_world_size()
        self.mp_world_size = self.grid.get_model_parallel_world_size()
        self.ep_world_size = self.grid.get_expert_parallel_world_size()
        self._config._configure_train_batch_size(self.dp_world_size)
        comm.configure(self._config)
        self._init_watchdog()

        # ---- model protocol ----------------------------------------------
        if not (isinstance(model, torch.nn.Module) and hasattr(model, "loss")):
            raise ValueError("model must be an nn.Module with .loss(batch) (the model "
                             "protocol: loss, loss_tokens, param_chunks, param_gatherer)")
        self.module = model
        self._check_experts(model)
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
            group=self._group, rank=self.global_rank, world=self.dp_world_size,
            expert_groups=self.grid.expert_groups, **placement)
        self._plan = self._zero.plan
        self._params: List[torch.nn.Parameter] = self._zero.params
        if any(self._zero.fetched):
            if not hasattr(model, "param_gatherer"):
                raise NotImplementedError(f"ZeRO stage 3 or offload_param on "
                                          f"{type(model).__name__}: the model must gather "
                                          "its modules' parameters (param_gatherer, as "
                                          "models/common.py GatheredModule does)")
            model.param_gatherer = self._zero
        log_dist(partition_report(self._plan), ranks=[0])

        # ---- optimizer, schedule, loss scaler ----------------------------
        self.optimizer = self._configure_optimizer(optimizer)
        self._expert_units = [u for u, unit in enumerate(self._plan.units) if unit.ep > 1]
        if self._expert_units and self.optimizer.per_tensor:
            raise _later("a per-tensor optimizer (LAMB) with expert parallelism")
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

        # ---- progressive layer drop: θ(t) into the loss each microbatch ----
        self.progressive_layer_drop = None
        if self._config.pld_enabled:
            if "pld_theta" not in inspect.signature(model.loss).parameters:
                raise ValueError(
                    "progressive_layer_drop.enabled=true but the model loss does not accept "
                    "a pld_theta kwarg — use a model with PLD gates (models.gpt2/bert) or "
                    "add pld_theta support")
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=self._config.pld_config.theta, gamma=self._config.pld_config.gamma)

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
        self.monitor = MonitorMaster(self._config.monitor_config)
        # the process-wide telemetry session (telemetry/): None when the
        # block is off; the per-step hooks read the live session, so one a
        # caller installs gets the same series
        self.telemetry = _telemetry.configure(self._config.telemetry, monitor=self.monitor)
        self._init_profiling()
        # the goodput meter over the telemetry spans, and the compile spans
        # (goodput/recorder.py): without the block the package is never
        # imported and ``op_builder``'s flag stays as it is
        self._goodput = None
        if self._config.goodput_present and self._config.goodput.enabled:
            from deepspeed_tpu_torch.goodput.recorder import GoodputMeter

            self._goodput = GoodputMeter(self._config.goodput, engine=self)
        self._last_save = None
        self._last_recovery = None
        self._init_resilience()
        self._init_blackbox()

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

        # ---- the activation_checkpointing block and the advisory keys ----
        ac = self._config.activation_checkpointing_config
        if ac.partition_activations or ac.cpu_checkpointing:
            from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing

            checkpointing.configure(deepspeed_config=self._config)
        for key in self._config.advisory_keys_set:
            log_dist(f"config key {key!r} accepted (changes nothing on CUDA): "
                     f"{self._config.advisory_reason(key)}", ranks=[0])
        if self._config.dump_state:
            self._config.print_config()

        # ---- compression training and the eigenvalue ----------------------
        self._compression = None          # the CompressionTransform, when armed
        self._compressed = None           # its CompressedParams gatherer
        self._compression_at = None       # the step its buffers hold
        if self._config.compression_config:
            from deepspeed_tpu_torch.compression.compress import init_compression

            init_compression(self, {"compression_training": self._config.compression_config})
        self.eigenvalue = None
        self.block_eigenvalue = None
        if self._config.eigenvalue_enabled:
            from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue

            ec = self._config.eigenvalue_config
            self.eigenvalue = Eigenvalue(
                verbose=ec.verbose, max_iter=ec.max_iter, tol=ec.tol, stability=ec.stability,
                gas_boundary_resolution=ec.gas_boundary_resolution,
                layer_name=ec.layer_name, layer_num=ec.layer_num)
        log_dist(f"engine ready: dtype={self.train_dtype}, zero={self.zero_stage}, "
                 f"device={self.device}, dp={self.dp_world_size}, "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()}, "
                 f"gas={self._config.gradient_accumulation_steps}", ranks=[0])

    # ------------------------------------------------------------- profiling
    def _init_profiling(self) -> None:
        """The ``flops_profiler`` and ``profiling`` blocks. The memory
        profiler's module is imported only with an enabled ``profiling``
        block; with ``span_memory`` it wraps the live session's tracer, so
        every span records its peak device memory above its entry."""
        self.flops_profiler_cfg = self._config.flops_profiler_config
        self.flops_profile = None       # the FlopsProfiler of the profiled step
        self._mem_profiler = None
        prof = self._config.profiling
        if not (self._config.profiling_present and prof.enabled):
            return
        from deepspeed_tpu_torch.profiling.memory import (MemoryProfiler, SpanMemoryTracer,
                                                          device_memory_stats)

        self._mem_profiler = MemoryProfiler(
            sample_interval=prof.sample_interval, memory=prof.memory,
            executable_analysis=prof.executable_analysis, leak_window=prof.leak_window,
            leak_min_growth_bytes=prof.leak_min_growth_bytes)
        session = _telemetry.get_session()
        if prof.span_memory and session is not None \
                and session.tracer is not _telemetry.NOOP_TRACER \
                and not isinstance(session.tracer, SpanMemoryTracer):
            session.tracer = SpanMemoryTracer(session.tracer, device_memory_stats(self.device))

    def _flops_profile_due(self) -> bool:
        """Whether the step about to run is ``flops_profiler.profile_step``.
        The NVMe optimizer's host-side step is not profiled, as in JAX."""
        cfg = self.flops_profiler_cfg
        if not cfg.enabled or self._global_step + 1 != cfg.profile_step:
            return False
        if self._nvme_optimizer is not None:
            logger.warning("flops profiler: unsupported for the NVMe-offload optimizer path "
                           "(host-side stepping); skipping")
            return False
        return True

    def _profiled_train_batch(self, batch, gas: int) -> torch.Tensor:
        """One ``_train_batch`` under the flops profiler's counter, its
        latency from CUDA events on the card (the host clock on the CPU).
        The count gives the throughput timer's EstTFLOPs and the
        ``train/flops_per_batch`` gauge."""
        from deepspeed_tpu_torch.profiling.flops_profiler.profiler import FlopsProfiler

        prof = FlopsProfiler(self.module, ds_engine=self)
        on_card = self.device.type == "cuda"
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        prof.start_profile()
        try:
            mean_loss = self._train_batch(batch, gas)
        finally:
            prof.stop_profile()
        if on_card:
            end.record()
            end.synchronize()
            prof.duration = start.elapsed_time(end) / 1e3
        else:
            prof.duration = time.perf_counter() - t0
        prof.params = self._numel
        self.flops_profile = prof
        self.tput_timer.set_flops_per_batch(prof.flops)
        _telemetry.get_registry().gauge("train/flops_per_batch").set(prof.flops)
        return mean_loss

    def _print_flops_profile(self) -> None:
        cfg = self.flops_profiler_cfg
        if comm.get_rank() == 0:
            self.flops_profile.print_model_profile(
                profile_step=cfg.profile_step, module_depth=cfg.module_depth,
                top_modules=cfg.top_modules, detailed=cfg.detailed,
                output_file=cfg.output_file)

    def memory_census(self):
        """A census of the card's allocated bytes by this engine's state
        (params, masters, optimizer state, gradient buffers, the rest as
        ``other``; a ``profiling.memory.CensusResult``), with or without the
        ``profiling`` block: the interactive entry point, where the block is
        the sampling one."""
        from deepspeed_tpu_torch.profiling.memory import census, named_engine_tensors

        return census(named_engine_tensors(self), device=self.device)

    # ------------------------------------------------------------ resilience
    def _init_watchdog(self) -> None:
        """The ``watchdog`` block, before any state is built: the step
        watchdog, the barrier and dump defaults, the heartbeat file and the
        startup fingerprint agreement. Without the block: no watchdog, no
        thread, no heartbeat, no agreement, and an earlier engine's
        config-installed barrier deadline and dump file are removed."""
        from deepspeed_tpu_torch.resilience import watchdog as _wd

        wd = self._config.watchdog
        self._watchdog = None
        self._heartbeat_path = None
        self._heartbeat_interval = 1
        self._consistency_interval = 0
        self._broken = None                 # why a step did not finish, if one did not
        if not wd.enabled:
            comm.clear_config_barrier_timeout()
            _wd.clear_config_dump_path()
            return
        _wd.set_default_dump_path(wd.stack_dump_file or None, source="config")
        self._watchdog = _wd.StepWatchdog(
            factor=wd.step_timeout_factor, percentile=wd.step_timeout_percentile,
            window=wd.window, min_timeout=wd.min_step_timeout,
            startup_timeout=wd.startup_timeout, on_timeout=wd.on_timeout,
            dump_path=wd.stack_dump_file or None)
        comm.set_default_barrier_timeout(wd.barrier_timeout, source="config")
        hb = wd.heartbeat_file or os.environ.get("DS_TPU_HEARTBEAT_FILE", "")
        if hb:
            self._heartbeat_path = hb
            self._heartbeat_interval = wd.heartbeat_interval
        self._consistency_interval = wd.consistency_interval
        if wd.check_fingerprint_at_init:
            from deepspeed_tpu_torch.resilience.consistency import verify_startup_consistency

            # every rank runs the same config, world and code before the
            # first collective; the deadline covers a peer that died
            self._config_fingerprint = verify_startup_consistency(
                self._config._param_dict,
                mesh={"data": self.dp_world_size, "expert": self.ep_world_size},
                timeout=wd.barrier_timeout)

    def _init_resilience(self) -> None:
        """The bad-step sentinel, the rewind ladder and the chaos block. The
        sentinel's and the ladder's modules are imported only with their
        blocks; an engine without an enabled chaos block removes an earlier
        engine's config-installed injector."""
        res = self._config.resilience
        self._bad_step_sentinel = None
        self._sentinel_rewinds = 0
        self._ckpt_save_dir = None           # the last save or load dir: the rewind target
        if res.sentinel.enabled:
            from deepspeed_tpu_torch.resilience.sentinel import BadStepSentinel

            s = res.sentinel
            self._bad_step_sentinel = BadStepSentinel(
                patience=s.patience, spike_factor=s.spike_factor, window=s.window,
                max_rewinds=s.max_rewinds)
        self._rewind = None
        if self._config.rewind_present and self._config.rewind.enabled:
            from deepspeed_tpu_torch.resilience.rewind import RewindManager

            self._rewind = RewindManager(self, self._config.rewind)
        if res.chaos.enabled:
            _chaos.install_chaos(_chaos.ChaosInjector.from_config(res.chaos))
        else:
            _chaos.uninstall_config_chaos()

    def _init_blackbox(self) -> None:
        """The flight recorder (``blackbox/``), armed only by a present and
        enabled block: otherwise the package is never imported, and the
        producers' ``sys.modules`` lookups find nothing. Its bundles are
        per process, so the manifest's world size is the process count."""
        self._blackbox = None
        if not (self._config.blackbox_present and self._config.blackbox.enabled):
            return
        from deepspeed_tpu_torch import blackbox

        self._blackbox = blackbox.configure(self._config.blackbox, rank=comm.get_rank())
        fp = getattr(self, "_config_fingerprint", None)
        if fp is None:
            from deepspeed_tpu_torch.resilience.consistency import config_fingerprint

            # the hash the startup agreement would take: the incident
            # report tells runs apart by it
            fp = config_fingerprint(self._config.to_dict(),
                                    mesh={"data": self.dp_world_size,
                                          "expert": self.ep_world_size})
        self._blackbox.config_fingerprint = fp
        self._blackbox.world_size = comm.get_world_size()

    def _mark_broken(self, e: BaseException) -> None:
        """A step stopped part way (a watchdog timeout, a fault): the flat
        params, masters, moments or gradient buffers may be half updated, so
        the engine refuses further steps until a restore."""
        self._broken = f"{type(e).__name__}: {e}"
        self._stop_step_timers()

    def _stop_step_timers(self) -> None:
        self.timers(TRAIN_BATCH_TIMER).reset()
        self.tput_timer.started = False

    def _check_not_broken(self) -> None:
        if self._broken is not None:
            raise RuntimeError(
                f"a step of this engine did not finish ({self._broken}), so its state may be "
                "half updated: build a new engine (the elastic agent does) or restore a "
                "checkpoint with load_checkpoint before training on")

    def _after_step(self, metrics: "StepMetrics") -> None:
        """The sentinel, then the RAM snapshot (a step the sentinel flagged
        never enters the ring)."""
        if self._bad_step_sentinel is not None:
            self._check_bad_step(metrics)
        if self._rewind is not None:
            self._rewind.maybe_snapshot(self._global_step, metrics)
        if self._blackbox is not None:
            # the recorder's heartbeat: one locked append, no read of the
            # loss and no wait for the card
            self._blackbox.on_step(self._global_step)

    def _check_bad_step(self, metrics: "StepMetrics") -> None:
        """Feed the step's loss and overflow flag to the sentinel; when it
        trips, rewind through the snapshot ladder: the RAM tier in place
        when the ring holds a snapshot, else the last verified disk
        checkpoint. With nothing to rewind to, or past ``max_rewinds``,
        raise ``BadStepError``. Counts ``resilience/sentinel_rewinds{tier}``."""
        from deepspeed_tpu_torch.resilience.sentinel import BadStepError

        sentinel = self._bad_step_sentinel
        if not sentinel.observe(float(metrics.loss), overflow=bool(metrics.overflow)):
            return
        reason = sentinel.last_reason
        has_ram = self._rewind is not None and self._rewind.has_ram_snapshot()
        if self._ckpt_save_dir is None and not has_ram:
            raise BadStepError(
                f"bad-step sentinel tripped ({reason}, patience={sentinel.patience}) and no "
                "checkpoint has been saved or loaded this run (and no RAM snapshot is held) "
                "— nothing to rewind to")
        if self._sentinel_rewinds >= sentinel.max_rewinds:
            raise BadStepError(f"bad-step sentinel tripped ({reason}) after "
                               f"{self._sentinel_rewinds} rewind(s) — giving up")
        self._sentinel_rewinds += 1
        logger.warning(f"bad-step sentinel: {reason} for {sentinel.patience} consecutive "
                       f"step(s); rewinding through the snapshot ladder (rewind "
                       f"{self._sentinel_rewinds}/{sentinel.max_rewinds})")
        if self._watchdog is not None:
            self._watchdog.extend_if_armed()        # a restore is step-sized work
        tier = None
        try:
            if has_ram and self._rewind.restore_from_ram() is not None:
                tier = "ram"
            if tier is None:
                if self._ckpt_save_dir is None:
                    raise BadStepError(
                        f"bad-step sentinel tripped ({reason}): the RAM snapshot was unusable "
                        "and no checkpoint has been saved or loaded this run — nothing to "
                        "rewind to")
                path, _ = self.load_checkpoint(self._ckpt_save_dir)
                if path is None:
                    raise BadStepError(f"bad-step sentinel tripped ({reason}) but no "
                                       f"restorable checkpoint was found in "
                                       f"{self._ckpt_save_dir}")
                tier = (self._last_recovery or {}).get("tier", "disk")
        except BadStepError:
            raise
        except BaseException as e:
            self._mark_broken(e)
            raise
        _telemetry.get_registry().counter("resilience/sentinel_rewinds",
                                          labels={"tier": tier}).inc()
        _telemetry.get_tracer().instant("sentinel_rewind", cat="resilience", reason=reason,
                                        tier=tier)
        bb = sys.modules.get("deepspeed_tpu_torch.blackbox")
        if bb is not None:
            bb.record("sentinel_rewind", "error",
                      {"reason": reason, "tier": tier, "rewind": self._sentinel_rewinds,
                       "max_rewinds": sentinel.max_rewinds}, step=self._global_step)
        sentinel.reset()

    def _touch_heartbeat_now(self) -> None:
        """A heartbeat outside the step cadence: a save or a load is
        progress, not a wedge; one reached from inside an armed step (the
        sentinel's rewind) gets ``startup_timeout`` more."""
        if self._heartbeat_path is not None:
            from deepspeed_tpu_torch.resilience.watchdog import touch_heartbeat

            touch_heartbeat(self._heartbeat_path)
        if self._watchdog is not None:
            self._watchdog.extend_if_armed()

    def _check_experts(self, model) -> None:
        """A MoE model: its expert-parallel size and coordinate must be the
        grid's, and it routes over the engine's groups. Its expert banks are
        ZeRO units like the others, so offload and ``zero.Init`` place and
        update them as they do the dense units."""
        loss_args = inspect.signature(model.loss).parameters
        self._loss_kwargs = {k for k in ("generator", "loss_weight", "dropout_rank")
                             if k in loss_args}
        if not hasattr(model, "expert_module_names"):
            return
        ep = self.grid.get_expert_parallel_world_size()
        if model.ep_size != ep or model.ep_rank != self.grid.get_expert_parallel_rank():
            raise ValueError(f"the model holds experts {model.ep_rank} of {model.ep_size}-way "
                             f"expert parallelism, the engine's grid has tpu.expert={ep} and "
                             f"this rank at {self.grid.get_expert_parallel_rank()}")
        model.expert_groups = self.grid.expert_groups

    # ---------------------------------------------------------- compression
    def arm_compression(self, config) -> "DeepSpeedEngine":
        """Install the compression of ``config`` (a ``CompressionConfig``):
        the model reads its armed weights compressed at the engine's step
        through a ``CompressedParams`` gatherer. Returns the engine."""
        from deepspeed_tpu_torch.compression.compress import (CompressedParams,
                                                              CompressionTransform,
                                                              stacked_layers_of)

        if not hasattr(self.module, "param_gatherer"):
            raise NotImplementedError(
                f"compression training of {type(self.module).__name__}: the model must "
                "compute through its modules' parameters (param_gatherer, as "
                "models/common.py GatheredModule does)")
        transform = CompressionTransform(config, dict(self.module.named_parameters()),
                                         stacked_layers_of(self.module))
        inner = self.module.param_gatherer
        if isinstance(inner, CompressedParams):
            inner = inner.inner
        self._zero.served.clear()             # an earlier arming's compressed values
        fetched = any(self._zero.fetched)
        self._compression = transform
        self._compressed = CompressedParams(
            self.module, transform, inner, zero=self._zero if fetched else None,
            index={n: i for i, n in enumerate(self._param_names)})
        self.module.param_gatherer = self._compressed
        self.invalidate_compiled()
        return self

    def invalidate_compiled(self) -> None:
        """Drop what baked in the compression (the JAX engine's
        ``invalidate_compiled``): the compressed weights are recomputed at
        their next use; a hybrid engine also drops its captured decode
        loops."""
        self._compression_at = None

    def _refresh_compression(self) -> None:
        """The compressed weights and gradient masks of the current step,
        computed once per step before the first use."""
        if self._compressed is None or self._compression_at == self._global_step:
            return
        self._compressed.refresh(self._global_step)
        self._compression_at = self._global_step

    @contextlib.contextmanager
    def _raw_params(self):
        """The model computing with its raw weights (the eigenvalue's
        Hessian is of the raw loss, as in JAX); yields those weights by
        name, leaves of the graph the loss is differentiated in. With
        fetched units (ZeRO stage 3, ``offload_param``) they are whole
        copies on the card that the model reads through a gatherer of its
        own, outside the units' gathers and gradient buffers."""
        gatherer = self.module.param_gatherer
        named = dict(self.module.named_parameters())
        if any(self._zero.fetched):
            index = {n: i for i, n in enumerate(self._param_names)}
            named = {n: self._zero.whole_param(index[n]).detach().clone().requires_grad_(True)
                     if n in index else p for n, p in named.items()}
            self.module.param_gatherer = _WholeParams(self.module, named)
        elif self._compressed is not None:
            self.module.param_gatherer = self._compressed.inner
        try:
            yield named
        finally:
            self.module.param_gatherer = gatherer

    @torch.no_grad()
    def finalize_params(self, transform) -> dict:
        """Every trainable parameter, whole, with ``transform``'s terminal
        compression made permanent (``redundancy_clean``), read one stacked
        leaf at a time; in host memory under ``offload_param``."""
        index = {n: i for i, n in enumerate(self._param_names)}
        home = torch.device("cpu") if self._host_offload_param else self.device
        return transform.finalize(
            {n: None for n in self._param_names},
            read=lambda n: self._zero.whole_param(index[n]),
            place=lambda t: t.to(home))

    @torch.no_grad()
    def replace_params(self, values: Mapping[str, torch.Tensor]) -> None:
        """The compute-type params from whole tensors by name (every
        trainable parameter); the fp32 copy the optimizer updates too when
        the engine keeps no separate master (fp32 training, where the JAX
        engine's params are its masters)."""
        tensors = [values[n].detach() for n in self._param_names]
        self._zero.load(PARAMS, tensors)
        if not self._keep_master and self._nvme_optimizer is None:
            self._zero.load(self._zero.fp32, tensors)
        self._compression_at = None

    def _maybe_update_eigenvalue(self, batch) -> None:
        """MoQ's coupling at a gradient-accumulation boundary (the JAX
        engine's ``_maybe_update_eigenvalue``): every
        ``gas_boundary_resolution`` steps while quantization stages are
        armed and some layer has a bit width still to reach, estimate the
        layers' eigenvalues on the first microbatch with the raw weights and
        install the period factors ``1 + int(4 ev)``, a change accepted only
        past the adjacent bucket's midpoint (hysteresis). The factors take
        effect from the next step."""
        comp = self._compression
        step = self._global_step
        if (comp is None or not comp.any_quant_armed()
                or step % self.eigenvalue.gas_boundary_resolution
                or not comp.any_precision_switch(step)):
            return
        from deepspeed_tpu_torch.models.common import plain_math

        micro = next(self._split(batch, self._config.gradient_accumulation_steps))
        gen = torch.Generator(device=self.device).manual_seed(
            (self._config.seed * 1_000_003 + step) * 1_009 + 0xE1)
        with self._raw_params() as params, plain_math(self.module):
            self.block_eigenvalue = self.eigenvalue.compute_eigenvalue(
                lambda: self.module.loss(micro), params, generator=gen)
        if not self.block_eigenvalue:
            return
        raw = [ev for ev, _ in self.block_eigenvalue.values()]
        if self._group is not None:
            # every rank installs rank 0's estimate
            t = torch.tensor(raw, dtype=torch.float32, device=self.device)
            comm.broadcast(t, src=0, group=self._group)
            raw = t.tolist()
            self.block_eigenvalue = {i: (ev, i) for i, ev in enumerate(raw)}
        old = comp._ev_factors
        factors = []
        for layer, ev in enumerate(raw):
            new = 1 + int(ev * 4)
            if old is not None and layer < len(old) and new != old[layer]:
                # hysteresis: a flip only when 4 ev moved past the adjacent
                # bucket's midpoint, so a layer riding a boundary stays put
                if abs(4.0 * ev - (old[layer] - 0.5)) <= 1.0:
                    new = old[layer]
            factors.append(new)
        if comp.set_eigenvalue_factors(factors, layer_name=self.eigenvalue.layer_name,
                                       step=step):
            # the windows moved: the next use recomputes the compressed
            # weights (the captured decode graphs read the same buffers)
            self._compression_at = None

    def eigenvalue_enabled(self) -> bool:
        return self.eigenvalue is not None

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
        if isinstance(batch, (tuple, list)):
            return tuple(put(v) for v in batch)
        return put(batch)

    def _split(self, batch, gas: int):
        """The global batch (a dict, a tuple of row-aligned arrays such as
        ``(x, y)``, or one array) as ``gas`` microbatches of consecutive
        rows."""
        if isinstance(batch, Mapping):
            first = next(iter(batch.values()))
        else:
            first = batch[0] if isinstance(batch, tuple) else batch
        rows = first.shape[0]
        if rows % gas:
            raise ValueError(f"batch of {rows} rows does not split into {gas} microbatches")
        m = rows // gas
        take = lambda x, i: x[i * m:(i + 1) * m]
        for i in range(gas):
            if isinstance(batch, Mapping):
                yield {k: take(v, i) for k, v in batch.items()}
            elif isinstance(batch, tuple):
                yield tuple(take(v, i) for v in batch)
            else:
                yield take(batch, i)

    def _forward(self, batch, weight=None, micro: int = 0):
        """The model's loss of one microbatch, given the generator (seeded
        alike on every rank), the data-parallel rank and the token weight
        where its ``loss`` takes them."""
        kwargs = {}
        if "generator" in self._loss_kwargs:
            kwargs["generator"] = torch.Generator(device=self.device).manual_seed(
                (self._config.seed * 1_000_003 + self._global_step) * 1_009 + micro)
        if "dropout_rank" in self._loss_kwargs:
            kwargs["dropout_rank"] = self.global_rank
        if weight is not None and "loss_weight" in self._loss_kwargs:
            kwargs["loss_weight"] = weight
        if self.progressive_layer_drop is not None:
            pld = self._config.pld_config
            kwargs["pld_theta"] = theta_at(self._global_step, pld.theta, pld.gamma)
        with self._zero.forward_context():
            return self.module.loss(batch, **kwargs)

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
        grad_norm = self._grad_norm(grads, group) * inv_scale   # unscaled global norm
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

    def _grad_norm(self, grads, group) -> torch.Tensor:
        """The global L2 norm: each expert unit (whole on each of the ranks
        that hold its experts) counted once, its squares summed over the
        expert-parallel group; the other units' over ``group``."""
        if not self._expert_units:
            return get_grad_norm(grads, group=group)
        ex = set(self._expert_units)
        sq = lambda ts: torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32).square()
                                     for g in ts]).sum()
        dense = sq([g for u, g in enumerate(grads) if u not in ex])
        experts = sq([grads[u] for u in self._expert_units])
        if group is not None:
            comm.all_reduce(dense, group=group)
        if self.grid.get_expert_parallel_group() is not None:
            comm.all_reduce(experts, group=self.grid.get_expert_parallel_group())
        return (dense + experts).sqrt()

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
        if self._heartbeat_path is not None and step % self._heartbeat_interval == 0:
            from deepspeed_tpu_torch.resilience.watchdog import touch_heartbeat

            # the launcher's liveness proof: its absence is the signal
            touch_heartbeat(self._heartbeat_path)
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(step)
        if self._config.steps_per_print and step % self._config.steps_per_print == 0:
            log_dist(f"step={step} loss={float(metrics.loss):.4f} lr={metrics.lr:.3e} "
                     f"gnorm={float(metrics.grad_norm):.3f}"
                     + (f" scale={metrics.loss_scale:.0f}" if self.fp16_enabled else ""),
                     ranks=[0])
            if self.wall_clock_breakdown:
                self.timers.log([TRAIN_BATCH_TIMER, FORWARD_GLOBAL_TIMER,
                                 BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER])
            if self._config.memory_breakdown:
                see_memory_usage(f"after step {step}", force=True)
        if self.monitor.enabled:
            self.monitor.write_events([
                ("Train/Samples/train_loss", float(metrics.loss), self.global_samples),
                ("Train/Samples/lr", float(metrics.lr), self.global_samples)])
        session = _telemetry.get_session()
        if session is not None:
            self._record_step_telemetry(session, metrics, step)
        if self._goodput is not None:
            # the previous step's ledger: this step's train_batch span is
            # still open here, so the goodput/* series lag one step
            self._goodput.on_step(step)
        if self._mem_profiler is not None:
            self._mem_profiler.maybe_sample(self, step)

    def _record_step_telemetry(self, session, metrics: StepMetrics, step: int) -> None:
        """The JAX engine's per-step series and the flush cadence, on the
        live session. The float() reads are one host sync per step, what
        enabling telemetry opts into. The ``device/*`` gauges read the
        caching allocator on the card; the CPU has none, as JAX's
        ``memory_stats`` has none there."""
        reg = session.registry
        reg.counter("train/steps").inc()
        reg.counter("train/samples").inc(self.train_batch_size())
        reg.gauge("train/loss").set(float(metrics.loss))
        reg.gauge("train/grad_norm").set(float(metrics.grad_norm))
        reg.gauge("train/lr").set(float(metrics.lr))
        if self.fp16_enabled:
            reg.gauge("train/loss_scale").set(float(metrics.loss_scale))
        if bool(metrics.overflow):
            reg.counter("train/overflow_steps").inc()
        sps = self.tput_timer.avg_samples_per_sec()
        if sps > 0:
            reg.gauge("train/samples_per_sec").set(sps)
        if self.device.type == "cuda":
            reg.gauge("device/bytes_in_use").set(float(torch.cuda.memory_allocated(self.device)))
            reg.gauge("device/peak_bytes_in_use").set(
                float(torch.cuda.max_memory_allocated(self.device)))
        session.step_end(step)

    # ----------------------------------------------------------- public API
    def train_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        """Consume this rank's rows of one global batch (all microbatches)
        and take one step. Returns the world's mean loss over the
        microbatches (a 0-d fp32 tensor, the same on every rank). With the
        ``watchdog`` block the whole call, the data fetch included, runs
        under the step deadline.

        An exception before the first backward (in the data fetch or a
        forward, an out-of-memory say) leaves the state as it was, and the
        caller may retry. One from the first backward on (with or without
        the resilience blocks) may leave the gradient buffers, params,
        masters or moments half updated: the engine then refuses
        ``train_batch`` and ``step`` until a whole-state
        ``load_checkpoint`` (or the elastic agent's rebuilt engine)."""
        self._check_not_broken()
        if self._watchdog is None:
            return self._train_batch_outer(batch, data_iter)
        self._watchdog.arm()
        try:
            return self._train_batch_outer(batch, data_iter)
        finally:
            self._watchdog.disarm()

    def _train_batch_outer(self, batch, data_iter) -> torch.Tensor:
        gas = self._config.gradient_accumulation_steps
        tracer = _telemetry.get_tracer()
        with tracer.span("data", step=self._global_step):
            if batch is None:
                if data_iter is None:
                    raise ValueError("train_batch needs a batch or data_iter")
                batch = next(data_iter)
            if self.curriculum_scheduler is not None:
                difficulty = self.curriculum_scheduler.update_difficulty(self._global_step + 1)
                batch = apply_seqlen_curriculum(batch, difficulty)
            batch = self._to_device(batch)
        # the chaos step hook before any launch: an injected fault changes
        # no state
        inj = _chaos.active_injector()
        if inj is not None and inj.targets("train_step"):
            inj.before("train_step", f"step={self._global_step + 1}")
        profile = self._flops_profile_due()
        with tracer.span("train_batch", step=self._global_step):
            mean_loss = (self._profiled_train_batch if profile else self._train_batch)(batch, gas)
        if self._consistency_interval and self._global_step % self._consistency_interval == 0:
            from deepspeed_tpu_torch.resilience.consistency import check_step_agreement

            # the engine's generators are seeded from (seed, step): the
            # seed is its RNG state
            check_step_agreement(self._global_step, float(mean_loss),
                                 rng=np.int64(self._config.seed))
        if self.eigenvalue is not None:
            with tracer.span("eigenvalue", step=self._global_step):
                self._maybe_update_eigenvalue(batch)
        if profile:
            self._print_flops_profile()
        return mean_loss

    def _train_batch(self, batch, gas: int) -> torch.Tensor:
        self.timers(TRAIN_BATCH_TIMER).start()
        self.tput_timer.start()
        writing = False                 # the state is untouched until the first backward
        try:
            self._refresh_compression()
            microbatches = list(self._split(batch, gas))
            weights = self._token_weights(microbatches)
            losses = []
            for i, mb in enumerate(microbatches):
                loss = self._forward(mb, None if weights is None else weights[i], i)
                if weights is not None:
                    loss = loss * weights[i]
                writing = True
                self._backward(loss)
                losses.append(loss.detach().float())
            mean_loss = self._world_mean(torch.stack(losses).mean())
            self.micro_steps += gas
            self._apply_grads(mean_loss, gas)
        except BaseException as e:
            if writing:
                self._mark_broken(e)
            else:
                self._stop_step_timers()
            raise
        self.timers(TRAIN_BATCH_TIMER).stop()
        self.tput_timer.stop(global_step=True)
        self._after_step(self._last_metrics)
        return mean_loss

    def forward(self, batch):
        """The loss of one microbatch (this rank's), with its autograd graph."""
        with _telemetry.get_tracer().span("fwd", step=self._global_step):
            return self._forward_call(batch)

    def _forward_call(self, batch):
        self.timers(FORWARD_GLOBAL_TIMER).start()
        batch = self._to_device(batch)
        self._refresh_compression()
        weights = self._token_weights([batch])
        self._pending_weight = None if weights is None else weights[0]
        loss = self._forward(batch, self._pending_weight,
                             self.micro_steps % self._config.gradient_accumulation_steps)
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss, allreduce_gradients=True, release_loss=False):
        """Backpropagate one microbatch's (scaled) loss into the fp32
        accumulation buffers, weighted by the microbatch's token share."""
        with _telemetry.get_tracer().span("bwd", step=self._global_step):
            return self._backward_call(loss)

    def _backward_call(self, loss):
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
        self._check_not_broken()
        if self._watchdog is not None:
            self._watchdog.arm()
        try:
            with _telemetry.get_tracer().span("step", step=self._global_step):
                self.timers(STEP_GLOBAL_TIMER).start()
                try:
                    self._apply_grads(self._world_mean(self._micro_loss),
                                      self._config.gradient_accumulation_steps)
                except BaseException as e:
                    self._mark_broken(e)
                    raise
                self._micro_loss = None
                self.timers(STEP_GLOBAL_TIMER).stop()
                self._after_step(self._last_metrics)
        finally:
            if self._watchdog is not None:
                self._watchdog.disarm()

    def eval_batch(self, batch) -> torch.Tensor:
        """Loss without gradients (for eval loops), with the compressed
        weights of the current step when compression is armed."""
        self._refresh_compression()
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

        self._ckpt_save_dir = save_dir          # the sentinel's rewind target
        self._touch_heartbeat_now()
        try:
            with _telemetry.get_tracer().span("save_checkpoint", cat="checkpoint"):
                return save_engine_checkpoint(self, save_dir, tag=tag,
                                              client_state=client_state,
                                              save_latest=save_latest)
        finally:
            self._touch_heartbeat_now()

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False, custom_load_fn=None):
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import \
            load_engine_checkpoint

        self._touch_heartbeat_now()
        with _telemetry.get_tracer().span("load_checkpoint", cat="checkpoint"):
            path, client_state = load_engine_checkpoint(
                self, load_dir, tag=tag, load_optimizer_states=load_optimizer_states,
                load_module_only=load_module_only)
        self._touch_heartbeat_now()
        self.invalidate_compiled()            # the weights the compression read changed
        if path is not None:
            self._ckpt_save_dir = load_dir    # the sentinel's rewind target
            if not (load_module_only or not load_optimizer_states):
                self._broken = None           # the whole state was restored
        return path, client_state
