"""DeepSpeed JSON config → typed config objects, for the training engine.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (and so of the
reference's ``deepspeed/runtime/config.py``), on the port's dataclass base
(no pydantic on the card's machine). One ds_config drives the engine, and
the batch triple ``train_batch_size = micro_batch * grad_accum * dp_world``
is resolved and validated centrally with the reference's rules and errors.

The port reads ``fp16``, ``bf16``, ``optimizer``, ``scheduler``,
``gradient_clipping``, ``zero_optimization``, ``aio``, ``comms_logger``, ``data_types``,
``sparse_attention``, ``checkpoint``, ``resilience``, ``data_efficiency``
(random-LTD's ``data_routing`` included: accepted, and applied to no model,
as in JAX), ``curriculum_learning``, ``dataloader_drop_last``,
``progressive_layer_drop``, ``activation_checkpointing``, ``memory_breakdown``,
``dump_state``, ``hybrid_engine``, ``compression_training`` (validated as
``compression/config.py`` reads it), ``eigenvalue``, ``telemetry`` (the
session ``telemetry/`` installs, with the ``monitor`` fan-out), the monitor
blocks ``tensorboard``, ``wandb`` and ``csv_monitor`` (``monitor/``),
``flops_profiler`` and ``profiling`` (``profiling/``; ``profiling_present``
says whether the block is there), ``goodput`` (``goodput/``;
``goodput_present``), ``blackbox`` (the flight recorder of ``blackbox/``;
``blackbox_present``), ``serving`` (the front-end of
``serving/``; ``serving_present`` says whether the block is there),
``watchdog``, ``rewind`` (``rewind_present``), ``elasticity``
(``elasticity/config.py``; None without the block), ``steps_per_print``,
``wall_clock_breakdown``, ``seed``, the ``tpu`` block's ``data`` and
``expert`` axes, and the batch keys.

The JAX package's advisory keys (its ``ADVISORY_NOOP_KEYS``) are the
reference's knobs that change nothing there. Here each has the reason that
is true of the port on CUDA: :data:`ADVISORY_NOOP_KEYS` are accepted at any
value, and :data:`ADVISORY_REFUSED_KEYS` only at the value that asks for
nothing (another raises ``ValueError`` with the reason and the knob to use).
The engine logs every one a config sets.

Every other top-level key the JAX package knows raises
``NotImplementedError`` naming it when present, rather than being ignored,
and so do the parts of a read block that belong to a later slice (the
chaos knobs of several devices, ``elasticity.resize.enabled``); a key
neither package knows is rejected with a did-you-mean hint.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Union

import torch

from deepspeed_tpu_torch.runtime.config_utils import (DeepSpeedConfigModel,
                                                      format_unknown_key_hints)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils.logging import logger

# the top-level keys the port reads
SUPPORTED_KEYS = frozenset({
    "fp16", "bf16", "bfloat16", "zero_optimization", "aio", "comms_logger", "data_types",
    "optimizer",
    "scheduler", "gradient_clipping", "sparse_attention", "steps_per_print",
    "wall_clock_breakdown", "seed", "checkpoint", "resilience", "data_efficiency",
    "curriculum_learning", "dataloader_drop_last", "progressive_layer_drop", "tpu",
    "activation_checkpointing", "memory_breakdown", "dump_state",
    "hybrid_engine", "compression_training", "eigenvalue", "telemetry", "serving",
    "watchdog", "rewind", "elasticity", "tensorboard", "wandb", "csv_monitor",
    "flops_profiler", "profiling", "goodput", "blackbox", "train_batch_size",
    "train_micro_batch_size_per_gpu",
    "train_micro_batch_size_per_chip", "gradient_accumulation_steps",
})

# the other top-level keys the JAX package accepts (its KNOWN_TOP_LEVEL_KEYS):
# each is a later slice of the port
LATER_KEYS = frozenset({
    "pipeline", "gradient_compression", "autotuning", "analysis",
    "perf", "overlap", "wire", "sdc", "roofline", "gray",
})

# The JAX package's advisory keys that the port accepts at any value, each
# with why it changes nothing here (the engine logs the reason).
ADVISORY_NOOP_KEYS = {
    "sparse_gradients":
        "the port's embedding gradients are dense tensors: the lookup's backward "
        "scatter-adds into the embedding's dense gradient (models/gpt2.py:287 "
        "embed_stage, models/llama.py:223 _embed), which joins its ZeRO unit's flat "
        "buffer and is reduced with the rest (runtime/zero/state.py:312 grad_hook); a "
        "sparse reduction would carry the same values",
    "prescale_gradients":
        "every gradient reduction is ReduceOp.AVG in data_types.grad_accum_dtype, fp32 "
        "unless set (runtime/zero/state.py:351 and :396), and NCCL runs a floating-point "
        "average as a sum of each rank's gradient pre-multiplied by 1/world: the "
        "gradients are always prescaled",
    "nebula":
        "the port's checkpoint engine already saves asynchronously: save_checkpoint "
        "blocks only for the copy to host memory and a background thread writes and "
        "commits the tag (checkpoint.async_save, runtime/checkpoint_engine/engine.py:537); "
        "nebula's tiers and storage paths have no counterpart",
    "zero_allow_untested_optimizer":
        "a client optimizer is a deepspeed_tpu_torch.ops.optimizers.Optimizer, which "
        "updates one flat fp32 tensor per ZeRO unit at every stage (runtime/engine.py:988 "
        "_configure_optimizer): there is no untested-optimizer gate to pass",
    "zero_force_ds_cpu_optimizer":
        "the port has no CPU Adam to force: offload_optimizer cpu keeps the state in "
        "host memory and the card does the math (runtime/zero/offload.py HostOffload), "
        "and offload_optimizer nvme steps its one AdamW on the host "
        "(runtime/swap_tensor/optimizer_swapper.py)",
    "timers":
        "throughput timing is always on (ThroughputTimer, utils/timer.py; the engine's "
        "tput_timer, runtime/engine.py:394) and the synchronized breakdown is the "
        "wall_clock_breakdown knob: set that instead",
}

# The JAX package's advisory keys that the port accepts only at the value
# that asks for nothing: key -> (that value, why another value is refused
# on CUDA and what to use instead). communication_data_type is also
# accepted at the gradient-accumulation type, which is what the port
# communicates in.
ADVISORY_REFUSED_KEYS = {
    "gradient_predivide_factor": (
        1.0,
        "the port divides by the world inside one ReduceOp.AVG (runtime/zero/state.py:351 "
        "and :382), with no split of the division around the reduction; leave it at 1.0 "
        "(prescale_gradients is accepted)"),
    "disable_allgather": (
        False,
        "ZeRO stages 1-3 reassemble updated shards with all_gather_into_tensor "
        "(runtime/zero/state.py:434) and have no broadcast path; leave it false"),
    "graph_harvesting": (
        False,
        "the port does not capture the training step as a CUDA graph; only generate's "
        "decode loop is captured (inference/engine.py DecodeLoop); leave it false"),
    "use_data_before_expert_parallel": (
        False,
        "the port's rank grid is data outside expert, rank d * ep + x "
        "(parallel/topology.py:8), with no reordered rank lists; leave it false"),
    "communication_data_type": (
        None,
        "gradients are reduced in data_types.grad_accum_dtype (runtime/zero/state.py:302 "
        "_buffer); set that knob instead"),
}

# the keys of the "sparse_attention" block: every SparsityConfig's keyword
# arguments and the mode (the JAX package's RAW_BLOCK_KEYS entry)
SPARSE_ATTENTION_KEYS = frozenset({
    "mode", "block", "different_layout_per_head", "num_local_blocks", "num_global_blocks",
    "attention", "horizontal_global_attention", "num_different_global_patterns",
    "num_random_blocks", "local_window_blocks", "global_block_indices",
    "global_block_end_indices", "num_sliding_window_blocks"})

# the raw-dict blocks the data pipeline reads permissively, with their
# accepted keys one level deep (the JAX package's RAW_BLOCK_KEYS entries);
# a dotted name is a nested block
RAW_BLOCK_KEYS = {
    "data_efficiency": frozenset({"enabled", "seed", "data_sampling", "data_routing"}),
    "data_efficiency.data_sampling": frozenset({
        "enabled", "num_epochs", "num_workers", "pin_memory", "curriculum_learning"}),
    "curriculum_learning": frozenset({
        "enabled", "curriculum_type", "min_difficulty", "max_difficulty",
        "schedule_type", "schedule_config"}),
}

# reference keys refused with a pointer
REJECTED_KEYS = {
    "amp": "apex automatic mixed precision is not supported; use bf16 or fp16 with "
           "dynamic loss scaling",
}


def _check_min(block, **bounds):
    for name, (lo, strict) in bounds.items():
        value = getattr(block, name)
        if value < lo or (strict and value == lo):
            raise ValueError(f"{type(block).__name__}.{name} must be "
                             f"{'>' if strict else '>='} {lo}, got {value}")


@dataclasses.dataclass
class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0           # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False

    def __post_init__(self):
        _check_min(self, loss_scale=(0.0, False), initial_scale_power=(0, False),
                   loss_scale_window=(0, True), hysteresis=(0, False),
                   min_loss_scale=(0.0, False))


@dataclasses.dataclass
class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    # keep an fp32 master copy of the weights (BF16_Optimizer semantics)
    master_weights: bool = True


@dataclasses.dataclass
class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: Optional[str] = None


@dataclasses.dataclass
class AioConfig(DeepSpeedConfigModel):
    """The aio block: the NVMe swap's I/O handle (``ops/aio.py``). A request
    is split into ``block_size`` chunks that ``thread_count`` threads read or
    write; ``queue_depth``, ``single_submit`` and ``overlap_events`` parse
    for the reference's config and change nothing, as in the JAX package."""
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclasses.dataclass
class PLDConfig(DeepSpeedConfigModel):
    """The progressive_layer_drop block: θ̄, the floor of the keep
    probability θ(t), and γ, its anneal rate
    (``runtime/progressive_layer_drop.py``)."""
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001

    def __post_init__(self):
        if not 0.0 < self.theta <= 1.0:
            raise ValueError(f"progressive_layer_drop.theta {self.theta} not in (0, 1]")
        _check_min(self, gamma=(0.0, False))


# The hybrid_engine keys that the JAX package accepts as no-ops, with why each
# changes nothing in the port (the engine logs the reason when one is set).
HYBRID_NOOP_KEYS = {
    "pin_parameters":
        "generate reads the training params where they live on the card "
        "(runtime/hybrid_engine.py generate): there is no inference copy to pin",
    "tp_gather_partition_size":
        "it sizes the gathers of tensor-parallel inference shards, and the port "
        "generates at inference_tp_size 1 only",
}


@dataclasses.dataclass
class HybridEngineConfig(DeepSpeedConfigModel):
    """The hybrid_engine block (``runtime/hybrid_engine.py``): ``enabled``
    makes ``initialize`` return the engine that trains and generates over
    the same params; ``max_out_tokens`` caps prompt + new tokens;
    ``pin_parameters`` and ``tp_gather_partition_size`` parse and change
    nothing (:data:`HYBRID_NOOP_KEYS`); ``release_inference_cache`` is
    refused at true and ``inference_tp_size`` above 1 is a later slice
    (tensor-parallel inference)."""
    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8

    def __post_init__(self):
        _check_min(self, max_out_tokens=(0, True), inference_tp_size=(1, False),
                   tp_gather_partition_size=(1, False))
        if self.release_inference_cache:
            raise ValueError(
                "ds_config hybrid_engine.release_inference_cache=true is not supported on "
                "CUDA: generate keeps each key's decode loop (its KV cache and captured graph, "
                "inference/engine.py generate_with_loops) for the next call to replay; leave "
                "it false")
        if self.inference_tp_size > 1:
            raise NotImplementedError(
                f"ds_config hybrid_engine.inference_tp_size={self.inference_tp_size}: "
                "tensor-parallel inference is a later slice of the port")


@dataclasses.dataclass
class EigenvalueConfig(DeepSpeedConfigModel):
    """The eigenvalue block (``runtime/eigenvalue.py``): power iteration on
    each layer's block of the Hessian, feeding MoQ's per-layer quantization
    periods at gradient-accumulation boundaries. ``layer_name`` names the
    model's layer list (``blocks``), ``layer_num`` (0: any) its length."""
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "blocks"
    layer_num: int = 0

    def __post_init__(self):
        _check_min(self, max_iter=(0, True), tol=(0.0, True), stability=(0.0, False),
                   gas_boundary_resolution=(0, True), layer_num=(0, False))


@dataclasses.dataclass
class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    """The activation_checkpointing block, read by
    ``runtime/activation_checkpointing/checkpointing.py`` ``configure``:
    ``cpu_checkpointing`` keeps the matmul outputs in pinned host memory
    instead of recomputing them; ``partition_activations`` is validated and
    does nothing at world 1, as in JAX; the rest parse as in JAX."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclasses.dataclass
class CommsLoggerConfig(DeepSpeedConfigModel):
    """The comms_logger block: a CommsLogger records every collective's
    latency and size (``comm.configure``)."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FlopsProfilerConfig(DeepSpeedConfigModel):
    """The flops_profiler block (``profiling/flops_profiler/``): the engine
    counts the matmul and convolution flops of the step that becomes
    ``profile_step`` and prints the profile after it; ``recompute_fwd_factor``
    parses and changes nothing, as in JAX."""
    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None

    def __post_init__(self):
        _check_min(self, recompute_fwd_factor=(0.0, False))


@dataclasses.dataclass
class TensorboardConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class WandbConfig(DeepSpeedConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


@dataclasses.dataclass
class CSVConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class MonitorConfig(DeepSpeedConfigModel):
    """The three monitor writers' blocks (``monitor/monitor.py``), each a
    top-level ds_config key."""
    tensorboard: TensorboardConfig = dataclasses.field(default_factory=TensorboardConfig)
    wandb: WandbConfig = dataclasses.field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = dataclasses.field(default_factory=CSVConfig)


@dataclasses.dataclass
class ProfilingConfig(DeepSpeedConfigModel):
    """The profiling block (``profiling/memory.py``): the census of the
    card's allocated bytes by the engine's state (params, fp32 masters,
    optimizer state, gradient buffers, the rest) every ``sample_interval``
    steps and at step 1, per-span peak deltas on the telemetry tracer
    (``span_memory``), and the leak sentinel over ``leak_window`` samples.
    ``executable_analysis`` asks for XLA's ``memory_analysis``, which has no
    CUDA counterpart: it records nothing and says so once. Its presence
    arms it (``enabled`` false keeps it present and off); without it the
    module is never imported."""
    enabled: bool = True
    sample_interval: int = 10
    memory: bool = True
    span_memory: bool = True
    executable_analysis: bool = True
    leak_window: int = 5
    leak_min_growth_bytes: int = 1 << 20

    def __post_init__(self):
        _check_min(self, sample_interval=(0, True), leak_window=(2, False),
                   leak_min_growth_bytes=(0, False))


@dataclasses.dataclass
class GoodputConfig(DeepSpeedConfigModel):
    """The goodput block (``goodput/``): every wall-second of a step in the
    closed taxonomy (compute, compile, exposed comm, data wait, checkpoint,
    watchdog stall, straggler wait, restart, idle) from the telemetry
    spans, exported as the ``goodput/*`` series one step behind.
    ``compile_spans`` arms ``op_builder``'s flag, so ``nvcc`` builds,
    library loads and CUDA graph captures land as ``compile`` spans
    (process-wide, and it stays armed, as the JAX listener stays
    registered). ``tolerance``: the fraction of a step's measured window
    its buckets may miss by before ``goodput/closure_violations`` counts
    it. Its presence arms it (``enabled`` false keeps it present and off);
    without it the package is never imported."""
    enabled: bool = True
    compile_spans: bool = True
    tolerance: float = 0.05

    def __post_init__(self):
        _check_min(self, tolerance=(0.0, True))
        if self.tolerance > 1.0:
            raise ValueError(f"GoodputConfig.tolerance must be <= 1.0, got {self.tolerance}")


@dataclasses.dataclass
class BlackboxConfig(DeepSpeedConfigModel):
    """The blackbox block (``blackbox/``): the always-on flight recorder. A
    bounded ring of incident events (watchdog timeouts, chaos injections,
    rewind recoveries, restarts, sentinel rewinds, breaker and serving
    transitions, sheds), each in the ``telemetry/events.py`` envelope, and
    a rolling per-step tail. An event of ``trigger_severity`` or worse (or
    SIGUSR1 with ``signal_snap``, or ``blackbox.snap``) writes an
    ``incidents/<ts>_<trigger>/`` bundle under ``output_dir`` (else the
    telemetry directory) within ``max_bundle_mb``; automatic bundles are at
    least ``min_trigger_interval_s`` apart and the newest ``max_bundles``
    are kept. Everything is on the host. Its presence arms it (``enabled``
    false keeps it present and off); without it the package is never
    imported. The JAX package's fields, defaults and bounds."""
    enabled: bool = True
    ring_size: int = 512
    metric_tail: int = 256
    span_tail: int = 256
    max_bundle_mb: float = 16.0
    max_bundles: int = 8
    min_trigger_interval_s: float = 30.0
    trigger_severity: str = "error"
    signal_snap: bool = True
    output_dir: Optional[str] = None

    def __post_init__(self):
        _check_min(self, ring_size=(1, False), metric_tail=(1, False), span_tail=(1, False),
                   max_bundle_mb=(0.0, True), max_bundles=(1, False),
                   min_trigger_interval_s=(0.0, False))


@dataclasses.dataclass
class CheckpointConfig(DeepSpeedConfigModel):
    """The checkpoint block. A tag is world-agnostic: rank 0 writes the
    whole tensors and the other ranks write nothing, so
    ``use_node_local_storage`` parses and changes nothing, as in the JAX
    package. ``tag_validation`` checks that every rank asked for the same
    tag (Warn logs a mismatch, Fail raises; rank 0's tag is used). The
    universal format and pipeline-split writes are later slices and raise."""
    tag_validation: str = "Warn"      # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: dict = dataclasses.field(default_factory=dict)
    # write the state on a background thread; save_checkpoint blocks only
    # for the copy to host memory
    async_save: bool = True

    def __post_init__(self):
        if self.tag_validation.lower() not in ("ignore", "warn", "fail"):
            raise ValueError(f"checkpoint.tag_validation={self.tag_validation!r} not in "
                             "('Ignore', 'Warn', 'Fail')")
        later = (
            (self.load_universal, "load_universal=true (the universal checkpoint format)"),
            (any(self.parallel_write.values()),
             f"parallel_write={self.parallel_write} (writes split across pipeline stages)"))
        for asked, what in later:
            if asked:
                raise NotImplementedError(f"ds_config checkpoint.{what}: later slice of "
                                          f"the port")


@dataclasses.dataclass
class ResilienceRetryConfig(DeepSpeedConfigModel):
    """Retry policy of the checkpoint engine's filesystem I/O."""
    enabled: bool = True
    max_attempts: int = 4
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    deadline: float = 30.0
    jitter: float = 0.25

    def __post_init__(self):
        _check_min(self, max_attempts=(1, False), base_delay=(0.0, False),
                   multiplier=(1.0, False), max_delay=(0.0, False), deadline=(0.0, True),
                   jitter=(0.0, False))
        if self.jitter > 1.0:
            raise ValueError(f"ResilienceRetryConfig.jitter must be <= 1.0, got {self.jitter}")


@dataclasses.dataclass
class ResilienceSentinelConfig(DeepSpeedConfigModel):
    """The bad-step sentinel (``resilience/sentinel.py``): after
    ``patience`` consecutive non-finite, overflow-skipped or spiking steps
    the engine rewinds through the snapshot ladder instead of burning the
    job; ``max_rewinds`` bounds the loop (then ``BadStepError``)."""
    enabled: bool = False
    patience: int = 3
    spike_factor: float = 0.0
    window: int = 20
    max_rewinds: int = 2

    def __post_init__(self):
        _check_min(self, patience=(1, False), spike_factor=(0.0, False), window=(2, False),
                   max_rewinds=(0, False))


# the fault classes of the JAX injector that need several devices or a
# simulated mesh (elasticity.resize, resilience.sdc and .gray): later slices
CHAOS_MESH_KNOBS = ("shrink_at_step", "shrink_to", "grow_at_step", "grow_to",
                    "collective_mismatch", "collective_mismatch_rank", "bitflip_at_step",
                    "bitflip_rate", "bitflip_target", "bitflip_device", "bitflip_bit",
                    "slow_from_step", "slow_device", "slow_factor", "slow_rate", "slow_min_s",
                    "slow_kind")


@dataclasses.dataclass
class ResilienceChaosConfig(DeepSpeedConfigModel):
    """Seedable fault injection (``resilience/chaos.py``), with the JAX
    block's fields, defaults and bounds; an enabled block installs the
    injector at engine init. The fault classes of several devices (its
    ``shrink``/``grow``, ``bitflip``, ``slow_device`` and
    ``collective_mismatch`` knobs, :data:`CHAOS_MESH_KNOBS`) are later
    slices: an enabled block with one set away from its default raises."""
    enabled: bool = False
    seed: int = 0
    failure_rate: float = 0.0
    truncate_rate: float = 0.0
    delay_rate: float = 0.0
    max_delay_s: float = 0.02
    hang_rate: float = 0.0
    hang_s: float = 3600.0
    preempt_rate: float = 0.0
    shrink_at_step: int = -1
    shrink_to: int = 0
    grow_at_step: int = -1
    grow_to: int = 0
    ops: list = dataclasses.field(default_factory=list)
    collective_mismatch: bool = False
    collective_mismatch_rank: int = -1
    bitflip_at_step: int = -1
    bitflip_rate: float = 0.0
    bitflip_target: str = "params"
    bitflip_device: int = 0
    bitflip_bit: int = 12
    slow_from_step: int = -1
    slow_device: int = 0
    slow_factor: float = 1.0
    slow_rate: float = 0.0
    slow_min_s: float = 0.0
    slow_kind: str = "compute"

    def __post_init__(self):
        _check_min(self, failure_rate=(0.0, False), truncate_rate=(0.0, False),
                   delay_rate=(0.0, False), max_delay_s=(0.0, False), hang_rate=(0.0, False),
                   hang_s=(0.0, False), preempt_rate=(0.0, False), shrink_at_step=(-1, False),
                   shrink_to=(0, False), grow_at_step=(-1, False), grow_to=(0, False),
                   collective_mismatch_rank=(-1, False), bitflip_at_step=(-1, False),
                   bitflip_rate=(0.0, False), bitflip_device=(0, False),
                   bitflip_bit=(0, False), slow_from_step=(-1, False), slow_device=(0, False),
                   slow_factor=(0.0, False), slow_rate=(0.0, False), slow_min_s=(0.0, False))
        for name in ("failure_rate", "truncate_rate", "delay_rate", "hang_rate",
                     "preempt_rate", "bitflip_rate", "slow_rate"):
            if getattr(self, name) > 1.0:
                raise ValueError(f"ResilienceChaosConfig.{name} must be <= 1.0, "
                                 f"got {getattr(self, name)}")
        if self.bitflip_bit > 31:
            raise ValueError(f"ResilienceChaosConfig.bitflip_bit must be <= 31, "
                             f"got {self.bitflip_bit}")
        # the JAX block's consistency rules: an armed drill with its target
        # left at the default is a typo, not a drill
        if self.shrink_at_step >= 0 and self.shrink_to < 1:
            raise ValueError("resilience.chaos: shrink_at_step is set but shrink_to is "
                             f"{self.shrink_to} — name the survivor count (>= 1)")
        if self.grow_at_step >= 0 and self.grow_to < 1:
            raise ValueError("resilience.chaos: grow_at_step is set but grow_to is "
                             f"{self.grow_to} — name the post-grow device count (>= 1)")
        if self.bitflip_at_step >= 0 and self.bitflip_rate <= 0.0:
            raise ValueError("resilience.chaos: bitflip_at_step is set but bitflip_rate is "
                             f"{self.bitflip_rate} — name the flip probability (1.0 for a "
                             "deterministic drill)")
        if self.bitflip_target not in ("params", "grads", "opt_state"):
            raise ValueError("resilience.chaos: bitflip_target must be 'params', 'grads' or "
                             f"'opt_state', got {self.bitflip_target!r}")
        if (self.slow_from_step >= 0 or self.slow_rate > 0.0) and self.slow_factor <= 1.0:
            raise ValueError("resilience.chaos: slow_device fault is armed but slow_factor is "
                             f"{self.slow_factor} — name the inflation multiple (> 1.0; 5.0 "
                             "for the acceptance drill)")
        if self.slow_kind not in ("compute", "link", "host"):
            raise ValueError("resilience.chaos: slow_kind must be 'compute', 'link' or "
                             f"'host', got {self.slow_kind!r}")
        defaults = ResilienceChaosConfig.__dataclass_fields__
        mesh = [k for k in CHAOS_MESH_KNOBS if getattr(self, k) != defaults[k].default]
        if self.enabled and mesh:
            raise NotImplementedError(
                f"ds_config resilience.chaos {mesh}: the shrink/grow, bitflip, slow_device "
                "and collective_mismatch fault classes need several devices or a simulated "
                "mesh, a later slice of the port")


@dataclasses.dataclass
class ResilienceConfig(DeepSpeedConfigModel):
    """Verified checkpoints and the restore policy, the bad-step
    ``sentinel`` and the ``chaos`` drill injector."""
    verify_on_load: bool = True
    fallback_to_last_good: bool = True
    retry: ResilienceRetryConfig = dataclasses.field(default_factory=ResilienceRetryConfig)
    sentinel: ResilienceSentinelConfig = dataclasses.field(
        default_factory=ResilienceSentinelConfig)
    chaos: ResilienceChaosConfig = dataclasses.field(default_factory=ResilienceChaosConfig)


@dataclasses.dataclass
class WatchdogConfig(DeepSpeedConfigModel):
    """The step watchdog and the consistency guard
    (``resilience/watchdog.py``, ``resilience/consistency.py``), with the
    JAX block's fields, defaults and bounds. A stalled step ends in a stack
    dump and a ``WatchdogTimeout`` (``on_timeout`` "raise") or a SIGABRT
    ("kill"); ranks agree on a config fingerprint at init and on (step,
    loss bits, RNG hash) every ``consistency_interval`` steps; the engine
    touches ``heartbeat_file`` (else ``DS_TPU_HEARTBEAT_FILE``) every
    ``heartbeat_interval`` steps. Without the block nothing of this runs."""
    enabled: bool = False
    step_timeout_factor: float = 3.0
    step_timeout_percentile: float = 0.95
    window: int = 32
    min_step_timeout: float = 60.0
    startup_timeout: float = 600.0
    barrier_timeout: float = 300.0
    on_timeout: str = "raise"
    stack_dump_file: str = ""
    consistency_interval: int = 0
    check_fingerprint_at_init: bool = True
    heartbeat_file: str = ""
    heartbeat_interval: int = 1

    def __post_init__(self):
        _check_min(self, step_timeout_factor=(0.0, True), step_timeout_percentile=(0.0, True),
                   window=(4, False), min_step_timeout=(0.0, True),
                   startup_timeout=(0.0, True), barrier_timeout=(0.0, True),
                   consistency_interval=(0, False), heartbeat_interval=(1, False))
        if self.step_timeout_percentile > 1.0:
            raise ValueError("WatchdogConfig.step_timeout_percentile must be <= 1.0, got "
                             f"{self.step_timeout_percentile}")
        if self.on_timeout not in ("raise", "kill"):
            raise ValueError(f"watchdog.on_timeout must be 'raise' or 'kill', got "
                             f"{self.on_timeout!r}")


@dataclasses.dataclass
class RewindConfig(DeepSpeedConfigModel):
    """The snapshot ladder (``resilience/rewind.py``): a host-RAM snapshot
    of the whole state every ``ram_interval`` healthy steps, ``keep`` of
    them in a process-wide ring; on preemption the elastic agent flushes
    one (a fresh one with ``emergency_fresh``) as an ``emergency_step<N>``
    tag (``emergency_save``); a load takes the freshest verified tier. The
    block's presence arms it (``enabled`` false keeps it present and off);
    without it the module is never imported."""
    enabled: bool = True
    ram_interval: int = 5
    keep: int = 2
    emergency_save: bool = True
    emergency_fresh: bool = True

    def __post_init__(self):
        _check_min(self, ram_interval=(0, True), keep=(1, False))


@dataclasses.dataclass
class TPUMeshConfig(DeepSpeedConfigModel):
    """The ``tpu`` block: the logical axes over the ranks (the JAX
    package's mesh axes). The port reads ``data`` (-1: what the other axes
    leave) and ``expert``, the MoE layers' expert-parallel size, which must
    divide the world. ``dcn_data_parallel`` places the JAX mesh's data axis
    over the slower links between TPU slices; on CUDA the rank order is
    the launcher's, and the key parses and changes nothing. ``pipe``,
    ``seq``, ``tensor``, ``mics`` and ``ici`` above 1 are later slices."""
    pipe: int = 1
    data: int = -1
    mics: int = 1
    ici: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    dcn_data_parallel: bool = True

    def __post_init__(self):
        _check_min(self, pipe=(1, False), mics=(1, False), ici=(1, False),
                   expert=(1, False), seq=(1, False), tensor=(1, False))
        if self.data != -1 and self.data < 1:
            raise ValueError(f"TPUMeshConfig.data must be -1 or >= 1, got {self.data}")
        for axis in ("pipe", "seq", "tensor", "mics", "ici"):
            if getattr(self, axis) > 1:
                raise NotImplementedError(f"ds_config tpu.{axis}={getattr(self, axis)}: later "
                                          "slice of the port")

    def expert_size(self, world: int) -> int:
        """The expert axis over ``world`` ranks, checked as the JAX mesh
        build checks its dims."""
        if world % self.expert:
            raise ValueError(f"world {world} not divisible by tpu.expert={self.expert}")
        if self.data != -1 and self.data * self.expert != world:
            raise ValueError(f"tpu mesh data={self.data} x expert={self.expert} needs "
                             f"{self.data * self.expert} ranks but {world} are present")
        return self.expert


@dataclasses.dataclass
class TelemetryConfig(DeepSpeedConfigModel):
    """The telemetry block (``telemetry/``): the process-wide registry
    (counters, gauges, p50/p90/p99 histograms) and Chrome-trace spans,
    exported to JSONL and Prometheus text by process 0. ``inference``
    makes ``generate`` observed (a host sync at prefill's end, the
    ``inference/*`` series). ``monitor`` fans the registry out through the
    engine's monitor writers as ``Telemetry/*`` tags."""
    enabled: bool = False
    output_dir: str = "./ds_telemetry"
    jsonl: bool = True
    prometheus: bool = True
    trace: bool = True
    monitor: bool = False
    inference: bool = True
    flush_interval: int = 50
    histogram_max_samples: int = 512
    histogram_buckets: list = dataclasses.field(default_factory=list)
    max_trace_events: int = 100_000

    def __post_init__(self):
        _check_min(self, flush_interval=(0, True), histogram_max_samples=(0, True),
                   max_trace_events=(0, True))


@dataclasses.dataclass
class ServingConfig(DeepSpeedConfigModel):
    """The serving block (``serving/``): the request-lifecycle front-end
    over the inference engine, with the JAX package's fields, defaults and
    bounds. Admission is bounded by ``max_queue_depth`` or, at 0, by
    ``kv_budget_fraction`` of the card's memory past the weights over one
    request's KV cache (``hbm_bytes`` > 0 pins the memory); deadlines are
    checked at admission and at every tick of ``decode_tick_tokens``
    tokens, each under ``decode_tick_timeout_s`` (``startup_tick_timeout_s``
    until a tick of its key has run); ``breaker_threshold`` consecutive
    tick failures open the circuit for ``breaker_cooldown_s``; a drain
    gives the request in flight ``drain_grace_s``; ``max_program_variants``
    bounds the sampling keys the server builds decode loops for."""
    enabled: bool = True
    max_queue_depth: int = 0
    kv_budget_fraction: float = 0.6
    hbm_bytes: int = 0
    default_deadline_s: float = 30.0
    decode_tick_tokens: int = 16
    decode_tick_timeout_s: float = 10.0
    startup_tick_timeout_s: float = 300.0
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 5.0
    drain_grace_s: float = 10.0
    shed_retry_after_s: float = 1.0
    max_program_variants: int = 8

    def __post_init__(self):
        _check_min(self, max_queue_depth=(0, False), kv_budget_fraction=(0.0, True),
                   hbm_bytes=(0, False), default_deadline_s=(0.0, True),
                   decode_tick_tokens=(0, True), decode_tick_timeout_s=(0.0, True),
                   startup_tick_timeout_s=(0.0, True), breaker_threshold=(1, False),
                   breaker_cooldown_s=(0.0, True), drain_grace_s=(0.0, False),
                   shed_retry_after_s=(0.0, False), max_program_variants=(1, False))
        if self.kv_budget_fraction > 1.0:
            raise ValueError("ServingConfig.kv_budget_fraction must be <= 1.0, got "
                             f"{self.kv_budget_fraction}")


# data_types.grad_accum_dtype → the type gradients are accumulated in
GRAD_ACCUM_DTYPES = {None: torch.float32, "fp32": torch.float32, "float32": torch.float32,
                     "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                     "fp16": torch.float16, "float16": torch.float16}


class DeepSpeedConfig:
    """Parsed and validated ds_config; a dict or a path to a JSON file."""

    def __init__(self, config: Union[str, Dict[str, Any]], world_size: Optional[int] = None):
        if isinstance(config, str):
            with open(config, "r") as f:
                self._param_dict = json.load(f)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        else:
            raise ValueError(f"Expected a dict or json path, got {type(config)}")
        pd = self._param_dict
        self._validate_top_level_keys(pd)

        self.fp16 = FP16Config.from_dict(pd.get("fp16", {}))
        self.bf16 = BF16Config.from_dict(pd.get("bf16", pd.get("bfloat16", {})))
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        self.zero_config = DeepSpeedZeroConfig.from_dict(pd.get("zero_optimization", {}))
        self.aio_config = AioConfig.from_dict(pd.get("aio", {}))
        self.comms_config = CommsLoggerConfig.from_dict(pd.get("comms_logger", {}))
        self.data_types_config = DataTypesConfig.from_dict(pd.get("data_types", {}))
        if self.data_types_config.grad_accum_dtype not in GRAD_ACCUM_DTYPES:
            raise ValueError(f"data_types.grad_accum_dtype="
                             f"{self.data_types_config.grad_accum_dtype!r} not in "
                             f"{sorted(k for k in GRAD_ACCUM_DTYPES if k)}")

        self.optimizer_name = None
        self.optimizer_params = None
        opt = pd.get("optimizer")
        if opt is not None:
            self.optimizer_name = opt.get("type", "").lower()
            self.optimizer_params = opt.get("params", {})

        self.scheduler_name = None
        self.scheduler_params = None
        sched = pd.get("scheduler")
        if sched is not None:
            self.scheduler_name = sched.get("type")
            self.scheduler_params = sched.get("params", {})

        self.sparse_attention = pd.get("sparse_attention", None)
        if isinstance(self.sparse_attention, dict):
            unknown = set(self.sparse_attention) - SPARSE_ATTENTION_KEYS
            if unknown:
                raise ValueError("Unknown key(s) in the 'sparse_attention' ds_config block: "
                                 f"{format_unknown_key_hints(unknown, SPARSE_ATTENTION_KEYS)}")
        self.checkpoint_config = CheckpointConfig.from_dict(pd.get("checkpoint", {}))
        self.mesh_config = TPUMeshConfig.from_dict(pd.get("tpu", {}))
        self.checkpoint_tag_validation_enabled = \
            self.checkpoint_config.tag_validation.lower() != "ignore"
        self.checkpoint_tag_validation_fail = \
            self.checkpoint_config.tag_validation.lower() == "fail"
        self.resilience = ResilienceConfig.from_dict(pd.get("resilience", {}))
        self.pld_config = PLDConfig.from_dict(pd.get("progressive_layer_drop", {}))
        self.pld_enabled = self.pld_config.enabled
        self.data_efficiency_config = pd.get("data_efficiency", {})
        self.activation_checkpointing_config = ActivationCheckpointingConfig.from_dict(
            pd.get("activation_checkpointing", {}))
        self.hybrid_engine = HybridEngineConfig.from_dict(pd.get("hybrid_engine", {}))
        self.compression_config = pd.get("compression_training", {})
        if self.compression_config:
            from deepspeed_tpu_torch.compression.config import CompressionConfig

            CompressionConfig.from_dict(self.compression_config)      # validated here
        self.eigenvalue_config = EigenvalueConfig.from_dict(pd.get("eigenvalue", {}))
        self.eigenvalue_enabled = self.eigenvalue_config.enabled
        self.telemetry = TelemetryConfig.from_dict(pd.get("telemetry", {}))
        self.flops_profiler_config = FlopsProfilerConfig.from_dict(pd.get("flops_profiler", {}))
        self.monitor_config = MonitorConfig.from_dict(
            {k: pd[k] for k in ("tensorboard", "wandb", "csv_monitor") if k in pd})
        # presence matters, as in JAX: without the block the memory profiler
        # is never imported and no census runs
        self.profiling = ProfilingConfig.from_dict(pd.get("profiling", {}))
        self.profiling_present = "profiling" in pd
        # presence matters, as in JAX: without the block the goodput
        # package is never imported and no compile span is stamped
        self.goodput = GoodputConfig.from_dict(pd.get("goodput", {}))
        self.goodput_present = "goodput" in pd
        # presence matters, as in JAX: without the block the blackbox
        # package is never imported (no ring, no signal handler, no bundles)
        self.blackbox = BlackboxConfig.from_dict(pd.get("blackbox", {}))
        self.blackbox_present = "blackbox" in pd
        self.serving = ServingConfig.from_dict(pd.get("serving", {}))
        self.serving_present = "serving" in pd
        self.watchdog = WatchdogConfig.from_dict(pd.get("watchdog", {}))
        # presence matters, as in JAX: without the block the rewind module
        # is never imported
        self.rewind = RewindConfig.from_dict(pd.get("rewind", {}))
        self.rewind_present = "rewind" in pd
        self.elasticity_config = None
        if "elasticity" in pd:
            from deepspeed_tpu_torch.elasticity.config import ElasticityConfig

            self.elasticity_config = ElasticityConfig.from_dict(pd["elasticity"])
        self.memory_breakdown = bool(pd.get("memory_breakdown", False))
        self.dump_state = bool(pd.get("dump_state", False))
        # the advisory keys the config sets: presence, not truthiness
        self.advisory_keys_set = [k for k in (*ADVISORY_NOOP_KEYS, *ADVISORY_REFUSED_KEYS)
                                  if k in pd]
        self.dataloader_drop_last = pd.get("dataloader_drop_last", None)
        self.gradient_clipping = float(pd.get("gradient_clipping", 0.0))
        self.steps_per_print = int(pd.get("steps_per_print", 10))
        self.wall_clock_breakdown = bool(pd.get("wall_clock_breakdown", False))
        self.seed = int(pd.get("seed", 1234))
        self.train_dtype = self._resolve_train_dtype()
        self._check_advisory_values(pd)
        self._configure_train_batch_size(world_size)

    def _check_advisory_values(self, pd):
        """An advisory key of :data:`ADVISORY_REFUSED_KEYS` at a value that
        asks for what the port does not do raises ``ValueError``."""
        for key, (noop, why) in ADVISORY_REFUSED_KEYS.items():
            if key not in pd:
                continue
            value = pd[key]
            if key == "communication_data_type" and value is not None \
                    and GRAD_ACCUM_DTYPES.get(value) == self.grad_accum_dtype:
                continue
            if value != noop:
                raise ValueError(f"ds_config {key}={value!r} is not supported on CUDA: {why}")

    def advisory_reason(self, key: str) -> str:
        """Why the advisory ``key`` changes nothing in the port."""
        if key in ADVISORY_NOOP_KEYS:
            return ADVISORY_NOOP_KEYS[key]
        return ADVISORY_REFUSED_KEYS[key][1]

    def _validate_top_level_keys(self, pd):
        for key, why in REJECTED_KEYS.items():
            if key in pd:
                raise ValueError(f"ds_config key {key!r} is not supported: {why}")
        later = sorted(set(pd) & LATER_KEYS)
        if later:
            raise NotImplementedError(f"ds_config key(s) {later}: later slice of the port")
        known = SUPPORTED_KEYS | set(ADVISORY_NOOP_KEYS) | set(ADVISORY_REFUSED_KEYS)
        unknown = set(pd) - known
        if unknown:
            raise ValueError("Unknown top-level ds_config key(s): "
                             f"{format_unknown_key_hints(unknown, known | LATER_KEYS)}")
        for name, accepted in RAW_BLOCK_KEYS.items():
            head, _, tail = name.partition(".")
            block = pd.get(head)
            if tail and isinstance(block, dict):
                block = block.get(tail)
            if isinstance(block, dict) and set(block) - accepted:
                raise ValueError(f"Unknown key(s) in the {name!r} ds_config block: "
                                 f"{format_unknown_key_hints(set(block) - accepted, accepted)}")

    # --------------------------------------------------------------- batch math
    def _configure_train_batch_size(self, world_size: Optional[int]):
        """Resolve (train_batch_size, micro_batch, grad_accum); any one may be
        omitted. The same completion rules and errors as the reference's
        ``_set_batch_related_parameters``."""
        pd = self._param_dict
        train_batch = pd.get("train_batch_size")
        micro_batch = pd.get("train_micro_batch_size_per_gpu",
                             pd.get("train_micro_batch_size_per_chip"))
        grad_acc = pd.get("gradient_accumulation_steps")
        self.dp_world_size = world_size  # None until the engine sets it

        if world_size is None:
            # defer the full check; the engine re-runs it with the real world
            self.train_batch_size = train_batch
            self.train_micro_batch_size_per_gpu = micro_batch
            self.gradient_accumulation_steps = grad_acc or 1
            return

        ws = max(1, world_size)
        if train_batch is not None and micro_batch is not None and grad_acc is not None:
            if train_batch != micro_batch * grad_acc * ws:
                raise ValueError(
                    f"train_batch_size ({train_batch}) != micro_batch ({micro_batch}) * "
                    f"grad_accum ({grad_acc}) * dp_world ({ws})")
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // (micro_batch * ws)
            if grad_acc == 0 or train_batch % (micro_batch * ws) != 0:
                raise ValueError(f"train_batch_size {train_batch} not divisible by "
                                 f"micro_batch*dp ({micro_batch}*{ws})")
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // (grad_acc * ws)
            if micro_batch == 0 or train_batch % (grad_acc * ws) != 0:
                raise ValueError(f"train_batch_size {train_batch} not divisible by "
                                 f"grad_acc*dp ({grad_acc}*{ws})")
        elif train_batch is not None:
            grad_acc = 1
            micro_batch = train_batch // ws
            if micro_batch == 0 or train_batch % ws != 0:
                raise ValueError(f"train_batch_size {train_batch} not divisible by "
                                 f"dp world {ws}")
        elif micro_batch is not None:
            grad_acc = grad_acc or 1
            train_batch = micro_batch * grad_acc * ws
        else:
            raise ValueError("Either train_batch_size or train_micro_batch_size_per_gpu "
                             "must be set")

        self.train_batch_size = int(train_batch)
        self.train_micro_batch_size_per_gpu = int(micro_batch)
        self.gradient_accumulation_steps = int(grad_acc)

    def _resolve_train_dtype(self):
        if self.fp16.enabled:
            return torch.float16
        if self.bf16.enabled:
            return torch.bfloat16
        return torch.float32

    # ------------------------------------------------------------------ misc
    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.zero_enabled

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def loss_scale(self) -> float:
        return self.fp16.loss_scale if self.fp16.enabled else 0.0

    @property
    def grad_accum_dtype(self) -> torch.dtype:
        return GRAD_ACCUM_DTYPES[self.data_types_config.grad_accum_dtype]

    def print_config(self, name: str = "DeepSpeedConfig"):
        logger.info(f"{name}:")
        logger.info(json.dumps(self._param_dict, indent=2, default=str))

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._param_dict)
