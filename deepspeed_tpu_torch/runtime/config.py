"""DeepSpeed JSON config → typed config objects, for the training engine.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (and so of the
reference's ``deepspeed/runtime/config.py``), on the port's dataclass base
(no pydantic on the card's machine). One ds_config drives the engine, and
the batch triple ``train_batch_size = micro_batch * grad_accum * dp_world``
is resolved and validated centrally with the reference's rules and errors.

The port reads ``fp16``, ``bf16``, ``optimizer``, ``scheduler``,
``gradient_clipping``, ``zero_optimization``, ``aio``, ``comms_logger``, ``data_types``,
``sparse_attention``, ``checkpoint``, ``resilience``, ``data_efficiency``,
``curriculum_learning``, ``dataloader_drop_last``, ``steps_per_print``,
``wall_clock_breakdown``, ``seed`` and the batch keys.
Every other top-level key the JAX package knows raises
``NotImplementedError`` naming it when present, rather than being ignored,
and so do the parts of a read block that belong to a later slice
(``resilience.sentinel``, an enabled ``resilience.chaos``, random-LTD's
``data_efficiency.data_routing``); a key neither package knows is rejected
with a did-you-mean hint.
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
    "curriculum_learning", "dataloader_drop_last",
    "train_batch_size", "train_micro_batch_size_per_gpu",
    "train_micro_batch_size_per_chip", "gradient_accumulation_steps",
})

# the other top-level keys the JAX package accepts (its KNOWN_TOP_LEVEL_KEYS
# and ADVISORY_NOOP_KEYS): each is a later slice of the port
LATER_KEYS = frozenset({
    "flops_profiler", "activation_checkpointing", "tensorboard", "wandb",
    "csv_monitor", "pipeline", "tpu", "elasticity", "hybrid_engine",
    "gradient_compression", "compression_training",
    "autotuning", "rewind", "watchdog", "analysis", "telemetry", "profiling",
    "perf", "serving", "goodput", "overlap", "wire", "sdc", "roofline", "gray", "blackbox",
    "memory_breakdown", "dump_state", "eigenvalue", "progressive_layer_drop",
    "sparse_gradients", "prescale_gradients", "gradient_predivide_factor",
    "disable_allgather", "graph_harvesting", "use_data_before_expert_parallel",
    "communication_data_type", "nebula", "zero_allow_untested_optimizer",
    "zero_force_ds_cpu_optimizer", "timers",
})

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
class CommsLoggerConfig(DeepSpeedConfigModel):
    """The comms_logger block: a CommsLogger records every collective's
    latency and size (``comm.configure``)."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: list = dataclasses.field(default_factory=list)


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
class ResilienceConfig(DeepSpeedConfigModel):
    """Verified checkpoints and the restore policy. ``sentinel`` and an
    enabled ``chaos`` are later slices of the port and raise."""
    verify_on_load: bool = True
    fallback_to_last_good: bool = True
    retry: ResilienceRetryConfig = dataclasses.field(default_factory=ResilienceRetryConfig)
    sentinel: Optional[dict] = None
    chaos: Optional[dict] = None

    def __post_init__(self):
        if self.sentinel is not None:
            raise NotImplementedError("ds_config resilience.sentinel (the bad-step "
                                      "sentinel): later slice of the port")
        if isinstance(self.chaos, dict) and self.chaos.get("enabled"):
            raise NotImplementedError("ds_config resilience.chaos with enabled=true (the "
                                      "fault injector): later slice of the port")


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
        self.checkpoint_tag_validation_enabled = \
            self.checkpoint_config.tag_validation.lower() != "ignore"
        self.checkpoint_tag_validation_fail = \
            self.checkpoint_config.tag_validation.lower() == "fail"
        self.resilience = ResilienceConfig.from_dict(pd.get("resilience", {}))
        self.data_efficiency_config = pd.get("data_efficiency", {})
        if isinstance(self.data_efficiency_config, dict) \
                and "data_routing" in self.data_efficiency_config:
            raise NotImplementedError("ds_config data_efficiency.data_routing (random-LTD): "
                                      "later slice of the port")
        self.dataloader_drop_last = pd.get("dataloader_drop_last", None)
        self.gradient_clipping = float(pd.get("gradient_clipping", 0.0))
        self.steps_per_print = int(pd.get("steps_per_print", 10))
        self.wall_clock_breakdown = bool(pd.get("wall_clock_breakdown", False))
        self.seed = int(pd.get("seed", 1234))
        self.train_dtype = self._resolve_train_dtype()
        self._configure_train_batch_size(world_size)

    def _validate_top_level_keys(self, pd):
        for key, why in REJECTED_KEYS.items():
            if key in pd:
                raise ValueError(f"ds_config key {key!r} is not supported: {why}")
        later = sorted(set(pd) & LATER_KEYS)
        if later:
            raise NotImplementedError(f"ds_config key(s) {later}: later slice of the port")
        unknown = set(pd) - SUPPORTED_KEYS
        if unknown:
            raise ValueError("Unknown top-level ds_config key(s): "
                             f"{format_unknown_key_hints(unknown, SUPPORTED_KEYS | LATER_KEYS)}")
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
