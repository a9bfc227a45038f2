"""DeepSpeed JSON config → typed config objects, for the training engine.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (and so of the
reference's ``deepspeed/runtime/config.py``), on the port's dataclass base
(no pydantic on the card's machine). One ds_config drives the engine, and
the batch triple ``train_batch_size = micro_batch * grad_accum * dp_world``
is resolved and validated centrally with the reference's rules and errors.

The port reads ``fp16``, ``bf16``, ``optimizer``, ``scheduler``,
``gradient_clipping``, ``zero_optimization``, ``data_types``,
``sparse_attention``, ``steps_per_print``, ``wall_clock_breakdown``,
``seed`` and the batch keys.
Every other top-level key the JAX package knows raises
``NotImplementedError`` naming it when present, rather than being ignored;
a key neither package knows is rejected with a did-you-mean hint.
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
    "fp16", "bf16", "bfloat16", "zero_optimization", "data_types", "optimizer",
    "scheduler", "gradient_clipping", "sparse_attention", "steps_per_print",
    "wall_clock_breakdown", "seed",
    "train_batch_size", "train_micro_batch_size_per_gpu",
    "train_micro_batch_size_per_chip", "gradient_accumulation_steps",
})

# the other top-level keys the JAX package accepts (its KNOWN_TOP_LEVEL_KEYS
# and ADVISORY_NOOP_KEYS): each is a later slice of the port
LATER_KEYS = frozenset({
    "comms_logger", "flops_profiler", "activation_checkpointing", "tensorboard", "wandb",
    "csv_monitor", "pipeline", "tpu", "checkpoint", "aio", "elasticity", "hybrid_engine",
    "gradient_compression", "compression_training", "data_efficiency",
    "autotuning", "resilience", "rewind", "watchdog", "analysis", "telemetry", "profiling",
    "perf", "serving", "goodput", "overlap", "wire", "sdc", "roofline", "gray", "blackbox",
    "memory_breakdown", "dump_state", "eigenvalue", "progressive_layer_drop",
    "curriculum_learning", "dataloader_drop_last",
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
