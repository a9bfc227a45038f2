"""ZeRO configuration (ds_config "zero_optimization" block).

Counterpart of ``deepspeed_tpu/runtime/zero/config.py`` (and so key-
compatible with the reference's ``deepspeed/runtime/zero/config.py``), on
the port's dataclass base: the same keys, aliases and bounds, unknown keys
rejected.

Stages 0–3 take effect (``partition.py`` places the state, the engine's
``runtime/zero/state.py`` runs the collectives), and stage 3 reads
``stage3_param_persistence_threshold``. The bucket, prefetch and live-
parameter keys parse and bound nothing yet: the engine issues one
collective per unit (a module's parameters, flat). ``offload_optimizer``
and ``offload_param`` take ``cpu`` and ``nvme`` (``runtime/zero/offload.py``,
``runtime/swap_tensor/``, ``runtime/zero/infinity.py``); the deprecated
``cpu_offload`` and ``cpu_offload_param`` become those blocks, and
``cpu_offload_use_pin_memory`` only warns, as in the JAX package. MiCS and
the quantized-ZeRO keys raise ``NotImplementedError`` (later slices).
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.utils.logging import logger

OFFLOAD_DEVICES = ("none", "cpu", "nvme")


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: later slice of the port")


def _check_min(block, **bounds):
    for name, lo in bounds.items():
        if getattr(block, name) < lo:
            raise ValueError(f"{type(block).__name__}.{name} must be >= {lo}, "
                             f"got {getattr(block, name)}")


@dataclasses.dataclass
class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False

    def __post_init__(self):
        if self.device not in OFFLOAD_DEVICES:
            raise ValueError(f"offload_param.device {self.device!r} not in {OFFLOAD_DEVICES}")
        _check_min(self, buffer_count=0, buffer_size=0, max_in_cpu=0)


@dataclasses.dataclass
class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0
    stream_overlap: Optional[bool] = None

    def __post_init__(self):
        if self.device not in OFFLOAD_DEVICES:
            raise ValueError(f"offload_optimizer.device {self.device!r} not in "
                             f"{OFFLOAD_DEVICES}")
        _check_min(self, buffer_count=0, ratio=0.0)
        if self.ratio > 1.0:
            raise ValueError(f"offload_optimizer.ratio must be <= 1, got {self.ratio}")


@dataclasses.dataclass
class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False

    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = field(
        default=None, metadata={"block": DeepSpeedZeroOffloadParamConfig})
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = field(
        default=None, metadata={"block": DeepSpeedZeroOffloadOptimizerConfig})

    sub_group_size: int = 1_000_000_000
    # deprecated spellings of the offload blocks
    cpu_offload_param: Optional[bool] = None
    cpu_offload_use_pin_memory: Optional[bool] = None
    cpu_offload: Optional[bool] = None

    prefetch_bucket_size: int = field(default=50_000_000,
                                      metadata={"alias": "stage3_prefetch_bucket_size"})
    param_persistence_threshold: int = field(
        default=100_000, metadata={"alias": "stage3_param_persistence_threshold"})
    model_persistence_threshold: int = field(
        default=2**63 - 1, metadata={"alias": "stage3_model_persistence_threshold"})
    max_live_parameters: int = field(default=1_000_000_000,
                                     metadata={"alias": "stage3_max_live_parameters"})
    max_reuse_distance: int = field(default=1_000_000_000,
                                    metadata={"alias": "stage3_max_reuse_distance"})
    gather_16bit_weights_on_model_save: bool = field(
        default=False, metadata={"alias": "stage3_gather_16bit_weights_on_model_save"})

    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    memory_efficient_linear: bool = True
    shard_axes: Optional[list] = None
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    # the reference's ZeRO++ switches
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = 1

    def __post_init__(self):
        self.stage = int(self.stage)
        if not 0 <= self.stage <= 3:
            raise ValueError(f"zero_optimization.stage must be 0..3, got {self.stage}")
        _check_min(self, reduce_bucket_size=0, allgather_bucket_size=0, sub_group_size=0,
                   prefetch_bucket_size=0, param_persistence_threshold=0,
                   model_persistence_threshold=0, max_live_parameters=0,
                   max_reuse_distance=0, mics_shard_size=-1)
        # the deprecated spellings, as the JAX package maps them
        for old, new, block in (
                ("cpu_offload", "offload_optimizer", DeepSpeedZeroOffloadOptimizerConfig),
                ("cpu_offload_param", "offload_param", DeepSpeedZeroOffloadParamConfig),
                ("cpu_offload_use_pin_memory", None, None)):
            value = getattr(self, old)
            if value is None:
                continue
            logger.warning(f"Config parameter {old} is deprecated. "
                           + (f"Use {new} instead." if new else ""))
            if new is None:
                continue
            if getattr(self, new) is not None:
                raise ValueError(f"Cannot provide deprecated parameter '{old}' and its "
                                 f"replacement '{new}' together")
            setattr(self, new, block(device="cpu") if value else None)
        if self.zero_quantized_weights or self.zero_quantized_gradients \
                or self.zero_hpz_partition_size > 1:
            raise _later("quantized ZeRO (zero_quantized_* / zero_hpz_partition_size)")
        if self.mics_shard_size > 0:
            raise _later("MiCS sharding (mics_shard_size)")

    @property
    def zero_enabled(self) -> bool:
        return self.stage > 0
