"""ZeRO configuration (ds_config "zero_optimization" block).

Counterpart of ``deepspeed_tpu/runtime/zero/config.py`` (and so key-
compatible with the reference's ``deepspeed/runtime/zero/config.py``), on
the port's dataclass base: the same keys, aliases and bounds, unknown keys
rejected.

On a world of one process every ZeRO placement is whole, as on a
one-device JAX mesh, so stages 0–3 are accepted there and change nothing.
What needs more than this slice raises ``NotImplementedError``: a stage
above 0 across more than one process (checked by the engine, which knows
the world), host or NVMe offload, and the quantized-ZeRO keys.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

OFFLOAD_DEVICES = ("none", "cpu", "nvme")


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: later slice of the port (comm and offload)")


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
        if self.device != "none":
            raise _later(f"offload_param to {self.device}")


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
        if self.device != "none":
            raise _later(f"offload_optimizer to {self.device}")


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
        if self.cpu_offload:
            raise _later("offload_optimizer to cpu (cpu_offload)")
        if self.cpu_offload_param:
            raise _later("offload_param to cpu (cpu_offload_param)")
        if self.zero_quantized_weights or self.zero_quantized_gradients \
                or self.zero_hpz_partition_size > 1:
            raise _later("quantized ZeRO (zero_quantized_* / zero_hpz_partition_size)")
        if self.mics_shard_size > 0:
            raise _later("MiCS sharding (mics_shard_size)")

    @property
    def zero_enabled(self) -> bool:
        return self.stage > 0
