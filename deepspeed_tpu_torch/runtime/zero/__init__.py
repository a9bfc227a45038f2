"""ZeRO: the configuration, the partition plan, the engine's per-unit state,
construction in place (``Init``), tiling and offload."""

from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig  # noqa: F401
from deepspeed_tpu_torch.runtime.zero.init import Init, materialize  # noqa: F401
from deepspeed_tpu_torch.runtime.zero.partition import (partition_report,  # noqa: F401
                                                        plan_partition)
from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear, tiled_matmul  # noqa: F401

__all__ = ["DeepSpeedZeroConfig", "Init", "materialize", "plan_partition", "partition_report",
           "TiledLinear", "tiled_matmul"]
