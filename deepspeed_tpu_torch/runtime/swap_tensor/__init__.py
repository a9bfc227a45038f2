"""NVMe tensor swapping for ZeRO-Infinity: see ``partition_swapper`` and
``optimizer_swapper``."""

from deepspeed_tpu_torch.runtime.swap_tensor.partition_swapper import (  # noqa: F401
    AsyncTensorSwapper, SwapBuffer)
