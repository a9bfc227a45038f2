from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator  # noqa: F401
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CUDA_Accelerator

_ACCELERATOR = CUDA_Accelerator()


def get_accelerator() -> DeepSpeedAccelerator:
    """The process's accelerator (the one CUDA implementation so far)."""
    return _ACCELERATOR
