from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator  # noqa: F401
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CUDA_Accelerator

_ACCELERATOR = CUDA_Accelerator()


def get_accelerator() -> DeepSpeedAccelerator:
    """The process's accelerator (the one CUDA implementation so far)."""
    return _ACCELERATOR


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller asks for
    something else; never a silent CPU."""
    import torch

    accel = get_accelerator()
    if device is None:
        if not accel.is_available():
            raise RuntimeError("no CUDA device: the port runs on CUDA, and on the CPU "
                               "only when asked with device='cpu'")
        return accel.device(accel.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not accel.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
