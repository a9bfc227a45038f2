"""The NVIDIA CUDA accelerator.

Counterpart of ``deepspeed_tpu/accelerator/tpu_accelerator.py``. Peak rates
are the published dense figures of each part (NVIDIA data sheets), chosen by
``torch.cuda.get_device_name()``: an SXM and a PCIe H100 differ by a third in
memory bandwidth, so the name decides. They assume the part's full power
limit; a card set below it runs slower under load.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator

# (name fragment, {dtype: dense FLOP/s}, bytes/s); the first fragment found in
# the device name wins, so the more specific parts come first
_PEAKS = (
    ("H100 PCIe", {torch.bfloat16: 756e12, torch.float16: 756e12, torch.float32: 51e12},
     2.0e12),
    ("H100 NVL", {torch.bfloat16: 835e12, torch.float16: 835e12, torch.float32: 60e12},
     3.9e12),
    ("H100", {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12},
     3.35e12),
    ("H200", {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12},
     4.8e12),
)


class CUDA_Accelerator(DeepSpeedAccelerator):
    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def device(self, device_index: Optional[int] = None) -> torch.device:
        return torch.device("cuda" if device_index is None else f"cuda:{device_index}")

    def current_device(self) -> int:
        return torch.cuda.current_device()

    def synchronize(self, device_index: Optional[int] = None) -> None:
        torch.cuda.synchronize(device_index)

    def Stream(self, device_index: Optional[int] = None):
        return torch.cuda.Stream(device_index)

    def current_stream(self, device_index: Optional[int] = None):
        return torch.cuda.current_stream(device_index)

    def stream(self, stream):
        return torch.cuda.stream(stream)

    def Event(self, enable_timing: bool = False):
        return torch.cuda.Event(enable_timing=enable_timing)

    def memory_allocated(self, device_index: Optional[int] = None) -> int:
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index: Optional[int] = None) -> int:
        return torch.cuda.max_memory_allocated(device_index)

    def reset_peak_memory_stats(self, device_index: Optional[int] = None) -> None:
        torch.cuda.reset_peak_memory_stats(device_index)

    def communication_backend_name(self) -> str:
        return "nccl"

    def _peaks(self):
        name = torch.cuda.get_device_name(0)
        for fragment, flops, bandwidth in _PEAKS:
            if fragment in name:
                return flops, bandwidth
        raise ValueError(f"no published peak rates recorded for {name!r}")

    def peak_flops(self, dtype=torch.bfloat16) -> float:
        return self._peaks()[0][dtype]

    def memory_bandwidth(self) -> float:
        return self._peaks()[1]
