"""The NVIDIA CUDA accelerator.

Counterpart of ``deepspeed_tpu/accelerator/tpu_accelerator.py``. Peak rates
are the published dense figures of each part (NVIDIA data sheets), chosen by
``torch.cuda.get_device_name()``: an SXM and a PCIe H100 differ by a third in
memory bandwidth, so the name decides. They assume the part's full power
limit; a card set below it runs slower under load.

The facts of a card (its memory, its types, selecting it) need one: without
a card those methods raise instead of answering. The names, the counts,
the seed, the types the port computes in and the op builders answer on any
host.
"""

from __future__ import annotations

from typing import List, Optional

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
    def _card(self, what: str) -> None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what} needs a CUDA card, and this host has none")

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def name(self) -> str:
        return "cuda"

    def device_name(self, device_index: Optional[int] = None) -> str:
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def device(self, device_index: Optional[int] = None) -> torch.device:
        return torch.device(self.device_name(device_index))

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def global_device_count(self) -> int:
        """The ranks of a NCCL world (one card each, as the launcher gives
        them), else this process's cards."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
            return dist.get_world_size()
        return self.device_count()

    def current_device(self) -> int:
        return torch.cuda.current_device()

    def set_device(self, device_index: int) -> None:
        self._card("set_device")
        torch.cuda.set_device(device_index)

    def on_accelerator(self, tensor) -> bool:
        return torch.is_tensor(tensor) and tensor.is_cuda

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

    def total_memory(self, device_index: Optional[int] = None) -> int:
        self._card("total_memory")
        index = self.current_device() if device_index is None else device_index
        return torch.cuda.get_device_properties(index).total_memory

    def available_memory(self, device_index: Optional[int] = None) -> int:
        """Free bytes on the card, as `cudaMemGetInfo` reports them."""
        self._card("available_memory")
        return torch.cuda.mem_get_info(device_index)[0]

    def memory_stats(self, device_index: Optional[int] = None) -> dict:
        self._card("memory_stats")
        return torch.cuda.memory_stats(device_index)

    # ------------------------------------------------------------------- RNG
    def manual_seed(self, seed: int) -> torch.Generator:
        """Seed the host's and every card's default generator; returns the
        host's."""
        return torch.manual_seed(seed)

    def initial_seed(self) -> int:
        return torch.initial_seed()

    # ----------------------------------------------------------------- dtype
    def is_bf16_supported(self) -> bool:
        self._card("is_bf16_supported")
        return torch.cuda.is_bf16_supported()

    def is_fp16_supported(self) -> bool:
        self._card("is_fp16_supported")
        return torch.cuda.get_device_capability() >= (5, 3)

    def supported_dtypes(self) -> List[torch.dtype]:
        """The types the port computes in: its kernels' three (fp32, bf16,
        fp16; built for Hopper, which has all three) and the integer types
        of its ids."""
        return [torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.int32]

    def preferred_dtype(self) -> torch.dtype:
        return torch.bfloat16

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

    # ------------------------------------------------------------- op builder
    def get_op_builder(self, op_name: str):
        from deepspeed_tpu_torch.ops.op_builder import builders

        return builders().get(op_name)

    def create_op_builder(self, op_name: str):
        """Build (``nvcc``, or ``g++`` for the aio library) and load the
        named library; a CUDA source needs a card. None for an unknown
        name, as the JAX registry gives."""
        from deepspeed_tpu_torch.ops.op_builder import CudaKernel

        builder = self.get_op_builder(op_name)
        if builder is None:
            return None
        if isinstance(builder, CudaKernel):
            self._card(f"create_op_builder({op_name!r})")
        builder.load()
        return builder
