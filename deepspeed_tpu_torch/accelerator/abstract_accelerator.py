"""Accelerator abstraction — the device-portability seam.

Counterpart of ``deepspeed_tpu/accelerator/abstract_accelerator.py``, with
every public method of the JAX seam (device enumeration and selection, RNG
seeding, memory statistics, dtype capability, the collective backend's
name, peak rates, the op builders) and what the port adds: streams and
events (the JAX package has none: XLA schedules the device itself) and the
card's memory bandwidth for roofline bounds. A method whose answer is a
fact of the card raises without one; it never reports a made-up value.
"""

from __future__ import annotations

import abc
from typing import Any, List, Optional


class DeepSpeedAccelerator(abc.ABC):
    """Device abstraction: the engines take their device from it, the
    timers their events, chip_smoke.py its memory statistics and peak
    rates."""

    # ------------------------------------------------------------------ device
    @abc.abstractmethod
    def is_available(self) -> bool: ...

    @abc.abstractmethod
    def device_name(self, device_index: Optional[int] = None) -> str: ...

    @abc.abstractmethod
    def device(self, device_index: Optional[int] = None) -> Any: ...

    @abc.abstractmethod
    def device_count(self) -> int:
        """Number of devices this process sees."""

    @abc.abstractmethod
    def global_device_count(self) -> int:
        """Number of devices across all processes."""

    @abc.abstractmethod
    def current_device(self) -> int: ...

    @abc.abstractmethod
    def set_device(self, device_index: int) -> None: ...

    @abc.abstractmethod
    def synchronize(self, device_index: Optional[int] = None) -> None:
        """Block until queued work on the device is complete."""

    # ------------------------------------------------------- streams, events
    @abc.abstractmethod
    def Stream(self, device_index: Optional[int] = None) -> Any:
        """A new stream on the device."""

    @abc.abstractmethod
    def current_stream(self, device_index: Optional[int] = None) -> Any: ...

    @abc.abstractmethod
    def stream(self, stream: Any) -> Any:
        """Context manager that makes ``stream`` current."""

    @abc.abstractmethod
    def Event(self, enable_timing: bool = False) -> Any:
        """A device event; with ``enable_timing``, two of them time the work
        queued between their ``record()`` calls."""

    # --------------------------------------------------------------------- RNG
    @abc.abstractmethod
    def manual_seed(self, seed: int) -> Any:
        """Seed the RNGs; returns the generator object where applicable."""

    @abc.abstractmethod
    def initial_seed(self) -> int: ...

    # ------------------------------------------------------------------ memory
    @abc.abstractmethod
    def memory_allocated(self, device_index: Optional[int] = None) -> int: ...

    @abc.abstractmethod
    def max_memory_allocated(self, device_index: Optional[int] = None) -> int: ...

    @abc.abstractmethod
    def reset_peak_memory_stats(self, device_index: Optional[int] = None) -> None: ...

    @abc.abstractmethod
    def total_memory(self, device_index: Optional[int] = None) -> int: ...

    @abc.abstractmethod
    def available_memory(self, device_index: Optional[int] = None) -> int: ...

    @abc.abstractmethod
    def memory_stats(self, device_index: Optional[int] = None) -> dict: ...

    # ------------------------------------------------------------------- dtype
    @abc.abstractmethod
    def is_bf16_supported(self) -> bool: ...

    @abc.abstractmethod
    def is_fp16_supported(self) -> bool: ...

    @abc.abstractmethod
    def supported_dtypes(self) -> List[Any]: ...

    @abc.abstractmethod
    def preferred_dtype(self) -> Any:
        """The training type the port prefers on this device."""

    # ------------------------------------------------------------ collectives
    @abc.abstractmethod
    def communication_backend_name(self) -> str:
        """The ``torch.distributed`` backend of this device's collectives."""

    # ----------------------------------------------------------------- perf
    @abc.abstractmethod
    def peak_flops(self, dtype: Any = None) -> float:
        """Published dense peak operations per second for ``dtype``."""

    @abc.abstractmethod
    def memory_bandwidth(self) -> float:
        """Published device-memory bandwidth in bytes per second."""

    # -------------------------------------------------------------- op builder
    @abc.abstractmethod
    def create_op_builder(self, op_name: str) -> Any:
        """The named library of ``ops/op_builder.py``, built and loaded."""

    @abc.abstractmethod
    def get_op_builder(self, op_name: str) -> Any:
        """The named library of ``ops/op_builder.py`` (None for an unknown
        name), not built."""

    # ---------------------------------------------------------------- platform
    @abc.abstractmethod
    def on_accelerator(self, tensor: Any) -> bool: ...

    @abc.abstractmethod
    def name(self) -> str: ...
