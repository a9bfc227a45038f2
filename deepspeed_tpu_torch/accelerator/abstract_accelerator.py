"""Accelerator abstraction — the device-portability seam.

Counterpart of ``deepspeed_tpu/accelerator/abstract_accelerator.py``, cut to
what the port uses: the device, streams and events (the JAX package has
none: XLA schedules the device itself), synchronisation, memory
statistics, and the card's peak rates for roofline bounds.
"""

from __future__ import annotations

import abc
from typing import Any, Optional


class DeepSpeedAccelerator(abc.ABC):
    """Device abstraction: the engines take their device from it, the
    timers their events, chip_smoke.py its memory statistics and peak
    rates."""

    # ------------------------------------------------------------------ device
    @abc.abstractmethod
    def is_available(self) -> bool: ...

    @abc.abstractmethod
    def device(self, device_index: Optional[int] = None) -> Any: ...

    @abc.abstractmethod
    def current_device(self) -> int: ...

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

    # ------------------------------------------------------------------ memory
    @abc.abstractmethod
    def memory_allocated(self, device_index: Optional[int] = None) -> int: ...

    @abc.abstractmethod
    def max_memory_allocated(self, device_index: Optional[int] = None) -> int: ...

    @abc.abstractmethod
    def reset_peak_memory_stats(self, device_index: Optional[int] = None) -> None: ...

    # ----------------------------------------------------------------- perf
    @abc.abstractmethod
    def peak_flops(self, dtype: Any = None) -> float:
        """Published dense peak operations per second for ``dtype``."""

    @abc.abstractmethod
    def memory_bandwidth(self) -> float:
        """Published device-memory bandwidth in bytes per second."""
