"""Accelerator abstraction — the device-portability seam.

Counterpart of ``deepspeed_tpu/accelerator/abstract_accelerator.py``, cut to
what the port uses: the device, synchronisation, peak-memory statistics,
and the card's peak rates for roofline bounds.
"""

from __future__ import annotations

import abc
from typing import Any, Optional


class DeepSpeedAccelerator(abc.ABC):
    """Device abstraction: the engine takes its device from it, chip_smoke.py
    its memory statistics and peak rates."""

    @abc.abstractmethod
    def is_available(self) -> bool: ...

    @abc.abstractmethod
    def device(self, device_index: Optional[int] = None) -> Any: ...

    @abc.abstractmethod
    def synchronize(self, device_index: Optional[int] = None) -> None:
        """Block until queued work on the device is complete."""

    @abc.abstractmethod
    def max_memory_allocated(self, device_index: Optional[int] = None) -> int: ...

    @abc.abstractmethod
    def reset_peak_memory_stats(self, device_index: Optional[int] = None) -> None: ...

    @abc.abstractmethod
    def peak_flops(self, dtype: Any = None) -> float:
        """Published dense peak operations per second for ``dtype``."""

    @abc.abstractmethod
    def memory_bandwidth(self) -> float:
        """Published device-memory bandwidth in bytes per second."""
