"""Utilities of the port."""

from .capability import (
    card_power_line,
    check_tensor_core_support,
    device_name,
    resolve_device,
    set_fp32_precision,
)
from .logging_utils import setup_logging
from .memory import DeviceMemoryTracker, device_memory_mb
from .watchdog import StallWatchdog

__all__ = ["DeviceMemoryTracker", "StallWatchdog", "card_power_line",
           "check_tensor_core_support", "device_memory_mb", "device_name",
           "resolve_device", "set_fp32_precision", "setup_logging"]
