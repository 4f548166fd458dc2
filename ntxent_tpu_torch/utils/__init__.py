"""Utilities of the port."""

from .capability import (
    card_power_line,
    check_tensor_core_support,
    device_name,
    resolve_device,
    set_fp32_precision,
)
from .watchdog import StallWatchdog

__all__ = ["StallWatchdog", "card_power_line", "check_tensor_core_support",
           "device_name", "resolve_device", "set_fp32_precision"]
