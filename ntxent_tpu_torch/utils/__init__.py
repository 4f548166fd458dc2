"""Utilities of the port."""

from .capability import (
    card_power_line,
    device_name,
    resolve_device,
    set_fp32_precision,
)

__all__ = ["card_power_line", "device_name", "resolve_device",
           "set_fp32_precision"]
