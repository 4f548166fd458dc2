"""Resilience helpers of the port."""

from .retry import RetryPolicy

__all__ = ["RetryPolicy"]
