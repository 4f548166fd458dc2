"""Resilience helpers of the port."""

from .retry import RetryBudgetExceeded, RetryPolicy

__all__ = ["RetryBudgetExceeded", "RetryPolicy"]
