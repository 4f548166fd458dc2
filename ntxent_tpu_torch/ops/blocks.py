"""Tile arithmetic shared by the port's kernel wrappers."""

from __future__ import annotations

__all__ = ["round_up"]


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
