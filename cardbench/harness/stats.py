"""Metric arithmetic shared by the readers in ``metrics/``."""
from __future__ import annotations

def rate(count: float, seconds: float) -> float:
    """Work over the whole window: every unit done in it over all its time."""
    return count / seconds
