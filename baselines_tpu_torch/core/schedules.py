"""Fraction-of-training schedules (counterpart of baselines_tpu/core/schedules.py:66-82)."""

from __future__ import annotations


def resolve_fraction_schedule(value):
    """Accept a constant or a callable of the remaining fraction of training, as
    ppo2/ppo2.py:90-96 does."""
    if callable(value):
        return value
    v = float(value)
    return lambda frac: v
