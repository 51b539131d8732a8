"""Annealing schedules (counterpart of baselines_tpu/core/schedules.py)."""

from __future__ import annotations

import numpy as np


class LinearSchedule:
    """Linear from ``initial_p`` to ``final_p`` over ``schedule_timesteps``, then held
    (schedules.py:27-40). The value is taken in f32, as the JAX package takes it, so a
    threshold compared with it (the epsilon of epsilon-greedy) is the same number."""

    def __init__(self, schedule_timesteps: int, final_p: float, initial_p: float = 1.0):
        self.schedule_timesteps = float(schedule_timesteps)
        self.final_p = float(final_p)
        self.initial_p = float(initial_p)

    def value(self, t) -> np.float32:
        f32 = np.float32
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.clip(f32(t) / f32(self.schedule_timesteps), f32(0.0), f32(1.0))
        return f32(self.initial_p) + frac * f32(self.final_p - self.initial_p)


def resolve_fraction_schedule(value):
    """Accept a constant or a callable of the remaining fraction of training, as
    ppo2/ppo2.py:90-96 does."""
    if callable(value):
        return value
    v = float(value)
    return lambda frac: v
