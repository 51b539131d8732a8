"""Annealing schedules (counterpart of baselines_tpu/core/schedules.py, after
baselines/common/schedules.py): ``ConstantSchedule``, ``LinearSchedule`` and
``PiecewiseSchedule`` of a step count, and the functions of the remaining fraction of
training that ppo2 anneals its learning rate and clip range with. The values are taken
in f32 on the host, the JAX package's arithmetic."""

from __future__ import annotations

import numpy as np

f32 = np.float32


class ConstantSchedule:
    """value(t) == value for every t (schedules.py:15-24)."""

    def __init__(self, value: float):
        self._v = float(value)

    def value(self, t) -> np.float32:
        return f32(self._v)

    __call__ = value


class LinearSchedule:
    """Linear from ``initial_p`` to ``final_p`` over ``schedule_timesteps``, then held
    (schedules.py:27-40). The value is taken in f32, as the JAX package takes it, so a
    threshold compared with it (the epsilon of epsilon-greedy) is the same number."""

    def __init__(self, schedule_timesteps: int, final_p: float, initial_p: float = 1.0):
        self.schedule_timesteps = float(schedule_timesteps)
        self.final_p = float(final_p)
        self.initial_p = float(initial_p)

    def value(self, t) -> np.float32:
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.clip(f32(t) / f32(self.schedule_timesteps), f32(0.0), f32(1.0))
        return f32(self.initial_p) + frac * f32(self.final_p - self.initial_p)

    __call__ = value


class PiecewiseSchedule:
    """Linear between the (t, value) ``endpoints``, sorted by t; outside them
    ``outside_value``, or the nearest endpoint's value when it is None
    (schedules.py:43-62, ``jnp.interp``'s f32 arithmetic)."""

    def __init__(self, endpoints, outside_value=None):
        ts, vs = zip(*endpoints)
        if list(ts) != sorted(ts):
            raise ValueError("endpoints must be sorted by t")
        self._ts = np.asarray(ts, f32)
        self._vs = np.asarray(vs, f32)
        self._outside_value = outside_value

    def value(self, t) -> np.float32:
        t = f32(t)
        ts, vs = self._ts, self._vs
        i = int(np.clip(np.searchsorted(ts, t, side="right"), 1, len(ts) - 1))
        dx = ts[i] - ts[i - 1]
        v = vs[i - 1] if dx == 0 else vs[i - 1] + ((t - ts[i - 1]) / dx) * (vs[i] - vs[i - 1])
        if t < ts[0] or t > ts[-1]:
            if self._outside_value is not None:
                return f32(self._outside_value)
            return vs[0] if t < ts[0] else vs[-1]
        return f32(v)

    __call__ = value


def constant_fraction_schedule(value: float):
    """lr(frac) = value * frac of the remaining fraction of training, ppo2's linear
    annealing (ppo2/ppo2.py:90-96)."""

    def f(frac):
        return f32(value) * f32(frac)

    return f


def resolve_fraction_schedule(value):
    """Accept a constant or a callable of the remaining fraction of training, as
    ppo2/ppo2.py:90-96 does."""
    if callable(value):
        return value
    v = float(value)
    return lambda frac: v
