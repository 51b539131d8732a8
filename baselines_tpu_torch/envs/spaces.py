"""Observation and action spaces (counterpart of baselines_tpu/envs/spaces.py)."""

from __future__ import annotations

import numpy as np


class Space:
    shape: tuple
    dtype: np.dtype

    def contains(self, x) -> bool:
        raise NotImplementedError


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int32)

    def contains(self, x) -> bool:
        x = int(np.asarray(x))
        return 0 <= x < self.n

    def __repr__(self):
        return f"Discrete({self.n})"

    def __eq__(self, other):
        return isinstance(other, Discrete) and other.n == self.n


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(
            np.all(x >= self.low - 1e-6) and np.all(x <= self.high + 1e-6)
        )

    def __repr__(self):
        return f"Box{self.shape}"

    def __eq__(self, other):
        return (
            isinstance(other, Box)
            and other.shape == self.shape
            and np.allclose(other.low, self.low)
            and np.allclose(other.high, self.high)
        )
