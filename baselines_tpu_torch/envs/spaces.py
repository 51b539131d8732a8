"""Observation and action spaces (counterpart of baselines_tpu/envs/spaces.py):
``Discrete``, ``Box``, ``MultiDiscrete``, ``MultiBinary`` and the goal envs'
``DictSpace``."""

from __future__ import annotations

import numpy as np
import torch


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


class MultiDiscrete(Space):
    """Independent discrete values, ``nvec[i]`` choices each (spaces.py:212-227)."""

    def __init__(self, nvec):
        self.nvec = np.asarray(nvec, np.int32)
        self.shape = self.nvec.shape
        self.dtype = np.dtype(np.int32)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all(x >= 0) and np.all(x < self.nvec))

    def __repr__(self):
        return f"MultiDiscrete({self.nvec.tolist()})"


class MultiBinary(Space):
    """``n`` independent bits (spaces.py:230-244)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = (self.n,)
        self.dtype = np.dtype(np.int32)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == (self.n,) and bool(np.all((x == 0) | (x == 1)))

    def __repr__(self):
        return f"MultiBinary({self.n})"


class DictSpace(Space):
    """Named sub-spaces, the goal envs' {observation, achieved_goal, desired_goal}
    contract (spaces.py:120-140, gym.GoalEnv); an observation is a dict of tensors."""

    def __init__(self, spaces: dict):
        self.spaces = dict(spaces)
        self.shape = None
        self.dtype = None

    def contains(self, x) -> bool:
        return all(k in x and s.contains(x[k]) for k, s in self.spaces.items())

    def __getitem__(self, k):
        return self.spaces[k]

    def __repr__(self):
        return f"DictSpace({list(self.spaces)})"


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a space's numpy dtype."""
    return torch.from_numpy(np.zeros(0, dtype)).dtype
