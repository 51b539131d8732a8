"""Observation and action spaces (counterpart of baselines_tpu/envs/spaces.py):
``Discrete``, ``Box``, ``MultiDiscrete``, ``MultiBinary`` and the goal envs'
``DictSpace``.

``sample(draws)`` draws one random element from a ``core.rng.Draws`` where the JAX
package's ``sample(key)`` takes a key, and returns a tensor on the draws' device, int32
for the discrete spaces and the Box's own dtype for a Box. Where the JAX package maps
uniforms to values (a bounded Box, MultiDiscrete, MultiBinary), the port maps them the
same way, so the same uniforms give the same sample; Discrete draws its integer and an
unbounded Box its normals directly."""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """``x`` as a numpy array; a tensor is read back from its device, as ``np.asarray``
    reads a JAX array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Space:
    shape: tuple
    dtype: np.dtype

    def sample(self, draws):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int32)

    def sample(self, draws) -> torch.Tensor:
        """An int32 scalar uniform in [0, n)."""
        return draws.randint(0, self.n, ())

    def contains(self, x) -> bool:
        x = int(_host(x))
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

    @property
    def bounded(self) -> bool:
        return bool(np.all(np.isfinite(self.low)) and np.all(np.isfinite(self.high)))

    def sample(self, draws) -> torch.Tensor:
        """Uniform in [low, high] where both are finite, as ``low + u * (high - low)``
        in f32 (at least ``low``), else standard normal; in the Box's dtype."""
        dtype = torch_dtype(self.dtype)
        if not self.bounded:
            return draws.normal(self.shape).to(dtype)
        u = draws.uniform(self.shape, 0.0, 1.0)
        low, high = (torch.as_tensor(b, dtype=torch.float32, device=u.device)
                     for b in (self.low, self.high))
        return torch.maximum(low, u * (high - low) + low).to(dtype)

    def contains(self, x) -> bool:
        x = _host(x)
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

    def sample(self, draws) -> torch.Tensor:
        """``floor(u * nvec)`` of f32 uniforms u, int32."""
        u = draws.uniform(self.shape, 0.0, 1.0)
        nvec = torch.as_tensor(self.nvec, dtype=torch.float32, device=u.device)
        return torch.floor(u * nvec).to(torch.int32)

    def contains(self, x) -> bool:
        x = _host(x)
        return x.shape == self.shape and bool(np.all(x >= 0) and np.all(x < self.nvec))

    def __repr__(self):
        return f"MultiDiscrete({self.nvec.tolist()})"


class MultiBinary(Space):
    """``n`` independent bits (spaces.py:230-244)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = (self.n,)
        self.dtype = np.dtype(np.int32)

    def sample(self, draws) -> torch.Tensor:
        """``n`` fair bits, ``u < 0.5`` of f32 uniforms u, int32."""
        return (draws.uniform((self.n,), 0.0, 1.0) < 0.5).to(torch.int32)

    def contains(self, x) -> bool:
        x = _host(x)
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

    def sample(self, draws) -> dict:
        """A sample of each sub-space, drawn in sorted key order, in a dict of that
        order."""
        return {k: s.sample(draws) for k, s in sorted(self.spaces.items())}

    def contains(self, x) -> bool:
        return all(k in x and s.contains(x[k]) for k, s in self.spaces.items())

    def __getitem__(self, k):
        return self.spaces[k]

    def __repr__(self):
        return f"DictSpace({list(self.spaces)})"


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a space's numpy dtype."""
    return torch.from_numpy(np.zeros(0, dtype)).dtype
