"""Identity fixture envs, stepped on the device (counterpart of
baselines_tpu/envs/testing/identity.py:1-126, after the reference's
common/tests/envs/identity_env.py): the observation is the correct action, so any
learner that can learn at all solves them in a few thousand steps.

Every step draws a new target from ``draws``, as the JAX env draws one from its step
key, and a reset draws the first. Given the same draws, obs, state, reward and done
equal the JAX env's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete


@dataclass
class IdentityState:
    target: torch.Tensor  # (N, ...)
    t: torch.Tensor  # (N,) int32


class _IdentityBase(TorchEnv):
    def __init__(self, episode_len: int = 100):
        self.episode_len = int(episode_len)

    def _sample_target(self, draws, num_envs: int):
        raise NotImplementedError

    def _reward(self, target, action):
        raise NotImplementedError

    def _obs(self, target):
        return target

    def reset(self, draws, num_envs: int, device: torch.device):
        target = self._sample_target(draws, num_envs)
        t = torch.zeros((num_envs,), dtype=torch.int32, device=target.device)
        return self._obs(target), IdentityState(target, t)

    def step(self, draws, state: IdentityState, action):
        reward = self._reward(state.target, action)
        new_target = self._sample_target(draws, state.t.shape[0])
        t = state.t + 1
        done = t >= self.episode_len
        return self._obs(new_target), IdentityState(new_target, t), reward, done, {}


class DiscreteIdentityEnv(_IdentityBase):
    """obs in {0..dim-1}; reward 1 where action == obs."""

    def __init__(self, dim: int, episode_len: int = 100):
        super().__init__(episode_len)
        self.dim = int(dim)
        self.observation_space = Discrete(dim)
        self.action_space = Discrete(dim)

    def _sample_target(self, draws, num_envs):
        return draws.randint(0, self.dim, (num_envs,))

    def _reward(self, target, action):
        return (action == target).to(torch.float32)


class MultiDiscreteIdentityEnv(_IdentityBase):
    """obs in MultiDiscrete(dims), drawn as floor(u * dims) from uniforms; reward 1
    where every component of the action matches."""

    def __init__(self, dims, episode_len: int = 100):
        super().__init__(episode_len)
        self.dims = np.asarray(dims, np.int32)
        self.observation_space = MultiDiscrete(self.dims)
        self.action_space = MultiDiscrete(self.dims)

    def _sample_target(self, draws, num_envs):
        u = draws.uniform((num_envs,) + self.dims.shape, 0.0, 1.0)
        return torch.floor(u * torch.as_tensor(self.dims, device=u.device)).to(torch.int32)

    def _reward(self, target, action):
        return torch.all(action == target, dim=-1).to(torch.float32)


class ImageIdentityEnv(_IdentityBase):
    """Discrete identity with image observations: the target class is a bright
    vertical stripe in a (size, size, 1) f32 frame."""

    def __init__(self, dim: int = 4, size: int = 24, episode_len: int = 100):
        super().__init__(episode_len)
        self.dim = int(dim)
        self.size = int(size)
        self.observation_space = Box(0.0, 1.0, (size, size, 1))
        self.action_space = Discrete(dim)

    def _sample_target(self, draws, num_envs):
        return draws.randint(0, self.dim, (num_envs,))

    def _reward(self, target, action):
        return (action == target).to(torch.float32)

    def _obs(self, target):
        stripe = self.size // self.dim
        cols = torch.arange(self.size, device=target.device)
        t = target[:, None]
        on = (cols >= t * stripe) & (cols < (t + 1) * stripe)  # (N, size)
        frame = on.to(torch.float32)[:, None, :].expand(-1, self.size, -1)
        return frame[..., None].contiguous()


class BoxIdentityEnv(_IdentityBase):
    """obs in [-1, 1]^shape; reward -||action - obs||^2."""

    def __init__(self, shape=(1,), episode_len: int = 100):
        super().__init__(episode_len)
        self.observation_space = Box(-1.0, 1.0, shape)
        self.action_space = Box(-1.0, 1.0, shape)

    def _sample_target(self, draws, num_envs):
        return draws.uniform((num_envs,) + self.observation_space.shape, -1.0, 1.0)

    def _reward(self, target, action):
        dims = tuple(range(1, target.dim()))
        return -torch.sum(torch.square(action - target), dim=dims)
