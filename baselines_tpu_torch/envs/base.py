"""The batched environment interface (counterpart of baselines_tpu/envs/base.py:39-57).

The JAX package writes one env as pure functions and vmaps them over N copies. The
port writes the batch directly: an env holds no state of its own, and every tensor of
its state has the batch as its first axis.

    obs, state = env.reset(draws, num_envs, device)
    obs, state, reward, done, info = env.step(state, action)

- ``state`` is a dataclass of tensors, each (N, ...).
- ``draws`` (core/rng.py) supplies every random number a reset takes.
- ``done`` is the combined terminated-or-truncated flag.
- Auto-reset is not done here; the vector layer does it (envs/vec.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from baselines_tpu_torch.envs.spaces import Space


class TorchEnv:
    observation_space: Space
    action_space: Space

    def reset(self, draws, num_envs: int, device: torch.device):
        raise NotImplementedError

    def step(self, state, action):
        raise NotImplementedError


@dataclass
class TimeLimitState:
    inner: Any
    t: torch.Tensor  # (N,) int32 steps taken in the episode


class TimeLimit(TorchEnv):
    """Truncate episodes at ``max_episode_steps``, reporting ``info['truncated']``
    (baselines_tpu/envs/base.py:75-94). The state becomes ``(inner, t)``."""

    def __init__(self, env: TorchEnv, max_episode_steps: int):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.max_episode_steps = int(max_episode_steps)

    def reset(self, draws, num_envs: int, device: torch.device):
        obs, inner = self.env.reset(draws, num_envs, device)
        return obs, TimeLimitState(inner, torch.zeros((num_envs,), dtype=torch.int32,
                                                      device=device))

    def step(self, state: TimeLimitState, action):
        obs, inner, reward, done, info = self.env.step(state.inner, action)
        t = state.t + 1
        truncated = (t >= self.max_episode_steps) & ~done
        info = dict(info, truncated=truncated)
        return obs, TimeLimitState(inner, t), reward, done | truncated, info
