"""A deterministic obs-sequence env for the wrapper tests (counterpart of
baselines_tpu/envs/testing/simple.py): obs[t] = arange(obs_dim) + offset + 100 t,
reward t, episodes of a fixed length. It draws nothing and is not registered."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.spaces import Box


@dataclass
class SimpleState:
    t: torch.Tensor  # (N,) int32


class SimpleDeterministicEnv(TorchEnv):
    def __init__(self, offset: float = 0.0, episode_len: int = 10, obs_dim: int = 3):
        self.offset = float(offset)
        self.episode_len = int(episode_len)
        self.obs_dim = int(obs_dim)
        self.observation_space = Box(-1e9, 1e9, (obs_dim,))
        self.action_space = Box(-1.0, 1.0, (obs_dim,))

    def _obs(self, t: torch.Tensor) -> torch.Tensor:
        base = torch.arange(self.obs_dim, dtype=torch.float32, device=t.device)
        return base + self.offset + t.to(torch.float32)[:, None] * 100.0

    def reset(self, draws, num_envs: int, device: torch.device):
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return self._obs(t), SimpleState(t)

    def step(self, draws, state: SimpleState, action):
        t = state.t + 1
        done = t >= self.episode_len
        return self._obs(t), SimpleState(t), state.t.to(torch.float32), done, {}
