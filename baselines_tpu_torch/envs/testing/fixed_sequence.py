"""FixedSequence fixture envs, stepped on the device (counterpart of
baselines_tpu/envs/testing/fixed_sequence.py, after the reference's
common/tests/envs/fixed_sequence_env.py:6-41): memorize a fixed action sequence from a
constant observation, so only a recurrent policy can solve it.

The sequence comes from ``np.random.RandomState(seed)``, as in the JAX env, and the
image variant's frame from ``RandomState(seed + 1)``; neither env draws anything at run
time. Obs, state, reward and done equal the JAX env's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.spaces import Box, Discrete


@dataclass
class FixedSequenceState:
    t: torch.Tensor  # (N,) int32


class FixedSequenceEnv(TorchEnv):
    def __init__(self, n_actions: int = 10, episode_len: int = 100, seed: int = 0):
        self.n_actions = int(n_actions)
        self.episode_len = int(episode_len)
        rng = np.random.RandomState(seed)
        self.sequence = rng.randint(0, n_actions, size=episode_len).astype(np.int32)
        self.observation_space = Discrete(1)
        self.action_space = Discrete(n_actions)
        self._on_device = {}

    def _constant(self, name: str, value: np.ndarray, device) -> torch.Tensor:
        """``value`` as a tensor on ``device``, made once."""
        key = (name, torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(value, device=device)
        return self._on_device[key]

    def _obs(self, num_envs: int, device) -> torch.Tensor:
        return torch.zeros((num_envs,), dtype=torch.int32, device=device)

    def reset(self, draws, num_envs: int, device: torch.device):
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return self._obs(num_envs, device), FixedSequenceState(t)

    def step(self, draws, state: FixedSequenceState, action):
        sequence = self._constant("sequence", self.sequence, state.t.device)
        reward = (action == sequence[state.t.long()]).to(torch.float32)
        t = state.t + 1
        done = t >= self.episode_len
        return (self._obs(t.shape[0], t.device), FixedSequenceState(t), reward, done, {})


class ImageFixedSequenceEnv(FixedSequenceEnv):
    """FixedSequence with a constant u8 (size, size, 1) frame for the observation."""

    def __init__(self, n_actions: int = 4, episode_len: int = 4, size: int = 36,
                 seed: int = 0):
        super().__init__(n_actions, episode_len, seed)
        rng = np.random.RandomState(seed + 1)
        self.frame = rng.randint(0, 256, size=(size, size, 1)).astype(np.uint8)
        self.observation_space = Box(0, 255, (size, size, 1), np.uint8)

    def _obs(self, num_envs: int, device) -> torch.Tensor:
        frame = self._constant("frame", self.frame, device)
        return frame.expand((num_envs,) + frame.shape).contiguous()
