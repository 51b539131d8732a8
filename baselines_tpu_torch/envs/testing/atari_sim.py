"""AtariSim: a synthetic env with the tensor shapes of the DeepMind Atari pipeline
(84x84x4 u8 frames), stepped on the device (counterpart of
baselines_tpu/envs/testing/atari_sim.py).

``step`` is deterministic given the state, and its obs, reward and done equal the JAX
env's bit for bit from the same state. ``reset`` draws the sprite's position and
velocity from ``draws``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.spaces import Box, Discrete


@dataclass
class AtariSimState:
    x: torch.Tensor  # sprite position (N, 2) int32
    v: torch.Tensor  # sprite velocity (N, 2) int32
    t: torch.Tensor  # (N,) int32


class AtariSim(TorchEnv):
    SIZE = 84
    CHANNELS = 4

    def __init__(self, n_actions: int = 6, episode_len: int = 1000):
        self.observation_space = Box(0, 255, (self.SIZE, self.SIZE, self.CHANNELS), np.uint8)
        self.action_space = Discrete(n_actions)
        self.episode_len = episode_len
        self.n_actions = n_actions

    def _obs(self, state: AtariSimState) -> torch.Tensor:
        ramp = torch.arange(self.SIZE, dtype=torch.int32, device=state.t.device)
        rows, cols = ramp.view(1, -1, 1), ramp.view(1, 1, -1)
        sprite = ((rows - state.x[:, 0, None, None]).abs() < 4) & (
            (cols - state.x[:, 1, None, None]).abs() < 4
        )
        background = ((rows * 7 + cols * 13 + state.t[:, None, None]) % 29).to(torch.uint8)
        frame = torch.maximum(sprite.to(torch.uint8) * 255, background)
        return frame[..., None].expand(-1, -1, -1, self.CHANNELS)

    def reset(self, draws, num_envs: int, device: torch.device):
        x = draws.randint(10, self.SIZE - 10, (num_envs, 2))
        v = draws.randint(-2, 3, (num_envs, 2))
        state = AtariSimState(x, v, torch.zeros((num_envs,), dtype=torch.int32, device=device))
        return self._obs(state), state

    def step(self, state: AtariSimState, action: torch.Tensor):
        x = state.x + state.v
        bounce = (x < 4) | (x >= self.SIZE - 4)
        v = torch.where(bounce, -state.v, state.v)
        x = torch.clamp(x, 4, self.SIZE - 5)
        t = state.t + 1
        # reward: +1 when the action parity matches the sprite quadrant
        half = self.SIZE // 2
        quadrant = (x[:, 0] >= half).to(torch.int32) * 2 + (x[:, 1] >= half).to(torch.int32)
        reward = (action % 4 == quadrant).to(torch.float32)
        done = t >= self.episode_len
        new_state = AtariSimState(x, v, t)
        return self._obs(new_state), new_state, reward, done, {}
