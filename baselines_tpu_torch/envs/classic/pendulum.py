"""Pendulum-v1 swing-up, stepped on the device (counterpart of
baselines_tpu/envs/classic/pendulum.py:14-68): gymnasium's PendulumEnv dynamics in f32,
torque clipped to +-2, speed to +-8, dt 0.05, cost angle^2 + 0.1 speed^2 + 0.001
torque^2, no termination, 200 steps a TimeLimit episode.

The constants and the order of the arithmetic are the JAX env's. ``_angle_normalize``
is a floor-mod, which ``torch.remainder`` computes as XLA does (fmod, then the divisor
added where the signs differ). ``torch.sin`` and ``torch.cos`` differ from XLA's by an
ulp on some inputs, so a step agrees with the JAX env's to rounding, not bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from baselines_tpu_torch.envs.base import TimeLimit, TorchEnv
from baselines_tpu_torch.envs.spaces import Box


@dataclass
class PendulumState:
    theta: torch.Tensor  # (N,) f32
    theta_dot: torch.Tensor


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class Pendulum(TorchEnv):
    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    def __init__(self):
        high = np.array([1.0, 1.0, self.MAX_SPEED], dtype=np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Box(-self.MAX_TORQUE, self.MAX_TORQUE, (1,))

    @staticmethod
    def _obs(s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)

    def reset(self, draws, num_envs: int, device: torch.device):
        theta = draws.uniform((num_envs,), -math.pi, math.pi)
        theta_dot = draws.uniform((num_envs,), -1.0, 1.0)
        state = PendulumState(theta, theta_dot)
        return self._obs(state), state

    def step(self, draws, state: PendulumState, action: torch.Tensor):
        u = torch.clamp(action.reshape(-1), -self.MAX_TORQUE, self.MAX_TORQUE)
        th, thdot = state.theta, state.theta_dot
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        newthdot = thdot + (
            3 * self.G / (2 * self.L) * torch.sin(th) + 3.0 / (self.M * self.L ** 2) * u
        ) * self.DT
        newthdot = torch.clamp(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * self.DT
        new_state = PendulumState(newth, newthdot)
        done = torch.zeros(th.shape, dtype=torch.bool, device=th.device)
        return self._obs(new_state), new_state, -cost, done, {}


def make_pendulum() -> TorchEnv:
    return TimeLimit(Pendulum(), 200)
