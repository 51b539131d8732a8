"""MountainCar-v0 and MountainCarContinuous-v0, stepped on the device (counterpart of
baselines_tpu/envs/classic/mountain_car.py:1-94): gymnasium's dynamics in f32, episodes
of 200 and 999 steps under a TimeLimit.

The constants and the order of the arithmetic are the JAX env's. ``torch.cos`` differs
from XLA's by an ulp on some inputs, so a step agrees with the JAX env's to rounding, not
bit for bit; the goal test (position >= goal, moving forward) can differ only for a
state within that rounding of the goal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from baselines_tpu_torch.envs.base import TimeLimit, TorchEnv
from baselines_tpu_torch.envs.spaces import Box, Discrete


@dataclass
class CarState:
    position: torch.Tensor  # (N,) f32
    velocity: torch.Tensor


class _Car(TorchEnv):
    MIN_POS, MAX_POS = -1.2, 0.6
    MAX_SPEED = 0.07

    def __init__(self):
        low = np.array([self.MIN_POS, -self.MAX_SPEED], np.float32)
        high = np.array([self.MAX_POS, self.MAX_SPEED], np.float32)
        self.observation_space = Box(low, high)

    @staticmethod
    def _obs(s: CarState) -> torch.Tensor:
        return torch.stack([s.position, s.velocity], dim=-1)

    def reset(self, draws, num_envs: int, device: torch.device):
        pos = draws.uniform((num_envs,), -0.6, -0.4)
        state = CarState(pos, torch.zeros_like(pos))
        return self._obs(state), state

    def _move(self, state: CarState, velocity: torch.Tensor):
        """Clip the speed, move, stop at the left wall; done at the goal moving forward
        (gymnasium's goal_velocity 0)."""
        velocity = torch.clamp(velocity, -self.MAX_SPEED, self.MAX_SPEED)
        position = torch.clamp(state.position + velocity, self.MIN_POS, self.MAX_POS)
        velocity = torch.where((position == self.MIN_POS) & (velocity < 0),
                               torch.zeros_like(velocity), velocity)
        done = (position >= self.GOAL_POS) & (velocity >= 0.0)
        new_state = CarState(position, velocity)
        return self._obs(new_state), new_state, done


class MountainCar(_Car):
    GOAL_POS = 0.5
    FORCE = 0.001
    GRAVITY = 0.0025

    def __init__(self):
        super().__init__()
        self.action_space = Discrete(3)

    def step(self, draws, state: CarState, action: torch.Tensor):
        velocity = state.velocity + (action - 1).to(torch.float32) * self.FORCE + torch.cos(
            3 * state.position) * (-self.GRAVITY)
        obs, new_state, done = self._move(state, velocity)
        return obs, new_state, torch.full_like(velocity, -1.0), done, {}


class MountainCarContinuous(_Car):
    GOAL_POS = 0.45
    POWER = 0.0015

    def __init__(self):
        super().__init__()
        self.action_space = Box(-1.0, 1.0, (1,))

    def step(self, draws, state: CarState, action: torch.Tensor):
        force = torch.clamp(action.reshape(-1), -1.0, 1.0)
        velocity = state.velocity + force * self.POWER - 0.0025 * torch.cos(3 * state.position)
        obs, new_state, done = self._move(state, velocity)
        reward = torch.where(done, 100.0, 0.0) - 0.1 * force ** 2
        return obs, new_state, reward, done, {}


def make_mountain_car() -> TorchEnv:
    return TimeLimit(MountainCar(), 200)


def make_mountain_car_continuous() -> TorchEnv:
    return TimeLimit(MountainCarContinuous(), 999)
