"""CartPole, stepped on the device (counterpart of baselines_tpu/envs/classic/cartpole.py).

The classic Barto-Sutton-Anderson cart-pole as gym's CartPoleEnv implements it: Euler
integration in f32, force +-10, tau 0.02, termination at |x| > 2.4 or |theta| > 12
degrees, reward 1 a step. The constants and the order of the arithmetic are the JAX
env's. ``torch.sin`` and ``torch.cos`` differ from XLA's by an ulp on some inputs, so a
step agrees with the JAX env's to rounding, not bit for bit. ``render_frame`` draws one
env's state for video capture, the JAX env's drawing in float64 numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from baselines_tpu_torch.envs.base import TimeLimit, TorchEnv
from baselines_tpu_torch.envs.spaces import Box, Discrete


@dataclass
class CartPoleState:
    x: torch.Tensor  # (N,) f32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor


class CartPole(TorchEnv):
    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    TOTAL_MASS = MASSCART + MASSPOLE
    LENGTH = 0.5  # half the pole's length
    POLEMASS_LENGTH = MASSPOLE * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_THRESHOLD = 12 * 2 * np.pi / 360
    X_THRESHOLD = 2.4

    def __init__(self):
        high = np.array([self.X_THRESHOLD * 2, np.finfo(np.float32).max,
                         self.THETA_THRESHOLD * 2, np.finfo(np.float32).max], dtype=np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Discrete(2)
        self._total_mass = {}

    def _div_total_mass(self, x: torch.Tensor) -> torch.Tensor:
        """x / TOTAL_MASS as a true f32 division: on the card, torch turns a division by
        a Python number into a product with its reciprocal, which rounds otherwise."""
        dev = x.device
        if dev not in self._total_mass:
            self._total_mass[dev] = torch.tensor(self.TOTAL_MASS, dtype=torch.float32, device=dev)
        return x / self._total_mass[dev]

    @staticmethod
    def _obs(s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def reset(self, draws, num_envs: int, device: torch.device):
        vals = draws.uniform((num_envs, 4), -0.05, 0.05)
        state = CartPoleState(*(vals[:, i].contiguous() for i in range(4)))
        return vals, state

    def step(self, draws, state: CartPoleState, action: torch.Tensor):
        force = torch.where(action == 1, self.FORCE_MAG, -self.FORCE_MAG).to(torch.float32)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        temp = self._div_total_mass(
            force + self.POLEMASS_LENGTH * state.theta_dot ** 2 * sintheta)
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self._div_total_mass(self.MASSPOLE * costheta ** 2)))
        xacc = temp - self._div_total_mass(self.POLEMASS_LENGTH * thetaacc * costheta)
        x = state.x + self.TAU * state.x_dot
        x_dot = state.x_dot + self.TAU * xacc
        theta = state.theta + self.TAU * state.theta_dot
        theta_dot = state.theta_dot + self.TAU * thetaacc
        new_state = CartPoleState(x, x_dot, theta, theta_dot)
        done = ((x < -self.X_THRESHOLD) | (x > self.X_THRESHOLD)
                | (theta < -self.THETA_THRESHOLD) | (theta > self.THETA_THRESHOLD))
        reward = torch.ones_like(x)
        return self._obs(new_state), new_state, reward, done, {}

    def render_frame(self, state: CartPoleState, width: int = 600, height: int = 400):
        """One env's state drawn as gym's CartPoleEnv draws it, simplified
        (cartpole.py:89-111): the track, the cart and the pole on white."""
        frame = np.full((height, width, 3), 255, np.uint8)
        scale = width / (self.X_THRESHOLD * 2)
        carty = int(height * 0.8)
        cartx = int(float(state.x) * scale + width / 2.0)
        frame[carty + 20:carty + 22, :] = 0
        frame[carty:carty + 20, max(cartx - 30, 0):min(cartx + 30, width)] = (0, 0, 0)
        pole_len = int(scale * self.LENGTH * 2)
        theta = float(state.theta)
        for r in range(pole_len):
            px = int(cartx + np.sin(theta) * r)
            py = int(carty - np.cos(theta) * r)
            if 0 <= px < width - 3 and 0 <= py < height - 3:
                frame[py:py + 3, px:px + 3] = (202, 152, 101)
        return frame


def make_cartpole(version: int = 1) -> TorchEnv:
    """CartPole-v0 (200 steps) / CartPole-v1 (500 steps)."""
    return TimeLimit(CartPole(), 200 if version == 0 else 500)
