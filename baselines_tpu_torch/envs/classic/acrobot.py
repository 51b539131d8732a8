"""Acrobot-v1, stepped on the device (counterpart of
baselines_tpu/envs/classic/acrobot.py:1-112): gymnasium's two-link pendulum ("book"
dynamics), torque in {-1, 0, +1}, one RK4 step of dt 0.2 a step, angles wrapped to
[-pi, pi), speeds clipped, done when the tip rises above the bar (-cos(s0) - cos(s0 +
s1) > 1), 500 steps a TimeLimit episode.

The JAX env integrates a 5-vector (the state and the torque, whose derivative is zero);
the port carries the torque beside the four state components, which is the same
arithmetic. The constants and the order of the arithmetic are the JAX env's, and every
division is by a tensor, as there. ``torch.sin``/``torch.cos`` differ from XLA's by an
ulp on some inputs, so a step agrees with the JAX env's to rounding, not bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from baselines_tpu_torch.envs.base import TimeLimit, TorchEnv
from baselines_tpu_torch.envs.spaces import Box, Discrete


@dataclass
class AcrobotState:
    s: torch.Tensor  # (N, 4) f32: theta1, theta2, dtheta1, dtheta2


def _wrap(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.remainder(x - lo, hi - lo) + lo


class Acrobot(TorchEnv):
    DT = 0.2
    L1 = 1.0
    L2 = 1.0
    M1 = 1.0
    M2 = 1.0
    LC1 = 0.5
    LC2 = 0.5
    I1 = 1.0
    I2 = 1.0
    G = 9.8
    MAX_VEL_1 = 4 * np.pi
    MAX_VEL_2 = 9 * np.pi

    def __init__(self):
        high = np.array([1.0, 1.0, 1.0, 1.0, self.MAX_VEL_1, self.MAX_VEL_2], np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Discrete(3)

    @staticmethod
    def _obs(s: torch.Tensor) -> torch.Tensor:
        t1, t2 = s[:, 0], s[:, 1]
        return torch.stack([torch.cos(t1), torch.sin(t1), torch.cos(t2), torch.sin(t2),
                            s[:, 2], s[:, 3]], dim=-1)

    def reset(self, draws, num_envs: int, device: torch.device):
        s = draws.uniform((num_envs, 4), -0.1, 0.1)
        return self._obs(s), AcrobotState(s)

    def _dsdt(self, s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        m1, m2, l1, lc1, lc2, i1, i2, g = (self.M1, self.M2, self.L1, self.LC1, self.LC2,
                                           self.I1, self.I2, self.G)
        theta1, theta2, dtheta1, dtheta2 = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
        d1 = (m1 * lc1 ** 2 + m2 * (l1 ** 2 + lc2 ** 2 + 2 * l1 * lc2 * torch.cos(theta2))
              + i1 + i2)
        d2 = m2 * (lc2 ** 2 + l1 * lc2 * torch.cos(theta2)) + i2
        phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dtheta2 ** 2 * torch.sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2)
            + phi2
        )
        ddtheta2 = (
            a + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1 ** 2 * torch.sin(theta2) - phi2
        ) / (m2 * lc2 ** 2 + i2 - d2 ** 2 / d1)
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2], dim=-1)

    def _rk4(self, y0: torch.Tensor, a: torch.Tensor, dt: float) -> torch.Tensor:
        k1 = self._dsdt(y0, a)
        k2 = self._dsdt(y0 + dt / 2 * k1, a)
        k3 = self._dsdt(y0 + dt / 2 * k2, a)
        k4 = self._dsdt(y0 + dt * k3, a)
        return y0 + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    def step(self, draws, state: AcrobotState, action: torch.Tensor):
        torque = action.to(torch.float32) - 1.0
        ns = self._rk4(state.s, torque, self.DT)
        ns = torch.stack([
            _wrap(ns[:, 0], -math.pi, math.pi),
            _wrap(ns[:, 1], -math.pi, math.pi),
            torch.clamp(ns[:, 2], -self.MAX_VEL_1, self.MAX_VEL_1),
            torch.clamp(ns[:, 3], -self.MAX_VEL_2, self.MAX_VEL_2),
        ], dim=-1)
        done = -torch.cos(ns[:, 0]) - torch.cos(ns[:, 1] + ns[:, 0]) > 1.0
        reward = torch.where(done, 0.0, -1.0)
        return self._obs(ns), AcrobotState(ns), reward, done, {}


def make_acrobot() -> TorchEnv:
    return TimeLimit(Acrobot(), 500)
