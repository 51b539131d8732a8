"""PointReach, a goal-conditioned reaching env stepped on the device (counterpart of
baselines_tpu/envs/goal/point_reach.py:23-74): a velocity-controlled point mass in
[-1, 1]^dim with dict observations {observation, achieved_goal, desired_goal} and the
FetchReach reward, 0 within ``distance_threshold`` of the goal, else -1, recomputable
by ``compute_reward`` for hindsight relabeling. Episodes end by the time limit only
(50 steps).

A reset draws the positions, then the goals, each uniform in [-1, 1). The distance is
the root of the summed squares, as ``jnp.linalg.norm`` takes it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from baselines_tpu_torch.envs.base import TimeLimit, TorchEnv
from baselines_tpu_torch.envs.spaces import Box, DictSpace


@dataclass
class PointReachState:
    pos: torch.Tensor  # (N, dim) f32
    goal: torch.Tensor  # (N, dim) f32


class PointReach(TorchEnv):
    def __init__(self, dim: int = 2, distance_threshold: float = 0.05, max_speed: float = 0.1):
        self.dim = dim
        self.distance_threshold = float(distance_threshold)
        self.max_speed = float(max_speed)
        sp = Box(-1.0, 1.0, (dim,))
        self.observation_space = DictSpace(
            {"observation": sp, "achieved_goal": sp, "desired_goal": sp})
        self.action_space = Box(-1.0, 1.0, (dim,))

    def compute_reward(self, achieved_goal: torch.Tensor, desired_goal: torch.Tensor):
        """The sparse reward of her/her_sampler.py:45-55's env.compute_reward."""
        d = torch.sqrt(torch.sum(torch.square(achieved_goal - desired_goal), dim=-1))
        return -(d > self.distance_threshold).to(torch.float32)

    @staticmethod
    def _obs(state: PointReachState) -> dict:
        return {"observation": state.pos, "achieved_goal": state.pos,
                "desired_goal": state.goal}

    def reset(self, draws, num_envs: int, device: torch.device):
        pos = draws.uniform((num_envs, self.dim), -1.0, 1.0)
        goal = draws.uniform((num_envs, self.dim), -1.0, 1.0)
        state = PointReachState(pos, goal)
        return self._obs(state), state

    def step(self, draws, state: PointReachState, action: torch.Tensor):
        action = torch.clamp(action, -1.0, 1.0) * self.max_speed
        pos = torch.clamp(state.pos + action, -1.0, 1.0)
        new_state = PointReachState(pos, state.goal)
        reward = self.compute_reward(pos, state.goal)
        done = torch.zeros(pos.shape[:1], dtype=torch.bool, device=pos.device)
        return self._obs(new_state), new_state, reward, done, {"is_success": reward == 0.0}


def make_point_reach(dim: int = 2) -> TorchEnv:
    return TimeLimit(PointReach(dim=dim), 50)
