"""The batched environment interface (counterpart of baselines_tpu/envs/base.py).

The JAX package writes one env as pure functions and vmaps them over N copies. The
port writes the batch directly: an env holds no state of its own, and every tensor of
its state has the batch as its first axis.

    obs, state = env.reset(draws, num_envs, device)
    obs, state, reward, done, info = env.step(draws, state, action)

- ``state`` is a dataclass of tensors, each (N, ...).
- ``draws`` (core/rng.py) supplies every random number a reset or a step takes. An env
  with no randomness in its step (CartPole, AtariSim, the classic envs) draws nothing
  there; the identity envs draw their next target.
- ``done`` is the combined terminated-or-truncated flag.
- Auto-reset is not done here; the vector layer does it (envs/vec.py).

Wrappers: ``TimeLimit`` (base.py:75-94), ``ClipActions`` (:97-105), ``RewardScale``
(:108-118) and ``ClipReward`` (:121-127).
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

    def step(self, draws, state, action):
        raise NotImplementedError

    @property
    def unwrapped(self) -> "TorchEnv":
        return self

    def render_frame(self, state):
        """An HWC u8 image of one env's state (each field a scalar), for video capture;
        an env that renders overrides it (base.py:53-55)."""
        raise NotImplementedError(f"{type(self).__name__} does not support rendering")


class EnvWrapper(TorchEnv):
    """Forwards reset and step to the env it wraps (base.py:58-72)."""

    def __init__(self, env: TorchEnv):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, draws, num_envs: int, device: torch.device):
        return self.env.reset(draws, num_envs, device)

    def step(self, draws, state, action):
        return self.env.step(draws, state, action)

    @property
    def unwrapped(self) -> TorchEnv:
        return self.env.unwrapped


@dataclass
class TimeLimitState:
    inner: Any
    t: torch.Tensor  # (N,) int32 steps taken in the episode


class TimeLimit(EnvWrapper):
    """Truncate episodes at ``max_episode_steps``, reporting ``info['truncated']``
    (baselines_tpu/envs/base.py:75-94). The state becomes ``(inner, t)``."""

    def __init__(self, env: TorchEnv, max_episode_steps: int):
        super().__init__(env)
        self.max_episode_steps = int(max_episode_steps)

    def reset(self, draws, num_envs: int, device: torch.device):
        obs, inner = self.env.reset(draws, num_envs, device)
        return obs, TimeLimitState(inner, torch.zeros((num_envs,), dtype=torch.int32,
                                                      device=device))

    def step(self, draws, state: TimeLimitState, action):
        obs, inner, reward, done, info = self.env.step(draws, state.inner, action)
        t = state.t + 1
        truncated = (t >= self.max_episode_steps) & ~done
        info = dict(info, truncated=truncated)
        return obs, TimeLimitState(inner, t), reward, done | truncated, info


class ClipActions(EnvWrapper):
    """``nan_to_num``, then clip the action to the Box's bounds (base.py:97-105)."""

    def __init__(self, env: TorchEnv):
        super().__init__(env)
        self._bounds = {}

    def _low_high(self, device):
        if device not in self._bounds:
            sp = self.action_space
            self._bounds[device] = (torch.as_tensor(sp.low, device=device),
                                    torch.as_tensor(sp.high, device=device))
        return self._bounds[device]

    def step(self, draws, state, action):
        low, high = self._low_high(action.device)
        action = torch.clamp(torch.nan_to_num(action), low, high)
        return self.env.step(draws, state, action)


class RewardScale(EnvWrapper):
    """reward *= scale (base.py:108-118)."""

    def __init__(self, env: TorchEnv, scale: float):
        super().__init__(env)
        self.scale = float(scale)

    def step(self, draws, state, action):
        obs, state, reward, done, info = self.env.step(draws, state, action)
        return obs, state, reward * self.scale, done, info


class ClipReward(EnvWrapper):
    """The sign of the reward, the DeepMind Atari ClipRewardEnv (base.py:121-127). A NaN
    reward stays NaN, as under ``jnp.sign``; ``torch.sign`` alone would give 0."""

    def step(self, draws, state, action):
        obs, state, reward, done, info = self.env.step(draws, state, action)
        sign = torch.where(torch.isnan(reward), reward, torch.sign(reward))
        return obs, state, sign, done, info
