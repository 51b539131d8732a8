"""The vector env layer (counterpart of baselines_tpu/envs/vec.py).

    obs, state = venv.reset(draws)                        # obs: (N, ...)
    obs, state, rew, done, info = venv.step(draws, state, actions)

Auto-reset matches the subprocess workers of the reference (subproc_vec_env.py:8-12):
where an env reports done, the returned obs and state are the reset ones, and the
terminal observation is ``info['terminal_obs']``.

Ported so far: ``VecTorchEnv`` (the batch with auto-reset), ``VecWrapper``,
``VecMonitor`` with its ``EpisodeStats`` ring of the last 100 episodes, and ``VecS2D``
with the packed 3-D layout.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.spaces import Box

EPISODE_BUFFER = 100  # matches deque(maxlen=100) of epinfos, ppo2/ppo2.py:118


def _where_done(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where done else b, with done broadcast over the trailing dims."""
    return torch.where(done.view(done.shape + (1,) * (a.dim() - done.dim())), a, b)


def _select_state(done, reset_state, state):
    return dataclasses.replace(state, **{
        f.name: _where_done(done, getattr(reset_state, f.name), getattr(state, f.name))
        for f in dataclasses.fields(state)
    })


@dataclass
class EpisodeStats:
    """Per-env accumulators and a ring of the last 100 completed episodes' returns and
    lengths, all on the device (the info['episode'] pipeline, bench/monitor.py:58-75)."""

    ep_return: torch.Tensor  # (N,) f32
    ep_length: torch.Tensor  # (N,) int32
    ret_buffer: torch.Tensor  # (EPISODE_BUFFER,) f32
    len_buffer: torch.Tensor  # (EPISODE_BUFFER,) f32
    episodes: torch.Tensor  # () int64, total completed
    total_steps: torch.Tensor  # () f32

    @staticmethod
    def create(num_envs: int, device) -> "EpisodeStats":
        return EpisodeStats(
            ep_return=torch.zeros((num_envs,), dtype=torch.float32, device=device),
            ep_length=torch.zeros((num_envs,), dtype=torch.int32, device=device),
            ret_buffer=torch.zeros((EPISODE_BUFFER,), dtype=torch.float32, device=device),
            len_buffer=torch.zeros((EPISODE_BUFFER,), dtype=torch.float32, device=device),
            episodes=torch.zeros((), dtype=torch.int64, device=device),
            total_steps=torch.zeros((), dtype=torch.float32, device=device),
        )

    def update(self, reward: torch.Tensor, done: torch.Tensor) -> "EpisodeStats":
        n = reward.shape[0]
        ep_return = self.ep_return + reward
        ep_length = self.ep_length + 1
        order = torch.cumsum(done.to(torch.int64), 0) - 1  # 0-based among dones
        n_done = order[-1] + 1
        # a ring written in env order keeps only the last EPISODE_BUFFER completions of
        # a step; dropping the others up front leaves every kept slot written once
        keep = done & (order >= n_done - EPISODE_BUFFER)
        slot = torch.where(keep, (self.episodes + order) % EPISODE_BUFFER, EPISODE_BUFFER)

        def ring(buf, val):
            return torch.cat([buf, buf.new_zeros(1)]).scatter(0, slot, val)[:EPISODE_BUFFER]

        return EpisodeStats(
            ep_return=torch.where(done, torch.zeros_like(ep_return), ep_return),
            ep_length=torch.where(done, torch.zeros_like(ep_length), ep_length),
            ret_buffer=ring(self.ret_buffer, ep_return),
            len_buffer=ring(self.len_buffer, ep_length.to(torch.float32)),
            episodes=self.episodes + n_done,
            total_steps=self.total_steps + n,
        )

    def _masked_mean(self, buf: torch.Tensor) -> torch.Tensor:
        valid = torch.clamp(self.episodes, max=EPISODE_BUFFER)
        mask = torch.arange(EPISODE_BUFFER, device=buf.device) < valid
        mean = torch.where(mask, buf, 0.0).sum() / torch.clamp(valid, min=1)
        return torch.where(valid > 0, mean, torch.full_like(mean, float("nan")))

    @property
    def mean_return(self) -> torch.Tensor:
        """eprewmean (ppo2/ppo2.py:201)."""
        return self._masked_mean(self.ret_buffer)

    @property
    def mean_length(self) -> torch.Tensor:
        """eplenmean (ppo2/ppo2.py:202)."""
        return self._masked_mean(self.len_buffer)


class VecTorchEnv:
    """A batch of ``num_envs`` envs on ``device`` with subprocess-matching auto-reset
    (counterpart of VecJaxEnv).

    The reset is computed at every step and selected where done: a branch on any(done)
    would wait on the device at every step. Each step therefore takes one reset's
    draws, as the JAX env derives one reset key per step."""

    def __init__(self, env: TorchEnv, num_envs: int, device):
        self.env = env
        self.num_envs = int(num_envs)
        self.device = torch.device(device)
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, draws):
        return self.env.reset(draws, self.num_envs, self.device)

    def step(self, draws, state, actions):
        obs, st, rew, done, info = self.env.step(state, actions)
        info = dict(info)
        info["terminal_obs"] = obs
        robs, rst = self.env.reset(draws, self.num_envs, self.device)
        new_obs = _where_done(done, robs, obs)
        new_state = _select_state(done, rst, st)
        return new_obs, new_state, rew.to(torch.float32), done, info


class VecWrapper:
    """Base vec wrapper: every concrete wrapper is a post-transform of the inner step's
    results, factored as ``unwrap_state`` + ``post``."""

    def __init__(self, venv):
        self.venv = venv
        self.num_envs = venv.num_envs
        self.device = venv.device
        self.observation_space = venv.observation_space
        self.action_space = venv.action_space

    def reset(self, draws):
        return self.venv.reset(draws)

    def unwrap_state(self, state):
        """This wrapper's view of the inner env state (identity when stateless)."""
        return state

    def post(self, state, obs, inner_state, rew, done, info):
        """Transform the inner step's results; returns the 5-tuple with this wrapper's
        state rebuilt around ``inner_state``."""
        return obs, inner_state, rew, done, info

    def step(self, draws, state, actions):
        obs, inner, rew, done, info = self.venv.step(draws, self.unwrap_state(state), actions)
        return self.post(state, obs, inner, rew, done, info)


@dataclass
class MonitorState:
    inner: Any
    stats: EpisodeStats


class VecMonitor(VecWrapper):
    """Episode accounting as device state (vec_monitor.py:7-55)."""

    def reset(self, draws):
        obs, inner = self.venv.reset(draws)
        return obs, MonitorState(inner, EpisodeStats.create(self.num_envs, self.device))

    def unwrap_state(self, state):
        return state.inner

    def post(self, state, obs, inner, rew, done, info):
        return obs, MonitorState(inner, state.stats.update(rew, done)), rew, done, info

    @staticmethod
    def get_stats(state) -> EpisodeStats:
        while not isinstance(state, MonitorState):
            state = state.inner
        return state.stats


class VecS2D(VecWrapper):
    """Space-to-depth packing of the observations: (H, W, C) -> (H/b, W/b, b*b*C), so
    the Nature CNN's 8x8/s4 conv1 becomes an exactly equivalent 2x2/s1 conv on
    21x21x64 frames. Only the packed 3-D layout (``flat=False``) is ported."""

    def __init__(self, venv, block: int = 4):
        super().__init__(venv)
        sp = venv.observation_space
        h, w, c = sp.shape
        if h % block or w % block:
            raise ValueError(f"obs {sp.shape} not divisible by s2d block {block}")
        self.block = int(block)
        packed = (h // block, w // block, block * block * c)
        self.observation_space = Box(np.min(sp.low), np.max(sp.high), packed, dtype=sp.dtype)

    def _pack(self, obs: torch.Tensor) -> torch.Tensor:
        b = self.block
        n, h, w, c = obs.shape
        x = obs.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h // b, w // b, b * b * c)

    def reset(self, draws):
        obs, inner = self.venv.reset(draws)
        return self._pack(obs), inner

    def post(self, state, obs, inner, rew, done, info):
        if "terminal_obs" in info:
            info = dict(info, terminal_obs=self._pack(info["terminal_obs"]))
        return self._pack(obs), inner, rew, done, info
