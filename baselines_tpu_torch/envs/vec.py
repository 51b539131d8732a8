"""The vector env layer (counterpart of baselines_tpu/envs/vec.py).

    obs, state = venv.reset(draws)                        # obs: (N, ...)
    obs, state, rew, done, info = venv.step(draws, state, actions)

Auto-reset matches the subprocess workers of the reference (subproc_vec_env.py:8-12):
where an env reports done, the returned obs and state are the reset ones, and the
terminal observation is ``info['terminal_obs']``.

Ported: ``VecTorchEnv`` (the batch with auto-reset), ``VecWrapper``, ``VecMonitor``
with its ``EpisodeStats`` ring of the last 100 episodes, ``VecFrameStack``,
``VecRewardScale``, ``VecNormalize`` with ``find_normalize_state`` and
``replace_normalize_stats``, and ``VecS2D`` with the packed 3-D layout. The dict-obs
wrappers come with item 7 of ROADMAP.md's Queue 1, and the pipelined env pair's branch
of the normalize helpers with item 8.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from baselines_tpu_torch.core.running_stats import RunningMeanStd, check_axis_name
from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.spaces import Box, torch_dtype

EPISODE_BUFFER = 100  # matches deque(maxlen=100) of epinfos, ppo2/ppo2.py:118


def _where_done(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where done else b, with done broadcast over the trailing dims."""
    return torch.where(done.view(done.shape + (1,) * (a.dim() - done.dim())), a, b)


def _select_state(done, reset_state, state):
    """The reset state where done, field by field through nested dataclasses."""
    if not dataclasses.is_dataclass(state):
        return _where_done(done, reset_state, state)
    return dataclasses.replace(state, **{
        f.name: _select_state(done, getattr(reset_state, f.name), getattr(state, f.name))
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
    would wait on the device at every step. Each step therefore takes the env step's
    draws (none for most envs), then one reset's draws, the order of ``kstep, kreset =
    jax.random.split(key)`` in VecJaxEnv.step."""

    def __init__(self, env: TorchEnv, num_envs: int, device):
        self.env = env
        self.num_envs = int(num_envs)
        self.device = torch.device(device)
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, draws):
        return self.env.reset(draws, self.num_envs, self.device)

    def step(self, draws, state, actions):
        obs, st, rew, done, info = self.env.step(draws, state, actions)
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


@dataclass
class FrameStackState:
    inner: Any
    frames: torch.Tensor  # (N, ..., C * k)


class VecFrameStack(VecWrapper):
    """The last k frames along the last (channel) axis (vec.py:257-303): on done the
    stack is zeroed before the reset frame goes in, and ``info['terminal_obs']`` is the
    terminal frame stacked onto the frames before it."""

    def __init__(self, venv, k: int):
        super().__init__(venv)
        self.k = int(k)
        sp = venv.observation_space
        low = np.repeat(sp.low, self.k, axis=-1)
        high = np.repeat(sp.high, self.k, axis=-1)
        self.observation_space = Box(low, high, dtype=sp.dtype)
        self._c = sp.shape[-1]

    def _insert(self, frames: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """Drop the oldest frame and append ``obs`` (jnp.roll then a set, vec.py:277-279)."""
        return torch.cat([frames[..., self._c:], obs.to(frames.dtype)], dim=-1)

    def reset(self, draws):
        obs, inner = self.venv.reset(draws)
        frames = torch.zeros((self.num_envs,) + self.observation_space.shape,
                             dtype=torch_dtype(self.observation_space.dtype), device=obs.device)
        frames = self._insert(frames, obs)
        return frames, FrameStackState(inner, frames)

    def unwrap_state(self, state):
        return state.inner

    def post(self, state, obs, inner, rew, done, info):
        if "terminal_obs" in info:
            info = dict(info, terminal_obs=self._insert(state.frames, info["terminal_obs"]))
        frames = _where_done(done, torch.zeros_like(state.frames), state.frames)
        frames = self._insert(frames, obs)
        return frames, FrameStackState(inner, frames), rew, done, info


class VecRewardScale(VecWrapper):
    """reward *= scale, the ``--reward_scale`` flag (vec.py:419-432). It sits outside
    VecMonitor, so the episode statistics stay in raw units, and inside VecNormalize,
    whose return statistics see the scaled rewards."""

    def __init__(self, venv, scale: float):
        super().__init__(venv)
        self.scale = float(scale)

    def post(self, state, obs, inner, rew, done, info):
        return obs, inner, rew * self.scale, done, info


@dataclass
class NormalizeState:
    inner: Any
    ob_rms: RunningMeanStd
    ret_rms: RunningMeanStd
    ret: torch.Tensor  # (N,) f32, the discounted return of each env's episode


class VecNormalize(VecWrapper):
    """Observation and return normalization by running statistics (vec.py:435-516,
    after the reference's vec_normalize.py:4-47). The statistics are part of the env
    state, so they are saved with the train state. ``reset`` folds the reset
    observations into ``ob_rms``; each step folds in the new observations and the
    discounted returns, divides the rewards by the return's standard deviation, and
    moves ``info['terminal_obs']`` into the normalized space, where a replay learner
    stores it beside the observations."""

    def __init__(self, venv, ob: bool = True, ret: bool = True, clipob: float = 10.0,
                 cliprew: float = 10.0, gamma: float = 0.99, epsilon: float = 1e-8,
                 axis_name=None):
        super().__init__(venv)
        check_axis_name(axis_name)
        self.ob = ob
        self.ret_flag = ret
        self.clipob = clipob
        self.cliprew = cliprew
        self.gamma = gamma
        self.epsilon = epsilon
        # trained statistics to start from at the next reset: evaluate sets them, so a
        # saved model is replayed under the normalization it was trained with
        self.init_stats = None

    def _norm_obs(self, ob_rms: RunningMeanStd, obs: torch.Tensor) -> torch.Tensor:
        if not self.ob:
            return obs
        return ob_rms.normalize(obs, clip=self.clipob, epsilon=self.epsilon)

    def reset(self, draws):
        obs, inner = self.venv.reset(draws)
        if self.init_stats is not None:
            ob_rms, ret_rms = self.init_stats
        else:
            ob_rms = RunningMeanStd.create(self.observation_space.shape, device=obs.device)
            ret_rms = RunningMeanStd.create((), device=obs.device)
        if self.ob:
            ob_rms = ob_rms.update(obs)
        ret = torch.zeros((self.num_envs,), dtype=torch.float32, device=obs.device)
        return self._norm_obs(ob_rms, obs), NormalizeState(inner, ob_rms, ret_rms, ret)

    def unwrap_state(self, state):
        return state.inner

    def post(self, state, obs, inner, rew, done, info):
        ob_rms, ret_rms = state.ob_rms, state.ret_rms
        ret = state.ret * self.gamma + rew
        if self.ob:
            ob_rms = ob_rms.update(obs)
        if self.ret_flag:
            ret_rms = ret_rms.update(ret)
            rew = torch.clamp(rew / torch.sqrt(ret_rms.var + self.epsilon), -self.cliprew,
                              self.cliprew)
        ret = torch.where(done, torch.zeros_like(ret), ret)
        new_state = NormalizeState(inner, ob_rms, ret_rms, ret)
        if "terminal_obs" in info:
            info = dict(info, terminal_obs=self._norm_obs(ob_rms, info["terminal_obs"]))
        return self._norm_obs(ob_rms, obs), new_state, rew, done, info


def find_normalize_state(env_state) -> NormalizeState | None:
    """The NormalizeState in a chain of wrapper states, or None when the env is not
    normalized (vec.py:519-532; the pipelined pair's branch comes with item 8)."""
    while env_state is not None:
        if isinstance(env_state, NormalizeState):
            return env_state
        env_state = getattr(env_state, "inner", None)
    return None


def replace_normalize_stats(env_state, ob_rms: RunningMeanStd, ret_rms: RunningMeanStd):
    """``env_state`` with its NormalizeState's statistics swapped for the given ones, and
    as it is when the chain has no NormalizeState (vec.py:535-551)."""
    if env_state is None:
        return None
    if isinstance(env_state, NormalizeState):
        return dataclasses.replace(env_state, ob_rms=ob_rms, ret_rms=ret_rms)
    inner = getattr(env_state, "inner", None)
    if inner is None:
        return env_state
    return dataclasses.replace(env_state, inner=replace_normalize_stats(inner, ob_rms, ret_rms))
