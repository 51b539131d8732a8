"""The DeepMind Atari preprocessing chain (counterpart of baselines_tpu/envs/atari.py,
after baselines/common/atari_wrappers.py).

``make_atari`` + ``wrap_deepmind`` (atari_wrappers.py:266-289): NoopResetEnv(30) ->
MaxAndSkipEnv(4) -> EpisodicLifeEnv -> FireResetEnv -> WarpFrame (84x84 grey) ->
ClipRewardEnv. The wrappers run in the host pool's workers on numpy frames; the frames
are stacked on the learner's device by VecFrameStack (``make_atari_vec_env``), so the
LazyFrames trick of the reference is not needed.

``WarpFrame`` does its greyscale and its resize in numpy, without cv2: the greyscale is
cv2's 15-bit fixed-point ``COLOR_RGB2GRAY``, and the resize is cv2's ``INTER_AREA``,
rebuilt from its weight tables and its order of f32 sums (``resizeArea_``) where both
axes shrink, and from its fixed-point linear path where one grows. On the ALE's
210x160x3 frames it gives cv2's frames bit for bit (``tests/test_torch_atari.py``).

``make_atari`` needs gymnasium and ale_py, imported where they are used; the wrappers
and ``atari_vec_env`` take any env with the gymnasium step API, so a stand-in emulator
runs the same chain where neither is installed.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from baselines_tpu_torch.envs.spaces import Box


class _Wrapper:
    """Hands every attribute it does not define to the env it wraps."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        if name == "env":  # not set yet (an object being unpickled)
            raise AttributeError(name)
        return getattr(self.env, name)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        return self.env.step(action)


class NoopResetEnv(_Wrapper):
    """A random number in [1, noop_max] of no-op steps after each reset, drawn from the
    emulator's ``np_random`` (atari_wrappers.py:12-39)."""

    def __init__(self, env, noop_max=30):
        super().__init__(env)
        self.noop_max = noop_max
        self.noop_action = 0
        if env.unwrapped.get_action_meanings()[0] != "NOOP":
            raise ValueError("NoopResetEnv needs action 0 to be NOOP")

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        noops = self.env.unwrapped.np_random.integers(1, self.noop_max + 1)
        for _ in range(noops):
            obs, _, terminated, truncated, info = self.env.step(self.noop_action)
            if terminated or truncated:
                obs, info = self.env.reset(**kwargs)
        return obs, info


class FireResetEnv(_Wrapper):
    """FIRE, then action 2, after each reset (atari_wrappers.py:41-59)."""

    def __init__(self, env):
        super().__init__(env)
        meanings = env.unwrapped.get_action_meanings()
        if meanings[1] != "FIRE" or len(meanings) < 3:
            raise ValueError("FireResetEnv needs action 1 to be FIRE and 3 actions or more")

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        obs, _, terminated, truncated, _ = self.env.step(1)
        if terminated or truncated:
            self.env.reset(**kwargs)
        obs, _, terminated, truncated, info = self.env.step(2)
        if terminated or truncated:
            obs, info = self.env.reset(**kwargs)
        return obs, info


class EpisodicLifeEnv(_Wrapper):
    """A lost life ends the episode, but only a game over resets the game; the reset
    after a lost life is one no-op step (atari_wrappers.py:61-95)."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.was_real_done = terminated or truncated
        lives = self.env.unwrapped.ale.lives()
        if 0 < lives < self.lives:
            terminated = True
        self.lives = lives
        return obs, reward, terminated, truncated, info

    def reset(self, **kwargs):
        if self.was_real_done:
            obs, info = self.env.reset(**kwargs)
        else:
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                obs, info = self.env.reset(**kwargs)
        self.lives = self.env.unwrapped.ale.lives()
        return obs, info


class MaxAndSkipEnv(_Wrapper):
    """Each action repeated ``skip`` times, the rewards summed and the pixel-wise max of
    the last two frames returned (atari_wrappers.py:97-123)."""

    def __init__(self, env, skip=4):
        super().__init__(env)
        self._skip = skip
        self._obs_buffer = np.zeros((2,) + tuple(env.observation_space.shape), dtype=np.uint8)

    def step(self, action):
        total_reward = 0.0
        terminated = truncated = False
        info = {}
        for i in range(self._skip):
            obs, reward, terminated, truncated, info = self.env.step(action)
            if i == self._skip - 2:
                self._obs_buffer[0] = obs
            if i == self._skip - 1:
                self._obs_buffer[1] = obs
            total_reward += float(reward)
            if terminated or truncated:
                break
        return self._obs_buffer.max(axis=0), total_reward, terminated, truncated, info


def rgb_to_gray(frame: np.ndarray) -> np.ndarray:
    """cv2's ``COLOR_RGB2GRAY`` on u8 (..., 3) frames: 0.299 R + 0.587 G + 0.114 B in
    15-bit fixed point, rounded."""
    f = frame.astype(np.int32)
    g = 9798 * f[..., 0] + 19235 * f[..., 1] + 3735 * f[..., 2]
    return ((g + (1 << 14)) >> 15).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _area_terms(ssize: int, dsize: int):
    """cv2's ``computeResizeAreaTab`` along one shrinking axis, as (terms, dsize)
    arrays of source indices and f32 weights: term t of output d is the t-th source
    pixel that covers it (weight 0 where d has fewer terms)."""
    scale = 1.0 / (dsize / ssize)
    per = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s2 = min(math.floor(fs2), ssize - 1)
        s1 = min(math.ceil(fs1), s2)
        terms = []
        if s1 - fs1 > 1e-3:
            terms.append((s1 - 1, (s1 - fs1) / cell))
        terms += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            terms.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        per.append(terms)
    idx = np.zeros((max(map(len, per)), dsize), np.int64)
    weight = np.zeros(idx.shape, np.float32)
    for d, terms in enumerate(per):
        for t, (s, w) in enumerate(terms):
            idx[t, d], weight[t, d] = s, np.float32(w)
    return idx, weight


def _resize_area_shrink(gray: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2's ``resizeArea_<uchar, float>``: each source row summed across in f32 term by
    term, then the rows summed down term by term, rounded half to even."""
    xi, xw = _area_terms(gray.shape[-1], width)
    yi, yw = _area_terms(gray.shape[-2], height)
    g = gray.astype(np.float32)
    rows = g[..., xi[0]] * xw[0]
    for t in range(1, len(xi)):
        rows = rows + g[..., xi[t]] * xw[t]
    out = rows[..., yi[0], :] * yw[0][:, None]
    for t in range(1, len(yi)):
        out = out + rows[..., yi[t], :] * yw[t][:, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS


@functools.lru_cache(maxsize=None)
def _linear_terms(ssize: int, dsize: int):
    """cv2's area-mode linear coefficients along one axis (the resize of an axis that
    grows): the first source index of each output and its two 11-bit weights."""
    inv = dsize / ssize
    scale = 1.0 / inv
    first = np.zeros(dsize, np.int64)
    weights = np.zeros((dsize, 2), np.int64)
    one = np.float32(1 << _COEF_BITS)
    for d in range(dsize):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - math.floor(f))
        if s >= ssize - 1:
            f, s = np.float32(0.0), ssize - 1
        first[d] = s
        weights[d] = (int(np.rint((np.float32(1.0) - f) * one)), int(np.rint(f * one)))
    return first, weights


def _resize_area_grow(gray: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2's ``INTER_AREA`` where an axis grows: its fixed-point linear resize with the
    area-mode coefficients, the vertical pass as its vector code rounds it."""
    h, w = gray.shape[-2:]
    x0, xw = _linear_terms(w, width)
    y0, yw = _linear_terms(h, height)
    g = gray.astype(np.int64)
    rows = g[..., x0] * xw[:, 0] + g[..., np.minimum(x0 + 1, w - 1)] * xw[:, 1]
    edge = x0 >= w - 1
    rows[..., edge] = g[..., x0[edge]] << _COEF_BITS
    a = ((rows[..., y0, :] >> 4) * yw[:, :1]) >> 16
    b = ((rows[..., np.minimum(y0 + 1, h - 1), :] >> 4) * yw[:, 1:]) >> 16
    return np.clip((a + b + 2) >> 2, 0, 255).astype(np.uint8)


def resize_area(gray: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(gray, (width, height), interpolation=INTER_AREA) on u8 (..., H, W)
    frames."""
    h, w = gray.shape[-2:]
    if height <= h and width <= w:
        return _resize_area_shrink(gray, height, width)
    return _resize_area_grow(gray, height, width)


class WarpFrame(_Wrapper):
    """The frame in grey, resized to ``height`` x ``width`` with cv2's area
    interpolation, as (height, width, 1) u8 (atari_wrappers.py:134-185)."""

    def __init__(self, env, width=84, height=84):
        super().__init__(env)
        self._width = width
        self._height = height
        self.observation_space = Box(0, 255, (height, width, 1), np.uint8)

    def _warp(self, frame):
        return resize_area(rgb_to_gray(np.asarray(frame)), self._height, self._width)[:, :, None]

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._warp(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._warp(obs), reward, terminated, truncated, info


class ClipRewardEnv(_Wrapper):
    """The reward's sign (atari_wrappers.py:125-131)."""

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return obs, float(np.sign(reward)), terminated, truncated, info


def make_atari(env_id: str, max_episode_steps=None, need_render: bool = False):
    """The ALE env ``env_id`` without frame skip or sticky actions, behind NoopResetEnv
    and MaxAndSkipEnv (atari_wrappers.py:266-273); ``need_render`` gives it an rgb_array
    render surface for video capture. Needs gymnasium and ale_py."""
    import gymnasium as gym
    import ale_py  # noqa: F401  (registers the ALE envs)

    env = gym.make(env_id, frameskip=1, repeat_action_probability=0.0,
                   render_mode="rgb_array" if need_render else None)
    env = NoopResetEnv(env, noop_max=30)
    env = MaxAndSkipEnv(env, skip=4)
    if max_episode_steps is not None:
        env = gym.wrappers.TimeLimit(env, max_episode_steps=max_episode_steps)
    return env


def wrap_deepmind(env, episode_life=True, clip_rewards=True, fire_reset=True):
    """wrap_deepmind (atari_wrappers.py:275-289); the frames are stacked and scaled on
    the device."""
    if episode_life:
        env = EpisodicLifeEnv(env)
    if fire_reset and "FIRE" in env.unwrapped.get_action_meanings():
        env = FireResetEnv(env)
    env = WarpFrame(env)
    if clip_rewards:
        env = ClipRewardEnv(env)
    return env


def atari_vec_env(thunk, num_envs: int, frame_stack: int = 4, *, device=None,
                  first_env: int = 0):
    """``num_envs`` envs of ``thunk`` in a host pool (worker processes for more than
    one), behind CallbackVecEnv on ``device``, frame-stacked there when ``frame_stack``
    > 1. ``first_env`` is the global index of the pool's first env (a mesh rank's)."""
    from baselines_tpu_torch.envs.callback_env import CallbackVecEnv
    from baselines_tpu_torch.envs.gym_bridge import host_pool
    from baselines_tpu_torch.envs.vec import VecFrameStack

    venv = CallbackVecEnv(host_pool(thunk, num_envs, first_env), device=device)
    return VecFrameStack(venv, frame_stack) if frame_stack > 1 else venv


def make_atari_vec_env(env_id: str, num_envs: int, frame_stack: int = 4,
                       need_render: bool = False, *, device=None, first_env: int = 0):
    """The DeepMind chain of ``env_id`` in a host pool feeding the device, frame-stacked
    there (atari.py:222-239). Raises ModuleNotFoundError here, before any worker
    starts, where ale_py is missing."""
    import ale_py  # noqa: F401

    def thunk():
        return wrap_deepmind(make_atari(env_id, need_render=need_render))

    return atari_vec_env(thunk, num_envs, frame_stack, device=device, first_env=first_env)
