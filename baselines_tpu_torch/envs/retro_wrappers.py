"""The retro (Sega, SNES) wrappers (counterpart of baselines_tpu/envs/retro_wrappers.py,
after baselines/common/retro_wrappers.py).

The wrappers run on any env with the gymnasium step API, in a host pool's workers;
their random numbers come from numpy's ``RandomState``, as the reference draws them.
The spaces they declare are the port's (``envs/spaces.py``), and a gymnasium space
they are given is converted, so none needs gymnasium. Only ``make_retro`` needs the
``retro`` emulator (and gymnasium for its TimeLimit), imported where it is called.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from baselines_tpu_torch.envs.atari import ClipRewardEnv, WarpFrame, _Wrapper, atari_vec_env
from baselines_tpu_torch.envs.gym_bridge import convert_space
from baselines_tpu_torch.envs.spaces import Box, DictSpace, Discrete


class StochasticFrameSkip(_Wrapper):
    """``n`` sub-steps an action; at the first sub-step the previous action sticks with
    probability ``stickprob``, and the second always takes the new one
    (retro_wrappers.py:10-50)."""

    def __init__(self, env, n, stickprob, seed=None):
        super().__init__(env)
        self.n = n
        self.stickprob = stickprob
        self.curac = None
        self.rng = np.random.RandomState(seed)

    def reset(self, **kwargs):
        self.curac = None
        return self.env.reset(**kwargs)

    def step(self, ac):
        terminated = truncated = False
        totrew = 0
        info = {}
        obs = None
        for i in range(self.n):
            if self.curac is None:
                self.curac = ac
            elif i == 0:
                if self.rng.rand() > self.stickprob:
                    self.curac = ac
            elif i == 1:
                self.curac = ac
            obs, rew, terminated, truncated, info = self.env.step(self.curac)
            totrew += rew
            if terminated or truncated:
                break
        return obs, totrew, terminated, truncated, info


class Downsample(_Wrapper):
    """Every ``ratio``-th pixel along both axes."""

    def __init__(self, env, ratio):
        super().__init__(env)
        self.ratio = ratio

    def _ds(self, frame):
        return frame[::self.ratio, ::self.ratio]

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._ds(obs), info

    def step(self, action):
        obs, rew, term, trunc, info = self.env.step(action)
        return self._ds(obs), rew, term, trunc, info


class Rgb2gray(_Wrapper):
    """The channels' mean, truncated to u8, as one channel."""

    @staticmethod
    def _gray(frame):
        return np.mean(frame, axis=-1, keepdims=True).astype(np.uint8)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._gray(obs), info

    def step(self, action):
        obs, rew, term, trunc, info = self.env.step(action)
        return self._gray(obs), rew, term, trunc, info


class RewardScaler(_Wrapper):
    """reward *= scale, ppo's reward scaling for retro games."""

    def __init__(self, env, scale=0.01):
        super().__init__(env)
        self.scale = scale

    def step(self, action):
        obs, rew, term, trunc, info = self.env.step(action)
        return obs, rew * self.scale, term, trunc, info


class PartialFrameStack(_Wrapper):
    """The last ``k`` frames along the channels, the older ones by their channel
    ``channel`` only: (h, w, c + k - 1) (retro_wrappers.py:48-77)."""

    def __init__(self, env, k, channel=1):
        super().__init__(env)
        self.k = k
        self.channel = channel
        self.frames = deque(maxlen=k)
        if hasattr(env, "observation_space"):
            space = convert_space(env.observation_space)
            h, w, c = space.shape
            self.observation_space = Box(0, 255, (h, w, c + k - 1), space.dtype)

    def _get_ob(self):
        assert len(self.frames) == self.k
        parts = [f if i == self.k - 1 else f[:, :, self.channel:self.channel + 1]
                 for i, f in enumerate(self.frames)]
        return np.concatenate(parts, axis=2)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        assert obs.shape[2] > self.channel
        for _ in range(self.k):
            self.frames.append(obs)
        return self._get_ob(), info

    def step(self, action):
        obs, rew, term, trunc, info = self.env.step(action)
        self.frames.append(obs)
        return self._get_ob(), rew, term, trunc, info


class MovieRecord(_Wrapper):
    """Every ``k``-th episode recorded by pointing the emulator's ``movie_path`` at
    ``savedir`` at its reset (retro_wrappers.py:113-126)."""

    def __init__(self, env, savedir, k):
        super().__init__(env)
        self.savedir = savedir
        self.k = k
        self.epcount = 0

    def reset(self, **kwargs):
        base = getattr(self.env, "unwrapped", self.env)
        if self.epcount % self.k == 0:
            base.movie_path = self.savedir
        else:
            base.movie_path = None
            base.movie = None
        self.epcount += 1
        return self.env.reset(**kwargs)


class AppendTimeout(_Wrapper):
    """The share of the episode's step budget still left, as the observation's
    ``value_estimation_timeout`` (retro_wrappers.py:128-168): a dict observation gains
    the key, another becomes {'original': obs, 'value_estimation_timeout': share}. The
    budget is the ``_max_episode_steps`` of the TimeLimit in the chain."""

    def __init__(self, env):
        super().__init__(env)
        self.ac_count = 0
        e = env
        while not hasattr(e, "_max_episode_steps"):
            e = e.env
        self.timeout = e._max_episode_steps
        self.dict_mode = False
        if hasattr(env, "observation_space"):
            t_space = Box(0.0, 1.0, (1,), np.float32)
            orig = convert_space(env.observation_space)
            self.dict_mode = isinstance(orig, DictSpace)
            spaces = dict(orig.spaces) if self.dict_mode else {"original": orig}
            spaces["value_estimation_timeout"] = t_space
            self.observation_space = DictSpace(spaces)

    def _process(self, ob):
        fracmissing = 1.0 - self.ac_count / self.timeout
        if self.dict_mode:
            ob = dict(ob)
            ob["value_estimation_timeout"] = fracmissing
            return ob
        return {"original": ob, "value_estimation_timeout": fracmissing}

    def reset(self, **kwargs):
        self.ac_count = 0
        obs, info = self.env.reset(**kwargs)
        return self._process(obs), info

    def step(self, action):
        self.ac_count += 1
        obs, rew, term, trunc, info = self.env.step(action)
        return self._process(obs), rew, term, trunc, info


class StartDoingRandomActionsWrapper(_Wrapper):
    """A random number below ``max_random_steps`` of random actions at startup (and
    after every episode with ``every_episode``), so that runs start from decorrelated
    emulator states (retro_wrappers.py:170-198). It auto-resets on done, and the infos
    of the steps in between are dropped, as in the reference. A random action is the
    action space's ``sample()``; the port's ``Discrete`` has none, and its actions are
    drawn from this wrapper's ``RandomState`` after the step count."""

    def __init__(self, env, max_random_steps, on_startup=True, every_episode=False,
                 seed=None):
        super().__init__(env)
        self.random_steps = max_random_steps
        self.every_episode = every_episode
        self.rng = np.random.RandomState(seed)
        self.last_obs = None
        self.last_info = {}
        if on_startup:
            self.some_random_steps()

    def some_random_steps(self):
        self.last_obs, self.last_info = self.env.reset()
        n = self.rng.randint(self.random_steps)
        space = self.env.action_space
        for _ in range(n):
            action = space.sample() if hasattr(space, "sample") else self.rng.randint(space.n)
            self.last_obs, _, term, trunc, self.last_info = self.env.step(action)
            if term or trunc:
                self.last_obs, self.last_info = self.env.reset()

    def reset(self, **kwargs):
        return self.last_obs, self.last_info

    def step(self, action):
        self.last_obs, rew, term, trunc, info = self.env.step(action)
        if term or trunc:
            self.last_obs, _ = self.env.reset()
            if self.every_episode:
                self.some_random_steps()
        return self.last_obs, rew, term, trunc, info


class SonicDiscretizer(_Wrapper):
    """The Genesis pad's 12 buttons reduced to the 7 combinations Sonic needs: LEFT,
    RIGHT, LEFT+DOWN, RIGHT+DOWN, DOWN, DOWN+B (spin dash) and B (jump)
    (retro_wrappers.py:224-243)."""

    BUTTONS = ["B", "A", "MODE", "START", "UP", "DOWN", "LEFT", "RIGHT", "C", "Y", "X", "Z"]
    COMBOS = (("LEFT",), ("RIGHT",), ("LEFT", "DOWN"), ("RIGHT", "DOWN"), ("DOWN",),
              ("DOWN", "B"), ("B",))

    def __init__(self, env):
        super().__init__(env)
        self._actions = []
        for combo in self.COMBOS:
            arr = np.zeros(len(self.BUTTONS), dtype=bool)
            arr[[self.BUTTONS.index(b) for b in combo]] = True
            self._actions.append(arr)
        self.action_space = Discrete(len(self._actions))

    def step(self, action):
        return self.env.step(self._actions[int(action)].copy())


class AllowBacktracking(_Wrapper):
    """The reward as the gain of the furthest x reached, not of x, so that going back
    out of a dead end costs nothing (retro_wrappers.py:258-282)."""

    def __init__(self, env):
        super().__init__(env)
        self._cur_x = 0.0
        self._max_x = 0.0

    def reset(self, **kwargs):
        self._cur_x = 0.0
        self._max_x = 0.0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, rew, term, trunc, info = self.env.step(action)
        self._cur_x += rew
        rew = max(0.0, self._cur_x - self._max_x)
        self._max_x = max(self._max_x, self._cur_x)
        return obs, rew, term, trunc, info


def make_retro(*, game, state=None, max_episode_steps=4500, **kwargs):
    """The retro game ``game`` from ``state`` (the game's default when None), behind
    StochasticFrameSkip(4, 0.25) and a TimeLimit (retro_wrappers.make_retro). Needs
    retro and gymnasium."""
    import retro

    if state is None:
        state = retro.State.DEFAULT
    env = retro.make(game, state, **kwargs)
    env = StochasticFrameSkip(env, n=4, stickprob=0.25)
    if max_episode_steps is not None:
        import gymnasium as gym

        env = gym.wrappers.TimeLimit(env, max_episode_steps=max_episode_steps)
    return env


def wrap_deepmind_retro(env, scale=True, frame_stack=4):
    """WarpFrame and the reward's sign (retro_wrappers.wrap_deepmind_retro); the frames
    are stacked on the device."""
    return ClipRewardEnv(WarpFrame(env))


def make_retro_vec_env(env_id: str, num_envs: int, gamestate=None, frame_stack: int = 4, *,
                       device=None, first_env: int = 0):
    """The retro chain of the game ``env_id`` from ``gamestate`` in a host pool feeding
    the device, frame-stacked there (the ``--gamestate`` surface, run.py:99-101). Raises
    ModuleNotFoundError here, before any worker starts, where retro is missing."""
    import retro  # noqa: F401

    def thunk():
        return wrap_deepmind_retro(make_retro(game=env_id, state=gamestate))

    return atari_vec_env(thunk, num_envs, frame_stack, device=device, first_env=first_env)
