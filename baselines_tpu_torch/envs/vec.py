"""The vector env layer (counterpart of baselines_tpu/envs/vec.py).

    obs, state = venv.reset(draws)                        # obs: (N, ...)
    obs, state, rew, done, info = venv.step(draws, state, actions)

Auto-reset matches the subprocess workers of the reference (subproc_vec_env.py:8-12):
where an env reports done, the returned obs and state are the reset ones, and the
terminal observation is ``info['terminal_obs']``.

Ported: ``VecTorchEnv`` (the batch with auto-reset, of tensor or dict observations),
``VecWrapper``, ``VecMonitor`` with its ``EpisodeStats`` ring of the last 100 episodes,
``VecFrameStack``, ``VecRewardScale``, ``VecNormalize`` with ``find_normalize_state``
and ``replace_normalize_stats``, ``VecS2D`` with the packed 3-D and flat layouts, and
the dict-obs wrappers ``VecExtractDictObs`` and ``VecFlattenDictObs``. Under a
data-parallel mesh (``axis_name``), VecMonitor's ring (after ``VecMonitor.sync_stats``)
and VecNormalize's statistics are those of every rank's envs, held alike by every rank.
A pipelined env pair's state (``envs/host_pipeline.PipeState``) has both groups' monitors merged by
``VecMonitor.get_stats`` and both groups' statistics read and set by the normalize
helpers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, ClassVar

import numpy as np
import torch

from baselines_tpu_torch.core.running_stats import RunningMeanStd
from baselines_tpu_torch.distributed.collectives import all_gather_rows
from baselines_tpu_torch.distributed.mesh import check_mesh
from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.spaces import Box, torch_dtype

EPISODE_BUFFER = 100  # matches deque(maxlen=100) of epinfos, ppo2/ppo2.py:118


def _where_done(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where done else b, with done broadcast over the trailing dims."""
    return torch.where(done.view(done.shape + (1,) * (a.dim() - done.dim())), a, b)


def _select_obs(done, a, b):
    """a where done else b, key by key for dict observations."""
    if isinstance(a, dict):
        return {k: _where_done(done, a[k], b[k]) for k in a}
    return _where_done(done, a, b)


def _select_state(done, reset_state, state):
    """The reset state where done, field by field through nested dataclasses."""
    if not dataclasses.is_dataclass(state):
        return _where_done(done, reset_state, state)
    return dataclasses.replace(state, **{
        f.name: _select_state(done, getattr(reset_state, f.name), getattr(state, f.name))
        for f in dataclasses.fields(state)
    })


def _ring_write(buf: torch.Tensor, slot: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``val`` written at ``slot`` along axis 0; a slot of ``len(buf)``
    drops its value."""
    pad = buf.new_zeros((1,) + tuple(buf.shape[1:]))
    return torch.cat([buf, pad]).index_copy(0, slot, val.to(buf.dtype))[:buf.shape[0]]


@dataclass
class EpisodeStats:
    """Per-env accumulators and a ring of the last 100 completed episodes' returns and
    lengths, all on the device (the info['episode'] pipeline, bench/monitor.py:58-75).

    Under a mesh the accumulators are the rank's envs' and the ring, the count and the
    steps are the whole mesh's, as the JAX package's mesh run replicates them. A step
    only adds the episodes that end on the rank's envs to ``pending``, keyed by step and
    global env; ``sync`` folds every rank's into the ring with one gather, in the order
    one process stepping all the envs writes them. A rank keeps its last 100 pending
    episodes, since the ring keeps no older one."""

    replicated_fields: ClassVar = ("ret_buffer", "len_buffer", "episodes", "total_steps",
                                   "pending", "n_pending", "pending_steps")

    ep_return: torch.Tensor  # (N,) f32
    ep_length: torch.Tensor  # (N,) int32
    ret_buffer: torch.Tensor  # (EPISODE_BUFFER,) f32
    len_buffer: torch.Tensor  # (EPISODE_BUFFER,) f32
    episodes: torch.Tensor  # () int64, total completed
    total_steps: torch.Tensor  # () f32
    pending: torch.Tensor  # (EPISODE_BUFFER, 3) f64: key, return, length; a ring
    n_pending: torch.Tensor  # () int64, the rank's episodes since the last sync
    pending_steps: torch.Tensor  # () int64, the steps since the last sync

    @staticmethod
    def create(num_envs: int, device) -> "EpisodeStats":
        return EpisodeStats(
            ep_return=torch.zeros((num_envs,), dtype=torch.float32, device=device),
            ep_length=torch.zeros((num_envs,), dtype=torch.int32, device=device),
            ret_buffer=torch.zeros((EPISODE_BUFFER,), dtype=torch.float32, device=device),
            len_buffer=torch.zeros((EPISODE_BUFFER,), dtype=torch.float32, device=device),
            episodes=torch.zeros((), dtype=torch.int64, device=device),
            total_steps=torch.zeros((), dtype=torch.float32, device=device),
            pending=torch.zeros((EPISODE_BUFFER, 3), dtype=torch.float64, device=device),
            n_pending=torch.zeros((), dtype=torch.int64, device=device),
            pending_steps=torch.zeros((), dtype=torch.int64, device=device),
        )

    def update(self, reward: torch.Tensor, done: torch.Tensor, mesh=None) -> "EpisodeStats":
        """Fold in a step; with a ``mesh``, the episodes that end on the rank's envs go
        to ``pending`` until the next ``sync``."""
        ep_return = self.ep_return + reward
        ep_length = self.ep_length + 1
        n = done.shape[0]
        order = torch.cumsum(done.to(torch.int64), 0) - 1  # 0-based among dones
        n_done = order[-1] + 1
        # a ring written in env order keeps only the last EPISODE_BUFFER completions of
        # a step; dropping the others up front leaves every kept slot written once
        keep = done & (order >= n_done - EPISODE_BUFFER)
        ring_start = self.episodes if mesh is None else self.n_pending
        slot = torch.where(keep, (ring_start + order) % EPISODE_BUFFER, EPISODE_BUFFER)
        next_return = torch.where(done, torch.zeros_like(ep_return), ep_return)
        next_length = torch.where(done, torch.zeros_like(ep_length), ep_length)
        if mesh is None:
            return dataclasses.replace(
                self,
                ep_return=next_return,
                ep_length=next_length,
                ret_buffer=_ring_write(self.ret_buffer, slot, ep_return),
                len_buffer=_ring_write(self.len_buffer, slot, ep_length.to(torch.float32)),
                episodes=self.episodes + n_done,
                total_steps=self.total_steps + n,
            )
        env = torch.arange(n, device=done.device) + mesh.rank * n
        key = self.pending_steps * (n * mesh.size) + env
        rows = torch.stack([key.to(torch.float64), ep_return.to(torch.float64),
                            ep_length.to(torch.float64)], dim=1)
        return dataclasses.replace(
            self,
            ep_return=next_return,
            ep_length=next_length,
            pending=_ring_write(self.pending, slot, rows),
            n_pending=self.n_pending + n_done,
            pending_steps=self.pending_steps + 1,
            total_steps=self.total_steps + n * mesh.size,
        )

    def sync(self, mesh) -> "EpisodeStats":
        """Every rank's pending episodes folded into the ring, newest last by (step,
        global env), and ``pending`` emptied. Collective: one gather."""
        head = torch.zeros((1, 3), dtype=torch.float64, device=self.pending.device)
        head[0, 0] = self.n_pending
        every = all_gather_rows(torch.cat([head, self.pending])[None], mesh)  # (W, 101, 3)
        counts = every[:, 0, 0].to(torch.int64)
        slots = torch.arange(EPISODE_BUFFER, device=counts.device)
        valid = (slots[None] < counts[:, None]).reshape(-1)
        rows = every[:, 1:].reshape(-1, 3)
        newest_first = torch.argsort(torch.where(valid, rows[:, 0], -1.0), descending=True)
        rows, valid = rows[newest_first], valid[newest_first]
        total = counts.sum()
        age = torch.arange(rows.shape[0], device=rows.device)
        keep = valid & (age < EPISODE_BUFFER)
        slot = torch.where(keep, (self.episodes + total - 1 - age) % EPISODE_BUFFER,
                           EPISODE_BUFFER)
        return dataclasses.replace(
            self,
            ret_buffer=_ring_write(self.ret_buffer, slot, rows[:, 1]),
            len_buffer=_ring_write(self.len_buffer, slot, rows[:, 2]),
            episodes=self.episodes + total,
            pending=torch.zeros_like(self.pending),
            n_pending=torch.zeros_like(self.n_pending),
            pending_steps=torch.zeros_like(self.pending_steps),
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

    def _masked_sum_and_count(self, buf: torch.Tensor):
        valid = torch.clamp(self.episodes, max=EPISODE_BUFFER)
        mask = torch.arange(EPISODE_BUFFER, device=buf.device) < valid
        return torch.where(mask, buf, 0.0).sum(), valid

    def merge(self, other: "EpisodeStats") -> "MergedStats":
        """The recent episodes of two groups as one, weighted by their episode counts:
        the log's view of a pipelined env pair (vec.py:121-135)."""
        rs, rc = self._masked_sum_and_count(self.ret_buffer)
        ros, roc = other._masked_sum_and_count(other.ret_buffer)
        ls, _ = self._masked_sum_and_count(self.len_buffer)
        los, _ = other._masked_sum_and_count(other.len_buffer)
        total = rc + roc
        denom = torch.clamp(total, min=1)
        nan = torch.full_like(rs, float("nan"))
        return MergedStats(mean_return=torch.where(total > 0, (rs + ros) / denom, nan),
                           mean_length=torch.where(total > 0, (ls + los) / denom, nan),
                           episodes=self.episodes + other.episodes)


@dataclass
class MergedStats:
    mean_return: torch.Tensor
    mean_length: torch.Tensor
    episodes: torch.Tensor


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
        new_obs = _select_obs(done, robs, obs)
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

    def close(self):
        """Forwarded down the chain (vec_env.py:140-175), to a host pool's close."""
        close = getattr(self.venv, "close", None)
        if close is not None:
            close()


@dataclass
class MonitorState:
    inner: Any
    stats: EpisodeStats


class VecMonitor(VecWrapper):
    """Episode accounting as device state (vec_monitor.py:7-55). With a mesh
    ``axis_name``, the ring holds every rank's finished episodes once ``sync_stats`` has
    folded them in (``EpisodeStats``); the learners do so after each rollout."""

    def __init__(self, venv, axis_name=None):
        super().__init__(venv)
        check_mesh(axis_name, "VecMonitor's axis_name")
        self.axis_name = axis_name

    def reset(self, draws):
        obs, inner = self.venv.reset(draws)
        return obs, MonitorState(inner, EpisodeStats.create(self.num_envs, self.device))

    def unwrap_state(self, state):
        return state.inner

    def post(self, state, obs, inner, rew, done, info):
        stats = state.stats.update(rew, done, self.axis_name)
        return obs, MonitorState(inner, stats), rew, done, info

    @staticmethod
    def get_stats(state):
        """The EpisodeStats of the chain's monitor; of a pipelined pair's state, both
        groups' merged (``EpisodeStats.merge``)."""
        if hasattr(state, "state_a"):
            return VecMonitor.get_stats(state.state_a).merge(VecMonitor.get_stats(state.state_b))
        while not isinstance(state, MonitorState):
            state = state.inner
        return state.stats

    @staticmethod
    def sync_stats(state, mesh):
        """``state`` with its monitor's pending episodes folded into the ring of every
        rank (``EpisodeStats.sync``), once a rollout; ``state`` itself without a mesh."""
        if mesh is None:
            return state
        if isinstance(state, MonitorState):
            return MonitorState(state.inner, state.stats.sync(mesh))
        return dataclasses.replace(state, inner=VecMonitor.sync_stats(state.inner, mesh))


class VecS2D(VecWrapper):
    """Space-to-depth packing of the observations: (H, W, C) -> (H/b, W/b, b*b*C), so
    the Nature CNN's 8x8/s4 conv1 becomes an exactly equivalent 2x2/s1 conv on
    21x21x64 frames. With ``flat`` each packed frame is one row of H*W*C values, the
    same bytes in the same order, and the space's ``packed_shape`` is the 3-D shape
    (vec.py:364-407): ``cnn_s2d`` and the fused kernel read such rows as views of the
    3-D frames."""

    def __init__(self, venv, block: int = 4, flat: bool = False):
        super().__init__(venv)
        sp = venv.observation_space
        h, w, c = sp.shape
        if h % block or w % block:
            raise ValueError(f"obs {sp.shape} not divisible by s2d block {block}")
        self.block = int(block)
        self.flat = bool(flat)
        packed = (h // block, w // block, block * block * c)
        shape = (int(np.prod(packed)),) if self.flat else packed
        self.observation_space = Box(np.min(sp.low), np.max(sp.high), shape, dtype=sp.dtype)
        if self.flat:
            self.observation_space.packed_shape = packed

    def _pack(self, obs: torch.Tensor) -> torch.Tensor:
        b = self.block
        n, h, w, c = obs.shape
        x = obs.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, -1) if self.flat else x.reshape(n, h // b, w // b, b * b * c)

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


class VecExtractDictObs(VecWrapper):
    """Dict observations projected to one key (vec_env/vec_remove_dict_obs.py:3-10)."""

    def __init__(self, venv, key: str):
        super().__init__(venv)
        self.key = key
        self.observation_space = venv.observation_space[key]

    def reset(self, draws):
        obs, state = self.venv.reset(draws)
        return obs[self.key], state

    def post(self, state, obs, inner, rew, done, info):
        if "terminal_obs" in info:
            info = dict(info, terminal_obs=info["terminal_obs"][self.key])
        return obs[self.key], inner, rew, done, info


class VecFlattenDictObs(VecWrapper):
    """Chosen keys of dict observations concatenated into one flat Box, the
    FlattenDictWrapper(['observation', 'desired_goal']) of make_robotics_env
    (cmd_util.py:124-135), with which the learners other than her train on goal envs
    (vec.py:330-350)."""

    def __init__(self, venv, keys=("observation", "desired_goal")):
        super().__init__(venv)
        self.keys = tuple(keys)
        spaces = [venv.observation_space[k] for k in self.keys]
        if not all(len(sp.shape) == 1 for sp in spaces):
            raise ValueError("VecFlattenDictObs needs 1-D parts")
        dim = sum(sp.shape[0] for sp in spaces)
        self.observation_space = Box(np.full((dim,), -np.inf, np.float32),
                                     np.full((dim,), np.inf, np.float32), (dim,), np.float32)

    def _flat(self, obs: dict) -> torch.Tensor:
        return torch.cat([obs[k] for k in self.keys], dim=-1)

    def reset(self, draws):
        obs, state = self.venv.reset(draws)
        return self._flat(obs), state

    def post(self, state, obs, inner, rew, done, info):
        if "terminal_obs" in info:
            info = dict(info, terminal_obs=self._flat(info["terminal_obs"]))
        return self._flat(obs), inner, rew, done, info


@dataclass
class NormalizeState:
    inner: Any
    ob_rms: RunningMeanStd
    ret_rms: RunningMeanStd
    ret: torch.Tensor  # (N,) f32, the discounted return of each env's episode

    replicated_fields: ClassVar = ("ob_rms", "ret_rms")


class VecNormalize(VecWrapper):
    """Observation and return normalization by running statistics (vec.py:435-516,
    after the reference's vec_normalize.py:4-47). The statistics are part of the env
    state, so they are saved with the train state. ``reset`` folds the reset
    observations into ``ob_rms``; each step folds in the new observations and the
    discounted returns, divides the rewards by the return's standard deviation, and
    moves ``info['terminal_obs']`` into the normalized space, where a replay learner
    stores it beside the observations. With a mesh ``axis_name`` (vec.py:461-504), the
    statistics fold in every rank's envs."""

    def __init__(self, venv, ob: bool = True, ret: bool = True, clipob: float = 10.0,
                 cliprew: float = 10.0, gamma: float = 0.99, epsilon: float = 1e-8,
                 axis_name=None):
        super().__init__(venv)
        check_mesh(axis_name, "VecNormalize's axis_name")
        self.axis_name = axis_name
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
            ob_rms = ob_rms.update(obs, axis_name=self.axis_name)
        ret = torch.zeros((self.num_envs,), dtype=torch.float32, device=obs.device)
        return self._norm_obs(ob_rms, obs), NormalizeState(inner, ob_rms, ret_rms, ret)

    def unwrap_state(self, state):
        return state.inner

    def post(self, state, obs, inner, rew, done, info):
        ob_rms, ret_rms = state.ob_rms, state.ret_rms
        ret = state.ret * self.gamma + rew
        if self.ob:
            ob_rms = ob_rms.update(obs, axis_name=self.axis_name)
        if self.ret_flag:
            ret_rms = ret_rms.update(ret, axis_name=self.axis_name)
            rew = torch.clamp(rew / torch.sqrt(ret_rms.var + self.epsilon), -self.cliprew,
                              self.cliprew)
        ret = torch.where(done, torch.zeros_like(ret), ret)
        new_state = NormalizeState(inner, ob_rms, ret_rms, ret)
        if "terminal_obs" in info:
            info = dict(info, terminal_obs=self._norm_obs(ob_rms, info["terminal_obs"]))
        return self._norm_obs(ob_rms, obs), new_state, rew, done, info


def find_normalize_state(env_state) -> NormalizeState | None:
    """The NormalizeState in a chain of wrapper states, or None when the env is not
    normalized (vec.py:519-532); of a pipelined pair's state, group A's, as the groups'
    statistics are merged after every rollout."""
    while env_state is not None:
        if isinstance(env_state, NormalizeState):
            return env_state
        if hasattr(env_state, "state_a"):
            env_state = env_state.state_a
            continue
        env_state = getattr(env_state, "inner", None)
    return None


def replace_normalize_stats(env_state, ob_rms: RunningMeanStd, ret_rms: RunningMeanStd):
    """``env_state`` with its NormalizeState's statistics swapped for the given ones, and
    as it is when the chain has no NormalizeState (vec.py:535-551); both groups' of a
    pipelined pair's state."""
    if env_state is None:
        return None
    if isinstance(env_state, NormalizeState):
        return dataclasses.replace(env_state, ob_rms=ob_rms, ret_rms=ret_rms)
    if hasattr(env_state, "state_a"):
        return dataclasses.replace(
            env_state, state_a=replace_normalize_stats(env_state.state_a, ob_rms, ret_rms),
            state_b=replace_normalize_stats(env_state.state_b, ob_rms, ret_rms))
    inner = getattr(env_state, "inner", None)
    if inner is None:
        return env_state
    return dataclasses.replace(env_state, inner=replace_normalize_stats(inner, ob_rms, ret_rms))
