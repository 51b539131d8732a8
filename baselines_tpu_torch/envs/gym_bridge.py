"""Host env pools over gymnasium envs (counterpart of baselines_tpu/envs/gym_bridge.py).

- ``HostDummyVecEnv`` ≙ DummyVecEnv (common/vec_env/dummy_vec_env.py:5-81): the envs
  step one after another in this process, each auto-reset on done.
- ``HostSubprocVecEnv`` ≙ SubprocVecEnv (subproc_vec_env.py), ``in_series`` envs a
  worker (:44-58), daemon workers (:63-64), auto-reset inside the worker (:8-12).
- ``HostShmemVecEnv`` ≙ ShmemVecEnv (shmem_vec_env.py:20-141): the observations come
  back through shared memory, the pipe carries only rewards, dones and infos.
- ``host_pool`` picks the Subproc pool for more than one env, the Dummy one for one.
- ``GymAdapter`` folds gymnasium's (terminated, truncated) into the one done of the
  gym-0.x API the reference is written against and keeps the Monitor's episode
  accounting (bench/monitor.py:10-94) as ``info['episode']`` on done.

Every pool has the ``HostVecEnv`` interface: ``reset(seed) -> obs`` and ``step(actions)
-> (obs, rewards, dones, infos)`` on numpy arrays, split into ``step_async`` and
``step_wait``. A reset seeds env i with ``seed + first_env + i``: ``first_env`` is the
global index of the pool's first env, nonzero for a rank of a mesh, whose pool holds
envs ``first_env .. first_env + num_envs - 1`` of the one-process run.
``envs/callback_env.py`` puts a pool behind the port's vec interface.

The workers start with ``fork`` by default and receive numpy actions only: they build
their envs after the fork and never touch torch, so a live CUDA context in the parent
does not reach them. gymnasium and cloudpickle are imported where they are used, so
this module imports where they are missing.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from typing import Callable, List

import numpy as np

from baselines_tpu_torch.core.tile_images import tile_images
from baselines_tpu_torch.envs.spaces import Box, DictSpace, Discrete, Space


def convert_space(space):
    """A gymnasium space as the port's space; one of the port's own as it is (a stand-in
    env, or a wrapper that declares the port's spaces, needs no gymnasium)."""
    if isinstance(space, Space):
        return space
    import gymnasium as gym

    if isinstance(space, gym.spaces.Discrete):
        return Discrete(int(space.n))
    if isinstance(space, gym.spaces.Box):
        return Box(space.low, space.high, space.shape, space.dtype)
    if isinstance(space, gym.spaces.Dict):
        return DictSpace({k: convert_space(s) for k, s in space.spaces.items()})
    raise NotImplementedError(f"unsupported host space {space}")


def stack_obs(obs_list):
    """The envs' observations stacked, key by key for dict observations (vec_env
    util.py:11-62)."""
    if isinstance(obs_list[0], dict):
        return {k: np.stack([o[k] for o in obs_list]) for k in obs_list[0]}
    return np.stack(obs_list)


class GymAdapter:
    """The gym-0.x (obs, reward, done, info) view of a gymnasium env, with the Monitor's
    episode accounting; on done the info holds ``episode``, ``terminal_observation`` and,
    for a truncation, ``TimeLimit.truncated``, and the env is reset."""

    def __init__(self, env):
        self.env = env
        self.observation_space = convert_space(env.observation_space)
        self.action_space = convert_space(env.action_space)
        self._ep_ret = 0.0
        self._ep_len = 0
        self._t0 = time.time()

    def reset(self, seed=None):
        obs, _ = self.env.reset(seed=seed)
        self._ep_ret, self._ep_len = 0.0, 0
        return obs

    def step(self, action):
        obs, rew, terminated, truncated, info = self.env.step(action)
        done = bool(terminated or truncated)
        self._ep_ret += float(rew)
        self._ep_len += 1
        if done:  # the Monitor's contract (monitor.py:58-75)
            info = dict(info)
            info["episode"] = {"r": self._ep_ret, "l": self._ep_len,
                               "t": round(time.time() - self._t0, 6)}
            if truncated and not terminated:
                info["TimeLimit.truncated"] = True
            info["terminal_observation"] = obs
            obs = self.reset()
        return obs, float(rew), done, info

    def render(self):
        return self.env.render()

    def close(self):
        self.env.close()


class HostVecEnv:
    """A pool's interface: ``reset(seed) -> obs (N, ...)``; ``step(actions) -> (obs,
    rewards, dones, infos)``, and the same split into ``step_async`` and ``step_wait``
    (vec_env.py:29-108). This base class steps at ``step_async`` and hands the result
    over at ``step_wait``; the process pools step while the caller computes."""

    num_envs: int
    observation_space: object
    action_space: object
    _sync_result = None

    def reset(self, seed=None):
        raise NotImplementedError

    def step(self, actions):
        raise NotImplementedError

    def step_async(self, actions):
        self._sync_result = self.step(actions)

    def step_wait(self):
        result, self._sync_result = self._sync_result, None
        return result

    def render(self):
        """The member envs' rgb frames tiled into one (VecEnv.render's 'rgb_array' mode,
        vec_env.py:110-121); the envs must be made with render_mode='rgb_array'."""
        raise NotImplementedError

    def close(self):
        pass


class HostDummyVecEnv(HostVecEnv):
    def __init__(self, env_fns: List[Callable], first_env: int = 0):
        self.envs = [GymAdapter(fn()) for fn in env_fns]
        self.num_envs = len(self.envs)
        self.first_env = int(first_env)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def reset(self, seed=None):
        return stack_obs([e.reset(None if seed is None else seed + self.first_env + i)
                          for i, e in enumerate(self.envs)])

    def step(self, actions):
        results = [e.step(a) for e, a in zip(self.envs, actions)]
        obs, rews, dones, infos = zip(*results)
        return (stack_obs(list(obs)), np.asarray(rews, np.float32), np.asarray(dones, bool),
                list(infos))

    def render(self):
        return tile_images([e.render() for e in self.envs])

    def close(self):
        for e in self.envs:
            e.close()


def _subproc_worker(remote, parent_remote, env_fn_wrappers):
    """A worker's loop (subproc_vec_env.py:7-36): its envs, stepped on command."""
    parent_remote.close()
    envs = [GymAdapter(fn()) for fn in env_fn_wrappers.x]
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                remote.send([env.step(a) for env, a in zip(envs, data)])
            elif cmd == "reset":
                remote.send([env.reset(None if data is None else data + j)
                             for j, env in enumerate(envs)])
            elif cmd == "render":
                remote.send([env.render() for env in envs])
            elif cmd == "get_spaces":
                remote.send((envs[0].observation_space, envs[0].action_space))
            elif cmd == "close":
                remote.close()
                break
    except KeyboardInterrupt:
        pass
    finally:
        for env in envs:
            env.close()


class _CloudpickleWrapper:
    """Pickles its contents with cloudpickle (vec_env.py:190-204): env thunks are often
    lambdas. Under ``fork`` the process arguments are not pickled at all."""

    def __init__(self, x):
        self.x = x

    def __getstate__(self):
        import cloudpickle

        return cloudpickle.dumps(self.x)

    def __setstate__(self, ob):
        import pickle

        self.x = pickle.loads(ob)


class HostSubprocVecEnv(HostVecEnv):
    def __init__(self, env_fns, in_series: int = 1, context: str = "fork",
                 first_env: int = 0):
        self.num_envs = len(env_fns)
        self.first_env = int(first_env)
        if self.num_envs % in_series:
            raise ValueError(f"in_series {in_series} does not divide {self.num_envs} envs")
        self.in_series = in_series
        self.nremotes = self.num_envs // in_series
        chunks = [env_fns[i * in_series:(i + 1) * in_series] for i in range(self.nremotes)]
        ctx = mp.get_context(context)
        self.remotes, self.work_remotes = zip(*[ctx.Pipe() for _ in range(self.nremotes)])
        self.ps = [ctx.Process(target=_subproc_worker,
                               args=(work_remote, remote, _CloudpickleWrapper(chunk)))
                   for work_remote, remote, chunk in zip(self.work_remotes, self.remotes,
                                                         chunks)]
        for p in self.ps:
            p.daemon = True  # a crashed parent must not hang (subproc_vec_env.py:63-64)
            p.start()
        for remote in self.work_remotes:
            remote.close()
        self.remotes[0].send(("get_spaces", None))
        self.observation_space, self.action_space = self.remotes[0].recv()

    def reset(self, seed=None):
        for i, remote in enumerate(self.remotes):
            remote.send(("reset", None if seed is None
                         else seed + self.first_env + i * self.in_series))
        return stack_obs([o for remote in self.remotes for o in remote.recv()])

    def step_async(self, actions):
        """Send the actions and return at once: the workers step while the caller
        computes (subproc_vec_env.py:75-80)."""
        for remote, chunk in zip(self.remotes, np.array_split(np.asarray(actions),
                                                              self.nremotes)):
            remote.send(("step", chunk))

    def step_wait(self):
        """Wait for the workers' results (subproc_vec_env.py:82-88)."""
        results = [r for remote in self.remotes for r in remote.recv()]
        obs, rews, dones, infos = zip(*results)
        return (stack_obs(list(obs)), np.asarray(rews, np.float32), np.asarray(dones, bool),
                list(infos))

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def render(self):
        for remote in self.remotes:
            remote.send(("render", None))
        return tile_images([f for remote in self.remotes for f in remote.recv()])

    def close(self):
        for remote in self.remotes:
            try:
                remote.send(("close", None))
            except BrokenPipeError:
                pass
        for p in self.ps:
            p.join(timeout=1)


class HostShmemVecEnv(HostSubprocVecEnv):
    """One worker an env whose observations come back through a shared array
    (shmem_vec_env.py:20-141); the pipe carries the rewards, dones and infos. Flat
    observations only."""

    def __init__(self, env_fns, context: str = "fork", first_env: int = 0):
        self.first_env = int(first_env)
        probe = GymAdapter(env_fns[0]())
        obs_space = probe.observation_space
        probe.close()
        if obs_space.shape is None:
            raise ValueError("HostShmemVecEnv moves one flat array; use HostDummyVecEnv or "
                             "HostSubprocVecEnv for dict observations")
        self._obs_shape = obs_space.shape
        self._obs_dtype = np.dtype(obs_space.dtype)
        typecode = {np.dtype(np.uint8): "B", np.dtype(np.float32): "f",
                    np.dtype(np.float64): "d", np.dtype(np.int32): "i"}[self._obs_dtype]
        ctx = mp.get_context(context)
        n = len(env_fns)
        size = int(np.prod(self._obs_shape))
        self.shm_bufs = [ctx.Array(typecode, size, lock=False) for _ in range(n)]
        self.num_envs = self.nremotes = n
        self.in_series = 1
        self.remotes, self.work_remotes = zip(*[ctx.Pipe() for _ in range(n)])
        self.ps = [ctx.Process(target=_shmem_worker,
                               args=(wr, r, _CloudpickleWrapper(fn), buf, self._obs_shape,
                                     self._obs_dtype.str))
                   for wr, r, fn, buf in zip(self.work_remotes, self.remotes, env_fns,
                                             self.shm_bufs)]
        for p in self.ps:
            p.daemon = True
            p.start()
        for remote in self.work_remotes:
            remote.close()
        self.remotes[0].send(("get_spaces", None))
        self.observation_space, self.action_space = self.remotes[0].recv()

    def _read_obs(self):
        return np.stack([np.frombuffer(buf, dtype=self._obs_dtype).reshape(self._obs_shape)
                         for buf in self.shm_bufs])

    def reset(self, seed=None):
        for i, remote in enumerate(self.remotes):
            remote.send(("reset", None if seed is None else seed + self.first_env + i))
        for remote in self.remotes:
            remote.recv()
        return self._read_obs()

    def step_async(self, actions):
        for remote, a in zip(self.remotes, actions):
            remote.send(("step", a))

    def step_wait(self):
        rews, dones, infos = zip(*[remote.recv() for remote in self.remotes])
        return (self._read_obs(), np.asarray(rews, np.float32), np.asarray(dones, bool),
                list(infos))

    def render(self):
        raise NotImplementedError("HostShmemVecEnv does not render, as in the JAX package")


def _shmem_worker(remote, parent_remote, env_fn_wrapper, shm_buf, obs_shape, obs_dtype):
    """A shared-memory worker (shmem_vec_env.py:107-141): the observation goes into the
    shared array."""
    parent_remote.close()
    env = GymAdapter(env_fn_wrapper.x())
    arr = np.frombuffer(shm_buf, dtype=np.dtype(obs_dtype)).reshape(obs_shape)
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                obs, rew, done, info = env.step(data)
                arr[...] = obs
                remote.send((rew, done, info))
            elif cmd == "reset":
                arr[...] = env.reset(data)
                remote.send(None)
            elif cmd == "get_spaces":
                remote.send((env.observation_space, env.action_space))
            elif cmd == "close":
                remote.close()
                break
    except KeyboardInterrupt:
        pass
    finally:
        env.close()


def host_pool(thunk, num_envs: int, first_env: int = 0) -> HostVecEnv:
    """``num_envs`` envs of ``thunk``: worker processes for more than one, the env in
    this process for one (cmd_util.py:56-59); ``first_env`` is the global index of the
    pool's first env."""
    if num_envs > 1:
        return HostSubprocVecEnv([thunk] * num_envs, first_env=first_env)
    return HostDummyVecEnv([thunk], first_env=first_env)
