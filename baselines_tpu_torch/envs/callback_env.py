"""CallbackVecEnv: a host env pool behind the port's vec interface (counterpart of
baselines_tpu/envs/callback_env.py).

    obs, state = venv.reset(draws)
    obs, state, rew, done, info = venv.step(draws, state, actions)

The JAX package calls its pools from inside a jitted rollout through ordered
``io_callback``s; the port has no jit boundary, so the calls are direct. The actions go
to the pool as numpy arrays and the results come back as tensors on ``device``, the
learner's. The pool auto-resets in its workers (subproc_vec_env.py:8-12); the terminal
observations come back as ``info['terminal_obs']``, the observations where no env was
done, as the device envs give them. ``info_keys`` names per-env scalar infos (goal
envs' ``is_success``) that come back as f32 tensors under their names. 64-bit host
observations (MuJoCo's) come back as f32. The state is the count of steps taken.

``_host_submit`` and ``_host_collect`` are the two legs of a step, which
``envs/host_pipeline.py`` pairs with another group's so that host env time overlaps
device compute.
"""

from __future__ import annotations

import numpy as np
import torch

from baselines_tpu_torch.core.device import resolve_device
from baselines_tpu_torch.envs.spaces import Box, DictSpace


def _downcast_space(space):
    """``space`` with a 64-bit Box turned into an f32 one (callback_env.py:26-39)."""
    if isinstance(space, DictSpace):
        return DictSpace({k: _downcast_space(s) for k, s in space.spaces.items()})
    if space.shape is not None and np.dtype(space.dtype).itemsize == 8:
        return Box(space.low.astype(np.float32), space.high.astype(np.float32), space.shape,
                   np.float32)
    return space


class CallbackVecEnv:
    def __init__(self, host_env, info_keys: tuple = (), device=None):
        self.host = host_env
        self.num_envs = host_env.num_envs
        self.device = resolve_device(device)
        self.observation_space = _downcast_space(host_env.observation_space)
        self.action_space = host_env.action_space
        self.info_keys = tuple(info_keys)

    def _dtype(self, key=None) -> np.dtype:
        space = self.observation_space if key is None else self.observation_space[key]
        return np.dtype(space.dtype)

    def _to_device(self, x: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(self.device)

    def _cast_obs(self, obs):
        """The pool's observations as tensors of the observation space's dtype."""
        if isinstance(self.observation_space, DictSpace):
            return {k: self._to_device(obs[k], self._dtype(k))
                    for k in self.observation_space.spaces}
        return self._to_device(obs, self._dtype())

    @staticmethod
    def _actions(actions) -> np.ndarray:
        """The actions as numpy for the pool; from the card this waits for the work that
        computed them."""
        if isinstance(actions, torch.Tensor):
            return actions.detach().cpu().numpy()
        return np.asarray(actions)

    def _format_results(self, results) -> tuple:
        """The pool's (obs, rewards, dones, infos) as (obs, rew f32, done bool,
        terminal_obs, *info_keys f32), tensors on the device (callback_env.py:76-97)."""
        obs, rew, done, infos = results
        if isinstance(obs, dict):
            terminal_obs = {k: np.array(v) for k, v in obs.items()}
        else:
            terminal_obs = np.array(obs)
        for i, info in enumerate(infos):
            if "terminal_observation" in info:
                tobs = info["terminal_observation"]
                if isinstance(terminal_obs, dict):
                    for k in terminal_obs:
                        terminal_obs[k][i] = tobs[k]
                else:
                    terminal_obs[i] = tobs
        extra = tuple(self._to_device(np.asarray([float(info.get(k, 0.0)) for info in infos]),
                                      np.float32)
                      for k in self.info_keys)
        return (self._cast_obs(obs), self._to_device(rew, np.float32),
                self._to_device(done, bool), self._cast_obs(terminal_obs)) + extra

    def _host_submit(self, actions) -> None:
        """Hand the batch's actions to the pool and return at once (the step_async leg)."""
        self.host.step_async(self._actions(actions))

    def _host_collect(self) -> tuple:
        """Wait for the pool's step (the step_wait leg); the formatted results."""
        return self._format_results(self.host.step_wait())

    def reset(self, draws):
        """Reset the pool with a seed drawn in [0, 2**31 - 1) (callback_env.py:126-131);
        the state is the step count, 0. The seed is one number for the whole mesh: under
        a ``ShardedDraws`` it comes from the replicated draws, so every rank draws what
        the one process draws, and a rank's pool seeds its envs by their global index."""
        seed = int(getattr(draws, "replicated", draws).randint(0, 2**31 - 1, ()))
        return self._cast_obs(self.host.reset(seed)), 0

    def step(self, draws, state, actions):
        obs, rew, done, terminal_obs, *extra = self._format_results(
            self.host.step(self._actions(actions)))
        info = {"terminal_obs": terminal_obs}
        info.update(zip(self.info_keys, extra))
        return obs, state + 1, rew, done, info

    def close(self):
        self.host.close()
