"""The pipelined (double-buffered) host env pair (counterpart of
baselines_tpu/envs/host_pipeline.py).

The reference hides env latency behind worker processes with its step_async/step_wait
split (subproc_vec_env.py:75-88), but its runner is serial: model.step, then env.step
(ppo2/runner.py:29-40). Here the envs are two groups stepped in antiphase: while group
A's envs step on the host, the device computes group B's actions, and the other way
round. Each phase submits one group's actions (step_async) and collects the other
group's results (step_wait), so a step of the pair costs the host calls of one group's
step while host env time and device policy time overlap. Within a rollout every action
is computed from its group's current observation; group B's transitions arrive one
phase later. Across an update one group-B transition a env is in flight, acted and
valued with the params before the update: its stored neglogp is the behaviour policy's,
so the ratio stays a correct importance weight, and only that row's value bootstrap is
one update old. ppo2 turns pipelining on for host envs; ``pipeline=False`` keeps the
serial rollout.

Any pool with step_async/step_wait works (``HostSubprocVecEnv``, ``HostShmemVecEnv``,
the native engine's thread), under any chain of vec wrappers: the wrappers are pure
post-transforms (``VecWrapper.post``), replayed on the collect leg by
``collect_through``. The JAX package calls these phases through ordered
``io_callback``s; here they are direct calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from baselines_tpu_torch.envs.callback_env import CallbackVecEnv
from baselines_tpu_torch.envs.vec import VecMonitor, VecWrapper


def base_callback_env(venv) -> CallbackVecEnv:
    """The CallbackVecEnv under a chain of vec wrappers; anything else fails, as
    pipelining needs a host-backed env."""
    v = venv
    while isinstance(v, VecWrapper):
        v = v.venv
    if not isinstance(v, CallbackVecEnv):
        raise AssertionError(f"pipelining needs a host-backed env, got {type(v)}")
    return v


def collect_through(venv, state, base_results):
    """One collected base step through the chain's post-transforms (the collect half of
    VecWrapper.step): (obs, state, rew, done, info)."""
    if isinstance(venv, VecWrapper):
        obs, inner, rew, done, info = collect_through(venv.venv, venv.unwrap_state(state),
                                                      base_results)
        return venv.post(state, obs, inner, rew, done, info)
    obs, rew, done, terminal_obs = base_results
    return obs, state + 1, rew, done, {"terminal_obs": terminal_obs}


@dataclass
class PipeState:
    """What a pipelined rollout carries: both groups' env states, A's current
    observation, and B's step in flight (the observation it acted on, its action, value
    and neglogp)."""

    state_a: Any
    state_b: Any
    obs_a: torch.Tensor  # group A's current obs (A idle)
    pend_obs_b: torch.Tensor  # the obs of B's step in flight
    pend_act_b: torch.Tensor
    pend_val_b: torch.Tensor
    pend_nlp_b: torch.Tensor
    # the done flags of the groups' last completed steps; for B also the rnn-mask
    # lineage of the pending transition (mask at step t = done at t-1, a2c/utils.py:88-91)
    last_done_a: torch.Tensor
    last_done_b: torch.Tensor


class PipelinedHostVecPair:
    """Two host-backed env chains of equal size, stepped in antiphase."""

    def __init__(self, venv_a, venv_b):
        if venv_a.num_envs != venv_b.num_envs:
            raise AssertionError("groups must be equal-sized")
        self.a = venv_a
        self.b = venv_b
        self.base_a = base_callback_env(venv_a)
        self.base_b = base_callback_env(venv_b)
        self.num_envs = venv_a.num_envs + venv_b.num_envs
        self.observation_space = venv_a.observation_space
        self.action_space = venv_a.action_space

    def submit_b(self, actions) -> None:
        """Start group B's step (the priming of init_pipe_state)."""
        self.base_b._host_submit(actions)

    def swap_ab(self, actions_a) -> tuple:
        """Submit group A's step, then wait for group B's in flight: A's envs step while
        the caller's next device work runs. B's formatted results."""
        self.base_a._host_submit(actions_a)
        return self.base_b._host_collect()

    def swap_ba(self, actions_b) -> tuple:
        self.base_b._host_submit(actions_b)
        return self.base_a._host_collect()

    @staticmethod
    def get_stats(pipe_state: PipeState):
        """Both groups' episode statistics merged, weighted by their episode counts."""
        return VecMonitor.get_stats(pipe_state.state_a).merge(
            VecMonitor.get_stats(pipe_state.state_b))

    def close(self) -> None:
        for v in (self.a, self.b):
            close = getattr(v, "close", None)
            if close is not None:
                close()
