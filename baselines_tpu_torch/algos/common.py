"""Shared learner scaffolding (counterpart of baselines_tpu/algos/common.py).

- ``build_env``: env id -> monitored vector env (VecTorchEnv -> VecMonitor -> VecS2D).
- ``run_rollout``: the T-step rollout, a Python loop where the JAX package scans;
  returns a time-major trajectory.
- ``ClipAdam``: clip by global norm, then Adam, then ``p -= lr * u``, with the
  arithmetic of ``optax.chain(clip_by_global_norm, scale_by_adam)`` and
  ``apply_updates_lr``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from baselines_tpu_torch.envs.registry import make_env
from baselines_tpu_torch.envs.vec import VecMonitor, VecS2D, VecTorchEnv


def build_env(env_id: str, num_envs: int, *, device, s2d: int = 0):
    """VecTorchEnv -> VecMonitor -> [VecS2D] (common.py:84-187 for a device env)."""
    venv = VecMonitor(VecTorchEnv(make_env(env_id), num_envs, device))
    if s2d:
        if s2d < 2:
            raise ValueError(f"--s2d must be a block size >= 2, got {s2d}")
        venv = VecS2D(venv, s2d)
    return venv


@dataclass
class Trajectory:
    """Time-major (T, N, ...) rollout record."""

    obs: torch.Tensor
    actions: torch.Tensor
    values: torch.Tensor
    neglogps: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor  # done AT step t (obs_{t+1} is a reset obs)
    rnn_masks: torch.Tensor  # done BEFORE step t, (T, N) f32


@dataclass
class Model:
    """What ``learn`` returns: the trained policy and the final train state."""

    policy: object
    state: object


@torch.no_grad()
def run_rollout(policy, venv, draws, env_state, obs, last_done, nsteps: int):
    """nsteps of policy.step + venv.step (common.py:207-251).

    Returns (env_state, obs, last_done, traj, last_value). The policy's kernel weights
    are packed once here and serve every step."""
    packed = policy.pack()
    n, dev = venv.num_envs, obs.device

    def buf(shape=(), dtype=torch.float32):
        return torch.empty((nsteps, n) + tuple(shape), dtype=dtype, device=dev)

    traj = Trajectory(
        obs=buf(obs.shape[1:], obs.dtype), actions=buf(dtype=torch.int32), values=buf(),
        neglogps=buf(), rewards=buf(), dones=buf(dtype=torch.bool), rnn_masks=buf(),
    )
    for t in range(nsteps):
        mask = last_done.to(torch.float32)
        action, value, neglogp = policy.step(obs, draws, packed)
        nobs, env_state, rew, ndone, _ = venv.step(draws, env_state, action)
        traj.obs[t] = obs
        traj.actions[t] = action
        traj.values[t] = value
        traj.neglogps[t] = neglogp
        traj.rewards[t] = rew
        traj.dones[t] = ndone
        traj.rnn_masks[t] = mask
        obs, last_done = nobs, ndone
    last_value = policy.value(obs, packed)
    return env_state, obs, last_done, traj, last_value


class ClipAdam:
    """Clip-then-Adam with the learning rate given at each step (ppo2/model.py:97-116
    order), matching optax: clip by global norm as ``g if norm < max else g / norm *
    max`` (no epsilon), then ``scale_by_adam`` with f32 bias corrections, then
    ``p -= lr * u``."""

    b1, b2 = 0.9, 0.999  # optax's defaults, which ppo2 keeps

    def __init__(self, params, max_grad_norm: float | None, eps: float = 1e-5):
        self.params = list(params)
        self.max_grad_norm = max_grad_norm
        self.eps = eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads, lr: float) -> None:
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < self.max_grad_norm
            grads = [torch.where(trigger, g, g / g_norm * self.max_grad_norm) for g in grads]
        self.count += 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1.to(p.device)) / (torch.sqrt(nu / bc2.to(p.device)) + self.eps)
            p.sub_(lr * u)
