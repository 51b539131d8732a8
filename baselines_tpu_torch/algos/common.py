"""Shared learner scaffolding (counterpart of baselines_tpu/algos/common.py).

- ``build_env``: env id -> the JAX package's wrapper chain for a device env
  ([ClipActions] -> VecTorchEnv -> VecMonitor -> [VecRewardScale] -> [VecNormalize] ->
  [VecFrameStack] -> [VecS2D]).
- ``not_ported``: the error for a reference keyword whose part is not ported yet.
- ``run_rollout``: the T-step rollout, a Python loop where the JAX package scans;
  returns a time-major trajectory and, for a recurrent policy, the carry.
- ``ClipAdam``: clip by global norm, then Adam, then ``p -= lr * u``, with the
  arithmetic of ``optax.chain(clip_by_global_norm, scale_by_adam)`` and
  ``apply_updates_lr``.
- ``Model``: what ``learn`` returns, with ``save``/``load`` of the params and the
  VecNormalize statistics (the ``--save_path`` payload) and ``save_full``/``load_full``
  of the whole train state.
- ``evaluate``: a bounded rollout of a trained model, the ``--play`` report, under the
  statistics the model was trained with, with the carry of a recurrent policy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.envs.base import ClipActions
from baselines_tpu_torch.envs.registry import get_env_type, make_env
from baselines_tpu_torch.envs.spaces import Box
from baselines_tpu_torch.envs.vec import (VecFrameStack, VecMonitor, VecNormalize,
                                          VecRewardScale, VecS2D, VecTorchEnv,
                                          find_normalize_state, replace_normalize_stats)


def not_ported(algo: str, option: str, where: str):
    """Raise for a keyword of the JAX package's ``learn`` whose part is not ported yet,
    naming the item of ROADMAP.md's Queue 1 that brings it."""
    raise NotImplementedError(f"{algo}'s {option} is not ported yet; it comes with {where} "
                              "of ROADMAP.md's Queue 1")


def build_env(env_id: str, num_envs: int, *, device, normalize: bool | None = None,
              reward_scale: float = 1.0, frame_stack: int = 0, s2d: int = 0):
    """The device env's chain of common.py:84-187: ClipActions on a ``Box`` action
    space, VecTorchEnv, VecMonitor, VecRewardScale when ``reward_scale`` != 1 (outside
    the monitor, whose statistics stay raw), VecNormalize when ``normalize`` (None:
    only for mujoco envs), VecFrameStack when ``frame_stack`` > 1, VecS2D when
    ``s2d``."""
    env = make_env(env_id)
    if isinstance(env.action_space, Box):
        env = ClipActions(env)
    venv = VecMonitor(VecTorchEnv(env, num_envs, device))
    if reward_scale != 1.0:
        venv = VecRewardScale(venv, reward_scale)
    if normalize is None:
        normalize = get_env_type(env_id) == "mujoco"
    if normalize:
        venv = VecNormalize(venv)
    if frame_stack and frame_stack > 1:
        venv = VecFrameStack(venv, frame_stack)
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
    """What ``learn`` returns (common.py:429-521): the trained policy, the final train
    state, and the optimizer and draws that the train state leaves out (the params live
    in the policy's module, the Adam moments in the optimizer, the generator in the
    draws)."""

    policy: object
    state: object
    opt: object = None
    draws: object = None

    @property
    def device(self) -> torch.device:
        return next(self.policy.module.parameters()).device

    def initial_rnn_state(self, nenv: int):
        """The policy's zero carry for ``nenv`` envs, None for a feedforward policy."""
        return self.policy.initial_state(nenv)

    def step(self, obs: torch.Tensor, draws, rnn_state=None, done=None):
        """The policy's ``step`` (common.py:447-457): (action, value, neglogp), and with
        a carry ``rnn_state`` the new carry last, the carry masked where ``done`` (no
        env masked when None)."""
        if rnn_state is None:
            return self.policy.step(obs, draws)
        mask = None if done is None else done.to(torch.float32)
        return self.policy.step(obs, draws, None, rnn_state, mask)

    def value(self, obs: torch.Tensor, rnn_state=None, done=None) -> torch.Tensor:
        if rnn_state is None:
            return self.policy.value(obs)
        mask = None if done is None else done.to(torch.float32)
        return self.policy.value(obs, None, rnn_state, mask)

    def _normalize_state(self):
        """The NormalizeState of the training env's state, or None when the env is not
        normalized."""
        return find_normalize_state(getattr(self.state, "env_state", None))

    def save(self, path: str) -> None:
        """The ``--save_path`` payload (common.py:464-478): the policy module's params,
        and the VecNormalize statistics when the training env was normalized, so a model
        replayed in a fresh process sees its observations scaled as in training."""
        payload = {"model_params": self.policy.module}
        ns = self._normalize_state()
        if ns is not None:
            payload["norm_ob_rms"] = ns.ob_rms
            payload["norm_ret_rms"] = ns.ret_rms
        ckpt.save_state(path, payload)

    def load(self, path: str) -> "Model":
        """Load ``save``'s payload: the params, and the VecNormalize statistics into the
        train state's env state where both the file and the env have them
        (common.py:480-509)."""
        tree = ckpt.load_state(path, map_location=self.device)
        ckpt.from_tree(tree["model_params"], self.policy.module, "model_params")
        ns = self._normalize_state()
        if "norm_ob_rms" in tree and ns is not None:
            ob_rms = ckpt.from_tree(tree["norm_ob_rms"], ns.ob_rms, "norm_ob_rms")
            ret_rms = ckpt.from_tree(tree["norm_ret_rms"], ns.ret_rms, "norm_ret_rms")
            self.state = dataclasses.replace(self.state, env_state=replace_normalize_stats(
                self.state.env_state, ob_rms, ret_rms))
        return self

    def _train_tree(self) -> dict:
        tree = {"params": self.policy.module, "state": self.state, "opt": self.opt,
                "rng": self.draws}
        return {k: v for k, v in tree.items() if v is not None}

    def save_full(self, path: str) -> None:
        """The whole train state: params, optimizer moments and count, the learner's
        state (env state, observations, counters, replay) and the generator's state."""
        ckpt.save_state(path, self._train_tree())

    def load_full(self, path: str) -> "Model":
        self.state = ckpt.load_state(path, self._train_tree(), map_location=self.device)["state"]
        return self


@torch.no_grad()
def run_rollout(policy, venv, draws, env_state, obs, last_done, nsteps: int, rnn_state=None):
    """nsteps of policy.step + venv.step (common.py:207-251).

    Returns (env_state, obs, last_done, traj, last_value, rnn_state). The policy's kernel
    weights are packed once here and serve every step. The actions are stored as
    sampled, in the shape and dtype of the policy's ``PdType`` (a Gaussian sample
    unclipped, with the ``neglogp`` of that sample); the env chain clips what it steps
    with. A recurrent policy carries ``rnn_state`` from step to step, masked where the
    env was done before the step (``traj.rnn_masks``); a feedforward one leaves it None."""
    packed = policy.pack()
    n, dev = venv.num_envs, obs.device
    pdtype = policy.pdtype

    def buf(shape=(), dtype=torch.float32):
        return torch.empty((nsteps, n) + tuple(shape), dtype=dtype, device=dev)

    traj = Trajectory(
        obs=buf(obs.shape[1:], obs.dtype),
        actions=buf(pdtype.sample_shape, pdtype.sample_dtype), values=buf(),
        neglogps=buf(), rewards=buf(), dones=buf(dtype=torch.bool), rnn_masks=buf(),
    )
    for t in range(nsteps):
        mask = last_done.to(torch.float32)
        if rnn_state is None:
            action, value, neglogp = policy.step(obs, draws, packed)
        else:
            action, value, neglogp, rnn_state = policy.step(obs, draws, packed, rnn_state, mask)
        nobs, env_state, rew, ndone, _ = venv.step(draws, env_state, action)
        traj.obs[t] = obs
        traj.actions[t] = action
        traj.values[t] = value
        traj.neglogps[t] = neglogp
        traj.rewards[t] = rew
        traj.dones[t] = ndone
        traj.rnn_masks[t] = mask
        obs, last_done = nobs, ndone
    last_value = policy.value(obs, packed, rnn_state, last_done.to(torch.float32))
    return env_state, obs, last_done, traj, last_value, rnn_state


@torch.no_grad()
def evaluate(model: Model, venv, draws, nsteps: int = 1000, deterministic: bool = True):
    """Roll the model's policy for ``nsteps`` from a reset of ``venv`` and report the
    monitor's (mean episode return, mean episode length, episodes) (common.py:523-566).
    ``deterministic`` takes ``mode_step``'s action, else ``step``'s sample; a recurrent
    policy starts from the zero carry and is masked where an env was done before the
    step. When the model trained on a normalized env and ``venv`` is normalized too, its
    VecNormalize starts from the trained statistics, so the reset's observations are
    already normalized by them."""
    policy = model.policy
    trained = model._normalize_state()
    if trained is not None:
        w = venv
        while w is not None:
            if isinstance(w, VecNormalize):
                w.init_stats = (trained.ob_rms, trained.ret_rms)
                break
            w = getattr(w, "venv", None)
    obs, env_state = venv.reset(draws)
    recurrent = getattr(policy, "is_recurrent", False)  # deepq's QPolicy has no carry
    rnn_state = policy.initial_state(venv.num_envs) if recurrent else None
    done = torch.zeros((venv.num_envs,), dtype=torch.bool, device=obs.device)
    for _ in range(nsteps):
        if recurrent:
            mask = done.to(torch.float32)
            if deterministic:
                action, _, rnn_state = policy.mode_step(obs, None, rnn_state, mask)
            else:
                action, _, _, rnn_state = policy.step(obs, draws, None, rnn_state, mask)
        elif deterministic:
            action = policy.mode_step(obs)[0]
        else:
            action = policy.step(obs, draws)[0]
        obs, env_state, _, done, _ = venv.step(draws, env_state, action)
    stats = VecMonitor.get_stats(env_state)
    return float(stats.mean_return), float(stats.mean_length), int(stats.episodes)


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

    def state_dict(self) -> dict:
        """The moments and the step count, which sets the bias corrections."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for mine, theirs in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            mine.copy_(theirs)
        self.count = int(state["count"])

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
