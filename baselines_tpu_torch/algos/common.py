"""Shared learner scaffolding (counterpart of baselines_tpu/algos/common.py).

- ``build_env``: env id -> the JAX package's wrapper chain for a device env
  ([ClipActions] -> VecTorchEnv -> [VecFlattenDictObs] -> VecMonitor -> [VecRewardScale]
  -> [VecNormalize] -> [VecFrameStack] -> [VecS2D]), the monitor and the normalization
  across the ranks of a mesh ``axis_name``.
- ``not_ported``: the error for a reference keyword whose part is not ported yet.
- ``run_rollout``: the T-step rollout, a Python loop where the JAX package scans;
  returns a time-major trajectory and, for a recurrent policy, the carry.
- ``ClipAdam`` and ``ClipRMSProp``: clip by global norm, then Adam or RMSProp, then
  ``p -= lr * u``, with the arithmetic of ``optax.chain(clip_by_global_norm,
  scale_by_adam)`` or ``scale_by_rms`` and ``apply_updates_lr``; under a mesh the
  gradients are first averaged over the ranks, so the norm is the global gradient's.
- ``learner_device``, ``update_metrics`` and ``mesh_metrics``: a learner's device, and
  an update's metrics, under a mesh the rank's shares, reduced over the ranks only on
  the updates that log.
- ``Model``: what ``learn`` returns, with ``save``/``load`` of the params and the
  VecNormalize statistics (the ``--save_path`` payload) and ``save_full``/``load_full``
  of the whole train state, in a one-process layout also under a mesh.
- ``evaluate``: a bounded rollout of a trained model, the ``--play`` report, under the
  statistics the model was trained with, with the carry of a recurrent policy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core.device import resolve_device
from baselines_tpu_torch.core.math import explained_variance, global_norm
from baselines_tpu_torch.distributed.collectives import all_gather_rows, merged_moments, pmean
from baselines_tpu_torch.distributed.mesh import barrier, gather_state, shard_state
from baselines_tpu_torch.envs.base import ClipActions
from baselines_tpu_torch.envs.registry import get_env_type, make_env
from baselines_tpu_torch.envs.spaces import Box, DictSpace
from baselines_tpu_torch.envs.vec import (VecFlattenDictObs, VecFrameStack, VecMonitor,
                                          VecNormalize, VecRewardScale, VecS2D, VecTorchEnv,
                                          find_normalize_state, replace_normalize_stats)


def not_ported(algo: str, option: str, where: str):
    """Raise for a keyword of the JAX package's ``learn`` whose part is not ported yet,
    naming the item of ROADMAP.md's Queue 1 that brings it."""
    raise NotImplementedError(f"{algo}'s {option} is not ported yet; it comes with {where} "
                              "of ROADMAP.md's Queue 1")


def build_env(env_id: str, num_envs: int, *, device, normalize: bool | None = None,
              reward_scale: float = 1.0, frame_stack: int = 0, s2d: int = 0,
              axis_name=None, keep_dict_obs: bool = False):
    """The device env's chain of common.py:84-187: ClipActions on a ``Box`` action
    space, VecTorchEnv, VecFlattenDictObs on dict observations unless ``keep_dict_obs``
    (her reads the dicts; the other learners see observation ++ desired_goal, as the
    JAX package's host goal envs give them, common.py:72-80), VecMonitor,
    VecRewardScale when ``reward_scale`` != 1 (outside the monitor, whose statistics stay
    raw), VecNormalize when ``normalize`` (None: only for mujoco envs), VecFrameStack
    when ``frame_stack`` > 1, VecS2D when ``s2d``. Under a mesh ``axis_name``,
    ``num_envs`` is the rank's envs, and the monitor and the normalization take every
    rank's."""
    env = make_env(env_id)
    if isinstance(env.action_space, Box):
        env = ClipActions(env)
    venv = VecTorchEnv(env, num_envs, device)
    if not keep_dict_obs and isinstance(venv.observation_space, DictSpace):
        venv = VecFlattenDictObs(venv)
    venv = VecMonitor(venv, axis_name=axis_name)
    if reward_scale != 1.0:
        venv = VecRewardScale(venv, reward_scale)
    if normalize is None:
        normalize = get_env_type(env_id) == "mujoco"
    if normalize:
        venv = VecNormalize(venv, axis_name=axis_name)
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


def learner_device(mesh, device) -> torch.device:
    """The device a learner runs on: the mesh's under a mesh (``device``, when given,
    must name the same), else ``resolve_device(device)``."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device={device!r} differs from the mesh's device {mesh.device}")
    return mesh.device


def update_metrics(metrics: dict, ypred: torch.Tensor, y: torch.Tensor, mesh) -> dict:
    """An update's ``metrics`` (the means of its loss terms) with the explained variance
    of ``ypred`` for ``y``. Under a mesh both are the rank's shares: ``explained_variance``
    is left as the moments of the rank's shard under ``"ev_moments"``, for
    ``mesh_metrics`` to merge on the updates that log."""
    if mesh is None:
        return dict(metrics, explained_variance=explained_variance(ypred, y))
    y = y.reshape(-1).to(torch.float32)
    d = y - ypred.reshape(-1).to(torch.float32)
    moments = torch.stack([y.mean(), d.mean(), torch.var(y, correction=0),
                           torch.var(d, correction=0)])
    return dict(metrics, ev_moments=moments)


def mesh_metrics(metrics: dict, mesh) -> dict:
    """The whole mesh's metrics from a rank's ``update_metrics``, in one gather: each
    tensor metric's mean over the ranks' equal-size shares, and ``explained_variance``
    over the global batch from the ranks' merged moments (math_util.py:29-47: nan where
    Var[y] is 0). Collective; without a mesh the metrics come back as they are."""
    if mesh is None:
        return metrics
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor) and k != "ev_moments"]
    local = torch.cat([torch.stack([metrics[k] for k in names]), metrics["ev_moments"]])
    every = all_gather_rows(local[None], mesh)  # (size, len(names) + 4)
    means = dict(zip(names, every[:, :len(names)].mean(dim=0).unbind()))
    _, (vary, vard) = merged_moments(every[:, len(names):len(names) + 2],
                                     every[:, len(names) + 2:])
    ev = 1.0 - vard / vary
    ev = torch.where(vary == 0, torch.full_like(ev, float("nan")), ev)
    out = {}
    for k, v in metrics.items():
        if k == "ev_moments":
            out["explained_variance"] = ev
        else:
            out[k] = means.get(k, v)
    return out


@dataclass
class Model:
    """What ``learn`` returns (common.py:429-521): the trained policy, the final train
    state, and the optimizer and draws that the train state leaves out (the params live
    in the policy's module, the Adam moments in the optimizer, the generator in the
    draws). Under a data-parallel ``mesh`` the state holds the rank's envs."""

    policy: object
    state: object
    opt: object = None
    draws: object = None
    mesh: object = None

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
        state (env state, observations, counters, replay) and the generator's state.
        Under a mesh it is collective: the ranks' env rows are gathered and rank 0
        writes the file of a one-process run."""
        tree = self._train_tree()
        if self.mesh is not None:
            tree["state"] = gather_state(self.state, self.mesh)
        save_from_rank0(path, tree, self.mesh)

    def load_full(self, path: str) -> "Model":
        """``save_full``'s file back; under a mesh it is collective, and each rank keeps
        its env rows."""
        tree = self._train_tree()
        if self.mesh is not None:  # a template of the whole state's shapes
            tree["state"] = gather_state(self.state, self.mesh)
        state = ckpt.load_state(path, tree, map_location=self.device)["state"]
        self.state = state if self.mesh is None else shard_state(state, self.mesh)
        return self


def polyak_update(target, source, tau: float) -> None:
    """target = (1 - tau) target + tau source, parameter by parameter, in place
    (ddpg_learner.py:36-47, 149-153; her's polyak is 1 - tau)."""
    with torch.no_grad():
        for t, p in zip(target.parameters(), source.parameters()):
            t.copy_((1 - tau) * t + tau * p)


def save_from_rank0(path: str, tree, mesh) -> None:
    """``ckpt.save_state`` by rank 0 of ``mesh`` alone (by the one process without a
    mesh); the other ranks wait until the file is written."""
    if mesh is None or mesh.rank == 0:
        ckpt.save_state(path, tree)
    if mesh is not None:
        barrier(mesh)


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
    already normalized by them. A goal policy (her's) steps on dict observations."""
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
    done = torch.zeros((venv.num_envs,), dtype=torch.bool, device=venv.device)
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


class _ClipOptimizer:
    """Clip by global norm, then a per-parameter scale, then ``p -= lr * u``, with the
    learning rate given at each step (ppo2/model.py:97-116 order). The clip matches
    optax's ``clip_by_global_norm``: ``g if norm < max else g / norm * max``, no
    epsilon. Under a ``mesh`` the gradients are first averaged over the ranks, so that
    the norm is the global gradient's, as in the JAX package's mesh run."""

    def __init__(self, params, max_grad_norm: float | None, mesh=None):
        self.params = list(params)
        self.max_grad_norm = max_grad_norm
        self.mesh = mesh
        self.count = 0

    def _clipped(self, grads) -> list:
        if self.mesh is not None:
            grads = pmean(grads, self.mesh)
        if self.max_grad_norm is None:
            return list(grads)
        g_norm = global_norm(grads)
        trigger = g_norm < self.max_grad_norm
        return [torch.where(trigger, g, g / g_norm * self.max_grad_norm) for g in grads]


class ClipAdam(_ClipOptimizer):
    """Clip-then-Adam, matching ``optax.chain(clip_by_global_norm, scale_by_adam)``:
    ``scale_by_adam`` with f32 bias corrections."""

    b1, b2 = 0.9, 0.999  # optax's defaults, which ppo2 keeps

    def __init__(self, params, max_grad_norm: float | None, eps: float = 1e-5, mesh=None):
        super().__init__(params, max_grad_norm, mesh)
        self.eps = eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

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
        grads = self._clipped(grads)
        self.count += 1
        f32 = torch.float32
        # the bias corrections in f32 on the host, as plain numbers: no copy to the card
        bc1 = float(1 - torch.tensor(self.b1, dtype=f32) ** self.count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=f32) ** self.count)
        # one op over every parameter at a time, each the f32 arithmetic of
        # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
        # p -= lr (mu / bc1) / (sqrt(nu / bc2) + eps)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - self.b2)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, sq)
        u = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(u, denom)
        torch._foreach_mul_(u, lr)
        torch._foreach_sub_(self.params, u)


class ClipRMSProp(_ClipOptimizer):
    """Clip-then-RMSProp, matching ``optax.chain(clip_by_global_norm,
    scale_by_rms(decay, eps))`` as a2c builds it (a2c.py:88-93): ``nu`` starts at 0 and
    the scale is ``g * rsqrt(nu + eps)``, eps inside the root (optax's
    ``eps_in_sqrt=True``), which ``torch.optim.RMSprop``'s ``g / (sqrt(nu) + eps)`` is
    not."""

    def __init__(self, params, max_grad_norm: float | None, decay: float = 0.99,
                 eps: float = 1e-5, mesh=None):
        super().__init__(params, max_grad_norm, mesh)
        self.decay = decay
        self.eps = eps
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state_dict(self) -> dict:
        return {"nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for mine, theirs in zip(self.nu, state["nu"]):
            mine.copy_(theirs)
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, grads, lr: float) -> None:
        grads = self._clipped(grads)
        self.count += 1
        for p, g, nu in zip(self.params, grads, self.nu):
            nu.copy_((1 - self.decay) * (g * g) + self.decay * nu)
            p.sub_(lr * (torch.rsqrt(nu + self.eps) * g))
