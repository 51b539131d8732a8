"""Shared learner scaffolding (counterpart of baselines_tpu/algos/common.py).

- ``build_env``: env id -> the JAX package's wrapper chain: a device env
  ([ClipActions] -> VecTorchEnv -> [VecFlattenDictObs]), a ``native:`` id's C++ engine
  or a host pool behind ``CallbackVecEnv`` (``make_host_vec_env``: the DeepMind chain
  for an atari id, a gymnasium env otherwise), then VecMonitor -> [VecRewardScale] ->
  [VecNormalize] -> [VecFrameStack] -> [VecS2D] -> [VecVideoRecorder], the monitor and
  the normalization across the ranks of a mesh ``axis_name``, whose host pools seed
  the rank's envs by their global index; ``closing_host_envs`` closes the host pools
  it opens in a block.
- ``build_env_pair``, ``init_pipe_state`` and ``run_rollout_pipelined``: two host env
  groups stepped in antiphase (``envs/host_pipeline.py``), ppo2's ``pipeline``.
- ``run_rollout``: the T-step rollout, a Python loop where the JAX package scans;
  returns a time-major trajectory and, for a recurrent policy, the carry.
- ``ClipAdam`` and ``ClipRMSProp``: clip by global norm, then Adam or RMSProp, then
  ``p -= lr * u``, with the arithmetic of ``optax.chain(clip_by_global_norm,
  scale_by_adam)`` or ``scale_by_rms`` and ``apply_updates_lr``; under a mesh the
  gradients are first averaged over the ranks, so the norm is the global gradient's.
- ``learner_device``, ``update_metrics`` and ``mesh_metrics``: a learner's device, and
  an update's metrics, under a mesh the rank's shares, reduced over the ranks only on
  the updates that log; ``gather_env_columns``: a rank's time-major rollout fields
  gathered into the whole mesh's, in one call.
- ``Model``: what ``learn`` returns, with ``save``/``load`` of the params and the
  VecNormalize statistics (the ``--save_path`` payload) and ``save_full``/``load_full``
  of the whole train state, in a one-process layout also under a mesh.
- ``evaluate``: a bounded rollout of a trained model, the ``--play`` report, under the
  statistics the model was trained with, with the carry of a recurrent policy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import weakref
from dataclasses import dataclass

import torch

from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core.device import resolve_device
from baselines_tpu_torch.core.math import explained_variance, global_norm
from baselines_tpu_torch.core.running_stats import RunningMeanStd, merge_branched
from baselines_tpu_torch.distributed.collectives import (all_gather_fields, all_gather_rows,
                                                         merged_moments, pmean)
from baselines_tpu_torch.distributed.mesh import barrier, gather_state, shard_state
from baselines_tpu_torch.envs.base import ClipActions
from baselines_tpu_torch.envs.callback_env import CallbackVecEnv
from baselines_tpu_torch.envs.gym_bridge import host_pool
from baselines_tpu_torch.envs.registry import get_env_type, is_torch_env, make_env
from baselines_tpu_torch.envs.spaces import Box, DictSpace
from baselines_tpu_torch.envs.vec import (VecFlattenDictObs, VecFrameStack, VecMonitor,
                                          VecNormalize, VecRewardScale, VecS2D, VecTorchEnv,
                                          find_normalize_state, replace_normalize_stats)


# the host pools build_env opened and nothing closed yet
_OPEN_HOST_ENVS = weakref.WeakSet()


@contextlib.contextmanager
def closing_host_envs():
    """Close, when the block ends, the host pools ``build_env`` opened in it (run.main's
    training and play envs)."""
    before = set(_OPEN_HOST_ENVS)
    try:
        yield
    finally:
        for venv in list(_OPEN_HOST_ENVS):
            if venv not in before:
                _OPEN_HOST_ENVS.discard(venv)
                venv.close()


def gym_thunk(env_id: str, env_type: str, need_render: bool = False):
    """A function that makes the gymnasium env ``env_id`` (with gymnasium-robotics'
    envs registered for a robotics id, and an rgb_array render surface when
    ``need_render``), in the pool's worker."""

    def thunk():
        import gymnasium as gym

        if env_type == "robotics":
            import gymnasium_robotics

            gym.register_envs(gymnasium_robotics)
        return gym.make(env_id, render_mode="rgb_array" if need_render else None)

    return thunk


def _host_bridge(venv) -> CallbackVecEnv:
    """The CallbackVecEnv at the bottom of a chain of vec wrappers."""
    while not isinstance(venv, CallbackVecEnv):
        venv = venv.venv
    return venv


def make_host_vec_env(env_id: str, num_envs: int, env_type: str, *, device,
                      need_render: bool = False, gamestate=None, keep_dict_obs: bool = False,
                      first_env: int = 0):
    """A host pool behind CallbackVecEnv (common.py:32-81), its first env the global
    env ``first_env``. An atari id takes the DeepMind chain, frame-stacked on the device
    (``envs/atari.py``); a retro id the retro chain (``envs/retro_wrappers.py``), which
    cannot render; any other id a gymnasium pool, whose dict observations are flattened
    to observation ++ desired_goal by VecFlattenDictObs (make_robotics_env's
    FlattenDictWrapper, cmd_util.py:124-135) unless ``keep_dict_obs``. ``need_render``
    makes the envs render rgb frames, for video capture."""
    if env_type == "atari":
        from baselines_tpu_torch.envs.atari import make_atari_vec_env

        venv = make_atari_vec_env(env_id, num_envs, need_render=need_render, device=device,
                                  first_env=first_env)
    elif env_type == "retro":
        if need_render:
            raise ValueError("--save_video_interval is unsupported for retro envs; remove "
                             "the flag or record from a gymnasium env")
        from baselines_tpu_torch.envs.retro_wrappers import make_retro_vec_env

        venv = make_retro_vec_env(env_id, num_envs, gamestate=gamestate, device=device,
                                  first_env=first_env)
    else:
        venv = CallbackVecEnv(host_pool(gym_thunk(env_id, env_type, need_render), num_envs,
                                        first_env), device=device)
    _OPEN_HOST_ENVS.add(_host_bridge(venv))
    if not keep_dict_obs and isinstance(venv.observation_space, DictSpace):
        venv = VecFlattenDictObs(venv)
    return venv


def build_env(env_id: str, num_envs: int, *, device, normalize: bool | None = None,
              reward_scale: float = 1.0, frame_stack: int = 0, s2d: int = 0,
              axis_name=None, keep_dict_obs: bool = False, save_video_interval: int = 0,
              save_video_length: int = 200, video_dir: str | None = None, gamestate=None):
    """The chain of common.py:84-187. The base: for a device env, ClipActions on a
    ``Box`` action space, VecTorchEnv, and VecFlattenDictObs on dict observations unless
    ``keep_dict_obs`` (her reads the dicts; the other learners see observation ++
    desired_goal, as the JAX package's host goal envs give them, common.py:72-80); for a
    ``native:`` id the C++ engine (``native/``) behind CallbackVecEnv, also for ids that
    exist as device envs; for any other id a host pool (``make_host_vec_env``: the
    DeepMind chain for an atari id, gymnasium's env otherwise; ``gamestate`` goes to a
    retro chain, which the env types of ``get_env_type`` never select, as in the JAX
    package). Then VecMonitor, VecRewardScale when ``reward_scale`` != 1 (outside the
    monitor, whose statistics stay raw), VecNormalize when ``normalize`` (None: only for
    mujoco envs), VecFrameStack when ``frame_stack`` > 1, VecS2D when ``s2d``, and
    outermost VecVideoRecorder when ``save_video_interval``: a video of
    ``save_video_length`` frames every ``save_video_interval`` steps, into ``video_dir``
    (the log dir's ``videos/`` when None; native ids do not render). Under a mesh
    ``axis_name``, ``num_envs`` is the rank's envs, a host pool's first env is the
    rank's first global env, and the monitor and the normalization take every rank's."""
    env_type = get_env_type(env_id)
    first_env = 0 if axis_name is None else axis_name.rank * num_envs
    torch_env = host_venv = None
    if env_id.startswith("native:"):
        from baselines_tpu_torch.native import NativeVecEnv

        if save_video_interval:
            raise ValueError("--save_video_interval: native envs do not render")
        venv = CallbackVecEnv(NativeVecEnv(env_id.split(":", 1)[1], num_envs,
                                           first_env=first_env), device=device)
        _OPEN_HOST_ENVS.add(venv)
        env_type = None
    elif is_torch_env(env_id):
        torch_env = make_env(env_id)
        env = ClipActions(torch_env) if isinstance(torch_env.action_space, Box) else torch_env
        venv = VecTorchEnv(env, num_envs, device)
        if not keep_dict_obs and isinstance(venv.observation_space, DictSpace):
            venv = VecFlattenDictObs(venv)
    else:
        venv = host_venv = make_host_vec_env(
            env_id, num_envs, env_type, device=device, need_render=save_video_interval > 0,
            gamestate=gamestate, keep_dict_obs=keep_dict_obs, first_env=first_env)
    venv = VecMonitor(venv, axis_name=axis_name)
    if reward_scale != 1.0:
        venv = VecRewardScale(venv, reward_scale)
    if normalize is None:
        normalize = env_type == "mujoco"
    if normalize:
        venv = VecNormalize(venv, axis_name=axis_name)
    if frame_stack and frame_stack > 1:
        venv = VecFrameStack(venv, frame_stack)
    if s2d:
        if s2d < 2:
            raise ValueError(f"--s2d must be a block size >= 2, got {s2d}")
        venv = VecS2D(venv, s2d)
    if save_video_interval:
        from baselines_tpu_torch.core import logger
        from baselines_tpu_torch.envs.video import VecVideoRecorder, torch_env_frame_fn

        if torch_env is not None:
            frame_fn = torch_env_frame_fn(torch_env)
        else:
            pool = _host_bridge(host_venv).host
            frame_fn = lambda _state: pool.render()  # noqa: E731
        venv = VecVideoRecorder(
            venv, video_dir or os.path.join(logger.get_dir() or ".", "videos"),
            record_video_trigger=lambda step: step % save_video_interval == 0,
            video_length=save_video_length, frame_fn=frame_fn)
    return venv


def build_env_pair(env_id: str, num_envs: int, *, device, **env_kwargs):
    """Two chains of ``num_envs / 2`` host envs each, with pools of their own, for the
    antiphase rollout (common.py:190-204, ``envs/host_pipeline.py``); no video capture
    there."""
    from baselines_tpu_torch.envs.host_pipeline import PipelinedHostVecPair

    if num_envs < 2 or num_envs % 2:
        raise AssertionError("pipelining needs an even env count >= 2")
    if env_kwargs.get("save_video_interval"):
        raise AssertionError("video capture is not supported on the pipelined rollout path")
    half = num_envs // 2
    return PipelinedHostVecPair(build_env(env_id, half, device=device, **env_kwargs),
                                build_env(env_id, half, device=device, **env_kwargs))


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


def update_metrics(metrics: dict, ypred: torch.Tensor, y: torch.Tensor, mesh,
                   ev_name: str = "explained_variance") -> dict:
    """An update's ``metrics`` (the means of its loss terms) with the explained variance
    of ``ypred`` for ``y`` under ``ev_name``. Under a mesh both are the rank's shares: the
    explained variance is left as the moments of the rank's shard under
    ``"ev_moments"``, for ``mesh_metrics`` to merge on the updates that log."""
    if mesh is None:
        return dict(metrics, **{ev_name: explained_variance(ypred, y)})
    y = y.reshape(-1).to(torch.float32)
    d = y - ypred.reshape(-1).to(torch.float32)
    moments = torch.stack([y.mean(), d.mean(), torch.var(y, correction=0),
                           torch.var(d, correction=0)])
    return dict(metrics, ev_moments=moments)


def mesh_metrics(metrics: dict, mesh, ev_name: str = "explained_variance") -> dict:
    """The whole mesh's metrics from a rank's ``update_metrics``, in one gather: each
    tensor metric's mean over the ranks' equal-size shares, and the explained variance
    (``ev_name``) over the global batch from the ranks' merged moments
    (math_util.py:29-47: nan where Var[y] is 0). Collective; without a mesh the metrics
    come back as they are."""
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
            out[ev_name] = ev
        else:
            out[k] = means.get(k, v)
    return out


def gather_env_columns(fields: dict, mesh) -> dict:
    """A rank's time-major (T, n, ...) tensors as the whole mesh's (T, N, ...), every
    rank's env columns in env order, in one call (``all_gather_fields`` of their
    env-major transposes); ``fields`` as they are without a mesh. Collective."""
    if mesh is None:
        return fields
    gathered = all_gather_fields({k: v.transpose(0, 1) for k, v in fields.items()}, mesh)
    return {k: v.transpose(0, 1) for k, v in gathered.items()}


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

    @property
    def params(self) -> dict:
        """The trained parameters (common.py:438-440): the policy module's named
        parameters, the tensors themselves."""
        return dict(self.policy.module.named_parameters())

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
def init_pipe_state(policy, pair, draws, reset_a, reset_b):
    """Prime the pipelined rollout (common.py:254-297): group B's first action is
    computed and submitted, so that every step of the rollout finds one B step in
    flight. Under VecNormalize both groups start from the union of their reset
    statistics, the common prior from which ``merge_branched`` rebuilds the exact merge
    after each rollout. Draws: the policy's noise for B's first step."""
    from baselines_tpu_torch.envs.host_pipeline import PipeState

    if policy.is_recurrent:
        raise AssertionError("pipelined rollouts support feedforward policies")
    obs_a, st_a = reset_a
    obs_b, st_b = reset_b
    ns_a, ns_b = find_normalize_state(st_a), find_normalize_state(st_b)
    if ns_a is not None and ns_b is not None:
        def union(a, b):
            zero = RunningMeanStd(mean=torch.zeros_like(a.mean), var=torch.zeros_like(a.var),
                                  count=torch.zeros_like(a.count))
            return merge_branched(zero, a, b)

        ob_rms = union(ns_a.ob_rms, ns_b.ob_rms)
        ret_rms = union(ns_a.ret_rms, ns_b.ret_rms)
        st_a = replace_normalize_stats(st_a, ob_rms, ret_rms)
        st_b = replace_normalize_stats(st_b, ob_rms, ret_rms)
    n = pair.a.num_envs
    act_b, val_b, nlp_b = policy.step(obs_b, draws)
    pair.submit_b(act_b)
    no_done = torch.zeros((n,), dtype=torch.bool, device=obs_a.device)
    return PipeState(state_a=st_a, state_b=st_b, obs_a=obs_a, pend_obs_b=obs_b,
                     pend_act_b=act_b, pend_val_b=val_b, pend_nlp_b=nlp_b,
                     last_done_a=no_done, last_done_b=no_done.clone())


@torch.no_grad()
def run_rollout_pipelined(policy, pair, draws, ps, nsteps: int):
    """nsteps antiphase steps over the env pair (common.py:300-376): group A's host
    step runs while the device computes group B's actions, and the other way round.
    Each step: A's action, submit A and collect B (``swap_ab``), B's next action, submit
    B and collect A (``swap_ba``). Draws: A's noise, then B's, at each step.

    Returns (pipe_state, traj, last_value): traj's (T, N) fields hold group A in columns
    [:N/2] and group B, one phase behind, in [N/2:]; last_value is A's value of its
    current obs beside B's pending value. VecNormalize's statistics of the two groups
    are merged exactly after the rollout (``merge_branched``), the in-process analog of
    the reference's cross-rank moment Allreduce (mpi_running_mean_std.py:41-48)."""
    from baselines_tpu_torch.envs.host_pipeline import PipeState, collect_through

    ns_prev = find_normalize_state(ps.state_a)
    packed = policy.pack()
    half, dev = pair.a.num_envs, ps.obs_a.device
    pdtype = policy.pdtype

    def buf(shape=(), dtype=torch.float32):
        return torch.empty((nsteps, 2 * half) + tuple(shape), dtype=dtype, device=dev)

    traj = Trajectory(
        obs=buf(ps.obs_a.shape[1:], ps.obs_a.dtype),
        actions=buf(pdtype.sample_shape, pdtype.sample_dtype), values=buf(),
        neglogps=buf(), rewards=buf(), dones=buf(dtype=torch.bool), rnn_masks=buf(),
    )
    cols = {"a": slice(0, half), "b": slice(half, 2 * half)}

    def record(t, group, obs, action, value, neglogp, rew, done, mask):
        c = cols[group]
        traj.obs[t, c] = obs
        traj.actions[t, c] = action
        traj.values[t, c] = value
        traj.neglogps[t, c] = neglogp
        traj.rewards[t, c] = rew
        traj.dones[t, c] = done
        traj.rnn_masks[t, c] = mask

    for t in range(nsteps):
        act_a, val_a, nlp_a = policy.step(ps.obs_a, draws, packed)
        # submit A (A's envs now step), collect B's step in flight
        obs_b, st_b, rew_b, done_b, _ = collect_through(pair.b, ps.state_b,
                                                        pair.swap_ab(act_a))
        record(t, "b", ps.pend_obs_b, ps.pend_act_b, ps.pend_val_b, ps.pend_nlp_b, rew_b,
               done_b, ps.last_done_b.to(torch.float32))
        # B's next action computes while A's envs still step
        act_b, val_b, nlp_b = policy.step(obs_b, draws, packed)
        obs_a, st_a, rew_a, done_a, _ = collect_through(pair.a, ps.state_a,
                                                        pair.swap_ba(act_b))
        record(t, "a", ps.obs_a, act_a, val_a, nlp_a, rew_a, done_a,
               ps.last_done_a.to(torch.float32))
        ps = PipeState(state_a=st_a, state_b=st_b, obs_a=obs_a, pend_obs_b=obs_b,
                       pend_act_b=act_b, pend_val_b=val_b, pend_nlp_b=nlp_b,
                       last_done_a=done_a, last_done_b=done_b)
    last_value = torch.cat([policy.value(ps.obs_a, packed), ps.pend_val_b])
    if ns_prev is not None:
        na, nb = find_normalize_state(ps.state_a), find_normalize_state(ps.state_b)
        ob_rms = merge_branched(ns_prev.ob_rms, na.ob_rms, nb.ob_rms)
        ret_rms = merge_branched(ns_prev.ret_rms, na.ret_rms, nb.ret_rms)
        ps = replace_normalize_stats(ps, ob_rms, ret_rms)
    return ps, traj, last_value


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
    recurrent = policy.is_recurrent
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
