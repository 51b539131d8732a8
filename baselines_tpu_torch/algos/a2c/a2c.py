"""A2C, synchronous advantage actor-critic (counterpart of baselines_tpu/algos/a2c/a2c.py,
after baselines/a2c).

Loss as a2c/a2c.py:54-86 (a2c.py:96-120 in the JAX package): pg_loss = E[(R - V) *
-log pi(a)] with the advantage from the rollout's values and not normalized, vf_loss =
MSE(V, R), and the entropy bonus. One step of clip-then-RMSProp (decay 0.99, eps 1e-5
inside the root, ``ClipRMSProp``) on each rollout batch, the learning rate annealed
linearly by the remaining fraction of training with ``lrschedule="linear"``
(a2c.py:127). The returns are the n-step bootstrapped ``nstep_returns``. A recurrent
policy replays the rollout from its carry before the rollout, as ppo's loss does.

Under a mesh (``mesh``) each rank steps ``num_envs / size`` envs; the gradients are
averaged over the ranks before the clip, the monitor's episodes are gathered once a
rollout, and the metrics and the moments of ``explained_variance`` on the updates that
log, so a W-rank run computes the numbers of the one-process run from the same seed, up
to the order of float sums.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from baselines_tpu_torch.algos.common import (ClipRMSProp, Model, build_env, learner_device,
                                              mesh_metrics, run_rollout, update_metrics)
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws, ShardedDraws
from baselines_tpu_torch.data.gae import nstep_returns
from baselines_tpu_torch.distributed.mesh import check_mesh, local_num_envs
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.policy import build_policy


@dataclass
class A2CTrainState:
    """What an update carries to the next; the params live in the policy's module and
    the RMS moments in the optimizer."""

    env_state: Any
    obs: torch.Tensor
    last_done: torch.Tensor
    rnn_state: torch.Tensor | None = None
    update_idx: int = 0


def _flat01(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def a2c_lr(lr: float, lrschedule: str, update_idx: int, nupdates: int) -> float:
    """The learning rate of update ``update_idx`` in f32, as the JAX package computes it
    (a2c.py:127): ``lr * (1 - update_idx / nupdates)`` for "linear", else ``lr``."""
    f32 = np.float32
    if lrschedule == "linear":
        return float(f32(lr) * (f32(1.0) - f32(update_idx) / f32(nupdates)))
    return float(f32(lr))


def make_update_fn(policy, venv, opt: ClipRMSProp, *, nsteps: int, gamma: float,
                   ent_coef: float, vf_coef: float, lr: float, lrschedule: str,
                   nupdates: int, mesh=None):
    """One a2c update (a2c.py:122-143): ``update_fn(state, draws) -> (state, metrics)``,
    a rollout, the n-step returns and one optimizer step. Under a ``mesh`` the rollout
    is the rank's envs (``draws`` a ``ShardedDraws``), ``opt`` averages the gradients
    over the ranks, and the metrics are the rank's shares, which
    ``algos.common.mesh_metrics`` reduces."""
    params = opt.params

    def loss_fn(traj, returns, rnn_init):
        if rnn_init is None:
            pdflat, vpred, _ = policy.module(_flat01(traj.obs))
        else:
            pdflat, vpred, _ = policy.module.unroll(traj.obs, rnn_init, traj.rnn_masks)
        pd = policy.pdtype.pdfromflat(pdflat)
        R = _flat01(returns)
        adv = R - _flat01(traj.values)  # from the rollout's values (a2c.py:102)
        pg_loss = torch.mean(adv * pd.neglogp(_flat01(traj.actions)))
        vf_loss = torch.mean(torch.square(vpred - R))
        entropy = torch.mean(pd.entropy())
        loss = pg_loss - entropy * ent_coef + vf_loss * vf_coef
        return loss, {"policy_loss": pg_loss, "value_loss": vf_loss,
                      "policy_entropy": entropy}

    def update_fn(state: A2CTrainState, draws):
        lr_now = a2c_lr(lr, lrschedule, state.update_idx, nupdates)
        rollout_init_rnn = state.rnn_state
        env_state, obs, last_done, traj, last_value, rnn_state = run_rollout(
            policy, venv, draws, state.env_state, state.obs, state.last_done, nsteps,
            rollout_init_rnn)
        env_state = VecMonitor.sync_stats(env_state, mesh)
        returns = nstep_returns(traj.rewards, traj.dones, last_value, gamma)
        loss, metrics = loss_fn(traj, returns, rollout_init_rnn)
        opt.step(torch.autograd.grad(loss, params), lr_now)
        metrics = update_metrics({k: v.detach() for k, v in metrics.items()},
                                 _flat01(traj.values), _flat01(returns), mesh)
        new_state = A2CTrainState(env_state=env_state, obs=obs, last_done=last_done,
                                  rnn_state=rnn_state, update_idx=state.update_idx + 1)
        return new_state, metrics

    return update_fn


def learn(
    *,
    env=None,
    env_id: str | None = None,
    network: str = "mlp",
    total_timesteps: int,
    seed: int | None = None,
    num_envs: int = 8,
    env_kwargs: dict | None = None,
    nsteps: int = 5,
    vf_coef: float = 0.5,
    ent_coef: float = 0.01,
    max_grad_norm: float = 0.5,
    lr: float = 7e-4,
    lrschedule: str = "linear",
    epsilon: float = 1e-5,
    alpha: float = 0.99,
    gamma: float = 0.99,
    log_interval: int = 100,
    load_path: str | None = None,
    value_network: str | None = None,
    mesh=None,
    device=None,
    **network_kwargs,
) -> Model:
    """Train a2c (a2c/a2c.py:119-231 signature and defaults), logging the keys of
    a2c.py:180-188 every ``log_interval`` updates and at the first.

    ``mesh``, a ``Mesh`` from ``distributed.make_mesh``, trains data parallel: every
    rank calls ``learn`` with the same arguments and steps ``num_envs / size`` of the
    envs on the mesh's device (an ``env`` given is the rank's). ``device`` is the card
    unless the caller passes ``"cpu"``; ``env_kwargs`` go to ``build_env`` and the
    remaining keywords to the network."""
    if lrschedule not in ("linear", "constant"):
        raise ValueError(f"lrschedule must be 'linear' or 'constant', got {lrschedule!r}")
    check_mesh(mesh, "a2c's mesh")
    device = learner_device(mesh, device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    venv = env if env is not None else build_env(
        env_id, local_num_envs(mesh, num_envs), device=device, axis_name=mesh,
        **(env_kwargs or {}))
    nbatch = venv.num_envs * nsteps * (1 if mesh is None else mesh.size)
    nupdates = max(total_timesteps // nbatch, 1) if total_timesteps > 0 else 0

    init_gen = torch.Generator().manual_seed(seed)
    policy = build_policy(venv.observation_space, venv.action_space, network, device=device,
                          generator=init_gen, value_network=value_network, **network_kwargs)
    opt = ClipRMSProp(policy.module.parameters(), max_grad_norm, decay=alpha, eps=epsilon,
                      mesh=mesh)
    draws = Draws(seed, device) if mesh is None else ShardedDraws(Draws(seed, device), mesh)
    obs, env_state = venv.reset(draws)
    state = A2CTrainState(env_state=env_state, obs=obs,
                          last_done=torch.zeros((venv.num_envs,), dtype=torch.bool, device=device),
                          rnn_state=policy.initial_state(venv.num_envs))
    update_fn = make_update_fn(policy, venv, opt, nsteps=nsteps, gamma=gamma,
                               ent_coef=ent_coef, vf_coef=vf_coef, lr=lr,
                               lrschedule=lrschedule, nupdates=nupdates, mesh=mesh)
    model = Model(policy, state, opt, draws, mesh)
    if load_path is not None:
        model.load(load_path)

    tstart = time.time()
    for update in range(1, nupdates + 1):
        state, metrics = update_fn(state, draws)
        if update % log_interval == 0 or update == 1:
            metrics = mesh_metrics(metrics, mesh)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            stats = VecMonitor.get_stats(state.env_state)
            logger.logkv("nupdates", update)
            logger.logkv("total_timesteps", update * nbatch)
            logger.logkv("fps", int(update * nbatch / (time.time() - tstart)))
            logger.logkv("eprewmean", float(stats.mean_return))
            for k, v in metrics.items():
                logger.logkv(k, v)
            logger.dumpkvs()
        model.state = state
    return model
