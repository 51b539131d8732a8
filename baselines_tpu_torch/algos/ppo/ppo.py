"""PPO with the clipped surrogate (counterpart of baselines_tpu/algos/ppo/ppo.py).

Loss as ppo2/model.py:46-116: clipped value loss, clipped ratio surrogate, entropy
bonus, approxkl and clipfrac, with advantages normalized per minibatch. Schedule as
ppo2/ppo2.py:21-218: noptepochs x nminibatches of shuffled minibatch steps, the
learning rate and clip range annealed by the remaining fraction of training.

Ported so far: feedforward policies on one device. Each update is a rollout, GAE, then
the epochs; every epoch draws a fresh permutation and gathers every field of the batch
through the row-gather kernel (``ops/gather.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from baselines_tpu_torch.algos.common import ClipAdam, Model, build_env, run_rollout
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.device import resolve_device
from baselines_tpu_torch.core.math import explained_variance
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.core.schedules import resolve_fraction_schedule
from baselines_tpu_torch.data.gae import gae
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.distributions import CategoricalPd
from baselines_tpu_torch.nn.policy import build_policy
from baselines_tpu_torch.ops.gather import take_rows


@dataclass
class PPOTrainState:
    """What an update carries to the next; the params live in the policy's module and
    the Adam moments in the optimizer."""

    env_state: Any
    obs: torch.Tensor
    last_done: torch.Tensor
    update_idx: int = 0


def _flat01(x: torch.Tensor) -> torch.Tensor:
    """(T, N, ...) -> (T*N, ...), the sf01 flatten (ppo2/runner.py:69-74)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def make_ppo_loss(policy, ent_coef: float, vf_coef: float):
    """ppo.py:63-124 for a feedforward policy with the clipped value loss."""

    def loss_fn(batch, advs, cliprange: float):
        obs, actions, returns, old_values, old_neglogps, _ = batch
        logits, vpred = policy.module(obs)
        pd = CategoricalPd(logits)
        neglogpac = pd.neglogp(actions)
        entropy = torch.mean(pd.entropy())

        vf_losses1 = torch.square(vpred - returns)
        vpredclipped = old_values + torch.clamp(vpred - old_values, -cliprange, cliprange)
        vf_losses2 = torch.square(vpredclipped - returns)
        vf_loss = 0.5 * torch.mean(torch.maximum(vf_losses1, vf_losses2))

        # 1 -/+ cliprange in f32, as the JAX package computes them
        lo = float(np.float32(1.0) - np.float32(cliprange))
        hi = float(np.float32(1.0) + np.float32(cliprange))
        ratio = torch.exp(old_neglogps - neglogpac)
        pg_losses = -advs * ratio
        pg_losses2 = -advs * torch.clamp(ratio, lo, hi)
        pg_loss = torch.mean(torch.maximum(pg_losses, pg_losses2))

        approxkl = 0.5 * torch.mean(torch.square(neglogpac - old_neglogps))
        clipfrac = torch.mean((torch.abs(ratio - 1.0) > cliprange).to(torch.float32))

        loss = pg_loss - entropy * ent_coef + vf_loss * vf_coef
        return loss, {
            "policy_loss": pg_loss,
            "value_loss": vf_loss,
            "policy_entropy": entropy,
            "approxkl": approxkl,
            "clipfrac": clipfrac,
        }

    return loss_fn


def _normalize_advs(returns: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    advs = returns - values
    return (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)


def make_update_fn(policy, venv, opt: ClipAdam, *, nsteps, nminibatches, noptepochs, gamma,
                   lam, ent_coef, vf_coef, lr_fn, cliprange_fn, nupdates):
    """One PPO update (ppo.py:208-233, :308-330, :374-396, feedforward, one device):
    ``update_fn(state, draws) -> (state, metrics)``. The rollout takes its draws first,
    then each epoch one permutation."""
    nbatch = venv.num_envs * nsteps
    nbatch_train = nbatch // nminibatches
    loss_fn = make_ppo_loss(policy, ent_coef, vf_coef)
    params = opt.params

    def update_fn(state: PPOTrainState, draws):
        frac = 1.0 - state.update_idx / nupdates
        lr = lr_fn(frac)
        cliprange = cliprange_fn(frac)

        env_state, obs, last_done, traj, last_value = run_rollout(
            policy, venv, draws, state.env_state, state.obs, state.last_done, nsteps
        )
        advs, returns = gae(traj.rewards, traj.values, traj.dones, last_value, gamma, lam)
        batch = [_flat01(x) for x in (traj.obs, traj.actions, returns, traj.values,
                                      traj.neglogps, traj.rnn_masks)]

        metrics = []
        for _ in range(noptepochs):
            perm = draws.permutation(nbatch)
            shuffled = [take_rows(x, perm) for x in batch]
            for i in range(nminibatches):
                mb = [x[i * nbatch_train:(i + 1) * nbatch_train] for x in shuffled]
                mb_advs = _normalize_advs(mb[2], mb[3])
                loss, mb_metrics = loss_fn(mb, mb_advs, cliprange)
                grads = torch.autograd.grad(loss, params)
                opt.step(grads, lr)
                metrics.append({k: v.detach() for k, v in mb_metrics.items()})

        out = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
        out["explained_variance"] = explained_variance(_flat01(traj.values), _flat01(returns))
        out["learning_rate"] = lr
        out["cliprange"] = cliprange
        new_state = PPOTrainState(env_state=env_state, obs=obs, last_done=last_done,
                                  update_idx=state.update_idx + 1)
        return new_state, out

    return update_fn


def learn(
    *,
    env=None,
    env_id: str | None = None,
    network: str = "cnn_s2d",
    total_timesteps: int,
    seed: int | None = None,
    num_envs: int = 8,
    env_kwargs: dict | None = None,
    nsteps: int = 2048,
    ent_coef: float = 0.0,
    lr=3e-4,
    vf_coef: float = 0.5,
    max_grad_norm: float = 0.5,
    gamma: float = 0.99,
    lam: float = 0.95,
    log_interval: int = 10,
    nminibatches: int = 4,
    noptepochs: int = 4,
    cliprange=0.2,
    adam_epsilon: float = 1e-5,
    device=None,
    **network_kwargs,
) -> Model:
    """Train ppo2 (ppo2/ppo2.py:21-218), logging the keys of ppo.py:589-599.

    ``device`` is the card unless the caller passes ``"cpu"``; ``env_kwargs`` go to
    ``build_env`` (for example ``s2d=4``) and the remaining keywords to the network
    (for example ``dtype=torch.bfloat16``)."""
    device = resolve_device(device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    venv = env if env is not None else build_env(env_id, num_envs, device=device,
                                                 **(env_kwargs or {}))
    nbatch = venv.num_envs * nsteps
    nupdates = max(total_timesteps // nbatch, 1) if total_timesteps > 0 else 0

    init_gen = torch.Generator().manual_seed(seed)
    policy = build_policy(venv.observation_space, venv.action_space, network, device=device,
                          generator=init_gen, **network_kwargs)
    opt = ClipAdam(policy.module.parameters(), max_grad_norm, eps=adam_epsilon)
    draws = Draws(seed, device)
    obs, env_state = venv.reset(draws)
    state = PPOTrainState(env_state=env_state, obs=obs,
                          last_done=torch.zeros((venv.num_envs,), dtype=torch.bool, device=device))
    update_fn = make_update_fn(
        policy, venv, opt, nsteps=nsteps, nminibatches=nminibatches, noptepochs=noptepochs,
        gamma=gamma, lam=lam, ent_coef=ent_coef, vf_coef=vf_coef,
        lr_fn=resolve_fraction_schedule(lr), cliprange_fn=resolve_fraction_schedule(cliprange),
        nupdates=nupdates,
    )

    tfirststart = time.time()
    tlastlog, lastlog_update = tfirststart, 0
    for update in range(1, nupdates + 1):
        state, metrics = update_fn(state, draws)
        if update % log_interval == 0 or update == 1:
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            tnow = time.time()
            fps = int((update - lastlog_update) * nbatch / (tnow - tlastlog))
            tlastlog, lastlog_update = tnow, update
            stats = VecMonitor.get_stats(state.env_state)
            logger.logkv("misc/serial_timesteps", update * nsteps)
            logger.logkv("misc/nupdates", update)
            logger.logkv("misc/total_timesteps", update * nbatch)
            logger.logkv("fps", fps)
            logger.logkv("eprewmean", float(stats.mean_return))
            logger.logkv("eplenmean", float(stats.mean_length))
            logger.logkv("misc/time_elapsed", tnow - tfirststart)
            for k, v in metrics.items():
                loss_key = "loss" in k or k in ("approxkl", "clipfrac", "policy_entropy")
                logger.logkv(f"loss/{k}" if loss_key else k, v)
            logger.dumpkvs()
    return Model(policy, state)
