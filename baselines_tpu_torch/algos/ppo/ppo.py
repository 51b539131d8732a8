"""PPO with the clipped surrogate (counterpart of baselines_tpu/algos/ppo/ppo.py).

Loss as ppo2/model.py:46-116: clipped value loss (or ppo1's plain value MSE with
``clip_value=False``), clipped ratio surrogate, entropy bonus, approxkl and clipfrac,
with advantages normalized per minibatch (or once over the whole batch with
``adv_norm="batch"``, ppo1's standardization). Schedule as
ppo2/ppo2.py:21-218: noptepochs x nminibatches of shuffled minibatch steps, the
learning rate and clip range annealed by the remaining fraction of training.

Ported so far: feedforward and recurrent policies on one device, a shared latent or a
separate value tower (``value_network="copy"``), and gradient microbatching. Each update
is a rollout, GAE, then the epochs. A feedforward epoch draws a fresh permutation of the
samples and gathers every field of the batch through the row-gather kernel
(``ops/gather.py``); a recurrent epoch permutes the envs and replays whole env sequences
from the carry before the rollout, the encoder once over all frames and the LSTM cell
step by step, with plain indexing as the JAX package takes them (ppo.py:240-261).

Checkpoints as ppo.py:544-602: ``save_interval`` writes the whole train state (params,
Adam moments and count, env state, observations, ``update_idx``, a recurrent policy's
carry and the generator's state) to ``<log dir>/checkpoints/<update:05d>``, and a run
with ``save_interval`` and a log dir resumes from the latest of them, so that a killed
run picks up where it stopped and draws what the uninterrupted run would have drawn. An
explicit ``load_path`` loads params only and wins over that resume.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from baselines_tpu_torch.algos.common import ClipAdam, Model, build_env, not_ported, run_rollout
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.checkpoint import latest_checkpoint, periodic_path
from baselines_tpu_torch.core.device import resolve_device
from baselines_tpu_torch.core.math import explained_variance
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.core.schedules import resolve_fraction_schedule
from baselines_tpu_torch.data.gae import gae
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.policy import build_policy
from baselines_tpu_torch.ops.gather import take_rows


@dataclass
class PPOTrainState:
    """What an update carries to the next; the params live in the policy's module and
    the Adam moments in the optimizer."""

    env_state: Any
    obs: torch.Tensor
    last_done: torch.Tensor
    rnn_state: torch.Tensor | None = None  # a recurrent policy's carry, (N, 2 * nlstm)
    update_idx: int = 0


def _flat01(x: torch.Tensor) -> torch.Tensor:
    """(T, N, ...) -> (T*N, ...), the sf01 flatten (ppo2/runner.py:69-74)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def make_ppo_loss(policy, ent_coef: float, vf_coef: float, clip_value: bool = True):
    """ppo.py:63-124: ppo2's clipped value loss, or the plain value MSE of ppo1 with
    ``clip_value=False``.

    ``loss_fn(batch, advs, cliprange, rnn_init=None)``: the batch's fields are flat (B,
    ...) for a feedforward policy; for a recurrent one they are time-major (T, B, ...)
    and the policy replays the sequence from ``rnn_init``, the carry of each env before
    the rollout, masked by the batch's masks (``PolicyValueNet.unroll``)."""

    def loss_fn(batch, advs, cliprange: float, rnn_init=None):
        obs, actions, returns, old_values, old_neglogps, masks = batch
        if rnn_init is None:
            pdflat, vpred, _ = policy.module(obs)
        else:
            pdflat, vpred, _ = policy.module.unroll(obs, rnn_init, masks)
            actions, returns, old_values, old_neglogps, advs = (
                _flat01(x) for x in (actions, returns, old_values, old_neglogps, advs))
        pd = policy.pdtype.pdfromflat(pdflat)
        neglogpac = pd.neglogp(actions)
        entropy = torch.mean(pd.entropy())

        vf_losses1 = torch.square(vpred - returns)
        if clip_value:
            vpredclipped = old_values + torch.clamp(vpred - old_values, -cliprange, cliprange)
            vf_losses2 = torch.square(vpredclipped - returns)
            vf_loss = 0.5 * torch.mean(torch.maximum(vf_losses1, vf_losses2))
        else:
            vf_loss = 0.5 * torch.mean(vf_losses1)

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
                   lam, ent_coef, vf_coef, lr_fn, cliprange_fn, nupdates,
                   microbatch_size: int | None = None, adv_norm: str = "minibatch",
                   clip_value: bool = True):
    """One PPO update (ppo.py:130-396, one device): ``update_fn(state, draws) -> (state,
    metrics)``. The rollout takes its draws first, then each epoch one permutation.
    ``adv_norm="batch"`` standardizes the advantages once over the whole batch and
    shuffles them with the other fields.

    A feedforward policy's epoch permutes the T * N samples and gathers every field
    through the row-gather kernel. A recurrent policy's epoch permutes the N envs and
    takes whole env sequences, (T, N / nminibatches, ...), each minibatch replayed from
    its envs' carry before the rollout (ppo.py:240-261), so ``nminibatches`` must
    divide N. ``microbatch_size`` splits each feedforward minibatch, its advantages
    already standardized, into microbatches whose gradients and metrics are averaged
    before the one optimizer step (ppo.py:183-206)."""
    if adv_norm not in ("minibatch", "batch"):
        raise ValueError(f"adv_norm must be 'minibatch' or 'batch', got {adv_norm!r}")
    nenvs = venv.num_envs
    nbatch = nenvs * nsteps
    nbatch_train = nbatch // nminibatches
    recurrent = policy.is_recurrent
    if recurrent and nenvs % nminibatches:
        raise ValueError(f"recurrent PPO needs nminibatches ({nminibatches}) to divide "
                         f"num_envs ({nenvs}) (ppo2/ppo2.py:107)")
    if recurrent and microbatch_size is not None:
        raise NotImplementedError("microbatching a recurrent policy is not supported, as in "
                                  "the JAX package (ppo.py:181)")
    if microbatch_size is not None and nbatch_train % microbatch_size:
        raise ValueError(f"microbatch_size {microbatch_size} does not divide the minibatch "
                         f"of {nbatch_train}")
    loss_fn = make_ppo_loss(policy, ent_coef, vf_coef, clip_value)
    params = opt.params

    def minibatch_grads(mb, advs, cliprange, rnn_init):
        """The minibatch's gradients and metrics, the mean over its microbatches when
        ``microbatch_size`` is set (ppo2/microbatched_model.py:35-75)."""
        if microbatch_size is None:
            loss, metrics = loss_fn(mb, advs, cliprange, rnn_init)
            return torch.autograd.grad(loss, params), metrics
        nmicro = nbatch_train // microbatch_size
        grads, metrics = None, []
        for j in range(nmicro):
            part = slice(j * microbatch_size, (j + 1) * microbatch_size)
            loss, m = loss_fn([x[part] for x in mb], advs[part], cliprange)
            g = torch.autograd.grad(loss, params)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            metrics.append({k: v.detach() for k, v in m.items()})
        return ([g / nmicro for g in grads],
                {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]})

    def update_fn(state: PPOTrainState, draws):
        frac = 1.0 - state.update_idx / nupdates
        lr = lr_fn(frac)
        cliprange = cliprange_fn(frac)

        rollout_init_rnn = state.rnn_state
        env_state, obs, last_done, traj, last_value, rnn_state = run_rollout(
            policy, venv, draws, state.env_state, state.obs, state.last_done, nsteps,
            rollout_init_rnn)
        advs, returns = gae(traj.rewards, traj.values, traj.dones, last_value, gamma, lam)
        batch_t = [traj.obs, traj.actions, returns, traj.values, traj.neglogps, traj.rnn_masks]
        if adv_norm == "batch":
            batch_t.append(_normalize_advs(returns, traj.values))

        metrics = []

        def train(mb, rnn_init):
            mb_advs = mb.pop() if adv_norm == "batch" else _normalize_advs(mb[2], mb[3])
            grads, mb_metrics = minibatch_grads(mb, mb_advs, cliprange, rnn_init)
            opt.step(grads, lr)
            metrics.append({k: v.detach() for k, v in mb_metrics.items()})

        if recurrent:
            envs_per_mb = nenvs // nminibatches
            for _ in range(noptepochs):
                perm = draws.permutation(nenvs)
                for i in range(nminibatches):
                    eidx = perm[i * envs_per_mb:(i + 1) * envs_per_mb]
                    train([x[:, eidx] for x in batch_t], rollout_init_rnn[eidx])
        else:
            batch = [_flat01(x) for x in batch_t]
            for _ in range(noptepochs):
                perm = draws.permutation(nbatch)
                shuffled = [take_rows(x, perm) for x in batch]
                for i in range(nminibatches):
                    train([x[i * nbatch_train:(i + 1) * nbatch_train] for x in shuffled], None)

        out = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
        out["explained_variance"] = explained_variance(_flat01(traj.values), _flat01(returns))
        out["learning_rate"] = lr
        out["cliprange"] = cliprange
        new_state = PPOTrainState(env_state=env_state, obs=obs, last_done=last_done,
                                  rnn_state=rnn_state, update_idx=state.update_idx + 1)
        return new_state, out

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
    save_interval: int = 0,
    load_path: str | None = None,
    value_network: str | None = None,
    microbatch_size: int | None = None,
    pipeline: bool | None = None,
    mesh=None,
    adv_norm: str = "minibatch",
    clip_value: bool = True,
    adam_epsilon: float = 1e-5,
    device=None,
    **network_kwargs,
) -> Model:
    """Train ppo2 (ppo2/ppo2.py:21-218), logging the keys of ppo.py:589-599.

    Takes every keyword of the JAX package's ``learn``; those whose part is not ported
    yet raise ``NotImplementedError`` naming the item of ROADMAP.md's Queue 1 that
    brings it. ``pipeline=None`` picks the on-device rollout, as the JAX package does
    for a device env. ``device`` is the card unless the caller passes ``"cpu"``;
    ``env_kwargs`` go to ``build_env`` (``normalize``, ``reward_scale``,
    ``frame_stack``, ``s2d``) and the remaining keywords to the network (for example
    ``dtype=torch.bfloat16``)."""
    if pipeline:
        not_ported("ppo2", "pipeline", "item 8 (the host pipeline)")
    if mesh is not None:
        not_ported("ppo2", "mesh", "item 5 (data parallelism)")
    device = resolve_device(device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    venv = env if env is not None else build_env(env_id, num_envs, device=device,
                                                 **(env_kwargs or {}))
    nbatch = venv.num_envs * nsteps
    nupdates = max(total_timesteps // nbatch, 1) if total_timesteps > 0 else 0

    init_gen = torch.Generator().manual_seed(seed)
    policy = build_policy(venv.observation_space, venv.action_space, network, device=device,
                          generator=init_gen, value_network=value_network, **network_kwargs)
    opt = ClipAdam(policy.module.parameters(), max_grad_norm, eps=adam_epsilon)
    draws = Draws(seed, device)
    obs, env_state = venv.reset(draws)
    state = PPOTrainState(env_state=env_state, obs=obs,
                          last_done=torch.zeros((venv.num_envs,), dtype=torch.bool, device=device),
                          rnn_state=policy.initial_state(venv.num_envs))
    update_fn = make_update_fn(
        policy, venv, opt, nsteps=nsteps, nminibatches=nminibatches, noptepochs=noptepochs,
        gamma=gamma, lam=lam, ent_coef=ent_coef, vf_coef=vf_coef,
        lr_fn=resolve_fraction_schedule(lr), cliprange_fn=resolve_fraction_schedule(cliprange),
        nupdates=nupdates, microbatch_size=microbatch_size, adv_norm=adv_norm,
        clip_value=clip_value,
    )

    model = Model(policy, state, opt, draws)
    if load_path is not None:
        model.load(load_path)
    start_update = 0
    if save_interval and logger.get_dir() and load_path is None:
        latest = latest_checkpoint(logger.get_dir())
        if latest is not None:
            state = model.load_full(latest).state
            start_update = state.update_idx
            logger.log(f"Resuming from checkpoint {latest} (update {start_update})")

    tfirststart = time.time()
    tlastlog, lastlog_update = tfirststart, start_update
    for update in range(start_update + 1, nupdates + 1):
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
        model.state = state
        if save_interval and (update % save_interval == 0 or update == 1) and logger.get_dir():
            model.save_full(periodic_path(logger.get_dir(), update))
    return model
