"""PPO with the clipped surrogate (counterpart of baselines_tpu/algos/ppo/ppo.py).

Loss as ppo2/model.py:46-116: clipped value loss (or ppo1's plain value MSE with
``clip_value=False``), clipped ratio surrogate, entropy bonus, approxkl and clipfrac,
with advantages normalized per minibatch (or once over the whole batch with
``adv_norm="batch"``, ppo1's standardization). Schedule as
ppo2/ppo2.py:21-218: noptepochs x nminibatches of shuffled minibatch steps, the
learning rate and clip range annealed by the remaining fraction of training.

Ported: feedforward and recurrent policies, a shared latent or a separate value
tower (``value_network="copy"``), gradient microbatching, data parallelism over a
``Mesh`` of ranks (``mesh``), and the antiphase rollout over two groups of host envs
(``pipeline``, ``envs/host_pipeline.py``). Each update
is a rollout, GAE, then the epochs. A feedforward epoch draws a fresh permutation of the
samples and gathers every field of the batch through the row-gather kernel
(``ops/gather.py``); a recurrent epoch permutes the envs and replays whole env sequences
from the carry before the rollout, the encoder once over all frames and the LSTM cell
step by step, with plain indexing as the JAX package takes them (ppo.py:240-261).

Under a mesh each rank steps ``num_envs / size`` envs and the epochs are shard-local, as
in the JAX package's mesh run (ppo.py:263-306, 331-372): each rank permutes its own
samples (or envs) and every minibatch is an equal slice of every rank's, so the
row-gather kernel stays on the rank's rows. What crosses the ranks: the minibatch's
advantage moments (or the whole batch's, with ``adv_norm="batch"``) and the gradients
before the clip, at each minibatch; VecNormalize's statistics at each env step; the
monitor's episodes once a rollout; the metrics and the moments of
``explained_variance`` on the updates that log.

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

from baselines_tpu_torch.algos.common import (ClipAdam, Model, build_env, build_env_pair,
                                              init_pipe_state, learner_device, mesh_metrics,
                                              run_rollout, run_rollout_pipelined,
                                              update_metrics)
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.checkpoint import latest_checkpoint, periodic_path
from baselines_tpu_torch.core.rng import Draws, ShardedDraws
from baselines_tpu_torch.distributed.collectives import merge_moments
from baselines_tpu_torch.distributed.mesh import check_mesh, local_num_envs
from baselines_tpu_torch.core.schedules import resolve_fraction_schedule
from baselines_tpu_torch.data.gae import gae
from baselines_tpu_torch.envs.registry import is_torch_env
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


def _normalize_advs(returns: torch.Tensor, values: torch.Tensor, mesh=None) -> torch.Tensor:
    """Standardized advantages, the standard deviation the root of the variance as
    ``jnp.std`` takes it; under a mesh by the moments of every rank's advantages
    (ppo.py:183-189 over the minibatch merged from the shards, :352-358)."""
    advs = returns - values
    mean, var = advs.mean(), advs.var(correction=0)
    if mesh is not None:
        mean, var = merge_moments(mean, var, mesh)
    return (advs - mean) / (torch.sqrt(var) + 1e-8)


def make_update_fn(policy, venv, opt: ClipAdam, *, nsteps, nminibatches, noptepochs, gamma,
                   lam, ent_coef, vf_coef, lr_fn, cliprange_fn, nupdates,
                   microbatch_size: int | None = None, adv_norm: str = "minibatch",
                   clip_value: bool = True, mesh=None, pipelined: bool = False):
    """One PPO update (ppo.py:130-396): ``update_fn(state, draws) -> (state, metrics)``.
    The rollout takes its draws first, then each epoch one permutation.
    ``adv_norm="batch"`` standardizes the advantages once over the whole batch and
    shuffles them with the other fields.

    A feedforward policy's epoch permutes the T * N samples and gathers every field
    through the row-gather kernel. A recurrent policy's epoch permutes the N envs and
    takes whole env sequences, (T, N / nminibatches, ...), each minibatch replayed from
    its envs' carry before the rollout (ppo.py:240-261), so ``nminibatches`` must
    divide N. ``microbatch_size`` splits each feedforward minibatch, its advantages
    already standardized, into microbatches whose gradients and metrics are averaged
    before the one optimizer step (ppo.py:183-206).

    With a ``mesh``, ``venv`` holds the rank's envs, ``draws`` gives the rank's rows and
    its shard's permutations (``core.rng.ShardedDraws``), and ``opt`` averages the
    gradients over the ranks. Each rank's epoch permutes its own samples (or envs) and
    takes 1/size of every minibatch from them; a microbatch takes ``microbatch_size /
    size`` of the rank's rows. The advantage moments are the whole mesh's, and so is the
    monitor's ring after the rollout; the metrics are the rank's shares, which
    ``algos.common.mesh_metrics`` reduces.

    ``pipelined`` takes the rollout from ``run_rollout_pipelined`` over ``venv``, a
    ``PipelinedHostVecPair`` whose state (``state.env_state``) is a ``PipeState``
    (ppo.py:214-217): the draws of each step are group A's noise, then group B's, and
    the state's ``obs`` and ``last_done`` stay as they are. GAE, the epochs and the
    minibatch steps are the same."""
    if adv_norm not in ("minibatch", "batch"):
        raise ValueError(f"adv_norm must be 'minibatch' or 'batch', got {adv_norm!r}")
    size = 1 if mesh is None else mesh.size
    nenvs = venv.num_envs  # the rank's
    nbatch = nenvs * nsteps
    nbatch_train = nbatch // nminibatches
    recurrent = policy.is_recurrent
    if pipelined and recurrent:
        raise AssertionError("pipelined rollouts support feedforward policies")
    if recurrent and nenvs % nminibatches:
        raise ValueError(f"recurrent PPO needs nminibatches ({nminibatches}) to divide "
                         f"num_envs ({nenvs} on each of {size} ranks) (ppo2/ppo2.py:107)")
    if mesh is not None and nbatch % nminibatches:
        raise ValueError(f"nminibatches ({nminibatches}) must divide each rank's "
                         f"{nbatch} samples under a mesh (ppo.py:344)")
    if recurrent and microbatch_size is not None:
        raise NotImplementedError("microbatching a recurrent policy is not supported, as in "
                                  "the JAX package (ppo.py:181)")
    if microbatch_size is not None and (microbatch_size % size
                                        or nbatch_train % (microbatch_size // size)):
        raise ValueError(f"microbatch_size {microbatch_size} does not divide the minibatch "
                         f"of {nbatch_train * size}" + (f" in {size} equal rank slices"
                                                         if size > 1 else ""))
    micro = None if microbatch_size is None else microbatch_size // size
    loss_fn = make_ppo_loss(policy, ent_coef, vf_coef, clip_value)
    params = opt.params

    def minibatch_grads(mb, advs, cliprange, rnn_init):
        """The minibatch's gradients and metrics, the mean over its microbatches when
        ``microbatch_size`` is set (ppo2/microbatched_model.py:35-75)."""
        if micro is None:
            loss, metrics = loss_fn(mb, advs, cliprange, rnn_init)
            return torch.autograd.grad(loss, params), metrics
        nmicro = nbatch_train // micro
        grads, metrics = None, []
        for j in range(nmicro):
            part = slice(j * micro, (j + 1) * micro)
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
        if pipelined:
            env_state, traj, last_value = run_rollout_pipelined(policy, venv, draws,
                                                                state.env_state, nsteps)
            obs, last_done, rnn_state = state.obs, state.last_done, state.rnn_state
        else:
            env_state, obs, last_done, traj, last_value, rnn_state = run_rollout(
                policy, venv, draws, state.env_state, state.obs, state.last_done, nsteps,
                rollout_init_rnn)
        env_state = VecMonitor.sync_stats(env_state, mesh)
        advs, returns = gae(traj.rewards, traj.values, traj.dones, last_value, gamma, lam)
        batch_t = [traj.obs, traj.actions, returns, traj.values, traj.neglogps, traj.rnn_masks]
        if adv_norm == "batch":
            batch_t.append(_normalize_advs(returns, traj.values, mesh))

        metrics = []

        def train(mb, rnn_init):
            mb_advs = mb.pop() if adv_norm == "batch" else _normalize_advs(mb[2], mb[3], mesh)
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
        out = update_metrics(out, _flat01(traj.values), _flat01(returns), mesh)
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

    Takes every keyword of the JAX package's ``learn``. ``pipeline`` steps two groups
    of host envs in antiphase (``envs/host_pipeline.py``); None turns it on, as the JAX
    package does (ppo.py:423-440), for an ``env_id`` that is not a device env (a
    ``native:`` or gymnasium id) with an even ``num_envs`` >= 2, no ``env`` and no mesh,
    and a string network that is not recurrent; a device env always takes the serial
    rollout, and ``pipeline=True`` on one fails. ``mesh``, a ``Mesh`` from
    ``distributed.make_mesh``, trains data
    parallel: every rank of the mesh calls ``learn`` with the same arguments, steps
    ``num_envs / size`` of the envs on the mesh's device (an ``env`` given is the
    rank's) and holds the same params; the log and the checkpoints are the whole
    mesh's, written by rank 0. ``device`` is the card unless the caller passes ``"cpu"``;
    ``env_kwargs`` go to ``build_env`` (``normalize``, ``reward_scale``,
    ``frame_stack``, ``s2d``) and the remaining keywords to the network (for example
    ``dtype=torch.bfloat16``)."""
    check_mesh(mesh, "ppo2's mesh")
    if pipeline is None:
        pipeline = (env is None and env_id is not None and not is_torch_env(env_id)
                    and num_envs >= 2 and num_envs % 2 == 0 and mesh is None
                    and isinstance(network, str) and "lstm" not in network)
    device = learner_device(mesh, device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    if pipeline:
        if env is not None:
            raise AssertionError("pipeline mode builds its own env pair from env_id")
        venv = build_env_pair(env_id, num_envs, device=device, **(env_kwargs or {}))
    else:
        venv = env if env is not None else build_env(
            env_id, local_num_envs(mesh, num_envs), device=device, axis_name=mesh,
            **(env_kwargs or {}))
    nbatch = venv.num_envs * nsteps * (1 if mesh is None else mesh.size)
    nupdates = max(total_timesteps // nbatch, 1) if total_timesteps > 0 else 0

    init_gen = torch.Generator().manual_seed(seed)
    policy = build_policy(venv.observation_space, venv.action_space, network, device=device,
                          generator=init_gen, value_network=value_network, **network_kwargs)
    opt = ClipAdam(policy.module.parameters(), max_grad_norm, eps=adam_epsilon, mesh=mesh)
    draws = Draws(seed, device) if mesh is None else ShardedDraws(Draws(seed, device), mesh)
    if pipeline:  # ppo.py:474-489: A's reset, B's, then B's first action in flight
        reset_a = venv.a.reset(draws)
        reset_b = venv.b.reset(draws)
        obs = reset_a[0]
        env_state = init_pipe_state(policy, venv, draws, reset_a, reset_b)
    else:
        obs, env_state = venv.reset(draws)
    state = PPOTrainState(env_state=env_state, obs=obs,
                          last_done=torch.zeros((venv.num_envs,), dtype=torch.bool, device=device),
                          rnn_state=policy.initial_state(venv.num_envs))
    update_fn = make_update_fn(
        policy, venv, opt, nsteps=nsteps, nminibatches=nminibatches, noptepochs=noptepochs,
        gamma=gamma, lam=lam, ent_coef=ent_coef, vf_coef=vf_coef,
        lr_fn=resolve_fraction_schedule(lr), cliprange_fn=resolve_fraction_schedule(cliprange),
        nupdates=nupdates, microbatch_size=microbatch_size, adv_norm=adv_norm,
        clip_value=clip_value, mesh=mesh, pipelined=pipeline,
    )

    model = Model(policy, state, opt, draws, mesh)
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
            metrics = mesh_metrics(metrics, mesh)
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
