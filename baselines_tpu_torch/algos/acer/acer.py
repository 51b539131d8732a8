"""ACER: actor-critic with experience replay (counterpart of
baselines_tpu/algos/acer/acer.py, after baselines/acer).

- Retrace(lambda = 1) targets, ``q_retrace`` (acer.py:25-51), a reverse loop over T;
- truncated importance weights min(c, rho) with the bias correction
  relu(1 - c / rho) (c = 10, :131-144);
- the trust region in the space of the softmax probabilities f around the Polyak-averaged
  policy (:155-176): with k = -f_avg / f and the ascent direction g, the step is
  g - max(0, (k.g - delta) / |k|^2) k, delta = 1;
- the average policy, avg = alpha avg + (1 - alpha) params after each step (alpha 0.99);
- a q head (``build_policy(estimate_q=True)``), V = sum_a f q;
- clip-then-RMSProp (``ClipRMSProp``: clip 10, decay 0.99, eps 1e-5), q_coef 0.5,
  ent_coef 0.01, the learning rate annealed linearly by default;
- a replay of whole (T, N) trajectory chunks, ``buffer_size // nsteps`` of them, sampled
  Poisson(``replay_ratio``) times after each on-policy update once ``replay_start``
  steps have run (:374-379), the counts drawn by numpy's ``RandomState(seed)`` as in the
  JAX package.

``train_chunk`` takes one forward of f and q over the chunk's (T + 1) * N observations
and builds the cotangents by hand, as the JAX package's single ``vjp`` does: on f, the
gradient of the policy loss (taken on a detached copy of f), trust-region-adjusted; on
q, q_coef (q_i - qret) onehot(a) / (T N). ``torch.autograd.grad((f, q), params,
grad_outputs=...)`` then gives the params' gradient in one backward.

The replay keeps the JAX package's flat layout (``ChunkReplay``): each chunk's
observations are one row of (T + 1) * prod(ob_shape) elements, or with ``dedup_frames``
= k > 1 the first stacked observation and a flat row of the T newest frames
(``data/frame_chunk.py``); rows are reshaped on the sample, never the whole ring. A
sample reads each field through the row-gather kernel (``ops/gather.py``): five
launches, six with ``dedup_frames``.

Draws in order: an on-policy update's rollout (the action noise, then the env's, a
step), then for each replay update its chunk indices.

Under a data-parallel mesh (``mesh``) each rank steps ``num_envs / size`` envs, as the
JAX package's mesh run shards the rollout (acer.py:394-397), and the replay is
replicated: each on-policy chunk is gathered from every rank in env order, in its
storage layout and one call, and added to every rank's ring; a replay update's chunk
indices are drawn for all ``num_envs`` rows at once and each rank reads its own rows
(the ``ShardedDraws`` of the env axis). Each rank trains on its rows, and the gradients
are averaged over the ranks. That is the one-process step because every term of
``train_chunk`` is a mean over equal per-env rows (Retrace runs along each env's time
axis, the trust region adjusts each row), and the ``(t * n)`` scalings, taken with the
rank's ``n``, cancel against the rank's means, so the average over the ranks divides by
the whole ``t * N``. The average policy then moves alike on every rank. The metrics are
the rank's shares, reduced on the updates that log.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass
from typing import Any, ClassVar

import numpy as np
import torch
import torch.nn.functional as F

from baselines_tpu_torch.algos.a2c.a2c import a2c_lr
from baselines_tpu_torch.algos.common import (ClipRMSProp, Model, build_env, learner_device,
                                              mesh_metrics, update_metrics)
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws, ShardedDraws
from baselines_tpu_torch.data.frame_chunk import compress_frames, decompress_frames
from baselines_tpu_torch.data.replay import ReplayBuffer, ReplayState
from baselines_tpu_torch.distributed.collectives import all_gather_fields
from baselines_tpu_torch.distributed.mesh import check_mesh, local_num_envs
from baselines_tpu_torch.envs.spaces import Discrete, torch_dtype
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.policy import build_policy

EPS = 1e-6


def q_retrace(rewards, dones, q_i, values, rho_i, gamma: float) -> torch.Tensor:
    """Retrace targets, time-major: rewards, dones, q_i and rho_i (T, N), values
    (T + 1, N); returns qret (T, N)."""
    rho_bar = torch.clamp(rho_i, max=1.0)
    out = torch.empty_like(rewards)
    qret = values[-1]
    for t in range(rewards.shape[0] - 1, -1, -1):
        qret = rewards[t] + gamma * qret * (1.0 - dones[t])
        out[t] = qret
        qret = rho_bar[t] * (qret - q_i[t]) + values[t]
    return out


class ChunkReplay:
    """A ring of ``capacity`` whole chunks in the flat layout (acer.py:152-220)."""

    def __init__(self, capacity: int, nsteps: int, ob_space, nact: int, dedup_frames: int):
        self.buffer = ReplayBuffer(capacity)
        self.nsteps = nsteps
        self.ob_shape = tuple(ob_space.shape)
        self.ob_dtype = torch_dtype(ob_space.dtype)
        self.nact = nact
        self.dedup = dedup_frames if dedup_frames > 1 else 0
        if self.dedup:
            kc = self.ob_shape[-1]
            if kc % self.dedup:
                raise ValueError(f"dedup_frames={dedup_frames} needs frame-stacked obs; the "
                                 f"last axis is {kc}")
            self.frames_shape = (nsteps,) + self.ob_shape[:-1] + (kc // self.dedup,)

    def init(self, device) -> ReplayState:
        t = self.nsteps
        item = {"actions": torch.zeros((t,), dtype=torch.int32, device=device),
                "rewards": torch.zeros((t,), device=device),
                "mus": torch.zeros((t, self.nact), device=device),
                "dones": torch.zeros((t,), device=device)}
        if self.dedup:
            item["obs0"] = torch.zeros(self.ob_shape, dtype=self.ob_dtype, device=device)
            item["frames"] = torch.zeros((math.prod(self.frames_shape),), dtype=self.ob_dtype,
                                         device=device)
        else:
            item["obs"] = torch.zeros(((t + 1) * math.prod(self.ob_shape),),
                                      dtype=self.ob_dtype, device=device)
        return self.buffer.init(item)

    def to_stored(self, chunk: dict) -> dict:
        """An env-major chunk, obs (N, T + 1, ...), in the storage layout."""
        out = {k: v for k, v in chunk.items() if k != "obs"}
        n = chunk["obs"].shape[0]
        if not self.dedup:
            out["obs"] = chunk["obs"].reshape(n, -1)
        else:
            out["obs0"], frames = compress_frames(chunk["obs"], chunk["dones"], self.dedup)
            out["frames"] = frames.reshape(n, -1)
        return out

    def to_full(self, stored: dict) -> dict:
        """The storage layout back to an env-major chunk with stacked observations."""
        out = {k: v for k, v in stored.items() if k not in ("obs", "obs0", "frames")}
        n = stored["actions"].shape[0]
        if not self.dedup:
            out["obs"] = stored["obs"].reshape((n, self.nsteps + 1) + self.ob_shape)
        else:
            frames = stored["frames"].reshape((n,) + self.frames_shape)
            out["obs"] = decompress_frames(stored["obs0"], frames, stored["dones"], self.dedup)
        return out

    def add(self, state: ReplayState, chunk: dict, mesh=None) -> ReplayState:
        """Add an env-major chunk; under a ``mesh`` every rank's chunk, gathered in the
        storage layout in one call."""
        stored = self.to_stored(chunk)
        if mesh is not None:
            stored = all_gather_fields(stored, mesh)
        return self.buffer.add_batch(state, stored)

    def sample(self, state: ReplayState, draws, n: int) -> dict:
        return self.to_full(self.buffer.sample(state, draws, n)[0])


@dataclass
class ACERTrainState:
    """What an update carries to the next: the env, the replay, the average policy (a
    module of the policy's architecture) and the update count; the params live in the
    policy's module and the RMSProp moments in the optimizer. Under a mesh ``env_state``
    and ``obs`` are the rank's envs'; the replay is replicated."""

    replicated_fields: ClassVar = ("replay",)

    env_state: Any
    obs: torch.Tensor
    replay: ReplayState
    avg: torch.nn.Module
    update_idx: int = 0


@torch.no_grad()
def rollout_chunk(policy, venv, draws, env_state, obs, nsteps: int):
    """An on-policy chunk with the behaviour probabilities (acer.py:317-342): (env_state,
    obs, chunk), the chunk env-major, obs (N, T + 1, ...), the others (N, T, ...)."""
    module, pdtype = policy.module, policy.pdtype
    obs_t, act_t, rew_t, mu_t, done_t = [], [], [], [], []
    for _ in range(nsteps):
        pdflat = module(obs)[0]
        pd = pdtype.pdfromflat(pdflat)
        action = pd.sample(pd.noise(draws))
        nobs, env_state, rew, done, _ = venv.step(draws, env_state, action)
        obs_t.append(obs)
        act_t.append(action)
        rew_t.append(rew)
        mu_t.append(torch.softmax(pdflat, dim=-1))
        done_t.append(done.to(torch.float32))
        obs = nobs
    chunk = {"obs": torch.stack(obs_t + [obs], dim=1), "actions": torch.stack(act_t, dim=1),
             "rewards": torch.stack(rew_t, dim=1), "mus": torch.stack(mu_t, dim=1),
             "dones": torch.stack(done_t, dim=1)}
    return env_state, obs, chunk


def make_train_chunk(policy, opt: ClipRMSProp, *, nsteps: int, q_coef: float,
                     ent_coef: float, gamma: float, c: float, trust_region: bool,
                     alpha: float, delta: float, mesh=None):
    """``train_chunk(avg, lr_now, chunk) -> metrics``: one step of the params on an
    env-major (N, T) chunk and the average policy's update (acer.py:226-315). Under a
    ``mesh`` the chunk is the rank's rows, ``opt`` averages the gradients over the
    ranks, and the metrics are the rank's shares."""
    module = policy.module
    params = opt.params
    nact = policy.ac_space.n

    def train_chunk(avg, lr_now: float, chunk: dict) -> dict:
        obs_c = chunk["obs"].transpose(0, 1)  # (T + 1, N, ...)
        actions, rewards, mus, dones = (chunk[k].transpose(0, 1)
                                        for k in ("actions", "rewards", "mus", "dones"))
        t, n = nsteps, actions.shape[1]
        obs_flat = obs_c.reshape(((t + 1) * n,) + tuple(obs_c.shape[2:]))
        pdflat, q_all, _ = module(obs_flat)
        f_all = torch.softmax(pdflat, dim=-1).reshape(t + 1, n, nact)
        q_all = q_all.reshape(t + 1, n, nact)
        f, q = f_all[:-1].reshape(t * n, nact), q_all[:-1].reshape(t * n, nact)

        with torch.no_grad():
            v_all = torch.sum(f_all * q_all, dim=-1)  # (T + 1, N)
            f_pol = torch.softmax(avg(obs_flat)[0], dim=-1).reshape(t + 1, n, nact)[:-1]
            f_pol = f_pol.reshape(t * n, nact)
            a = actions.reshape(-1).long()[:, None]
            fd, qd = f.detach(), q.detach()
            f_i, q_i = fd.gather(1, a)[:, 0], qd.gather(1, a)[:, 0]
            rho = fd / (mus.reshape(-1, nact) + EPS)
            rho_i = rho.gather(1, a)[:, 0]
            qret = q_retrace(rewards, dones, q_i.reshape(t, n), v_all, rho_i.reshape(t, n),
                             gamma).reshape(-1)
            v = v_all[:-1].reshape(-1)
            coef_f = (qret - v) * torch.clamp(rho_i, max=c)
            coef_bc = (qd - v[:, None]) * F.relu(1.0 - torch.full_like(rho, c) / (rho + EPS)) * fd

        def loss_pol_of_f(f_var):
            f_i_v = f_var.gather(1, a)[:, 0]
            gain_f = torch.log(f_i_v + EPS) * coef_f
            gain_bc = torch.sum(torch.log(f_var + EPS) * coef_bc, dim=1)
            entropy = -torch.sum(f_var * torch.log(f_var + EPS), dim=1)
            return -torch.mean(gain_f) - torch.mean(gain_bc) - ent_coef * torch.mean(entropy)

        f_var = fd.clone().requires_grad_(True)
        loss_policy = loss_pol_of_f(f_var)
        dldf, = torch.autograd.grad(loss_policy, f_var)
        with torch.no_grad():
            if trust_region:
                g_asc = -dldf * (t * n)  # the ascent direction (acer.py:156's scaling)
                k = -f_pol / (fd + EPS)
                adj = torch.clamp((torch.sum(k * g_asc, dim=-1) - delta)
                                  / (torch.sum(torch.square(k), dim=-1) + EPS), min=0.0)
                ct_f = -(g_asc - adj[:, None] * k) / (t * n)
            else:
                ct_f = dldf
            ct_q = q_coef * (q_i - qret)[:, None] * F.one_hot(a[:, 0], nact) / (t * n)
        grads = torch.autograd.grad((f, q), params, grad_outputs=(ct_f, ct_q))
        opt.step(grads, lr_now)
        with torch.no_grad():
            for pa, p in zip(avg.parameters(), params):
                pa.copy_(alpha * pa + (1 - alpha) * p)
            return update_metrics({
                "loss_policy": loss_policy.detach(),
                "loss_q": 0.5 * torch.mean(torch.square(qret - q_i)),
                "entropy": torch.mean(-torch.sum(fd * torch.log(fd + EPS), dim=1))},
                q_i, qret, mesh, ev_name="ev_q")

    return train_chunk


def make_update_fns(policy, venv, opt: ClipRMSProp, replay: ChunkReplay, *, nsteps: int,
                    lr: float, lrschedule: str, nupdates: int, mesh=None, **train_kwargs):
    """(``onpolicy_update(state, draws)``, ``replay_update(state, draws)``), each ->
    (state, metrics) (acer.py:344-374): a rollout chunk added to the replay and trained
    on; a replayed chunk of as many envs trained on. Both take the learning rate of the
    state's update count. Under a ``mesh`` (``draws`` a ``ShardedDraws``) the rollout and
    the replayed rows are the rank's and every rank's chunk goes to the replay."""
    train_chunk = make_train_chunk(policy, opt, nsteps=nsteps, mesh=mesh, **train_kwargs)
    nenvs = venv.num_envs

    def onpolicy_update(state: ACERTrainState, draws):
        lr_now = a2c_lr(lr, lrschedule, state.update_idx, nupdates)
        env_state, obs, chunk = rollout_chunk(policy, venv, draws, state.env_state, state.obs,
                                              nsteps)
        env_state = VecMonitor.sync_stats(env_state, mesh)
        buf = replay.add(state.replay, chunk, mesh)
        metrics = train_chunk(state.avg, lr_now, chunk)
        return ACERTrainState(env_state=env_state, obs=obs, replay=buf, avg=state.avg,
                              update_idx=state.update_idx + 1), metrics

    def replay_update(state: ACERTrainState, draws):
        lr_now = a2c_lr(lr, lrschedule, state.update_idx, nupdates)
        # under a mesh the rank's rows of the whole sample's chunk indices
        metrics = train_chunk(state.avg, lr_now, replay.sample(state.replay, draws, nenvs))
        return state, metrics

    return onpolicy_update, replay_update


def learn(
    *,
    env=None,
    env_id: str | None = None,
    network: str = "cnn",
    total_timesteps: int = int(80e6),
    seed: int | None = None,
    num_envs: int = 16,
    env_kwargs: dict | None = None,
    nsteps: int = 20,
    q_coef: float = 0.5,
    ent_coef: float = 0.01,
    max_grad_norm: float = 10,
    lr: float = 7e-4,
    lrschedule: str = "linear",
    rprop_epsilon: float = 1e-5,
    rprop_alpha: float = 0.99,
    gamma: float = 0.99,
    log_interval: int = 100,
    buffer_size: int = 50000,
    replay_ratio: int = 4,
    replay_start: int = 10000,
    c: float = 10.0,
    trust_region: bool = True,
    alpha: float = 0.99,
    delta: float = 1.0,
    dedup_frames: int = 0,
    frame_stack: int = 0,
    load_path: str | None = None,
    mesh=None,
    device=None,
    **network_kwargs,
) -> Model:
    """acer.learn (acer.py:78-116 signature and defaults), logging the keys of
    acer.py:417-421. ``dedup_frames`` = k stores frames rather than k-frame stacks and
    restacks them on the sample; it needs k-frame-stacked observations (``frame_stack``
    = k here, or a stacked ``env``). ``mesh``, a ``Mesh`` from ``distributed.make_mesh``,
    trains data parallel: every rank calls ``learn`` with the same arguments and steps
    ``num_envs / size`` of the envs on the mesh's device (an ``env`` given is the rank's).
    ``device`` is the card unless the caller passes ``"cpu"``; the remaining keywords go
    to the network."""
    check_mesh(mesh, "acer's mesh")
    if lrschedule not in ("linear", "constant"):
        raise ValueError(f"lrschedule must be 'linear' or 'constant', got {lrschedule!r}")
    device = learner_device(mesh, device)
    rng = np.random.RandomState(seed if seed is not None else 0)  # the replay counts
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    venv = env if env is not None else build_env(
        env_id, local_num_envs(mesh, num_envs), device=device, axis_name=mesh,
        frame_stack=frame_stack, **(env_kwargs or {}))
    if not isinstance(venv.action_space, Discrete):
        raise ValueError(f"acer needs Discrete actions, got {venv.action_space!r}")
    nenvs = venv.num_envs * (1 if mesh is None else mesh.size)
    nupdates = max(total_timesteps // (nenvs * nsteps), 1) if total_timesteps > 0 else 0

    policy = build_policy(venv.observation_space, venv.action_space, network, device=device,
                          generator=torch.Generator().manual_seed(seed), estimate_q=True,
                          **network_kwargs)
    if policy.is_recurrent:  # acer.py:131-143
        raise ValueError("recurrent ACER is not supported, as in the JAX package: stale "
                         "stored carries bias the Retrace targets; use ppo2 or a2c")
    opt = ClipRMSProp(policy.module.parameters(), max_grad_norm, decay=rprop_alpha,
                      eps=rprop_epsilon, mesh=mesh)
    replay = ChunkReplay(max(buffer_size // nsteps, 1), nsteps, venv.observation_space,
                         venv.action_space.n, dedup_frames)
    draws = Draws(seed, device) if mesh is None else ShardedDraws(Draws(seed, device), mesh)
    obs, env_state = venv.reset(draws)
    state = ACERTrainState(env_state=env_state, obs=obs, replay=replay.init(device),
                           avg=copy.deepcopy(policy.module))
    onpolicy_update, replay_update = make_update_fns(
        policy, venv, opt, replay, nsteps=nsteps, lr=lr, lrschedule=lrschedule,
        nupdates=nupdates, mesh=mesh, q_coef=q_coef, ent_coef=ent_coef, gamma=gamma, c=c,
        trust_region=trust_region, alpha=alpha, delta=delta)
    model = Model(policy, state, opt, draws, mesh)
    if load_path is not None:
        model.load(load_path)

    tstart = time.time()
    for update in range(1, nupdates + 1):
        state, metrics = onpolicy_update(state, draws)
        if replay_ratio > 0 and update * nenvs * nsteps >= replay_start:
            for _ in range(rng.poisson(replay_ratio)):
                state, _ = replay_update(state, draws)
        model.state = state
        if log_interval and (update % log_interval == 0 or update == 1):
            metrics = mesh_metrics(metrics, mesh, ev_name="ev_q")
            stats = VecMonitor.get_stats(state.env_state)
            logger.logkv("total_timesteps", update * nenvs * nsteps)
            logger.logkv("fps", int(update * nenvs * nsteps / (time.time() - tstart)))
            logger.logkv("mean_episode_reward", float(stats.mean_return))
            for k, v in metrics.items():
                logger.logkv(k, float(v))
            logger.dumpkvs()
    model.state = state
    return model
