"""GAIL: a TRPO generator driven by a learned adversary's reward (counterpart of
baselines_tpu/algos/gail/gail.py, after baselines/gail/trpo_mpi.py, with the
behavior-cloning pretraining of gail/behavior_clone.py).

An iteration (gail.py:318-500):

- the rollout, whose env rewards are kept for logging only;
- the rewards relabelled by the discriminator, -log(1 - D(obs, action)), on the raw
  observations and the executed (clipped) Box actions; where the env is normalized
  (only when a normalized ``env`` is passed: the default is raw observations), raw
  observations are rebuilt from its statistics;
- GAE, then trpo's policy step (``trpo.natural_step``: the Fisher-vector product as a
  double backward on every ``fvp_subsample``-th sample, conjugate gradient, the line
  search stopping at the first passing probe) and trpo's value fit (``trpo.value_fit``,
  ``vf_iters`` epochs of Adam on 64-sample minibatches gathered through K2);
- every ``g_step``-th iteration a discriminator round: its observation statistics fold
  in the generator's and the expert's rows, then ``d_step`` Adam steps. The other
  iterations log -1 for both accuracies, not NaN (gail.py:484-491).

With ``policy_obfilter`` (the default) the policy normalizes its observations by its own
running statistics, clipped to +-5 (gail/mlp_policy.py:34-42), which fold in each
rollout's observations before the step; the discriminator sees raw observations.

The expert sample of an iteration (``nbatch`` rows, two K2 launches) is drawn before its
rollout. Draws in order: the expert sample's indices, the rollout's, the value epochs'
permutations.

``GAILModel.save`` carries the policy (its observation statistics included), the
adversary (``gail_adversary``: the discriminator, its Adam state and observation
statistics, the value tower's Adam state), the iteration count and, where the training
env was normalized, its VecNormalize statistics. The reference's save keeps neither of
the last two; the port keeps both, a deliberate difference. ``load`` parses the file
once, and reads a payload of params alone too: a policy without observation statistics
loads into the unfiltered policy, for evaluation.

Under a data-parallel mesh (``mesh``) gail is not sharded: the JAX package's gail takes
``mesh`` and never uses it (gail.py:227), so every rank runs the whole one-process
learner on the mesh's device, all ``num_envs`` envs and the same draws, and computes the
one-process numbers bit for bit. The logger's rows come from rank 0 alone
(``logger.configure_for_process``; its collective ``dumpkvs`` averages equal values),
and ``run.main`` saves from rank 0 alone.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn as nn

from baselines_tpu_torch.algos.common import (ClipAdam, Model, build_env, learner_device,
                                              run_rollout)
from baselines_tpu_torch.algos.gail.adversary import (Discriminator, adversary_loss,
                                                      adversary_reward)
from baselines_tpu_torch.algos.gail.behavior_clone import pretrain_bc
from baselines_tpu_torch.algos.gail.dataset import ExpertDataset
from baselines_tpu_torch.algos.trpo.trpo import natural_step, split_params, value_fit
from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.core.running_stats import RunningMeanStd
from baselines_tpu_torch.data.gae import gae
from baselines_tpu_torch.distributed.mesh import check_mesh
from baselines_tpu_torch.envs.spaces import Box
from baselines_tpu_torch.envs.vec import (VecMonitor, VecNormalize, find_normalize_state,
                                          replace_normalize_stats)
from baselines_tpu_torch.nn.policy import Policy, build_policy

OB_CLIP = 5.0


class ObsNormPolicyValueNet(nn.Module):
    """A PolicyValueNet (``pi``) behind its observation filter: ``forward`` feeds it
    clip((obs - mean) / sqrt(var + 1e-8), +-5). The statistics are buffers
    (``ob_rms_mean``, ``ob_rms_var``, ``ob_rms_count``), so they are saved with the
    params and move with no gradient (the JAX package's {"pi", "ob_rms"} params)."""

    def __init__(self, inner: nn.Module, ob_shape):
        super().__init__()
        self.pi = inner
        self.is_recurrent = inner.is_recurrent
        self.ob_space = inner.ob_space
        rms = RunningMeanStd.create(tuple(ob_shape), device=next(inner.parameters()).device)
        self.register_buffer("ob_rms_mean", rms.mean)
        self.register_buffer("ob_rms_var", rms.var)
        self.register_buffer("ob_rms_count", rms.count)

    @property
    def ob_rms(self) -> RunningMeanStd:
        return RunningMeanStd(mean=self.ob_rms_mean, var=self.ob_rms_var,
                              count=self.ob_rms_count)

    @torch.no_grad()
    def set_ob_rms(self, rms: RunningMeanStd) -> None:
        self.ob_rms_mean.copy_(rms.mean)
        self.ob_rms_var.copy_(rms.var)
        self.ob_rms_count.copy_(rms.count)

    def normalize(self, obs: torch.Tensor) -> torch.Tensor:
        y = (obs - self.ob_rms_mean) / torch.sqrt(self.ob_rms_var + 1e-8)
        return torch.clamp(y, -OB_CLIP, OB_CLIP)

    def forward(self, obs, rnn_state=None, rnn_mask=None):
        return self.pi(self.normalize(obs), rnn_state, rnn_mask)


class ObsNormPolicy(Policy):
    """The act surface of an ``ObsNormPolicyValueNet``: the inner policy's on the
    normalized observations. ``inner`` is the unfiltered policy over the same
    parameters."""

    def __init__(self, inner: Policy):
        super().__init__(ObsNormPolicyValueNet(inner.module, inner.ob_space.shape),
                         inner.ob_space, inner.ac_space)
        self.inner = inner

    def pack(self):
        return None

    def _heads(self, obs, packed, rnn_state, rnn_mask):
        return self.inner._heads(self.module.normalize(obs), None, rnn_state, rnn_mask)


@dataclass
class GAILTrainState:
    """What an iteration carries to the next; the params live in the policy's module
    and the discriminator, the Adam moments in their optimizers."""

    env_state: Any
    obs: torch.Tensor
    last_done: torch.Tensor
    d_obs_rms: RunningMeanStd
    iters: int = 0


def _flat01(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


@dataclass
class GAILModel(Model):
    """``Model`` with the adversary: ``disc`` and its optimizer ``d_opt`` (``opt`` is
    the value tower's), and, for an ``mlp`` policy, ``legacy_policy_builder(num_hidden)``
    that rebuilds the unfiltered policy at a params-only checkpoint's width."""

    disc: Any = None
    d_opt: Any = None
    legacy_policy_builder: Any = None

    def _adversary(self) -> dict:
        return {"d_params": self.disc, "d_opt": self.d_opt, "d_obs_rms": self.state.d_obs_rms,
                "vf_opt": self.opt}

    def save(self, path: str) -> None:
        payload = {"model_params": self.policy.module, "gail_adversary": self._adversary(),
                   "iters": self.state.iters}
        ns = self._normalize_state()
        if ns is not None:  # kept where the reference drops them (ADVICE.md, gail.py:138)
            payload["norm_ob_rms"] = ns.ob_rms
            payload["norm_ret_rms"] = ns.ret_rms
        ckpt.save_state(path, payload)

    def load(self, path: str) -> "GAILModel":
        tree = ckpt.load_state(path, map_location=self.device)
        params = tree.get("model_params", tree)
        if isinstance(self.policy, ObsNormPolicy) and "ob_rms_mean" not in params:
            return self._load_legacy(params)
        ckpt.from_tree(params, self.policy.module, "model_params")
        state = self.state
        ns = self._normalize_state()
        if "norm_ob_rms" in tree and ns is not None:
            state = dataclasses.replace(state, env_state=replace_normalize_stats(
                state.env_state, ckpt.from_tree(tree["norm_ob_rms"], ns.ob_rms, "norm_ob_rms"),
                ckpt.from_tree(tree["norm_ret_rms"], ns.ret_rms, "norm_ret_rms")))
        if "gail_adversary" in tree:
            adv = ckpt.from_tree(tree["gail_adversary"], self._adversary(), "gail_adversary")
            state = dataclasses.replace(state, d_obs_rms=adv["d_obs_rms"])
        if "iters" in tree:
            state = dataclasses.replace(state, iters=int(tree["iters"]))
        self.state = state
        return self

    def _load_legacy(self, params: dict) -> "GAILModel":
        """A policy's params without the observation filter: the unfiltered policy,
        rebuilt at the checkpoint's hidden width for ``mlp``, for evaluation."""
        inner = self.policy.inner
        width = params.get("network.mlp_fc0.weight")
        if width is not None and self.legacy_policy_builder is not None:
            inner = self.legacy_policy_builder(int(width.shape[0]))
        ckpt.from_tree(params, inner.module, "model_params")
        self.policy = inner
        return self


def make_update_fn(policy, venv, disc: Discriminator, vf_opt: ClipAdam, d_opt: ClipAdam, *,
                   nsteps: int, max_kl: float, cg_iters: int, gamma: float, lam: float,
                   ent_coef: float, cg_damping: float, vf_stepsize: float, vf_iters: int,
                   d_stepsize: float, g_step: int, d_step: int, adversary_entcoeff: float,
                   fvp_subsample: int, norm_epsilon: float = 1e-8):
    """One GAIL iteration (gail.py:318-521): ``update_fn(state, exp_obs, exp_acs, draws)
    -> (state, metrics)``, with the iteration's expert sample. ``norm_epsilon`` is the
    normalized env's epsilon, for rebuilding raw observations."""
    obfilter = isinstance(policy, ObsNormPolicy)
    inner = policy.inner if obfilter else policy
    nenvs = venv.num_envs
    space = venv.action_space
    dev = next(disc.parameters()).device
    low = high = None
    if isinstance(space, Box):
        low = torch.as_tensor(np.asarray(space.low, np.float32), device=dev)
        high = torch.as_tensor(np.asarray(space.high, np.float32), device=dev)
    d_params = list(disc.parameters())

    def update_fn(state: GAILTrainState, exp_obs, exp_acs, draws):
        env_state, obs, last_done, traj, last_value, _ = run_rollout(
            policy, venv, draws, state.env_state, state.obs, state.last_done, nsteps)
        ob, ac = _flat01(traj.obs), _flat01(traj.actions)
        ac2 = ac if ac.dim() > 1 else ac[:, None].to(torch.float32)
        if low is not None:  # the discriminator judges the executed action
            ac2 = torch.clamp(ac2, low, high)
        ns = find_normalize_state(env_state)
        disc_ob = ob if ns is None else ob * torch.sqrt(ns.ob_rms.var + norm_epsilon) + ns.ob_rms.mean
        disc_ob = disc_ob.to(torch.float32)

        with torch.no_grad():
            adv_rew = adversary_reward(disc, state.d_obs_rms, disc_ob, ac2)
        advs, tdlamret = gae(adv_rew.reshape(nsteps, nenvs), traj.values, traj.dones,
                             last_value, gamma, lam)
        atarg, ret = _flat01(advs), _flat01(tdlamret)
        atarg = (atarg - atarg.mean()) / (torch.sqrt(atarg.var(correction=0)) + 1e-8)

        # the filter folds in the fresh rollout before the step (trpo_mpi.py), so the
        # old and the new distributions share it and the KL sees only the params move
        if obfilter:
            policy.module.set_ob_rms(policy.module.ob_rms.update(ob))
            ob = policy.module.normalize(ob)
        step, losses = natural_step(inner, ob, ac, atarg, _flat01(traj.neglogps),
                                    max_kl=max_kl, cg_iters=cg_iters, ent_coef=ent_coef,
                                    cg_damping=cg_damping, fvp_subsample=fvp_subsample,
                                    nsteps=nsteps)
        with torch.no_grad():  # the diagnostics after the step (trpo_mpi.py:281-284)
            pol = {k: p.detach() for k, p in split_params(inner.module)[0].items()}
            gain_after, _, kl_after, _ = losses(pol)
        value_fit(inner.module, vf_opt, ob, ret, draws, vf_iters=vf_iters,
                  vf_stepsize=vf_stepsize)

        d_obs_rms = state.d_obs_rms
        if (state.iters + 1) % g_step == 0:
            exp_obs = exp_obs.to(torch.float32)
            d_obs_rms = d_obs_rms.update(torch.cat([disc_ob, exp_obs], dim=0))
            accs = []
            for _ in range(d_step):
                loss, acc = adversary_loss(disc, d_obs_rms, disc_ob, ac2, exp_obs, exp_acs,
                                           adversary_entcoeff)
                d_opt.step(torch.autograd.grad(loss, d_params), d_stepsize)
                accs.append(torch.stack([acc["gen_acc"], acc["exp_acc"]]))
            gen_acc, exp_acc = torch.stack(accs).mean(dim=0).unbind()
        else:  # an explicit sentinel: NaN would poison a mean over progress.csv
            gen_acc = exp_acc = torch.tensor(-1.0, device=dev)

        metrics = {
            "optimgain": gain_after,
            "meankl": kl_after,
            "adversary_reward_mean": torch.mean(adv_rew),
            "true_reward_mean": torch.mean(traj.rewards),
            "d_gen_acc": gen_acc,
            "d_exp_acc": exp_acc,
            "linesearch_success": step["linesearch_success"],
        }
        new_state = GAILTrainState(env_state=env_state, obs=obs, last_done=last_done,
                                   d_obs_rms=d_obs_rms, iters=state.iters + 1)
        return new_state, metrics

    return update_fn


def learn(
    *,
    env=None,
    env_id: str | None = None,
    network: str = "mlp",
    total_timesteps: int,
    expert_dataset: ExpertDataset | None = None,
    expert_path: str | None = None,
    traj_limitation: int = -1,
    seed: int | None = None,
    num_envs: int = 4,
    env_kwargs: dict | None = None,
    timesteps_per_batch: int = 1024,
    max_kl: float = 0.01,
    cg_iters: int = 10,
    gamma: float = 0.995,
    lam: float = 0.97,
    ent_coef: float = 0.0,
    cg_damping: float = 0.1,
    vf_stepsize: float = 1e-3,
    vf_iters: int = 5,
    d_stepsize: float = 3e-4,
    g_step: int = 3,
    d_step: int = 1,
    adversary_hidden_size: int = 100,
    adversary_entcoeff: float = 1e-3,
    pretrained: bool = False,
    bc_max_iters: int = 1000,
    policy_obfilter: bool = True,
    fvp_subsample: int = 5,
    log_interval: int = 1,
    load_path: str | None = None,
    mesh=None,
    device=None,
    **network_kwargs,
) -> GAILModel:
    """gail/trpo_mpi.learn (gail.py:195-235 signature and defaults). ``expert_path`` is
    an ``.npz`` in the reference schema (``--expert_path`` on the command line);
    ``expert_dataset`` wins where both are given. The env gives raw observations unless
    ``env_kwargs`` asks for normalization. Under a ``mesh`` (a ``Mesh`` from
    ``distributed.make_mesh``) every rank runs this whole learner on the mesh's device,
    unsharded (the module's docstring). ``device`` is the card unless the caller passes
    ``"cpu"``; the remaining keywords go to the network (``mlp`` defaults to 100 hidden
    units, gail/run_mujoco.py:78)."""
    check_mesh(mesh, "gail's mesh")
    device = learner_device(mesh, device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    if expert_dataset is None and expert_path is not None:
        expert_dataset = ExpertDataset(expert_path=expert_path, traj_limitation=traj_limitation,
                                       device=device)
    if expert_dataset is None:
        raise ValueError("gail needs an expert_dataset or an expert_path")
    env_kwargs = dict(env_kwargs or {})
    env_kwargs.setdefault("normalize", False)
    venv = env if env is not None else build_env(env_id, num_envs, device=device, **env_kwargs)
    norm_epsilon, w = 1e-8, venv
    while w is not None:  # a normalized env's epsilon rebuilds the raw observations
        if isinstance(w, VecNormalize):
            norm_epsilon = w.epsilon
            break
        w = getattr(w, "venv", None)
    nenvs = venv.num_envs
    nsteps = max(timesteps_per_batch // nenvs, 1)
    nbatch = nsteps * nenvs
    niters = max(total_timesteps // nbatch, 1) if total_timesteps > 0 else 0

    if network == "mlp":
        network_kwargs.setdefault("num_hidden", 100)
    init_gen = torch.Generator().manual_seed(seed)

    def make_inner(**overrides):
        return build_policy(venv.observation_space, venv.action_space, network, device=device,
                            generator=init_gen, value_network="copy",
                            **{**network_kwargs, **overrides})

    inner = make_inner()
    policy = ObsNormPolicy(inner) if policy_obfilter else inner
    ob_dim = int(np.prod(venv.observation_space.shape))
    ac_shape = getattr(venv.action_space, "shape", None)
    ac_dim = int(ac_shape[-1]) if ac_shape else 1
    disc = Discriminator(ob_dim, ac_dim, adversary_hidden_size, generator=init_gen).to(device)
    draws = Draws(seed, device)
    obs, env_state = venv.reset(draws)
    if pretrained:
        if policy_obfilter:  # BC runs through the filter, seeded from the expert rows
            policy.module.set_ob_rms(policy.module.ob_rms.update(expert_dataset.obs))
        pretrain_bc(policy, expert_dataset, draws, max_iters=bc_max_iters)

    vf_opt = ClipAdam(split_params(inner.module)[1].values(), None, eps=1e-8)
    d_opt = ClipAdam(disc.parameters(), None, eps=1e-8)
    state = GAILTrainState(env_state=env_state, obs=obs,
                           last_done=torch.zeros((nenvs,), dtype=torch.bool, device=device),
                           d_obs_rms=RunningMeanStd.create(obs.shape[1:], device=device))
    update_fn = make_update_fn(
        policy, venv, disc, vf_opt, d_opt, nsteps=nsteps, max_kl=max_kl, cg_iters=cg_iters,
        gamma=gamma, lam=lam, ent_coef=ent_coef, cg_damping=cg_damping,
        vf_stepsize=vf_stepsize, vf_iters=vf_iters, d_stepsize=d_stepsize, g_step=g_step,
        d_step=d_step, adversary_entcoeff=adversary_entcoeff, fvp_subsample=fvp_subsample,
        norm_epsilon=norm_epsilon)
    model = GAILModel(policy, state, vf_opt, draws, disc=disc, d_opt=d_opt,
                      legacy_policy_builder=(lambda nh: make_inner(num_hidden=nh))
                      if network == "mlp" else None)
    if load_path is not None:
        model.load(load_path)
        state = model.state

    tstart = time.time()
    for it in range(1, niters + 1):
        exp_obs, exp_acs = expert_dataset.sample(draws, nbatch)
        state, metrics = update_fn(state, exp_obs, exp_acs, draws)
        model.state = state
        if log_interval and (it % log_interval == 0 or it == 1):
            stats = VecMonitor.get_stats(state.env_state)
            logger.logkv("iters", it)
            logger.logkv("timesteps", it * nbatch)
            logger.logkv("EpTrueRewMean", float(stats.mean_return))
            logger.logkv("fps", int(it * nbatch / (time.time() - tstart)))
            for k, v in metrics.items():
                logger.logkv(k, float(v))
            logger.dumpkvs()
    model.state = state
    return model
