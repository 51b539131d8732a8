"""TRPO, the natural-gradient trust region (counterpart of
baselines_tpu/algos/trpo/trpo.py, after baselines/trpo_mpi/trpo_mpi.py:89-392).

An iteration is a rollout, GAE, then the policy step and the value fit:

- the surrogate E[ratio * A] with the advantages standardized over the batch (the root
  of the variance, as ``jnp.std`` takes it), plus ``ent_coef`` times the entropy;
- the Fisher-vector product as the Hessian of the mean KL to the rollout's policy times
  a vector, on every ``fvp_subsample``-th sample, plus ``cg_damping`` times the vector:
  the KL's gradient is taken once with its graph kept, and each product is the gradient
  of its dot with the vector (a double backward; the JAX package takes the same product
  forward over reverse);
- ``cg_iters`` trips of conjugate gradient (``core/cg.py``), the step scaled to
  sqrt(2 max_kl / s^T H s);
- the backtracking line search over ten halvings, taking the first probe whose gain
  improved and whose KL is within 1.5 max_kl. The JAX package evaluates all ten probes
  and takes the first that passes; the port stops at that probe, which gives the same
  step. When none passes the params stay, ``improve`` is 0 and ``meankl`` is probe 0's;
- the separate value tower (``value_network="copy"``) fit by ``vf_iters`` epochs of
  Adam on 64-sample minibatches, each epoch a fresh permutation whose gathers go through
  the row-gather kernel (``ops/gather.py``), the last ``nbatch % 64`` samples dropped.

The policy's parameters are ``POLICY_KEYS`` (the latent network, ``pi`` and a Gaussian's
``logstd``); the value tower and ``vf`` are the rest (``split_params``).

Checkpoints as trpo.py:280-316: ``save_interval`` writes the whole train state to
``<log dir>/checkpoints/<iter:05d>`` and a run with ``save_interval`` and a log dir
resumes from the latest; an explicit ``load_path`` loads params only and wins over that
resume.

Under a data-parallel mesh (``mesh``) each rank steps ``num_envs / size`` envs and
computes the one-process iteration, as the JAX package's mesh run does
(trpo.py:283-286): the advantages are standardized by the merged moments of every
rank's; the surrogate's gradient and means are averaged over the ranks in one
all-reduce; each Fisher-vector product is summed over the ranks before the damping is
added, on the rows of the global batch's subsample that the rank holds (``fisher_rows``:
global row ``t * N + n``, not the rank's own ``[::fvp_subsample]``), its KL divided by
the subsample's global size; each probe's means are averaged in one all-reduce, so every
rank takes the same branches of conjugate gradient and the line search. The value fit
runs on the whole batch, gathered once an iteration to every rank, shuffled by a
replicated permutation. Rank 0 writes the checkpoints, in the one-process layout, and a
resume gives each rank its envs back.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from baselines_tpu_torch.algos.common import (ClipAdam, Model, build_env, gather_env_columns,
                                              learner_device, run_rollout)
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.cg import cg
from baselines_tpu_torch.core.checkpoint import latest_checkpoint, periodic_path
from baselines_tpu_torch.core.math import explained_variance, flatten_tree, unflatten_like
from baselines_tpu_torch.core.rng import Draws, ShardedDraws
from baselines_tpu_torch.data.gae import gae
from baselines_tpu_torch.distributed.collectives import merge_moments, pmean, psum
from baselines_tpu_torch.distributed.mesh import check_mesh, local_num_envs
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.policy import build_policy, encode_observation
from baselines_tpu_torch.ops.gather import take_rows

POLICY_KEYS = ("network", "pi", "logstd")  # against the value tower: value_network, vf
VF_MINIBATCH = 64


def split_params(module: nn.Module) -> tuple[dict, dict]:
    """(policy params, value params) of a PolicyValueNet by name, each a dict in the
    module's order (trpo.py:42-46)."""
    pol, vf = {}, {}
    for name, p in module.named_parameters():
        (pol if name.split(".")[0] in POLICY_KEYS else vf)[name] = p
    return pol, vf


def merge_params(pol: dict, vf: dict) -> dict:
    """trpo.py:49-50: one dict of both."""
    return {**pol, **vf}


def cg_solve(hvp, b: torch.Tensor, cg_iters: int, residual_tol: float = 1e-10) -> torch.Tensor:
    """Conjugate gradient (common/cg.py:2-34; implementation in core/cg.py)."""
    return cg(hvp, b, cg_iters, residual_tol)


class _PolicyHead(nn.Module):
    """The distribution's flat parameters of a PolicyValueNet, without its value tower,
    so that ``functional_call`` can run them on given policy params."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.m = module

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.m.pd_head(self.m.network(encode_observation(self.m.ob_space, obs)))


def fisher_vector_product(policy, theta: dict, ob: torch.Tensor, old_pdflat: torch.Tensor,
                          cg_damping: float, kl_scale: float = 1.0, mesh=None):
    """``hvp(v)``: the Hessian of the mean KL from the distributions ``old_pdflat`` to
    the policy at ``theta`` (policy params by name) on ``ob``, times the flat ``v``, plus
    ``cg_damping * v`` (trpo.py:167-181). The KL's gradient is taken once with its graph;
    each call is one backward of its dot with ``v``. The KL's mean is scaled by
    ``kl_scale``: under a ``mesh`` ``ob`` is the rank's rows of the subsample, the scale
    the rank's rows over the subsample's, and the product is summed over the ranks, one
    all-reduce a call, before the damping is added."""
    head = _PolicyHead(policy.module)
    pdtype = policy.pdtype
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in theta.items()}
    pdflat = functional_call(head, {f"m.{k}": v for k, v in leaves.items()}, (ob,))
    kl = torch.mean(pdtype.pdfromflat(old_pdflat).kl(pdtype.pdfromflat(pdflat))) * kl_scale
    kl_grad = flatten_tree(torch.autograd.grad(kl, list(leaves.values()), create_graph=True))

    def hvp(v: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            hv = torch.autograd.grad(torch.dot(kl_grad, v), list(leaves.values()),
                                     retain_graph=True)
        hv = flatten_tree(hv)
        if mesh is not None:
            hv, = psum([hv], mesh)
        return hv + cg_damping * v

    return hvp


def fisher_rows(nsteps: int, nenvs: int, every: int, size: int = 1, rank: int = 0,
                device=None):
    """(rows, count): the rows of rank ``rank``'s flattened (T * n) time-major batch that
    are every ``every``-th row of the flattened (T * N) batch of ``size`` ranks, whose row
    ``t * N + r * n + j`` is rank r's row ``t * n + j``, and the size of that subsample
    over every rank (one rank: its ``[::every]``). Raises ``ValueError``, on every rank
    alike, where a rank holds none of it."""
    big_n = nenvs * size
    t = torch.arange(nsteps)[:, None]
    on = (t * big_n + torch.arange(big_n)[None, :]) % every == 0  # (T, N)
    by_rank = on.reshape(nsteps, size, nenvs)
    if not bool(by_rank.any(dim=2).any(dim=0).all()):
        raise ValueError(f"a rank's {nsteps} x {nenvs} batch holds no row of the global "
                         f"batch's every {every}-th: use more steps or envs a rank")
    rows = torch.nonzero(by_rank[:, rank].reshape(-1))[:, 0]
    return rows.to(device), int(on.sum())


@dataclass
class TRPOTrainState:
    """What an iteration carries to the next; the params live in the policy's module and
    the value tower's Adam moments in the optimizer."""

    env_state: Any
    obs: torch.Tensor
    last_done: torch.Tensor
    iters: int = 0


def _flat01(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def natural_step(policy, ob: torch.Tensor, ac: torch.Tensor, atarg: torch.Tensor,
                 old_neglogp: torch.Tensor, *, max_kl: float, cg_iters: int, ent_coef: float,
                 cg_damping: float, fvp_subsample: int, nsteps: int, mesh=None):
    """The policy step of trpo.py:148-200 on a batch: the surrogate's gradient, conjugate
    gradient on the Fisher-vector product of every ``fvp_subsample``-th sample, and the
    line search, which moves the policy params of ``policy.module`` (``split_params``)
    in place. ``ob`` is what the module's encoder takes. Returns the metrics (the gain,
    surrogate and entropy at the old params, the chosen probe's KL, the expected and
    the achieved improvement, whether a probe passed) and ``losses(params) -> (gain,
    surrogate, KL, entropy)`` at given policy params by name. The batch is a flattened
    (``nsteps``, n) rollout.

    Under a ``mesh`` the batch is the rank's rollout and every quantity is the whole
    mesh's: the gradient and the means averaged over the ranks, the Fisher-vector
    product summed over them on the global subsample (``fisher_rows``), so that every
    rank takes the same step."""
    head = _PolicyHead(policy.module)
    pdtype = policy.pdtype
    pol_params = split_params(policy.module)[0]
    with torch.no_grad():
        old_pdflat = head(ob)
    old_pd = pdtype.pdfromflat(old_pdflat)
    theta = {k: p.detach() for k, p in pol_params.items()}

    def local_losses(pp: dict):
        pd = pdtype.pdfromflat(
            functional_call(head, {f"m.{k}": v for k, v in pp.items()}, (ob,)))
        ratio = torch.exp(old_neglogp - pd.neglogp(ac))
        surrgain = torch.mean(ratio * atarg)
        meankl = torch.mean(old_pd.kl(pd))
        meanent = torch.mean(pd.entropy())
        return surrgain + ent_coef * meanent, surrgain, meankl, meanent

    def losses(pp: dict):
        """The means of the whole batch: one all-reduce under a mesh."""
        out = local_losses(pp)
        return out if mesh is None else tuple(pmean([torch.stack(out)], mesh)[0].unbind())

    leaves = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    gain0, surr0, _, ent0 = local_losses(leaves)
    g = flatten_tree(torch.autograd.grad(gain0, list(leaves.values())))
    if mesh is not None:  # the gradient and the means of the whole batch, in one call
        g, means = pmean([g, torch.stack([gain0, surr0, ent0]).detach()], mesh)
        gain0, surr0, ent0 = means.unbind()

    # the Fisher-vector product on a subsample (trpo_mpi.py:307-311)
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    rows, count = fisher_rows(nsteps, ob.shape[0] // nsteps, fvp_subsample, size, rank,
                              ob.device)
    hvp = fisher_vector_product(policy, theta, ob[rows], old_pdflat[rows], cg_damping,
                                kl_scale=rows.numel() / count, mesh=mesh)

    with torch.no_grad():
        stepdir = cg_solve(hvp, g.detach(), cg_iters)
        shs = 0.5 * torch.dot(stepdir, hvp(stepdir))
        lm = torch.sqrt(torch.clamp(shs / max_kl, min=1e-12))
        fullstep = stepdir / lm
        expectedimprove = torch.dot(g, fullstep)
        th_before = flatten_tree(theta)

        # backtracking line search (trpo_mpi.py:330-350)
        th_final, improve, meankl, success = th_before, None, None, False
        for k in range(10):
            th_new = th_before + fullstep * np.float32(0.5) ** k
            gain, _, kl, _ = losses(unflatten_like(th_new, theta))
            step_improve = gain - gain0.detach()
            if meankl is None:
                meankl = kl  # logged where no probe passes (argmax of all-False is 0)
            if bool(torch.isfinite(gain) & (step_improve > 0) & (kl <= max_kl * 1.5)):
                th_final, improve, meankl, success = th_new, step_improve, kl, True
                break
        for p, new in zip(pol_params.values(), unflatten_like(th_final, theta).values()):
            p.copy_(new)

    metrics = {
        "optimgain": gain0.detach(),
        "meankl": meankl,
        "entropy": ent0.detach(),
        "surrgain": surr0.detach(),
        "expectedimprove": expectedimprove,
        "improve": improve if success else torch.zeros_like(expectedimprove),
        "linesearch_success": torch.tensor(float(success), device=g.device),
    }
    return metrics, losses


def value_fit(module: nn.Module, vf_opt: ClipAdam, ob: torch.Tensor, ret: torch.Tensor,
              draws, *, vf_iters: int, vf_stepsize: float) -> None:
    """``vf_iters`` epochs of Adam on the value tower (``split_params``' second half)
    over 64-sample minibatches (trpo_mpi.py:358-364): each epoch a fresh permutation
    whose gathers of ``ob`` and ``ret`` go through the row-gather kernel, the last
    ``len(ob) % 64`` samples dropped. ``ob`` is what the module's encoder takes."""
    vf_list = list(split_params(module)[1].values())
    nmb = max(ob.shape[0] // VF_MINIBATCH, 1)
    for _ in range(vf_iters):
        perm = draws.permutation(ob.shape[0])
        ob_sh, ret_sh = take_rows(ob, perm), take_rows(ret, perm)
        for i in range(nmb):
            rows = slice(i * VF_MINIBATCH, (i + 1) * VF_MINIBATCH)
            x = encode_observation(module.ob_space, ob_sh[rows])
            vpred = module.vf(module.value_network(x))[..., 0]
            loss = torch.mean(torch.square(vpred - ret_sh[rows]))
            vf_opt.step(torch.autograd.grad(loss, vf_list), vf_stepsize)


def make_update_fn(policy, venv, vf_opt: ClipAdam, *, nsteps: int, max_kl: float,
                   cg_iters: int, gamma: float, lam: float, ent_coef: float,
                   cg_damping: float, vf_stepsize: float, vf_iters: int,
                   fvp_subsample: int = 5, mesh=None):
    """One TRPO iteration (trpo.py:134-262): ``update_fn(state, draws) -> (state,
    metrics)``. The rollout takes its draws first, then each value epoch one
    permutation. Under a ``mesh`` the rollout is the rank's envs (``draws`` a
    ``ShardedDraws``, whose ``replicated`` draws take the permutations), the monitor's
    episodes are gathered once, and the metrics are the whole mesh's."""

    def update_fn(state: TRPOTrainState, draws):
        env_state, obs, last_done, traj, last_value, _ = run_rollout(
            policy, venv, draws, state.env_state, state.obs, state.last_done, nsteps)
        env_state = VecMonitor.sync_stats(env_state, mesh)
        advs, tdlamret = gae(traj.rewards, traj.values, traj.dones, last_value, gamma, lam)
        ob, ac = _flat01(traj.obs), _flat01(traj.actions)
        old_neglogp = _flat01(traj.neglogps)
        atarg = _flat01(advs)
        mean, var = atarg.mean(), atarg.var(correction=0)
        if mesh is not None:
            mean, var = merge_moments(mean, var, mesh)
        atarg = (atarg - mean) / (torch.sqrt(var) + 1e-8)
        metrics, _ = natural_step(policy, ob, ac, atarg, old_neglogp, max_kl=max_kl,
                                  cg_iters=cg_iters, ent_coef=ent_coef,
                                  cg_damping=cg_damping, fvp_subsample=fvp_subsample,
                                  nsteps=nsteps, mesh=mesh)
        # the value fit on the whole batch, gathered to every rank under a mesh
        whole = gather_env_columns({"obs": traj.obs, "ret": tdlamret, "values": traj.values},
                                   mesh)
        ret = _flat01(whole["ret"])
        value_fit(policy.module, vf_opt, _flat01(whole["obs"]), ret,
                  draws if mesh is None else draws.replicated, vf_iters=vf_iters,
                  vf_stepsize=vf_stepsize)
        metrics["ev_tdlam_before"] = explained_variance(_flat01(whole["values"]), ret)
        new_state = TRPOTrainState(env_state=env_state, obs=obs, last_done=last_done,
                                   iters=state.iters + 1)
        return new_state, metrics

    return update_fn


def learn(
    *,
    env=None,
    env_id: str | None = None,
    network: str = "mlp",
    total_timesteps: int,
    seed: int | None = None,
    num_envs: int = 1,
    env_kwargs: dict | None = None,
    timesteps_per_batch: int = 1024,
    max_kl: float = 0.001,
    cg_iters: int = 10,
    gamma: float = 0.99,
    lam: float = 1.0,
    ent_coef: float = 0.0,
    cg_damping: float = 1e-2,
    vf_stepsize: float = 3e-4,
    vf_iters: int = 3,
    fvp_subsample: int = 5,
    log_interval: int = 1,
    save_interval: int = 0,
    load_path: str | None = None,
    normalize_observations: bool = False,
    mesh=None,
    device=None,
    **network_kwargs,
) -> Model:
    """trpo_mpi.learn (trpo_mpi.py:89-145 signature and defaults), logging the keys of
    trpo.py:318-333. ``timesteps_per_batch`` is an iteration's samples over all
    ``num_envs`` envs. ``normalize_observations`` puts the env behind VecNormalize,
    whose statistics are saved with the model (the reference normalizes inside the
    policy). ``mesh``, a ``Mesh`` from ``distributed.make_mesh``, trains data parallel:
    every rank calls ``learn`` with the same arguments and steps ``num_envs / size`` of
    the envs on the mesh's device (an ``env`` given is the rank's). ``device`` is the
    card unless the caller passes ``"cpu"``; the remaining keywords go to the network
    (for example ``dtype=torch.bfloat16``)."""
    check_mesh(mesh, "trpo's mesh")
    device = learner_device(mesh, device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    env_kwargs = dict(env_kwargs or {})
    if env is None and normalize_observations:
        env_kwargs.setdefault("normalize", True)
    venv = env if env is not None else build_env(
        env_id, local_num_envs(mesh, num_envs), device=device, axis_name=mesh, **env_kwargs)
    nenvs = venv.num_envs * (1 if mesh is None else mesh.size)
    nsteps = max(timesteps_per_batch // nenvs, 1)
    nbatch = nsteps * nenvs
    niters = max(total_timesteps // nbatch, 1) if total_timesteps > 0 else 0

    init_gen = torch.Generator().manual_seed(seed)
    policy = build_policy(venv.observation_space, venv.action_space, network, device=device,
                          generator=init_gen, value_network="copy", **network_kwargs)
    if policy.is_recurrent:
        raise ValueError("recurrent policies are not supported by trpo, as in the reference")
    vf_opt = ClipAdam(split_params(policy.module)[1].values(), None, eps=1e-8)
    draws = Draws(seed, device) if mesh is None else ShardedDraws(Draws(seed, device), mesh)
    obs, env_state = venv.reset(draws)
    state = TRPOTrainState(env_state=env_state, obs=obs,
                           last_done=torch.zeros((venv.num_envs,), dtype=torch.bool,
                                                 device=device))
    update_fn = make_update_fn(policy, venv, vf_opt, nsteps=nsteps, max_kl=max_kl,
                               cg_iters=cg_iters, gamma=gamma, lam=lam, ent_coef=ent_coef,
                               cg_damping=cg_damping, vf_stepsize=vf_stepsize,
                               vf_iters=vf_iters, fvp_subsample=fvp_subsample, mesh=mesh)

    model = Model(policy, state, vf_opt, draws, mesh)
    if load_path is not None:
        model.load(load_path)
    start_it = 0
    if save_interval and logger.get_dir() and load_path is None:
        latest = latest_checkpoint(logger.get_dir())
        if latest is not None:
            state = model.load_full(latest).state
            start_it = state.iters
            logger.log(f"Resuming from checkpoint {latest} (iter {start_it})")

    tstart = time.time()
    for it in range(start_it + 1, niters + 1):
        state, metrics = update_fn(state, draws)
        model.state = state
        if save_interval and (it % save_interval == 0 or it == 1) and logger.get_dir():
            model.save_full(periodic_path(logger.get_dir(), it))
        if log_interval and (it % log_interval == 0 or it == 1):
            stats = VecMonitor.get_stats(state.env_state)
            logger.logkv("iters", it)
            logger.logkv("timesteps", it * nbatch)
            logger.logkv("EpRewMean", float(stats.mean_return))
            logger.logkv("EpLenMean", float(stats.mean_length))
            logger.logkv("fps", int(it * nbatch / (time.time() - tstart)))
            for k, v in metrics.items():
                logger.logkv(k, float(v))
            logger.dumpkvs()
    model.state = state
    return model
