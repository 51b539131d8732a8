"""ACKTR: an A2C loss stepped by a K-FAC natural gradient (counterpart of
baselines_tpu/algos/acktr/acktr.py, after baselines/acktr/acktr.py:18-158).

The training loss is E[ADV * -log pi(a)] - ent_coef * H + vf_coef * MSE(V, R) with the
n-step returns and the rollout's values (:40-44). The Fisher loss is -E[-log pi(a)] on the
batch's actions plus the value's Gauss-Newton term vf_fisher_coef * (V - sg(V + xi))^2,
xi a standard normal drawn after the rollout (:47-51).

``KfacPolicyNet`` is an explicit stack of layers (``mlp``; the Nature ``cnn``, ``cnn_small``
and ``cnn_s2d`` on NHWC images, u8 divided by 255), then the ``pi`` and ``vf`` heads, each
a K-FAC layer. A forward takes zero ``taps`` added to every pre-activation, so that
``torch.autograd.grad`` of the Fisher loss for the taps gives the per-location
pre-activation gradients. Dense layers use the classic factors; conv layers the KFC
approximation: the rows are (sample, location) pairs, ``F.unfold``'s im2col patches
(ordered (cin, kh, kw), as ``conv_general_dilated_patches``) and the per-location
gradients scaled by batch * sqrt(T) (acktr.py:253-270). The convs run NCHW: the input is
permuted once, the conv kernels are OIHW and the first dense layer after them reads the
output flattened in (C, H, W) order; ``convert.kfac_state_dict`` permutes the JAX
package's (H, W, C) rows of that layer once. A conv kernel meets its factors in the
(cin * k * k, cout) layout.

An update (acktr.py:429-505): the rollout, the n-step returns, one forward with the taps
for both losses' gradients, the factor statistics, the eigendecompositions when the
host's step count is a multiple of ``kfac_update``, the preconditioned gradient (a
Gaussian's ``logstd`` keeps its raw gradient) scaled by the KL trust radius
min(1, sqrt(kfac_clip / max(vFv lr^2, 1e-12))), the raw gradient instead for the first
``cold_iter`` updates, the clip to ``max_grad_norm``, then momentum SGD,
``p -= lr * (momentum * m + d)``, with the learning rate annealed linearly by default.
Draws in order: the rollout's, then the Fisher loss's noise.

Under a data-parallel mesh (``mesh``) each rank steps ``num_envs / size`` envs and
computes the one-process update, as the JAX package's mesh run does (acktr.py:527-530):
the gradients of the training loss are averaged over the ranks; the Fisher loss is the
rank's share of the whole batch's mean and ``layer_stats`` scales the rows by the whole
batch's size, so that each row is a sample's own gradient, and the factor moments of
the ranks' equal shares are averaged (``kfac.update_stats``); the Fisher noise is drawn
for the whole batch from the replicated generator, each rank taking its env columns.
Every rank then decomposes, preconditions, clips and steps on the same values. The
metrics are the rank's shares, reduced on the updates that log.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, ClassVar

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from baselines_tpu_torch.algos.a2c.a2c import a2c_lr
from baselines_tpu_torch.algos.acktr.kfac import (KFACState, init_kfac, precondition_layer,
                                                  update_eigs, update_stats)
from baselines_tpu_torch.algos.common import (Model, build_env, learner_device, mesh_metrics,
                                              run_rollout, update_metrics)
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.math import global_norm
from baselines_tpu_torch.core.rng import Draws, ShardedDraws
from baselines_tpu_torch.data.gae import nstep_returns
from baselines_tpu_torch.distributed.collectives import pmean
from baselines_tpu_torch.distributed.mesh import check_mesh, local_num_envs
from baselines_tpu_torch.envs.spaces import Box
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.distributions import make_pdtype
from baselines_tpu_torch.nn.policy import encode_observation, encoded_shape


def _ortho(shape, scale: float, generator: torch.Generator | None) -> torch.Tensor:
    """acktr.py:47-52: the Q of a normal matrix's QR, at (rows, cols) ``shape``."""
    w = torch.randn(shape, generator=generator)
    tall = shape[0] >= shape[1]
    q, _ = torch.linalg.qr(w if tall else w.T)
    q = q if tall else q.T
    return scale * q[:shape[0], :shape[1]]


@dataclass
class _Spec:
    """A K-FAC layer: ``kind`` "dense" or "conv", its factor dims (din, dout) and, for a
    conv, its kernel, stride and output size."""

    kind: str
    factor_dims: tuple
    act: Any = None
    k: int = 0
    stride: int = 0
    cin: int = 0
    hout: int = 0
    wout: int = 0


_CONV_STACKS = {"cnn": ([(32, 8, 4), (64, 4, 2), (64, 3, 1)], 512),
                "cnn_small": ([(8, 8, 4), (16, 4, 2)], 128),
                "cnn_s2d": ([(32, 2, 1), (64, 4, 2), (64, 3, 1)], 512)}


class KfacPolicyNet(nn.Module):
    """The layer stack and the heads (acktr.py:77-305): ``layers`` (Conv2d or Linear),
    ``pi``, ``vf`` and, for a Box action space, ``logstd`` (1, d). ``forward(obs, taps)
    -> (pdflat, vf, acts)``, ``acts[i]`` the input of K-FAC layer i (NCHW for a conv,
    flattened for a dense layer)."""

    def __init__(self, ob_space, ac_space, network: str = "mlp", num_hidden: int = 64,
                 num_layers: int = 2, generator: torch.Generator | None = None):
        super().__init__()
        self.ob_space = ob_space
        self.pdtype = make_pdtype(ac_space)
        self.continuous = isinstance(ac_space, Box)
        self.pi_dim = self.pdtype.param_size // 2 if self.continuous else self.pdtype.param_size
        probe = encoded_shape(ob_space)
        specs = []
        if network == "mlp":
            self.conv_input = False
            din = math.prod(probe)
            for _ in range(num_layers):
                specs.append(_Spec("dense", (din, num_hidden), torch.tanh))
                din = num_hidden
        elif network in _CONV_STACKS:
            if len(probe) != 3:
                raise ValueError(f"acktr network={network!r} needs HWC image obs")
            self.conv_input = True
            h, w, c = probe
            stack, width = _CONV_STACKS[network]
            for cout, k, stride in stack:
                hout, wout = (h - k) // stride + 1, (w - k) // stride + 1
                specs.append(_Spec("conv", (c * k * k, cout), F.relu, k, stride, c, hout, wout))
                h, w, c = hout, wout, cout
            specs.append(_Spec("dense", (h * w * c, width), F.relu))
            din = width
        else:
            raise ValueError("acktr supports network in ('mlp', 'cnn', 'cnn_small', "
                             f"'cnn_s2d'), got {network!r}")
        specs.append(_Spec("dense", (din, self.pi_dim)))  # the pi head
        specs.append(_Spec("dense", (din, 1)))  # the vf head
        self.specs = specs
        self.layer_dims = [s.factor_dims for s in specs]

        def make(spec, scale):
            fdin, fout = spec.factor_dims
            if spec.kind == "conv":
                layer = nn.Conv2d(spec.cin, fout, spec.k, stride=spec.stride)
            else:
                layer = nn.Linear(fdin, fout)
            with torch.no_grad():
                layer.weight.copy_(_ortho((fdin, fout), scale, generator).T.reshape(
                    layer.weight.shape))
                layer.bias.zero_()
            return layer

        self.layers = nn.ModuleList([make(s, math.sqrt(2.0)) for s in specs[:-2]])
        self.pi = make(specs[-2], 0.01)
        self.vf = make(specs[-1], 1.0)
        if self.continuous:
            self.logstd = nn.Parameter(torch.zeros((1, self.pi_dim)))

    @property
    def kfac_modules(self) -> list:
        """The K-FAC layers in factor order: the stack, ``pi``, ``vf``."""
        return list(self.layers) + [self.pi, self.vf]

    @property
    def conv_out_hw(self) -> tuple | None:
        """(H, W) of the last conv's output, whose flatten the first dense layer reads."""
        convs = [s for s in self.specs if s.kind == "conv"]
        return (convs[-1].hout, convs[-1].wout) if convs else None

    def _encode(self, obs: torch.Tensor) -> torch.Tensor:
        x = encode_observation(self.ob_space, obs)
        x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.to(torch.float32)
        return x.permute(0, 3, 1, 2) if self.conv_input else x.reshape(x.shape[0], -1)

    @staticmethod
    def _layer_forward(spec: _Spec, layer: nn.Module, x: torch.Tensor, tap):
        if spec.kind == "conv":
            s = F.conv2d(x, layer.weight, layer.bias, stride=spec.stride)
        else:
            x = x.reshape(x.shape[0], -1)
            s = F.linear(x, layer.weight, layer.bias)
        return x, s if tap is None else s + tap

    def forward(self, obs: torch.Tensor, taps=None):
        x = self._encode(obs)
        acts, pre = [], []
        for i, (spec, layer) in enumerate(zip(self.specs, self.kfac_modules)):
            a_in, s = self._layer_forward(spec, layer, x, None if taps is None else taps[i])
            acts.append(a_in)
            pre.append(s)
            if spec.act is not None:
                x = spec.act(s)
        s_pi, s_vf = pre[-2], pre[-1]
        pdflat = (torch.cat([s_pi, self.logstd.expand_as(s_pi)], dim=-1) if self.continuous
                  else s_pi)
        return pdflat, s_vf[:, 0], acts

    def zero_taps(self, batch: int, device) -> list:
        """Zero pre-activation taps for ``batch`` samples, each requiring grad."""
        out = []
        for spec in self.specs:
            shape = ((batch, spec.factor_dims[1], spec.hout, spec.wout) if spec.kind == "conv"
                     else (batch, spec.factor_dims[1]))
            out.append(torch.zeros(shape, device=device, requires_grad=True))
        return out

    def layer_stats(self, acts, ds, batch: int | None = None) -> list:
        """(a rows, g rows) of each layer for ``update_stats``: a dense layer's rows are
        samples with the gradients of the mean loss times the batch; a conv layer's are
        (sample, location) pairs, im2col patches and per-location gradients times
        batch * sqrt(T) (T locations), which folds KFC's T into S. ``batch`` is the size
        of the batch whose mean the loss is (the rows' count by default; under a mesh
        the whole mesh's)."""
        batch = ds[-1].shape[0] if batch is None else batch
        rows = []
        for spec, a, g in zip(self.specs, acts, ds):
            if spec.kind == "conv":
                p = F.unfold(a, spec.k, stride=spec.stride)  # (B, cin*k*k, T)
                t = spec.hout * spec.wout
                rows.append((p.transpose(1, 2).reshape(-1, spec.factor_dims[0]),
                             g.permute(0, 2, 3, 1).reshape(-1, spec.factor_dims[1])
                             * (batch * np.sqrt(t))))
            else:
                rows.append((a, g * batch))
        return rows

    def precondition(self, kfac_layers, layer_grads, epsilon: float) -> list:
        """F^-1 g of each K-FAC layer, ``layer_grads`` and the result as (gW, gb) in the
        parameters' shapes."""
        out = []
        for spec, layer, (gW, gb) in zip(self.specs, kfac_layers, layer_grads):
            pW, pb = precondition_layer(layer, gW.reshape(gW.shape[0], -1).T, gb, epsilon)
            out.append((pW.T.reshape(gW.shape), pb))
        return out


class KfacPolicy:
    """The act surface over a ``KfacPolicyNet`` for the rollout, ``Model`` and
    ``evaluate``."""

    is_recurrent = False

    def __init__(self, net: KfacPolicyNet, ob_space, ac_space):
        self.module = net
        self.ob_space = ob_space
        self.ac_space = ac_space
        self.pdtype = net.pdtype

    def initial_state(self, batch_size: int):
        return None

    def pack(self):
        return None

    @torch.no_grad()
    def step(self, obs, draws, packed=None, rnn_state=None, rnn_mask=None):
        pdflat, vf, _ = self.module(obs)
        pd = self.pdtype.pdfromflat(pdflat)
        action = pd.sample(pd.noise(draws))
        return action, vf, pd.neglogp(action)

    @torch.no_grad()
    def mode_step(self, obs, packed=None, rnn_state=None, rnn_mask=None):
        pdflat, vf, _ = self.module(obs)
        return self.pdtype.pdfromflat(pdflat).mode(), vf

    @torch.no_grad()
    def value(self, obs, packed=None, rnn_state=None, rnn_mask=None):
        return self.module(obs)[1]


@dataclass
class ACKTRTrainState:
    """What an update carries to the next; the params live in the policy's module. Under
    a mesh ``env_state``, ``obs`` and ``last_done`` are the rank's envs'."""

    replicated_fields: ClassVar = ("kfac",)

    env_state: Any
    obs: torch.Tensor
    last_done: torch.Tensor
    kfac: KFACState
    update_idx: int = 0


def _flat01(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def make_update_fn(policy: KfacPolicy, venv, *, nsteps: int, gamma: float, ent_coef: float,
                   vf_coef: float, vf_fisher_coef: float, lr: float, max_grad_norm: float,
                   kfac_clip: float, lrschedule: str, epsilon: float, stats_decay: float,
                   momentum: float, cold_iter: int, kfac_update: int, nupdates: int,
                   mesh=None):
    """One ACKTR update (acktr.py:429-509): ``update_fn(state, draws) -> (state,
    metrics)``. Under a ``mesh`` the rollout is the rank's envs (``draws`` a
    ``ShardedDraws``, whose ``replicated`` draws take the Fisher noise), the gradients
    and the factor moments are the whole batch's, and the metrics are the rank's
    shares, which ``algos.common.mesh_metrics`` reduces."""
    net = policy.module
    pdtype = policy.pdtype
    params = list(net.parameters())
    index = {id(p): i for i, p in enumerate(params)}
    kfac_idx = [(index[id(m.weight)], index[id(m.bias)]) for m in net.kfac_modules]
    nl = venv.num_envs
    nbatch = nl * nsteps  # the rank's
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)

    def update_fn(state: ACKTRTrainState, draws):
        lr_now = a2c_lr(lr, lrschedule, state.update_idx, nupdates)
        env_state, obs, last_done, traj, last_value, _ = run_rollout(
            policy, venv, draws, state.env_state, state.obs, state.last_done, nsteps)
        env_state = VecMonitor.sync_stats(env_state, mesh)
        ret = _flat01(nstep_returns(traj.rewards, traj.dones, last_value, gamma))
        ob, ac, val = _flat01(traj.obs), _flat01(traj.actions), _flat01(traj.values)
        adv = ret - val

        # one forward serves both losses: the taps are zeros
        taps = net.zero_taps(nbatch, ob.device)
        pdflat, vf, acts = net(ob, taps)
        pd = pdtype.pdfromflat(pdflat)
        neglogpac = pd.neglogp(ac)
        pg_loss = torch.mean(adv * neglogpac)
        entropy = torch.mean(pd.entropy())
        vf_loss = torch.mean(torch.square(vf - ret))
        loss = pg_loss - ent_coef * entropy + vf_coef * vf_loss
        grads = torch.autograd.grad(loss, params, retain_graph=True)
        if mesh is not None:  # the whole batch's gradient
            grads = pmean(grads, mesh)
        # the whole batch's (T * N) noise, the rank's env columns
        replicated = draws if mesh is None else draws.replicated
        vf_noise = replicated.normal((nbatch * size,)).reshape(nsteps, size, nl)[
            :, rank].reshape(-1)
        # the rank's share of the whole batch's mean
        fisher = (-torch.mean(neglogpac) - vf_fisher_coef * torch.mean(
            torch.square(vf - (vf + vf_noise).detach()))) / size
        ds = torch.autograd.grad(fisher, taps)

        with torch.no_grad():
            rows = net.layer_stats([a.detach() for a in acts], ds, nbatch * size)
            kfac = update_stats(state.kfac, rows, stats_decay, mesh)
            if kfac.step % kfac_update == 0:
                kfac = update_eigs(kfac)
            if kfac.step < cold_iter:  # the cold start: the plain gradient
                direction = list(grads)
            else:
                layer_grads = [(grads[w], grads[b]) for w, b in kfac_idx]
                precond = net.precondition(kfac.layers, layer_grads, epsilon)
                vFv = sum(torch.sum(pW * gW) + torch.sum(pb * gb)
                          for (pW, pb), (gW, gb) in zip(precond, layer_grads))
                lr2 = float(np.float32(lr_now) ** 2)
                scale = torch.clamp(torch.sqrt(
                    torch.full_like(vFv, kfac_clip) / torch.clamp(vFv * lr2, min=1e-12)), max=1.0)
                direction = list(grads)  # a Gaussian's logstd keeps its raw gradient
                for (w, b), (pW, pb) in zip(kfac_idx, precond):
                    direction[w], direction[b] = pW * scale, pb * scale
            gnorm = global_norm(direction)
            clip_coef = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-8), max=1.0)
            new_momentum = [momentum * m + d * clip_coef
                            for m, d in zip(kfac.momentum, direction)]
            for p, m in zip(params, new_momentum):
                p.sub_(lr_now * m)
        kfac = KFACState(layers=kfac.layers, momentum=new_momentum, step=kfac.step + 1)

        metrics = update_metrics({"policy_loss": pg_loss.detach(),
                                  "value_loss": vf_loss.detach(),
                                  "policy_entropy": entropy.detach()}, val, ret, mesh)
        new_state = ACKTRTrainState(env_state=env_state, obs=obs, last_done=last_done,
                                    kfac=kfac, update_idx=state.update_idx + 1)
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
    nsteps: int = 20,
    gamma: float = 0.99,
    ent_coef: float = 0.01,
    vf_coef: float = 0.5,
    vf_fisher_coef: float = 1.0,
    lr: float = 0.25,
    max_grad_norm: float = 0.5,
    kfac_clip: float = 0.001,
    lrschedule: str = "linear",
    epsilon: float = 0.01,
    stats_decay: float = 0.99,
    momentum: float = 0.9,
    cold_iter: int = 10,
    kfac_update: int = 1,
    log_interval: int = 100,
    load_path: str | None = None,
    num_hidden: int = 64,
    num_layers: int = 2,
    mesh=None,
    device=None,
    **network_kwargs,
) -> Model:
    """acktr.learn (acktr.py:351-380 signature and defaults), logging the keys of
    acktr.py:544-549. ``mesh``, a ``Mesh`` from ``distributed.make_mesh``, trains data
    parallel: every rank calls ``learn`` with the same arguments and steps ``num_envs /
    size`` of the envs on the mesh's device (an ``env`` given is the rank's). ``device``
    is the card unless the caller passes ``"cpu"``; other keywords are taken and unused,
    as in the JAX package."""
    check_mesh(mesh, "acktr's mesh")
    if lrschedule not in ("linear", "constant"):
        raise ValueError(f"lrschedule must be 'linear' or 'constant', got {lrschedule!r}")
    device = learner_device(mesh, device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    venv = env if env is not None else build_env(
        env_id, local_num_envs(mesh, num_envs), device=device, axis_name=mesh,
        **(env_kwargs or {}))
    nbatch = venv.num_envs * nsteps * (1 if mesh is None else mesh.size)
    nupdates = max(total_timesteps // nbatch, 1) if total_timesteps > 0 else 0

    net = KfacPolicyNet(venv.observation_space, venv.action_space, network, num_hidden,
                        num_layers, generator=torch.Generator().manual_seed(seed)).to(device)
    policy = KfacPolicy(net, venv.observation_space, venv.action_space)
    draws = Draws(seed, device) if mesh is None else ShardedDraws(Draws(seed, device), mesh)
    obs, env_state = venv.reset(draws)
    state = ACKTRTrainState(
        env_state=env_state, obs=obs,
        last_done=torch.zeros((venv.num_envs,), dtype=torch.bool, device=device),
        kfac=init_kfac(net.layer_dims, net.parameters(), device))
    update_fn = make_update_fn(
        policy, venv, nsteps=nsteps, gamma=gamma, ent_coef=ent_coef, vf_coef=vf_coef,
        vf_fisher_coef=vf_fisher_coef, lr=lr, max_grad_norm=max_grad_norm,
        kfac_clip=kfac_clip, lrschedule=lrschedule, epsilon=epsilon, stats_decay=stats_decay,
        momentum=momentum, cold_iter=cold_iter, kfac_update=kfac_update, nupdates=nupdates,
        mesh=mesh)
    model = Model(policy, state, None, draws, mesh)
    if load_path is not None:
        model.load(load_path)

    tstart = time.time()
    for upd in range(1, nupdates + 1):
        state, metrics = update_fn(state, draws)
        model.state = state
        if log_interval and (upd % log_interval == 0 or upd == 1):
            metrics = mesh_metrics(metrics, mesh)
            stats = VecMonitor.get_stats(state.env_state)
            logger.logkv("nupdates", upd)
            logger.logkv("total_timesteps", upd * nbatch)
            logger.logkv("fps", int(upd * nbatch / (time.time() - tstart)))
            logger.logkv("eprewmean", float(stats.mean_return))
            for k, v in metrics.items():
                logger.logkv(k, float(v))
            logger.dumpkvs()
    model.state = state
    return model
