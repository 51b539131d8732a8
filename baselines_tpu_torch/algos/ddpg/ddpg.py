"""DDPG, the deterministic actor-critic (counterpart of baselines_tpu/algos/ddpg/ddpg.py,
after baselines/ddpg).

The agent as ddpg_learner.py:66-397: a tanh actor scaled to the action range
(ddpg/models.py:24-33) and a critic over concat(obs, action) with an ``output`` head
(models.py:37-48), both final layers drawn uniform in +-3e-3; Polyak-averaged target
networks with ``tau``; the observations normalized by running statistics (clip 5); with
``normalize_returns`` the critic learns normalized returns and its output layer is
rescaled at each statistics update so that its denormalized prediction stays (popart,
``_popart_rescale``); L2 regularization of the critic's non-output kernels; Adam with an
optional clip by global norm; OU or normal action noise, or adaptive parameter noise.

The loop as ddpg.py:21-275: epochs x cycles x (``nb_rollout_steps`` env steps, then
``nb_train_steps`` batched updates, each with its Polyak step), once the replay holds a
batch. With parameter noise the actor is perturbed afresh at each cycle's start and the
noise's scale adapted every ``param_noise_adaption_interval`` train steps of a cycle.
The replay is ``data/replay.py``, whose sample gathers each of its five fields through
the row-gather kernel (``ops/gather.py``).

Draws are taken in this order: the cycle's perturbation (parameter noise), then at each
rollout step the action noise and the env step's draws; at each train step the replay
sample, then the adaptation's test perturbation.

Under a data-parallel mesh (``mesh``) each rank steps ``num_envs / size`` envs with its
rows of the action noise (the OU state holds the rank's rows) and the learner is
replicated, as the JAX package's mesh run replicates the replay and the key
(ddpg.py:385-388): each rollout step's transitions are gathered from every rank in env
order, in one call, so every rank's ring and observation statistics are the one-process
ones; the replay samples and the parameter perturbations draw from the replicated
generator; the gradients are averaged all the same. The monitor's episodes are gathered
once a cycle.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass
from typing import Any, ClassVar

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from baselines_tpu_torch.algos.common import (ClipAdam, Model, build_env, learner_device,
                                              polyak_update)
from baselines_tpu_torch.algos.ddpg.noise import (adapt_param_noise_stddev, parse_noise_type,
                                                  perturb_params)
from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws, ShardedDraws
from baselines_tpu_torch.core.running_stats import RunningMeanStd
from baselines_tpu_torch.data.replay import ReplayBuffer
from baselines_tpu_torch.distributed.collectives import all_gather_fields
from baselines_tpu_torch.distributed.mesh import check_mesh, local_num_envs
from baselines_tpu_torch.envs.spaces import Box
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.networks import get_network


def _final_layer(n_in: int, n_out: int, generator: torch.Generator | None) -> nn.Linear:
    """tf.random_uniform_initializer(-3e-3, 3e-3) on the kernel (ddpg/models.py:31,46),
    flax's zero bias."""
    layer = nn.Linear(n_in, n_out)
    nn.init.uniform_(layer.weight, -3e-3, 3e-3, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class Actor(nn.Module):
    """network -> ``pi`` -> tanh (ddpg.py:61-68)."""

    def __init__(self, network: nn.Module, nb_actions: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.network = network
        self.pi = _final_layer(network.latent_size, nb_actions, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.pi(self.network(obs)))


class Critic(nn.Module):
    """network over concat(obs, action) -> ``output`` (ddpg.py:71-78)."""

    def __init__(self, network: nn.Module, generator: torch.Generator | None = None):
        super().__init__()
        self.network = network
        self.output = _final_layer(network.latent_size, 1, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.output(self.network(torch.cat([obs, action], dim=-1)))[..., 0]


@dataclass
class DDPGTrainState:
    """What a cycle carries to the next. The modules hold the params; the optimizers
    hold the Adam moments; ``perturbed_actor_params`` is the perturbed actor's params by
    name (the actor's own when there is no parameter noise). Under a mesh ``env_state``,
    ``obs`` and ``action_noise_state`` are the rank's envs'; the rest is replicated."""

    replicated_fields: ClassVar = ("replay", "obs_rms", "ret_rms", "param_noise_stddev",
                                   "perturbed_actor_params")

    target_actor: Actor
    target_critic: Critic
    env_state: Any
    obs: torch.Tensor
    replay: Any
    obs_rms: RunningMeanStd
    ret_rms: RunningMeanStd
    action_noise_state: torch.Tensor
    param_noise_stddev: torch.Tensor
    perturbed_actor_params: dict
    t: int = 0  # env steps so far


@torch.no_grad()
def _popart_rescale(critic: Critic, old_mean, old_std, new_mean, new_std) -> None:
    """Rescale the critic's ``output`` layer in place so that its denormalized prediction
    is unchanged by the return statistics' update (ddpg_learner.py:205-221)."""
    out = critic.output
    out.weight.copy_(out.weight * old_std / new_std)
    out.bias.copy_((out.bias * old_std + old_mean - new_mean) / new_std)


class DDPGPolicy:
    """The deterministic policy for ``evaluate`` and ``--play``: the actor on the
    observations normalized by the model's current statistics, scaled to the action
    range (ddpg.py:377-393)."""

    is_recurrent = False

    def __init__(self, actor: Actor, critic: Critic, norm_obs, max_action: torch.Tensor):
        self.module = actor
        self.critic = critic
        self.norm_obs = norm_obs  # (obs) -> the actor's input, under the model's statistics
        self.max_action = max_action

    @torch.no_grad()
    def mode_step(self, obs: torch.Tensor):
        return self.max_action * self.module(self.norm_obs(obs)), None

    def step(self, obs: torch.Tensor, draws=None):
        return self.mode_step(obs)[0], None, None


class DDPGModel(Model):
    """``save``/``load`` of the actor, the critic, their targets and both running
    statistics, the variables the reference's save_variables writes
    (tf_util.py:345-372, ddpg.py:424-450)."""

    @property
    def params(self) -> dict:
        """The actor's and the critic's named parameters and both running statistics
        (ddpg.py:412-420)."""
        s = self.state
        return {"actor": dict(self.policy.module.named_parameters()),
                "critic": dict(self.policy.critic.named_parameters()),
                "obs_rms": s.obs_rms, "ret_rms": s.ret_rms}

    def _ckpt_tree(self) -> dict:
        s = self.state
        return {"actor": self.policy.module, "critic": self.policy.critic,
                "target_actor": s.target_actor, "target_critic": s.target_critic,
                "obs_rms": s.obs_rms, "ret_rms": s.ret_rms}

    def save(self, path: str) -> None:
        ckpt.save_state(path, self._ckpt_tree())

    def load(self, path: str) -> "DDPGModel":
        tree = ckpt.load_state(path, self._ckpt_tree(), map_location=self.device)
        self.state = dataclasses.replace(self.state, obs_rms=tree["obs_rms"],
                                         ret_rms=tree["ret_rms"])
        return self


def learn(
    *,
    env=None,
    env_id: str | None = None,
    network: str = "mlp",
    total_timesteps: int | None = None,
    seed: int | None = None,
    num_envs: int = 1,
    env_kwargs: dict | None = None,
    nb_epochs: int | None = None,
    nb_epoch_cycles: int = 20,
    nb_rollout_steps: int = 100,
    nb_train_steps: int = 50,
    reward_scale: float = 1.0,
    noise_type: str = "adaptive-param_0.2",
    normalize_returns: bool = False,
    normalize_observations: bool = True,
    critic_l2_reg: float = 1e-2,
    actor_lr: float = 1e-4,
    critic_lr: float = 1e-3,
    gamma: float = 0.99,
    clip_norm: float | None = None,
    batch_size: int = 64,
    tau: float = 0.01,
    buffer_size: int = 10**6,
    param_noise_adaption_interval: int = 50,
    log_interval: int = 1,
    load_path: str | None = None,
    mesh=None,
    device=None,
    **network_kwargs,
) -> Model:
    """ddpg.learn (ddpg/ddpg.py:21-66 signature and defaults), logging the keys of
    ddpg.py:458-468 and the last train step's losses of each logged epoch. ``mesh``, a
    ``Mesh`` from ``distributed.make_mesh``, trains data parallel: every rank calls
    ``learn`` with the same arguments and steps ``num_envs / size`` of the envs on the
    mesh's device (an ``env`` given is the rank's). ``device`` is the card unless the
    caller passes ``"cpu"``; the remaining keywords go to the networks
    (``layer_norm=True`` for the mujoco defaults)."""
    check_mesh(mesh, "ddpg's mesh")
    device = learner_device(mesh, device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    env_kwargs = dict(env_kwargs or {})
    env_kwargs.setdefault("normalize", False)
    venv = env if env is not None else build_env(
        env_id, local_num_envs(mesh, num_envs), device=device, axis_name=mesh, **env_kwargs)
    nenvs = venv.num_envs * (1 if mesh is None else mesh.size)
    if not isinstance(venv.action_space, Box):
        raise ValueError(f"DDPG requires a Box action space, got {venv.action_space!r}")
    nb_actions = venv.action_space.shape[-1]
    max_action = torch.as_tensor(venv.action_space.high, device=device)
    if total_timesteps is not None and nb_epochs is None:
        # total_timesteps=0 means no training (the load-and-play contract, run.py:218-244)
        nb_epochs = (max(1, int(total_timesteps) // (nb_epoch_cycles * nb_rollout_steps * nenvs))
                     if total_timesteps > 0 else 0)
    nb_epochs = 500 if nb_epochs is None else nb_epochs

    ob_shape = tuple(venv.observation_space.shape)
    init_gen = torch.Generator().manual_seed(seed)
    actor = Actor(get_network(network, ob_shape=ob_shape, generator=init_gen, **network_kwargs),
                  nb_actions, init_gen).to(device)
    critic_in = (int(np.prod(ob_shape)) + nb_actions,)
    critic = Critic(get_network(network, ob_shape=critic_in, generator=init_gen,
                                **network_kwargs), init_gen).to(device)
    action_noise, param_noise_std0 = parse_noise_type(noise_type, nb_actions)
    use_param_noise = param_noise_std0 is not None
    actor_opt = ClipAdam(actor.parameters(), clip_norm, eps=1e-8, mesh=mesh)
    critic_opt = ClipAdam(critic.parameters(), clip_norm, eps=1e-8, mesh=mesh)
    actor_params, critic_params = list(actor.parameters()), list(critic.parameters())
    # the critic's L2 term: every kernel outside the output layer (ddpg_learner.py:187-196)
    l2_params = [p for name, p in critic.named_parameters()
                 if not name.startswith("output.") and name.endswith("weight") and p.dim() == 2]
    rb = ReplayBuffer(buffer_size)

    def norm_obs(rms: RunningMeanStd, o: torch.Tensor) -> torch.Tensor:
        if not normalize_observations:
            return o.to(torch.float32)
        return rms.normalize(o, clip=5.0)

    def critic_q(module: Critic, rms, o, a, ret_rms) -> torch.Tensor:
        """The critic's prediction in return units (denormalized with popart)."""
        q = module(norm_obs(rms, o), a)
        return ret_rms.denormalize(q) if normalize_returns else q

    def actor_named(params: dict, rms, o) -> torch.Tensor:
        return functional_call(actor, params, (norm_obs(rms, o),))

    def rollout_step(state: DDPGTrainState, draws) -> DDPGTrainState:
        with torch.no_grad():
            if use_param_noise:
                a = actor_named(state.perturbed_actor_params, state.obs_rms, state.obs)
                noise_state = state.action_noise_state
            else:
                a = actor(norm_obs(state.obs_rms, state.obs))
                noise_state = state.action_noise_state
                if action_noise is not None:
                    noise, noise_state = action_noise.sample(draws, noise_state)
                    a = a + noise
            a = torch.clamp(a, -1.0, 1.0)
            nobs, env_state, rew, done, info = venv.step(draws, state.env_state, max_action * a)
            rew = rew * reward_scale
            transition = {"obs": state.obs, "action": a, "reward": rew,
                          "next_obs": info["terminal_obs"], "done": done.to(torch.float32)}
            if mesh is not None:  # every rank's, in env order
                transition = all_gather_fields(transition, mesh)
            replay = rb.add_batch(state.replay, transition)
            obs_rms = (state.obs_rms.update(transition["obs"]) if normalize_observations
                       else state.obs_rms)
            noise_state = torch.where(done[:, None], torch.zeros_like(noise_state), noise_state)
        return dataclasses.replace(state, env_state=env_state, obs=nobs, replay=replay,
                                   obs_rms=obs_rms, action_noise_state=noise_state,
                                   t=state.t + nenvs)

    def train_step(state: DDPGTrainState, draws, step_idx: int):
        batch, _ = rb.sample(state.replay, draws, batch_size)
        obs_rms, ret_rms = state.obs_rms, state.ret_rms
        with torch.no_grad():
            next_a = state.target_actor(norm_obs(obs_rms, batch["next_obs"]))
            q_next = critic_q(state.target_critic, obs_rms, batch["next_obs"], next_a, ret_rms)
            target_q = batch["reward"] + gamma * (1.0 - batch["done"]) * q_next
            if normalize_returns:
                old_mean, old_std = ret_rms.mean, torch.sqrt(ret_rms.var + 1e-8)
                ret_rms = ret_rms.update(target_q)
                new_mean, new_std = ret_rms.mean, torch.sqrt(ret_rms.var + 1e-8)
                _popart_rescale(critic, old_mean, old_std, new_mean, new_std)
                _popart_rescale(state.target_critic, old_mean, old_std, new_mean, new_std)
                target_q = (target_q - new_mean) / new_std

        q = critic(norm_obs(obs_rms, batch["obs"]), batch["action"])
        critic_loss = torch.mean(torch.square(q - target_q))
        if critic_l2_reg > 0:
            critic_loss = critic_loss + critic_l2_reg * sum(torch.sum(torch.square(p))
                                                            for p in l2_params)
        critic_opt.step(torch.autograd.grad(critic_loss, critic_params), critic_lr)

        a = actor(norm_obs(obs_rms, batch["obs"]))
        actor_loss = -torch.mean(critic_q(critic, obs_rms, batch["obs"], a, ret_rms))
        actor_opt.step(torch.autograd.grad(actor_loss, actor_params), actor_lr)

        polyak_update(state.target_actor, actor, tau)
        polyak_update(state.target_critic, critic, tau)

        stddev = state.param_noise_stddev
        if use_param_noise and step_idx % param_noise_adaption_interval == 0:
            with torch.no_grad():
                params = dict(actor.named_parameters())
                test = perturb_params(draws, params, stddev)
                a0 = actor_named(params, obs_rms, batch["obs"])
                a1 = actor_named(test, obs_rms, batch["obs"])
                distance = torch.sqrt(torch.mean(torch.square(a0 - a1)))
                stddev = adapt_param_noise_stddev(stddev, distance, param_noise_std0)
        losses = (actor_loss.detach(), critic_loss.detach())
        return dataclasses.replace(state, ret_rms=ret_rms, param_noise_stddev=stddev), losses

    def cycle(state: DDPGTrainState, draws):
        """One cycle (ddpg.py:322-359); returns the state and the last train step's
        (actor loss, critic loss), None when it did not train. Under a mesh the
        perturbations and the samples take ``draws.replicated``."""
        replicated = draws if mesh is None else draws.replicated
        if use_param_noise:  # agent.reset() at the cycle's start (ddpg.py:150-156)
            with torch.no_grad():
                # a snapshot: the layer norms' params are taken as they are now
                state = dataclasses.replace(state, perturbed_actor_params=perturb_params(
                    replicated, {k: p.detach().clone() for k, p in actor.named_parameters()},
                    state.param_noise_stddev))
        for _ in range(nb_rollout_steps):
            state = rollout_step(state, draws)
        state = dataclasses.replace(state, env_state=VecMonitor.sync_stats(state.env_state,
                                                                           mesh))
        losses = None
        if state.replay.size >= batch_size:
            for i in range(nb_train_steps):
                state, losses = train_step(state, replicated, i)
        return state, losses

    draws = Draws(seed, device) if mesh is None else ShardedDraws(Draws(seed, device), mesh)
    obs, env_state = venv.reset(draws)
    sample_item = {
        "obs": obs[0],
        "action": torch.zeros((nb_actions,), dtype=torch.float32, device=device),
        "reward": torch.zeros((), dtype=torch.float32, device=device),
        "next_obs": obs[0],
        "done": torch.zeros((), dtype=torch.float32, device=device),
    }
    state = DDPGTrainState(
        target_actor=copy.deepcopy(actor), target_critic=copy.deepcopy(critic),
        env_state=env_state, obs=obs, replay=rb.init(sample_item),
        obs_rms=RunningMeanStd.create(ob_shape, device=device),
        ret_rms=RunningMeanStd.create((), device=device),
        action_noise_state=(action_noise.init_state(venv.num_envs, device)
                            if action_noise is not None
                            else torch.zeros((venv.num_envs, nb_actions), dtype=torch.float32,
                                             device=device)),
        param_noise_stddev=torch.tensor(param_noise_std0 or 0.0, dtype=torch.float32,
                                        device=device),
        perturbed_actor_params={k: p.detach().clone() for k, p in actor.named_parameters()},
    )

    model = DDPGModel(None, state, None, draws, mesh)
    model.policy = DDPGPolicy(actor, critic, lambda o: norm_obs(model.state.obs_rms, o),
                              max_action)
    model.cycle = cycle  # one cycle, for tests
    if load_path is not None:
        model.load(load_path)
        state = model.state

    tstart = time.time()
    for epoch in range(nb_epochs):
        losses = None
        for _ in range(nb_epoch_cycles):
            state, cycle_losses = cycle(state, draws)
            losses = cycle_losses or losses
        model.state = state
        if log_interval and epoch % log_interval == 0:
            stats = VecMonitor.get_stats(state.env_state)
            logger.logkv("epoch", epoch)
            logger.logkv("total/steps", state.t)
            logger.logkv("rollout/return_history", float(stats.mean_return))
            logger.logkv("total/epochs", epoch + 1)
            logger.logkv("total/steps_per_second", int(state.t / (time.time() - tstart)))
            if losses is not None:
                logger.logkv("train/loss_actor", float(losses[0]))
                logger.logkv("train/loss_critic", float(losses[1]))
            if use_param_noise:
                logger.logkv("param_noise_stddev", float(state.param_noise_stddev))
            logger.dumpkvs()
    model.state = state
    return model
