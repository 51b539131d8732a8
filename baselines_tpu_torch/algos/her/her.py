"""HER, hindsight experience replay over a DDPG core (counterpart of
baselines_tpu/algos/her/her.py, after baselines/her).

- The actor and critic read the observation and the goal, each normalized by its
  running statistics and clipped to ``norm_clip`` (her/normalizer.py:10-118); the goal
  statistics fold in the episodes' goals and achieved goals.
- A cycle rolls ``num_envs`` fresh episodes of the env's horizon T with epsilon-random
  plus Gaussian exploration (her/rollout.py:50-136; ``noise_eps``, ``random_eps``, as
  her/ddpg.py:170-184), stores them in the episode buffer (``data/her_buffer.py``), runs
  ``n_batches`` train steps on relabeled samples, then moves the targets by Polyak
  averaging with ``polyak`` (her/her.py:22-84).
- The critic's target is clipped to [-1 / (1 - gamma), 0]; the actor's loss adds
  ``action_l2`` times the mean square of its pre-scale output (her/ddpg.py).
- With ``bc_loss`` a second buffer of demonstration episodes is sampled each train step
  (without relabeling) and the actor also imitates them, where the critic prefers the
  demonstrated action when ``q_filter`` is on (her/ddpg.py:361-377).
- Each epoch an evaluator rolls episodes without noise and logs ``test/success_rate``
  beside the exploring rollouts' ``train/success_rate``.

Goal envs come two ways (her.py:134-190): a device env of the registry (``PointReach-v0``)
stepped directly, as the JAX package vmaps it, with fresh episodes each cycle; or a
gymnasium-robotics env (``FetchReach-v4``) in a host pool behind ``CallbackVecEnv``
with dict observations and ``is_success`` from the infos, whose stream runs on across
cycles: the envs only truncate, at the horizon T of the env's spec, so the auto-reset
at a cycle's last step starts the next cycle's episodes, and the last step's terminal
observation closes the stored episodes. Its reward for relabeled goals is the
goal-distance threshold of the env's ``distance_threshold`` and ``reward_type``. The
evaluator has a host pool of its own. ``--save_path`` writes the actor with both
normalizers.

Draws: a rollout step takes the Gaussian noise, the random actions, then the
epsilon uniforms; a cycle takes the device env's reset draws, the steps', the store's,
then each train step's sample (and its demonstration sample). The host pools draw
their reset seeds when ``learn`` starts, the train pool's from the run's draws. The
evaluator draws from its own generator, seeded with ``seed + 999``.

Under a data-parallel mesh (``mesh``) each rank rolls ``num_envs / size`` of a cycle's
episodes with its rows of every env-axis draw, and the learner is replicated, as the JAX
package's mesh run replicates the episode buffer and the key (her.py:440-443): the
cycle's episodes (and their last-step successes) are gathered from every rank in env
order in one call, so every rank stores the one-process episodes and folds them into
``o_rms`` and ``g_rms``; the store and the train steps draw from the replicated
generator; the gradients are averaged all the same. The evaluator's success rate takes
every rank's episodes. A rank's host pools hold its ``num_envs / size`` envs, seeded by
their global index from the one reset seed that every rank draws alike
(``CallbackVecEnv.reset``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os.path as osp
import time
from dataclasses import dataclass
from typing import Any, ClassVar

import numpy as np
import torch
import torch.nn as nn

from baselines_tpu_torch.algos.common import (ClipAdam, Model, gym_thunk, host_pool,
                                              learner_device, polyak_update)
from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws, ShardedDraws
from baselines_tpu_torch.core.running_stats import RunningMeanStd
from baselines_tpu_torch.data.her_buffer import HerBufferState, HerReplayBuffer
from baselines_tpu_torch.distributed.collectives import all_gather_fields, all_gather_rows
from baselines_tpu_torch.distributed.mesh import check_mesh, local_num_envs
from baselines_tpu_torch.envs.base import TimeLimit
from baselines_tpu_torch.envs.callback_env import CallbackVecEnv
from baselines_tpu_torch.envs.registry import get_env_type, is_torch_env, make_env
from baselines_tpu_torch.nn.networks import _lecun, get_network

# env-keyed parameter overrides (her/experiment/config.py:10-14), by env id without its
# version suffix
DEFAULT_ENV_PARAMS = {"FetchReach": {"n_cycles": 10}}


class GoalActor(nn.Module):
    """concat(o, g) -> network -> ``pi`` -> tanh (her.py:41-49)."""

    def __init__(self, network: nn.Module, nb_actions: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.network = network
        self.pi = _lecun(nn.Linear(network.latent_size, nb_actions), generator)

    def forward(self, o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.pi(self.network(torch.cat([o, g], dim=-1))))


class GoalCritic(nn.Module):
    """concat(o, g, u) -> network -> ``output`` (her.py:52-59)."""

    def __init__(self, network: nn.Module, generator: torch.Generator | None = None):
        super().__init__()
        self.network = network
        self.output = _lecun(nn.Linear(network.latent_size, 1), generator)

    def forward(self, o: torch.Tensor, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.output(self.network(torch.cat([o, g, u], dim=-1)))[..., 0]


@dataclass
class HERTrainState:
    """What a cycle carries to the next; the actor and critic live in the policy, their
    Adam moments in the optimizers. Under a mesh every field is replicated."""

    replicated_fields: ClassVar = ("buffer", "o_rms", "g_rms", "success_rate")

    target_actor: GoalActor
    target_critic: GoalCritic
    buffer: HerBufferState
    o_rms: RunningMeanStd
    g_rms: RunningMeanStd
    success_rate: torch.Tensor  # () f32, the exploring rollouts' moving average
    n_episodes: int = 0
    # a host goal env's stream, carried across cycles: the train pool's state and obs
    env_state: Any = None
    obs: Any = None


def goal_distance_reward(distance_threshold: float, reward_type: str):
    """gymnasium-robotics' goal envs' compute_reward (her_sampler.py:52-56 calls the
    env's): minus the goal distance, or -1 where it is over ``distance_threshold`` and 0
    within it for ``reward_type="sparse"``."""

    def compute_reward(achieved_goal: torch.Tensor, desired_goal: torch.Tensor):
        d = torch.sqrt(torch.sum(torch.square(achieved_goal - desired_goal), dim=-1))
        if reward_type == "sparse":
            return -(d > distance_threshold).to(torch.float32)
        return -d

    return compute_reward


class HERPolicy:
    """The goal policy on dict observations, for ``evaluate`` and ``--play``: the actor
    under the model's current normalizers, scaled to the action range."""

    is_recurrent = False

    def __init__(self, actor: GoalActor, critic: GoalCritic, pi, max_action: torch.Tensor):
        self.module = actor
        self.critic = critic
        self.pi = pi  # (o, g) -> the actor's action in [-1, 1] under the model's statistics
        self.max_action = max_action

    @torch.no_grad()
    def mode_step(self, obs: dict):
        return self.max_action * self.pi(obs["observation"], obs["desired_goal"]), None

    def step(self, obs: dict, draws=None):
        return self.mode_step(obs)[0], None, None


class HERModel(Model):
    """``save``/``load`` of the actor and both normalizers, the ``--save_path`` payload
    of her.py:526."""

    @property
    def params(self) -> dict:
        """The actor's named parameters and both normalizers (her.py:509-516)."""
        return {"actor": dict(self.policy.module.named_parameters()),
                "o_rms": self.state.o_rms, "g_rms": self.state.g_rms}

    def _params(self) -> dict:
        return {"actor": self.policy.module, "o_rms": self.state.o_rms,
                "g_rms": self.state.g_rms}

    def save(self, path: str) -> None:
        ckpt.save_state(path, {"model_params": self._params()})

    def load(self, path: str) -> "HERModel":
        tree = ckpt.load_state(path, {"model_params": self._params()},
                               map_location=self.device)["model_params"]
        self.state = dataclasses.replace(self.state, o_rms=tree["o_rms"], g_rms=tree["g_rms"])
        return self


def learn(
    *,
    env=None,
    env_id: str | None = None,
    network: str = "mlp",
    total_timesteps: int,
    seed: int | None = None,
    num_envs: int = 8,
    replay_k: float = 4,
    n_cycles: int | None = None,
    n_batches: int = 40,
    n_test_rollouts: int = 10,
    batch_size: int = 256,
    buffer_size_episodes: int = 10000,
    polyak: float = 0.95,
    gamma: float | None = None,
    q_lr: float = 1e-3,
    pi_lr: float = 1e-3,
    action_l2: float = 1.0,
    noise_eps: float = 0.2,
    random_eps: float = 0.3,
    norm_clip: float = 5.0,
    bc_loss: bool = False,
    q_filter: bool = False,
    demo_episodes=None,
    demo_batch_size: int = 128,
    prm_loss_weight: float = 0.001,
    aux_loss_weight: float = 0.0078,
    log_interval: int = 1,
    load_path: str | None = None,
    num_hidden: int = 256,
    num_layers: int = 3,
    mesh=None,
    env_kwargs: dict | None = None,
    device=None,
    **network_kwargs,
) -> Model:
    """her.learn (her/her.py:87-177 and experiment/config.py DEFAULT_PARAMS: 3 x 256
    layers, pi_lr and q_lr 1e-3, polyak 0.95, replay_k 4, batch 256, n_cycles 50 (10 for
    FetchReach), n_batches 40, gamma 1 - 1 / T). ``demo_episodes`` is (o (E, T + 1, do),
    ag (E, T + 1, dg), g (E, T, dg), u (E, T, du)), arrays or tensors. ``env_kwargs`` is
    taken for the CLI's sake and unused: goal envs take no env flags, as in the JAX
    package. ``mesh``, a ``Mesh`` from ``distributed.make_mesh``, trains data parallel:
    every rank calls ``learn`` with the same arguments and rolls ``num_envs / size`` of
    the episodes on the mesh's device. ``device`` is the card unless the caller passes
    ``"cpu"``."""
    del env_kwargs
    check_mesh(mesh, "her's mesh")
    device = learner_device(mesh, device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    if n_cycles is None:
        n_cycles = DEFAULT_ENV_PARAMS.get((env_id or "").split("-v")[0], {}).get("n_cycles", 50)

    host_mode = env is None and env_id is not None and not is_torch_env(env_id)
    nl = local_num_envs(mesh, num_envs)  # the episodes a rank rolls
    if host_mode:  # a rank's pools hold its envs, seeded by their global index
        thunk = gym_thunk(env_id, get_env_type(env_id))
        first_env = 0 if mesh is None else mesh.rank * nl
        train_venv = CallbackVecEnv(host_pool(thunk, nl, first_env), info_keys=("is_success",),
                                    device=device)
        eval_venv = CallbackVecEnv(host_pool(thunk, nl, first_env), info_keys=("is_success",),
                                   device=device)
        probe = thunk()
        T = probe.spec.max_episode_steps
        compute_reward = goal_distance_reward(
            float(getattr(probe.unwrapped, "distance_threshold", 0.05)),
            getattr(probe.unwrapped, "reward_type", "sparse"))
        probe.close()
        ob_space, ac_space = train_venv.observation_space, train_venv.action_space
    else:
        wrapped = env if env is not None else make_env(env_id)
        if not isinstance(wrapped, TimeLimit):
            raise ValueError("HER needs a fixed-horizon goal env behind TimeLimit")
        T = wrapped.max_episode_steps
        base = wrapped.env
        if not hasattr(base, "compute_reward"):
            raise ValueError("HER's env must have compute_reward")
        compute_reward = base.compute_reward
        ob_space, ac_space = base.observation_space, base.action_space
    do = ob_space["observation"].shape[0]
    dg = ob_space["desired_goal"].shape[0]
    du = ac_space.shape[0]
    max_action = torch.as_tensor(ac_space.high, device=device)
    if gamma is None:
        gamma = 1.0 - 1.0 / T
    clip_return = 1.0 / (1.0 - gamma)

    net_kwargs = dict(num_hidden=num_hidden, num_layers=num_layers, **network_kwargs)
    if network == "mlp":
        net_kwargs.setdefault("activation", torch.relu)
    init_gen = torch.Generator().manual_seed(seed)
    actor = GoalActor(get_network(network, ob_shape=(do + dg,), generator=init_gen,
                                  **net_kwargs), du, init_gen).to(device)
    critic = GoalCritic(get_network(network, ob_shape=(do + dg + du,), generator=init_gen,
                                    **net_kwargs), init_gen).to(device)
    actor_opt = ClipAdam(actor.parameters(), None, eps=1e-8, mesh=mesh)
    critic_opt = ClipAdam(critic.parameters(), None, eps=1e-8, mesh=mesh)
    actor_params, critic_params = list(actor.parameters()), list(critic.parameters())
    buffer = HerReplayBuffer(buffer_size_episodes, T, {"o": do, "g": dg, "u": du})

    demo_buffer = demo_state = None
    if bc_loss:
        if demo_episodes is None:
            raise ValueError("bc_loss requires demo_episodes")
        d_o, d_ag, d_g, d_u = (torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                               device=device) for x in demo_episodes)
        demo_buffer = HerReplayBuffer(d_o.shape[0], T, {"o": do, "g": dg, "u": du})
        # the demos fill the buffer in order, so the store's random slots go unused
        demo_state = demo_buffer.store_episodes(demo_buffer.init(device), Draws(0, device),
                                                d_o, d_ag, d_g, d_u)

    def normalized(state: HERTrainState, o, g):
        """o and g normalized by the state's statistics and clipped to ``norm_clip``."""
        return (state.o_rms.normalize(o, clip=norm_clip),
                state.g_rms.normalize(g, clip=norm_clip))

    def pi(state: HERTrainState, o, g) -> torch.Tensor:
        return actor(*normalized(state, o, g))

    @torch.no_grad()
    def episodes(state: HERTrainState, draws, explore: bool, host=None):
        """A rank's ``num_envs / size`` T-step episodes (her/rollout.py:50-136): o/ag (B,
        T + 1, .), g/u (B, T, .), the success (B,) of their last step, and the host
        stream's (env state, obs) after them. Fresh episodes of the device env; with
        ``host``, (venv, env state, obs) of a host pool, the episodes that its stream runs
        next."""
        if host is None:
            obs, env_state = base.reset(draws, nl, device)
        else:
            venv, env_state, obs = host
        os_, ags, gs, us = [], [], [], []
        for _ in range(T):
            o, ag, g = obs["observation"], obs["achieved_goal"], obs["desired_goal"]
            u = pi(state, o, g)
            if explore:
                u = torch.clamp(u + noise_eps * draws.normal(u.shape), -1.0, 1.0)
                u_rand = draws.uniform(u.shape, -1.0, 1.0)
                take_rand = draws.uniform((nl, 1), 0.0, 1.0) < random_eps
                u = torch.where(take_rand, u_rand, u)
            step = base.step if host is None else venv.step
            obs, env_state, _, _, info = step(draws, env_state, max_action * u)
            os_.append(o)
            ags.append(ag)
            gs.append(g)
            us.append(u)
        # the last step's observation before any reset: a host pool auto-resets there
        final = obs if host is None else info["terminal_obs"]
        os_.append(final["observation"])
        ags.append(final["achieved_goal"])
        return (torch.stack(os_, 1), torch.stack(ags, 1), torch.stack(gs, 1),
                torch.stack(us, 1), info["is_success"].to(torch.float32), (env_state, obs))

    def critic_loss(state: HERTrainState, batch: dict) -> torch.Tensor:
        """The critic's TD loss on a batch, its target clipped to [-1 / (1 - gamma), 0]
        (her/ddpg.py)."""
        o, g = normalized(state, batch["o"], batch["g"])
        with torch.no_grad():
            o2 = state.o_rms.normalize(batch["o2"], clip=norm_clip)
            q2 = state.target_critic(o2, g, state.target_actor(o2, g))
            target = torch.clamp(batch["r"] + gamma * q2, -clip_return, 0.0)
        return torch.mean(torch.square(critic(o, g, batch["u"]) - target))

    def actor_loss(state: HERTrainState, batch: dict, demo: dict | None = None):
        """-Q of the actor's action plus ``action_l2`` times its mean square; with a
        ``demo`` batch, weighted with the behaviour-cloning term (her/ddpg.py:361-377)."""
        o, g = normalized(state, batch["o"], batch["g"])
        a = actor(o, g)
        loss = -torch.mean(critic(o, g, a)) + action_l2 * torch.mean(torch.square(a))
        if demo is None:
            return loss
        o, g = normalized(state, demo["o"], demo["g"])
        a_demo = actor(o, g)
        mask = 1.0
        if q_filter:  # imitate only where the critic prefers the demonstration
            with torch.no_grad():
                q_demo, q_actor = critic(o, g, demo["u"]), critic(o, g, a_demo)
                mask = (q_demo > q_actor).to(torch.float32)[:, None]
        cloning = torch.sum(torch.square((a_demo - demo["u"]) * mask))
        return prm_loss_weight * loss + aux_loss_weight * cloning

    def train_step(state: HERTrainState, draws):
        """One update of the critic, then of the actor against the updated critic;
        returns (critic loss, actor loss)."""
        batch = buffer.sample(state.buffer, draws, batch_size, replay_k, compute_reward)
        closs = critic_loss(state, batch)
        critic_opt.step(torch.autograd.grad(closs, critic_params), q_lr)
        demo = None
        if bc_loss:  # the demonstrations keep their goals (replay_k 0)
            demo = demo_buffer.sample(demo_state, draws, demo_batch_size, 0.0, compute_reward)
        aloss = actor_loss(state, batch, demo)
        actor_opt.step(torch.autograd.grad(aloss, actor_params), pi_lr)
        return closs.detach(), aloss.detach()

    def cycle(state: HERTrainState, draws):
        """One cycle (her.py:384-424); returns the state and the last train step's
        (critic loss, actor loss). Under a mesh the episodes are gathered from every
        rank, and the store and the train steps take ``draws.replicated``."""
        host = (train_venv, state.env_state, state.obs) if host_mode else None
        o_seq, ag_seq, g_seq, u_seq, success, (env_state, obs) = episodes(
            state, draws, explore=True, host=host)
        if host_mode:
            state = dataclasses.replace(state, env_state=env_state, obs=obs)
        if mesh is not None:  # every rank's episodes, in env order
            draws = draws.replicated
            o_seq, ag_seq, g_seq, u_seq, success = all_gather_fields(
                {"o": o_seq, "ag": ag_seq, "g": g_seq, "u": u_seq, "success": success},
                mesh).values()
        success = success.mean()
        buf = buffer.store_episodes(state.buffer, draws, o_seq, ag_seq, g_seq, u_seq)
        o_rms = state.o_rms.update(o_seq.reshape(-1, do))
        g_rms = state.g_rms.update(torch.cat([g_seq.reshape(-1, dg), ag_seq.reshape(-1, dg)]))
        state = dataclasses.replace(state, buffer=buf, o_rms=o_rms, g_rms=g_rms,
                                    n_episodes=state.n_episodes + num_envs,
                                    success_rate=0.9 * state.success_rate + 0.1 * success)
        losses = None
        for _ in range(n_batches):
            losses = train_step(state, draws)
        polyak_update(state.target_actor, actor, 1 - polyak)
        polyak_update(state.target_critic, critic, 1 - polyak)
        return state, losses

    eval_stream = None  # the evaluator's host pool's (env state, obs), across epochs

    def run_eval(state: HERTrainState, draws) -> float:
        """The evaluator (her/rollout.py's exploit mode, her/her.py:49-60): the mean
        last-step success over ceil(n_test_rollouts / num_envs) rounds of episodes
        without noise, fresh ones of the device env or the evaluator pool's next."""
        nonlocal eval_stream
        rounds, total = max(1, -(-n_test_rollouts // num_envs)), 0.0
        for _ in range(rounds):
            host = (eval_venv, *eval_stream) if host_mode else None
            *_, success, stream = episodes(state, draws, explore=False, host=host)
            if host_mode:
                eval_stream = stream
            if mesh is not None:  # every rank's episodes
                success = all_gather_rows(success, mesh)
            total += float(success.mean())
        return total / rounds

    draws = Draws(seed, device)
    eval_draws = Draws(seed + 999, device)
    if mesh is not None:
        draws, eval_draws = ShardedDraws(draws, mesh), ShardedDraws(eval_draws, mesh)
    init_env_state = init_obs = None
    if host_mode:
        init_obs, init_env_state = train_venv.reset(draws)
        eval_obs, eval_env_state = eval_venv.reset(eval_draws)
        eval_stream = (eval_env_state, eval_obs)
    state = HERTrainState(
        target_actor=copy.deepcopy(actor), target_critic=copy.deepcopy(critic),
        buffer=buffer.init(device), o_rms=RunningMeanStd.create((do,), device=device),
        g_rms=RunningMeanStd.create((dg,), device=device),
        success_rate=torch.zeros((), dtype=torch.float32, device=device),
        env_state=init_env_state, obs=init_obs)
    model = HERModel(None, state, draws=draws, mesh=mesh)
    model.policy = HERPolicy(actor, critic,
                             lambda o, g: pi(model.state, o, g),
                             max_action)
    # one cycle, and the losses on a batch, for tests
    model.cycle, model.critic_loss, model.actor_loss = cycle, critic_loss, actor_loss
    if load_path is not None:
        model.load(load_path)
        state = model.state

    steps_per_epoch = n_cycles * num_envs * T
    n_epochs = max(total_timesteps // steps_per_epoch, 1) if total_timesteps > 0 else 0
    # the resolved parameters (her/her.py:126, config.py log_params), from rank 0
    if logger.get_dir() and (mesh is None or mesh.rank == 0):
        params = dict(
            env_id=env_id, network=network, T=T, num_envs=num_envs, replay_k=replay_k,
            n_cycles=n_cycles, n_batches=n_batches, n_test_rollouts=n_test_rollouts,
            batch_size=batch_size, buffer_size_episodes=buffer_size_episodes,
            polyak=polyak, gamma=gamma, q_lr=q_lr, pi_lr=pi_lr, action_l2=action_l2,
            noise_eps=noise_eps, random_eps=random_eps, norm_clip=norm_clip,
            bc_loss=bc_loss, q_filter=q_filter, demo_batch_size=demo_batch_size,
            prm_loss_weight=prm_loss_weight, aux_loss_weight=aux_loss_weight,
            num_hidden=num_hidden, num_layers=num_layers, seed=seed,
            total_timesteps=total_timesteps, n_epochs=n_epochs)
        with open(osp.join(logger.get_dir(), "params.json"), "w") as f:
            json.dump(params, f, indent=2, sort_keys=True)

    tstart = time.time()
    for epoch in range(n_epochs):
        losses = None
        for _ in range(n_cycles):
            state, losses = cycle(state, draws)
        model.state = state
        test_success = run_eval(state, eval_draws)
        if log_interval and epoch % log_interval == 0:
            logger.logkv("epoch", epoch)
            logger.logkv("train/episode", state.n_episodes)
            logger.logkv("train/success_rate", float(state.success_rate))
            logger.logkv("test/success_rate", test_success)
            logger.logkv("total/steps", (epoch + 1) * steps_per_epoch)
            logger.logkv("steps_per_second",
                         int((epoch + 1) * steps_per_epoch / (time.time() - tstart)))
            logger.logkv("train/loss_critic", float(losses[0]))
            logger.logkv("train/loss_actor", float(losses[1]))
            logger.dumpkvs()
    if host_mode:
        train_venv.close()
        eval_venv.close()
    model.state = state
    return model
