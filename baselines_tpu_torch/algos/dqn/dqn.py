"""DQN (counterpart of baselines_tpu/algos/dqn/dqn.py, after baselines/deepq).

Update rule as deepq/build_graph.py:317-449: double-Q action selection by the online
net, evaluated with the target net; the huber TD loss weighted by importance weights;
clipping by global norm 10, then Adam; a hard copy to the target net every
``target_network_update_freq`` env steps. Loop as deepq/deepq.py:95-332: epsilon-greedy
on a linear schedule over ``exploration_fraction * total_timesteps``,
``learning_starts`` / ``train_freq`` gating, prioritized replay with beta annealed and
priorities |td| + eps, dueling heads (deepq/models.py:30-45).

The JAX package runs ``chunk_size`` iterations as one ``lax.scan``; the port runs them
as a Python loop of ``iteration`` calls, with the step count and the ring cursor on the
host (they follow from the number of iterations alone) and everything else on the card.
The epsilon-greedy act step of the bf16 ``cnn_s2d`` net runs the fused CNN kernel on
weights packed from the current params at every step, since the params change at every
training iteration. Prioritized replay samples through the stratified-sampling kernel,
where the JAX package leaves its Pallas sampler off.

Checkpoints as dqn.py:388-496 (deepq/deepq.py:244-331): ``<checkpoint_path>/latest``
holds the train fields (params, target params, Adam moments and count, ``t``,
``n_target_syncs``), written every ``checkpoint_freq`` steps once training has started,
and resumed with its progress; ``<checkpoint_path>/best`` is written when the
100-episode mean return improves after more than 100 episodes, and restored without
its progress at the end, so the returned model is the best seen. The envs and the
replay start afresh on resume, as in the reference.
"""

from __future__ import annotations

import copy
import math
import os.path as osp
import time
from dataclasses import dataclass, replace
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from baselines_tpu_torch.algos.common import ClipAdam, Model, build_env, not_ported
from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.device import resolve_device
from baselines_tpu_torch.core.math import huber_loss
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.core.schedules import LinearSchedule
from baselines_tpu_torch.data.prioritized import PrioritizedReplayBuffer
from baselines_tpu_torch.data.replay import ReplayBuffer
from baselines_tpu_torch.envs.spaces import Discrete
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.networks import _ortho, get_network
from baselines_tpu_torch.nn.policy import act_latent, encode_observation, encoded_shape


class QNet(nn.Module):
    """network latent -> hiddens -> [dueling] q-values (deepq/models.py:5-45). Each
    stream is ``{name}_fc{i}`` (orthogonal, gain sqrt 2), optionally ``{name}_ln{i}``
    (LayerNorm with flax's eps of 1e-6), relu, then ``{name}_out`` (gain 1); the
    dueling output is ``state + (a - mean a)``."""

    def __init__(self, network: nn.Module, n_actions: int, hiddens: Sequence[int] = (256,),
                 dueling: bool = True, layer_norm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.network = network
        self.n_actions = int(n_actions)
        self.hiddens = tuple(hiddens)
        self.dueling = dueling
        self.layer_norm = layer_norm
        self._add_stream("action_value", self.n_actions, generator)
        if dueling:
            self._add_stream("state_value", 1, generator)

    def _add_stream(self, name: str, out_dim: int, generator) -> None:
        width = self.network.latent_size
        for i, n_h in enumerate(self.hiddens):
            self.add_module(f"{name}_fc{i}", _ortho(nn.Linear(width, n_h), math.sqrt(2), generator))
            if self.layer_norm:
                self.add_module(f"{name}_ln{i}", nn.LayerNorm(n_h, eps=1e-6))
            width = n_h
        self.add_module(f"{name}_out", _ortho(nn.Linear(width, out_dim), 1.0, generator))

    def _stream(self, h: torch.Tensor, name: str) -> torch.Tensor:
        for i in range(len(self.hiddens)):
            h = getattr(self, f"{name}_fc{i}")(h)
            if self.layer_norm:
                h = getattr(self, f"{name}_ln{i}")(h)
            h = F.relu(h)
        return getattr(self, f"{name}_out")(h)

    def head(self, latent: torch.Tensor) -> torch.Tensor:
        """q-values from the f32 latent."""
        latent = latent.reshape(latent.shape[0], -1)
        action_scores = self._stream(latent, "action_value")
        if not self.dueling:
            return action_scores
        state_score = self._stream(latent, "state_value")
        return state_score + (action_scores - action_scores.mean(dim=-1, keepdim=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.network(x))


class QPolicy:
    """The policy surface over a Q-net (dqn.py:85-132): epsilon-greedy ``step``, greedy
    ``mode_step`` and ``value``. ``q_values`` runs the module with autograd; the act
    step runs without, and for the bf16 ``cnn_s2d`` net its latent comes from the fused
    CNN kernel on weights packed from the current params."""

    def __init__(self, module: QNet, ob_space, n_actions: int):
        self.module = module
        self.ob_space = ob_space
        self.n_actions = int(n_actions)

    def q_values(self, obs: torch.Tensor, module: QNet | None = None) -> torch.Tensor:
        """q-values of ``module`` (the online net by default) with autograd."""
        module = self.module if module is None else module
        return module(encode_observation(self.ob_space, obs))

    @torch.no_grad()
    def act_q_values(self, obs: torch.Tensor) -> torch.Tensor:
        obs = encode_observation(self.ob_space, obs)
        return self.module.head(act_latent(self.module.network, obs))

    @torch.no_grad()
    def eps_greedy(self, obs: torch.Tensor, draws, eps: float) -> torch.Tensor:
        """build_graph.py:146-199: independent epsilon-greedy for each env; the random
        actions are drawn first, then the uniforms compared with ``eps``."""
        greedy = torch.argmax(self.act_q_values(obs), dim=-1).to(torch.int32)
        random_actions = draws.randint(0, self.n_actions, greedy.shape)
        use_random = draws.uniform(greedy.shape, 0.0, 1.0) < eps
        return torch.where(use_random, random_actions, greedy)

    def step(self, obs: torch.Tensor, draws):
        """(action, None, None): greedy, with its draws taken as epsilon-greedy's."""
        return self.eps_greedy(obs, draws, 0.0), None, None

    @torch.no_grad()
    def mode_step(self, obs: torch.Tensor):
        q = self.act_q_values(obs)
        return torch.argmax(q, dim=-1).to(torch.int32), torch.max(q, dim=-1).values

    @torch.no_grad()
    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.max(self.act_q_values(obs), dim=-1).values


@dataclass
class DQNTrainState:
    """What an iteration carries to the next; the online params live in the policy's
    module and the Adam moments in the optimizer."""

    target: QNet
    env_state: Any
    obs: torch.Tensor
    replay: Any
    t: int = 0  # total env steps so far
    n_target_syncs: int = 0


def td_loss(policy: QPolicy, target: QNet, batch: dict, weights: torch.Tensor, *,
            gamma: float, double_q: bool):
    """(loss, td) of dqn.py:211-227: the importance-weighted mean huber loss of the TD
    error; the target takes no gradient."""
    q_t = policy.q_values(batch["obs"])
    q_sel = q_t.gather(1, batch["action"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_tp1_target = policy.q_values(batch["next_obs"], target)
        if double_q:
            a_prime = torch.argmax(policy.q_values(batch["next_obs"]), dim=-1)
            q_tp1_best = q_tp1_target.gather(1, a_prime[:, None])[:, 0]
        else:
            q_tp1_best = torch.max(q_tp1_target, dim=-1).values
        q_tp1_best = (1.0 - batch["done"]) * q_tp1_best
        target_q = batch["reward"] + gamma * q_tp1_best
    td = q_sel - target_q
    return torch.mean(weights * huber_loss(td)), td


def make_iteration_fn(policy: QPolicy, venv, rb, opt: ClipAdam, *, lr: float, batch_size: int,
                      learning_starts: int, train_freq: int, gamma: float,
                      target_network_update_freq: int, prioritized_replay: bool,
                      prioritized_replay_eps: float, double_q: bool,
                      exploration: LinearSchedule, beta_schedule: LinearSchedule):
    """One deepq iteration (dqn.py:229-344): ``iteration(state, draws) -> (state,
    info)``. It acts, steps the envs, adds the transitions, trains when ``t >=
    learning_starts`` and ``t % train_freq < nenvs``, and copies the params to the
    target net when ``t // target_network_update_freq`` passes the syncs made. ``info``
    holds the sampled ``idx``, ``td`` and ``loss`` of a training iteration, else is
    empty. Draws are taken in this order: the act step's, the env step's, the sample's."""
    nenvs = venv.num_envs
    params = opt.params

    def iteration(state: DQNTrainState, draws):
        eps = float(exploration.value(state.t))
        action = policy.eps_greedy(state.obs, draws, eps)
        nobs, env_state, rew, done, step_info = venv.step(draws, state.env_state, action)
        transition = {
            "obs": state.obs,
            "action": action,
            "reward": rew,
            "next_obs": step_info["terminal_obs"],  # the pre-reset obs, the true s'
            "done": done.to(torch.float32),
        }
        replay = rb.add_batch(state.replay, transition)
        t = state.t + nenvs

        info = {}
        if t >= learning_starts and t % train_freq < nenvs:
            if prioritized_replay:
                beta = float(beta_schedule.value(t))
                batch, idx, weights = rb.sample(replay, draws, batch_size, beta)
            else:
                batch, idx = rb.sample(replay, draws, batch_size)
                weights = torch.ones((batch_size,), dtype=torch.float32, device=action.device)
            loss, td = td_loss(policy, state.target, batch, weights, gamma=gamma,
                               double_q=double_q)
            grads = torch.autograd.grad(loss, params)
            opt.step(grads, lr)
            td = td.detach()
            if prioritized_replay:
                replay = rb.update_priorities(replay, idx, td.abs() + prioritized_replay_eps)
            info = {"idx": idx, "td": td, "loss": loss.detach()}

        n_target_syncs = state.n_target_syncs
        want_syncs = t // target_network_update_freq
        if want_syncs > n_target_syncs:
            with torch.no_grad():
                for tp, p in zip(state.target.parameters(), policy.module.parameters()):
                    tp.copy_(p)
            n_target_syncs = want_syncs
        new_state = DQNTrainState(target=state.target, env_state=env_state, obs=nobs,
                                  replay=replay, t=t, n_target_syncs=n_target_syncs)
        return new_state, info

    return iteration


def learn(
    *,
    env=None,
    env_id: str | None = None,
    network: str = "mlp",
    total_timesteps: int,
    seed: int | None = None,
    num_envs: int = 1,
    env_kwargs: dict | None = None,
    lr: float = 5e-4,
    buffer_size: int = 50000,
    exploration_fraction: float = 0.1,
    exploration_final_eps: float = 0.02,
    train_freq: int = 1,
    batch_size: int = 32,
    print_freq: int = 100,
    learning_starts: int = 1000,
    gamma: float = 1.0,
    target_network_update_freq: int = 500,
    prioritized_replay: bool = False,
    prioritized_replay_alpha: float = 0.6,
    prioritized_replay_beta0: float = 0.4,
    prioritized_replay_beta_iters: int | None = None,
    prioritized_replay_eps: float = 1e-6,
    double_q: bool = True,
    dueling: bool = True,
    param_noise: bool = False,
    hiddens: Sequence[int] = (256,),
    layer_norm: bool = False,
    grad_norm_clipping: float = 10.0,
    chunk_size: int = 256,
    checkpoint_freq: int | None = 10000,
    checkpoint_path: str | None = None,
    load_path: str | None = None,
    mesh=None,
    chunk_timing: list | None = None,
    device=None,
    **network_kwargs,
) -> Model:
    """Train deepq (deepq/deepq.py:95-332 signature and defaults), logging the keys of
    dqn.py:476-490 every ``(print_freq * 100) // (chunk_size * nenvs)`` chunks.

    ``device`` is the card unless the caller passes ``"cpu"``; ``env_kwargs`` go to
    ``build_env`` (``normalize``, ``reward_scale``, ``frame_stack``, ``s2d``), so the
    replay stores the observations and ``info['terminal_obs']`` as the outermost
    wrapper gives them; the remaining keywords go to the network
    (for example ``dtype=torch.bfloat16``). ``chunk_timing``, when a list, gets the
    wall time after each chunk, the device synchronized."""
    if param_noise:
        not_ported("deepq", "param_noise", "item 7 (its perturbation comes with ddpg)")
    if mesh is not None:
        not_ported("deepq", "mesh", "item 5 (data parallelism)")
    device = resolve_device(device)
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    venv = env if env is not None else build_env(env_id, num_envs, device=device,
                                                 **(env_kwargs or {}))
    nenvs = venv.num_envs
    if not isinstance(venv.action_space, Discrete):
        raise ValueError(f"DQN requires discrete actions, got {venv.action_space!r}")
    n_actions = venv.action_space.n

    init_gen = torch.Generator().manual_seed(seed)
    net = get_network(network, ob_shape=encoded_shape(venv.observation_space),
                      generator=init_gen, **network_kwargs)
    qnet = QNet(net, n_actions, hiddens=hiddens, dueling=dueling, layer_norm=layer_norm,
                generator=init_gen).to(device)
    policy = QPolicy(qnet, venv.observation_space, n_actions)
    opt = ClipAdam(qnet.parameters(), grad_norm_clipping, eps=1e-5)

    exploration = LinearSchedule(int(exploration_fraction * total_timesteps),
                                 exploration_final_eps, 1.0)
    beta_schedule = LinearSchedule(prioritized_replay_beta_iters or total_timesteps, 1.0,
                                   prioritized_replay_beta0)
    if prioritized_replay:
        rb = PrioritizedReplayBuffer(buffer_size, prioritized_replay_alpha)
    else:
        rb = ReplayBuffer(buffer_size)

    draws = Draws(seed, device)
    obs, env_state = venv.reset(draws)
    sample_item = {
        "obs": obs[0],
        "action": torch.zeros((), dtype=torch.int32, device=device),
        "reward": torch.zeros((), dtype=torch.float32, device=device),
        "next_obs": obs[0],
        "done": torch.zeros((), dtype=torch.float32, device=device),
    }
    state = DQNTrainState(target=copy.deepcopy(qnet), env_state=env_state, obs=obs,
                          replay=rb.init(sample_item))
    iteration = make_iteration_fn(
        policy, venv, rb, opt, lr=lr, batch_size=batch_size, learning_starts=learning_starts,
        train_freq=train_freq, gamma=gamma, target_network_update_freq=target_network_update_freq,
        prioritized_replay=prioritized_replay, prioritized_replay_eps=prioritized_replay_eps,
        double_q=double_q, exploration=exploration, beta_schedule=beta_schedule,
    )

    model = Model(policy, state, opt, draws)
    if load_path is not None:
        model.load(load_path)

    latest_file = best_file = None
    best_mean_reward = None
    ckpt_marker = -1

    def train_fields(s: DQNTrainState) -> dict:
        return {"params": qnet, "target_params": s.target, "opt": opt, "t": s.t,
                "n_target_syncs": s.n_target_syncs}

    def restore_fields(s: DQNTrainState, path: str, with_progress: bool) -> DQNTrainState:
        tree = ckpt.load_state(path, map_location=device)
        tree.pop("best_mean_reward", None)
        fields = train_fields(s)
        if not with_progress:
            for k in ("t", "n_target_syncs"):
                tree.pop(k)
                fields.pop(k)
        fields = ckpt.from_tree(tree, fields)
        return replace(s, t=fields.get("t", s.t),
                       n_target_syncs=fields.get("n_target_syncs", s.n_target_syncs))

    if checkpoint_path is not None:
        latest_file = osp.join(checkpoint_path, "latest")
        best_file = osp.join(checkpoint_path, "best")
        if osp.exists(latest_file):
            state = restore_fields(state, latest_file, with_progress=True)
            logger.log(f"Resumed training state from {latest_file} at t={state.t}")
        if osp.exists(best_file):
            best_mean_reward = float(ckpt.load_state(best_file)["best_mean_reward"])
            logger.log(f"Found best checkpoint (mean reward {best_mean_reward:.1f})")

    steps_per_chunk = chunk_size * nenvs
    nchunks = max(total_timesteps // steps_per_chunk, 1) if total_timesteps > 0 else 0
    tstart = time.time()
    for chunk in range(1, nchunks + 1):
        for _ in range(chunk_size):
            state, _ = iteration(state, draws)
        if chunk_timing is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            chunk_timing.append(time.time())
        if latest_file is not None and checkpoint_freq:
            marker = state.t // checkpoint_freq
            if state.t >= learning_starts and marker > ckpt_marker:
                ckpt_marker = marker
                ckpt.save_state(latest_file, train_fields(state))
                stats = VecMonitor.get_stats(state.env_state)
                episodes, mean100 = int(stats.episodes), float(stats.mean_return)
                if episodes > 100 and (best_mean_reward is None or mean100 > best_mean_reward):
                    if print_freq is not None:
                        logger.log(f"Saving best model: mean reward {best_mean_reward} -> "
                                   f"{mean100:.1f}")
                    best_mean_reward = mean100
                    ckpt.save_state(best_file, dict(train_fields(state),
                                                    best_mean_reward=mean100))
        if print_freq and chunk % max(1, (print_freq * 100) // steps_per_chunk) == 0:
            stats = VecMonitor.get_stats(state.env_state)
            episodes = int(stats.episodes)  # waits for the device
            logger.logkv("steps", state.t)
            logger.logkv("episodes", episodes)
            logger.logkv("mean 100 episode reward", float(stats.mean_return))
            logger.logkv("% time spent exploring", int(100 * float(exploration.value(state.t))))
            logger.logkv("fps", int(state.t / (time.time() - tstart)))
            logger.dumpkvs()
    if best_file is not None and osp.exists(best_file):
        if print_freq is not None and best_mean_reward is not None:
            logger.log(f"Restored model with mean reward: {best_mean_reward:.1f}")
        state = restore_fields(state, best_file, with_progress=False)
    model.state = state
    return model
