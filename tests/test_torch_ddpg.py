"""The port's ddpg (algos/ddpg/) and deepq's parameter noise against the JAX package's,
on the CPU: the action and parameter noise and the popart rescale, then the slice as a
whole, one ddpg cycle of rollout steps and train steps and a run of deepq iterations
with ``param_noise``, each side from the same weights (flax's init moved by noise,
carried across by convert.py), the same env state and the same draws, rebuilt from the
JAX learner's key splits."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import ddpg_cycle
from torch_parity import (ReplayDraws, base_env, move_params, push_env_step, push_perturbation,
                          push_reset, rel_err)

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.ddpg import ddpg as jddpg
from baselines_tpu.algos.ddpg import noise as jnoise
from baselines_tpu.algos.dqn import dqn as jdqn
from baselines_tpu.nn.networks import get_network as jax_get_network
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import ClipAdam, build_env
from baselines_tpu_torch.algos.ddpg import ddpg, noise
from baselines_tpu_torch.algos.dqn import dqn
from baselines_tpu_torch.core.logger import configure, reset
from baselines_tpu_torch.core.schedules import LinearSchedule
from baselines_tpu_torch.data.replay import ReplayBuffer
from baselines_tpu_torch.nn.networks import get_network


def _actor_pair(layer_norm: bool, seed: int = 0):
    """A JAX Actor's params (flax's init, moved) and the port's Actor carrying them."""
    jactor = jddpg.Actor(jax_get_network("mlp", num_hidden=16, layer_norm=layer_norm), 2)
    params = move_params(jactor.init(jax.random.PRNGKey(seed), jnp.zeros((1, 3))), seed)
    tactor = ddpg.Actor(get_network("mlp", ob_shape=(3,), num_hidden=16,
                                    layer_norm=layer_norm), 2)
    tactor.load_state_dict(convert.actor_state_dict(params))
    return jactor, params, tactor


def test_is_perturbable_matches_jax_on_the_ports_names():
    """The port's names and the flax paths give the same verdicts: the MLP's
    ``LayerNorm_i`` are left alone, deepq's ``action_value_ln0`` (no part starts with
    ``ln``) is perturbed in both."""
    _, params, tactor = _actor_pair(layer_norm=True)
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [getattr(p, "key", str(p)) for p in path][1:]
        want[".".join(names[:-1])] = jnoise.is_perturbable(path)
    for name, _ in tactor.named_parameters():
        assert noise.is_perturbable(name) == want[name.rsplit(".", 1)[0]], name
    assert not noise.is_perturbable("network.LayerNorm_0.weight")
    assert noise.is_perturbable("action_value_ln0.weight") and not noise.is_perturbable("ln.x")


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "no_ln"])
def test_perturb_params_matches_jax(layer_norm):
    """The perturbed actor's params to 1e-6, the port drawing one normal a perturbable
    parameter in sorted-name order, which is the JAX package's flattened order; the
    layer norms' params unchanged; the actions of the perturbed actor to 1e-6."""
    jactor, params, tactor = _actor_pair(layer_norm)
    key, stddev = jax.random.PRNGKey(7), 0.2
    want = jnoise.perturb_params(key, jax.tree_util.tree_map(jnp.asarray, params), stddev)
    draws = ReplayDraws()
    push_perturbation(draws, key, params)
    got = noise.perturb_params(draws, dict(tactor.named_parameters()), torch.tensor(stddev))
    assert not draws.queue
    want_sd = convert.actor_state_dict(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want_sd)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        moved = not torch.equal(p.detach(), tactor.state_dict()[name])
        assert moved == noise.is_perturbable(name), name
    obs = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    with torch.no_grad():
        a = torch.func.functional_call(tactor, got, (torch.from_numpy(obs),))
    np.testing.assert_allclose(a.numpy(), np.asarray(jactor.apply(want, jnp.asarray(obs))),
                               rtol=1e-6, atol=1e-6)
    distance = torch.tensor(0.3)
    for d in (0.1, 0.3, 0.5):
        np.testing.assert_allclose(
            float(noise.adapt_param_noise_stddev(torch.tensor(stddev), distance, d)),
            float(jnoise.adapt_param_noise_stddev(jnp.float32(stddev), jnp.float32(0.3), d)),
            rtol=1e-7)


@pytest.mark.parametrize("kind", ["ou_0.2", "normal_0.3"])
def test_action_noise_matches_jax(kind):
    """Ten samples of OU noise (its state carried) or normal noise, to 1e-6, from the
    same normals; parse_noise_type reads the same specs."""
    jn, jstd = jnoise.parse_noise_type(kind + ",adaptive-param_0.1", 2)
    tn, tstd = noise.parse_noise_type(kind + ",adaptive-param_0.1", 2)
    assert type(tn).__name__ == type(jn).__name__ and tstd == jstd == 0.1
    jstate, tstate = jn.init_state(3), tn.init_state(3, "cpu")
    key = jax.random.PRNGKey(1)
    for _ in range(10):
        key, k = jax.random.split(key)
        draws = ReplayDraws()
        draws.push("normal", jax.random.normal(k, (3, 2)))
        jx, jstate = jn.sample(k, jstate)
        tx, tstate = tn.sample(draws, tstate)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), rtol=1e-6, atol=1e-7)
    assert noise.parse_noise_type("none", 2) == (None, None)
    with pytest.raises(RuntimeError):
        noise.parse_noise_type("gamma_0.1", 2)


def test_popart_rescale_matches_jax():
    """The critic's output layer after the rescale to 1e-6, and the denormalized
    prediction left as it was (ddpg_learner.py:205-221)."""
    jcritic = jddpg.Critic(jax_get_network("mlp", num_hidden=16))
    params = move_params(jcritic.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)),
                                      jnp.zeros((1, 2))), 0)
    tcritic = ddpg.Critic(get_network("mlp", ob_shape=(5,), num_hidden=16))
    tcritic.load_state_dict(convert.critic_state_dict(params))
    stats = [np.float32(x) for x in (0.3, 1.7, -0.4, 2.9)]
    want = jddpg._popart_rescale(jax.tree_util.tree_map(jnp.asarray, params), *stats)
    ddpg._popart_rescale(tcritic, *[torch.tensor(x) for x in stats])
    want_sd = convert.critic_state_dict(jax.tree_util.tree_map(np.asarray, want))
    for name, p in tcritic.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_sd[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    rng = np.random.RandomState(2)
    o, a = rng.randn(6, 3).astype(np.float32), rng.randn(6, 2).astype(np.float32)
    before = np.asarray(jcritic.apply(params, o, a)) * stats[1] + stats[0]
    with torch.no_grad():
        after = tcritic(torch.from_numpy(o), torch.from_numpy(a)).numpy() * stats[3] + stats[2]
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-5)


NENVS, ROLLOUT, TRAINS, BATCH = 2, 40, 4, 16
CYCLE_CASES = {
    "pendulum_ou": dict(env_id="Pendulum-v1", noise_type="ou_0.2", actor_lr=1e-3),
    "box_param_noise": dict(env_id="BoxIdentity-v0", noise_type="adaptive-param_0.2",
                            layer_norm=True, normalize_returns=True, clip_norm=1.0,
                            gamma=0.9, param_noise_adaption_interval=2),
}


def jax_cycle(case: str, nenvs: int, draws, whole) -> dict:
    """One ddpg cycle of ROLLOUT env steps of ``nenvs`` envs and TRAINS train steps of
    the JAX learner (for one epoch of one cycle, its initial params moved by a wrapped
    ``jit_init``), and its draws rebuilt from its key splits, in the port's order: the
    env-axis ones (the reset's, the action noise, the env steps') pushed to ``draws``,
    the ones a mesh's ranks take alike (the perturbations, the replay samples) to
    ``whole``. Returns the JAX learner's start and end states and the spec of the
    port's cycle (``torch_dist_worker.ddpg_cycle``), from the same weights."""
    spec = dict(CYCLE_CASES[case])
    env_id = spec.pop("env_id")
    kwargs = dict(network="mlp", num_hidden=16, seed=0, nb_epoch_cycles=1,
                  nb_rollout_steps=ROLLOUT, nb_train_steps=TRAINS, batch_size=BATCH,
                  buffer_size=100, log_interval=0, **spec)
    starts = []

    def start_moved(make_state, key):
        state = make_state(key)
        actor = jax.tree_util.tree_map(jnp.asarray, move_params(state.actor_params, 1))
        critic = jax.tree_util.tree_map(jnp.asarray, move_params(state.critic_params, 2))
        state = jax_common.dealias(state.replace(
            actor_params=actor, critic_params=critic, target_actor_params=actor,
            target_critic_params=critic, perturbed_actor_params=actor))
        starts.append(jax.device_get(state))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", start_moved)
        jend = jddpg.learn(env_id=env_id, num_envs=nenvs, nb_epochs=1, **kwargs).state
    jstart, = starts

    jvenv = jax_build_env(env_id, nenvs, normalize=False)
    base = base_env(jvenv)
    _, kreset, _, _ = jax.random.split(jax.random.PRNGKey(0), 4)
    push_reset(draws, base, kreset, nenvs)
    param_noise = spec["noise_type"].startswith("adaptive-param")
    key = jstart.key
    if param_noise:
        key, kp = jax.random.split(key)
        push_perturbation(whole, kp, jstart.actor_params)
    for _ in range(ROLLOUT):
        key, kstep, knoise = jax.random.split(key, 3)
        if not param_noise:
            draws.push("normal", jax.random.normal(knoise, (nenvs, 1)))
        push_env_step(draws, base, kstep, nenvs)
    for i in range(TRAINS):
        key, ksample, _, kadapt = jax.random.split(key, 4)
        whole.push("randint", jax.random.randint(ksample, (BATCH,), 0,
                                                 min(nenvs * ROLLOUT, kwargs["buffer_size"])))
        if param_noise and i % spec["param_noise_adaption_interval"] == 0:
            push_perturbation(whole, kadapt, jend.actor_params)
    start = {"actor": convert.actor_state_dict(jstart.actor_params),
             "critic": convert.critic_state_dict(jstart.critic_params)}
    return dict(jstart=jstart, jend=jend,
                spec=dict(env_id=env_id, nenvs=nenvs, kwargs=kwargs, start=start))


def _one_cycle(case: str) -> dict:
    """The JAX learner's cycle of NENVS envs and the port's cycle (``learn`` built it,
    nothing trained) from the same state, with the JAX learner's draws."""
    draws = ReplayDraws()
    run = jax_cycle(case, NENVS, draws, draws)
    model, obs, state, losses = ddpg_cycle(run["spec"], draws)
    np.testing.assert_allclose(obs.numpy(), np.asarray(run["jstart"].obs), rtol=1e-6, atol=1e-7)
    assert not draws.queue, "the port took fewer draws than the JAX learner made"
    return dict(jend=run["jend"], tend=state, model=model, start=run["spec"]["start"],
                losses=losses)


@pytest.fixture(scope="module", params=list(CYCLE_CASES))
def cycle(request):
    return request.param, _one_cycle(request.param)


def check_cycle_state(case: str, nenvs: int, jend, tend, losses, rows=slice(None)) -> None:
    """After the cycle of ``nenvs`` envs: t, the ring's cursor, the stored transitions (to
    1e-5: sin/cos and the identity env's rewards round by an ulp), the observation
    statistics (count exactly), the return statistics of popart, the OU state (of the
    envs ``rows``) and the parameter noise's adapted scale."""
    assert tend.t == int(jend.t) == nenvs * ROLLOUT
    assert (tend.replay.ptr, tend.replay.size) == (int(jend.replay.ptr), int(jend.replay.size))
    for k, v in jend.replay.data.items():
        np.testing.assert_allclose(tend.replay.data[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(tend.obs_rms.count) == float(jend.obs_rms.count)
    for f in ("mean", "var"):
        np.testing.assert_allclose(getattr(tend.obs_rms, f).numpy(),
                                   np.asarray(getattr(jend.obs_rms, f)), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(getattr(tend.ret_rms, f).numpy(),
                                   np.asarray(getattr(jend.ret_rms, f)), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tend.action_noise_state.numpy(),
                               np.asarray(jend.action_noise_state)[rows], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tend.param_noise_stddev), float(jend.param_noise_stddev),
                               rtol=1e-6)
    if case == "box_param_noise":
        assert float(tend.param_noise_stddev) != 0.2  # adapted twice
        for name, p in tend.perturbed_actor_params.items():
            want = convert.actor_state_dict(jend.perturbed_actor_params)[name]
            np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert all(bool(torch.isfinite(x)) for x in losses)


def check_cycle_params(jend, start: dict, actor, critic, tend) -> None:
    """Each param's change over the train steps to 2e-4 of the JAX change, for the actor
    and the critic (Adam, the critic's L2, the clip, popart's rescale) and their Polyak
    targets, as tests/test_torch_update.py holds ppo2's params. A target moves by tau =
    1 % of the gap a step and each side rounds it to its f32 ulp at every step, which is
    about 1e-3 of so small a change; so a target's change is held to 2e-4 of the JAX
    change beside one ulp of the target a train step."""
    pairs = [("actor", actor, jend.actor_params, convert.actor_state_dict, 0),
             ("critic", critic, jend.critic_params, convert.critic_state_dict, 0),
             ("actor", tend.target_actor, jend.target_actor_params, convert.actor_state_dict,
              TRAINS),
             ("critic", tend.target_critic, jend.target_critic_params,
              convert.critic_state_dict, TRAINS)]
    for which, module, jparams, to_sd, ulps in pairs:
        want = to_sd(jax.tree_util.tree_map(np.asarray, jparams))
        for name, p in module.state_dict().items():
            base = start[which][name].double()
            delta_want = want[name].double() - base
            if float(delta_want.abs().max()) == 0:  # a layer norm under no gradient
                assert torch.equal(p, start[which][name]), name
                continue
            ulp = torch.from_numpy(np.spacing(np.abs(want[name].numpy()))).double()
            err = (p.double() - base - delta_want).abs()
            assert bool((err <= 2e-4 * delta_want.abs().max() + ulps * ulp).all()), (which, name)


def test_cycle_replay_and_statistics_match_jax(cycle):
    """The cycle's replay, statistics and noise as the JAX learner's
    (``check_cycle_state``)."""
    case, run = cycle
    check_cycle_state(case, NENVS, run["jend"], run["tend"], run["losses"])


def test_cycle_params_match_jax(cycle):
    """The cycle's params and targets as the JAX learner's (``check_cycle_params``)."""
    _, run = cycle
    check_cycle_params(run["jend"], run["start"], run["model"].policy.module,
                       run["model"].policy.critic, run["tend"])


def test_learn_runs_on_the_cpu_and_round_trips(tmp_path):
    """The entry point at a tiny size logs the JAX keys with the last train step's
    losses; ``save``/``load`` carry the actor, the critic, their targets and both
    running statistics bit for bit; a mesh that is not a ``Mesh`` raises TypeError."""
    configure(dir=str(tmp_path), format_strs=["json"])
    try:
        model = ddpg.learn(env_id="Pendulum-v1", total_timesteps=400, num_envs=2,
                           nb_epoch_cycles=2, nb_rollout_steps=50, nb_train_steps=3,
                           batch_size=16, noise_type="adaptive-param_0.2", layer_norm=True,
                           normalize_returns=True, seed=0, device="cpu")
    finally:
        reset()
    rows = [__import__("json").loads(line) for line in (tmp_path / "progress.json").open()]
    assert set(rows[-1]) == {"epoch", "total/steps", "rollout/return_history", "total/epochs",
                             "total/steps_per_second", "param_noise_stddev",
                             "train/loss_actor", "train/loss_critic"}
    assert rows[-1]["total/steps"] == 400 and model.state.t == 400
    model.save(str(tmp_path / "m.pt"))
    loaded = ddpg.learn(env_id="Pendulum-v1", total_timesteps=0, num_envs=2, seed=1,
                        layer_norm=True, load_path=str(tmp_path / "m.pt"), device="cpu")
    for a, b in zip(model._ckpt_tree().values(), loaded._ckpt_tree().values()):
        sa = a.state_dict() if hasattr(a, "state_dict") else dataclasses.asdict(a)
        sb = b.state_dict() if hasattr(b, "state_dict") else dataclasses.asdict(b)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    obs = torch.randn(3, 3)
    assert torch.equal(model.policy.mode_step(obs)[0], loaded.policy.mode_step(obs)[0])
    with pytest.raises(TypeError, match="Mesh"):
        ddpg.learn(env_id="Pendulum-v1", total_timesteps=0, device="cpu", mesh=object())


DQN_NENVS, DQN_ITERS = 4, 40
DQN_HP = dict(lr=1e-3, batch_size=8, learning_starts=16, train_freq=1, gamma=0.99,
              target_network_update_freq=40, prioritized_replay=False,
              prioritized_replay_eps=1e-6, double_q=True)
DQN_LEARN = dict(env_id="CartPole-v1", network="mlp", seed=0, num_envs=DQN_NENVS,
                 buffer_size=200, exploration_fraction=0.5, exploration_final_eps=0.1,
                 hiddens=(32,), layer_norm=True, chunk_size=DQN_ITERS, print_freq=0,
                 checkpoint_freq=None, param_noise=True, **DQN_HP)


class PerIterationDraws(ReplayDraws):
    """Recorded draws, with the perturbation normals of each iteration apart: the port
    draws them only in an iteration where an episode ended, and the JAX learner
    computes them in every one."""

    normals: list = []

    def normal(self, shape):
        values = self.normals.pop(0)
        assert values.shape == tuple(shape), (values.shape, shape)
        return torch.from_numpy(values.copy())


@pytest.fixture(scope="module")
def dqn_runs():
    """JAX: deepq with ``param_noise`` on CartPole for DQN_ITERS iterations of 4 envs,
    its initial params moved (and the target and perturbed nets equal to them). The
    port: ``make_iteration_fn(param_noise=True)`` from the same state with the same
    draws, each iteration's perturbation normals from its own key."""
    total = DQN_NENVS * DQN_ITERS
    starts = []

    def start_moved(make_state, key):
        state = make_state(key)
        params = jax.tree_util.tree_map(jnp.asarray, move_params(state.params, 3))
        state = jax_common.dealias(state.replace(params=params, target_params=params,
                                                 perturbed_params=params))
        starts.append(jax.device_get(state))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", start_moved)
        jend = jdqn.learn(total_timesteps=total, **DQN_LEARN).state
    jstart, = starts

    jvenv = jax_build_env("CartPole-v1", DQN_NENVS)
    base = base_env(jvenv)
    draws = PerIterationDraws()
    _, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    push_reset(draws, base, kreset, DQN_NENVS)
    key, perturbations = jstart.key, []
    for i in range(DQN_ITERS):
        key, kact, kstep, ksample, kperturb = jax.random.split(key, 5)
        ku, kr = jax.random.split(kact)
        draws.push("randint", jax.random.randint(kr, (DQN_NENVS,), 0, 2, jnp.int32))
        draws.push("uniform", jax.random.uniform(ku, (DQN_NENVS,)))
        push_env_step(draws, base, kstep, DQN_NENVS)
        if DQN_NENVS * (i + 1) >= DQN_HP["learning_starts"]:
            draws.push("randint", jax.random.randint(ksample, (8,), 0,
                                                     min(DQN_NENVS * (i + 1), 200)))
        normals = ReplayDraws()
        push_perturbation(normals, kperturb, jstart.params)
        perturbations.append([v for _, v in normals.queue])

    tvenv = build_env("CartPole-v1", DQN_NENVS, device="cpu")
    net = get_network("mlp", ob_shape=(4,))
    qnet = dqn.QNet(net, 2, hiddens=(32,), layer_norm=True)
    start = convert.q_state_dict(jstart.params)
    qnet.load_state_dict(start)
    policy = dqn.QPolicy(qnet, tvenv.observation_space, 2)
    opt = ClipAdam(qnet.parameters(), 10.0, eps=1e-5)
    rb = ReplayBuffer(200)
    obs, env_state = tvenv.reset(draws)
    item = {"obs": obs[0], "action": torch.zeros((), dtype=torch.int32),
            "reward": torch.zeros(()), "next_obs": obs[0], "done": torch.zeros(())}
    state = dqn.DQNTrainState(target=copy.deepcopy(qnet), env_state=env_state, obs=obs,
                              replay=rb.init(item), perturbed=copy.deepcopy(qnet),
                              param_noise_scale=torch.tensor(0.01))
    iteration = dqn.make_iteration_fn(
        policy, tvenv, rb, opt, exploration=LinearSchedule(int(0.5 * total), 0.1, 1.0),
        beta_schedule=LinearSchedule(total, 1.0, 0.4), param_noise=True, **DQN_HP)
    adapted = 0
    for i in range(DQN_ITERS):
        draws.normals = list(perturbations[i])
        scale = state.param_noise_scale
        state, _ = iteration(state, draws)
        adapted += state.param_noise_scale is not scale
        assert not draws.normals or len(draws.normals) == len(perturbations[i])
    assert not draws.queue, "the port took fewer draws than the JAX learner made"
    return dict(jend=jend, tend=state, policy=policy, start=start, adapted=adapted)


def test_dqn_param_noise_adapts_and_perturbs_as_jax(dqn_runs):
    """After the iterations: the episodes ended often enough to adapt several times; the
    adapted scale to 1e-5; the perturbed net's params, the online params' change (to
    2e-4 of it, as the update tests hold params) and the replay as the JAX learner's."""
    jend, tend = dqn_runs["jend"], dqn_runs["tend"]
    assert dqn_runs["adapted"] >= 3
    assert tend.t == int(jend.t)
    np.testing.assert_allclose(float(tend.param_noise_scale), float(jend.param_noise_scale),
                               rtol=1e-5)
    assert float(tend.param_noise_scale) != 0.01
    for k, v in jend.replay.data.items():
        np.testing.assert_allclose(tend.replay.data[k].numpy(), np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    want = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jend.params))
    for name, p in dqn_runs["policy"].module.state_dict().items():
        base = dqn_runs["start"][name].double()
        delta_want = want[name].double() - base
        assert float(delta_want.abs().max()) > 0, name
        assert rel_err(p.double() - base, delta_want) < 2e-4, name
    jpert = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jend.perturbed_params))
    for name, p in tend.perturbed.state_dict().items():
        assert rel_err(p, jpert[name]) < 1e-5, name


def test_dqn_param_noise_learns_and_checkpoints(tmp_path):
    """deepq with ``param_noise`` through learn on the CPU: the scale moves, and the
    ``latest`` checkpoint holds it with the perturbed net, resumed by a second run."""
    kwargs = dict(env_id="CartPole-v1", total_timesteps=256, learning_starts=64,
                  chunk_size=32, param_noise=True, checkpoint_path=str(tmp_path),
                  checkpoint_freq=64, print_freq=0, seed=0, device="cpu")
    model = dqn.learn(**kwargs)
    scale = float(model.state.param_noise_scale)
    assert np.isfinite(scale) and scale != 0.01
    tree = torch.load(tmp_path / "latest", weights_only=True)
    assert {"param_noise_scale", "perturbed_params"} <= set(tree)
    resumed = dqn.learn(**dict(kwargs, total_timesteps=32))
    assert resumed.state.t == int(tree["t"]) + 32
