"""ppo2's gradient microbatching and separate value tower, the ppo1 adapter, and deepq on
``conv_only``, against the JAX package on the CPU; and ``--alg=ppo1`` and deepq at its
Atari defaults through the port's ``run.main``.

The updates are ``torch_parity.one_ppo_update`` on CartPole-v1 with ``mlp``, the JAX
draws injected, held by ``assert_update_metrics_match`` and
``assert_update_params_match``, the default update's bounds. The deepq iteration is
held as tests/test_torch_continuous.py holds MountainCar's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ReplayDraws, assert_update_metrics_match, assert_update_params_match,
                          one_ppo_update, push_env_step, push_reset)

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.common import jit_init
from baselines_tpu.algos.dqn import dqn as jdqn
from baselines_tpu.algos.ppo import ppo as jppo
from baselines_tpu.algos.ppo1 import ppo1 as jppo1
from baselines_tpu.envs.registry import make_env as jax_make_env
from baselines_tpu_torch import convert, run
from baselines_tpu_torch.algos.common import ClipAdam, build_env
from baselines_tpu_torch.algos.dqn import dqn
from baselines_tpu_torch.algos.ppo import ppo
from baselines_tpu_torch.algos.ppo1 import ppo1
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.schedules import LinearSchedule
from baselines_tpu_torch.data.prioritized import PrioritizedState
from baselines_tpu_torch.data.replay import ReplayBuffer
from baselines_tpu_torch.nn.networks import ConvOnly, get_network


@pytest.fixture(autouse=True)
def quiet_logger():
    yield
    logger.reset()


# --- ppo2: microbatching and value_network="copy" ------------------------------------

# each minibatch of 64 samples as 4 microbatches of 16
VARIANTS = {"microbatch_size": dict(microbatch_size=16),
            "value_network_copy": dict(value_network="copy")}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    return request.param


@pytest.fixture(scope="module")
def variant_runs(variant):
    return one_ppo_update("CartPole-v1", **VARIANTS[variant])


def test_variant_update_metrics_match_jax(variant_runs):
    assert_update_metrics_match(variant_runs["jmetrics"], variant_runs["tmetrics"])
    assert variant_runs["recorder"].min_margin() > 1e-5


def test_variant_update_params_match_jax(variant, variant_runs):
    """Each param tensor's change over the update to 2e-4 of that change; with
    ``value_network="copy"`` the value tower's own layers among them."""
    start = variant_runs["start"]
    if variant == "value_network_copy":
        assert {"value_network.mlp_fc0.weight", "value_network.mlp_fc1.bias"} <= set(start)
    assert_update_params_match(variant_runs["jnew"].params, variant_runs["tpol"], start)


def test_microbatching_matches_the_whole_minibatch():
    """The port's update with 4 microbatches of each minibatch ends within 1e-5 of the
    update without them, from the same start and draws (tests/test_microbatches.py:51's
    bound): the advantages are standardized over the whole minibatch before the split
    and the gradients averaged."""
    plain = one_ppo_update("CartPole-v1")
    micro = one_ppo_update("CartPole-v1", microbatch_size=16)
    for (name, p), q in zip(plain["tpol"].module.state_dict().items(),
                            micro["tpol"].module.state_dict().values()):
        assert float((p - q).abs().max()) < 1e-5, name
        assert not torch.equal(p, plain["start"][name]), name


# --- ppo1 -----------------------------------------------------------------------------

PPO1_ARGS = dict(env_id="CartPole-v1", total_timesteps=128, seed=0, num_envs=8,
                 timesteps_per_actorbatch=128, optim_batchsize=64, optim_epochs=2,
                 entcoeff=0.01)


def _ppo1_keywords(learn_module, ppo_module, monkeypatch, **kwargs):
    """The keywords ppo1's ``learn`` hands to ppo2's."""
    seen = {}
    monkeypatch.setattr(ppo_module, "learn", lambda **kw: seen.update(kw))
    learn_module.learn(**kwargs)
    return seen


@pytest.mark.parametrize("schedule", ["constant", "linear"])
def test_ppo1_hands_ppo2_the_jax_keywords(monkeypatch, schedule):
    """The port's ppo1 asks ppo2 for the JAX ppo1's update: batch-level advantages, no
    value clipping, ``vf_coef=2.0``, no gradient clipping, the batch split into
    ``optim_batchsize`` minibatches, and the same schedules."""
    args = dict(PPO1_ARGS, schedule=schedule, value_network="copy")
    want = _ppo1_keywords(jppo1, jppo, monkeypatch, **args)
    got = _ppo1_keywords(ppo1, ppo, monkeypatch, **args)
    assert set(got) == set(want)
    for k, v in want.items():
        assert (got[k](0.5) == v(0.5)) if callable(v) else got[k] == v, k
    assert (got["adv_norm"], got["clip_value"], got["vf_coef"], got["max_grad_norm"]) == (
        "batch", False, 2.0, None)
    assert (got["nsteps"], got["nminibatches"]) == (16, 2)


@pytest.fixture(scope="module")
def ppo1_runs():
    """One ppo1 update of both sides with the keywords the port's ppo1 hands ppo2."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ppo, "learn", lambda **kw: seen.update(kw))
        ppo1.learn(**dict(PPO1_ARGS, schedule="linear"))
    hparams = {k: seen[k] for k in ("nsteps", "nminibatches", "noptepochs", "ent_coef",
                                    "vf_coef", "gamma", "lam")}
    return one_ppo_update("CartPole-v1", hparams=hparams, max_grad_norm=seen["max_grad_norm"],
                          lr=seen["lr"], cliprange=seen["cliprange"],
                          adv_norm=seen["adv_norm"], clip_value=seen["clip_value"])


def test_ppo1_update_matches_jax(ppo1_runs):
    """Every metric and each param's change at the default update's bounds."""
    assert_update_metrics_match(ppo1_runs["jmetrics"], ppo1_runs["tmetrics"])
    assert_update_params_match(ppo1_runs["jnew"].params, ppo1_runs["tpol"], ppo1_runs["start"])


def _report(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith("episode_rew mean=")]
    assert len(lines) == 1, out
    return lines[0]


def test_run_ppo1_with_value_copy_round_trip(tmp_path, capsys):
    """``--alg=ppo1 --value_network=copy`` through ``run.main`` at ppo1's classic-control
    defaults (8 envs, 512 steps an update, minibatches of 128), train, save and play;
    then ``--load_path`` loads the policy and its value tower bit for bit and plays the
    same report."""
    path = str(tmp_path / "ppo1.pt")
    common = ["--alg=ppo1", "--env=CartPole-v1", "--seed=0", "--device=cpu", "--play",
              "--value_network=copy"]
    model = run.main(common + ["--num_timesteps=1024", f"--save_path={path}",
                               f"--log_path={tmp_path / 'a'}"])
    first = _report(capsys.readouterr().out)
    assert model.state.update_idx == 2 and model.opt.max_grad_norm is None
    loaded = run.main(common + ["--num_timesteps=0", f"--load_path={path}",
                                f"--log_path={tmp_path / 'b'}"])
    assert _report(capsys.readouterr().out) == first
    saved, back = model.policy.module.state_dict(), loaded.policy.module.state_dict()
    assert "value_network.mlp_fc0.weight" in saved and saved.keys() == back.keys()
    for name in saved:
        assert torch.equal(saved[name], back[name]), name


# --- deepq on conv_only ---------------------------------------------------------------

NENVS, BUFFER, BATCH, ITERS = 4, 64, 8, 2
HPARAMS = dict(lr=1e-3, batch_size=BATCH, learning_starts=8, train_freq=4, gamma=0.99,
               target_network_update_freq=8, prioritized_replay=False,
               prioritized_replay_eps=1e-6, double_q=True)


def test_conv_only_deepq_iteration_matches_jax():
    """deepq on ImageIdentity36-v0 with ``conv_only`` (36x36x1 frames to a 1x1x64
    latent), 2 iterations of 4 envs, the second of which trains and syncs the target
    net, from the JAX learner's initial state and draws: t, the syncs and the ring
    equal; each param's change to 1e-3 of that change in norm; the target net equal to
    the online net."""
    total = NENVS * ITERS
    starts = []

    def recording_jit_init(make_state, key):
        state = jit_init(make_state, key)
        starts.append(jax.device_get((state.params, state.obs)))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", recording_jit_init)
        jend = jdqn.learn(total_timesteps=total, env_id="ImageIdentity36-v0",
                          network="conv_only", seed=0, num_envs=NENVS, buffer_size=BUFFER,
                          exploration_fraction=0.5, exploration_final_eps=0.1, chunk_size=1,
                          print_freq=0, checkpoint_freq=None, **HPARAMS).state
    (jstart_params, jstart_obs), = starts

    base = jax_make_env("ImageIdentity36-v0")
    draws = ReplayDraws()
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    push_reset(draws, base, kreset, NENVS)
    for i in range(ITERS):
        key, kact, kstep, ksample, _ = jax.random.split(key, 5)
        ku, kr = jax.random.split(kact)
        draws.push("randint", jax.random.randint(kr, (NENVS,), 0, 4, jnp.int32))
        draws.push("uniform", jax.random.uniform(ku, (NENVS,)))
        push_env_step(draws, base, kstep, NENVS)
        t = NENVS * (i + 1)
        if t >= HPARAMS["learning_starts"]:
            draws.push("randint", jax.random.randint(ksample, (BATCH,), 0, min(t, BUFFER)))

    venv = build_env("ImageIdentity36-v0", NENVS, device="cpu")
    net = get_network("conv_only", ob_shape=(36, 36, 1))
    assert isinstance(net, ConvOnly) and net.latent_size == 64
    qnet = dqn.QNet(net, 4)
    start = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jstart_params))
    qnet.load_state_dict(start, strict=True)
    policy = dqn.QPolicy(qnet, venv.observation_space, 4)
    opt = ClipAdam(qnet.parameters(), 10.0, eps=1e-5)
    rb = ReplayBuffer(BUFFER)
    obs, env_state = venv.reset(draws)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jstart_obs))
    item = {"obs": obs[0], "action": torch.zeros((), dtype=torch.int32),
            "reward": torch.zeros(()), "next_obs": obs[0], "done": torch.zeros(())}
    state = dqn.DQNTrainState(target=copy.deepcopy(qnet), env_state=env_state, obs=obs,
                              replay=rb.init(item))
    iteration = dqn.make_iteration_fn(
        policy, venv, rb, opt, exploration=LinearSchedule(int(0.5 * total), 0.1, 1.0),
        beta_schedule=LinearSchedule(total, 1.0, 0.4), **HPARAMS)
    infos = []
    for _ in range(ITERS):
        state, info = iteration(state, draws)
        infos.append(info)
    assert not draws.queue, "the port took fewer draws than the JAX learner made"

    assert [bool(i) for i in infos] == [False, True]
    assert state.t == int(jend.t) == total and state.n_target_syncs == int(jend.n_target_syncs) == 1
    jrep, trep = jend.replay, state.replay
    assert (trep.ptr, trep.size) == (int(jrep.ptr), int(jrep.size)) == (8, 8)
    for k, v in jrep.data.items():
        np.testing.assert_array_equal(trep.data[k].numpy(), np.asarray(v), err_msg=k)
    want = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jend.params))
    for name, p in policy.module.state_dict().items():
        delta_want = want[name].double() - start[name].double()
        delta_got = p.double() - start[name].double()
        assert float(delta_want.abs().max()) > 0, name
        assert float((delta_got - delta_want).norm() / delta_want.norm()) < 1e-3, name
        assert torch.equal(state.target.state_dict()[name], p), name
    assert torch.isfinite(infos[1]["loss"]) and float(infos[1]["loss"]) > 0


def test_run_deepq_at_the_atari_defaults(tmp_path):
    """``--alg=deepq --env=AtariSim-v0 --env_type=atari`` through ``run.main``: deepq's
    Atari defaults (``conv_only``, prioritized replay, dueling), cut in size, train on
    the 84x84x4 frames and update the priorities they sample."""
    model = run.main(["--alg=deepq", "--env=AtariSim-v0", "--env_type=atari", "--seed=0",
                      "--device=cpu", "--num_timesteps=96", "--learning_starts=64",
                      "--buffer_size=128", "--batch_size=8", "--chunk_size=16",
                      f"--log_path={tmp_path}"])
    qnet = model.policy.module
    assert isinstance(qnet.network, ConvOnly) and qnet.dueling
    assert qnet.network.latent_size == 7 * 7 * 64
    replay = model.state.replay
    assert isinstance(replay, PrioritizedState) and model.state.t == 96
    prios = replay.priorities[:replay.buffer.size]
    assert bool(torch.isfinite(prios).all()) and int((prios != 1.0).sum()) > 0
