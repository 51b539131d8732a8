"""Continuous control and the env layer through the learners, against the JAX package's
on the CPU: one ppo2 update on Pendulum-v1 with VecRewardScale and VecNormalize (a
diagonal-Gaussian head), one on MultiDiscreteIdentity-v0 (a multi-categorical head),
one deepq training iteration on MountainCar-v0, ``Model.save``/``load`` with the
VecNormalize statistics, ``evaluate`` under trained statistics, bitwise resume with
VecNormalize, and the ``run.main`` round trip with ``--reward_scale`` and
``--env_kwargs="{'normalize': True}"``.

Tolerances: the updates' metrics and params as tests/torch_parity.py holds CartPole's
(1e-4 relative / 1e-6 absolute; each param's change to 2e-4 of that change); running
statistics to rtol 1e-5 with their counts bit for bit; deepq as tests/test_torch_mlp.py
holds CartPole's; ``evaluate``'s mean return to rtol 1e-4 (200 steps of Pendulum, whose
sin/cos differ from XLA's by an ulp), its lengths and episode counts exactly; the port
against itself (save/load, resume, the CLI) bit for bit."""

import copy
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ROLLOUT_ATOL, ROLLOUT_RTOL, ReplayDraws, assert_update_metrics_match,
                          assert_update_params_match, mlp_policy_params, one_ppo_update,
                          push_env_step, push_reset)

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.common import Model as JaxModel
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.common import evaluate as jax_evaluate
from baselines_tpu.algos.common import jit_init
from baselines_tpu.algos.dqn import dqn as jdqn
from baselines_tpu.core.running_stats import RunningMeanStd as JaxRMS
from baselines_tpu.envs.registry import make_env as jax_make_env
from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu.envs.vec import find_normalize_state as jax_find_normalize_state
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import algos, convert, run
from baselines_tpu_torch.algos.common import ClipAdam, Model, build_env, evaluate
from baselines_tpu_torch.algos.dqn import dqn
from baselines_tpu_torch.algos.ppo import ppo
from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.running_stats import RunningMeanStd
from baselines_tpu_torch.core.schedules import LinearSchedule
from baselines_tpu_torch.data.replay import ReplayBuffer
from baselines_tpu_torch.envs.vec import (NormalizeState, VecMonitor, VecNormalize,
                                          VecRewardScale, find_normalize_state)
from baselines_tpu_torch.nn.networks import MLP
from baselines_tpu_torch.nn.policy import build_policy

STAT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def quiet_logger():
    yield
    logger.reset()


def _assert_stats_match(mine: RunningMeanStd, theirs) -> None:
    np.testing.assert_allclose(mine.mean.numpy(), np.asarray(theirs.mean), rtol=STAT_RTOL)
    np.testing.assert_allclose(mine.var.numpy(), np.asarray(theirs.var), rtol=STAT_RTOL)
    np.testing.assert_array_equal(mine.count.numpy(), np.asarray(theirs.count))


def test_pendulum_ppo_update_with_vec_normalize_matches_jax():
    """One ppo2 update on Pendulum-v1 with mlp, VecRewardScale(0.1) and VecNormalize,
    from the same params (``logstd`` at -0.5) and draws (the Gaussian noise of every
    rollout step): every metric to 1e-4 relative or 1e-6 absolute, each param's change
    (``logstd``'s included) to 2e-4 of that change, the final normalized obs to 1e-4 /
    1e-5, and both running statistics to rtol 1e-5 with their counts bit for bit."""
    r = one_ppo_update("Pendulum-v1", env_kwargs={"normalize": True, "reward_scale": 0.1})
    assert_update_metrics_match(r["jmetrics"], r["tmetrics"])
    assert_update_params_match(r["jnew"].params, r["tpol"], r["start"])
    assert "logstd" in r["start"] and r["tpol"].pdtype.kind == "diag_gaussian"
    jnew, tnew = r["jnew"], r["tnew"]
    np.testing.assert_allclose(tnew.obs.numpy(), np.asarray(jnew.obs), rtol=1e-4, atol=1e-5)
    tns, jns = find_normalize_state(tnew.env_state), jax_find_normalize_state(jnew.env_state)
    _assert_stats_match(tns.ob_rms, jns.ob_rms)
    _assert_stats_match(tns.ret_rms, jns.ret_rms)
    assert abs(float(tns.ob_rms.count) - (1e-4 + 8 + 16 * 8)) < 1e-3  # the reset, 16 steps
    np.testing.assert_allclose(tns.ret.numpy(), np.asarray(jns.ret), rtol=1e-4, atol=1e-6)


def test_multidiscrete_identity_ppo_update_matches_jax():
    """One ppo2 update on MultiDiscreteIdentity-v0 (one-hot encoded MultiDiscrete
    observations, a multi-categorical head fed one uniform tensor for each categorical):
    metrics and params as on CartPole; the obs, rewards and episode state bit for bit."""
    r = one_ppo_update("MultiDiscreteIdentity-v0")
    assert_update_metrics_match(r["jmetrics"], r["tmetrics"])
    assert_update_params_match(r["jnew"].params, r["tpol"], r["start"])
    jnew, tnew = r["jnew"], r["tnew"]
    np.testing.assert_array_equal(tnew.obs.numpy(), np.asarray(jnew.obs))
    assert r["tpol"].pdtype.kind == "multicategorical"
    js, ts = JaxVecMonitor.get_stats(jnew.env_state), VecMonitor.get_stats(tnew.env_state)
    np.testing.assert_array_equal(ts.ep_return.numpy(), np.asarray(js.ep_return))


# --- one deepq training iteration on MountainCar-v0 -----------------------------------

NENVS, BUFFER, BATCH, ITERS = 4, 64, 8, 2
HPARAMS = dict(lr=1e-3, batch_size=BATCH, learning_starts=8, train_freq=4, gamma=0.99,
               target_network_update_freq=8, prioritized_replay=False,
               prioritized_replay_eps=1e-6, double_q=True)


def test_mountain_car_deepq_iteration_matches_jax():
    """deepq on MountainCar-v0 with mlp, 2 iterations of 4 envs, the second of which
    trains and syncs the target net, from the JAX learner's initial state and draws:
    t, the syncs and the ring cursor equal; the stored actions, rewards and dones equal
    and the stored observations to 1e-4 relative / 1e-6 absolute; each param's change
    to 1e-3 of that change in norm; the target net equal to the online net."""
    total = NENVS * ITERS
    starts = []

    def recording_jit_init(make_state, key):
        state = jit_init(make_state, key)
        starts.append(jax.device_get((state.params, state.obs)))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", recording_jit_init)
        jend = jdqn.learn(total_timesteps=total, env_id="MountainCar-v0", network="mlp", seed=0,
                          num_envs=NENVS, buffer_size=BUFFER, exploration_fraction=0.5,
                          exploration_final_eps=0.1, chunk_size=1, print_freq=0,
                          checkpoint_freq=None, **HPARAMS).state
    (jstart_params, jstart_obs), = starts

    base = jax_make_env("MountainCar-v0")
    draws = ReplayDraws()
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    push_reset(draws, base, kreset, NENVS)
    for i in range(ITERS):
        key, kact, kstep, ksample, _ = jax.random.split(key, 5)
        ku, kr = jax.random.split(kact)
        draws.push("randint", jax.random.randint(kr, (NENVS,), 0, 3, jnp.int32))
        draws.push("uniform", jax.random.uniform(ku, (NENVS,)))
        push_env_step(draws, base, kstep, NENVS)
        t = NENVS * (i + 1)
        if t >= HPARAMS["learning_starts"]:
            draws.push("randint", jax.random.randint(ksample, (BATCH,), 0, min(t, BUFFER)))

    venv = build_env("MountainCar-v0", NENVS, device="cpu")
    qnet = dqn.QNet(MLP(ob_shape=(2,)), 3)
    start = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jstart_params))
    qnet.load_state_dict(start)
    policy = dqn.QPolicy(qnet, venv.observation_space, 3)
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
        if k in ("obs", "next_obs"):
            np.testing.assert_allclose(trep.data[k].numpy(), np.asarray(v), rtol=ROLLOUT_RTOL,
                                       atol=ROLLOUT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(trep.data[k].numpy(), np.asarray(v), err_msg=k)
    want = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jend.params))
    got = policy.module.state_dict()
    for name, p in got.items():
        delta_want = want[name].double() - start[name].double()
        delta_got = p.double() - start[name].double()
        assert float(delta_want.abs().max()) > 0, name
        assert float((delta_got - delta_want).norm() / delta_want.norm()) < 1e-3, name
        assert torch.equal(state.target.state_dict()[name], p), name
    assert torch.isfinite(infos[1]["loss"]) and float(infos[1]["loss"]) > 0


# --- save, load, play and resume with VecNormalize -----------------------------------

PPO = dict(env_id="Pendulum-v1", network="mlp", seed=0, num_envs=4, nsteps=32,
           nminibatches=2, noptepochs=2, log_interval=100, device="cpu", num_hidden=16,
           env_kwargs={"normalize": True, "reward_scale": 0.1})


def test_model_save_load_carries_norm_stats(tmp_path):
    """``save`` writes the params (``logstd`` included) and both running statistics;
    ``load`` into a fresh normalized learner restores all of them bit for bit; a model
    trained without VecNormalize saves params only, and loading a normalized file into
    it leaves its env state without statistics."""
    logger.configure(dir=str(tmp_path / "log"), format_strs=[])
    model = ppo.learn(total_timesteps=2 * 4 * 32, **PPO)
    path = str(tmp_path / "m.pt")
    model.save(path)
    tree = torch.load(path, weights_only=True)
    assert set(tree) == {"model_params", "norm_ob_rms", "norm_ret_rms"}
    assert "logstd" in tree["model_params"]
    fresh = ppo.learn(total_timesteps=0, load_path=path, **dict(PPO, seed=1))
    for k, v in model.policy.module.state_dict().items():
        assert torch.equal(fresh.policy.module.state_dict()[k], v), k
    saved, loaded = model._normalize_state(), fresh._normalize_state()
    for name in ("ob_rms", "ret_rms"):
        for field in ("mean", "var", "count"):
            assert torch.equal(getattr(getattr(loaded, name), field),
                               getattr(getattr(saved, name), field)), (name, field)
    assert float(saved.ob_rms.count) > 4 * 32 * 2

    raw = ppo.learn(total_timesteps=4 * 32, **dict(PPO, env_kwargs=None))
    assert raw._normalize_state() is None
    raw.save(str(tmp_path / "raw.pt"))
    assert set(torch.load(str(tmp_path / "raw.pt"), weights_only=True)) == {"model_params"}
    raw.load(path)
    assert raw._normalize_state() is None
    assert torch.equal(raw.policy.module.logstd, model.policy.module.logstd)


def test_evaluate_seeds_the_trained_statistics_like_jax():
    """``evaluate`` of a Gaussian mlp policy on 4 normalized Pendulum envs for 210
    deterministic steps, its VecNormalize started from trained statistics (so the reset
    obs is normalized by them): the mean return to rtol 1e-4, the mean length and the
    episode count equal to the JAX ``evaluate``'s, and unlike a run from fresh
    statistics."""
    n, nsteps = 4, 210
    rng = np.random.RandomState(2)
    mean, var = rng.randn(3).astype(np.float32), rng.uniform(0.5, 2, 3).astype(np.float32)
    rmean, rvar = np.float32(-3.0), np.float32(4.0)
    params = mlp_policy_params(4, 3, 1, num_hidden=16)
    params["params"]["logstd"] = np.array([[-0.2]], np.float32)

    jvenv = jax_build_env("Pendulum-v1", 1, normalize=True)
    jns = jax_find_normalize_state(jvenv.reset(jax.random.PRNGKey(0))[1])
    jns = jns.replace(ob_rms=JaxRMS(jnp.asarray(mean), jnp.asarray(var), jnp.float32(500.0)),
                      ret_rms=JaxRMS(jnp.asarray(rmean), jnp.asarray(rvar), jnp.float32(500.0)))
    jpol = jax_build_policy(jvenv.observation_space, jvenv.action_space, "mlp", num_hidden=16)
    jplay = jax_build_env("Pendulum-v1", n, normalize=True)
    key = jax.random.PRNGKey(9)
    want = jax_evaluate(JaxModel(jpol, types.SimpleNamespace(params=params, env_state=jns)),
                        jplay, key, nsteps=nsteps, deterministic=True)

    base = jplay.venv.venv.env
    draws = ReplayDraws()
    push_reset(draws, base, key, n)
    k = key
    for _ in range(nsteps):
        k, _, kstep = jax.random.split(k, 3)
        push_env_step(draws, base, kstep, n)
    play = build_env("Pendulum-v1", n, device="cpu", normalize=True)
    assert isinstance(play, VecNormalize)
    tpol = build_policy(play.observation_space, play.action_space, "mlp", device="cpu",
                        num_hidden=16)
    tpol.module.load_state_dict(convert.policy_state_dict(params))
    count = torch.tensor(500.0)
    tns = NormalizeState(None, RunningMeanStd(torch.from_numpy(mean), torch.from_numpy(var), count),
                         RunningMeanStd(torch.tensor(rmean), torch.tensor(rvar), count), None)
    got = evaluate(Model(tpol, types.SimpleNamespace(env_state=tns)), play, draws, nsteps=nsteps)
    assert not draws.queue
    assert got[1:] == want[1:] and got[2] == 4
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    fresh = jax_evaluate(JaxModel(jpol, types.SimpleNamespace(params=params)),
                         jax_build_env("Pendulum-v1", n, normalize=True), key, nsteps=nsteps)
    assert abs(fresh[0] - want[0]) > 1.0


def _walk_equal(a, b, where, leaves):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _walk_equal(a[k], b[k], f"{where}.{k}", leaves)
    elif isinstance(a, list):
        for i, (u, v) in enumerate(zip(a, b)):
            _walk_equal(u, v, f"{where}[{i}]", leaves)
    elif isinstance(a, torch.Tensor):
        leaves.append(where)
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_ppo_resume_with_vec_normalize_is_bitwise(tmp_path):
    """3 updates on normalized Pendulum with a checkpoint at each; a run resumed from
    update 2's checkpoint ends with the uninterrupted run's params, Adam moments,
    generator state and env state, the running statistics and discounted returns
    included, bit for bit."""
    def run_ppo(logdir, resume_from=None):
        if resume_from is not None:
            os.makedirs(os.path.join(logdir, "checkpoints"))
            shutil.copy(resume_from, os.path.join(logdir, "checkpoints", "00002"))
        logger.configure(dir=str(logdir), format_strs=[])
        model = ppo.learn(total_timesteps=3 * 4 * 32, save_interval=1, **PPO)
        logger.reset()
        return model

    full = run_ppo(tmp_path / "full")
    resumed = run_ppo(tmp_path / "resumed", str(tmp_path / "full" / "checkpoints" / "00002"))
    assert resumed.state.update_idx == full.state.update_idx == 3
    leaves = []
    _walk_equal(ckpt.to_tree(full._train_tree()), ckpt.to_tree(resumed._train_tree()),
                "train state", leaves)
    for leaf in ("ob_rms.count", "ret_rms.var", "ret", "inner.stats.ep_return"):
        assert f"train state.state.env_state.{leaf}" in leaves, leaf
    assert "train state.params.logstd" in leaves


def _play_line(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith("episode_rew mean=")]
    assert len(lines) == 1, out
    return lines[0]


def test_run_round_trip_with_reward_scale_and_normalize(tmp_path, capsys, monkeypatch):
    """``run.main`` on Pendulum-v1 with ``--reward_scale=0.1`` and
    ``--env_kwargs="{'normalize': True}"``: train, save and play; then ``--load_path``
    of that file with ``--num_timesteps=0 --play`` prints the same play report, with
    the params and statistics bit for bit. The flag reaches ``build_env`` as
    ``reward_scale``."""
    path = str(tmp_path / "m.pt")
    base = ["--alg=ppo2", "--env=Pendulum-v1", "--env_kwargs={'normalize': True}",
            "--device=cpu", "--num_env=4", "--nsteps=32", "--num_hidden=16", "--play"]
    capsys.readouterr()
    trained = run.main(base + ["--num_timesteps=256", "--reward_scale=0.1", f"--save_path={path}",
                               f"--log_path={tmp_path / 'a'}"])
    report = _play_line(capsys.readouterr().out)
    loaded = run.main(base + ["--num_timesteps=0", f"--load_path={path}",
                              f"--log_path={tmp_path / 'b'}"])
    assert _play_line(capsys.readouterr().out) == report
    a, b = ckpt.to_tree(trained._normalize_state()), ckpt.to_tree(loaded._normalize_state())
    for name in ("ob_rms", "ret_rms"):
        for field in ("mean", "var", "count"):
            assert torch.equal(a[name][field], b[name][field]), (name, field)
    for k, v in trained.policy.module.state_dict().items():
        assert torch.equal(loaded.policy.module.state_dict()[k], v), k

    seen = {}

    def fake_learn(**kwargs):
        seen.update(kwargs)
        return types.SimpleNamespace(save=None)

    monkeypatch.setattr(algos, "get_learn_function", lambda alg: fake_learn)
    run.main(["--alg=ppo2", "--env=Pendulum-v1", "--reward_scale=0.1", "--device=cpu",
              "--env_kwargs={'normalize': True}", f"--log_path={tmp_path / 'c'}"])
    assert seen["env_kwargs"] == {"normalize": True, "reward_scale": 0.1}
    venv = build_env("Pendulum-v1", 2, device="cpu", **seen["env_kwargs"])
    assert isinstance(venv, VecNormalize) and isinstance(venv.venv, VecRewardScale)
    assert venv.venv.scale == 0.1 and isinstance(venv.venv.venv, VecMonitor)
