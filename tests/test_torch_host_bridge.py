"""The port's host env bridge (baselines_tpu_torch/envs/gym_bridge.py and
callback_env.py) on the CPU: its Dummy, Subproc and Shmem pools against each other and
against the JAX package's on gymnasium CartPole-v1 with the same seeds and actions, bit
for bit; its CallbackVecEnv against the JAX package's over the same pools (obs,
rewards, dones, terminal obs and info keys, bit for bit, the JAX side's reset seed fed
to the port as its draw); the f64 -> f32 downcast on MuJoCo's HalfCheetah-v4; the
space conversion with dict spaces."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import ReplayDraws

gym = pytest.importorskip("gymnasium")

from baselines_tpu.envs.callback_env import CallbackVecEnv as JaxCallbackVecEnv  # noqa: E402
from baselines_tpu.envs.gym_bridge import HostDummyVecEnv as JaxDummy  # noqa: E402
from baselines_tpu_torch.envs import gym_bridge  # noqa: E402
from baselines_tpu_torch.envs.callback_env import CallbackVecEnv  # noqa: E402
from baselines_tpu_torch.envs.spaces import Box, DictSpace, Discrete  # noqa: E402

N, STEPS = 4, 60


def _cartpole():
    return gym.make("CartPole-v1")


def _short_cartpole():
    """CartPole cut at 20 steps, so that random play truncates and the infos carry
    ``TimeLimit.truncated``."""
    return gym.make("CartPole-v1", max_episode_steps=20)


def _actions(steps=STEPS, n=N):
    return np.random.RandomState(0).randint(0, 2, size=(steps, n))


def _run(venv, seed=7):
    """Reset with ``seed``, then STEPS random actions, half of them through
    step_async/step_wait: the stacked obs (reset included), rewards, dones and the
    terminal obs of the infos."""
    obs = venv.reset(seed)
    all_obs, rews, dones, terms = [obs], [], [], []
    for t, a in enumerate(_actions(n=venv.num_envs)):
        if t % 2:
            venv.step_async(a)
            obs, rew, done, infos = venv.step_wait()
        else:
            obs, rew, done, infos = venv.step(a)
        all_obs.append(obs)
        rews.append(rew)
        dones.append(done)
        terms.append([np.asarray(i["terminal_observation"]) if d else None
                      for i, d in zip(infos, done)])
        assert all(("episode" in i) == d for i, d in zip(infos, done))
    venv.close()
    return np.stack(all_obs), np.stack(rews), np.stack(dones), terms


@pytest.fixture(scope="module")
def reference():
    """The JAX package's Dummy pool on the same seed and actions."""
    return _run(JaxDummy([_cartpole] * N))


@pytest.mark.parametrize("make", [
    lambda: gym_bridge.HostDummyVecEnv([_cartpole] * N),
    lambda: gym_bridge.HostSubprocVecEnv([_cartpole] * N),
    lambda: gym_bridge.HostSubprocVecEnv([_cartpole] * N, in_series=2),
    lambda: gym_bridge.HostShmemVecEnv([_cartpole] * N),
], ids=["dummy", "subproc", "subproc_in_series_2", "shmem"])
def test_pool_matches_jax_dummy_pool(make, reference):
    """Every pool of the port steps as the JAX package's Dummy pool, bit for bit: obs,
    rewards, dones and terminal obs, with the Monitor's ``episode`` on each done."""
    obs, rews, dones, terms = _run(make())
    robs, rrews, rdones, rterms = reference
    np.testing.assert_array_equal(obs, robs)
    np.testing.assert_array_equal(rews, rrews)
    np.testing.assert_array_equal(dones, rdones)
    assert dones.sum() > 0
    for row, rrow in zip(terms, rterms):
        for a, b in zip(row, rrow):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pool", ["dummy", "subproc"])
def test_callback_env_matches_jax(pool):
    """CallbackVecEnv's reset and steps against the JAX package's CallbackVecEnv over
    the same kind of pool: the JAX reset seed (a randint of the key) is the port's draw;
    obs, rewards, dones, terminal obs and the ``TimeLimit.truncated`` info key as f32,
    bit for bit, over truncated and terminated episodes."""
    from baselines_tpu.envs.gym_bridge import HostSubprocVecEnv as JaxSubproc

    make_ours = {"dummy": gym_bridge.HostDummyVecEnv,
                 "subproc": gym_bridge.HostSubprocVecEnv}[pool]
    make_theirs = {"dummy": JaxDummy, "subproc": JaxSubproc}[pool]
    keys = ("TimeLimit.truncated",)
    ours = CallbackVecEnv(make_ours([_short_cartpole] * N), info_keys=keys, device="cpu")
    theirs = JaxCallbackVecEnv(make_theirs([_short_cartpole] * N), info_keys=keys)
    try:
        key = jax.random.PRNGKey(3)
        jobs, jstate = theirs.reset(key)
        draws = ReplayDraws()
        draws.push("randint", jax.random.randint(key, (), 0, 2**31 - 1))
        tobs, tstate = ours.reset(draws)
        assert not draws.queue and tobs.dtype == torch.float32
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        truncated = terminated = 0
        for a in _actions(80):
            jout = theirs.step(key, jstate, jnp.asarray(a, jnp.int32))
            tout = ours.step(None, tstate, torch.from_numpy(a))
            (jobs, jstate, jrew, jdone, jinfo), (tobs, tstate, trew, tdone, tinfo) = jout, tout
            np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
            np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
            np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
            assert sorted(tinfo) == sorted(jinfo)
            for k in jinfo:
                assert tinfo[k].numpy().dtype == np.asarray(jinfo[k]).dtype
                np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]))
            assert tstate == int(jstate)
            truncated += int(tinfo["TimeLimit.truncated"].sum())
            terminated += int(tdone.sum()) - int(tinfo["TimeLimit.truncated"].sum())
        assert truncated > 0 and terminated > 0
    finally:
        ours.close()
        theirs.close()


def test_callback_env_downcasts_mujoco_obs():
    """HalfCheetah-v4's f64 observations come back as f32, its space f32 too, equal to
    the JAX package's cast; the f32 actions reach the env."""
    pytest.importorskip("mujoco")

    def cheetah():
        return gym.make("HalfCheetah-v4")

    ours = CallbackVecEnv(gym_bridge.HostDummyVecEnv([cheetah] * 2), device="cpu")
    theirs = JaxCallbackVecEnv(JaxDummy([cheetah] * 2))
    try:
        assert ours.host.observation_space.dtype == np.float64
        assert ours.observation_space.dtype == np.float32
        assert ours.observation_space.shape == (17,)
        key = jax.random.PRNGKey(0)
        jobs, _ = theirs.reset(key)
        draws = ReplayDraws()
        draws.push("randint", jax.random.randint(key, (), 0, 2**31 - 1))
        tobs, state = ours.reset(draws)
        assert tobs.dtype == torch.float32
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        a = np.random.RandomState(1).uniform(-1, 1, (2, 6)).astype(np.float32)
        jobs, _, jrew, _, _ = theirs.step(key, 0, jnp.asarray(a))
        tobs, state, trew, _, _ = ours.step(None, state, torch.from_numpy(a))
        assert tobs.dtype == torch.float32 and state == 1
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    finally:
        ours.close()
        theirs.close()


def test_convert_space_and_stack_obs():
    """gymnasium's Discrete, Box and Dict spaces as the port's, and dict observations
    stacked key by key."""
    d = gym_bridge.convert_space(gym.spaces.Dict({
        "observation": gym.spaces.Box(-1.0, 1.0, (3,), np.float64),
        "desired_goal": gym.spaces.Box(-2.0, 2.0, (2,), np.float32)}))
    assert isinstance(d, DictSpace) and isinstance(d["observation"], Box)
    assert d["observation"].shape == (3,) and d["observation"].dtype == np.float64
    np.testing.assert_array_equal(d["desired_goal"].high, np.full((2,), 2.0, np.float32))
    assert gym_bridge.convert_space(gym.spaces.Discrete(5)) == Discrete(5)
    stacked = gym_bridge.stack_obs([{"a": np.zeros(2), "b": np.ones(1)}] * 3)
    assert stacked["a"].shape == (3, 2) and stacked["b"].shape == (3, 1)
