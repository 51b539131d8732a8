"""The port's native C++ env engine (baselines_tpu_torch/native) on the CPU: bit for bit
against the JAX package's engine (baselines_tpu.native) on every id it serves, within
1e-4 of the port's device envs (as tests/test_native_env.py holds the JAX engine
against JAX physics), auto-reset, the time limit and reseeding, where it is built, and
that a build that fails raises."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from baselines_tpu import native as jax_native
from baselines_tpu_torch import native
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.envs.registry import make_env
from baselines_tpu_torch.envs.spaces import Discrete

ROOT = Path(__file__).resolve().parent.parent


def _actions(venv, n_steps: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    n = venv.num_envs
    if isinstance(venv.action_space, Discrete):
        return rng.randint(0, venv.action_space.n, size=(n_steps, n)).astype(np.float32)
    return rng.uniform(-1.0, 1.0, size=(n_steps, n, 1)).astype(np.float32)


def _terminal(obs, done, infos):
    """The pre-reset observations: the terminal one where an env was done."""
    out = obs.copy()
    for i in np.flatnonzero(done):
        out[i] = infos[i]["terminal_observation"]
    return out


@pytest.mark.parametrize("env_id", native.NATIVE_ENV_IDS)
def test_native_matches_jax_engine_bit_for_bit(env_id):
    """The same seeds and actions, stepped through auto-resets and past the time limit
    in both engines (8 envs, the env's step limit and 5 more steps): obs, rewards, dones,
    terminal obs and the physics state equal bit for bit, with the step_async/step_wait
    split on the port's side every other step."""
    n = 8
    ours, theirs = native.NativeVecEnv(env_id, n, seed=3), jax_native.NativeVecEnv(env_id, n, seed=3)
    steps = ours.max_steps + 5
    try:
        np.testing.assert_array_equal(ours.reset(seed=17), theirs.reset(seed=17))
        np.testing.assert_array_equal(ours.get_state(), theirs.get_state())
        n_done = 0
        for t, a in enumerate(_actions(ours, steps)):
            if t % 2:
                ours.step_async(a)
                o1, r1, d1, i1 = ours.step_wait()
            else:
                o1, r1, d1, i1 = ours.step(a)
            o2, r2, d2, i2 = theirs.step(a)
            np.testing.assert_array_equal(o1, o2)
            np.testing.assert_array_equal(r1, r2)
            np.testing.assert_array_equal(d1, d2)
            np.testing.assert_array_equal(_terminal(o1, d1, i1), _terminal(o2, d2, i2))
            assert [sorted(i) for i in i1] == [sorted(i) for i in i2]
            n_done += int(d1.sum())
        np.testing.assert_array_equal(ours.get_state(), theirs.get_state())
        assert n_done > 0
        assert ours.observation_space.shape == theirs.observation_space.shape
        assert type(ours.action_space).__name__ == type(theirs.action_space).__name__
    finally:
        ours.close()
        theirs.close()


def _device_rollout(env_id, phys, actions):
    """The port's device env (without its time limit) from the physics state ``phys``
    (num_envs, state_dim) f64 through ``actions``: per-step obs and rewards, and dones."""
    env = make_env(env_id).unwrapped
    draws = Draws(0, "cpu")
    _, state = env.reset(draws, phys.shape[0], torch.device("cpu"))
    cols, fields = 0, {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        width = int(np.prod(x.shape[1:]))
        vals = phys[:, cols:cols + width].astype(np.float32).reshape(x.shape)
        fields[f.name] = torch.from_numpy(vals).to(x.dtype)
        cols += width
    state = dataclasses.replace(state, **fields)
    discrete = isinstance(env.action_space, Discrete)
    obs_l, rew_l, done_l = [], [], []
    for a in actions:
        act = torch.from_numpy(a).long() if discrete else torch.from_numpy(a)
        obs, state, rew, done, _ = env.step(draws, state, act)
        obs_l.append(obs.numpy())
        rew_l.append(rew.numpy())
        done_l.append(done.numpy())
    return np.stack(obs_l), np.stack(rew_l), np.stack(done_l)


@pytest.mark.parametrize("env_id,n_steps", [("CartPole-v1", 30), ("Pendulum-v1", 50),
                                            ("MountainCar-v0", 50),
                                            ("MountainCarContinuous-v0", 50),
                                            ("Acrobot-v1", 40)])
def test_native_matches_device_env(env_id, n_steps):
    """Each env's obs and rewards within 1e-4 of the port's device env from the same
    physics state, up to its first termination (where the engine auto-resets)."""
    venv = native.NativeVecEnv(env_id, 3, seed=11)
    venv.reset(seed=11)
    phys0 = venv.get_state()
    actions = _actions(venv, n_steps)
    obs_n, rew_n, done_n = [], [], []
    for a in actions:
        o, r, d, infos = venv.step(a)
        obs_n.append(_terminal(o, d, infos))
        rew_n.append(r)
        done_n.append(d)
    venv.close()
    obs_n, rew_n, done_n = np.stack(obs_n), np.stack(rew_n), np.stack(done_n)
    obs_d, rew_d, done_d = _device_rollout(env_id, phys0, actions)
    for i in range(3):
        first = np.flatnonzero(done_n[:, i])
        stop = int(first[0]) + 1 if len(first) else n_steps
        np.testing.assert_allclose(obs_n[:stop, i], obs_d[:stop, i], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(rew_n[:stop, i], rew_d[:stop, i], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(done_n[:stop - 1, i], done_d[:stop - 1, i])


def test_native_autoreset_timelimit_and_reseed():
    """Pushing right ends CartPole-v0 episodes within its 200 steps, the done env's obs
    is a fresh reset obs and its terminal obs is in the info; the same seed gives the
    same obs, another seed others."""
    venv = native.NativeVecEnv("CartPole-v0", 2, seed=3)
    obs = venv.reset(seed=3)
    assert obs.shape == (2, 4) and np.all(np.abs(obs) <= 0.05)
    for steps in range(1, 301):
        obs, _, done, infos = venv.step(np.ones((2, 1), np.float32))
        if done.any():
            i = int(np.flatnonzero(done)[0])
            assert "terminal_observation" in infos[i]
            assert np.all(np.abs(obs[i]) <= 0.05)
            break
    assert steps <= 200
    venv.close()
    v = native.NativeVecEnv("Pendulum-v1", 4, seed=5)
    o1, o2, o3 = v.reset(seed=42), v.reset(seed=42), v.reset(seed=43)
    np.testing.assert_array_equal(o1, o2)
    assert not np.allclose(o1, o3)
    v.close()


def test_native_library_is_built_under_the_port():
    """The engine's library lies in baselines_tpu_torch/_build/, keyed by the source's
    hash, and its source is the JAX package's but for the global index of the pool's
    first env that ``btenv_create`` takes (its comment, its parameter and its use in the
    seeding)."""
    path = native.build()
    assert path.parent == ROOT / "baselines_tpu_torch" / "_build"
    assert path.name.startswith("envpool_") and path.exists()
    ours = native.SOURCE.read_text()
    for added in ("first_env + ", ", uint64_t first_env", ", first_env"):
        assert added in ours
        ours = ours.replace(added, "")
    lines = ours.splitlines(keepends=True)
    start = next(i for i, line in enumerate(lines) if "btenv_create(name" in line)
    del lines[start + 1:start + 4]  # the comment on the first env's index
    jax_source = (ROOT / "baselines_tpu" / "native" / "csrc" / "envpool.cpp").read_text()
    assert "".join(lines) == jax_source


def test_native_id_raises_when_the_build_fails(tmp_path, monkeypatch):
    """With the compiler out of reach and nothing built, a native: id raises and names
    the compiler's error; build_env does not fall back to the device env."""
    from baselines_tpu_torch.algos.common import build_env

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        build_env("native:CartPole-v1", 2, device="cpu")
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.NativeVecEnv("CartPole-v1", 2)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "CXX", "g++")
    with pytest.raises(RuntimeError, match="failed to build"):
        native.NativeVecEnv("CartPole-v1", 2)
