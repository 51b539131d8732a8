"""The port's classic envs (Pendulum-v1, MountainCar-v0, MountainCarContinuous-v0,
Acrobot-v1) against the JAX package's, on the CPU, with states made by numpy and the JAX
envs' own reset draws.

Tolerances: ``torch.sin``/``torch.cos`` differ from XLA's by an ulp on some inputs, so a
step from the same state agrees to rtol 1e-6 / atol 2e-6 (Acrobot's RK4 step carries
those ulps through four derivative evaluations: at speeds up to 4 rad/s the two sides
differ by under 1e-6), not bit for bit; over a rollout, where the ulps carry on, to
torch_parity's rtol 1e-4 / atol 1e-6 (Acrobot's to atol 2e-5: its RK4 step carries the
ulps of one step into the next most, 4.8e-6 after 32 steps), and Pendulum's continuous
rewards to the same.
Done flags are compared exactly only where no state came within 1e-5 of a threshold
(MountainCar's goal and left wall, Acrobot's height test), which each test asserts.
Resets take the JAX draws and give the same state bit for bit; Acrobot's wrapped angles
are compared on the circle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ROLLOUT_ATOL, ROLLOUT_RTOL, THRESHOLD_MARGIN, RecordStates,
                          ReplayDraws, port_vec_env, push_env_step, push_reset)

from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.envs.classic.acrobot import AcrobotState as JaxAcrobotState
from baselines_tpu.envs.classic.mountain_car import CarState as JaxCarState
from baselines_tpu.envs.classic.pendulum import PendulumState as JaxPendulumState
from baselines_tpu.envs.registry import make_env as jax_make_env
from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu_torch.algos.common import build_env
from baselines_tpu_torch.envs.base import ClipActions, TimeLimit, TimeLimitState
from baselines_tpu_torch.envs.classic.acrobot import AcrobotState
from baselines_tpu_torch.envs.classic.mountain_car import CarState, MountainCar
from baselines_tpu_torch.envs.classic.pendulum import PendulumState
from baselines_tpu_torch.envs.registry import make_env
from baselines_tpu_torch.envs.spaces import Box
from baselines_tpu_torch.envs.vec import VecMonitor

RTOL, ATOL = 1e-6, 2e-6
ACROBOT_ROLLOUT_ATOL = 2e-5  # 32 steps of 16 envs differ by up to 4.8e-6
IDS = ["Pendulum-v1", "MountainCar-v0", "MountainCarContinuous-v0", "Acrobot-v1"]
LIMITS = {"Pendulum-v1": 200, "MountainCar-v0": 200, "MountainCarContinuous-v0": 999,
          "Acrobot-v1": 500}


def _car_margin(goal: float):
    def margin(obs: torch.Tensor) -> float:
        """The least distance of MountainCar observations from the goal, from the left
        wall (where the position is not on it), and from zero speed at the goal."""
        obs = obs.reshape(-1, 2).double()
        pos, vel = obs[:, 0], obs[:, 1]
        wall = (pos - MountainCar.MIN_POS).abs()
        wall = torch.where(pos == np.float32(MountainCar.MIN_POS), torch.inf, wall)
        at_goal = torch.where(pos >= goal - 1e-3, vel.abs(), torch.full_like(vel, torch.inf))
        return float(min((pos - goal).abs().min(), wall.min(), at_goal.min()))
    return margin


def _acrobot_margin(obs: torch.Tensor) -> float:
    """The least distance of Acrobot observations (cos t1, sin t1, cos t2, sin t2, ...)
    from the height test -cos(t1) - cos(t1 + t2) > 1."""
    o = obs.reshape(-1, 6).double()
    height = -o[:, 0] - (o[:, 0] * o[:, 2] - o[:, 1] * o[:, 3])
    return float((height - 1.0).abs().min())


MARGINS = {"Pendulum-v1": None, "MountainCar-v0": _car_margin(0.5),
           "MountainCarContinuous-v0": _car_margin(0.45), "Acrobot-v1": _acrobot_margin}


def _states(env_id: str, rng, n: int):
    """(JAX state, port state, actions) from numpy: Pendulum over two turns either way
    at any speed, torques past the clip; the cars over the whole track at any speed;
    Acrobot at any angles and speeds up to 4 rad/s."""
    if env_id == "Pendulum-v1":
        th = rng.uniform(-2 * np.pi, 2 * np.pi, n).astype(np.float32)
        thdot = rng.uniform(-8, 8, n).astype(np.float32)
        actions = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
        return (JaxPendulumState(jnp.asarray(th), jnp.asarray(thdot)),
                PendulumState(torch.from_numpy(th), torch.from_numpy(thdot)), actions)
    if env_id.startswith("MountainCar"):
        pos = rng.uniform(-1.2, 0.6, n).astype(np.float32)
        vel = rng.uniform(-0.07, 0.07, n).astype(np.float32)
        actions = (rng.randint(0, 3, n).astype(np.int32) if env_id == "MountainCar-v0"
                   else rng.uniform(-1.5, 1.5, (n, 1)).astype(np.float32))
        return (JaxCarState(jnp.asarray(pos), jnp.asarray(vel)),
                CarState(torch.from_numpy(pos), torch.from_numpy(vel)), actions)
    s = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-np.pi, np.pi, n),
                  rng.uniform(-4, 4, n), rng.uniform(-4, 4, n)], axis=1).astype(np.float32)
    return (JaxAcrobotState(jnp.asarray(s)), AcrobotState(torch.from_numpy(s)),
            rng.randint(0, 3, n).astype(np.int32))


def _assert_states_close(env_id: str, got, want, rtol, atol) -> None:
    if env_id == "Acrobot-v1":
        g, w = got.s.numpy().astype(np.float64), np.asarray(want.s, np.float64)
        turn = np.angle(np.exp(1j * (g[:, :2] - w[:, :2])))  # wrapped angles, on the circle
        np.testing.assert_allclose(turn, 0.0, atol=atol)
        np.testing.assert_allclose(g[:, 2:], w[:, 2:], rtol=rtol, atol=atol)
        return
    for name in vars(got):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("env_id", IDS)
def test_classic_step_matches_jax(env_id):
    """One step of 4096 envs from the same numpy states and actions: obs and state to
    rtol 1e-6 / atol 2e-6, rewards to the same (exact where they are counts), dones
    equal with no state within 1e-5 of a threshold, and both outcomes exercised where
    the env terminates."""
    n = 4096
    jstate, tstate, actions = _states(env_id, np.random.RandomState(len(env_id)), n)
    jenv, tenv = jax_make_env(env_id).unwrapped, make_env(env_id).unwrapped
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jobs, jst, jrew, jdone, _ = jax.jit(jax.vmap(jenv.step))(keys, jstate, jnp.asarray(actions))
    tobs, tst, trew, tdone, info = tenv.step(None, tstate, torch.from_numpy(actions))
    assert tobs.dtype == torch.float32 and tobs.shape == (n,) + jenv.observation_space.shape
    assert info == {} and trew.dtype == torch.float32 and tdone.dtype == torch.bool
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=RTOL, atol=ATOL)
    _assert_states_close(env_id, tst, jst, RTOL, ATOL)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=RTOL, atol=ATOL)
    if MARGINS[env_id] is not None:
        assert MARGINS[env_id](tobs) > THRESHOLD_MARGIN
        assert 0 < int(tdone.sum()) < n
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))


@pytest.mark.parametrize("env_id", IDS)
def test_classic_reset_takes_the_jax_draws(env_id):
    """The reset state is the JAX env's bit for bit from its own draws, the obs too
    where no sin/cos is taken (to rtol 1e-6 / atol 2e-6 where one is), the TimeLimit
    counter starts at zero, and the spaces are the JAX env's."""
    env, jenv = make_env(env_id), jax_make_env(env_id)
    for mine, theirs in ((env.observation_space, jenv.observation_space),
                         (env.action_space, jenv.action_space)):
        assert type(mine).__name__ == type(theirs).__name__ and mine.shape == theirs.shape
        if isinstance(mine, Box):
            np.testing.assert_array_equal(mine.low, theirs.low)
            np.testing.assert_array_equal(mine.high, theirs.high)
        else:
            assert mine.n == theirs.n
    n, key = 64, jax.random.PRNGKey(5)
    draws = ReplayDraws()
    push_reset(draws, jenv, key, n)
    jobs, (jinner, jt) = jax.vmap(jenv.reset)(jax.random.split(key, n))
    tobs, tstate = env.reset(draws, n, "cpu")
    assert not draws.queue
    assert isinstance(tstate, TimeLimitState) and not tstate.t.any()
    for name in vars(tstate.inner):
        np.testing.assert_array_equal(getattr(tstate.inner, name).numpy(),
                                      np.asarray(getattr(jinner, name)), err_msg=name)
    if env_id.startswith("MountainCar"):
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    else:
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=RTOL, atol=ATOL)


def _actions(env_id: str, rng, n: int, first: bool):
    """Random actions; Box actions up to 1.5 times the bound, and a NaN in the first
    step's first env, which ClipActions turns into 0."""
    space = make_env(env_id).action_space
    if not isinstance(space, Box):
        return rng.randint(0, space.n, n).astype(np.int32)
    a = rng.uniform(-1.5, 1.5, (n,) + space.shape).astype(np.float32) * space.high
    if first:
        a[0] = np.nan
    return a


@pytest.mark.parametrize("env_id", IDS)
def test_classic_vec_rollout_matches_jax(env_id):
    """32 steps of 16 envs through build_env's chain (ClipActions on Box actions,
    VecMonitor) from the JAX reset draws, random actions: obs and terminal obs to rtol
    1e-4 / atol 1e-6, rewards to the same (exact where they are counts), dones and the
    TimeLimit counters equal, and no state within 1e-5 of a threshold."""
    n = 16
    jvenv = jax_build_env(env_id, n)
    tvenv = build_env(env_id, n, device="cpu")
    assert isinstance(tvenv, VecMonitor) and isinstance(jvenv, JaxVecMonitor)
    assert isinstance(port_vec_env(tvenv).env, ClipActions) == isinstance(
        tvenv.action_space, Box)
    margin = MARGINS[env_id]
    recorder = RecordStates(port_vec_env(tvenv).env, margin=margin)
    port_vec_env(tvenv).env = recorder
    base = jvenv.venv.env
    rng = np.random.RandomState(3)
    key, kreset = jax.random.split(jax.random.PRNGKey(11))
    draws = ReplayDraws()
    push_reset(draws, base, kreset, n)
    jobs, jstate = jvenv.reset(kreset)
    tobs, tstate = tvenv.reset(draws)
    jstep = jax.jit(jvenv.step)
    rtol, atol = ROLLOUT_RTOL, (ACROBOT_ROLLOUT_ATOL if env_id == "Acrobot-v1" else ROLLOUT_ATOL)
    for i in range(32):
        key, kstep = jax.random.split(key)
        actions = _actions(env_id, rng, n, first=i == 0)
        push_env_step(draws, base, kstep, n)
        jobs, jstate, jrew, jdone, jinfo = jstep(kstep, jstate, jnp.asarray(actions))
        tobs, tstate, trew, tdone, tinfo = tvenv.step(draws, tstate, torch.from_numpy(actions))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=rtol, atol=atol)
        np.testing.assert_allclose(tinfo["terminal_obs"].numpy(),
                                   np.asarray(jinfo["terminal_obs"]), rtol=rtol, atol=atol)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=rtol, atol=atol)
        np.testing.assert_array_equal(tstate.inner.t.numpy(), np.asarray(jstate.inner[1]))
    assert not draws.queue
    if margin is not None:
        assert recorder.min_margin() > THRESHOLD_MARGIN
    js, ts = JaxVecMonitor.get_stats(jstate), VecMonitor.get_stats(tstate)
    assert int(ts.episodes) == int(js.episodes)
    np.testing.assert_allclose(ts.ep_return.numpy(), np.asarray(js.ep_return), rtol=ROLLOUT_RTOL)


class _Idle:
    """A stand-in env that never terminates, so the TimeLimit alone ends episodes."""

    def __init__(self, env):
        self.observation_space, self.action_space = env.observation_space, env.action_space

    def reset(self, draws, num_envs, device):
        return torch.zeros((num_envs,) + self.observation_space.shape), torch.zeros((num_envs,))

    def step(self, draws, state, action):
        return (torch.zeros((state.shape[0],) + self.observation_space.shape), state + 1,
                torch.ones_like(state), torch.zeros(state.shape, dtype=torch.bool), {})


@pytest.mark.parametrize("env_id", IDS)
def test_classic_time_limits(env_id):
    """The TimeLimits of registry.py (200, 200, 999, 500), the JAX envs' too;
    ``truncated`` is set on the step that reaches the limit and nowhere else."""
    limit = LIMITS[env_id]
    env = make_env(env_id)
    assert isinstance(env, TimeLimit) and env.max_episode_steps == limit
    assert jax_make_env(env_id).max_episode_steps == limit
    idle = TimeLimit(_Idle(env), limit)
    _, state = idle.reset(None, 3, "cpu")
    state = TimeLimitState(state.inner, torch.tensor([0, limit - 2, limit - 1], dtype=torch.int32))
    _, state, _, done, info = idle.step(None, state, None)
    np.testing.assert_array_equal(done.numpy(), [False, False, True])
    np.testing.assert_array_equal(info["truncated"].numpy(), [False, False, True])
    np.testing.assert_array_equal(state.t.numpy(), [1, limit - 1, limit])
