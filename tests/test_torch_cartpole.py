"""The port's CartPole (baselines_tpu_torch/envs/classic/cartpole.py) and TimeLimit
against the JAX package's, on the CPU, with states made by numpy and the JAX env's own
reset draws.

Tolerances: ``torch.sin``/``torch.cos`` differ from XLA's by an ulp on some inputs (and
XLA's compiled step rounds otherwise than its eager one), so one step from the same
state agrees to rtol 1e-6 / atol 1e-7, not bit for bit; after several steps, where
those ulps carry on, to torch_parity's rtol 1e-4 / atol 1e-6. A rollout compares its done
flags exactly only where no state came within 1e-5 of a termination threshold, which
each such test asserts, so that a flag flipped by rounding cannot hide. Integer state
(the TimeLimit counter, the episode ring's counts) is compared bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ROLLOUT_ATOL, ROLLOUT_RTOL, THRESHOLD_MARGIN, RecordStates,
                          ReplayDraws, push_env_step, push_reset, threshold_margin)

from baselines_tpu.envs.classic.cartpole import CartPole as JaxCartPole
from baselines_tpu.envs.classic.cartpole import CartPoleState as JaxCartPoleState
from baselines_tpu.envs.classic.cartpole import make_cartpole as jax_make_cartpole
from baselines_tpu.envs.vec import VecJaxEnv, VecMonitor as JaxVecMonitor
from baselines_tpu_torch.envs import registry
from baselines_tpu_torch.envs.base import TimeLimit, TimeLimitState
from baselines_tpu_torch.envs.classic.cartpole import CartPole, CartPoleState, make_cartpole
from baselines_tpu_torch.envs.vec import VecMonitor, VecTorchEnv

RTOL, ATOL = 1e-6, 1e-7
N = 64


def _states(rng, n, scale):
    """States spread over ``scale`` times the reset range, velocities ten times wider."""
    v = rng.uniform(-0.05, 0.05, (4, n)).astype(np.float32) * scale
    v[1] *= 10
    v[3] *= 10
    return v


@pytest.mark.parametrize("scale", [1, 4], ids=["reset_range", "wide"])
def test_cartpole_step_matches_jax(scale):
    """One step from the same states and actions: obs and state to rtol 1e-6 / atol
    1e-7, reward and done equal (no state within 1e-5 of a threshold)."""
    rng = np.random.RandomState(scale)
    v = _states(rng, 4096, scale)
    actions = rng.randint(0, 2, 4096).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    jobs, jst, jrew, jdone, _ = jax.jit(jax.vmap(JaxCartPole().step))(
        keys, JaxCartPoleState(*map(jnp.asarray, v)), jnp.asarray(actions))
    tobs, tst, trew, tdone, info = CartPole().step(
        None, CartPoleState(*map(torch.from_numpy, v)), torch.from_numpy(actions))
    assert tobs.shape == (4096, 4) and tobs.dtype == torch.float32 and info == {}
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=RTOL, atol=ATOL)
    for name in ("x", "x_dot", "theta", "theta_dot"):
        np.testing.assert_allclose(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    assert trew.dtype == torch.float32
    assert threshold_margin(tobs) > THRESHOLD_MARGIN
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    if scale > 1:
        assert 0 < int(tdone.sum()) < 4096  # both outcomes are exercised


def test_cartpole_reset_takes_the_jax_draws():
    """The reset's obs and state are the four uniforms the JAX env draws, bit for bit,
    and the TimeLimit counter starts at zero."""
    env = make_cartpole(1)
    jenv = jax_make_cartpole(1)
    key = jax.random.PRNGKey(5)
    draws = ReplayDraws()
    push_reset(draws, jenv, key, N)
    jobs, (jinner, jt) = jax.vmap(jenv.reset)(jax.random.split(key, N))
    tobs, tstate = env.reset(draws, N, "cpu")
    assert not draws.queue
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert isinstance(tstate, TimeLimitState) and tstate.t.dtype == torch.int32
    np.testing.assert_array_equal(tstate.t.numpy(), np.asarray(jt))
    for name in ("x", "x_dot", "theta", "theta_dot"):
        np.testing.assert_array_equal(getattr(tstate.inner, name).numpy(),
                                      np.asarray(getattr(jinner, name)))
    assert float(tobs.abs().max()) <= 0.05


class _Upright:
    """A stand-in env that never terminates, so the TimeLimit alone ends episodes."""

    observation_space = CartPole().observation_space
    action_space = CartPole().action_space

    def reset(self, draws, num_envs, device):
        return torch.zeros((num_envs, 4)), torch.zeros((num_envs,))

    def step(self, draws, state, action):
        return (torch.zeros((state.shape[0], 4)), state + 1, torch.ones_like(state),
                torch.zeros(state.shape, dtype=torch.bool), {})


@pytest.mark.parametrize("version,limit", [(0, 200), (1, 500)], ids=["v0", "v1"])
def test_time_limit_truncates_at_200_and_500(version, limit):
    """make_cartpole's limits; ``truncated`` set on the step that reaches the limit and
    not where the inner env terminated, with ``done | truncated`` returned, as the JAX
    TimeLimit does."""
    assert make_cartpole(version).max_episode_steps == limit
    assert jax_make_cartpole(version).max_episode_steps == limit
    env = TimeLimit(_Upright(), limit)
    _, state = env.reset(None, 3, "cpu")
    state = TimeLimitState(state.inner,
                           torch.tensor([0, limit - 2, limit - 1], dtype=torch.int32))
    _, state, _, done, info = env.step(None, state, torch.zeros(3, dtype=torch.int32))
    np.testing.assert_array_equal(done.numpy(), [False, False, True])
    np.testing.assert_array_equal(info["truncated"].numpy(), [False, False, True])
    np.testing.assert_array_equal(state.t.numpy(), [1, limit - 1, limit])
    # a terminal step at the limit is terminated, not truncated
    cart = make_cartpole(version)
    inner = CartPoleState(*(torch.tensor([v]) for v in (2.39, 1.0, 0.0, 0.0)))
    at_limit = TimeLimitState(inner, torch.tensor([limit - 1], dtype=torch.int32))
    _, _, _, done, info = cart.step(None, at_limit, torch.ones(1, dtype=torch.int32))
    assert bool(done[0]) and not bool(info["truncated"][0])


@pytest.mark.parametrize("version", [0, 1], ids=["v0", "v1"])
def test_vec_rollout_matches_jax(version):
    """24 steps of 16 envs behind VecMonitor from the JAX reset states, random actions:
    obs and terminal obs to rtol 1e-4 / atol 1e-6, rewards, dones, the TimeLimit
    counters and the episode counts equal, the episode ring to 1e-6. Episodes end and
    auto-reset inside the run, and no state comes within 1e-5 of a threshold."""
    n = 16
    jvenv = JaxVecMonitor(VecJaxEnv(jax_make_cartpole(version), n))
    recorder = RecordStates(make_cartpole(version))
    tvenv = VecMonitor(VecTorchEnv(recorder, n, "cpu"))
    base = jvenv.venv.env
    rng = np.random.RandomState(version)
    key, kreset = jax.random.split(jax.random.PRNGKey(11))
    draws = ReplayDraws()
    push_reset(draws, base, kreset, n)
    jobs, jstate = jvenv.reset(kreset)
    tobs, tstate = tvenv.reset(draws)
    jstep = jax.jit(jvenv.step)
    n_done = 0
    for _ in range(24):
        key, kstep = jax.random.split(key)
        actions = rng.randint(0, 2, n).astype(np.int32)
        push_env_step(draws, base, kstep, n)
        jobs, jstate, jrew, jdone, jinfo = jstep(kstep, jstate, jnp.asarray(actions))
        tobs, tstate, trew, tdone, tinfo = tvenv.step(draws, tstate, torch.from_numpy(actions))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tinfo["truncated"].numpy(), np.asarray(jinfo["truncated"]))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=ROLLOUT_RTOL,
                                   atol=ROLLOUT_ATOL)
        np.testing.assert_allclose(tinfo["terminal_obs"].numpy(),
                                   np.asarray(jinfo["terminal_obs"]), rtol=ROLLOUT_RTOL,
                                   atol=ROLLOUT_ATOL)
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tstate.inner.t.numpy(), np.asarray(jstate.inner[1]))
        n_done += int(np.asarray(jdone).sum())
    assert not draws.queue
    assert n_done >= 4
    assert recorder.min_margin() > THRESHOLD_MARGIN
    js, ts = JaxVecMonitor.get_stats(jstate), VecMonitor.get_stats(tstate)
    assert int(ts.episodes) == int(js.episodes) == n_done
    np.testing.assert_array_equal(ts.ep_length.numpy(), np.asarray(js.ep_length))
    np.testing.assert_allclose(ts.ret_buffer.numpy(), np.asarray(js.ret_buffer), rtol=1e-6)
    np.testing.assert_allclose(float(ts.mean_length), float(js.mean_length), rtol=1e-6)


def test_registry_types_and_unported_ids():
    """Every id has the JAX registry's env type; the port registers every device env of
    the JAX package but PointReach-v0, which raises NotImplementedError naming item 7, as
    host ids raise naming item 8."""
    from baselines_tpu.envs import registry as jax_registry

    for env_id in jax_registry.env_names() + ["HalfCheetah-v4", "PongNoFrameskip-v4",
                                              "FetchReach-v2", "native:CartPole-v1"]:
        assert registry.get_env_type(env_id) == jax_registry.get_env_type(env_id), env_id
    assert registry.is_torch_env("CartPole-v1") and not registry.is_torch_env("PointReach-v0")
    assert set(registry.env_names()) == set(jax_registry.env_names()) - {"PointReach-v0"}
    for env_id, item in (("PointReach-v0", "item 7"), ("Pendulum-v0", "item 8"),
                         ("HalfCheetah-v4", "item 8"),
                         ("native:CartPole-v1", "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            registry.make_env(env_id)
    for env_id in jax_registry.env_names():
        if not registry.is_torch_env(env_id):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                registry.make_env(env_id)
