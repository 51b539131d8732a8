"""The port's envs against the JAX package's, on the CPU: AtariSim's step from an
injected state, the vector layer's auto-reset and episode accounting, and VecS2D's
packing, all bit for bit (integer dynamics and u8 frames leave no room for rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import ReplayDraws, push_env_step, push_reset

from baselines_tpu.envs.testing.atari_sim import AtariSim as JaxAtariSim
from baselines_tpu.envs.testing.atari_sim import AtariSimState as JaxAtariSimState
from baselines_tpu.envs.vec import VecJaxEnv, VecMonitor as JaxVecMonitor, VecS2D as JaxVecS2D
from baselines_tpu_torch.envs.testing.atari_sim import AtariSim, AtariSimState
from baselines_tpu_torch.envs.vec import VecMonitor, VecS2D, VecTorchEnv

N = 6


def _injected_state(rng, episode_len):
    """Sprites near every wall, both velocity signs, clocks just short of the end."""
    x = rng.randint(0, 84, (N, 2)).astype(np.int32)
    v = rng.randint(-3, 4, (N, 2)).astype(np.int32)
    t = rng.randint(episode_len - 3, episode_len, (N,)).astype(np.int32)
    return x, v, t


def test_atari_sim_step_bit_exact_from_injected_state():
    rng = np.random.RandomState(0)
    jenv, tenv = JaxAtariSim(episode_len=50), AtariSim(episode_len=50)
    x, v, t = _injected_state(rng, 50)
    jstate = JaxAtariSimState(jnp.asarray(x), jnp.asarray(v), jnp.asarray(t))
    tstate = AtariSimState(torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(t))
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jstep = jax.jit(jax.vmap(jenv.step))
    for _ in range(5):
        actions = rng.randint(0, 6, (N,)).astype(np.int32)
        jobs, jstate, jrew, jdone, _ = jstep(keys, jstate, jnp.asarray(actions))
        tobs, tstate, trew, tdone, _ = tenv.step(tstate, torch.from_numpy(actions))
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        for name in ("x", "v", "t"):
            np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                          np.asarray(getattr(jstate, name)))


def _chains(episode_len, s2d):
    jvenv = JaxVecMonitor(VecJaxEnv(JaxAtariSim(episode_len=episode_len), N))
    tvenv = VecMonitor(VecTorchEnv(AtariSim(episode_len=episode_len), N, "cpu"))
    if s2d:
        jvenv, tvenv = JaxVecS2D(jvenv, s2d), VecS2D(tvenv, s2d)
    return jvenv, tvenv


def test_vec_auto_reset_monitor_and_s2d_bit_exact():
    """Episodes of 4 steps end all through the run, so auto-reset, terminal_obs and the
    episode ring are exercised at every few steps, behind VecS2D's packing."""
    jvenv, tvenv = _chains(episode_len=4, s2d=4)
    base = jvenv.venv.venv.env
    rng = np.random.RandomState(1)
    key = jax.random.PRNGKey(3)
    key, kreset = jax.random.split(key)
    draws = ReplayDraws()
    push_reset(draws, base, kreset, N)
    jobs, jstate = jvenv.reset(kreset)
    tobs, tstate = tvenv.reset(draws)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert tobs.shape == (N, 21, 21, 64) and tobs.dtype == torch.uint8
    jstep = jax.jit(jvenv.step)
    n_done = 0
    for _ in range(11):
        key, kstep = jax.random.split(key)
        actions = rng.randint(0, 6, (N,)).astype(np.int32)
        push_env_step(draws, base, kstep, N)
        jobs, jstate, jrew, jdone, jinfo = jstep(kstep, jstate, jnp.asarray(actions))
        tobs, tstate, trew, tdone, tinfo = tvenv.step(draws, tstate, torch.from_numpy(actions))
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(tinfo["terminal_obs"].numpy(), np.asarray(jinfo["terminal_obs"]))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        n_done += int(np.asarray(jdone).sum())
        js, ts = JaxVecMonitor.get_stats(jstate), VecMonitor.get_stats(tstate)
        for name in ("ep_return", "ep_length", "ret_buffer", "len_buffer", "total_steps"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
        assert int(ts.episodes) == int(js.episodes)
        np.testing.assert_array_equal(ts.mean_return.numpy(), np.asarray(js.mean_return))
        np.testing.assert_array_equal(ts.mean_length.numpy(), np.asarray(js.mean_length))
    assert not draws.queue
    assert n_done >= 2 * N


def test_s2d_packing_bit_exact():
    rng = np.random.RandomState(2)
    frames = rng.randint(0, 256, (N, 84, 84, 4)).astype(np.uint8)
    jvenv, tvenv = _chains(episode_len=1000, s2d=4)
    want = np.asarray(jvenv._pack(jnp.asarray(frames)))
    got = tvenv._pack(torch.from_numpy(frames))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert tvenv.observation_space.shape == jvenv.observation_space.shape == (21, 21, 64)


def test_episode_ring_keeps_the_last_100_when_more_end_at_once():
    """More than 100 envs finishing in one step: the ring holds the last 100 in env
    order, as a sequential write leaves it."""
    from baselines_tpu_torch.envs.vec import EpisodeStats

    n = 130
    stats = EpisodeStats.create(n, "cpu")
    stats = stats.update(torch.zeros(n), torch.zeros(n, dtype=torch.bool))
    reward = torch.arange(n, dtype=torch.float32)
    stats = stats.update(reward, torch.ones(n, dtype=torch.bool))
    want = np.zeros(100, np.float32)
    for i in range(n):
        want[i % 100] = i
    np.testing.assert_array_equal(stats.ret_buffer.numpy(), want)
    assert int(stats.episodes) == n
    np.testing.assert_allclose(float(stats.mean_return), want.mean(), rtol=1e-6)
    np.testing.assert_array_equal(stats.len_buffer.numpy(), np.full(100, 2.0, np.float32))
