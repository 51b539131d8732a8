"""The port's fixture envs (the identity envs, FixedSequence and ImageFixedSequence)
against the JAX package's, on the CPU, bit for bit: the same draws (the identity envs
draw a new target at every step, FixedSequence nothing) give the same obs, rewards,
dones, states and episode counts, across episode ends and auto-resets. One exception:
BoxIdentity's episode returns agree to rtol 1e-6 (an ulp), though its rewards are equal
at every step: XLA's compiled step rounds their sum otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ReplayDraws, port_vec_env, push_env_step, push_reset

from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.envs.registry import make_env as jax_make_env
from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu_torch.algos.common import build_env
from baselines_tpu_torch.envs.registry import make_env
from baselines_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete
from baselines_tpu_torch.envs.testing.fixed_sequence import FixedSequenceState
from baselines_tpu_torch.envs.testing.identity import IdentityState
from baselines_tpu_torch.envs.vec import VecMonitor

IDS = ["DiscreteIdentity-v0", "BoxIdentity-v0", "MultiDiscreteIdentity-v0",
       "ImageIdentity-v0", "ImageIdentity36-v0", "FixedSequence-v0", "ImageFixedSequence-v0"]


def _same_space(mine, theirs) -> None:
    assert type(mine).__name__ == type(theirs).__name__
    assert mine.shape == theirs.shape and mine.dtype == theirs.dtype
    if isinstance(mine, Box):
        np.testing.assert_array_equal(mine.low, theirs.low)
        np.testing.assert_array_equal(mine.high, theirs.high)
    elif isinstance(mine, Discrete):
        assert mine.n == theirs.n
    elif isinstance(mine, MultiDiscrete):
        np.testing.assert_array_equal(mine.nvec, theirs.nvec)


def _actions(space, rng, n: int, target):
    """Half the envs act on the current target (the reward's other outcome), the rest
    at random."""
    if isinstance(space, Box):
        a = rng.uniform(-1, 1, (n,) + space.shape).astype(np.float32)
    elif isinstance(space, MultiDiscrete):
        a = np.stack([rng.randint(0, k, n) for k in space.nvec], axis=-1).astype(np.int32)
    else:
        a = rng.randint(0, space.n, n).astype(np.int32)
    if target is not None:
        a[: n // 2] = target[: n // 2]
    return a


@pytest.mark.parametrize("env_id", IDS)
def test_fixture_env_rollout_matches_jax_bit_for_bit(env_id):
    """12 envs for 14 steps behind VecMonitor, from the JAX draws, each env's step
    counter set after the reset to 1-10 steps before its episode's end (100 steps; 4
    for ImageFixedSequence, from 0-3 steps in): obs, terminal obs, rewards, dones, the
    state and the episode counts equal bit for bit; the spaces are the JAX env's."""
    n, steps = 12, 14
    env, jenv = make_env(env_id), jax_make_env(env_id)
    _same_space(env.observation_space, jenv.observation_space)
    _same_space(env.action_space, jenv.action_space)
    jvenv = jax_build_env(env_id, n)
    tvenv = build_env(env_id, n, device="cpu")
    base = jvenv.venv.env
    rng = np.random.RandomState(7)
    key, kreset = jax.random.split(jax.random.PRNGKey(3))
    draws = ReplayDraws()
    push_reset(draws, base, kreset, n)
    jobs, jstate = jvenv.reset(kreset)
    tobs, tstate = tvenv.reset(draws)
    limit = env.episode_len
    t0 = (np.arange(n) % min(10, limit) + max(limit - 10, 0)).astype(np.int32)
    jstate = jstate.replace(inner=jstate.inner.replace(t=jnp.asarray(t0)))
    tstate = dataclasses.replace(tstate, inner=dataclasses.replace(
        tstate.inner, t=torch.from_numpy(t0)))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert tobs.dtype == torch.from_numpy(np.array(jobs)).dtype
    jstep = jax.jit(jvenv.step)
    rewarded = 0.0
    for _ in range(steps):
        key, kstep = jax.random.split(key)
        inner = port_vec_env(tvenv)
        target = tstate.inner.target.numpy() if isinstance(tstate.inner, IdentityState) else None
        actions = _actions(inner.action_space, rng, n, target)
        push_env_step(draws, base, kstep, n)
        jobs, jstate, jrew, jdone, jinfo = jstep(kstep, jstate, jnp.asarray(actions))
        tobs, tstate, trew, tdone, tinfo = tvenv.step(draws, tstate, torch.from_numpy(actions))
        for got, want in ((tobs, jobs), (tinfo["terminal_obs"], jinfo["terminal_obs"]),
                          (trew, jrew), (tdone, jdone)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        rewarded += float(trew.sum())
    assert not draws.queue
    if isinstance(tstate.inner, IdentityState):
        np.testing.assert_array_equal(tstate.inner.target.numpy(), np.asarray(jstate.inner.target))
        assert rewarded != 0
    else:
        assert isinstance(tstate.inner, FixedSequenceState)
    np.testing.assert_array_equal(tstate.inner.t.numpy(), np.asarray(jstate.inner.t))
    js, ts = JaxVecMonitor.get_stats(jstate), VecMonitor.get_stats(tstate)
    assert int(ts.episodes) == int(js.episodes) >= n
    if env_id == "BoxIdentity-v0":
        np.testing.assert_allclose(ts.ret_buffer.numpy(), np.asarray(js.ret_buffer), rtol=1e-6)
    else:
        np.testing.assert_array_equal(ts.ret_buffer.numpy(), np.asarray(js.ret_buffer))
