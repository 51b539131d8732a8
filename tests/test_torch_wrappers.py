"""The port's env wrappers (ClipActions, RewardScale, ClipReward), vec wrappers
(VecFrameStack, VecRewardScale, VecNormalize) and running statistics against the JAX
package's, on the CPU.

Tolerances: the wrappers that move or scale values (ClipActions, RewardScale,
ClipReward, VecFrameStack, VecRewardScale) agree bit for bit. ``torch.var`` and
``jnp.var`` sum in other orders, so running statistics agree to rtol 1e-5 (their counts
bit for bit), and VecNormalize's normalized observations and rewards, which divide by
those statistics, to rtol 1e-4 / atol 1e-5 over Pendulum's steps (whose sin/cos differ
by an ulp besides)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ReplayDraws, push_env_step, push_reset

from baselines_tpu.core.running_stats import RunningMeanStd as JaxRMS
from baselines_tpu.core.running_stats import merge_branched as jax_merge_branched
from baselines_tpu.envs import base as jbase
from baselines_tpu.envs.classic.pendulum import make_pendulum as jax_make_pendulum
from baselines_tpu.envs.spaces import Box as JaxBox
from baselines_tpu.envs.testing.simple import SimpleDeterministicEnv as JaxSimple
from baselines_tpu.envs import vec as jvec
from baselines_tpu_torch.core.running_stats import RunningMeanStd, merge_branched
from baselines_tpu_torch.envs import base as tbase
from baselines_tpu_torch.envs import vec as tvec
from baselines_tpu_torch.envs.classic.pendulum import make_pendulum
from baselines_tpu_torch.envs.spaces import Box
from baselines_tpu_torch.envs.testing.simple import SimpleDeterministicEnv

STAT_RTOL = 1e-5


class _JaxEcho(jbase.JaxEnv):
    """Observes the action it was given; its reward is the action's sum."""

    observation_space = JaxBox(-10, 10, (3,))
    action_space = JaxBox(np.array([-1, -2, 0], np.float32), np.array([1, 2, 0.5], np.float32))

    def reset(self, key):
        return jnp.zeros((3,)), jnp.zeros(())

    def step(self, key, state, action):
        return action, state, jnp.sum(action), jnp.zeros((), bool), {}


class _Echo(tbase.TorchEnv):
    observation_space = Box(-10, 10, (3,))
    action_space = Box(np.array([-1, -2, 0], np.float32), np.array([1, 2, 0.5], np.float32))

    def reset(self, draws, num_envs, device):
        return torch.zeros((num_envs, 3)), torch.zeros((num_envs,))

    def step(self, draws, state, action):
        return action, state, action.sum(dim=-1), torch.zeros(state.shape, dtype=torch.bool), {}


@pytest.mark.parametrize("wrapper", ["ClipActions", "RewardScale", "ClipReward"])
def test_env_wrappers_match_jax(wrapper):
    """On actions with NaN, +-inf and values past either bound: ClipActions'
    nan_to_num and clip, RewardScale's product, ClipReward's sign (NaN where the reward
    is NaN), bit for bit."""
    a = np.random.RandomState(0).uniform(-4, 4, (16, 3)).astype(np.float32)
    a[0, 0], a[1, 1], a[2, 2], a[3] = np.nan, np.inf, -np.inf, 0.0
    args = (0.37,) if wrapper == "RewardScale" else ()
    jenv = getattr(jbase, wrapper)(_JaxEcho(), *args)
    tenv = getattr(tbase, wrapper)(_Echo(), *args)
    assert tenv.unwrapped.__class__ is _Echo
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    jobs, _, jrew, _, _ = jax.vmap(jenv.step)(keys, jnp.zeros(16), jnp.asarray(a))
    tobs, _, trew, _, _ = tenv.step(None, torch.zeros(16), torch.from_numpy(a))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    if wrapper == "ClipActions":
        assert np.isfinite(tobs.numpy()).all() and tobs[0, 0] == 0
    if wrapper == "ClipReward":  # a NaN reward stays NaN, as under jnp.sign
        assert np.isnan(trew[0]) and set(np.unique(trew[1:].numpy())) <= {-1.0, 0.0, 1.0}


def _simple_chains(n: int, k: int, scale: float):
    """JAX and port chains over SimpleDeterministicEnv (episodes of 3 steps, each env
    offset by its index through the reset obs): VecMonitor -> VecRewardScale ->
    VecFrameStack."""
    def chain(mod, env):
        venv = mod.VecMonitor(mod.VecJaxEnv(env, n) if mod is jvec else
                              mod.VecTorchEnv(env, n, "cpu"))
        return mod.VecFrameStack(mod.VecRewardScale(venv, scale), k)
    return (chain(jvec, JaxSimple(offset=0.5, episode_len=3)),
            chain(tvec, SimpleDeterministicEnv(offset=0.5, episode_len=3)))


def test_frame_stack_and_reward_scale_match_jax():
    """7 steps of 2 envs of 3-step episodes behind VecRewardScale(0.5) and
    VecFrameStack(3): the stacked obs, zeroed on done before the reset frame goes in,
    ``terminal_obs`` stacked onto the frames before it, the scaled rewards and the
    monitor's raw returns, bit for bit."""
    n, k = 2, 3
    jvenv, tvenv = _simple_chains(n, k, 0.5)
    assert tvenv.observation_space.shape == jvenv.observation_space.shape == (9,)
    np.testing.assert_array_equal(tvenv.observation_space.low, jvenv.observation_space.low)
    key = jax.random.PRNGKey(0)
    jobs, jstate = jvenv.reset(key)
    tobs, tstate = tvenv.reset(None)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    actions = np.zeros((n, 3), np.float32)
    dones = 0
    jstep = jax.jit(jvenv.step)
    for _ in range(7):
        jobs, jstate, jrew, jdone, jinfo = jstep(key, jstate, jnp.asarray(actions))
        tobs, tstate, trew, tdone, tinfo = tvenv.step(None, tstate, torch.from_numpy(actions))
        for got, want in ((tobs, jobs), (tinfo["terminal_obs"], jinfo["terminal_obs"]),
                          (trew, jrew), (tdone, jdone), (tstate.frames, jstate.frames)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        dones += int(tdone.sum())
    assert dones == 4
    ts, js = tvec.VecMonitor.get_stats(tstate), jvec.VecMonitor.get_stats(jstate)
    np.testing.assert_array_equal(ts.ret_buffer.numpy(), np.asarray(js.ret_buffer))
    assert float(ts.ret_buffer[0]) == 0 + 1 + 2  # raw rewards, not scaled


def test_frame_stack_zeroes_on_done():
    """On a done the stack restarts from zeros with the reset frame, and the terminal
    stack ends in the terminal frame (vec.py:293-303)."""
    venv = tvec.VecFrameStack(tvec.VecTorchEnv(SimpleDeterministicEnv(episode_len=2), 1, "cpu"), 2)
    obs, state = venv.reset(None)
    np.testing.assert_array_equal(obs.numpy(), [[0, 0, 0, 0, 1, 2]])
    obs, state, _, done, info = venv.step(None, state, torch.zeros((1, 3)))
    np.testing.assert_array_equal(obs.numpy(), [[0, 1, 2, 100, 101, 102]])
    obs, state, _, done, info = venv.step(None, state, torch.zeros((1, 3)))
    assert bool(done[0])
    np.testing.assert_array_equal(info["terminal_obs"].numpy(), [[100, 101, 102, 200, 201, 202]])
    np.testing.assert_array_equal(obs.numpy(), [[0, 0, 0, 0, 1, 2]])


def test_vec_normalize_matches_jax():
    """12 steps of 8 Pendulum envs (each TimeLimit counter set 1-8 steps before the
    end, so every env resets once) through VecMonitor -> VecRewardScale(0.1) ->
    VecNormalize from the JAX draws: the normalized obs, terminal obs (in the
    normalized space) and rewards to rtol 1e-4 / atol 1e-5; ob_rms and ret_rms to rtol
    1e-5 with their counts bit for bit; the discounted returns zeroed on done."""
    n = 8

    def chain(mod, env):
        base = (mod.VecJaxEnv(jbase.ClipActions(env), n) if mod is jvec else
                mod.VecTorchEnv(tbase.ClipActions(env), n, "cpu"))
        return mod.VecNormalize(mod.VecRewardScale(mod.VecMonitor(base), 0.1))

    jvenv, tvenv = chain(jvec, jax_make_pendulum()), chain(tvec, make_pendulum())
    base = jvenv.venv.venv.venv.env
    key, kreset = jax.random.split(jax.random.PRNGKey(2))
    draws = ReplayDraws()
    push_reset(draws, base, kreset, n)
    jobs, jstate = jvenv.reset(kreset)
    tobs, tstate = tvenv.reset(draws)
    t0 = np.arange(192, 200, dtype=np.int32)
    jmon = jstate.inner
    jstate = jstate.replace(inner=jmon.replace(inner=(jmon.inner[0], jnp.asarray(t0))))
    tmon = tstate.inner
    tstate = dataclasses.replace(tstate, inner=dataclasses.replace(
        tmon, inner=dataclasses.replace(tmon.inner, t=torch.from_numpy(t0))))
    rng = np.random.RandomState(4)
    tol = dict(rtol=1e-4, atol=1e-5)
    jstep = jax.jit(jvenv.step)
    for _ in range(12):
        key, kstep = jax.random.split(key)
        actions = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
        push_env_step(draws, base, kstep, n)
        jobs, jstate, jrew, jdone, jinfo = jstep(kstep, jstate, jnp.asarray(actions))
        tobs, tstate, trew, tdone, tinfo = tvenv.step(draws, tstate, torch.from_numpy(actions))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **tol)
        np.testing.assert_allclose(tinfo["terminal_obs"].numpy(),
                                   np.asarray(jinfo["terminal_obs"]), **tol)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **tol)
        np.testing.assert_allclose(tstate.ret.numpy(), np.asarray(jstate.ret), **tol)
    assert not draws.queue
    assert int(tvec.VecMonitor.get_stats(tstate).episodes) == n
    for name in ("ob_rms", "ret_rms"):
        mine, theirs = getattr(tstate, name), getattr(jstate, name)
        np.testing.assert_allclose(mine.mean.numpy(), np.asarray(theirs.mean), rtol=STAT_RTOL)
        np.testing.assert_allclose(mine.var.numpy(), np.asarray(theirs.var), rtol=STAT_RTOL)
        np.testing.assert_array_equal(mine.count.numpy(), np.asarray(theirs.count))
    assert float(tstate.ob_rms.count) == np.float32(np.float32(1e-4) + n) + 12 * n


def test_normalize_state_helpers():
    """find_normalize_state walks the wrapper states to the NormalizeState (None without
    one); replace_normalize_stats swaps its statistics and leaves a chain without one as
    it is; an axis_name that is not a mesh raises TypeError."""
    venv = tvec.VecFrameStack(tvec.VecNormalize(tvec.VecMonitor(
        tvec.VecTorchEnv(SimpleDeterministicEnv(), 2, "cpu"))), 2)
    _, state = venv.reset(None)
    ns = tvec.find_normalize_state(state)
    assert isinstance(ns, tvec.NormalizeState) and ns is state.inner
    ob = RunningMeanStd.create((3,), epsilon=5.0, device="cpu")
    ret = RunningMeanStd.create((), epsilon=7.0, device="cpu")
    new = tvec.replace_normalize_stats(state, ob, ret)
    assert tvec.find_normalize_state(new).ob_rms is ob and tvec.find_normalize_state(new).ret_rms is ret
    assert isinstance(new, tvec.FrameStackState) and new.frames is state.frames
    plain = tvec.VecMonitor(tvec.VecTorchEnv(SimpleDeterministicEnv(), 2, "cpu")).reset(None)[1]
    assert tvec.find_normalize_state(plain) is None
    same = tvec.replace_normalize_stats(plain, ob, ret)
    assert tvec.find_normalize_state(same) is None and same.stats is plain.stats
    for make in (lambda: tvec.VecNormalize(venv, axis_name="batch"),
                 lambda: ob.update(torch.zeros((4, 3)), axis_name="batch")):
        with pytest.raises(TypeError, match="Mesh"):
            make()


def _assert_stats_match(mine: RunningMeanStd, theirs) -> None:
    np.testing.assert_allclose(mine.mean.numpy(), np.asarray(theirs.mean), rtol=STAT_RTOL)
    np.testing.assert_allclose(mine.var.numpy(), np.asarray(theirs.var), rtol=STAT_RTOL)
    np.testing.assert_array_equal(mine.count.numpy(), np.asarray(theirs.count))


def test_running_mean_std_matches_jax():
    """create (count 1e-4 in f32), update on batches of (64, 3), (5, 2, 3) and one
    sample, update_from_moments, normalize with and without the clip, denormalize, std,
    and merge_branched of two branches of disjoint data: to rtol 1e-5, counts bit for
    bit; merge_branched recovers the statistics of the union."""
    rng = np.random.RandomState(1)
    batches = [rng.randn(64, 3).astype(np.float32) * 3 + 1,
               rng.randn(5, 2, 3).astype(np.float32), rng.randn(3).astype(np.float32)]
    mine, theirs = RunningMeanStd.create((3,), device="cpu"), JaxRMS.create((3,))
    assert mine.count.dtype == torch.float32 and mine.count.shape == ()
    np.testing.assert_array_equal(mine.count.numpy(), np.asarray(theirs.count))
    for x in batches:
        mine, theirs = mine.update(torch.from_numpy(x)), theirs.update(jnp.asarray(x))
        _assert_stats_match(mine, theirs)
    bm, bv = rng.randn(3).astype(np.float32), rng.rand(3).astype(np.float32)
    mine = mine.update_from_moments(torch.from_numpy(bm), torch.from_numpy(bv),
                                    torch.tensor(17.0))
    theirs = theirs.update_from_moments(jnp.asarray(bm), jnp.asarray(bv), jnp.float32(17.0))
    _assert_stats_match(mine, theirs)
    y = rng.randn(16, 3).astype(np.float32) * 20
    for clip in (None, 1.5):
        np.testing.assert_allclose(mine.normalize(torch.from_numpy(y), clip=clip).numpy(),
                                   np.asarray(theirs.normalize(jnp.asarray(y), clip=clip)),
                                   rtol=STAT_RTOL, atol=1e-6)
    np.testing.assert_allclose(mine.denormalize(torch.from_numpy(y)).numpy(),
                               np.asarray(theirs.denormalize(jnp.asarray(y))), rtol=STAT_RTOL)
    np.testing.assert_allclose(mine.std.numpy(), np.asarray(theirs.std), rtol=STAT_RTOL)

    a_data, b_data = rng.randn(40, 3).astype(np.float32), rng.randn(24, 3).astype(np.float32) + 2
    prev, jprev = mine, theirs
    a, b = prev.update(torch.from_numpy(a_data)), prev.update(torch.from_numpy(b_data))
    merged = merge_branched(prev, a, b)
    jmerged = jax_merge_branched(jprev, jprev.update(jnp.asarray(a_data)),
                                 jprev.update(jnp.asarray(b_data)))
    np.testing.assert_allclose(merged.mean.numpy(), np.asarray(jmerged.mean), rtol=1e-4)
    np.testing.assert_allclose(merged.var.numpy(), np.asarray(jmerged.var), rtol=1e-4)
    np.testing.assert_array_equal(merged.count.numpy(), np.asarray(jmerged.count))
    union = prev.update(torch.from_numpy(np.concatenate([a_data, b_data])))
    np.testing.assert_allclose(merged.mean.numpy(), union.mean.numpy(), rtol=1e-4)
    np.testing.assert_allclose(merged.var.numpy(), union.var.numpy(), rtol=1e-3)
