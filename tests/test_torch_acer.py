"""The port's acer (algos/acer/acer.py, data/frame_chunk.py, the q head of nn/policy.py)
against the JAX package's, on the CPU: the Retrace targets; the frame codec across
episode boundaries and the flat stored rows, bit for bit; the q head; and one on-policy
and one replay update of each side from the same weights (carried across by
convert.py), the same env state and the same draws (the rollout's, then the replay's
chunk indices, rebuilt from the JAX learner's key splits): with the trust region on
flat rows, and without it on the frame-deduplicated replay of a 2-frame stack.

Tolerances: Retrace to 1e-5 absolute (the reference test's); the q head to 1e-5
relative; params, the average params and RMSProp's nu to 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import acer_two_updates
from torch_parity import (ReplayDraws, base_env, init_params, move_params, push_reset,
                          push_rollout_step, rel_err)

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.acer import acer as jacer
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.core import logger as jax_logger
from baselines_tpu.data.frame_chunk import compress_frames as jax_compress
from baselines_tpu.data.frame_chunk import decompress_frames as jax_decompress
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.acer import acer
from baselines_tpu_torch.algos.common import build_env
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.data.frame_chunk import compress_frames, decompress_frames
from baselines_tpu_torch.envs.testing.identity import BoxIdentityEnv
from baselines_tpu_torch.envs.vec import VecFrameStack, VecTorchEnv
from baselines_tpu_torch.nn.policy import build_policy


def test_q_retrace_matches_jax():
    rng = np.random.RandomState(0)
    t, n = 7, 3
    args = [rng.randn(t, n), (rng.rand(t, n) < 0.2), rng.randn(t, n), rng.randn(t + 1, n),
            np.exp(rng.randn(t, n))]
    args = [a.astype(np.float32) for a in args]
    want = np.asarray(jacer.q_retrace(*map(jnp.asarray, args), 0.95))
    got = acer.q_retrace(*map(torch.from_numpy, args), 0.95).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_frame_codec_round_trips_and_matches_jax_bit_for_bit():
    """A 4-frame stack of BoxIdentity((2,), episode_len=5) over 37 steps of 3 envs (so
    episodes end inside the chunk): compress then decompress gives every stacked
    observation back, one env at a time and batched, and both functions give the JAX
    package's bits on the same chunk."""
    k, nsteps, nenvs = 4, 37, 3
    venv = VecFrameStack(VecTorchEnv(BoxIdentityEnv((2,), episode_len=5), nenvs, "cpu"), k)
    draws = Draws(3, "cpu")
    obs, state = venv.reset(draws)
    obs_t, done_t = [obs], []
    for _ in range(nsteps):
        obs, state, _, done, _ = venv.step(draws, state, draws.uniform((nenvs, 2), -1.0, 1.0))
        obs_t.append(obs)
        done_t.append(done.to(torch.float32))
    full = torch.stack(obs_t, dim=1)  # (N, T + 1, 2k)
    dones = torch.stack(done_t, dim=1)
    assert bool((dones > 0).any()) and bool((full[:, 1:] == 0).any())
    first, frames = compress_frames(full, dones, k)
    assert frames.shape[-1] * k == full.shape[-1]
    assert torch.equal(decompress_frames(first, frames, dones, k), full)
    for i in range(nenvs):
        f0, fr = compress_frames(full[i], dones[i], k)
        assert torch.equal(f0, first[i]) and torch.equal(fr, frames[i])
        rebuilt = decompress_frames(f0, fr, dones[i], k)
        assert torch.equal(rebuilt, full[i])
        jf0, jfr = jax_compress(jnp.asarray(full[i].numpy()), jnp.asarray(dones[i].numpy()), k)
        np.testing.assert_array_equal(np.asarray(jf0), f0.numpy())
        np.testing.assert_array_equal(np.asarray(jfr), fr.numpy())
        jrebuilt = jax_decompress(jf0, jfr, jnp.asarray(dones[i].numpy()), k)
        np.testing.assert_array_equal(np.asarray(jrebuilt), rebuilt.numpy())


def test_q_head_matches_jax():
    """estimate_q: a ``q`` head of n_actions on the latent (orthogonal, gain 1) where the
    value head was, for Discrete actions only; pdflat and q to 1e-5 of JAX's."""
    jvenv = jax_build_env("CartPole-v1", 1)
    jpol = jax_build_policy(jvenv.observation_space, jvenv.action_space, "mlp", estimate_q=True)
    obs = np.random.RandomState(1).randn(16, 4).astype(np.float32)
    params = init_params(jpol.init, 5, jnp.asarray(obs[:1]))
    jpdflat, jq, _ = jpol.apply(params, jnp.asarray(obs))
    tvenv = build_env("CartPole-v1", 1, device="cpu")
    tpol = build_policy(tvenv.observation_space, tvenv.action_space, "mlp", device="cpu",
                        estimate_q=True)
    assert {"q.weight", "q.bias"} <= set(tpol.module.state_dict())
    assert not hasattr(tpol.module, "vf")
    tpol.module.load_state_dict(convert.policy_state_dict(params))
    with torch.no_grad():
        pdflat, q, _ = tpol.module(torch.from_numpy(obs))
    assert q.shape == (16, 2)
    np.testing.assert_allclose(pdflat.numpy(), np.asarray(jpdflat), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Discrete"):
        box = build_env("BoxIdentity-v0", 1, device="cpu")
        build_policy(box.observation_space, box.action_space, "mlp", device="cpu",
                     estimate_q=True)


NENVS, NSTEPS = 4, 8
CASES = {"trust_region": dict(trust_region=True),
         "no_trust_region_dedup": dict(trust_region=False, frame_stack=2, dedup_frames=2)}


def jax_two_chunks(case: str, draws) -> dict:
    """One on-policy and one replay update of the JAX learner (learn for one update of
    4 envs x 8 steps, replay from the start; numpy's RandomState(2) draws 1 replay from
    Poisson(4); its params and average params replaced by moved flax inits through a
    wrapped ``jit_init``), and its draws rebuilt from its key splits (all of them on the
    env axis: the rollout's, then the replay's chunk indices) pushed to ``draws``.
    Returns the JAX learner's start and end states and the port's case for
    ``torch_dist_worker.acer_two_updates``, with the same weights."""
    spec = dict(CASES[case])
    frame_stack = spec.pop("frame_stack", 0)
    seed = 2
    assert np.random.RandomState(seed).poisson(4) == 1
    jvenv = jax_build_env("CartPole-v1", NENVS, frame_stack=frame_stack)
    starts = []

    def start_from_moved(make_state, key):
        state = make_state(key)
        params = move_params(state.params, 4)
        state = state.replace(params=params, avg_params=params)
        starts.append(jax.device_get(state))
        return jax_common.dealias(state)

    hp = dict(num_hidden=16, replay_start=0, buffer_size=10 * NSTEPS, lr=7e-4, q_coef=0.5,
              ent_coef=0.01, gamma=0.99, c=10.0, alpha=0.99, delta=1.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", start_from_moved)
        mp.setattr(jax_logger, "logkv", lambda k, v: None)
        mp.setattr(jax_logger, "dumpkvs", lambda: None)
        jmodel = jacer.learn(env_id="CartPole-v1", network="mlp", seed=seed, num_envs=NENVS,
                             nsteps=NSTEPS, total_timesteps=NENVS * NSTEPS,
                             frame_stack=frame_stack, log_interval=1, **hp, **spec)
    jstart, = starts

    base = base_env(jvenv)
    _, kreset, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    push_reset(draws, base, kreset, NENVS)
    k = jstart.key
    for _ in range(NSTEPS):
        k = push_rollout_step(draws, base, k, NENVS, jvenv.action_space)
    _, ksample = jax.random.split(k)
    draws.push("randint", jax.random.randint(ksample, (NENVS,), 0, NENVS))
    # the port's learner as ``learn`` builds it at these hyperparameters (the rest are
    # acer_two_updates' own: lr, q_coef, ent_coef, gamma, c, alpha, delta as ``hp``)
    port_case = dict(env_id="CartPole-v1", num_envs=NENVS, nsteps=NSTEPS, seed=seed,
                     frame_stack=frame_stack, dedup_frames=spec.get("dedup_frames", 0),
                     capacity=10, nupdates=1, trust_region=spec["trust_region"],
                     network_kwargs={"num_hidden": hp["num_hidden"]})
    return dict(jstart=jstart, jnew=jax.device_get(jmodel.state),
                start=convert.policy_state_dict(jstart.params), case=port_case)


@pytest.fixture(scope="module", params=list(CASES))
def two_chunks(request):
    """The JAX learner's two updates (``jax_two_chunks``) and the port's update
    functions' from the same state and draws."""
    draws = ReplayDraws()
    run = jax_two_chunks(request.param, draws)
    out = acer_two_updates(run["case"], draws=draws, start=run["start"])
    np.testing.assert_array_equal(out["reset_obs"].numpy(), np.asarray(run["jstart"].obs))
    assert not draws.queue, "the port took fewer draws than the JAX update made"
    return dict(run, out=out)


def check_updates(jnew, start: dict, out: dict) -> None:
    """After the on-policy and the replay step (``acer_two_updates``' ``out``): the
    params and the average params to 1e-4 relative of JAX's, and each tensor's change
    to 1e-4 of the JAX change beside the two ulps in which each side rounds the f32
    values it steps (a step moves a param of about 0.3 by about 1e-4, and the average by
    a hundredth of that, so an ulp is 3e-4 of the one change and 3e-2 of the other);
    RMSProp's nu to 1e-4 relative."""
    for got, want_params in ((out["replay"]["params"], jnew.params),
                             (out["replay"]["avg"], jnew.avg_params)):
        want = convert.policy_state_dict(want_params)
        for name, p in got.items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4, err_msg=name)
            delta_want = want[name].double() - start[name].double()
            assert float(delta_want.abs().max()) > 0, name
            ulp = torch.from_numpy(np.spacing(np.abs(want[name].numpy()))).double()
            err = (p.double() - want[name].double()).abs()
            assert bool((err <= 1e-4 * delta_want.abs().max() + 2 * ulp).all()), name
    jnu = convert.policy_state_dict(jnew.opt_state[1].nu)
    assert out["count"] == 2
    for name, nu in out["nu"].items():
        assert rel_err(nu.double(), jnu[name].double()) < 1e-4, name
    assert all(np.isfinite(v) for v in out["onpolicy"]["metrics"].values())


def test_updates_match_jax(two_chunks):
    """The params, the average params and RMSProp's nu after the two updates as the JAX
    learner's (``check_updates``)."""
    check_updates(two_chunks["jnew"], two_chunks["start"], two_chunks["out"])


def test_stored_rows_match_jax_bit_for_bit(two_chunks):
    """The replay ring after the on-policy update holds the JAX package's layout: flat
    rows of (T + 1) * prod(ob_shape) observations, or the first stacked observation and
    a flat row of the T newest frames. JAX's stored rows, restored by the port's
    ``to_full`` and stored again by its ``to_stored``, come back bit for bit; the port's
    own ring has the same shapes and dtypes, and its actions and dones are JAX's."""
    run = two_chunks
    replay, ring = run["out"]["layout"], run["out"]["ring"]
    jdata = {k: torch.from_numpy(np.array(v)[:NENVS])
             for k, v in run["jnew"].replay.data.items()}
    tdata = {k: v[:NENVS] for k, v in ring.data.items()}
    assert set(jdata) == set(tdata) == (
        {"actions", "rewards", "mus", "dones"} | ({"obs0", "frames"} if replay.dedup else {"obs"}))
    for k in jdata:
        assert jdata[k].shape == tdata[k].shape and jdata[k].dtype == tdata[k].dtype, k
    full = replay.to_full(jdata)
    again = replay.to_stored(full)
    for k in jdata:
        assert torch.equal(again[k], jdata[k]), k
    assert full["obs"].shape == (NENVS, NSTEPS + 1) + replay.ob_shape
    if replay.dedup:
        for i in range(NENVS):
            want = jax_decompress(jnp.asarray(jdata["obs0"][i].numpy()),
                                  jnp.asarray(jdata["frames"][i].numpy().reshape(
                                      replay.frames_shape)),
                                  jnp.asarray(jdata["dones"][i].numpy()), replay.dedup)
            np.testing.assert_array_equal(full["obs"][i].numpy(), np.asarray(want))
    assert torch.equal(tdata["actions"], jdata["actions"])
    assert torch.equal(tdata["dones"], jdata["dones"])
    assert ring.size == NENVS and ring.ptr == NENVS
