"""The slice as a whole: one full ppo2 update of the port against the JAX package's, on
the CPU, at 8 envs x 16 steps of AtariSim-v0 packed by VecS2D, cnn_s2d in f32, 2 epochs
of 2 minibatches.

Both start from the same weights (carried across by convert.py) and the same env
state. The port is handed the very draws the JAX update makes, rebuilt from the same
key splits (algos/ppo/ppo.py:374-375, algos/common.py:228-230): the Gumbel uniforms and
env reset draws of every rollout step, then the epoch permutations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ReplayDraws, policy_params, push_epochs, push_reset,
                          push_rollout_step, rel_err)

from baselines_tpu.algos.common import adam_optimizer
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.ppo.ppo import PPOTrainState as JaxTrainState
from baselines_tpu.algos.ppo.ppo import make_update_fn as jax_make_update_fn
from baselines_tpu.core.schedules import resolve_fraction_schedule as jax_schedule
from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import ClipAdam, build_env
from baselines_tpu_torch.algos.ppo.ppo import PPOTrainState, make_update_fn
from baselines_tpu_torch.core.schedules import resolve_fraction_schedule
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.policy import build_policy

NENVS, NSTEPS, NMB, NEPOCHS = 8, 16, 2, 2
HPARAMS = dict(nsteps=NSTEPS, nminibatches=NMB, noptepochs=NEPOCHS, gamma=0.99, lam=0.95,
               ent_coef=0.01, vf_coef=0.5, nupdates=1)


@pytest.fixture(scope="module")
def runs():
    venv = jax_build_env("AtariSim-v0", NENVS, s2d=4)
    jpol = jax_build_policy(venv.observation_space, venv.action_space, "cnn_s2d")
    tx = adam_optimizer(0.5, eps=1e-5)
    # learn()'s make_state (algos/ppo/ppo.py:508-521), with the params made by numpy
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    obs, env_state = venv.reset(kreset)
    params = policy_params(0, venv.action_space.n)
    state = JaxTrainState(params=params, opt_state=tx.init(params), key=key,
                          env_state=env_state, obs=obs, rnn_state=None,
                          last_done=jnp.zeros((NENVS,), bool), update_idx=jnp.zeros((), jnp.int32))
    update = jax.jit(jax_make_update_fn(jpol, venv, tx, lr_fn=jax_schedule(3e-4),
                                        cliprange_fn=jax_schedule(0.2), **HPARAMS))
    jnew, jmetrics = update(state)

    base = venv.venv.venv.env  # VecS2D -> VecMonitor -> VecJaxEnv -> AtariSim
    draws = ReplayDraws()
    push_reset(draws, base, kreset, NENVS)
    k = key
    for _ in range(NSTEPS):
        k = push_rollout_step(draws, base, k, NENVS, venv.action_space.n)
    push_epochs(draws, k, NEPOCHS, NENVS * NSTEPS)

    tvenv = build_env("AtariSim-v0", NENVS, device="cpu", s2d=4)
    tpol = build_policy(tvenv.observation_space, tvenv.action_space, "cnn_s2d", device="cpu")
    start = convert.policy_state_dict(params)
    tpol.module.load_state_dict(start)
    opt = ClipAdam(tpol.module.parameters(), 0.5, eps=1e-5)
    tobs, tenv_state = tvenv.reset(draws)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
    tstate = PPOTrainState(env_state=tenv_state, obs=tobs,
                           last_done=torch.zeros((NENVS,), dtype=torch.bool))
    update_fn = make_update_fn(tpol, tvenv, opt, lr_fn=resolve_fraction_schedule(3e-4),
                               cliprange_fn=resolve_fraction_schedule(0.2), **HPARAMS)
    tnew, tmetrics = update_fn(tstate, draws)
    assert not draws.queue, "the port took fewer draws than the JAX update made"
    return dict(jnew=jnew, jmetrics=jmetrics, tnew=tnew, tmetrics=tmetrics, tpol=tpol,
                start=start)


def test_update_metrics_match_jax(runs):
    """Every metric to 1e-4 relative or 1e-6 absolute: f32 convolutions and reductions
    sum in another order, and the second and later minibatch steps see params that
    already carry those differences."""
    jm, tm = runs["jmetrics"], runs["tmetrics"]
    assert set(tm) == set(jm)
    for k in jm:
        got, want = float(tm[k]), float(jm[k])
        assert abs(got - want) <= 1e-6 + 1e-4 * abs(want), (k, got, want)
    assert float(jm["approxkl"]) > 0


def test_update_params_match_jax(runs):
    """Each param tensor's change over the update to 2e-4 of that change: Adam divides
    each gradient by its running scale, so a relative difference in a small gradient
    comes through undamped (3e-5 at most, measured on this test's inputs)."""
    want = convert.policy_state_dict(jax.tree_util.tree_map(np.asarray, runs["jnew"].params))
    for name, p in runs["tpol"].module.state_dict().items():
        start = runs["start"][name].double()
        delta_want = want[name].double() - start
        assert float(delta_want.abs().max()) > 0, name
        assert rel_err(p.double() - start, delta_want) < 2e-4, name


def test_update_env_state_matches_jax(runs):
    """The rollout leaves the envs where the JAX rollout leaves them, bit for bit."""
    jnew, tnew = runs["jnew"], runs["tnew"]
    np.testing.assert_array_equal(tnew.obs.numpy(), np.asarray(jnew.obs))
    js, ts = JaxVecMonitor.get_stats(jnew.env_state), VecMonitor.get_stats(tnew.env_state)
    np.testing.assert_array_equal(ts.ep_return.numpy(), np.asarray(js.ep_return))
    np.testing.assert_array_equal(ts.ep_length.numpy(), np.asarray(js.ep_length))
    assert tnew.update_idx == int(jnew.update_idx) == 1
