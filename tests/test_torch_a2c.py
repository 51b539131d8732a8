"""a2c in the port against the JAX package on the CPU: ``ClipRMSProp`` against optax's
``chain(clip_by_global_norm, scale_by_rms)``, and two a2c updates against two updates of
the JAX package's ``learn`` from the same weights and draws.

The JAX learner builds its update inside ``learn``; the test rebuilds its initial state
from the same key splits (a2c.py:157-171: ``key, kreset, kinit``) and hands the port
the draws of its two rollouts (algos/common.py:228-230), then compares the logged rows
and the params after the second update, which ran at half the learning rate of the
first (``lrschedule="linear"``). Tolerances: the metrics to 1e-4 relative or 1e-6
absolute and each param's change to 2e-4 of the JAX change, as
tests/test_torch_update.py holds ppo2's update (RMSProp, like Adam, divides each
gradient by its running scale); the rollout bit for bit."""

import jax
import numpy as np
import optax
import pytest
import torch
from torch_parity import (ReplayDraws, assert_update_params_match, base_env, push_reset,
                          push_rollout_step)

from baselines_tpu.algos.a2c import a2c as jax_a2c
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.core import logger as jax_logger
from baselines_tpu.core.rng import seed_key
from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.a2c.a2c import A2CTrainState, a2c_lr, make_update_fn
from baselines_tpu_torch.algos.common import ClipRMSProp, build_env
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.policy import build_policy


def test_clip_rmsprop_matches_optax():
    """Five steps of random gradients, clipped on some steps and not on others, through
    ClipRMSProp and through optax's chain with ``p - lr * u``, to 1e-6."""
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (3,), (7,)]
    start = [rng.randn(*s).astype(np.float32) for s in shapes]
    params = [torch.from_numpy(x.copy()) for x in start]
    opt = ClipRMSProp(params, max_grad_norm=0.5, decay=0.99, eps=1e-5)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.scale_by_rms(decay=0.99, eps=1e-5))
    jparams = [jax.numpy.asarray(x) for x in start]
    state = tx.init(jparams)
    for step in range(5):
        scale = 0.01 if step % 2 else 1.0  # norms under and over the clip
        grads = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
        lr = 7e-4 * (1 - step / 5)
        opt.step([torch.from_numpy(g) for g in grads], lr)
        updates, state = tx.update([jax.numpy.asarray(g) for g in grads], state, jparams)
        jparams = [p - np.float32(lr) * u for p, u in zip(jparams, updates)]
        for mine, theirs in zip(params, jparams):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)
    assert opt.count == 5


def test_linear_learning_rate_in_f32():
    assert a2c_lr(7e-4, "linear", 0, 2) == float(np.float32(7e-4))
    assert a2c_lr(7e-4, "linear", 1, 2) == float(np.float32(7e-4) * np.float32(0.5))
    assert a2c_lr(7e-4, "constant", 1, 2) == float(np.float32(7e-4))


class _Rows(jax_logger.KVWriter):
    def __init__(self):
        self.rows = []

    def writekvs(self, kvs):
        self.rows.append(dict(kvs))


CASES = {
    "mlp": dict(env_id="DiscreteIdentity-v0", network="mlp", network_kwargs={}),
    "lstm": dict(env_id="FixedSequence-v0", network="lstm", network_kwargs={"nlstm": 8}),
}
NENVS, NSTEPS, SEED = 8, 16, 3


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    case = CASES[request.param]
    hp = dict(env_id=case["env_id"], network=case["network"], seed=SEED, num_envs=NENVS,
              nsteps=NSTEPS, gamma=0.9, total_timesteps=2 * NENVS * NSTEPS, log_interval=1)
    rows = _Rows()
    jax_logger.Logger.CURRENT = jax_logger.Logger(dir=None, output_formats=[rows])
    try:
        jmodel = jax_a2c.learn(**hp, **case["network_kwargs"])
    finally:
        jax_logger.reset()
    # learn()'s make_state (a2c.py:157-171)
    venv = jax_build_env(case["env_id"], NENVS)
    jpol = jax_build_policy(venv.observation_space, venv.action_space, case["network"],
                            **case["network_kwargs"])
    key, kreset, kinit = jax.random.split(seed_key(SEED), 3)
    obs, _ = venv.reset(kreset)
    start = convert.policy_state_dict(jax.tree_util.tree_map(np.asarray, jpol.init(kinit, obs)))

    draws = ReplayDraws()
    base = base_env(venv)
    push_reset(draws, base, kreset, NENVS)
    for _ in range(2 * NSTEPS):
        key = push_rollout_step(draws, base, key, NENVS, venv.action_space)
    tvenv = build_env(case["env_id"], NENVS, device="cpu")
    tpol = build_policy(tvenv.observation_space, tvenv.action_space, case["network"],
                        device="cpu", **case["network_kwargs"])
    tpol.module.load_state_dict(start)
    opt = ClipRMSProp(tpol.module.parameters(), 0.5, decay=0.99, eps=1e-5)
    tobs, env_state = tvenv.reset(draws)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
    state = A2CTrainState(env_state=env_state, obs=tobs,
                          last_done=torch.zeros((NENVS,), dtype=torch.bool),
                          rnn_state=tpol.initial_state(NENVS))
    update = make_update_fn(tpol, tvenv, opt, nsteps=NSTEPS, gamma=0.9, ent_coef=0.01,
                            vf_coef=0.5, lr=7e-4, lrschedule="linear", nupdates=2)
    tmetrics = []
    for _ in range(2):
        state, m = update(state, draws)
        tmetrics.append({k: float(v) for k, v in m.items()})
    assert not draws.queue
    return dict(jmodel=jmodel, jrows=rows.rows, tpol=tpol, tstate=state, tmetrics=tmetrics,
                start=start)


def test_a2c_metrics_match_jax(runs):
    """policy_loss, value_loss, policy_entropy and explained_variance of both updates,
    to 1e-4 relative or 1e-6 absolute."""
    assert len(runs["jrows"]) == 2
    for jrow, trow in zip(runs["jrows"], runs["tmetrics"]):
        assert set(trow) == {"policy_loss", "value_loss", "policy_entropy",
                             "explained_variance"}
        for k, got in trow.items():
            want = float(jrow[k])
            assert abs(got - want) <= 1e-6 + 1e-4 * abs(want), (k, got, want)


def test_a2c_params_match_jax(runs):
    """Each param tensor's change over the two updates to 2e-4 of the JAX change."""
    assert_update_params_match(runs["jmodel"].params, runs["tpol"], runs["start"])


def test_a2c_rollout_matches_jax(runs):
    """The two rollouts leave the envs where the JAX ones leave them, bit for bit."""
    js = JaxVecMonitor.get_stats(runs["jmodel"].state.env_state)
    ts = VecMonitor.get_stats(runs["tstate"].env_state)
    np.testing.assert_array_equal(runs["tstate"].obs.numpy(), np.asarray(runs["jmodel"].state.obs))
    np.testing.assert_array_equal(ts.ep_return.numpy(), np.asarray(js.ep_return))
    assert runs["tstate"].update_idx == 2
