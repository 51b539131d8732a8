"""The port's recurrent policies against the JAX package's on the CPU: the rollout's
carry and masks, the loss's replay from the carry before the rollout, recurrent
minibatching by whole envs, ``evaluate``, ``Model.step`` and the bitwise resume.

The env is FixedSequenceEnv(10, episode_len=5), as tests/test_ppo_learning.py's
recurrent test builds it, so a 16-step rollout crosses three episode ends and the masks
reset the carry of every env in the middle of the sequence. The JAX side's weights come
from flax's init, moved by noise (``torch_parity.init_params``), and reach the port
through convert.py.
"""

import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ReplayDraws, assert_update_metrics_match, assert_update_params_match,
                          init_params, one_ppo_update, push_policy_noise, rel_err)

from baselines_tpu.algos.common import Model as JaxModel
from baselines_tpu.algos.common import evaluate as jax_evaluate
from baselines_tpu.envs.spaces import Discrete as JaxDiscrete
from baselines_tpu.envs.testing.fixed_sequence import FixedSequenceEnv as JaxFixedSequence
from baselines_tpu.envs.vec import VecJaxEnv, VecMonitor as JaxVecMonitor
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import Model, evaluate, run_rollout
from baselines_tpu_torch.algos.ppo import ppo
from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.envs.spaces import Discrete
from baselines_tpu_torch.envs.testing.fixed_sequence import FixedSequenceEnv
from baselines_tpu_torch.envs.vec import VecMonitor, VecTorchEnv
from baselines_tpu_torch.nn.policy import build_policy

NLSTM = 8


@pytest.fixture(autouse=True)
def quiet_logger():
    yield
    logger.reset()


def fixed_sequence_envs(nenvs: int):
    """(the JAX venv, the port's venv) of FixedSequenceEnv(10, episode_len=5)."""
    return (JaxVecMonitor(VecJaxEnv(JaxFixedSequence(10, episode_len=5), nenvs)),
            VecMonitor(VecTorchEnv(FixedSequenceEnv(10, episode_len=5), nenvs, "cpu")))


def _policies(network="lstm", seed=0, nenvs=4, **network_kwargs):
    """The JAX and the port's policy on FixedSequence's one-state observation, the
    port's loaded with the JAX side's moved init params; the policy head scaled up a
    hundredfold keeps the actions away from near ties."""
    jpol = jax_build_policy(JaxDiscrete(1), JaxDiscrete(10), network, **network_kwargs)
    params = init_params(jpol.init, seed, jnp.zeros((nenvs,), jnp.int32))
    params["params"]["pi"]["kernel"] = params["params"]["pi"]["kernel"] * 100
    tpol = build_policy(Discrete(1), Discrete(10), network, device="cpu", **network_kwargs)
    tpol.module.load_state_dict(convert.policy_state_dict(params), strict=True)
    return jpol, params, tpol


@pytest.fixture(scope="module")
def recurrent_update():
    """One full recurrent ppo2 update, ``lstm`` with 8 cells, 4 envs x 16 steps, 2
    epochs of 2 minibatches of 2 whole envs, with the JAX draws."""
    return one_ppo_update(make_envs=fixed_sequence_envs, network="lstm",
                          network_kwargs={"nlstm": NLSTM}, hparams={"nenvs": 4})


def test_recurrent_update_metrics_match_jax(recurrent_update):
    """Every metric to 1e-4 relative or 1e-6 absolute, as for the feedforward update."""
    assert_update_metrics_match(recurrent_update["jmetrics"], recurrent_update["tmetrics"])


def test_recurrent_update_params_match_jax(recurrent_update):
    """Each param tensor's change over the update to 2e-4 of that change, the LSTM's
    ``wx``, ``wh`` and ``b`` among them."""
    r = recurrent_update
    lstm = {"network.lstm.wx.weight", "network.lstm.wh.weight", "network.lstm.b"}
    assert lstm <= set(r["start"])
    assert_update_params_match(r["jnew"].params, r["tpol"], r["start"])


def test_recurrent_update_carries_the_carry(recurrent_update):
    """The carry after the rollout, which the next update starts from, equals JAX's to
    1e-5, and the masks reset it: an episode of 5 steps ended in the rollout."""
    r = recurrent_update
    got, want = r["tnew"].rnn_state, np.asarray(r["jnew"].rnn_state)
    assert got.shape == want.shape == (4, 2 * NLSTM)
    assert rel_err(got, want) < 1e-5
    assert float(np.abs(want).max()) > 0
    assert bool(r["tnew"].last_done.all()) == bool(np.asarray(r["jnew"].last_done).all())


def test_loss_replays_the_rollout():
    """The loss's replay of a rollout (``PolicyValueNet.unroll``: the observations
    encoded at once, the cell step by step from the carry before the rollout, masked by
    the rollout's masks) gives the ``neglogps`` and ``values`` the rollout stepped with,
    to 1e-5 relative, over 12 steps that cross two episode ends."""
    torch.manual_seed(0)
    _, _, tpol = _policies(nlstm=NLSTM)
    venv = VecMonitor(VecTorchEnv(FixedSequenceEnv(10, episode_len=5), 4, "cpu"))
    draws = Draws(0, "cpu")
    obs, env_state = venv.reset(draws)
    init = 0.3 * torch.randn(4, 2 * NLSTM)
    done = torch.tensor([False, True, False, False])
    _, _, _, traj, _, carry = run_rollout(tpol, venv, draws, env_state, obs, done, 12, init)
    assert traj.rnn_masks[0].tolist() == [0.0, 1.0, 0.0, 0.0]
    assert int(traj.rnn_masks.sum()) == 4 * 2 + 1
    with torch.no_grad():
        pdflat, vf, replayed = tpol.module.unroll(traj.obs, init, traj.rnn_masks)
    neglogp = tpol.pdtype.pdfromflat(pdflat).neglogp(traj.actions.reshape(-1))
    assert rel_err(neglogp, traj.neglogps.reshape(-1)) < 1e-5
    assert rel_err(vf, traj.values.reshape(-1)) < 1e-5
    torch.testing.assert_close(replayed, carry, rtol=1e-5, atol=1e-6)


def test_recurrent_evaluate_matches_jax():
    """``evaluate`` of an lstm policy, 4 envs, 23 deterministic steps from the zero
    carry, masked at every episode end: the mean return, mean length and episode count
    equal the JAX ``evaluate``'s."""
    jpol, params, tpol = _policies(nlstm=NLSTM)
    jvenv, tvenv = fixed_sequence_envs(4)
    want = jax_evaluate(JaxModel(jpol, types.SimpleNamespace(params=params)), jvenv,
                        jax.random.PRNGKey(0), nsteps=23, deterministic=True)
    got = evaluate(Model(tpol, None), tvenv, ReplayDraws(), nsteps=23, deterministic=True)
    assert got[2] == want[2] == 16
    assert got == want


def test_model_step_with_carry_and_done_matches_jax():
    """``Model.step(obs, draws, rnn_state, done)`` with JAX's Gumbel uniforms: the
    actions equal, the values, neglogps and new carry to 1e-5; ``done`` zeroes the
    carry of the envs that start an episode, and None masks nothing; ``Model.value``
    with the carry and ``done``; ``initial_rnn_state`` is the zero carry."""
    jpol, params, tpol = _policies(nlstm=NLSTM, nenvs=5)
    jmodel, tmodel = JaxModel(jpol, types.SimpleNamespace(params=params)), Model(tpol, None)
    obs = np.zeros((5,), np.int32)
    carry = (0.5 * np.random.RandomState(1).randn(5, 2 * NLSTM)).astype(np.float32)
    assert torch.equal(tmodel.initial_rnn_state(5), torch.zeros(5, 2 * NLSTM))
    for done in (np.array([True, False, True, False, False]), None):
        key = jax.random.PRNGKey(3)
        jdone = None if done is None else jnp.asarray(done)
        jaction, jvalue, jneglogp, jcarry = jmodel.step(key, jnp.asarray(obs),
                                                        jnp.asarray(carry), jdone)
        draws = ReplayDraws()
        push_policy_noise(draws, key, 5, 10)
        tdone = None if done is None else torch.from_numpy(done)
        action, value, neglogp, tcarry = tmodel.step(torch.from_numpy(obs), draws,
                                                     torch.from_numpy(carry), tdone)
        np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
        assert rel_err(value, jvalue) < 1e-5 and rel_err(neglogp, jneglogp) < 1e-5
        assert rel_err(tcarry, jcarry) < 1e-5
        if done is not None:  # the JAX Model.value takes no carry without a mask
            tvalue = tmodel.value(torch.from_numpy(obs), torch.from_numpy(carry), tdone)
            jvalue = jmodel.value(jnp.asarray(obs), jnp.asarray(carry), jdone)
            assert rel_err(tvalue, jvalue) < 1e-5
    # a fresh carry differs from a masked one only where done was False
    fresh = tmodel.step(torch.from_numpy(obs), draws_for(5), torch.zeros(5, 2 * NLSTM))[3]
    masked = tmodel.step(torch.from_numpy(obs), draws_for(5), torch.from_numpy(carry),
                         torch.ones(5, dtype=torch.bool))[3]
    torch.testing.assert_close(fresh, masked, rtol=0, atol=0)


def draws_for(n):
    draws = ReplayDraws()
    draws.push("uniform", np.full((n, 10), 0.5, np.float32))
    return draws


@pytest.mark.parametrize("kwargs,error", [
    ({"network": "lstm", "microbatch_size": 8}, NotImplementedError),
    ({"network": "lstm", "nminibatches": 3}, ValueError),
    ({"network": "lstm", "value_network": "copy"}, NotImplementedError),
], ids=["microbatch", "nminibatches_not_dividing_envs", "value_network_copy"])
def test_recurrent_options_the_jax_package_refuses(kwargs, error):
    """As the JAX package: no microbatching of a recurrent policy (ppo.py:181), the
    minibatches must split the envs evenly (:177-180), and no separate value tower for
    a recurrent network (policy.py:66-67)."""
    with pytest.raises(error):
        ppo.learn(env_id="FixedSequence-v0", num_envs=4, nsteps=8, total_timesteps=32,
                  device="cpu", seed=0, nlstm=NLSTM, **dict({"nminibatches": 2}, **kwargs))


PPO = dict(env_id="FixedSequence-v0", network="lstm", nlstm=NLSTM, seed=0, num_envs=4,
           nsteps=16, nminibatches=2, noptepochs=2, log_interval=100, device="cpu")


def _ppo_run(logdir, resume_from=None, **kwargs):
    if resume_from is not None:
        os.makedirs(os.path.join(logdir, "checkpoints"), exist_ok=True)
        shutil.copy(resume_from, os.path.join(logdir, "checkpoints",
                                              os.path.basename(resume_from)))
    logger.configure(dir=str(logdir), format_strs=[])
    model = ppo.learn(**dict(PPO, **kwargs))
    logger.reset()
    return model


def test_recurrent_resume_reproduces_uninterrupted_run(tmp_path):
    """4 updates of a recurrent run with a checkpoint at each; a run resumed from the
    checkpoint of update 2 in a fresh log dir ends with the uninterrupted run's params,
    Adam moments, env state, carry and generator state, bit for bit."""
    total = 4 * 4 * 16
    full = _ppo_run(tmp_path / "full", total_timesteps=total, save_interval=1)
    resumed = _ppo_run(tmp_path / "resumed", total_timesteps=total, save_interval=1,
                       resume_from=str(tmp_path / "full" / "checkpoints" / "00002"))
    assert resumed.state.update_idx == full.state.update_idx == 4
    a, b = ckpt.to_tree(full._train_tree()), ckpt.to_tree(resumed._train_tree())
    leaves = []

    def walk(x, y, where):
        if isinstance(x, dict):
            assert set(x) == set(y), where
            for k in x:
                walk(x[k], y[k], f"{where}.{k}")
        elif isinstance(x, list):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{where}[{i}]")
        elif isinstance(x, torch.Tensor):
            leaves.append(where)
            assert torch.equal(x, y), where
        else:
            assert x == y, where

    walk(a, b, "train state")
    assert "train state.state.rnn_state" in leaves
    assert "train state.params.network.lstm.b" in leaves
    assert float(full.state.rnn_state.abs().max()) > 0
