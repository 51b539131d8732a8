"""The slice as a whole: one full ppo2 update of the port against the JAX package's, on
the CPU, at 8 envs x 16 steps of AtariSim-v0 packed by VecS2D, cnn_s2d in f32, 2 epochs
of 2 minibatches (``torch_parity.one_ppo_update``).

Both start from the same weights (carried across by convert.py) and the same env
state. The port is handed the very draws the JAX update makes, rebuilt from the same
key splits (algos/ppo/ppo.py:374-375, algos/common.py:228-230): the Gumbel uniforms and
env reset draws of every rollout step, then the epoch permutations."""

import numpy as np
import pytest
from torch_parity import assert_update_metrics_match, assert_update_params_match, one_ppo_update

from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu_torch.envs.vec import VecMonitor


@pytest.fixture(scope="module")
def runs():
    return one_ppo_update()


def test_update_metrics_match_jax(runs):
    """Every metric to 1e-4 relative or 1e-6 absolute (see
    ``torch_parity.assert_update_metrics_match``)."""
    assert_update_metrics_match(runs["jmetrics"], runs["tmetrics"])


def test_update_params_match_jax(runs):
    """Each param tensor's change over the update to 2e-4 of that change (see
    ``torch_parity.assert_update_params_match``)."""
    assert_update_params_match(runs["jnew"].params, runs["tpol"], runs["start"])


def test_update_env_state_matches_jax(runs):
    """The rollout leaves the envs where the JAX rollout leaves them, bit for bit."""
    jnew, tnew = runs["jnew"], runs["tnew"]
    np.testing.assert_array_equal(tnew.obs.numpy(), np.asarray(jnew.obs))
    js, ts = JaxVecMonitor.get_stats(jnew.env_state), VecMonitor.get_stats(tnew.env_state)
    np.testing.assert_array_equal(ts.ep_return.numpy(), np.asarray(js.ep_return))
    np.testing.assert_array_equal(ts.ep_length.numpy(), np.asarray(js.ep_length))
    assert tnew.update_idx == int(jnew.update_idx) == 1
