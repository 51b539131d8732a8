"""ppo2's ``learn`` takes every keyword of the JAX package's ``learn``
(baselines_tpu/algos/ppo/ppo.py:399-428).

The two options ``clip_value=False`` (ppo1's plain value MSE) and ``adv_norm="batch"``
(advantages standardized once over the whole batch) run one full update against the
JAX update with the same draws, as tests/test_torch_update.py does for the defaults;
``value_network="copy"`` and ``microbatch_size`` run here and are held to the JAX update
in tests/test_torch_ppo_variants.py; ``save_interval`` and ``load_path`` write and read
checkpoints. ``pipeline`` and ``mesh`` raise ``NotImplementedError`` naming the
ROADMAP.md item that brings them, instead of falling into the network's keywords.

Each option must also change the update on these inputs, so that the comparison with
JAX can tell a port that honours it from one that ignores it: ``clip_value=False``
changes the value loss, ``adv_norm="batch"`` the policy loss."""

import pytest
import torch
from torch_parity import assert_update_metrics_match, assert_update_params_match, one_ppo_update

from baselines_tpu_torch.algos.ppo.ppo import learn
from baselines_tpu_torch.core import logger


OPTIONS = {"clip_value_false": ({"clip_value": False}, "value_loss"),
           "adv_norm_batch": ({"adv_norm": "batch"}, "policy_loss")}


@pytest.fixture(scope="module", params=list(OPTIONS))
def option(request):
    return request.param


@pytest.fixture(scope="module")
def runs(option):
    return one_ppo_update(**OPTIONS[option][0])


@pytest.fixture(scope="module")
def default_runs():
    return one_ppo_update()


def test_option_changes_the_update(option, runs, default_runs):
    """The option's metric moves from the default update's by more than ten times the
    tolerance the JAX comparison allows, on both sides."""
    metric = OPTIONS[option][1]
    for side in ("jmetrics", "tmetrics"):
        got, default = float(runs[side][metric]), float(default_runs[side][metric])
        assert abs(got - default) > 10 * (1e-6 + 1e-4 * abs(default)), (side, got, default)


def test_option_update_metrics_match_jax(runs):
    """Every metric to 1e-4 relative or 1e-6 absolute, as for the default update."""
    assert_update_metrics_match(runs["jmetrics"], runs["tmetrics"])


def test_option_update_params_match_jax(runs):
    """Each param tensor's change over the update to 2e-4 of that change, as for the
    default update."""
    assert_update_params_match(runs["jnew"].params, runs["tpol"], runs["start"])


@pytest.mark.parametrize("option", ["save_interval", "load_path"])
def test_checkpoint_keyword_works(tmp_path, option):
    """``save_interval=1`` writes the whole train state at every update into the log
    dir's checkpoints/; ``load_path`` starts from the params of a saved model."""
    kwargs = dict(env_id="CartPole-v1", num_envs=2, nsteps=8, nminibatches=2, noptepochs=1,
                  device="cpu", seed=0, log_interval=100)
    logger.configure(dir=str(tmp_path), format_strs=[])
    try:
        if option == "save_interval":
            model = learn(total_timesteps=2 * 16, save_interval=1, **kwargs)
            assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
                "00001", "00002"]
            assert torch.load(tmp_path / "checkpoints" / "00002",
                              weights_only=True)["state"]["update_idx"] == 2
        else:
            saved = learn(total_timesteps=16, **dict(kwargs, seed=1))
            saved.save(str(tmp_path / "model.pt"))
            model = learn(total_timesteps=0, load_path=str(tmp_path / "model.pt"), **kwargs)
            for p, q in zip(saved.policy.module.parameters(), model.policy.module.parameters()):
                assert torch.equal(p, q)
    finally:
        logger.reset()
    assert type(model.policy.module.network).__name__ == "MLP"  # the JAX default network


@pytest.mark.parametrize("kwargs,item", [
    ({"pipeline": True}, "item 8"),
    ({"mesh": object()}, "item 5"),
])
def test_unported_keyword_raises_not_implemented(kwargs, item):
    """Raised before any env or network is built, naming the Queue 1 item."""
    with pytest.raises(NotImplementedError, match=item):
        learn(env_id="AtariSim-v0", total_timesteps=0, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [{"value_network": "copy"}, {"microbatch_size": 64}],
                         ids=["value_network_copy", "microbatch_size"])
def test_item4_keyword_runs(kwargs):
    """The two keywords that raised until item 4 was ported run an update on CartPole-v1:
    ``value_network="copy"`` with a value tower of its own init beside the policy's
    network, ``microbatch_size=64`` as two microbatches of the 128-sample minibatch."""
    model = learn(env_id="CartPole-v1", num_envs=2, nsteps=64, nminibatches=1, noptepochs=1,
                  total_timesteps=128, device="cpu", seed=0, log_interval=100, **kwargs)
    assert model.state.update_idx == 1
    module = model.policy.module
    if "value_network" in kwargs:
        assert type(module.value_network).__name__ == "MLP"
        assert not torch.equal(module.value_network.mlp_fc0.weight, module.network.mlp_fc0.weight)
    else:
        assert module.value_network is None


def test_reference_defaults_are_accepted():
    """The JAX package's default values of those keywords run: no update at
    total_timesteps=0, but the env, the policy and the update are built."""
    model = learn(env_id="AtariSim-v0", env_kwargs={"s2d": 4}, num_envs=2, nsteps=4,
                  total_timesteps=0, device="cpu", seed=0, save_interval=0, load_path=None,
                  value_network="shared", microbatch_size=None, pipeline=None, mesh=None,
                  adv_norm="minibatch", clip_value=True)
    assert model.state.update_idx == 0
