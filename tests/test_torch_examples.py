"""The port's examples against the JAX package's on the CPU: ``my_tiny_net`` against the
JAX ``MyTinyNet`` with the params carried by ``convert.network_state_dict``, one ppo2
update on it against the JAX update (``torch_parity.one_ppo_update``, the same draws on
both sides), each example's ``learn`` keywords against those the JAX example's ``main``
passes, and the examples end to end at a cut depth: train_cartpole trains and saves,
enjoy_cartpole loads, evaluates (the same report as the trained model) and writes its
video; custom_network trains ppo2 on the registered network.
"""

import os

import jax
import numpy as np
import pytest
import torch
from torch_parity import (assert_update_metrics_match, assert_update_params_match,
                          one_ppo_update)

from baselines_tpu.examples import custom_network as jax_custom_network
from baselines_tpu.examples import enjoy_cartpole as jax_enjoy_cartpole
from baselines_tpu.examples import train_cartpole as jax_train_cartpole
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import build_env, evaluate
from baselines_tpu_torch.algos.dqn.dqn import learn as dqn_learn
from baselines_tpu_torch.algos.ppo.ppo import learn as ppo_learn
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.envs.registry import make_env
from baselines_tpu_torch.envs.video import record_video
from baselines_tpu_torch.examples import custom_network, enjoy_cartpole, train_cartpole
from baselines_tpu_torch.nn.networks import get_network


@pytest.fixture(autouse=True)
def quiet_logger():
    logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[])
    yield
    logger.reset()


@pytest.mark.parametrize("shape", [(4,), (2, 3)])
@pytest.mark.parametrize("width", [32, 64])
def test_my_tiny_net_matches_jax(shape, width):
    """The registered ``my_tiny_net`` built by name, with flax's init of the JAX
    ``MyTinyNet`` carried across, gives the JAX latents to 1e-6 (f32 sums in another
    order); both start from flax's Dense init, lecun_normal with zero biases."""
    rng = np.random.RandomState(width + len(shape))
    x = rng.randn(16, *shape).astype(np.float32) * 3
    jnet = jax_custom_network.MyTinyNet(width=width)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(width), x)
    want = np.asarray(jnet.apply(params, x))
    net = get_network("my_tiny_net", ob_shape=shape, width=width,
                      generator=torch.Generator().manual_seed(0))
    assert isinstance(net, custom_network.MyTinyNet)
    assert net.latent_size == width and net.is_recurrent is False
    assert [n for n, _ in net.named_parameters()] == [
        "Dense_0.weight", "Dense_0.bias", "Dense_1.weight", "Dense_1.bias"]
    # the port's own init: lecun_normal's spread, zero biases
    w0 = net.Dense_0.weight.detach().numpy()
    assert abs(w0.std() * np.sqrt(np.prod(shape)) - 1.0) < 0.25
    assert float(net.Dense_0.bias.detach().abs().sum()) == 0.0
    net.load_state_dict(convert.network_state_dict(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (16, width) and (want > 0).mean() > 0.2
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_one_ppo_update_on_my_tiny_net_matches_jax():
    """One ppo2 update on CartPole-v1 with ``network="my_tiny_net"`` at the example's
    width, from the same weights (flax's init moved by noise) with the same draws on both
    sides, held to torch_parity's bounds."""
    r = one_ppo_update("CartPole-v1", network="my_tiny_net", network_kwargs={"width": 64})
    assert isinstance(r["tpol"].module.network, custom_network.MyTinyNet)
    assert_update_metrics_match(r["jmetrics"], r["tmetrics"])
    assert_update_params_match(r["jnew"].params, r["tpol"], r["start"])


class _Captured(Exception):
    pass


def _jax_learn_kwargs(monkeypatch, module) -> dict:
    """The keywords the JAX example's ``main`` passes to ``learn`` (which is stopped
    there, before any training)."""
    seen = {}

    def learn(**kwargs):
        seen.update(kwargs)
        raise _Captured

    monkeypatch.setattr(module, "learn", learn)
    if hasattr(module, "logger"):
        monkeypatch.setattr(module.logger, "configure", lambda *a, **k: None)
    with pytest.raises(_Captured):
        module.main()
    return seen


@pytest.mark.parametrize("name", ["train_cartpole", "enjoy_cartpole", "custom_network"])
def test_example_keywords_match_jax(monkeypatch, name):
    """Each example's ``learn`` keywords are the JAX example's, but for the model file's
    name (a torch file in place of msgpack)."""
    port, ref = {"train_cartpole": (train_cartpole.LEARN_KWARGS, jax_train_cartpole),
                 "enjoy_cartpole": (enjoy_cartpole.LOAD_KWARGS, jax_enjoy_cartpole),
                 "custom_network": (custom_network.LEARN_KWARGS, jax_custom_network)}[name]
    want = _jax_learn_kwargs(monkeypatch, ref)
    if name == "enjoy_cartpole":
        assert want.pop("load_path") == "cartpole_model.msgpack"
        port = dict(port)
        assert port.pop("load_path") == train_cartpole.MODEL_PATH == "cartpole_model.pt"
    assert port == want


def test_train_then_enjoy_cartpole_end_to_end(tmp_path):
    """train_cartpole's configuration at a cut depth (one chunk of 1024 steps, 24 of them
    past learning_starts) on the CPU, saved; then enjoy_cartpole's steps on that file:
    load, evaluate 1000 steps (the trained model's report bit for bit, the params bit for
    bit) and write the video."""
    model = dqn_learn(**dict(train_cartpole.LEARN_KWARGS, total_timesteps=1024,
                             device="cpu"))
    assert model.state.t == 1024
    path = str(tmp_path / train_cartpole.MODEL_PATH)
    model.save(path)

    def report(m):
        return evaluate(m, build_env("CartPole-v1", 4, device=m.device), Draws(0, m.device),
                        nsteps=enjoy_cartpole.EVAL_STEPS)

    loaded = dqn_learn(**dict(enjoy_cartpole.LOAD_KWARGS, load_path=path, device="cpu"))
    assert loaded.state.t == 0
    for a, b in zip(model.policy.module.parameters(), loaded.policy.module.parameters()):
        assert torch.equal(a, b)
    trained, replayed = report(model), report(loaded)
    assert trained == replayed and trained[2] > 0 and np.isfinite(trained[0])
    video = str(tmp_path / enjoy_cartpole.VIDEO_PATH)
    assert record_video(loaded, make_env("CartPole-v1"), video, video_length=40) == video
    assert os.path.getsize(video) > 0


def test_custom_network_end_to_end():
    """custom_network's configuration at a cut depth (2 updates of 8 envs x 128 steps) on
    the CPU: ppo2 trains the registered network, logs finite losses, and its params
    move."""
    rows = []

    class Recording(logger.KVWriter):
        def writekvs(self, kvs):
            rows.append(dict(kvs))

    logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[Recording()])
    torch.manual_seed(0)
    model = ppo_learn(**dict(custom_network.LEARN_KWARGS, total_timesteps=2048, seed=0,
                             log_interval=1, device="cpu"))
    net = model.policy.module.network
    assert isinstance(net, custom_network.MyTinyNet) and net.latent_size == 64
    assert len(rows) == 2 and rows[-1]["misc/total_timesteps"] == 2048
    for key in ("loss/policy_loss", "loss/value_loss", "loss/approxkl"):
        assert all(np.isfinite(float(r[key])) for r in rows), key
    fresh = get_network("my_tiny_net", ob_shape=(4,), width=64,
                        generator=torch.Generator().manual_seed(0))
    assert not torch.equal(fresh.Dense_0.weight, net.Dense_0.weight)
    assert all(bool(torch.isfinite(p).all()) for p in model.policy.module.parameters())
