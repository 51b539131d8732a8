"""The names of the JAX package's public API that the port gained last, each against the
JAX function on the CPU: MultiBinary observations, the constructors that default to
the card, the spaces' ``sample`` and ``Box.bounded``, the logger's ``logkvs``, levels
and timers, ``discount`` and ``affine_reverse_scan``, the ``Pd`` base with ``logp``,
``save_params``/``load_params``, ``Model.params`` (her's and ddpg's too), the
Q-policy's generic surface, and the native engine's ``available``/``supports``.

JAX draws with threefry keys and the port with a torch.Generator, so a space's sample
is compared where the JAX package maps uniforms to values: the port is handed the
uniforms (or normals) that JAX drew from the same key, and must give the same sample
bit for bit. Discrete's integers are checked by their range over many draws.
"""

import csv
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import ReplayDraws
from torch_parity import move_params, rel_err

import baselines_tpu.native as jax_native
from baselines_tpu.algos.common import Model as JaxModel
from baselines_tpu.algos.dqn import dqn as jdqn
from baselines_tpu.core import checkpoint as jax_ckpt
from baselines_tpu.core import logger as jax_logger
from baselines_tpu.core.math import discount as jax_discount
from baselines_tpu.data.gae import affine_reverse_scan as jax_affine_reverse_scan
from baselines_tpu.envs import spaces as jspaces
from baselines_tpu.nn import networks as jax_networks
from baselines_tpu.nn.distributions import make_pdtype as jax_make_pdtype
from baselines_tpu.nn.policy import build_policy as jax_build_policy
import baselines_tpu_torch.native as native
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import Model
from baselines_tpu_torch.algos.ddpg.ddpg import DDPGModel
from baselines_tpu_torch.algos.dqn import dqn
from baselines_tpu_torch.algos.gail import gail
from baselines_tpu_torch.algos.gail.dataset import ExpertDataset
from baselines_tpu_torch.algos.her.her import HERModel
from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.math import discount
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.core.running_stats import RunningMeanStd
from baselines_tpu_torch.data.gae import affine_reverse_scan
from baselines_tpu_torch.envs import spaces
from baselines_tpu_torch.nn import networks
from baselines_tpu_torch.nn.distributions import Pd, make_pdtype
from baselines_tpu_torch.nn.policy import build_policy


def test_multibinary_observations_match_jax():
    """mlp on MultiBinary(16) observations with Discrete(4) actions, the JAX params
    carried across by convert.py: latent, logits and value to 1e-5 relative (the
    largest difference over the largest magnitude, as the other parity tests measure
    it: f32 products sum in another order), and the neglogp of the same actions; the
    port steps on them."""
    jpol = jax_build_policy(jspaces.MultiBinary(16), jspaces.Discrete(4), "mlp")
    obs = np.random.RandomState(0).randint(0, 2, (32, 16)).astype(np.int32)
    params = move_params(jpol.init(jax.random.PRNGKey(0), jnp.asarray(obs)), 1)
    tpol = build_policy(spaces.MultiBinary(16), spaces.Discrete(4), "mlp", device="cpu")
    tpol.module.load_state_dict(convert.policy_state_dict(params))

    want_latent = jpol.module.network.apply(
        {"params": params["params"]["network"]}, jnp.asarray(obs))
    want_logits, want_vf, _ = jpol.apply(params, jnp.asarray(obs))
    x = torch.from_numpy(obs)
    with torch.no_grad():
        latent = tpol.module.network(x)
        logits, vf, _ = tpol.module(x)
    for got, want in ((latent, want_latent), (logits, want_logits), (vf, want_vf)):
        assert got.shape == np.shape(want) and rel_err(got.numpy(), want) < 1e-5
    actions = np.random.RandomState(2).randint(0, 4, (32,)).astype(np.int32)
    want_neglogp = jpol.pdtype.pdfromflat(want_logits).neglogp(jnp.asarray(actions))
    got_neglogp = tpol.pdtype.pdfromflat(logits).neglogp(torch.from_numpy(actions))
    assert rel_err(got_neglogp.numpy(), want_neglogp) < 1e-5
    action, value, neglogp = tpol.step(x, Draws(0, "cpu"))
    assert action.shape == (32,) and value.shape == (32,) and neglogp.shape == (32,)


def test_constructors_default_to_the_card():
    """ExpertDataset, RunningMeanStd.create and RecurrentNetwork.initial_state with no
    device put their tensors on the card: here, without one, they raise as every entry
    point does; with "cpu" they are on the CPU."""
    lstm = networks.get_network("lstm", ob_shape=(3,), nlstm=4)
    obs = np.zeros((5, 3), np.float32)
    made = {
        "ExpertDataset": lambda **kw: ExpertDataset(obs=obs, acs=obs, **kw).obs,
        "RunningMeanStd.create": lambda **kw: RunningMeanStd.create((3,), **kw).mean,
        "RecurrentNetwork.initial_state": lambda **kw: lstm.initial_state(2, **kw),
    }
    for what, make in made.items():
        assert make(device="cpu").device.type == "cpu", what
        if torch.cuda.is_available():
            assert make().device.type == "cuda", what
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_expert_dataset_from_a_file_drives_gail_on_the_cpu(tmp_path):
    """An ExpertDataset read from an expert .npz with device="cpu" drives
    gail.learn(device="cpu") for one iteration: its rows are the file's, as the JAX
    package reads them, and one expert sample of the batch is taken."""
    expert = np.random.RandomState(0).uniform(-1, 1, size=(2, 100, 1)).astype(np.float32)
    path = os.fspath(tmp_path / "expert.npz")
    np.savez(path, obs=expert, acs=expert.copy())
    from baselines_tpu.algos.gail.dataset import ExpertDataset as JaxExpertDataset

    dataset = ExpertDataset(expert_path=path, device="cpu")
    want = JaxExpertDataset(expert_path=path)
    np.testing.assert_array_equal(dataset.obs.numpy(), np.asarray(want.obs))
    assert dataset.obs.device.type == "cpu" and dataset.n == 200
    model = gail.learn(env_id="BoxIdentity-v0", expert_dataset=dataset, seed=0, num_envs=4,
                       timesteps_per_batch=64, total_timesteps=64, g_step=1, d_step=1,
                       num_hidden=8, adversary_hidden_size=8, vf_iters=1, cg_iters=2,
                       log_interval=0, device="cpu")
    assert model.state.iters == 1
    assert all(bool(torch.isfinite(p).all()) for p in model.params.values())


SPACE_PAIRS = {
    "box": (lambda m: m.Box(np.array([-1.0, 0.0, -3.0]), np.array([1.0, 2.0, 5.0])),
            [("uniform", (3,))]),
    "box_u8": (lambda m: m.Box(0, 255, (2, 3), np.uint8), [("uniform", (2, 3))]),
    "box_unbounded": (lambda m: m.Box(-np.inf, np.inf, (4,)), [("normal", (4,))]),
    "multi_discrete": (lambda m: m.MultiDiscrete([3, 7, 2]), [("uniform", (3,))]),
    "multi_binary": (lambda m: m.MultiBinary(9), [("uniform", (9,))]),
    "dict": (lambda m: m.DictSpace({"z": m.MultiBinary(2), "a": m.Box(-2.0, 2.0, (2,))}),
             [("uniform", (2,)), ("uniform", (2,))]),
}


@pytest.mark.parametrize("name", sorted(SPACE_PAIRS))
def test_space_sample_maps_jax_draws_alike(name):
    """Handed the uniforms (normals for an unbounded Box) that the JAX package draws from
    a key, the port's sample is the JAX package's from that key, bit for bit, in its
    dtype; a DictSpace draws its sub-spaces in sorted key order from the key's splits."""
    make, draws = SPACE_PAIRS[name]
    jspace, tspace = make(jspaces), make(spaces)
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        keys = jax.random.split(key, len(draws)) if name == "dict" else [key]
        fake = ReplayDraws()
        for (kind, shape), k in zip(draws, keys):
            fake.push(kind, getattr(jax.random, kind)(k, shape))
        want, got = jspace.sample(key), tspace.sample(fake)
        assert not fake.queue
        if name == "dict":
            assert list(got) == sorted(jspace.spaces) == list(want)
            pairs = [(got[k], want[k]) for k in want]
        else:
            pairs = [(got, want)]
        for g, w in pairs:
            assert g.dtype == spaces.torch_dtype(np.asarray(w).dtype)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert tspace.contains(got)


def test_space_samples_from_draws():
    """Over 2000 draws from a Draws: every sample is in its space, with the JAX
    package's shape and dtype, and each Discrete value and MultiBinary bit occurs;
    Box.bounded as the JAX package's."""
    draws = Draws(0, "cpu")
    for name, (make, _) in list(SPACE_PAIRS.items()) + [
            ("discrete", (lambda m: m.Discrete(5), None))]:
        jspace, tspace = make(jspaces), make(spaces)
        want = jspace.sample(jax.random.PRNGKey(0))
        samples = [tspace.sample(draws) for _ in range(2000)]
        assert all(tspace.contains(s) and jspace.contains(
            {k: v.numpy() for k, v in s.items()} if name == "dict" else s.numpy())
            for s in samples), name
        if name == "dict":
            assert all(list(s) == ["a", "z"] for s in samples)
            samples, want = [s["z"] for s in samples], want["z"]
        w = np.asarray(want)
        assert all(s.shape == w.shape and s.dtype == spaces.torch_dtype(w.dtype)
                   for s in samples), name
        if name in ("discrete", "multi_binary", "dict"):
            values = torch.stack(samples).unique().tolist()
            assert values == list(range(5 if name == "discrete" else 2)), name
        if isinstance(tspace, spaces.Box):
            assert tspace.bounded == jspace.bounded == (name != "box_unbounded")


def _log_calls(log, fns_doubled):
    log.logkvs({"b": 2.5, "a": 1, "name": "x"})
    log.debug("hidden at INFO")
    log.info("an", "info")
    log.warn("a warning")
    log.error("an error", 3)
    log.set_level(log.DEBUG)
    log.debug("debug shown")
    with log.profile_kv("block"):
        sum(range(1000))
    fns_doubled()
    fns_doubled()
    log.logkv_mean("m", 1.0)
    log.dumpkvs()
    log.logkvs({"a": 2})
    log.dumpkvs()


def _lines_without_timers(path: str, logdir: str):
    """log.txt's lines with the log dir named alike, table cells stripped of padding and
    the rules of dashes alike; the value of each wait_ key checked and left out."""
    out, timers = [], 0
    with open(path) as f:
        for line in f.read().splitlines():
            line = line.replace(logdir, "<dir>")
            if set(line) == {"-"}:
                line = "-"
            elif line.startswith("|"):
                key, value = (c.strip() for c in line.strip("|").split("|"))
                if key.startswith("wait_"):
                    assert float(value) >= 0, line
                    value, timers = "<s>", timers + 1
                line = f"{key}={value}"
            out.append(line)
    return out, timers


def test_logger_names_write_what_jax_writes(tmp_path):
    """The same calls through both loggers (logkvs, debug/info/warn/error and the levels,
    profile_kv and profile) give the same log.txt and progress.csv, but for the value of
    each wait_ timer, which is present and >= 0 on both sides."""
    out = {}
    for side, log in (("jax", jax_logger), ("port", logger)):
        d = os.fspath(tmp_path / side)
        log.configure(dir=d, format_strs=["log", "csv"])
        try:
            timed = log.profile("fn")(lambda: sum(range(1000)))
            _log_calls(log, timed)
        finally:
            log.reset()
        lines, timers = _lines_without_timers(os.path.join(d, "log.txt"), d)
        with open(os.path.join(d, "progress.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        for row in rows:
            for k in ("wait_block", "wait_fn"):
                assert row[k] == "" or float(row[k]) >= 0
                row[k] = row[k] != ""
        out[side] = (lines, timers, rows)
    assert out["port"] == out["jax"]
    lines, timers, rows = out["port"]
    assert timers == 2 and "debug shown" in lines and "hidden at INFO" not in lines
    assert rows[0]["wait_block"] and rows[0]["wait_fn"] and not rows[1]["wait_fn"]


def test_discount_and_affine_reverse_scan_match_jax():
    """(T=128, N=8) f32 to rtol 1e-6: the JAX package sums by lax.scan (discount) and
    by an associative scan (affine_reverse_scan), the port step by step. The inputs are
    positive, so that no output sits near 0 where a relative tolerance says nothing."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, (128, 8)).astype(np.float32)
    coefs = rng.uniform(0, 0.99, (128, 8)).astype(np.float32)
    init = rng.uniform(0, 1, (8,)).astype(np.float32)
    for gamma in (0.99, 0.5):
        got = discount(torch.from_numpy(x), gamma)
        assert got.dtype == torch.float32 and got.shape == (128, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_discount(jnp.asarray(x), gamma)),
                                   rtol=1e-6)
    np.testing.assert_allclose(discount(x.astype(np.float64), 0.9).numpy(),
                               np.asarray(jax_discount(x.astype(np.float64), 0.9)), rtol=1e-6)
    got = affine_reverse_scan(*map(torch.from_numpy, (coefs, x, init)))
    want = jax_affine_reverse_scan(*map(jnp.asarray, (coefs, x, init)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("space", ["Discrete", "MultiDiscrete", "Box", "MultiBinary"])
def test_pd_logp_matches_jax(space):
    """Every distribution is a Pd whose logp is -neglogp, to rtol 1e-6 of the JAX
    package's on the same flat parameters and samples."""
    rng = np.random.RandomState(0)
    made = {"Discrete": (lambda m: m.Discrete(5), lambda n: rng.randint(0, 5, n)),
            "MultiDiscrete": (lambda m: m.MultiDiscrete([3, 4]),
                              lambda n: np.stack([rng.randint(0, 3, n),
                                                  rng.randint(0, 4, n)], -1)),
            "Box": (lambda m: m.Box(-1.0, 1.0, (3,)), lambda n: rng.randn(n, 3)),
            "MultiBinary": (lambda m: m.MultiBinary(4), lambda n: rng.randint(0, 2, (n, 4)))}
    make, sample = made[space]
    jtype, ttype = jax_make_pdtype(make(jspaces)), make_pdtype(make(spaces))
    flat = rng.randn(64, jtype.param_size).astype(np.float32)
    x = sample(64).astype(np.float32 if space == "Box" else np.int32)
    pd = ttype.pdfromflat(torch.from_numpy(flat))
    assert isinstance(pd, Pd)
    want = jtype.pdfromflat(jnp.asarray(flat)).logp(jnp.asarray(x))
    got = pd.logp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert torch.equal(got, -pd.neglogp(torch.from_numpy(x)))


def _policy_pair(seed: int = 0):
    jpol = jax_build_policy(jspaces.Box(-1.0, 1.0, (4,)), jspaces.Discrete(2), "mlp")
    params = move_params(jpol.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4))), seed)
    tpol = build_policy(spaces.Box(-1.0, 1.0, (4,)), spaces.Discrete(2), "mlp", device="cpu")
    tpol.module.load_state_dict(convert.policy_state_dict(params))
    return jpol, params, tpol


def test_model_params_and_save_load_params_match_jax(tmp_path):
    """Model.params is the policy module's named parameters, the tensors that convert.py
    maps the JAX Model's params onto; save_params and load_params round trip them on
    both sides, a module loaded in place and a tree of tensors rebuilt."""
    jpol, params, tpol = _policy_pair()
    jmodel = JaxModel(jpol, SimpleNamespace(params=params))
    model = Model(tpol, None)
    want = convert.policy_state_dict(jax.tree_util.tree_map(np.asarray, jmodel.params))
    got = model.params
    assert got.keys() == want.keys() == dict(tpol.module.named_parameters()).keys()
    assert all(got[k] is p for k, p in tpol.module.named_parameters())
    for k in want:
        np.testing.assert_array_equal(got[k].detach().numpy(), want[k].numpy())

    jpath, path = os.fspath(tmp_path / "jax.msgpack"), os.fspath(tmp_path / "port.pt")
    jax_ckpt.save_params(jpath, jmodel.params)
    jloaded = jax_ckpt.load_params(jpath, jax.tree_util.tree_map(jnp.zeros_like, params))
    ckpt.save_params(path, model.params)
    _, _, fresh = _policy_pair(seed=5)
    assert ckpt.load_params(path, fresh.module) is fresh.module
    back = ckpt.load_params(path, {k: torch.zeros_like(v) for k, v in model.params.items()})
    want = convert.policy_state_dict(jax.tree_util.tree_map(np.asarray, jloaded))
    for k, p in fresh.module.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[k].numpy())
        np.testing.assert_array_equal(back[k].numpy(), want[k].numpy())


def test_her_and_ddpg_model_params():
    """HERModel.params holds the actor's parameters and both normalizers, as
    her.py:509-516's; DDPGModel.params the actor's, the critic's and both running
    statistics, as ddpg.py:412-420's."""
    actor, critic = torch.nn.Linear(3, 2), torch.nn.Linear(5, 1)
    rms = [RunningMeanStd.create((3,), device="cpu") for _ in range(2)]
    her = HERModel(SimpleNamespace(module=actor), SimpleNamespace(o_rms=rms[0], g_rms=rms[1]))
    assert list(her.params) == ["actor", "o_rms", "g_rms"]
    assert her.params["actor"] == dict(actor.named_parameters())
    assert her.params["o_rms"] is rms[0] and her.params["g_rms"] is rms[1]
    ddpg = DDPGModel(SimpleNamespace(module=actor, critic=critic),
                     SimpleNamespace(obs_rms=rms[0], ret_rms=rms[1]))
    assert list(ddpg.params) == ["actor", "critic", "obs_rms", "ret_rms"]
    assert ddpg.params["critic"] == dict(critic.named_parameters())
    assert ddpg.params["obs_rms"] is rms[0] and ddpg.params["ret_rms"] is rms[1]


def test_q_policy_generic_surface_matches_jax():
    """The Q-policy's initial_state is None, and step, mode_step and value take a carry
    and a mask and ignore them, as dqn.py:103,122-130's; mode_step and value to rtol
    1e-5 relative (largest difference over largest magnitude) of the JAX package's from
    the same params."""
    jmod = jdqn.QNet(network=jax_networks.get_network("mlp"), n_actions=3)
    obs = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    params = move_params(jmod.init(jax.random.PRNGKey(0), jnp.asarray(obs)), 0)
    jpol = jdqn.QPolicy(jmod, jspaces.Box(-5.0, 5.0, (4,)), 3)
    tmod = dqn.QNet(networks.get_network("mlp", ob_shape=(4,)), 3)
    tmod.load_state_dict(convert.q_state_dict(params))
    tpol = dqn.QPolicy(tmod, spaces.Box(-5.0, 5.0, (4,)), 3)
    assert tpol.initial_state(8) is None and jpol.initial_state(8) is None
    assert tpol.is_recurrent is False
    x, carry, mask = torch.from_numpy(obs), torch.ones((8, 6)), torch.ones(8)
    action, q = tpol.mode_step(x, None, carry, mask)
    jaction, jq, _ = jpol.mode_step(params, jnp.asarray(obs), None, jnp.ones(8))
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
    assert rel_err(q.numpy(), jq) < 1e-5
    assert rel_err(tpol.value(x, None, carry, mask).numpy(),
                   jpol.value(params, jnp.asarray(obs), None, None)) < 1e-5
    draws = ReplayDraws([("randint", np.zeros(8)), ("uniform", np.ones(8))])
    got = tpol.step(x, draws, None, carry, mask)
    assert torch.equal(got[0], action) and got[1:] == (None, None) and not draws.queue


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Acrobot-v1", "native:CartPole-v1",
                                    "HalfCheetah-v4", "AtariSim-v0"])
def test_native_available_and_supports_match_jax(env_id):
    """Both engines build here: the two answer alike for each id."""
    assert native.available() is jax_native.available() is True
    assert native.supports(env_id) is jax_native.supports(env_id)


def test_native_available_is_a_query(monkeypatch, tmp_path):
    """Where the engine cannot be built, available() and supports() say so, and building
    a pool still raises with the compiler's error: no path falls back on the answer."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", os.fspath(tmp_path / "no-such-compiler"))
    assert native.available() is False and native.supports("CartPole-v1") is False
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.NativeVecEnv("CartPole-v1", 2)
