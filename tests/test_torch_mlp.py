"""The port's ``mlp`` and Nature ``cnn`` networks, its mlp policy and QNet, and the
learners on CartPole-v1 with ``mlp``, against the JAX package's on the CPU.

- The networks take the JAX package's params through convert.py and agree to 1e-5
  relative in f32 (sums in another order), to 2e-2 in bf16.
- One ppo2 update on CartPole-v1 (``torch_parity.one_ppo_update``) and one deepq
  training iteration are held to the JAX learner with its own draws injected, at the
  tolerances of tests/torch_parity.py: the envs' states after several steps to 1e-4
  relative / 1e-6 absolute, since torch's sin/cos differ from XLA's by an ulp."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ROLLOUT_ATOL, ROLLOUT_RTOL, THRESHOLD_MARGIN, RecordStates,
                          ReplayDraws, assert_update_metrics_match, assert_update_params_match,
                          mlp_policy_params, one_ppo_update, push_env_step, push_reset, rel_err)

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.common import jit_init
from baselines_tpu.algos.dqn import dqn as jdqn
from baselines_tpu.envs.registry import make_env as jax_make_env
from baselines_tpu.envs.spaces import Box as JaxBox, Discrete as JaxDiscrete
from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu.nn.networks import MLP as JaxMLP, NatureCNN as JaxNatureCNN
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import ClipAdam, build_env
from baselines_tpu_torch.algos.dqn import dqn
from baselines_tpu_torch.core.schedules import LinearSchedule
from baselines_tpu_torch.data.replay import ReplayBuffer
from baselines_tpu_torch.envs.spaces import Box, Discrete
from baselines_tpu_torch.envs.vec import VecMonitor
from baselines_tpu_torch.nn.networks import MLP, NatureCNN, get_network
from baselines_tpu_torch.nn.policy import build_policy


def _mlp_params(seed, ob_dim, layer_norm, num_layers=2, num_hidden=64):
    return {"params": mlp_policy_params(seed, ob_dim, 2, num_layers, num_hidden,
                                        layer_norm)["params"]["network"]}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("layer_norm", [False, True], ids=["no_ln", "ln"])
def test_mlp_through_convert(layer_norm, dtype, tol):
    """(16, 3, 4) inputs flattened to 12, two layers of 64, tanh: f32 to 1e-5 relative,
    bf16 to 2e-2; the latent comes back in f32."""
    x = np.random.RandomState(0).randn(16, 3, 4).astype(np.float32)
    params = _mlp_params(1, 12, layer_norm)
    jnet = JaxMLP(layer_norm=layer_norm, dtype=getattr(jnp, dtype))
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    net = get_network("mlp", ob_shape=(3, 4), layer_norm=layer_norm, dtype=dtype)
    net.load_state_dict(convert.network_state_dict(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (16, 64)
    assert net.latent_size == 64
    assert rel_err(got, want) < tol


@pytest.mark.parametrize("num_layers,num_hidden,activation", [(1, 32, "relu"), (3, 16, "tanh")])
def test_mlp_keywords_match_jax(num_layers, num_hidden, activation):
    """The JAX keyword names ``num_layers``, ``num_hidden`` and ``activation``."""
    x = np.random.RandomState(2).randn(8, 5).astype(np.float32)
    params = _mlp_params(3, 5, False, num_layers, num_hidden)
    jnet = JaxMLP(num_layers=num_layers, num_hidden=num_hidden,
                  activation=getattr(jax.nn, activation))
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    net = MLP(ob_shape=(5,), num_layers=num_layers, num_hidden=num_hidden,
              activation=getattr(torch, activation))
    net.load_state_dict(convert.network_state_dict(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert net.latent_size == num_hidden
    assert rel_err(got, want) < 1e-5


def test_nature_cnn_through_convert():
    """The Nature CNN on unpacked 84x84x4 u8 frames, f32, to 1e-5 relative; the dense
    layer reads the conv output in NHWC order on both sides."""
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (4, 84, 84, 4)).astype(np.uint8)

    def layer(shape):
        return {"kernel": (rng.randn(*shape) * np.sqrt(2) / np.sqrt(np.prod(shape[:-1])))
                .astype(np.float32), "bias": (rng.randn(shape[-1]) * 0.01).astype(np.float32)}

    params = {"params": {"c1": layer((8, 8, 4, 32)), "c2": layer((4, 4, 32, 64)),
                         "c3": layer((3, 3, 64, 64)), "fc1": layer((3136, 512))}}
    want = np.asarray(jax.jit(JaxNatureCNN().apply)(params, jnp.asarray(frames)))
    net = NatureCNN()
    net.load_state_dict(convert.network_state_dict(params))
    with torch.no_grad():
        got = net(torch.from_numpy(frames))
    assert got.shape == (4, 512) and net.latent_size == 512
    assert rel_err(got, want) < 1e-5
    assert (want > 0).mean() > 0.1


def test_unported_networks_raise():
    """No network name of the JAX package is left unported: the names that raised
    ``NotImplementedError`` until item 4 build (each is held to the JAX network in
    tests/test_torch_networks.py); a name the JAX package does not know raises
    ``ValueError``, as the JAX package's registry does."""
    for name in ("cnn_small", "impala_cnn", "conv_only", "lstm", "cnn_lstm"):
        net = get_network(name, ob_shape=(36, 36, 1))
        assert net.latent_size > 0
    with pytest.raises(ValueError, match="unknown network 'no_such_net'"):
        get_network("no_such_net")


def test_mlp_policy_mode_step_matches_jax():
    """``mode_step``: the argmax action and the value of the JAX policy's, to 1e-5, on a
    Box(4) observation; a tie picks the first maximal action, as ``jnp.argmax``."""
    obs = np.random.RandomState(5).randn(32, 4).astype(np.float32)
    params = mlp_policy_params(6, 4, 3)
    params["params"]["pi"]["kernel"] = params["params"]["pi"]["kernel"] * 100
    jpol = jax_build_policy(JaxBox(-10, 10, (4,)), JaxDiscrete(3), "mlp")
    tpol = build_policy(Box(-10, 10, (4,)), Discrete(3), "mlp", device="cpu")
    tpol.module.load_state_dict(convert.policy_state_dict(params))
    jaction, jvalue, _ = jpol.mode_step(params, jnp.asarray(obs))
    action, value = tpol.mode_step(torch.from_numpy(obs))
    assert action.dtype == torch.int32
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
    assert rel_err(value, jvalue) < 1e-5
    # equal logits: the first action
    with torch.no_grad():
        tpol.module.pi.weight.zero_()
        tpol.module.pi.bias.copy_(torch.tensor([0.5, 0.5, 0.5]))
    assert not tpol.mode_step(torch.from_numpy(obs))[0].any()


@pytest.fixture(scope="module")
def ppo_runs():
    return one_ppo_update("CartPole-v1")


def test_cartpole_ppo_update_matches_jax(ppo_runs):
    """One ppo2 update on CartPole-v1 with mlp: every metric to 1e-4 relative or 1e-6
    absolute, each param's change to 2e-4 of that change, the envs' final obs to 1e-4
    relative / 1e-6 absolute and the episode counts equal; no state of the rollout came
    within 1e-5 of a termination threshold, so no done flag could flip unseen."""
    r = ppo_runs
    assert r["recorder"].min_margin() > THRESHOLD_MARGIN
    assert_update_metrics_match(r["jmetrics"], r["tmetrics"])
    assert_update_params_match(r["jnew"].params, r["tpol"], r["start"])
    jnew, tnew = r["jnew"], r["tnew"]
    np.testing.assert_allclose(tnew.obs.numpy(), np.asarray(jnew.obs), rtol=ROLLOUT_RTOL,
                               atol=ROLLOUT_ATOL)
    np.testing.assert_array_equal(tnew.last_done.numpy(), np.asarray(jnew.last_done))
    js, ts = JaxVecMonitor.get_stats(jnew.env_state), VecMonitor.get_stats(tnew.env_state)
    assert int(ts.episodes) == int(js.episodes) > 0
    np.testing.assert_array_equal(ts.ep_length.numpy(), np.asarray(js.ep_length))
    np.testing.assert_array_equal(tnew.env_state.inner.t.numpy(),
                                  np.asarray(jnew.env_state.inner[1]))
    assert tnew.update_idx == int(jnew.update_idx) == 1


# --- one deepq training iteration on CartPole-v1 with mlp ----------------------------

NENVS, BUFFER, BATCH, ITERS = 4, 64, 8, 2
HPARAMS = dict(lr=1e-3, batch_size=BATCH, learning_starts=8, train_freq=4, gamma=0.99,
               target_network_update_freq=8, prioritized_replay=False,
               prioritized_replay_eps=1e-6, double_q=True)
LEARN = dict(env_id="CartPole-v1", network="mlp", seed=0, num_envs=NENVS,
             buffer_size=BUFFER, exploration_fraction=0.5, exploration_final_eps=0.1,
             chunk_size=1, print_freq=0, checkpoint_freq=None, **HPARAMS)


@pytest.fixture(scope="module")
def dqn_runs():
    """JAX: one learn of ITERS iterations, the second of which trains (t = 8) and syncs
    the target net; its initial state taken from ``jit_init``. The port: the same
    initial state, then ITERS calls of its iteration function with the JAX learner's
    draws (dqn.py:230, :116; the uniform replay's sample, replay.py:58-62)."""
    total = NENVS * ITERS
    starts = []

    def recording_jit_init(make_state, key):
        state = jit_init(make_state, key)
        starts.append(jax.device_get((state.params, state.obs)))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", recording_jit_init)
        jend = jdqn.learn(total_timesteps=total, **LEARN).state
    (jstart_params, jstart_obs), = starts

    base = jax_make_env("CartPole-v1")
    draws = ReplayDraws()
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    push_reset(draws, base, kreset, NENVS)
    for i in range(ITERS):
        key, kact, kstep, ksample, _ = jax.random.split(key, 5)
        ku, kr = jax.random.split(kact)
        draws.push("randint", jax.random.randint(kr, (NENVS,), 0, 2, jnp.int32))
        draws.push("uniform", jax.random.uniform(ku, (NENVS,)))
        push_env_step(draws, base, kstep, NENVS)
        t = NENVS * (i + 1)
        if t >= HPARAMS["learning_starts"]:
            draws.push("randint", jax.random.randint(ksample, (BATCH,), 0, min(t, BUFFER)))

    venv = build_env("CartPole-v1", NENVS, device="cpu")
    recorder = RecordStates(venv.venv.env)
    venv.venv.env = recorder
    qnet = dqn.QNet(MLP(ob_shape=(4,)), 2)
    start = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jstart_params))
    qnet.load_state_dict(start)
    policy = dqn.QPolicy(qnet, venv.observation_space, 2)
    opt = ClipAdam(qnet.parameters(), 10.0, eps=1e-5)
    rb = ReplayBuffer(BUFFER)
    obs, env_state = venv.reset(draws)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jstart_obs))
    item = {"obs": obs[0], "action": torch.zeros((), dtype=torch.int32),
            "reward": torch.zeros(()), "next_obs": obs[0], "done": torch.zeros(())}
    state = dqn.DQNTrainState(target=copy.deepcopy(qnet), env_state=env_state, obs=obs,
                              replay=rb.init(item))
    iteration = dqn.make_iteration_fn(
        policy, venv, rb, opt, exploration=LinearSchedule(int(0.5 * total), 0.1, 1.0),
        beta_schedule=LinearSchedule(total, 1.0, 0.4), **HPARAMS)
    infos = []
    for _ in range(ITERS):
        state, info = iteration(state, draws)
        infos.append(info)
    assert not draws.queue, "the port took fewer draws than the JAX learner made"
    return dict(jend=jend, tend=state, infos=infos, policy=policy, start=start,
                recorder=recorder)


def test_cartpole_deepq_iteration_matches_jax(dqn_runs):
    """After the iterations: t, the target syncs and the ring cursor equal; the stored
    actions, rewards and dones equal and the stored observations to 1e-4 relative /
    1e-6 absolute; the training iteration's loss to 1e-5 relative; each param's change
    to 1e-3 of that change in norm; the target net equal to the online net after the
    sync at t = 8. No state came within 1e-5 of a termination threshold."""
    r = dqn_runs
    jend, tend = r["jend"], r["tend"]
    assert r["recorder"].min_margin() > THRESHOLD_MARGIN
    assert [bool(i) for i in r["infos"]] == [False, True]
    assert tend.t == int(jend.t) == NENVS * ITERS
    assert tend.n_target_syncs == int(jend.n_target_syncs) == 1
    jrep, trep = jend.replay, tend.replay
    assert (trep.ptr, trep.size) == (int(jrep.ptr), int(jrep.size)) == (8, 8)
    for k, v in jrep.data.items():
        if k in ("obs", "next_obs"):
            np.testing.assert_allclose(trep.data[k].numpy(), np.asarray(v), rtol=ROLLOUT_RTOL,
                                       atol=ROLLOUT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(trep.data[k].numpy(), np.asarray(v), err_msg=k)
    want = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jend.params))
    got = r["policy"].module.state_dict()
    assert set(got) == set(want)
    for name, p in got.items():
        start = r["start"][name].double()
        delta_want = want[name].double() - start
        delta_got = p.double() - start
        assert float(delta_want.abs().max()) > 0, name
        assert float((delta_got - delta_want).norm() / delta_want.norm()) < 1e-3, name
    for name, p in tend.target.state_dict().items():
        assert torch.equal(p, got[name]), name
    loss = r["infos"][1]["loss"]
    assert torch.isfinite(loss) and float(loss) > 0


def test_qnet_over_mlp_converts_and_matches_jax():
    """A QNet over mlp (deepq's CartPole network) from the JAX params through
    ``convert.q_state_dict``: q-values to 1e-5 relative, greedy actions equal."""
    jmod = jdqn.QNet(network=JaxMLP(), n_actions=2)
    obs = np.random.RandomState(7).randn(16, 4).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(obs))
    want = np.asarray(jmod.apply(params, jnp.asarray(obs)))
    tmod = dqn.QNet(MLP(ob_shape=(4,)), 2)
    tmod.load_state_dict(convert.q_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    tpol = dqn.QPolicy(tmod, Box(-10, 10, (4,)), 2)
    with torch.no_grad():
        got = tpol.q_values(torch.from_numpy(obs))
    assert rel_err(got, want) < 1e-5
    np.testing.assert_array_equal(tpol.mode_step(torch.from_numpy(obs))[0].numpy(),
                                  np.argmax(want, axis=-1))
