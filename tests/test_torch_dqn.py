"""The port's deepq (algos/dqn/dqn.py) against the JAX package's, on the CPU: its math
helpers, QNet from carried-across params, the TD loss and its gradients, and the slice
as a whole, a few iterations of the JAX learner from the same initial state with the
same draws."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ReplayDraws, policy_params, push_env_step, push_reset, rel_err

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.common import jit_init
from baselines_tpu.algos.dqn import dqn as jdqn
from baselines_tpu.core.math import huber_loss as jax_huber_loss
from baselines_tpu.core.schedules import LinearSchedule as JaxLinearSchedule
from baselines_tpu.envs.registry import make_env as jax_make_env
from baselines_tpu.envs.spaces import Box as JaxBox
from baselines_tpu.envs.spaces import Discrete as JaxDiscrete
from baselines_tpu.nn.policy import encode_observation as jax_encode_observation
from baselines_tpu.nn.networks import NatureCNNS2D as JaxNatureCNNS2D
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import ClipAdam, build_env
from baselines_tpu_torch.algos.dqn import dqn
from baselines_tpu_torch.core.logger import configure, reset
from baselines_tpu_torch.core.math import huber_loss
from baselines_tpu_torch.core.schedules import LinearSchedule
from baselines_tpu_torch.data.prioritized import PrioritizedReplayBuffer
from baselines_tpu_torch.data.replay import ReplayState
from baselines_tpu_torch.envs.spaces import Box, Discrete
from baselines_tpu_torch.nn.networks import NatureCNNS2D
from baselines_tpu_torch.nn.policy import encode_observation, uses_fused_kernel


def test_huber_loss_matches_jax():
    x = np.random.RandomState(0).randn(1000).astype(np.float32) * 3
    for delta in (1.0, 0.5):
        got = huber_loss(torch.from_numpy(x), delta).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_huber_loss(jnp.asarray(x), delta)))


@pytest.mark.parametrize("args", [(1638, 0.01, 1.0), (16384, 1.0, 0.4), (7, 0.02, 1.0)])
def test_linear_schedule_matches_jax_in_f32(args):
    """Bit for bit in f32: epsilon is compared with uniforms, so one ulp matters."""
    ts = list(range(0, 20000, 37)) + [0, 1, args[0] - 1, args[0], args[0] + 1]
    got = np.array([LinearSchedule(*args).value(t) for t in ts])
    want = np.array([JaxLinearSchedule(*args).value(t) for t in ts])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_encode_observation_matches_jax():
    """One-hot f32 for Discrete, the observation itself for Box (input.py:43-63)."""
    obs = np.array([0, 4, 2, 2], np.int32)
    got = encode_observation(Discrete(5), torch.from_numpy(obs))
    want = jax_encode_observation(JaxDiscrete(5), jnp.asarray(obs))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    frames = torch.zeros((2, 21, 21, 64), dtype=torch.uint8)
    assert encode_observation(Box(0, 255, (21, 21, 64), np.uint8), frames) is frames


def _q_params(seed: int, n_actions: int, dueling: bool, layer_norm: bool) -> dict:
    """A JAX QNet's params in flax layout, made with numpy like torch_parity's
    policy_params; LayerNorm scales and biases away from 1 and 0."""
    rng = np.random.RandomState(seed)
    tree = {"network": policy_params(seed, n_actions)["params"]["network"]}

    def dense(n_in, n_out, gain):
        return {"kernel": (rng.randn(n_in, n_out) * gain / np.sqrt(n_in)).astype(np.float32),
                "bias": (rng.randn(n_out) * 0.01).astype(np.float32)}

    for name, out in [("action_value", n_actions)] + ([("state_value", 1)] if dueling else []):
        tree[f"{name}_fc0"] = dense(512, 256, np.sqrt(2))
        if layer_norm:
            tree[f"{name}_ln0"] = {"scale": (1 + 0.1 * rng.randn(256)).astype(np.float32),
                                   "bias": (0.1 * rng.randn(256)).astype(np.float32)}
        tree[f"{name}_out"] = dense(256, out, 1.0)
    return {"params": tree}


def _models(dueling: bool, layer_norm: bool, seed: int = 0):
    params = _q_params(seed, 6, dueling, layer_norm)
    jmod = jdqn.QNet(network=JaxNatureCNNS2D(), n_actions=6, dueling=dueling,
                     layer_norm=layer_norm)
    jpol = jdqn.QPolicy(jmod, JaxBox(0, 255, (21, 21, 64), np.uint8), 6)
    tmod = dqn.QNet(NatureCNNS2D(), 6, dueling=dueling, layer_norm=layer_norm)
    tmod.load_state_dict(convert.q_state_dict(params))
    tpol = dqn.QPolicy(tmod, Box(0, 255, (21, 21, 64), np.uint8), 6)
    return params, jpol, tpol


def _obs(rng, b):
    return rng.randint(0, 256, (b, 21, 21, 64)).astype(np.uint8)


@pytest.mark.parametrize("dueling", [True, False], ids=["dueling", "plain"])
@pytest.mark.parametrize("layer_norm", [False, True], ids=["no_ln", "ln"])
def test_qnet_matches_jax(dueling, layer_norm):
    """q-values to 1e-5 relative: f32 convolutions and LayerNorm statistics sum in
    another order."""
    params, jpol, tpol = _models(dueling, layer_norm)
    x = _obs(np.random.RandomState(1), 8)
    want = np.asarray(jpol.module.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tpol.q_values(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 6)
    assert rel_err(got, want) < 1e-5
    np.testing.assert_array_equal(tpol.mode_step(torch.from_numpy(x))[0].numpy(),
                                  np.argmax(want, axis=-1))


def test_act_step_packs_the_current_params():
    """The bf16 net's act step runs the fused CNN on weights packed from the params of
    the moment (on the CPU, the kernel's plain version, which takes the same packed
    weights): after a change of the params its q-values follow the module's, to the
    kernel's 2e-2 relative tolerance, so a stale pack would fail here."""
    params, _, _ = _models(True, False)
    tmod = dqn.QNet(NatureCNNS2D(dtype=torch.bfloat16), 6)
    tmod.load_state_dict(convert.q_state_dict(params))
    tpol = dqn.QPolicy(tmod, Box(0, 255, (21, 21, 64), np.uint8), 6)
    assert uses_fused_kernel(tmod.network)
    x = torch.from_numpy(_obs(np.random.RandomState(3), 4))
    for _ in range(2):
        with torch.no_grad():
            want = tmod(x)
        got = tpol.act_q_values(x)
        assert rel_err(got, want) < 2e-2
        before = got
        with torch.no_grad():
            tmod.network.fc1.weight.mul_(-1.0)
    assert rel_err(tpol.act_q_values(x), before) > 0.1


def _jax_td_loss(jpol, gamma, double_q):
    """dqn.py:211-227, which the JAX package keeps inside ``learn``."""

    def td_loss(params, target_params, batch, weights):
        q_t = jpol.q_values(params, batch["obs"])
        q_sel = jnp.take_along_axis(q_t, batch["action"][:, None], axis=-1)[:, 0]
        q_tp1_target = jpol.q_values(target_params, batch["next_obs"])
        if double_q:
            q_tp1_online = jpol.q_values(params, batch["next_obs"])
            a_prime = jnp.argmax(q_tp1_online, axis=-1)
            q_tp1_best = jnp.take_along_axis(q_tp1_target, a_prime[:, None], axis=-1)[:, 0]
        else:
            q_tp1_best = jnp.max(q_tp1_target, axis=-1)
        q_tp1_best = (1.0 - batch["done"]) * q_tp1_best
        target = batch["reward"] + gamma * q_tp1_best
        td = q_sel - jax.lax.stop_gradient(target)
        return jnp.mean(weights * jax_huber_loss(td)), td

    return td_loss


@pytest.mark.parametrize("double_q", [True, False], ids=["double_q", "max_q"])
def test_td_loss_and_grads_match_jax(double_q):
    """Loss and TD errors to 1e-5 relative, every gradient to 1e-4 relative of its
    largest entry, with IS weights and some terminal transitions; the target net has
    its own params."""
    params, jpol, tpol = _models(True, False)
    tparams = _q_params(1, 6, True, False)
    target = dqn.QNet(NatureCNNS2D(), 6)
    target.load_state_dict(convert.q_state_dict(tparams))
    rng = np.random.RandomState(2)
    batch = {"obs": _obs(rng, 8), "next_obs": _obs(rng, 8),
             "action": rng.randint(0, 6, 8).astype(np.int32),
             "reward": rng.randn(8).astype(np.float32),
             "done": (rng.rand(8) < 0.3).astype(np.float32)}
    weights = rng.uniform(0.2, 1.0, 8).astype(np.float32)

    fn = _jax_td_loss(jpol, 0.99, double_q)
    (jloss, jtd), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        params, tparams, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(weights))
    loss, td = dqn.td_loss(tpol, target, {k: torch.from_numpy(v) for k, v in batch.items()},
                           torch.from_numpy(weights), gamma=0.99, double_q=double_q)
    assert rel_err(loss.detach(), jloss) < 1e-5
    assert rel_err(td.detach(), jtd) < 1e-5
    names = [n for n, _ in tpol.module.named_parameters()]
    grads = torch.autograd.grad(loss, list(tpol.module.parameters()))
    want = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert rel_err(g, want[name]) < 1e-4, name
    assert not any(p.grad is not None for p in target.parameters())


# --- the slice as a whole ---------------------------------------------------------

NENVS, BUFFER, BATCH, ITERS = 4, 64, 8, 4
HPARAMS = dict(lr=1e-3, batch_size=BATCH, learning_starts=8, train_freq=4, gamma=0.99,
               target_network_update_freq=8, prioritized_replay=True,
               prioritized_replay_eps=1e-6, double_q=True)
LEARN = dict(env_id="AtariSim-v0", env_kwargs={"s2d": 4}, network="cnn_s2d", seed=0,
             num_envs=NENVS, buffer_size=BUFFER, exploration_fraction=0.5,
             exploration_final_eps=0.1, prioritized_replay_alpha=0.6, chunk_size=1,
             print_freq=0, checkpoint_freq=None, **HPARAMS)


@pytest.fixture(scope="module")
def slice_runs():
    """JAX: one learn over ITERS iterations of one chunk each, its initial state taken
    as ``jit_init`` returns it. The port: the same initial state (params carried across
    by convert.q_state_dict), then ITERS calls of its iteration function with the JAX
    learner's draws, rebuilt from its key splits (dqn.py:230, :116)."""
    total = NENVS * ITERS
    starts = []

    def recording_jit_init(make_state, key):
        state = jit_init(make_state, key)
        starts.append(jax.device_get((state.params, state.obs)))  # before donation
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", recording_jit_init)
        jend = jdqn.learn(total_timesteps=total, **LEARN).state
    (jstart_params, jstart_obs), = starts

    base = jax_make_env("AtariSim-v0")
    draws = ReplayDraws()
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    push_reset(draws, base, kreset, NENVS)
    first_u = None
    for i in range(ITERS):
        key, kact, kstep, ksample, _ = jax.random.split(key, 5)
        ku, kr = jax.random.split(kact)
        draws.push("randint", jax.random.randint(kr, (NENVS,), 0, 6, jnp.int32))
        draws.push("uniform", jax.random.uniform(ku, (NENVS,)))
        push_env_step(draws, base, kstep, NENVS)
        if NENVS * (i + 1) >= HPARAMS["learning_starts"]:
            u = jax.random.uniform(ksample, (BATCH,))
            first_u = u if first_u is None else first_u
            draws.push("uniform", u)

    venv = build_env("AtariSim-v0", NENVS, device="cpu", s2d=4)
    qnet = dqn.QNet(NatureCNNS2D(), 6)
    start = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jstart_params))
    qnet.load_state_dict(start)
    policy = dqn.QPolicy(qnet, venv.observation_space, 6)
    opt = ClipAdam(qnet.parameters(), 10.0, eps=1e-5)
    rb = PrioritizedReplayBuffer(BUFFER, 0.6)
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
    return dict(jend=jend, tend=state, infos=infos, policy=policy, start=start, first_u=first_u)


def test_slice_first_training_samples_match_jax(slice_runs):
    """The first training iteration (t = 8) samples from priorities that are all 1.0, so
    its indices are the JAX learner's bit for bit: its XLA route (searchsorted left) and
    the port's kernel route (right) differ only on a target exactly on a boundary."""
    infos = slice_runs["infos"]
    assert [bool(i) for i in infos] == [False, True, True, True]
    prios = jnp.zeros((BUFFER,), jnp.float32).at[:8].set(1.0)
    cum = jnp.cumsum(prios)
    targets = (jnp.arange(BATCH) + slice_runs["first_u"]) / BATCH * cum[-1]
    want = np.clip(np.asarray(jnp.searchsorted(cum, targets, side="left")), 0, BUFFER - 1)
    np.testing.assert_array_equal(infos[1]["idx"].numpy(), want)


def test_slice_state_matches_jax(slice_runs):
    """After the iterations: t, the target syncs, the ring cursor and every replay field
    bit for bit; priorities and max_priority to 1e-4 relative (|td| from f32
    convolutions summed in another order); the target net equal to the online net
    after the sync at t = 16; and each param's change over the three training steps to
    5e-3 of that change in norm. Adam divides by sqrt(v) + 1e-5, so an element whose
    gradient is near zero, where a relu at the edge of zero is on in one sum and off in
    the other, moves by up to lr in one run and not in the other: a few hundred of the
    1.6M trunk weights do, and the change of the trunk differs by 2.1e-3 in norm at most,
    of the heads by 1.3e-5 (measured on these inputs)."""
    jend, tend = slice_runs["jend"], slice_runs["tend"]
    assert tend.t == int(jend.t) == NENVS * ITERS
    assert tend.n_target_syncs == int(jend.n_target_syncs) == 2
    jrep, trep = jend.replay, tend.replay
    assert (trep.buffer.ptr, trep.buffer.size) == (int(jrep.buffer.ptr), int(jrep.buffer.size))
    for k, v in jrep.buffer.data.items():
        np.testing.assert_array_equal(trep.buffer.data[k].numpy(), np.asarray(v), err_msg=k)
    want_prios = np.asarray(jrep.priorities)
    assert (want_prios[:16] != 1.0).any() and (want_prios[16:] == 0).all()
    assert rel_err(trep.priorities[:BUFFER], want_prios) < 1e-4
    assert not trep.priorities[BUFFER:].any()
    assert rel_err(trep.max_priority, jrep.max_priority) < 1e-4

    want = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jend.params))
    got = slice_runs["policy"].module.state_dict()
    for name, p in got.items():
        start = slice_runs["start"][name].double()
        delta_want = want[name].double() - start
        delta_got = p.double() - start
        assert float(delta_want.abs().max()) > 0, name
        assert float((delta_got - delta_want).norm() / delta_want.norm()) < 5e-3, name
    jtarget = convert.q_state_dict(jax.tree_util.tree_map(np.asarray, jend.target_params))
    for name, p in tend.target.state_dict().items():
        assert torch.equal(p, got[name]), name
        np.testing.assert_array_equal(jtarget[name].numpy(), want[name].numpy())


@pytest.mark.parametrize("prioritized", [True, False], ids=["prioritized", "uniform"])
def test_learn_runs_on_the_cpu_and_logs_the_jax_keys(tmp_path, prioritized):
    """The entry point at a tiny size, with either buffer: the log keys and cadence of
    dqn.py:476-490; ``param_noise`` builds the perturbed net and its scale (its
    iterations are held against the JAX learner's in tests/test_torch_ddpg.py), and a
    mesh that is not a Mesh raises."""
    configure(dir=str(tmp_path), format_strs=["json"])
    try:
        model = dqn.learn(total_timesteps=104, device="cpu", **dict(
            LEARN, chunk_size=13, print_freq=1, dtype=torch.bfloat16,
            prioritized_replay=prioritized))
    finally:
        reset()
    rows = [__import__("json").loads(line) for line in (tmp_path / "progress.json").open()]
    assert len(rows) == 2  # every chunk, since print_freq * 100 // (13 * 4) == 1
    assert set(rows[-1]) == {"steps", "episodes", "mean 100 episode reward",
                             "% time spent exploring", "fps"}
    assert [r["steps"] for r in rows] == [52, 104] and model.state.t == 104
    assert model.state.n_target_syncs == 13
    assert isinstance(model.state.replay.buffer if prioritized else model.state.replay,
                      ReplayState)
    noisy = dqn.learn(total_timesteps=0, device="cpu", **dict(LEARN, param_noise=True))
    assert float(noisy.state.param_noise_scale) == np.float32(0.01)
    for p, q in zip(noisy.state.perturbed.parameters(), noisy.policy.module.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(TypeError, match="Mesh"):
        dqn.learn(total_timesteps=0, device="cpu", **dict(LEARN, mesh=object()))


@pytest.mark.parametrize("option", ["checkpoint_path", "load_path"])
def test_checkpoint_options_work(tmp_path, option):
    """``checkpoint_path`` writes ``latest`` once training has started and a second run
    resumes its step count; ``load_path`` starts from the params of a saved model."""
    if option == "checkpoint_path":
        kwargs = dict(LEARN, checkpoint_path=str(tmp_path), checkpoint_freq=8, device="cpu")
        first = dqn.learn(total_timesteps=16, **kwargs)
        assert (tmp_path / "latest").exists() and first.state.t == 16
        assert dqn.learn(total_timesteps=16, **kwargs).state.t == 32
    else:
        saved = dqn.learn(total_timesteps=16, device="cpu", **LEARN)
        saved.save(str(tmp_path / "model.pt"))
        loaded = dqn.learn(total_timesteps=0, device="cpu", load_path=str(tmp_path / "model.pt"),
                           **dict(LEARN, seed=1))
        for p, q in zip(saved.policy.module.parameters(), loaded.policy.module.parameters()):
            assert torch.equal(p, q)
