"""The port's her (algos/her/her.py), its episode buffer (data/her_buffer.py), the goal
env PointReach (envs/goal/point_reach.py), DictSpace and the dict-obs wrappers against
the JAX package's, on the CPU: the env's reset and step, the buffer's stores and
relabeled samples bit for bit from the same draws, and the slice as a whole, one her
cycle of each side from the same weights (flax's init moved by noise, carried across by
convert.py) with the same draws, rebuilt from the JAX learner's key splits."""

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import her_cycle
from torch_parity import ReplayDraws, move_params

from baselines_tpu.algos.her import her as jher
from baselines_tpu.data.her_buffer import HerReplayBuffer as JaxHerReplayBuffer
from baselines_tpu.envs.goal.point_reach import PointReach as JaxPointReach
from baselines_tpu.envs.vec import VecFlattenDictObs as JaxVecFlattenDictObs
from baselines_tpu_torch import convert, run
from baselines_tpu_torch.algos.common import build_env
from baselines_tpu_torch.algos.her import her
from baselines_tpu_torch.core.logger import configure, reset
from baselines_tpu_torch.data.her_buffer import HerReplayBuffer
from baselines_tpu_torch.envs.goal.point_reach import PointReach
from baselines_tpu_torch.envs.registry import get_env_type, make_env
from baselines_tpu_torch.envs.spaces import Box, DictSpace
from baselines_tpu_torch.envs.vec import VecExtractDictObs, VecTorchEnv


def _push_point_reach_reset(draws: ReplayDraws, key, n: int, dim: int = 2) -> None:
    """What the port draws where the JAX PointReach resets with one key of
    ``split(key, n)`` each: the positions, then the goals."""
    keys = jax.random.split(key, n)
    pairs = [jax.random.split(k) for k in keys]
    draws.push("uniform", np.stack([jax.random.uniform(a, (dim,), jnp.float32, -1.0, 1.0)
                                    for a, _ in pairs]))
    draws.push("uniform", np.stack([jax.random.uniform(b, (dim,), jnp.float32, -1.0, 1.0)
                                    for _, b in pairs]))


def test_point_reach_reset_and_step_match_jax():
    """Reset and 60 steps of 8 envs to rtol 1e-6 (the positions are clipped sums, so in
    fact bit for bit): observations, rewards, is_success and compute_reward on relabeled
    goals; the registry's PointReach-v0 is this env behind a 50-step TimeLimit."""
    n = 8
    jenv, tenv = JaxPointReach(), PointReach()
    key = jax.random.PRNGKey(3)
    jobs, jst = jax.vmap(jenv.reset)(jax.random.split(key, n))
    draws = ReplayDraws()
    _push_point_reach_reset(draws, key, n)
    tobs, tst = tenv.reset(draws, n, "cpu")
    rng = np.random.RandomState(0)
    for t in range(60):
        assert set(tobs) == {"observation", "achieved_goal", "desired_goal"}
        for k in tobs:
            np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]), rtol=1e-6)
        action = (rng.randn(n, 2) * 0.7).astype(np.float32)
        jobs, jst, jrew, jdone, jinfo = jax.vmap(jenv.step)(
            jax.random.split(key, n), jst, jnp.asarray(action))
        tobs, tst, trew, tdone, tinfo = tenv.step(None, tst, torch.from_numpy(action))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tinfo["is_success"].numpy(), np.asarray(jinfo["is_success"]))
        assert not tdone.any()
    ag = rng.uniform(-1, 1, (100, 2)).astype(np.float32)
    g = (ag + rng.randn(100, 2) * 0.04).astype(np.float32)
    want = np.asarray(jenv.compute_reward(jnp.asarray(ag), jnp.asarray(g)))
    assert 0 < (want == 0).sum() < 100
    np.testing.assert_array_equal(tenv.compute_reward(torch.from_numpy(ag),
                                                      torch.from_numpy(g)).numpy(), want)
    wrapped = make_env("PointReach-v0")
    assert wrapped.max_episode_steps == 50 and isinstance(wrapped.env, PointReach)
    assert get_env_type("PointReach-v0") == "robotics"


class _DictVenvStub:
    """What the JAX VecFlattenDictObs reads of the env it wraps."""

    num_envs = 4
    observation_space = JaxPointReach().observation_space
    action_space = JaxPointReach().action_space


def test_dict_space_and_wrappers():
    """DictSpace's lookup and containment; the vec layer auto-resets dict observations
    key by key at the time limit; VecFlattenDictObs gives observation ++ desired_goal as
    the JAX wrapper concatenates them, terminal observations too, and VecExtractDictObs
    one key; build_env flattens unless ``keep_dict_obs``."""
    sp = PointReach().observation_space
    assert isinstance(sp, DictSpace) and isinstance(sp["desired_goal"], Box)
    assert sp.contains({k: np.zeros(2, np.float32) for k in sp.spaces})
    assert not sp.contains({"observation": np.zeros(2, np.float32)})
    jflat = JaxVecFlattenDictObs(_DictVenvStub())
    venv = build_env("PointReach-v0", 4, device="cpu")
    assert venv.observation_space.shape == jflat.observation_space.shape == (4,)
    inner = VecTorchEnv(make_env("PointReach-v0"), 4, "cpu")
    extract = VecExtractDictObs(VecTorchEnv(make_env("PointReach-v0"), 4, "cpu"),
                                "achieved_goal")
    assert extract.observation_space == sp["achieved_goal"]
    drawn = [ReplayDraws() for _ in range(3)]
    for t in range(51):  # the reset, then a reset's draws at every step
        for d in drawn:
            _push_point_reach_reset(d, jax.random.PRNGKey(t), 4)
    (obs, state), (dobs, dstate), (eobs, estate) = (
        w.reset(d) for w, d in zip((venv, inner, extract), drawn))
    action = torch.full((4, 2), 0.3)
    for _ in range(50):
        want = np.asarray(jflat._flat({k: jnp.asarray(v.numpy()) for k, v in dobs.items()}))
        np.testing.assert_array_equal(obs.numpy(), want)
        assert torch.equal(eobs, dobs["achieved_goal"])
        obs, state, _, done, info = venv.step(drawn[0], state, action)
        dobs, dstate, _, ddone, dinfo = inner.step(drawn[1], dstate, action)
        eobs, estate, _, _, einfo = extract.step(drawn[2], estate, action)
    assert bool(done.all()) and bool(ddone.all()) and not any(d.queue for d in drawn)
    terminal = dinfo["terminal_obs"]
    np.testing.assert_array_equal(info["terminal_obs"].numpy(), np.asarray(
        jflat._flat({k: jnp.asarray(v.numpy()) for k, v in terminal.items()})))
    assert torch.equal(einfo["terminal_obs"], terminal["achieved_goal"])
    assert not torch.equal(dobs["observation"], terminal["observation"])  # reset
    np.testing.assert_array_equal(obs.numpy(), torch.cat([dobs["observation"],
                                                          dobs["desired_goal"]], -1).numpy())
    kept = build_env("PointReach-v0", 2, device="cpu", keep_dict_obs=True)
    assert isinstance(kept.observation_space, DictSpace)


C, T, DIMS = 5, 6, {"o": 3, "g": 2, "u": 2}


def test_her_buffer_stores_and_samples_match_jax():
    """Four stores of 2 episodes into 5 slots (the last ones at random slots) and two
    samples of 64 with relabeling, from the same draws: the storage and every field of
    the samples bit for bit; the relabeled goals are achieved goals of later steps."""
    rng = np.random.RandomState(0)
    jbuf, tbuf = JaxHerReplayBuffer(C, T, DIMS), HerReplayBuffer(C, T, DIMS)
    jst, tst = jbuf.init(), tbuf.init("cpu")
    jenv, tenv = JaxPointReach(distance_threshold=0.5), PointReach(distance_threshold=0.5)
    key = jax.random.PRNGKey(1)
    for i in range(4):
        eps = [rng.randn(2, T + 1, 3), rng.randn(2, T + 1, 2), rng.randn(2, T, 2),
               rng.randn(2, T, 2)]
        eps = [x.astype(np.float32) for x in eps]
        key, k = jax.random.split(key)
        jst = jbuf.store_episodes(jst, k, *[jnp.asarray(x) for x in eps])
        draws = ReplayDraws()
        draws.push("randint", jax.random.randint(k, (2,), 0, C, jnp.int32))
        tst = tbuf.store_episodes(tst, draws, *[torch.from_numpy(x) for x in eps])
    assert tst.n_episodes == int(jst.n_episodes) == 8
    for f, rows in (("o", T + 1), ("ag", T + 1), ("g", T), ("u", T)):
        np.testing.assert_array_equal(getattr(tst, f).reshape(C, rows, -1).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    for replay_k in (4, 0):
        key, k = jax.random.split(key)
        want = jbuf.sample(jst, k, 64, replay_k, jenv.compute_reward)
        kep, kt, kher, kfut = jax.random.split(k, 4)
        draws = ReplayDraws()
        draws.push("randint", jax.random.randint(kep, (64,), 0, C, jnp.int32))
        draws.push("randint", jax.random.randint(kt, (64,), 0, T, jnp.int32))
        draws.push("uniform", jax.random.uniform(kher, (64,)))
        draws.push("uniform", jax.random.uniform(kfut, (64,)))
        got = tbuf.sample(tst, draws, 64, replay_k, tenv.compute_reward)
        assert not draws.queue and set(got) == set(want)
        for f in want:
            np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]), err_msg=f)
        relabeled = (got["g"] != torch.from_numpy(np.array(jbuf.sample(
            jst, k, 64, 0, jenv.compute_reward)["g"]))).any(-1)
        assert bool(relabeled.any()) == (replay_k > 0)


NENVS, CYCLE_KW = 4, dict(network="mlp", seed=0, num_envs=4, n_cycles=1, n_batches=3,
                          batch_size=32, buffer_size_episodes=16, num_hidden=32,
                          num_layers=2, log_interval=0)


def jax_cycle(draws, whole) -> tuple:
    """JAX: her for one epoch of one cycle of 4 episodes of PointReach-v0 (T = 50) and 3
    train steps, the actor's and critic's init moved by noise; and its draws rebuilt
    from its key splits, in the port's order: the env-axis ones (the episodes' resets
    and noise) pushed to ``draws``, the ones a mesh's ranks take alike (the store's
    slots, each train step's sample) to ``whole``. Returns the JAX learner's end state
    and the port's start weights ("actor", "critic")."""
    inits = {}

    def moved_init(module_cls):
        flax_init = module_cls.init

        def init(self, key, *args):
            params = move_params(flax_init(self, key, *args), len(inits))
            inits[module_cls.__name__] = params
            return jax.tree_util.tree_map(jnp.asarray, params)

        return init

    with pytest.MonkeyPatch.context() as mp:
        for cls in (jher.GoalActor, jher.GoalCritic):
            mp.setattr(cls, "init", moved_init(cls))
        jend = jher.learn(env_id="PointReach-v0", total_timesteps=NENVS * 50,
                          **CYCLE_KW).state

    key, _, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    key, kreset = jax.random.split(key)
    _push_point_reach_reset(draws, kreset, NENVS)
    for _ in range(50):
        key, knoise, keps, krand, _ = jax.random.split(key, 5)
        draws.push("normal", jax.random.normal(knoise, (NENVS, 2)))
        draws.push("uniform", jax.random.uniform(krand, (NENVS, 2), minval=-1.0, maxval=1.0))
        draws.push("uniform", jax.random.uniform(keps, (NENVS, 1)))
    key, kstore = jax.random.split(key)
    whole.push("randint", jax.random.randint(kstore, (NENVS,), 0, 16, jnp.int32))
    for _ in range(CYCLE_KW["n_batches"]):
        key, ksample = jax.random.split(key)
        kep, kt, kher, kfut = jax.random.split(ksample, 4)
        whole.push("randint", jax.random.randint(kep, (32,), 0, NENVS, jnp.int32))
        whole.push("randint", jax.random.randint(kt, (32,), 0, 50, jnp.int32))
        whole.push("uniform", jax.random.uniform(kher, (32,)))
        whole.push("uniform", jax.random.uniform(kfut, (32,)))
    return jend, {"actor": convert.actor_state_dict(inits["GoalActor"]),
                  "critic": convert.critic_state_dict(inits["GoalCritic"])}


@pytest.fixture(scope="module")
def cycle_runs():
    """The JAX learner's cycle (``jax_cycle``) and the port's: learn builds the same
    learner (nothing trained), the params are carried across, and its cycle runs with
    the JAX learner's draws."""
    draws = ReplayDraws()
    jend, start = jax_cycle(draws, draws)
    model, state, losses = her_cycle({"kwargs": CYCLE_KW, "start": start}, draws)
    assert not draws.queue, "the port took fewer draws than the JAX learner made"
    return dict(jend=jend, tend=state, model=model, start=start, losses=losses)


def check_cycle_buffer_and_normalizers(jend, tend) -> None:
    """After the cycle: the stored episodes (to 1e-6: the actions come from f32 networks
    whose sums run in another order), the episode count, the o and g statistics (count
    exactly) and the success rate's moving average."""
    assert tend.n_episodes == int(jend.n_episodes) == NENVS
    for f, rows in (("o", 51), ("ag", 51), ("g", 50), ("u", 50)):
        np.testing.assert_allclose(getattr(tend.buffer, f).reshape(16, rows, -1).numpy(),
                                   np.asarray(getattr(jend.buffer, f)), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    for rms, jrms in ((tend.o_rms, jend.o_rms), (tend.g_rms, jend.g_rms)):
        assert float(rms.count) == float(jrms.count)
        np.testing.assert_allclose(rms.mean.numpy(), np.asarray(jrms.mean), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rms.var.numpy(), np.asarray(jrms.var), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tend.success_rate), float(jend.success_rate), atol=1e-7)


def check_cycle_params(jend, start: dict, actor, critic, tend) -> None:
    """Each param's change over the train steps to 2e-4 of the JAX change, for the actor
    and the critic (Adam), and for their targets after the one Polyak step at the
    cycle's end beside the ulp to which each side rounds the f32 target, as
    tests/test_torch_update.py holds ppo2's params."""
    pairs = [("actor", actor, jend.actor_params, 0),
             ("critic", critic, jend.critic_params, 0),
             ("actor", tend.target_actor, jend.target_actor_params, 1),
             ("critic", tend.target_critic, jend.target_critic_params, 1)]
    for which, module, jparams, ulps in pairs:
        want = convert.actor_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
        for name, p in module.state_dict().items():
            base = start[which][name].double()
            delta_want = want[name].double() - base
            assert float(delta_want.abs().max()) > 0, (which, name)
            ulp = torch.from_numpy(np.spacing(np.abs(want[name].numpy()))).double()
            err = (p.double() - base - delta_want).abs()
            assert bool((err <= 2e-4 * delta_want.abs().max() + ulps * ulp).all()), (which, name)


def test_cycle_buffer_and_normalizers_match_jax(cycle_runs):
    """The cycle's episodes and statistics as the JAX learner's
    (``check_cycle_buffer_and_normalizers``)."""
    check_cycle_buffer_and_normalizers(cycle_runs["jend"], cycle_runs["tend"])


def test_cycle_params_match_jax(cycle_runs):
    """The cycle's params and targets as the JAX learner's (``check_cycle_params``)."""
    model = cycle_runs["model"]
    check_cycle_params(cycle_runs["jend"], cycle_runs["start"], model.policy.module,
                       model.policy.critic, cycle_runs["tend"])


def test_cycle_losses_match_jax(cycle_runs):
    """The critic's and the actor's losses at the end of the cycle on one relabeled
    batch of the buffer, to 1e-4 relative: the port's loss functions against the same
    formulas (her.py:309-345) through the JAX modules, params and normalizers; the
    cycle's own last losses are finite."""
    jend, tend, model = cycle_runs["jend"], cycle_runs["tend"], cycle_runs["model"]
    draws = ReplayDraws()
    rng = np.random.RandomState(5)
    draws.push("randint", rng.randint(0, NENVS, 32))
    draws.push("randint", rng.randint(0, 50, 32))
    draws.push("uniform", rng.uniform(0, 1, 32).astype(np.float32))
    draws.push("uniform", rng.uniform(0, 1, 32).astype(np.float32))
    buf = HerReplayBuffer(16, 50, {"o": 2, "g": 2, "u": 2})
    batch = buf.sample(tend.buffer, draws, 32, 4, PointReach().compute_reward)
    with torch.no_grad():
        closs = float(model.critic_loss(tend, batch))
        aloss = float(model.actor_loss(tend, batch))

    net = jher.get_network("mlp", num_hidden=32, num_layers=2, activation=jax.nn.relu)
    jactor, jcritic = jher.GoalActor(net, 2), jher.GoalCritic(net)
    b = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def norm(rms, x):
        return rms.normalize(x, clip=5.0)

    def pi(p, o, g):
        return jactor.apply(p, norm(jend.o_rms, o), norm(jend.g_rms, g))

    def q(p, o, g, u):
        return jcritic.apply(p, norm(jend.o_rms, o), norm(jend.g_rms, g), u)

    gamma = 1.0 - 1.0 / 50
    u2 = pi(jend.target_actor_params, b["o2"], b["g"])
    target = jnp.clip(b["r"] + gamma * q(jend.target_critic_params, b["o2"], b["g"], u2),
                      -1.0 / (1.0 - gamma), 0.0)
    want_c = float(jnp.mean(jnp.square(q(jend.critic_params, b["o"], b["g"], b["u"]) - target)))
    a = pi(jend.actor_params, b["o"], b["g"])
    want_a = float(-jnp.mean(q(jend.critic_params, b["o"], b["g"], a)) + jnp.mean(a * a))
    assert abs(closs - want_c) <= 1e-4 * abs(want_c) and abs(aloss - want_a) <= 1e-4 * abs(want_a)
    assert all(bool(torch.isfinite(x)) for x in cycle_runs["losses"])


def test_learn_logs_saves_and_plays_through_the_cli(tmp_path):
    """run.main on the CPU at a tiny size: the JAX keys logged with the losses and
    params.json written; --save_path and --play on dict observations; --load_path of
    that file plays the same report; bc_loss with q_filter on demonstrations trains; a
    host goal env (gymnasium-robotics' FetchReach-v4, where installed) builds, and a
    mesh that is not a ``Mesh`` raises TypeError."""
    argv = ["--alg=her", "--env=PointReach-v0", "--num_env=4", "--n_cycles=2",
            "--n_batches=2", "--batch_size=16", "--num_hidden=16", "--seed=0",
            "--device=cpu", "--play"]
    path = str(tmp_path / "her.pt")

    def play(extra):
        import contextlib
        import io
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                model = run.main(argv + extra)
            finally:
                reset()
        lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("episode_rew")]
        assert len(lines) == 1, out.getvalue()
        return model, lines[0]

    model, report = play(["--num_timesteps=800", f"--save_path={path}",
                          f"--log_path={tmp_path / 'a'}"])
    keys = set(open(tmp_path / "a" / "progress.csv").read().splitlines()[0].split(","))
    assert {"epoch", "train/episode", "train/success_rate", "test/success_rate",
            "total/steps", "steps_per_second", "train/loss_actor", "train/loss_critic"} == keys
    assert json.load(open(tmp_path / "a" / "params.json"))["n_cycles"] == 2
    loaded, report2 = play(["--num_timesteps=0", f"--load_path={path}",
                            f"--log_path={tmp_path / 'b'}"])
    assert report2 == report
    for a, b in zip(model.policy.module.parameters(), loaded.policy.module.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(model.state.o_rms.mean, loaded.state.o_rms.mean)

    demo = tuple(np.zeros((2,) + s, np.float32) for s in ((51, 2), (51, 2), (50, 2), (50, 2)))
    configure(format_strs=[])
    try:
        m = her.learn(env_id="PointReach-v0", total_timesteps=400, num_envs=4, n_cycles=2,
                      n_batches=2, batch_size=16, num_hidden=16, bc_loss=True, q_filter=True,
                      demo_episodes=demo, demo_batch_size=8, device="cpu", seed=0)
    finally:
        reset()
    assert all(bool(torch.isfinite(p).all()) for p in m.policy.module.parameters())
    if importlib.util.find_spec("gymnasium_robotics") is not None:
        m = her.learn(env_id="FetchReach-v4", total_timesteps=0, num_envs=2, device="cpu")
        assert m.state.obs["observation"].shape == (2, 10)
    with pytest.raises(TypeError, match="Mesh"):
        her.learn(env_id="PointReach-v0", total_timesteps=0, device="cpu", mesh=object())
