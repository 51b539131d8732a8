"""The port's user surface on the CPU: ``evaluate`` against the JAX package's, ppo2's
whole-state checkpoints and auto-resume, deepq's ``latest`` and ``best`` checkpoints,
the ``--save_path`` / ``--load_path`` / ``--play`` round trip of
``python -m baselines_tpu_torch.run``, and the algorithm registry.

Tolerances: ``evaluate``'s report is compared exactly, since every episode's return and
length are counts, given that no state came within 1e-5 of a termination threshold
(asserted); resumed and uninterrupted runs of the port are compared bit for bit."""

import os
import shutil
import types

import jax
import pytest
import torch
from torch_parity import (THRESHOLD_MARGIN, RecordStates, ReplayDraws, mlp_policy_params,
                          push_env_step, push_reset)

from baselines_tpu.algos.common import Model as JaxModel
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.common import evaluate as jax_evaluate
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import algos, convert, run
from baselines_tpu_torch.algos.common import Model, build_env, evaluate
from baselines_tpu_torch.algos.dqn import dqn
from baselines_tpu_torch.algos.ppo import ppo
from baselines_tpu_torch.core import checkpoint as ckpt
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.nn.policy import build_policy


@pytest.fixture(autouse=True)
def quiet_logger():
    yield
    logger.reset()


def test_evaluate_matches_jax():
    """8 CartPole-v1 envs, 150 deterministic steps of the same mlp policy from the same
    reset draws: the mean return, mean length and episode count equal the JAX
    ``evaluate``'s."""
    n, nsteps = 8, 150
    params = mlp_policy_params(3, 4, 2)
    jvenv = jax_build_env("CartPole-v1", n)
    jpol = jax_build_policy(jvenv.observation_space, jvenv.action_space, "mlp")
    key = jax.random.PRNGKey(9)
    want = jax_evaluate(JaxModel(jpol, types.SimpleNamespace(params=params)), jvenv, key,
                        nsteps=nsteps, deterministic=True)

    base = jvenv.venv.env
    draws = ReplayDraws()
    push_reset(draws, base, key, n)  # evaluate resets with the key itself
    k = key
    for _ in range(nsteps):
        k, _, kstep = jax.random.split(k, 3)
        push_env_step(draws, base, kstep, n)
    venv = build_env("CartPole-v1", n, device="cpu")
    recorder = RecordStates(venv.venv.env)
    venv.venv.env = recorder
    tpol = build_policy(venv.observation_space, venv.action_space, "mlp", device="cpu")
    tpol.module.load_state_dict(convert.policy_state_dict(params))
    got = evaluate(Model(tpol, None), venv, draws, nsteps=nsteps, deterministic=True)
    assert not draws.queue
    assert recorder.min_margin() > THRESHOLD_MARGIN
    assert got[2] == want[2] > 8
    assert got == want


# --- ppo2 checkpoints --------------------------------------------------------------

PPO = dict(env_id="CartPole-v1", network="mlp", seed=0, num_envs=8, nsteps=64,
           nminibatches=2, noptepochs=2, log_interval=100, device="cpu")


def _ppo_run(logdir, resume_from=None, **kwargs):
    if resume_from is not None:
        os.makedirs(os.path.join(logdir, "checkpoints"), exist_ok=True)
        shutil.copy(resume_from, os.path.join(logdir, "checkpoints",
                                              os.path.basename(resume_from)))
    logger.configure(dir=str(logdir), format_strs=[])
    model = ppo.learn(**dict(PPO, **kwargs))
    logger.reset()
    return model


def test_ppo_resume_reproduces_uninterrupted_run(tmp_path):
    """4 updates with a checkpoint at each; a run resumed from the checkpoint of update
    2 in a fresh log dir ends with the uninterrupted run's params, Adam moments, env
    state and generator state, bit for bit (the JAX package's tests/test_resume.py)."""
    full = _ppo_run(tmp_path / "full", total_timesteps=4 * 8 * 64, save_interval=1)
    names = sorted(os.listdir(tmp_path / "full" / "checkpoints"))
    assert names == ["00001", "00002", "00003", "00004"]
    resumed = _ppo_run(tmp_path / "resumed", total_timesteps=4 * 8 * 64, save_interval=1,
                       resume_from=str(tmp_path / "full" / "checkpoints" / "00002"))
    assert resumed.state.update_idx == full.state.update_idx == 4
    assert sorted(os.listdir(tmp_path / "resumed" / "checkpoints")) == ["00002", "00003",
                                                                         "00004"]
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
    assert "train state.rng.generator" in leaves and "train state.opt.mu[0]" in leaves
    assert "train state.state.env_state.inner.t" in leaves  # the TimeLimit counters


def test_checkpoint_holds_only_tensors_and_numbers(tmp_path):
    """A periodic checkpoint loads with ``weights_only=True`` and rebuilds into a fresh
    train state; a tensor of another shape is refused with its path."""
    model = _ppo_run(tmp_path, total_timesteps=8 * 64, save_interval=1)
    path = tmp_path / "checkpoints" / "00001"
    tree = torch.load(path, weights_only=True)
    assert set(tree) == {"params", "state", "opt", "rng"}
    assert tree["opt"]["count"] == 2 * 2 and tree["state"]["update_idx"] == 1
    model.load_full(str(path))
    assert model.state.update_idx == 1
    tree["state"]["obs"] = tree["state"]["obs"][:4]
    torch.save(tree, path)
    with pytest.raises(ValueError, match="state.state.obs"):
        model.load_full(str(path))


def test_explicit_load_path_beats_auto_resume(tmp_path):
    """With stale checkpoints in the log dir and an explicit load_path, training starts
    from the load_path's params at update 0."""
    prior = tmp_path / "prior"
    _ppo_run(prior, total_timesteps=2 * 8 * 64, save_interval=1)
    assert (prior / "checkpoints" / "00002").exists()
    other = _ppo_run(tmp_path / "other", total_timesteps=2 * 8 * 64, seed=1)
    explicit = str(tmp_path / "explicit.pt")
    other.save(explicit)
    resumed = _ppo_run(prior, total_timesteps=0, save_interval=1, load_path=explicit)
    assert resumed.state.update_idx == 0
    for (name, p), q in zip(other.policy.module.state_dict().items(),
                            resumed.policy.module.state_dict().values()):
        assert torch.equal(p, q), name


# --- deepq checkpoints -------------------------------------------------------------

def _dqn_run(path, total, **kwargs):
    logger.configure(dir=str(path.parent / "log"), format_strs=[])
    return dqn.learn(env_id="CartPole-v1", seed=0, num_envs=8,  # the default network
                     total_timesteps=total, learning_starts=128, chunk_size=32,
                     checkpoint_freq=512, checkpoint_path=str(path), print_freq=None,
                     device="cpu", **kwargs)


def test_dqn_latest_written_and_resumed(tmp_path):
    """``latest`` holds the train fields and a second run resumes its progress: the
    exploration and target schedules go on from t (tests/test_dqn_checkpoint.py). No
    network is named, so the default, ``mlp``, serves."""
    cp = tmp_path / "ckpt"
    m1 = _dqn_run(cp, 2048)
    assert type(m1.policy.module.network).__name__ == "MLP"
    assert (cp / "latest").exists()
    tree = torch.load(cp / "latest", weights_only=True)
    assert set(tree) == {"params", "target_params", "opt", "t", "n_target_syncs"}
    assert tree["t"] == m1.state.t == 2048
    m2 = _dqn_run(cp, 2048)
    assert m2.state.t == 4096
    assert m2.state.n_target_syncs == 4096 // 500


def test_dqn_best_restored_at_end_not_last(tmp_path):
    """A planted ``best`` with zero params and an unbeatable mean return is what a later
    run returns, without its progress (deepq.py:327-331)."""
    cp = tmp_path / "ckpt"
    _dqn_run(cp, 1024)
    tree = torch.load(cp / "latest", weights_only=True)
    tree["params"] = {k: torch.zeros_like(v) for k, v in tree["params"].items()}
    tree["best_mean_reward"] = 1e9
    torch.save(tree, cp / "best")
    m = _dqn_run(cp, 1024)
    assert m.state.t == 2048  # the progress is latest's plus this run's, not best's
    assert all(not p.any() for p in m.policy.module.state_dict().values())


# --- the CLI -----------------------------------------------------------------------

def _report(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith("episode_rew mean=")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.mark.parametrize("alg,extra", [
    ("ppo2", ["--num_timesteps=2048", "--nsteps=64", "--num_env=8"]),
    ("deepq", ["--num_timesteps=1024", "--learning_starts=256", "--chunk_size=64"]),
])
def test_run_save_load_play_round_trip(tmp_path, capsys, alg, extra):
    """``run.main`` on CartPole-v1 with ``--device=cpu``: train, ``--save_path`` and
    ``--play``; then ``--load_path`` of that file with ``--num_timesteps=0 --play``
    loads the same params bit for bit and prints the same report."""
    path = str(tmp_path / "model.pt")
    common = [f"--alg={alg}", "--env=CartPole-v1", "--seed=0", "--device=cpu", "--play"]
    model = run.main(common + extra + [f"--save_path={path}", f"--log_path={tmp_path / 'a'}"])
    first = _report(capsys.readouterr().out)
    loaded = run.main(common + ["--num_timesteps=0", f"--load_path={path}",
                                f"--log_path={tmp_path / 'b'}"])
    second = _report(capsys.readouterr().out)
    assert first == second
    for (name, p), q in zip(model.policy.module.state_dict().items(),
                            loaded.policy.module.state_dict().values()):
        assert torch.equal(p, q), name
    assert (tmp_path / "a" / "progress.csv").exists()


def test_run_defaults_network_and_flags(tmp_path):
    """The env type picks the defaults and the network (mlp for classic control); an
    explicit ``--network`` beats them; ``--s2d`` turns ``cnn`` into ``cnn_s2d`` and
    refuses other networks; the env flags of later items raise."""
    base = ["--env=CartPole-v1", "--num_timesteps=0", "--device=cpu",
            f"--log_path={tmp_path}"]
    model = run.main(["--alg=ppo2"] + base)
    assert type(model.policy.module.network).__name__ == "MLP"
    model = run.main(["--alg=ppo2", "--network=mlp", "--num_hidden=16"] + base)
    assert model.policy.module.network.latent_size == 16
    model = run.main(["--alg=ppo2", "--env=AtariSim-v0", "--network=cnn", "--s2d=4",
                      "--num_env=2"] + base[1:])
    assert type(model.policy.module.network).__name__ == "NatureCNNS2D"
    with pytest.raises(ValueError, match="--s2d"):
        run.main(["--alg=ppo2", "--env=AtariSim-v0", "--s2d=4"] + base[1:])
    for flag, item in (("--save_video_interval=5", "item 8"), ("--save_video_interval=10", "item 8"),
                       ("--gamestate=Level1", "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            run.main(["--alg=ppo2", flag] + base)


def test_run_without_device_needs_a_card(tmp_path):
    """Without ``--device=cpu`` the learner asks for the card, and with none it raises
    the "no CUDA device" error rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--alg=ppo2", "--env=CartPole-v1", "--num_timesteps=0",
                  f"--log_path={tmp_path}"])


def test_algorithm_registry():
    """ppo2/ppo, ppo1 and deepq/dqn resolve to the port's learners; every other algorithm
    the JAX package knows raises NotImplementedError naming its item; an unknown name
    raises ValueError, as the JAX registry does."""
    from baselines_tpu import algos as jax_algos
    from baselines_tpu_torch.algos.ppo1 import ppo1

    assert algos.get_learn_function("ppo2") is algos.get_learn_function("ppo") is ppo.learn
    assert algos.get_learn_function("ppo1") is ppo1.learn
    assert algos.get_learn_function("deepq") is algos.get_learn_function("dqn") is dqn.learn
    assert algos.get_defaults("ppo2", "classic_control")["nsteps"] == 128
    assert algos.get_defaults("ppo1", "mujoco")["value_network"] == "copy"
    assert algos.get_defaults("deepq", "classic_control") == {"gamma": 0.99, "train_freq": 1}
    for alg, item in (("a2c", "item 6"), ("trpo_mpi", "item 7"), ("acer", "item 7")):
        with pytest.raises(NotImplementedError, match=item):
            algos.get_learn_function(alg)
    for alg in jax_algos.algo_names():
        if alg not in algos.algo_names():
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                algos.get_defaults(alg, "classic_control")
    with pytest.raises(ValueError, match="unknown algorithm"):
        algos.get_learn_function("sac")
    with pytest.raises(NotImplementedError, match="item 7"):
        run.main(["--alg=ddpg", "--env=CartPole-v1", "--device=cpu", "--num_timesteps=0"])
    for alg in ("ppo2", "ppo1"):
        for env_type in ("atari", "mujoco", "classic_control", "robotics", "testing"):
            want = jax_algos.get_defaults(alg, env_type)
            got = algos.get_defaults(alg, env_type)
            assert set(got) == set(want), (alg, env_type)
            for k, v in want.items():
                assert (got[k](0.5) == v(0.5)) if callable(v) else got[k] == v, (alg, env_type, k)
