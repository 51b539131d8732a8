"""The host env path of the port end to end on the CPU: ppo2's pipeline rule, run.main on
a native: id and on a gymnasium id (save, play, then the --load_path round trip bit for
bit with the same play report), her on gymnasium-robotics' FetchReach-v4 through
run.main with --play on dict observations, and the profiler."""

import contextlib
import io
import json
import math

import pytest
import torch

from baselines_tpu_torch import run
from baselines_tpu_torch.algos.ppo.ppo import learn
from baselines_tpu_torch.core import logger, profiler
from baselines_tpu_torch.envs.host_pipeline import PipeState
from baselines_tpu_torch.envs.vec import find_normalize_state


def _main(argv):
    """run.main(argv) with its output kept: (model, the play report line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            model = run.main(argv)
        finally:
            logger.reset()
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("episode_rew")]
    assert len(lines) == 1, out.getvalue()[-3000:]
    return model, lines[0]


def _same_params(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("kwargs,pipelined", [
    ({"env_id": "native:CartPole-v1", "num_envs": 4}, True),
    ({"env_id": "native:CartPole-v1", "num_envs": 3}, False),
    ({"env_id": "native:CartPole-v1", "num_envs": 4, "pipeline": False}, False),
    ({"env_id": "native:CartPole-v1", "num_envs": 4, "network": "lstm"}, False),
    ({"env_id": "CartPole-v1", "num_envs": 4}, False),
], ids=["native_even", "native_odd", "pipeline_false", "lstm", "device_env"])
def test_ppo2_pipeline_rule(kwargs, pipelined):
    """pipeline=None pipelines, as the JAX package's rule does (ppo.py:423-440), an env id
    that is not a device env with an even env count and a string network that is not
    recurrent; the pipelined state is a PipeState over two groups of half the envs."""
    kwargs = dict({"network": "mlp"}, **kwargs)
    model = learn(total_timesteps=0, nsteps=8, device="cpu", seed=0, **kwargs)
    env_state = model.state.env_state
    assert isinstance(env_state, PipeState) == pipelined
    if pipelined:
        assert env_state.obs_a.shape == (2, 4) and env_state.pend_act_b.shape == (2,)


def test_run_main_native_saves_plays_and_loads(tmp_path):
    """ppo2 on native:CartPole-v1 through run.main (4 envs, so pipelined), 4 updates,
    --save_path and --play; --load_path of that file with --num_timesteps=0: the same
    params bit for bit and the same play report."""
    path = str(tmp_path / "ppo2.pt")
    argv = ["--alg=ppo2", "--env=native:CartPole-v1", "--num_env=4", "--nsteps=32",
            "--seed=0", "--device=cpu", "--play"]
    model, report = _main(argv + ["--num_timesteps=512", f"--save_path={path}",
                                  f"--log_path={tmp_path / 'a'}"])
    assert isinstance(model.state.env_state, PipeState)
    rows = open(tmp_path / "a" / "progress.csv").read().splitlines()
    assert len(rows) == 2  # the header and update 1's row (log_interval 10)
    loaded, report2 = _main(argv + ["--num_timesteps=0", f"--load_path={path}",
                                    f"--log_path={tmp_path / 'b'}"])
    assert _same_params(model.policy.module, loaded.policy.module)
    assert report2 == report


def test_run_main_gymnasium_mujoco_saves_plays_and_loads(tmp_path):
    """ppo2 on MuJoCo's InvertedPendulum-v4 (a gymnasium id, so a host pool, and a mujoco
    env, so VecNormalize) through run.main, pipelined over 2 envs: the saved params and
    both running statistics come back bit for bit and play the same report."""
    pytest.importorskip("mujoco")
    path = str(tmp_path / "ppo2.pt")
    argv = ["--alg=ppo2", "--env=InvertedPendulum-v4", "--num_env=2", "--nsteps=16",
            "--seed=0", "--device=cpu", "--play"]
    model, report = _main(argv + ["--num_timesteps=64", f"--save_path={path}",
                                  f"--log_path={tmp_path / 'a'}"])
    ns = find_normalize_state(model.state.env_state)
    assert isinstance(model.state.env_state, PipeState) and ns is not None
    assert float(ns.ob_rms.count) > 64
    loaded, report2 = _main(argv + ["--num_timesteps=0", f"--load_path={path}",
                                    f"--log_path={tmp_path / 'b'}"])
    assert _same_params(model.policy.module, loaded.policy.module)
    ls = find_normalize_state(loaded.state.env_state)
    for a, b in ((ns.ob_rms, ls.ob_rms), (ns.ret_rms, ls.ret_rms)):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    assert report2 == report


def test_her_fetchreach_through_run_main(tmp_path):
    """her on FetchReach-v4 (host pools of 2 envs for training and for the evaluator),
    one epoch of 2 cycles: finite losses, the env's horizon T = 50 and the FetchReach
    override of n_cycles taken from params.json's record, the train stream carried in
    the state, and --play on dict observations."""
    pytest.importorskip("gymnasium_robotics")
    argv = ["--alg=her", "--env=FetchReach-v4", "--num_env=2", "--n_cycles=2",
            "--n_batches=2", "--batch_size=16", "--num_hidden=16", "--seed=0",
            "--device=cpu", "--play", "--num_timesteps=200", f"--log_path={tmp_path}"]
    model, report = _main(argv)
    rows = open(tmp_path / "progress.csv").read().splitlines()
    header, last = rows[0].split(","), rows[-1].split(",")
    for key in ("train/loss_critic", "train/loss_actor", "test/success_rate"):
        assert math.isfinite(float(last[header.index(key)])), key
    params = json.load(open(tmp_path / "params.json"))
    assert params["T"] == 50 and params["n_cycles"] == 2 and params["n_epochs"] == 1
    assert model.state.n_episodes == 4 and model.state.obs["desired_goal"].shape == (2, 3)
    assert "episodes=" in report


def test_profiler_on_the_cpu(tmp_path):
    """trace writes a Chrome trace into its directory; annotate's ranges are in it and
    nest; device_timer gives seconds a call, above 0."""
    with profiler.trace(str(tmp_path)) as prof:
        with profiler.annotate("outer"):
            with profiler.annotate("inner"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    names = json.dumps(json.load(open(files[0])))
    assert "outer" in names and "inner" in names
    events = {e.name: e for e in prof.events() if e.name in ("outer", "inner")}
    outer, inner = events["outer"].time_range, events["inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    seconds = profiler.device_timer(lambda a: a @ a, torch.randn(32, 32), iters=3)
    assert seconds > 0
