"""The port's learners on two gloo ranks against the same learners in one process, from
the same seed (the analog of tests/test_mesh_learners.py and tests/test_multiprocess.py).

- a2c and prioritized deepq on DiscreteIdentity-v0 at tests/test_mesh_learners.py's
  configurations (deepq's chunks cut from 128 to 32 iterations, which moves only its
  log rows, to four of them): the two-rank params within that file's 5e-3 of the one-process params
  (the sums of the gradient mean and the moments run in another order), the logged
  eprewmean and the monitor's ring equal, since every rank's draws are its rows of the
  one-process draws and the ring takes both ranks' episodes in env order; ppo1, whose
  shuffle is shard-local, finite and alike on both ranks.
- Two processes started with torchrun's variables train ppo2 with mlp on CartPole-v1:
  ``maybe_initialize_distributed`` may be called twice, only rank 0 writes
  progress.csv, the logger's rows are count-weighted means over the ranks, and a run
  resumed on two ranks from a ``save_interval`` checkpoint ends bit for bit where the
  uninterrupted two-rank run ends.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from torch_dist_worker import RecordingOutput, run_ranks

from baselines_tpu_torch.algos import get_learn_function
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.envs.vec import VecMonitor

RUNS = {
    "a2c": ("a2c", dict(env_id="DiscreteIdentity-v0", network="mlp", total_timesteps=1280,
                        seed=0, num_envs=8, nsteps=16, gamma=0.9, log_interval=1)),
    "deepq": ("deepq", dict(env_id="DiscreteIdentity-v0", network="mlp",
                            total_timesteps=1536, seed=0, num_envs=8, lr=1e-3, gamma=0.9,
                            learning_starts=256, train_freq=1, batch_size=64,
                            chunk_size=32, buffer_size=4096, prioritized_replay=True,
                            print_freq=2)),
    "ppo1": ("ppo1", dict(env_id="CartPole-v1", network="mlp", total_timesteps=1024, seed=0,
                          num_envs=8, timesteps_per_actorbatch=256, optim_epochs=2,
                          optim_batchsize=64)),
}


def _one_process(alg, kwargs):
    recorder = RecordingOutput()
    logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
    try:
        model = get_learn_function(alg)(device="cpu", **kwargs)
    finally:
        logger.reset()
    stats = VecMonitor.get_stats(model.state.env_state)
    return dict(params=model.policy.module.state_dict(), rows=recorder.rows,
                ret_buffer=stats.ret_buffer, len_buffer=stats.len_buffer,
                episodes=int(stats.episodes))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    ranks = run_ranks("learners", tmp_path_factory.mktemp("learners"), spec={"runs": RUNS})
    return {name: dict(mesh=[out[name] for out in ranks],
                       single=_one_process(*RUNS[name]) if name != "ppo1" else None)
            for name in RUNS}


@pytest.mark.parametrize("name", ["a2c", "deepq"])
def test_two_ranks_match_one_process(runs, name):
    """The params within 5e-3 (tests/test_mesh_learners.py:130) and alike on both
    ranks."""
    single = runs[name]["single"]["params"]
    a, b = (out["params"] for out in runs[name]["mesh"])
    for k, want in single.items():
        assert torch.equal(a[k], b[k]), k
        torch.testing.assert_close(a[k], want, atol=5e-3, rtol=5e-3)
        assert bool(torch.isfinite(a[k]).all())


@pytest.mark.parametrize("name", ["a2c", "deepq"])
def test_two_ranks_log_the_one_process_episodes(runs, name):
    """The eprewmean (deepq's mean 100 episode reward) that rank 0 logs, row by row, and
    every rank's ring of the last 100 episodes, equal to the one process's; rank 1
    writes no row."""
    key = "eprewmean" if name == "a2c" else "mean 100 episode reward"
    single = runs[name]["single"]
    rank0, rank1 = runs[name]["mesh"]
    assert len(single["rows"]) >= 4 and rank1["rows"] == []
    assert single["episodes"] >= 8  # each env has ended an episode of 100 steps
    np.testing.assert_array_equal([r[key] for r in rank0["rows"]],
                                  [r[key] for r in single["rows"]])  # nan before an end
    for out in (rank0, rank1):
        assert torch.equal(out["ret_buffer"], single["ret_buffer"])
        assert torch.equal(out["len_buffer"], single["len_buffer"])
        assert out["episodes"] == single["episodes"]


def test_ppo1_on_two_ranks_is_finite(runs):
    a, b = (out["params"] for out in runs["ppo1"]["mesh"])
    for k in a:
        assert torch.equal(a[k], b[k]) and bool(torch.isfinite(a[k]).all()), k


def _ppo_processes(workdir, total_timesteps, resume_from=None):
    logdir = os.path.join(workdir, "log")
    if resume_from is not None:
        os.makedirs(os.path.join(logdir, "checkpoints"))
        shutil.copy(resume_from, os.path.join(logdir, "checkpoints"))
    outs = run_ranks("processes", workdir,
                     spec={"logdir": logdir, "total_timesteps": total_timesteps})
    return outs, logdir


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    """Four updates of 8 envs x 32 steps on two processes with a checkpoint at each,
    and a second pair of processes resumed from the checkpoint of update 2."""
    full_dir = tmp_path_factory.mktemp("processes_full")
    full, full_log = _ppo_processes(full_dir, 4 * 8 * 32)
    resumed, resumed_log = _ppo_processes(
        tmp_path_factory.mktemp("processes_resumed"), 4 * 8 * 32,
        resume_from=os.path.join(full_log, "checkpoints", "00002"))
    return dict(full=full, full_log=full_log, resumed=resumed, resumed_log=resumed_log)


def test_processes_log_from_rank_0(processes):
    """Only rank 0 writes progress.csv, one row an update and one of the probe; rank 1
    keeps a log of its own; the replicas' params agree; the weighted mean is (0 * 1 +
    1 * 2) / 3."""
    log = processes["full_log"]
    assert os.path.exists(os.path.join(log, "progress.csv"))
    assert not os.path.exists(os.path.join(log, "progress-proc001.csv"))
    assert os.path.exists(os.path.join(log, "log-proc001.txt"))
    with open(os.path.join(log, "progress.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 4 + 1
    for out in processes["full"]:
        assert out["consistent"]
        assert out["dumped"]["probe"] == pytest.approx(2.0 / 3.0, rel=1e-6)


def test_processes_checkpoint_is_the_one_process_layout(processes):
    """Rank 0 writes each checkpoint with the whole state of the 8 envs."""
    tree = torch.load(os.path.join(processes["full_log"], "checkpoints", "00004"),
                      weights_only=True)
    assert tree["state"]["obs"].shape == (8, 4)
    assert tree["state"]["update_idx"] == 4
    assert sorted(os.listdir(os.path.join(processes["full_log"], "checkpoints"))) == [
        "00001", "00002", "00003", "00004"]


def test_processes_resume_reproduces_uninterrupted_run(processes):
    """Resumed on two ranks from update 2, the run ends bit for bit where the
    uninterrupted two-rank run ends, on each rank: params, Adam moments and count, the
    rank's envs and observations, the generator's state."""
    assert sorted(os.listdir(os.path.join(processes["resumed_log"], "checkpoints"))) == [
        "00002", "00003", "00004"]

    def walk(x, y, where):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), where
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), where
            for k in x:
                walk(x[k], y[k], f"{where}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, (a, b) in enumerate(zip(x, y)):
                walk(a, b, f"{where}[{i}]")
        else:
            assert x == y, where

    for rank, (a, b) in enumerate(zip(processes["full"], processes["resumed"])):
        walk(a["tree"], b["tree"], f"rank {rank}")
        assert a["tree"]["state"]["update_idx"] == 4
        assert a["tree"]["state"]["obs"].shape == (4, 4)
