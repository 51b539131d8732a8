"""One rank of the port's multi-rank tests on the CPU, and the helpers that start them.

    python torch_dist_worker.py <task> <workdir>

runs rank ``RANK`` of ``WORLD_SIZE`` (torchrun's variables, which ``run_ranks`` sets)
in a gloo group whose rendezvous is the file ``<workdir>/rendezvous``, so that test
processes running side by side race for no port. A task reads its inputs from
``<workdir>/spec.pt`` and writes its results to ``<workdir>/result.<rank>.pt``.

This module is the port's alone: it imports nothing of JAX, and ``run_ranks`` starts it
with jax, flax, optax and baselines_tpu blocked, so every multi-rank test also shows
that the port's distributed path stands without them. ``ReplayDraws``, the stand-in for
the port's ``Draws`` that serves recorded numbers, lives here for the same reason.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from baselines_tpu_torch.core import logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = "import sys\nfor m in ('jax', 'flax', 'optax', 'baselines_tpu'):\n    sys.modules[m] = None\n"
RANK_TIMEOUT_S = 300  # a rank that takes longer fails its test rather than the suite


class ReplayDraws:
    """Serves the port recorded draws, in the order it asks for them."""

    def __init__(self, queue=None):
        self.queue = list(queue or [])

    def push(self, kind: str, values) -> None:
        self.queue.append((kind, np.asarray(values)))

    def _pop(self, kind: str, shape) -> np.ndarray:
        assert self.queue, f"the port asked for more draws than were recorded ({kind})"
        got_kind, values = self.queue.pop(0)
        assert got_kind == kind and values.shape == tuple(shape), (
            f"the port asked for {kind} {tuple(shape)}, the next draw is {got_kind} "
            f"{values.shape}"
        )
        return values

    def uniform(self, shape, low, high):
        return torch.from_numpy(self._pop("uniform", shape).astype(np.float32))

    def randint(self, low, high, shape):
        return torch.from_numpy(self._pop("randint", shape).astype(np.int32))

    def normal(self, shape):
        return torch.from_numpy(self._pop("normal", shape).astype(np.float32))

    def permutation(self, n):
        return torch.from_numpy(self._pop("permutation", (n,)).astype(np.int64))


def run_ranks(task: str, workdir, world: int = 2, spec=None) -> list:
    """Run ``task`` on ``world`` gloo ranks in ``workdir`` (made if missing) and return
    each rank's result. A rank that fails or outlives ``RANK_TIMEOUT_S`` fails the
    caller, with the ranks' output."""
    workdir = os.fspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    if spec is not None:
        torch.save(spec, os.path.join(workdir, "spec.pt"))
    code = (BLOCKED + "import runpy\nsys.argv = sys.argv[1:]\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, os.path.abspath(__file__), task, workdir],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {task} exited {p.returncode}:\n{out[-6000:]}"
    return [torch.load(os.path.join(workdir, f"result.{rank}.pt"), weights_only=False)
            for rank in range(world)]


def _init(workdir: str):
    """Join the gloo group twice over (the second call is a no-op) and return the mesh."""
    from baselines_tpu_torch.distributed import make_mesh, maybe_initialize_distributed

    rendezvous = f"file://{os.path.join(workdir, 'rendezvous')}"
    assert maybe_initialize_distributed(device="cpu", init_method=rendezvous)
    assert maybe_initialize_distributed(device="cpu", init_method=rendezvous)
    return make_mesh()


class RecordingOutput(logger.KVWriter):
    """A logger output that keeps every row it is given."""

    def __init__(self):
        self.rows = []

    def writekvs(self, kvs):
        self.rows.append(dict(kvs))


def _recording_logger(rank: int, workdir: str) -> RecordingOutput:
    """The process's logger, configured for it, with a ``RecordingOutput`` added."""
    logger.configure_for_process(rank, dir=os.path.join(workdir, "log"), format_strs=[])
    recorder = RecordingOutput()
    logger.Logger.CURRENT.output_formats.append(recorder)
    return recorder


class CountCollectives:
    """Counts the calls of torch.distributed's collectives made inside the block."""

    NAMES = ("all_reduce", "all_gather", "all_gather_object", "broadcast", "barrier")

    def __enter__(self):
        self.calls = 0
        self.saved = {name: getattr(torch.distributed, name) for name in self.NAMES}

        def counted(fn):
            def call(*args, **kwargs):
                self.calls += 1
                return fn(*args, **kwargs)
            return call

        for name, fn in self.saved.items():
            setattr(torch.distributed, name, counted(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(torch.distributed, name, fn)


def task_collectives(mesh, spec, workdir):
    """psum and pmean, the row gather (of one tensor and of several fields at once), the
    moments merge, the consistency check, the weighted mean of the logger's rows,
    RunningMeanStd over the ranks' shards, the sharded draws, the state gather, and the
    monitor's episodes folded over the ranks."""
    from baselines_tpu_torch.algos.common import build_env
    from baselines_tpu_torch.core.rng import Draws, ShardedDraws
    from baselines_tpu_torch.core.running_stats import RunningMeanStd
    from baselines_tpu_torch.distributed import (host_weighted_mean, param_consistency_check,
                                                 pmean, psum)
    from baselines_tpu_torch.distributed.collectives import all_gather_fields, all_gather_rows
    from baselines_tpu_torch.envs.vec import EpisodeStats
    from baselines_tpu_torch.distributed.mesh import gather_state, shard_state

    r = mesh.rank
    out = {}
    f32 = [torch.full((2, 3), float(r + 1)), torch.full((5,), 0.5 * (r + 1))]
    out["psum"] = psum(f32, mesh) + psum([torch.arange(4, dtype=torch.int64) * (r + 1)], mesh)
    out["pmean"] = pmean(f32, mesh)
    out["rows"] = all_gather_rows(torch.arange(3) + 10 * r, mesh)
    fields = {"u8": torch.arange(24, dtype=torch.uint8).reshape(2, 3, 4) + 100 * r,
              "i32": torch.tensor([-1, 7], dtype=torch.int32) * (r + 1),
              "f32": torch.tensor([[0.5], [-2.25]]) + r, "bool": torch.tensor([True, r == 1])}
    with CountCollectives() as count:
        out["fields"] = all_gather_fields(fields, mesh)
    out["fields_calls"] = count.calls

    # the monitor over the ranks: spec["rewards"]/["dones"] are (T, 2 * n), rank r steps
    # columns [r * n, (r + 1) * n); the ring is folded in at the steps of spec["syncs"]
    n = spec["dones"].shape[1] // mesh.size
    stats = EpisodeStats.create(n, "cpu")
    with CountCollectives() as count:
        for t in range(spec["dones"].shape[0]):
            cols = slice(r * n, (r + 1) * n)
            stats = stats.update(spec["rewards"][t, cols], spec["dones"][t, cols], mesh)
            if t in spec["syncs"]:
                stats = stats.sync(mesh)
    out["episode_stats"] = (stats, count.calls)

    params = [torch.randn((4, 4), generator=torch.Generator().manual_seed(0)), torch.zeros(4)]
    out["consistent"] = param_consistency_check(params, mesh)
    if r == 1:
        params[0][0, 0] += 1e-3
    out["perturbed"] = param_consistency_check(params, mesh)

    x = spec["x"]
    n = x.shape[0] // mesh.size
    rms = RunningMeanStd.create((3,)).update(x[r * n:(r + 1) * n], axis_name=mesh)
    out["rms"] = (rms.mean, rms.var, rms.count)

    sharded = ShardedDraws(Draws(0, "cpu"), mesh)
    out["draws"] = (sharded.uniform((4, 3), -1.0, 1.0), sharded.randint(0, 9, (4,)),
                    sharded.normal((4, 2)), sharded.permutation(6))

    venv = build_env("CartPole-v1", 4, device="cpu", normalize=True, axis_name=mesh)
    _, state = venv.reset(ShardedDraws(Draws(1, "cpu"), mesh))
    whole = gather_state(state, mesh)
    out["state"] = (state, whole, shard_state(whole, mesh))

    out["weighted"] = host_weighted_mean({"probe": (float(r), r + 1), "text": ("a", 1)})
    logger.configure_for_process(r, dir=os.path.join(workdir, "log"),
                                 format_strs=["csv"] if r == 0 else None)
    logger.logkv_mean("probe", float(r))  # count 1 on each rank
    if r == 1:
        logger.logkv_mean("probe", 1.0)  # rank 1: mean 1.0 of 2
    out["dumped"] = logger.dumpkvs()
    logger.reset()
    return out


def task_ppo_update(mesh, spec, workdir):
    """One ppo2 update of each case of ``spec["cases"]`` from the given weights, env and
    the rank's share of the JAX update's draws."""
    from baselines_tpu_torch.algos.common import ClipAdam, build_env, mesh_metrics
    from baselines_tpu_torch.algos.ppo.ppo import PPOTrainState, make_update_fn
    from baselines_tpu_torch.core.schedules import resolve_fraction_schedule
    from baselines_tpu_torch.envs.testing.fixed_sequence import FixedSequenceEnv
    from baselines_tpu_torch.envs.vec import VecMonitor, VecTorchEnv
    from baselines_tpu_torch.nn.policy import build_policy

    results = {}
    for name, case in spec["cases"].items():
        nl = case["nenvs"] // mesh.size
        if case["env_id"] == "FixedSequence":
            venv = VecMonitor(VecTorchEnv(FixedSequenceEnv(10, episode_len=5), nl, "cpu"),
                              axis_name=mesh)
        else:
            venv = build_env(case["env_id"], nl, device="cpu", s2d=case["s2d"], axis_name=mesh,
                             **case["env_kwargs"])
        policy = build_policy(venv.observation_space, venv.action_space, case["network"],
                              device="cpu", **case["network_kwargs"])
        policy.module.load_state_dict(case["start"])
        opt = ClipAdam(policy.module.parameters(), 0.5, eps=1e-5, mesh=mesh)
        draws = ReplayDraws(case["draws"][mesh.rank])
        obs, env_state = venv.reset(draws)
        state = PPOTrainState(env_state=env_state, obs=obs,
                              last_done=torch.zeros((nl,), dtype=torch.bool),
                              rnn_state=policy.initial_state(nl))
        update_fn = make_update_fn(policy, venv, opt, lr_fn=resolve_fraction_schedule(3e-4),
                                   cliprange_fn=resolve_fraction_schedule(0.2),
                                   mesh=mesh, **case["hparams"], **case["options"])
        with CountCollectives() as count:
            new, metrics = update_fn(state, draws)
        metrics = mesh_metrics(metrics, mesh)
        stats = VecMonitor.get_stats(new.env_state)
        results[name] = dict(params=policy.module.state_dict(),
                             metrics={k: float(v) for k, v in metrics.items()},
                             reset_obs=obs, obs=new.obs, ep_return=stats.ep_return,
                             ep_length=stats.ep_length, episodes=int(stats.episodes),
                             ret_buffer=stats.ret_buffer, draws_left=len(draws.queue),
                             collectives=count.calls)
    return results


def task_learners(mesh, spec, workdir):
    """Each learner of ``spec["runs"]`` under the mesh: its final params, the logged
    rows and the monitor's ring."""
    from baselines_tpu_torch.algos import get_learn_function
    from baselines_tpu_torch.envs.vec import VecMonitor

    results = {}
    for name, (alg, kwargs) in spec["runs"].items():
        recorder = _recording_logger(mesh.rank, workdir)
        model = get_learn_function(alg)(device="cpu", mesh=mesh, **kwargs)
        stats = VecMonitor.get_stats(model.state.env_state)
        results[name] = dict(params=model.policy.module.state_dict(), rows=recorder.rows,
                             ret_buffer=stats.ret_buffer, len_buffer=stats.len_buffer,
                             episodes=int(stats.episodes))
        logger.reset()
    return results


def task_processes(mesh, spec, workdir):
    """ppo2 with mlp on CartPole-v1 as torchrun would run it: the log configured for
    the process, ``save_interval`` checkpoints in the log dir (and the resume from the
    latest of them), the params checked across the ranks, the logger's weighted mean."""
    from baselines_tpu_torch.algos.ppo import ppo
    from baselines_tpu_torch.core import checkpoint as ckpt
    from baselines_tpu_torch.distributed import param_consistency_check

    logdir = spec["logdir"]
    logger.configure_for_process(mesh.rank, dir=logdir,
                                 format_strs=["csv"] if mesh.rank == 0 else None)
    model = ppo.learn(env_id="CartPole-v1", network="mlp", seed=0, num_envs=8, nsteps=32,
                      nminibatches=4, noptepochs=2, total_timesteps=spec["total_timesteps"],
                      log_interval=1, save_interval=1, mesh=mesh, device="cpu")
    consistent = param_consistency_check(list(model.policy.module.parameters()), mesh)
    logger.logkv_mean("probe", float(mesh.rank))
    if mesh.rank == 1:
        logger.logkv_mean("probe", 1.0)
    dumped = logger.dumpkvs()
    logger.reset()
    return dict(tree=ckpt.to_tree(model._train_tree()), consistent=consistent, dumped=dumped)


TASKS = {"collectives": task_collectives, "ppo_update": task_ppo_update,
         "learners": task_learners, "processes": task_processes}


def main(argv) -> None:
    task, workdir = argv
    torch.set_num_threads(1)
    mesh = _init(workdir)
    spec_path = os.path.join(workdir, "spec.pt")
    spec = torch.load(spec_path, weights_only=False) if os.path.exists(spec_path) else None
    result = TASKS[task](mesh, spec, workdir)
    torch.save(result, os.path.join(workdir, f"result.{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
