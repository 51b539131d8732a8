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

import copy
import dataclasses
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
    """Serves the port recorded draws, in the order it asks for them. A recorded draw is
    (kind, values), or (kind, values, whole) for a rank of a mesh: ``whole`` says that
    the ranks take it alike, through ``replicated``, and not by env rows."""

    whole = False

    def __init__(self, queue=None):
        self.queue = list(queue or [])

    def push(self, kind: str, values) -> None:
        self.queue.append((kind, np.asarray(values)))

    def _pop(self, kind: str, shape) -> np.ndarray:
        assert self.queue, f"the port asked for more draws than were recorded ({kind})"
        got_kind, values, *whole = self.queue.pop(0)
        assert got_kind == kind and values.shape == tuple(shape), (
            f"the port asked for {kind} {tuple(shape)}, the next draw is {got_kind} "
            f"{values.shape}"
        )
        assert whole in ([], [self.whole]), (
            f"the port took {kind} {tuple(shape)} from the "
            f"{'replicated' if self.whole else 'env-axis'} draws, but the ranks take it "
            f"{'whole' if whole[0] else 'by env rows'}")
        return values

    def uniform(self, shape, low, high):
        return torch.from_numpy(self._pop("uniform", shape).astype(np.float32))

    def randint(self, low, high, shape):
        return torch.from_numpy(self._pop("randint", shape).astype(np.int32))

    def normal(self, shape):
        return torch.from_numpy(self._pop("normal", shape).astype(np.float32))

    def permutation(self, n):
        return torch.from_numpy(self._pop("permutation", (n,)).astype(np.int64))

    @property
    def replicated(self):
        """The same queue, for the draws that every rank takes alike: a rank's recording
        holds its rows of every env-axis draw and every replicated draw whole, in the
        order the port takes them."""
        view = copy.copy(self)  # shares the queue
        view.whole = True
        return view


def run_ranks(task: str, workdir, world: int = 2, spec=None, later=None) -> list:
    """Run ``task`` on ``world`` gloo ranks in ``workdir`` (made if missing) and return
    each rank's result. ``later``, where given, is called here once the ranks have
    started, and what it returns is written to ``<workdir>/later.pt`` for the tasks that
    wait for it (``task_sequence``), so that the ranks run the rest meanwhile. A rank that
    fails or outlives ``RANK_TIMEOUT_S`` fails the caller, with the ranks' output."""
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
        if later is not None:
            path = os.path.join(workdir, "later.pt")
            torch.save(later(), path + ".tmp")
            os.replace(path + ".tmp", path)  # whole, or not there
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
    channels_last = torch.arange(120, dtype=torch.float32).reshape(2, 3, 4, 5) * (r + 1)
    out["channels_last"] = psum([channels_last.contiguous(memory_format=torch.channels_last)],
                                mesh)[0]
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
    rms = RunningMeanStd.create((3,), device="cpu").update(x[r * n:(r + 1) * n], axis_name=mesh)
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
    """Each learner of ``spec["runs"]`` under the mesh: its final params (and whether
    ``param_consistency_check`` holds them equal on every rank), the logged rows and,
    where the learner has one, the monitor's ring, or her's episode buffer."""
    from baselines_tpu_torch.algos import get_learn_function
    from baselines_tpu_torch.distributed import param_consistency_check
    from baselines_tpu_torch.envs.vec import VecMonitor

    results = {}
    for name, (alg, kwargs) in spec["runs"].items():
        recorder = _recording_logger(mesh.rank, workdir)
        model = get_learn_function(alg)(device="cpu", mesh=mesh, **kwargs)
        results[name] = dict(
            params=model.policy.module.state_dict(), rows=recorder.rows,
            consistent=param_consistency_check(list(model.policy.module.parameters()), mesh,
                                               atol=0.0))
        env_state = getattr(model.state, "env_state", None)
        if dataclasses.is_dataclass(env_state):  # a monitored chain (not a host pool's count)
            stats = VecMonitor.get_stats(env_state)
            results[name].update(ret_buffer=stats.ret_buffer, len_buffer=stats.len_buffer,
                                 episodes=int(stats.episodes))
        if alg == "her":
            results[name]["buffer"] = model.state.buffer
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


def task_trpo_update(mesh, spec, workdir):
    """One trpo iteration of each case of ``spec["cases"]`` from the given weights, env
    and the rank's share of the JAX iteration's draws (its rows of the rollout's, the
    value epochs' permutations whole)."""
    from baselines_tpu_torch.algos.common import ClipAdam, build_env
    from baselines_tpu_torch.algos.trpo import trpo
    from baselines_tpu_torch.nn.policy import build_policy

    results = {}
    for name, case in spec["cases"].items():
        nl = case["nenvs"] // mesh.size
        venv = build_env(case["env_id"], nl, device="cpu", axis_name=mesh)
        policy = build_policy(venv.observation_space, venv.action_space, "mlp", device="cpu",
                              value_network="copy")
        policy.module.load_state_dict(case["start"])
        vf_opt = ClipAdam(trpo.split_params(policy.module)[1].values(), None, eps=1e-8)
        draws = ReplayDraws(case["draws"][mesh.rank])
        obs, env_state = venv.reset(draws)
        state = trpo.TRPOTrainState(env_state=env_state, obs=obs,
                                    last_done=torch.zeros((nl,), dtype=torch.bool))
        update_fn = trpo.make_update_fn(policy, venv, vf_opt, nsteps=case["nsteps"], mesh=mesh,
                                        **case["hparams"])
        with CountCollectives() as count:
            new, metrics = update_fn(state, draws)
        results[name] = dict(params=policy.module.state_dict(),
                             metrics={k: float(v) for k, v in metrics.items()},
                             obs=new.obs, draws_left=len(draws.queue), collectives=count.calls)
    return results


def task_acktr_update(mesh, spec, workdir):
    """Two acktr updates of each case of ``spec["cases"]`` (a cold-start step, then a
    K-FAC step) from the given weights, env and the rank's share of the JAX updates'
    draws (its rows of the rollouts', the Fisher noise whole)."""
    from baselines_tpu_torch.algos.acktr import acktr, kfac
    from baselines_tpu_torch.algos.common import build_env, mesh_metrics

    results = {}
    for name, case in spec["cases"].items():
        nl = case["nenvs"] // mesh.size
        venv = build_env(case["env_id"], nl, device="cpu", axis_name=mesh)
        net = acktr.KfacPolicyNet(venv.observation_space, venv.action_space, case["network"])
        net.load_state_dict(case["start"])
        policy = acktr.KfacPolicy(net, venv.observation_space, venv.action_space)
        draws = ReplayDraws(case["draws"][mesh.rank])
        obs, env_state = venv.reset(draws)
        state = acktr.ACKTRTrainState(
            env_state=env_state, obs=obs, last_done=torch.zeros((nl,), dtype=torch.bool),
            kfac=kfac.init_kfac(net.layer_dims, net.parameters(), "cpu"))
        update_fn = acktr.make_update_fn(policy, venv, mesh=mesh, **case["hparams"])
        with CountCollectives() as count:
            for _ in range(2):
                state, metrics = update_fn(state, draws)
        metrics = mesh_metrics(metrics, mesh)
        results[name] = dict(params=net.state_dict(), momentum=state.kfac.momentum,
                             factors=[(layer.A, layer.S) for layer in state.kfac.layers],
                             step=state.kfac.step, metrics={k: float(v) for k, v in
                                                            metrics.items()},
                             draws_left=len(draws.queue), collectives=count.calls)
    return results


def acer_two_updates(case: dict, mesh=None, draws=None, start=None) -> dict:
    """An acer on-policy update of ``case["num_envs"]`` envs (split over the mesh's
    ranks), then a replay update of a chunk sampled for as many envs, from ``start``'s
    weights and ``draws`` (where None, the init and the draws of ``case["seed"]``): the
    reset's observations, the start params, and after each update the params, the
    average policy's and the metrics (reduced over the ranks); then RMSProp's ``nu`` by
    name and its count, the ring (``ring``) and its ``ChunkReplay`` (``layout``). The
    port's one process and the mesh runs call it."""
    from baselines_tpu_torch.algos.acer import acer
    from baselines_tpu_torch.algos.common import ClipRMSProp, build_env, mesh_metrics
    from baselines_tpu_torch.core.rng import Draws, ShardedDraws
    from baselines_tpu_torch.distributed.mesh import local_num_envs
    from baselines_tpu_torch.nn.policy import build_policy

    seed, nsteps = case["seed"], case["nsteps"]
    venv = build_env(case["env_id"], local_num_envs(mesh, case["num_envs"]), device="cpu",
                     axis_name=mesh, frame_stack=case.get("frame_stack", 0))
    policy = build_policy(venv.observation_space, venv.action_space, "mlp", device="cpu",
                          generator=torch.Generator().manual_seed(seed), estimate_q=True,
                          **case.get("network_kwargs", {}))
    if start is not None:
        policy.module.load_state_dict(start)
    opt = ClipRMSProp(policy.module.parameters(), 10.0, mesh=mesh)
    replay = acer.ChunkReplay(case.get("capacity", 16), nsteps, venv.observation_space,
                              venv.action_space.n, case.get("dedup_frames", 0))
    if draws is None:
        draws = Draws(seed, "cpu") if mesh is None else ShardedDraws(Draws(seed, "cpu"), mesh)
    obs, env_state = venv.reset(draws)
    state = acer.ACERTrainState(env_state=env_state, obs=obs, replay=replay.init("cpu"),
                                avg=copy.deepcopy(policy.module))
    onpolicy, replayed = acer.make_update_fns(
        policy, venv, opt, replay, nsteps=nsteps, lr=7e-4, lrschedule="linear",
        nupdates=case.get("nupdates", 4), mesh=mesh, q_coef=0.5, ent_coef=0.01, gamma=0.99,
        c=10.0, trust_region=case.get("trust_region", True), alpha=0.99, delta=1.0)
    out = {"reset_obs": obs, "start": copy.deepcopy(policy.module.state_dict())}
    for kind, fn in (("onpolicy", onpolicy), ("replay", replayed)):
        state, metrics = fn(state, draws)
        out[kind] = dict(params=copy.deepcopy(policy.module.state_dict()),
                         avg=copy.deepcopy(state.avg.state_dict()),
                         metrics={k: float(v) for k, v in
                                  mesh_metrics(metrics, mesh, ev_name="ev_q").items()})
    names = [name for name, _ in policy.module.named_parameters()]
    out.update(nu=dict(zip(names, opt.nu)), count=opt.count, ring=state.replay, layout=replay,
               replay_size=state.replay.size)
    return out


def task_acer_updates(mesh, spec, workdir):
    """``acer_two_updates`` of each case of ``spec["cases"]``: from its seed's init and
    draws, or from ``case["start"]`` and the rank's recording ``case["draws"][rank]``."""
    out = {}
    for name, case in spec["cases"].items():
        draws = ReplayDraws(case["draws"][mesh.rank]) if "draws" in case else None
        out[name] = acer_two_updates(case, mesh, draws, case.get("start"))
        if draws is not None:
            out[name]["draws_left"] = len(draws.queue)
    return out


def _load_actor_critic(start: dict, policy, state) -> None:
    """ddpg's or her's actor, critic and their targets from ``start`` ("actor",
    "critic": state dicts)."""
    for module, which in ((policy.module, "actor"), (state.target_actor, "actor"),
                          (policy.critic, "critic"), (state.target_critic, "critic")):
        module.load_state_dict(start[which])


def ddpg_cycle(spec: dict, draws, mesh=None):
    """One ddpg cycle of ``spec["nenvs"]`` envs (split over the mesh's ranks) of
    ``spec["env_id"]``, from ``spec["start"]``'s weights and ``draws``: ``learn`` builds
    the learner with ``spec["kwargs"]`` (nothing trained), the env resets, the cycle
    runs. Returns (model, the reset's observations, the state after the cycle, the last
    train step's losses)."""
    from baselines_tpu_torch.algos.common import build_env
    from baselines_tpu_torch.algos.ddpg import ddpg
    from baselines_tpu_torch.distributed.mesh import local_num_envs

    venv = build_env(spec["env_id"], local_num_envs(mesh, spec["nenvs"]), device="cpu",
                     normalize=False, axis_name=mesh)
    model = ddpg.learn(env=venv, nb_epochs=0, device="cpu", mesh=mesh, **spec["kwargs"])
    _load_actor_critic(spec["start"], model.policy, model.state)
    obs, env_state = venv.reset(draws)
    state = dataclasses.replace(model.state, obs=obs, env_state=env_state)
    state, losses = model.cycle(state, draws)
    return model, obs, state, losses


def her_cycle(spec: dict, draws, mesh=None):
    """One her cycle on PointReach-v0 (``spec["kwargs"]``'s episodes split over the
    mesh's ranks), from ``spec["start"]``'s weights and ``draws``: ``learn`` builds the
    learner (nothing trained), the cycle runs. Returns (model, the state after the
    cycle, the last train step's losses)."""
    from baselines_tpu_torch.algos.her import her

    model = her.learn(env_id="PointReach-v0", total_timesteps=0, device="cpu", mesh=mesh,
                      **spec["kwargs"])
    _load_actor_critic(spec["start"], model.policy, model.state)
    state, losses = model.cycle(model.state, draws)
    return model, state, losses


def task_cycles(mesh, spec, workdir):
    """One ddpg cycle of each case of ``spec["ddpg"]`` and one her cycle of
    ``spec["her"]``, each from the given weights and the rank's recording of the JAX
    learner's draws (its rows of the env-axis draws, the replicated ones whole): the
    state after the cycle with the actor and the critic, the draws left and the
    collectives made."""
    results = {}
    for name, case in [*((f"ddpg_{n}", c) for n, c in spec["ddpg"].items()),
                       ("her", spec["her"])]:
        draws = ReplayDraws(case["draws"][mesh.rank])
        with CountCollectives() as count:
            if name == "her":
                model, state, losses = her_cycle(case, draws, mesh)
                obs = None
            else:
                model, obs, state, losses = ddpg_cycle(case, draws, mesh)
        results[name] = dict(reset_obs=obs, state=state, losses=losses,
                             actor=model.policy.module, critic=model.policy.critic,
                             draws_left=len(draws.queue), collectives=count.calls)
    return results


def task_trpo_checkpoints(mesh, spec, workdir):
    """trpo under the mesh with a checkpoint each iteration in the log dir, then a
    second run in a fresh log dir resumed from the checkpoint of iteration 2: each run's
    whole train state, the checkpoints written, and the writes this rank made."""
    import shutil

    from baselines_tpu_torch.algos.trpo import trpo
    from baselines_tpu_torch.core import checkpoint as ckpt

    writes = []
    save_state = ckpt.save_state

    def counted_save(path, tree):
        writes.append(os.path.basename(path))
        save_state(path, tree)

    ckpt.save_state = counted_save
    out = {}
    try:
        for run in ("full", "resumed"):
            logdir = os.path.join(workdir, f"trpo_{run}")
            if run == "resumed" and mesh.rank == 0:
                os.makedirs(os.path.join(logdir, "checkpoints"))
                shutil.copy(os.path.join(workdir, "trpo_full", "checkpoints", "00002"),
                            os.path.join(logdir, "checkpoints"))
            torch.distributed.barrier()
            logger.configure_for_process(mesh.rank, dir=logdir, format_strs=[])
            model = trpo.learn(device="cpu", mesh=mesh, save_interval=1, **spec["kwargs"])
            logger.reset()
            out[run] = dict(tree=ckpt.to_tree(model._train_tree()), iters=model.state.iters,
                            checkpoints=sorted(os.listdir(os.path.join(logdir, "checkpoints"))))
    finally:
        ckpt.save_state = save_state
    out["writes"] = writes
    return out


def task_sequence(mesh, spec, workdir):
    """Several tasks in one pair of processes: ``spec["tasks"]`` maps a name to (task,
    its spec); a spec that is None is the entry of that name in ``<workdir>/later.pt``,
    waited for (``run_ranks``' ``later``). Returns each task's result by name."""
    import time

    path, later = os.path.join(workdir, "later.pt"), None
    out = {}
    for name, (task, sub) in spec["tasks"].items():
        if sub is None:
            deadline = time.monotonic() + RANK_TIMEOUT_S
            while later is None:
                if os.path.exists(path):
                    later = torch.load(path, weights_only=False)
                else:
                    assert time.monotonic() < deadline, f"{path} never came"
                    time.sleep(0.05)
            sub = later[name]
        out[name] = TASKS[task](mesh, sub, workdir)
    return out


TASKS = {"collectives": task_collectives, "ppo_update": task_ppo_update,
         "learners": task_learners, "processes": task_processes,
         "trpo_update": task_trpo_update, "acktr_update": task_acktr_update,
         "acer_updates": task_acer_updates, "trpo_checkpoints": task_trpo_checkpoints,
         "cycles": task_cycles, "sequence": task_sequence}


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
