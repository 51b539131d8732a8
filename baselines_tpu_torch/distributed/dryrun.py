"""One update of each data-parallel learner on W ranks (the port's counterpart of
``__graft_entry__.dryrun_multichip``).

    python -m baselines_tpu_torch.distributed.dryrun 2            # W cards, NCCL
    python -m baselines_tpu_torch.distributed.dryrun 2 --device=cpu   # gloo

``dryrun_multichip(world)`` starts ``world`` processes, one for each rank (rank r on
card r, or all on the CPU), joined through a ``file://`` rendezvous in a temporary
directory. Each trains every learner with an ``mlp`` under ``mesh=make_mesh()``, one
update (or a few deepq training iterations, one ddpg or her cycle) each: ppo2, ppo1,
deepq, a2c, trpo, acktr and acer on CartPole-v1, ppo2 on the native engine's CartPole
(a host pool under the mesh), ddpg on Pendulum-v1, her on
PointReach-v0 and gail on BoxIdentity-v0 from an expert ``.npz`` that the rank writes
beside the rendezvous; and checks that the params are finite and equal on every rank.
It returns each rank's report and raises when a rank fails or takes longer than
``RANK_TIMEOUT_S``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RANK_TIMEOUT_S = 600  # a rank that takes longer fails the dry run


def _rank_main(rank: int, world: int, rendezvous: str, device: str) -> None:
    """The body of one rank."""
    import numpy as np

    from baselines_tpu_torch.algos import get_learn_function
    from baselines_tpu_torch.core import logger
    from baselines_tpu_torch.distributed import (make_mesh, maybe_initialize_distributed,
                                                 param_consistency_check)

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    maybe_initialize_distributed(device=device, init_method=f"file://{rendezvous}")
    mesh = make_mesh()
    logger.configure_for_process(rank, format_strs=[])
    num_envs = 2 * world
    expert = os.path.join(os.path.dirname(rendezvous), f"expert.{rank}.npz")
    expert_obs = np.random.RandomState(0).uniform(-1, 1, (1, 256, 1)).astype(np.float32)
    np.savez(expert, obs=expert_obs, acs=expert_obs)
    runs = {
        "ppo2": dict(total_timesteps=num_envs * 8, nsteps=8, nminibatches=2, noptepochs=2),
        "ppo2 native": dict(alg="ppo2", env_id="native:CartPole-v1",
                            total_timesteps=num_envs * 8, nsteps=8, nminibatches=2,
                            noptepochs=2),
        "ppo1": dict(total_timesteps=num_envs * 16, timesteps_per_actorbatch=num_envs * 16,
                     optim_epochs=2, optim_batchsize=4 * world),
        "deepq": dict(total_timesteps=num_envs * 24, learning_starts=num_envs * 8,
                      batch_size=2 * world, buffer_size=num_envs * 64, chunk_size=8,
                      prioritized_replay=True, print_freq=0),
        "a2c": dict(total_timesteps=num_envs * 8, nsteps=8),
        "trpo": dict(total_timesteps=num_envs * 16, timesteps_per_batch=num_envs * 16,
                     vf_iters=1),
        "acktr": dict(total_timesteps=num_envs * 8, nsteps=8, cold_iter=0),
        "acer": dict(total_timesteps=num_envs * 16, nsteps=8, replay_start=num_envs * 8,
                     buffer_size=num_envs * 64, replay_ratio=1),
        "ddpg": dict(env_id="Pendulum-v1", nb_epochs=1, nb_epoch_cycles=1,
                     nb_rollout_steps=16, nb_train_steps=2, batch_size=16, noise_type="ou_0.2"),
        "her": dict(env_id="PointReach-v0", total_timesteps=1, n_cycles=1, n_batches=2,
                    batch_size=16, n_test_rollouts=num_envs),
        "gail": dict(env_id="BoxIdentity-v0", total_timesteps=num_envs * 16,
                     timesteps_per_batch=num_envs * 16, vf_iters=1, g_step=1,
                     expert_path=expert),
    }
    for name, kwargs in runs.items():
        kwargs = {"env_id": "CartPole-v1", **kwargs}
        alg = kwargs.pop("alg", name)
        model = get_learn_function(alg)(network="mlp", seed=0, num_envs=num_envs, mesh=mesh,
                                        **kwargs)
        params = list(model.policy.module.parameters())
        if not all(bool(torch.isfinite(p).all()) for p in params):
            raise RuntimeError(f"{name}: params are not finite on rank {rank}")
        if not param_consistency_check(params, mesh, atol=0.0):
            raise RuntimeError(f"{name}: the ranks' params differ")
        print(f"rank {rank}/{world} on {mesh.device}: {name} ok", flush=True)
    torch.distributed.destroy_process_group()


def dryrun_multichip(world: int, device: str | None = None) -> list:
    """Run the dry run on ``world`` ranks: on cards 0..world-1 with NCCL (``device``
    None), or on the CPU with gloo (``device="cpu"``). Returns each rank's output."""
    if device is None and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} cards, found "
                           f"{torch.cuda.device_count()}: NCCL puts no two ranks on one GPU")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "baselines_tpu_torch.distributed.dryrun", str(world),
             f"--device={device or 'cuda'}", f"--rank={rank}", f"--rendezvous={rendezvous}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]
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
        if p.returncode != 0:
            raise RuntimeError(f"dry run rank {rank} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("world", type=int)
    parser.add_argument("--device", default=None, help="cpu for gloo ranks; the cards by default")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.rendezvous, args.device)
        return 0
    device = None if args.device in (None, "cuda") else args.device
    for out in dryrun_multichip(args.world, device):
        print(out, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
