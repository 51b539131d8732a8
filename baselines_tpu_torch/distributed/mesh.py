"""The data-parallel mesh on ``torch.distributed`` (counterpart of
baselines_tpu/distributed/mesh.py, the replacement of the reference's MPI topology,
mpi_util.py and mpi_fork.py).

The JAX package runs one controller over a ``jax.sharding.Mesh`` of devices and lets
XLA compile the gradient mean into the update. The port runs one process for each card,
as PyTorch does, launched by ``torchrun`` (or by a test harness), and a ``Mesh`` is that
process's view of the group:

- every rank holds ``num_envs / size`` of the envs, the rank's rows of the global env
  axis (``local_num_envs``);
- every rank holds a whole replica of the params and the optimizer state;
- gradients and batch statistics cross the ranks through the collectives of
  ``collectives.py``, so that a W-rank run computes the numbers of the JAX package's
  mesh run, up to the order of float sums.

``maybe_initialize_distributed`` joins the group from torchrun's variables (NCCL for the
card, gloo for the CPU); ``make_mesh`` returns the ``Mesh``. ``gather_state`` and
``shard_state`` are the analog of ``shard_train_state`` (mesh.py:101-119): the leaves
of a train state are the rank's env rows, except the fields a state dataclass names in
its ``replicated_fields`` (episode rings, running statistics, replay rings, target
nets), which every rank holds whole. A checkpoint holds the gathered state, the layout
of a one-process run, and every rank keeps its rows of it on load.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from baselines_tpu_torch.distributed.collectives import all_gather_rows

DATA_AXIS = "dp"
# a rank that dies makes the others fail after this long instead of hanging
GROUP_TIMEOUT_S = 120


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh seen from one rank: the process group (None for the
    default group), this rank, the number of ranks, and this rank's device."""

    group: Any
    rank: int
    size: int
    device: torch.device


def maybe_initialize_distributed(device=None, init_method: str | None = None) -> bool:
    """Join the process group that torchrun's variables describe (mesh.py:34-62):
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, and ``MASTER_ADDR``/``MASTER_PORT``
    unless ``init_method`` gives the rendezvous (a ``file://`` path, say). A no-op
    without ``RANK`` and ``WORLD_SIZE``, and when the group exists already; returns
    whether a group exists.

    ``device`` is the card unless ``"cpu"`` is given, as for the learners. On the card
    the backend is NCCL and the process first takes card ``LOCAL_RANK``, since NCCL
    puts no two ranks on one GPU; on the CPU it is gloo. The group's collectives time
    out after ``GROUP_TIMEOUT_S`` seconds."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if torch.device("cuda" if device is None else device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return True


def make_mesh(group=None) -> Mesh:
    """The mesh of ``group`` (the default group when None) as this rank sees it: on the
    current card for an NCCL group, on the CPU for a gloo one."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a torch.distributed process group: launch with "
                           "torchrun and call maybe_initialize_distributed() first")
    nccl = "nccl" in str(dist.get_backend(group))
    device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return Mesh(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group),
                device=device)


def check_mesh(mesh, where: str) -> None:
    """Raise ``TypeError`` unless ``mesh`` is None or a ``Mesh``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"{where} takes a baselines_tpu_torch.distributed.Mesh (from "
                        f"make_mesh), got {type(mesh).__name__}")


def local_num_envs(mesh: Mesh | None, num_envs: int) -> int:
    """The envs a rank steps: ``num_envs / size`` (all of them without a mesh)."""
    if mesh is None:
        return num_envs
    if num_envs % mesh.size:
        raise ValueError(f"num_envs={num_envs} must be divisible by the mesh's size "
                         f"{mesh.size}")
    return num_envs // mesh.size


def barrier(mesh: Mesh) -> None:
    dist.barrier(group=mesh.group)


def _map_env_leaves(fn, obj):
    """``obj`` with ``fn`` applied to every tensor on the env axis: every tensor leaf of
    nested dataclasses but those under a field named in the dataclass's
    ``replicated_fields``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        keep = getattr(obj, "replicated_fields", ())
        return dataclasses.replace(obj, **{
            f.name: _map_env_leaves(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name not in keep})
    return obj


def gather_state(state, mesh: Mesh):
    """The train state of the whole mesh, as one process holding every env would hold
    it: each env-axis leaf gathered from the ranks in env order, the replicated fields
    as they are. Collective."""
    return _map_env_leaves(lambda x: all_gather_rows(x, mesh), state)


def shard_state(state, mesh: Mesh):
    """This rank's rows of a whole train state's env-axis leaves (``gather_state``'s
    inverse)."""

    def rows(x):
        n = x.shape[0] // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n].clone()

    return _map_env_leaves(rows, state)
