"""Collectives over a data-parallel mesh (counterpart of
baselines_tpu/distributed/collectives.py, after the reference's mpi_moments.py,
mpi_util.py and the checks of mpi_adam.py).

The JAX package reduces inside its jitted programs with ``lax.psum``/``pmean``; the
port's ranks are processes, so these helpers call ``torch.distributed`` on the mesh's
group (NCCL on the card, gloo on the CPU). Every helper is collective: each rank of the
mesh calls it, in the same order.

- ``psum``/``pmean``: the sum or mean over the ranks of a list of tensors of one dtype,
  flattened into one all-reduce;
- ``all_gather_rows``: the ranks' tensors concatenated on axis 0, rank 0's rows first,
  which is how a rank's env rows sit in the global env axis; ``all_gather_fields`` does
  it for several tensors of any dtypes in one call;
- ``merge_moments``: the mean and variance of the union of equal-size shards from each
  shard's (running_stats.py:51-56), and ``merged_moments`` from moments already
  gathered;
- ``tree_sum_scalar`` and ``param_consistency_check``: the params' fingerprint, equal on
  every rank (MpiAdam.check_synced, mpi_adam.py:51-61);
- ``host_weighted_mean``: the count-weighted mean of logged scalars over the processes
  (mpi_util.py:110-132), through ``all_gather_object``.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def psum(tensors, mesh) -> list:
    """The sum over the ranks of each of ``tensors``, which share a dtype, flattened
    into one all-reduce (a collective costs host time whatever its size). Each sum keeps
    its tensor's memory layout (a conv's gradient may come channels-last), so that the
    reductions that read it later sum in the same order as without a mesh."""
    tensors = list(tensors)
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError(f"psum takes tensors of one dtype, got {[t.dtype for t in tensors]}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    parts = (part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                   tensors))
    return [part if t.is_contiguous() else torch.empty_like(t).copy_(part)
            for part, t in zip(parts, tensors)]


def pmean(tensors, mesh) -> list:
    """The mean over the ranks of each tensor of ``tensors``: ``psum`` over the mesh's
    size, which changes no value on one rank."""
    return [t / mesh.size for t in psum(tensors, mesh)]


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """(n, ...) on each rank -> (size * n, ...), rank r's rows at [r * n, (r + 1) * n)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def all_gather_fields(fields: dict, mesh) -> dict:
    """``all_gather_rows`` of every tensor of ``fields``, which share their leading
    axis, in one call: each rank's rows are packed into bytes, gathered once and
    unpacked."""
    n = next(iter(fields.values())).shape[0]
    parts = [x.contiguous().reshape(n, -1).view(torch.uint8) for x in fields.values()]
    widths = [p.shape[1] for p in parts]
    packed = all_gather_rows(torch.cat(parts, dim=1), mesh)
    return {k: col.contiguous().view(x.dtype).reshape((-1,) + tuple(x.shape[1:]))
            for (k, x), col in zip(fields.items(), packed.split(widths, dim=1))}


def merged_moments(means: torch.Tensor, variances: torch.Tensor):
    """(mean, var) of the union of equal-size shards from the shards' moments stacked
    on axis 0, as running_stats.py:51-56 merges them: the mean of the means, then the
    mean of ``var_r + (mean_r - mean)^2``. One shard's moments come back unchanged."""
    g_mean = means.mean(dim=0)
    return g_mean, (variances + torch.square(means - g_mean)).mean(dim=0)


def merge_moments(mean: torch.Tensor, var: torch.Tensor, mesh):
    """(mean, var) of the union of the ranks' equal-size shards, from each shard's mean
    and variance (``merged_moments`` of the gathered moments)."""
    both = all_gather_rows(torch.stack([mean, var])[None], mesh)  # (size, 2, ...)
    return merged_moments(both[:, 0], both[:, 1])


def tree_sum_scalar(tensors) -> torch.Tensor:
    """The sum of every element of ``tensors`` in f64: the params' fingerprint
    (mpi_adam_optimizer.py:53-60)."""
    return sum(torch.sum(t.detach().to(torch.float64)) for t in tensors)


def param_consistency_check(params, mesh, atol: float = 1e-5) -> bool:
    """True when every rank holds the same params, to ``atol`` on their f64 sums
    (collectives.py:40-65; the JAX package sums in f32). A debugging probe, not for the
    hot loop: it waits for the device."""
    s = tree_sum_scalar(params).reshape(1)
    sums = all_gather_rows(s, mesh)
    return bool((sums.max() - sums.min()).abs() <= atol)


def process_index() -> int:
    """This process's rank in the default process group, 0 when there is none (the
    counterpart of ``jax.process_index()``)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the default process group, 1 when there is none."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_weighted_mean(local_name2valcount: dict) -> dict:
    """{name: (value, count)} of each process -> {name: count-weighted mean over the
    processes} (collectives.py:68-89, mpi_util.py:110-132). Values that are not numbers
    are left out, with a warning on process 0."""
    if process_count() == 1:
        gathered = [local_name2valcount]
    else:
        gathered = [None] * process_count()
        dist.all_gather_object(gathered, local_name2valcount)
    name2sum, name2count = {}, {}
    for d in gathered:
        for name, (val, count) in d.items():
            try:
                val = float(val)
            except (TypeError, ValueError):
                if process_index() == 0:
                    warnings.warn(f"WARNING: tried to compute mean on non-float {name}={val}")
                continue
            name2sum[name] = name2sum.get(name, 0.0) + val * count
            name2count[name] = name2count.get(name, 0) + count
    return {name: name2sum[name] / name2count[name] for name in name2sum}
