"""Running mean and variance as a dataclass of device tensors (counterpart of
baselines_tpu/core/running_stats.py:20-103, after the reference's
common/running_mean_std.py:5-81).

``update`` folds a batch in by the parallel (Chan) merge of running_mean_std.py:22-33
and returns a new ``RunningMeanStd``; nothing is updated in place. The arithmetic is the
JAX package's: the count is an f32 scalar that starts at ``epsilon`` (1e-4), and the
batch variance has no correction. ``torch.var`` and ``jnp.var`` sum in other orders, so
the statistics agree with the JAX package's to rounding, not bit for bit.

With ``axis_name``, a data-parallel ``Mesh`` (distributed/mesh.py), the batch moments
of the ranks' equal-size shards are merged as the JAX package merges them over a mesh
axis (running_stats.py:51-56): the mean of the means, the mean of ``var_r + (mean_r -
mean)^2``, and the count times the number of ranks, so that every rank holds the
statistics of the whole batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from baselines_tpu_torch.core.device import resolve_device
from baselines_tpu_torch.distributed.collectives import merge_moments
from baselines_tpu_torch.distributed.mesh import check_mesh


@dataclass
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # () f32

    @staticmethod
    def create(shape=(), epsilon: float = 1e-4, device=None,
               dtype: torch.dtype = torch.float32) -> "RunningMeanStd":
        """Mean 0, variance 1 and count ``epsilon`` on ``device``, the card unless the
        caller passes ``"cpu"``."""
        device = resolve_device(device)
        return RunningMeanStd(
            mean=torch.zeros(shape, dtype=dtype, device=device),
            var=torch.ones(shape, dtype=dtype, device=device),
            count=torch.full((), epsilon, dtype=torch.float32, device=device),
        )

    def update(self, x: torch.Tensor, axis_name=None) -> "RunningMeanStd":
        """Fold in a batch of shape (batch..., *stat_shape); the leading axes are
        reduced, and with a mesh ``axis_name`` the ranks' batches too."""
        check_mesh(axis_name, "RunningMeanStd.update's axis_name")
        x = x.to(torch.float32)
        reduce_dims = tuple(range(x.dim() - self.mean.dim()))
        if reduce_dims:
            batch_count = float(math.prod(x.shape[d] for d in reduce_dims))
            batch_mean = torch.mean(x, dim=reduce_dims)
            batch_var = torch.var(x, dim=reduce_dims, correction=0)
        else:  # one sample: torch would reduce every dim for an empty dim tuple
            batch_count, batch_mean, batch_var = 1.0, x, torch.zeros_like(x)
        if axis_name is not None:
            batch_mean, batch_var = merge_moments(batch_mean, batch_var, axis_name)
            batch_count *= axis_name.size
        # a fill, not a copy from the host, which would wait for the card's stream
        count = torch.full((), batch_count, dtype=torch.float32, device=x.device)
        return self.update_from_moments(batch_mean, batch_var, count)

    def update_from_moments(self, batch_mean, batch_var, batch_count) -> "RunningMeanStd":
        """The parallel merge (running_mean_std.py:22-33)."""
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + torch.square(delta) * self.count * batch_count / tot
        return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var)

    def normalize(self, x: torch.Tensor, clip: float | None = None,
                  epsilon: float = 1e-8) -> torch.Tensor:
        y = (x.to(torch.float32) - self.mean) / torch.sqrt(self.var + epsilon)
        if clip is not None:
            y = torch.clamp(y, -clip, clip)
        return y

    def denormalize(self, y: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
        return y * torch.sqrt(self.var + epsilon) + self.mean


def merge_branched(prev: RunningMeanStd, a: RunningMeanStd, b: RunningMeanStd) -> RunningMeanStd:
    """The exact merge of two statistics that both branched from ``prev`` and then
    folded in disjoint data, in (count, sum, sum of squares) space, where the union is
    a + b - prev (running_stats.py:84-103)."""

    def sums(r):
        return r.count, r.mean * r.count, (r.var + torch.square(r.mean)) * r.count

    (cp, sp, qp), (ca, sa, qa), (cb, sb, qb) = sums(prev), sums(a), sums(b)
    count = ca + cb - cp
    mean = (sa + sb - sp) / count
    var = (qa + qb - qp) / count - torch.square(mean)
    return RunningMeanStd(mean=mean, var=torch.clamp(var, min=0.0), count=count)
