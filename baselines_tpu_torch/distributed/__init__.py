"""Data parallelism for the port (counterpart of baselines_tpu/distributed/__init__.py):
one process for each device on ``torch.distributed``, NCCL on the card and gloo on the
CPU. ``mesh.py`` and ``collectives.py`` import nothing of the rest of the port, which
builds on them; ``dryrun.py`` drives the learners over them."""

from baselines_tpu_torch.distributed.collectives import (
    host_weighted_mean,
    param_consistency_check,
    pmean,
    psum,
)
from baselines_tpu_torch.distributed.mesh import (
    DATA_AXIS,
    Mesh,
    make_mesh,
    maybe_initialize_distributed,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "maybe_initialize_distributed",
    "psum",
    "pmean",
    "param_consistency_check",
    "host_weighted_mean",
]
