"""The port's core (counterpart of baselines_tpu/core/__init__.py), with the same
exports: ``math_util``, ``Registry``, the schedules, ``RunningMeanStd`` and ``logger``."""

from baselines_tpu_torch.core import math as math_util
from baselines_tpu_torch.core.registry import Registry
from baselines_tpu_torch.core.schedules import (
    ConstantSchedule,
    LinearSchedule,
    PiecewiseSchedule,
    constant_fraction_schedule,
)
from baselines_tpu_torch.core.running_stats import RunningMeanStd
from baselines_tpu_torch.core import logger

__all__ = [
    "math_util",
    "Registry",
    "ConstantSchedule",
    "LinearSchedule",
    "PiecewiseSchedule",
    "constant_fraction_schedule",
    "RunningMeanStd",
    "logger",
]
