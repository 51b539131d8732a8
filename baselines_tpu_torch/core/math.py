"""Small math utilities (counterpart of baselines_tpu/core/math.py)."""

from __future__ import annotations

import torch


def explained_variance(ypred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - Var[y - ypred] / Var[y], nan when Var[y] == 0 (math_util.py:29-47)."""
    ypred = ypred.reshape(-1).to(torch.float32)
    y = y.reshape(-1).to(torch.float32)
    vary = torch.var(y, correction=0)
    ev = 1.0 - torch.var(y - ypred, correction=0) / vary
    return torch.where(vary == 0, torch.full_like(ev, float("nan")), ev)
