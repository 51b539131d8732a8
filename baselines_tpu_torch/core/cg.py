"""Conjugate gradient (counterpart of baselines_tpu/core/cg.py, after
baselines/common/cg.py:2-34).

The JAX package runs a fixed number of trips and, once the residual falls below
``residual_tol``, freezes the carry instead of leaving the loop, so that every replica
of a mesh takes the same number of operator calls. The port keeps that form: ``cg``
always makes ``cg_iters`` calls of ``f_Ax``, and a trip after convergence leaves the
iterate as it was, which is the JAX result even where one more trip would move it.
"""

from __future__ import annotations

import torch


def cg(f_Ax, b: torch.Tensor, cg_iters: int = 10, residual_tol: float = 1e-10) -> torch.Tensor:
    """Solve A x = b for a symmetric positive-definite A given ``f_Ax(v) = A v``."""
    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    rdotr = torch.dot(b, b)
    for _ in range(cg_iters):
        z = f_Ax(p)
        v = rdotr / torch.clamp(torch.dot(p, z), min=1e-12)
        x_new = x + v * p
        r_new = r - v * z
        newrdotr = torch.dot(r_new, r_new)
        mu = newrdotr / torch.clamp(rdotr, min=1e-12)
        p_new = r_new + mu * p
        done = newrdotr < residual_tol
        x = torch.where(done, x, x_new)
        r = torch.where(done, r, r_new)
        p = torch.where(done, p, p_new)
        rdotr = torch.where(done, rdotr, newrdotr)
    return x
