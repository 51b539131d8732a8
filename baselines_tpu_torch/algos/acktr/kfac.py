"""K-FAC, the Kronecker-factored curvature of ACKTR's optimizer (counterpart of
baselines_tpu/algos/acktr/kfac.py, after baselines/acktr/kfac.py).

Each layer registers its factors explicitly (``acktr.KfacPolicyNet``). For a layer with
inputs a (n, din) and pre-activation gradients g (n, dout), as rows with any per-sample
or per-location scaling folded in by the caller:

    A = E[a~ a~^T] (a~ = a with a homogeneous 1 for the bias), S = E[g g^T],
    F ~ A (x) S,  F^-1 G = Q_A ((Q_A^T G Q_S) / (lam_A lam_S^T + eps)) Q_S^T

for the (din + 1, dout) gradient G = [gW; gb]. ``update_stats`` keeps exponential
moving averages of A and S; ``update_eigs`` refreshes their eigendecompositions
(``torch.linalg.eigh``, eigenvalues clamped at 0); ``precondition_layer`` applies F^-1.
A layer's factors start as identities (kfac.py:64-72). Under a data-parallel mesh each
rank holds an equal share of the batch's rows, so ``update_stats`` averages the shares'
moments over the ranks (one all-reduce) before the moving averages: every rank holds the
whole batch's factors, and ``update_eigs`` decomposes the same factors on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from baselines_tpu_torch.distributed.collectives import pmean


@dataclass
class LayerKFACState:
    A: torch.Tensor  # (din + 1, din + 1)
    S: torch.Tensor  # (dout, dout)
    QA: torch.Tensor
    lamA: torch.Tensor
    QS: torch.Tensor
    lamS: torch.Tensor


@dataclass
class KFACState:
    """The layers' factors, the momentum of each parameter, and the number of updates
    taken, a host integer that schedules the eigendecompositions and the cold start."""

    layers: list
    momentum: list
    step: int = 0


def init_layer(din: int, dout: int, device) -> LayerKFACState:
    def eye(n):
        return torch.eye(n, dtype=torch.float32, device=device)

    return LayerKFACState(A=eye(din + 1), S=eye(dout), QA=eye(din + 1),
                          lamA=torch.ones((din + 1,), device=device), QS=eye(dout),
                          lamS=torch.ones((dout,), device=device))


def init_kfac(layer_dims, params, device) -> KFACState:
    """Identity factors for each (din, dout) of ``layer_dims`` and zero momentum for
    each tensor of ``params``."""
    return KFACState(layers=[init_layer(din, dout, device) for din, dout in layer_dims],
                     momentum=[torch.zeros_like(p) for p in params])


def update_stats(state: KFACState, layer_rows, stats_decay: float = 0.99,
                 mesh=None) -> KFACState:
    """Fold one Fisher backward's rows into the moving averages: ``layer_rows[i]`` is
    layer i's (a (n, din), g (n, dout)), under a ``mesh`` the rank's equal share of the
    batch's rows."""
    moments = []
    for a, g in layer_rows:
        n = a.shape[0]
        a_h = torch.cat([a, torch.ones((n, 1), dtype=a.dtype, device=a.device)], dim=1)
        moments += [(a_h.T @ a_h) / n, (g.T @ g) / n]
    if mesh is not None:  # the whole batch's moments
        moments = pmean(moments, mesh)
    layers = []
    for layer, mA, mS in zip(state.layers, moments[0::2], moments[1::2]):
        A = stats_decay * layer.A + (1 - stats_decay) * mA
        S = stats_decay * layer.S + (1 - stats_decay) * mS
        layers.append(LayerKFACState(A=A, S=S, QA=layer.QA, lamA=layer.lamA, QS=layer.QS,
                                     lamS=layer.lamS))
    return KFACState(layers=layers, momentum=state.momentum, step=state.step)


def update_eigs(state: KFACState) -> KFACState:
    """Every factor's eigendecomposition anew (kfac.py:512-616), eigenvalues clamped at
    0. A failure of ``eigh`` raises."""
    layers = []
    for layer in state.layers:
        lamA, QA = torch.linalg.eigh(layer.A)
        lamS, QS = torch.linalg.eigh(layer.S)
        layers.append(LayerKFACState(A=layer.A, S=layer.S, QA=QA, lamA=torch.clamp(lamA, min=0.0),
                                     QS=QS, lamS=torch.clamp(lamS, min=0.0)))
    return KFACState(layers=layers, momentum=state.momentum, step=state.step)


def precondition_layer(layer: LayerKFACState, gW: torch.Tensor, gb: torch.Tensor,
                       epsilon: float):
    """F^-1 g of one layer in factor layout: ``gW`` (din, dout), ``gb`` (dout,); returns
    (pW, pb) in the same layout."""
    G = torch.cat([gW, gb[None, :]], dim=0)
    Gt = layer.QA.T @ G @ layer.QS
    denom = layer.lamA[:, None] * layer.lamS[None, :] + epsilon
    P = layer.QA @ (Gt / denom) @ layer.QS.T
    return P[:-1], P[-1]
