"""Behavior cloning (counterpart of baselines_tpu/algos/gail/behavior_clone.py, after
baselines/gail/behavior_clone.py): plain Adam (optax's ``adam(lr)``: eps 1e-8, no clip)
on the mean ``neglogp`` of expert actions under the policy, one expert minibatch a
step. Every parameter of the policy's module is stepped; those the loss does not reach
(a value tower) get zero gradients, which move nothing, as in the JAX package."""

from __future__ import annotations

import torch

from baselines_tpu_torch.algos.common import ClipAdam
from baselines_tpu_torch.core import logger


def pretrain_bc(policy, dataset, draws, max_iters: int = 10000, batch_size: int = 128,
                lr: float = 1e-4, log_interval: int = 0) -> None:
    """Train ``policy.module`` in place for ``max_iters`` steps; each step draws its
    minibatch from ``draws`` (``ExpertDataset.sample``)."""
    module = policy.module
    params = list(module.parameters())
    opt = ClipAdam(params, None, eps=1e-8)
    for it in range(max_iters):
        ob, ac = dataset.sample(draws, batch_size)
        pd = policy.pdtype.pdfromflat(module(ob)[0])
        loss = torch.mean(pd.neglogp(ac))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        opt.step([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)], lr)
        if log_interval and it % log_interval == 0:
            logger.log(f"bc iter {it} loss {float(loss):.4f}")
