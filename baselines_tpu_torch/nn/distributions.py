"""Action distributions (counterpart of baselines_tpu/nn/distributions.py). Ported so
far: ``CategoricalPd`` (distributions.py:153-204 of the reference)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


class CategoricalPd:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    def flatparam(self) -> torch.Tensor:
        return self.logits

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1).to(torch.int32)

    def neglogp(self, x: torch.Tensor) -> torch.Tensor:
        """Sparse softmax cross-entropy (distributions.py:169-183)."""
        logp = F.log_softmax(self.logits, dim=-1)
        return -torch.gather(logp, -1, x.long().unsqueeze(-1)).squeeze(-1)

    def kl(self, other: "CategoricalPd") -> torch.Tensor:
        """Stable KL (distributions.py:184-191)."""
        a0 = self.logits - self.logits.amax(dim=-1, keepdim=True)
        a1 = other.logits - other.logits.amax(dim=-1, keepdim=True)
        ea0, ea1 = torch.exp(a0), torch.exp(a1)
        z0, z1 = ea0.sum(dim=-1, keepdim=True), ea1.sum(dim=-1, keepdim=True)
        p0 = ea0 / z0
        return torch.sum(p0 * (a0 - torch.log(z0) - a1 + torch.log(z1)), dim=-1)

    def entropy(self) -> torch.Tensor:
        """Stable entropy (distributions.py:192-198)."""
        a0 = self.logits - self.logits.amax(dim=-1, keepdim=True)
        ea0 = torch.exp(a0)
        z0 = ea0.sum(dim=-1, keepdim=True)
        p0 = ea0 / z0
        return torch.sum(p0 * (torch.log(z0) - a0), dim=-1)

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """Gumbel-max sampling (distributions.py:199-201) from uniforms ``u`` in
        [1e-10, 1) of the logits' shape, which the caller draws."""
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
