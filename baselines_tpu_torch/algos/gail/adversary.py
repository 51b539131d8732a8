"""GAIL's discriminator (counterpart of baselines_tpu/algos/gail/adversary.py, after
baselines/gail/adversary.py TransitionClassifier, :21-87).

``Discriminator``: concat(obs, action), ``num_layers`` x tanh(Dense(hidden_size)), then
Dense(1), a logit; flax's names ``Dense_0``..``Dense_{num_layers}`` and its default init
(``lecun_normal``, zero biases). Both functions below normalize the observations by the
discriminator's own ``RunningMeanStd`` without a clip. The generator's reward is
-log(1 - sigmoid(logit) + 1e-8) (adversary.py:45-47); the loss is the stable sigmoid
cross-entropy of generator rows against 0 and expert rows against 1, less ``entcoeff``
times the logits' Bernoulli entropy (:49-60).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from baselines_tpu_torch.core.running_stats import RunningMeanStd
from baselines_tpu_torch.nn.networks import _lecun


class Discriminator(nn.Module):
    def __init__(self, ob_dim: int, ac_dim: int, hidden_size: int = 100,
                 num_layers: int = 2, generator: torch.Generator | None = None):
        super().__init__()
        self.num_layers = int(num_layers)
        width = ob_dim + ac_dim
        for i in range(self.num_layers):
            self.add_module(f"Dense_{i}", _lecun(nn.Linear(width, hidden_size), generator))
            width = hidden_size
        self.add_module(f"Dense_{self.num_layers}", _lecun(nn.Linear(width, 1), generator))

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        for i in range(self.num_layers):
            x = torch.tanh(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.num_layers}")(x)[..., 0]


def logit_bernoulli_entropy(logits: torch.Tensor) -> torch.Tensor:
    """adversary.py:7-12."""
    return (1.0 - torch.sigmoid(logits)) * logits - F.logsigmoid(logits)


def adversary_loss(disc: Discriminator, obs_rms: RunningMeanStd, gen_obs, gen_acs, exp_obs,
                   exp_acs, entcoeff: float = 1e-3):
    """(BCE(generator -> 0, expert -> 1) - entcoeff * H, {"gen_acc", "exp_acc"})."""
    gen_logits = disc(obs_rms.normalize(gen_obs), gen_acs)
    exp_logits = disc(obs_rms.normalize(exp_obs), exp_acs)

    def bce(logits, label: float):
        return (torch.clamp(logits, min=0) - logits * label
                + torch.log1p(torch.exp(-torch.abs(logits))))

    gen_loss = torch.mean(bce(gen_logits, 0.0))
    exp_loss = torch.mean(bce(exp_logits, 1.0))
    entropy = torch.mean(logit_bernoulli_entropy(torch.cat([gen_logits, exp_logits])))
    total = gen_loss + exp_loss - entcoeff * entropy
    gen_acc = torch.mean((torch.sigmoid(gen_logits) < 0.5).to(torch.float32))
    exp_acc = torch.mean((torch.sigmoid(exp_logits) > 0.5).to(torch.float32))
    return total, {"gen_acc": gen_acc, "exp_acc": exp_acc}


def adversary_reward(disc: Discriminator, obs_rms: RunningMeanStd, obs, acs) -> torch.Tensor:
    """-log(1 - D(obs, acs) + 1e-8)."""
    logits = disc(obs_rms.normalize(obs), acs)
    return -torch.log(1.0 - torch.sigmoid(logits) + 1e-8)
