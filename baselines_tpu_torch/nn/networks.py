"""Networks (counterpart of baselines_tpu/nn/networks.py). Ported so far: the
space-to-depth Nature CNN, ``cnn_s2d``.

Mixed precision as in the JAX package: parameters are f32, the layers compute in
``dtype``, u8 images are divided by 255 inside the network, and the latent comes back
in f32. Inputs stay NHWC, as the JAX package lays them out.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _to_float(x: torch.Tensor) -> torch.Tensor:
    """u8 images -> f32 / 255 (models.py:19)."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def _ortho(layer: nn.Module, gain: float, generator: torch.Generator | None) -> nn.Module:
    nn.init.orthogonal_(layer.weight, gain, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class NatureCNNS2D(nn.Module):
    """The Nature DQN convnet on space-to-depth-packed frames, (B, 21, 21, 64) u8
    (networks.py:107-143): conv 2x2/s1 32, conv 4x4/s2 64, conv 3x3/s1 64, dense 512,
    relu after each, orthogonal init with gain sqrt(2). The dense layer reads the conv
    output flattened in NHWC order, (7, 7, 64) -> 3136, as the JAX package does."""

    is_recurrent = False
    latent_size = 512

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        gain = math.sqrt(2)
        self.c1 = _ortho(nn.Conv2d(64, 32, 2), gain, generator)
        self.c2 = _ortho(nn.Conv2d(32, 64, 4, stride=2), gain, generator)
        self.c3 = _ortho(nn.Conv2d(64, 64, 3), gain, generator)
        self.fc1 = _ortho(nn.Linear(7 * 7 * 64, 512), gain, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = _to_float(x).permute(0, 3, 1, 2).to(dt)
        for conv in (self.c1, self.c2, self.c3):
            h = F.relu(F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return F.relu(F.linear(h, self.fc1.weight.to(dt), self.fc1.bias.to(dt))).to(torch.float32)


_NETWORKS = {"cnn_s2d": NatureCNNS2D}


def get_network(name: str, **kwargs) -> nn.Module:
    """Build a network by name; ``dtype`` may be a string such as ``"bfloat16"``."""
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    if name not in _NETWORKS:
        raise KeyError(f"unknown network {name!r}; the port has {sorted(_NETWORKS)}")
    return _NETWORKS[name](**kwargs)
