"""Networks (counterpart of baselines_tpu/nn/networks.py). Ported so far: ``mlp``, the
Nature CNN ``cnn`` and its space-to-depth form ``cnn_s2d``.

Mixed precision as in the JAX package: parameters are f32, the layers compute in
``dtype``, u8 images are divided by 255 inside the network, and the latent comes back
in f32. Inputs stay NHWC, as the JAX package lays them out. Module names are the flax
names (``mlp_fc0``, ``LayerNorm_0``, ``c1``, ``fc1``), so ``convert.py`` maps a flax tree
name for name. Each network takes ``ob_shape``, the shape of one encoded observation,
since a torch layer needs its input width when it is built.
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


class MLP(nn.Module):
    """A stack of dense layers (networks.py:61-87): ``num_layers`` of ``num_hidden``,
    orthogonal init with gain sqrt(2), optional LayerNorm (flax's eps of 1e-6, its
    statistics in f32), then ``activation``; the input is flattened."""

    is_recurrent = False

    def __init__(self, ob_shape=None, num_layers: int = 2, num_hidden: int = 64,
                 activation=torch.tanh, layer_norm: bool = False,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        if ob_shape is None:
            raise ValueError("mlp needs ob_shape, the shape of one encoded observation")
        self.dtype = dtype
        self.activation = activation
        self.layer_norm = layer_norm
        self.num_layers = int(num_layers)
        width = math.prod(ob_shape)
        for i in range(self.num_layers):
            self.add_module(f"mlp_fc{i}", _ortho(nn.Linear(width, num_hidden), math.sqrt(2),
                                                 generator))
            if layer_norm:
                self.add_module(f"LayerNorm_{i}", nn.LayerNorm(num_hidden, eps=1e-6))
            width = num_hidden
        self.latent_size = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = _to_float(x).reshape(x.shape[0], -1).to(dt)
        for i in range(self.num_layers):
            fc = getattr(self, f"mlp_fc{i}")
            h = F.linear(h, fc.weight.to(dt), fc.bias.to(dt))
            if self.layer_norm:
                ln = getattr(self, f"LayerNorm_{i}")
                h = F.layer_norm(h.to(torch.float32), ln.normalized_shape, ln.weight, ln.bias,
                                 ln.eps).to(dt)
            h = self.activation(h)
        return h.to(torch.float32)


def _conv_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


class NatureCNN(nn.Module):
    """The Nature DQN convnet on unpacked frames, (B, 84, 84, 4) u8 (networks.py:89-106):
    conv 8x8/s4 32, conv 4x4/s2 64, conv 3x3/s1 64, dense 512, relu after each,
    orthogonal init with gain sqrt(2). The dense layer reads the conv output flattened in
    NHWC order, as the JAX package does."""

    is_recurrent = False
    latent_size = 512

    def __init__(self, ob_shape=(84, 84, 4), dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        h, w, c = ob_shape
        gain = math.sqrt(2)
        self.c1 = _ortho(nn.Conv2d(c, 32, 8, stride=4), gain, generator)
        self.c2 = _ortho(nn.Conv2d(32, 64, 4, stride=2), gain, generator)
        self.c3 = _ortho(nn.Conv2d(64, 64, 3), gain, generator)
        for k, s in ((8, 4), (4, 2), (3, 1)):
            h, w = _conv_out(h, k, s), _conv_out(w, k, s)
        self.fc1 = _ortho(nn.Linear(h * w * 64, 512), gain, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_stack(self, x)


def _conv_stack(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """c1, c2, c3 and fc1 of a Nature CNN in ``net.dtype``, relu after each, on NHWC
    input; the latent comes back in f32."""
    dt = net.dtype
    h = _to_float(x).permute(0, 3, 1, 2).to(dt)
    for conv in (net.c1, net.c2, net.c3):
        h = F.relu(F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return F.relu(F.linear(h, net.fc1.weight.to(dt), net.fc1.bias.to(dt))).to(torch.float32)


class NatureCNNS2D(nn.Module):
    """The Nature DQN convnet on space-to-depth-packed frames, (B, 21, 21, 64) u8
    (networks.py:107-143): conv 2x2/s1 32, conv 4x4/s2 64, conv 3x3/s1 64, dense 512,
    relu after each, orthogonal init with gain sqrt(2). The dense layer reads the conv
    output flattened in NHWC order, (7, 7, 64) -> 3136, as the JAX package does."""

    is_recurrent = False
    latent_size = 512

    def __init__(self, ob_shape=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if ob_shape is not None and tuple(ob_shape) != (21, 21, 64):
            raise ValueError(f"cnn_s2d takes (21, 21, 64) packed frames, got {tuple(ob_shape)}")
        self.dtype = dtype
        gain = math.sqrt(2)
        self.c1 = _ortho(nn.Conv2d(64, 32, 2), gain, generator)
        self.c2 = _ortho(nn.Conv2d(32, 64, 4, stride=2), gain, generator)
        self.c3 = _ortho(nn.Conv2d(64, 64, 3), gain, generator)
        self.fc1 = _ortho(nn.Linear(7 * 7 * 64, 512), gain, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_stack(self, x)


_NETWORKS = {"mlp": MLP, "cnn": NatureCNN, "cnn_s2d": NatureCNNS2D}
# the JAX package's other networks come with item 4 of ROADMAP.md's Queue 1
_NOT_PORTED = ("cnn_small", "impala_cnn", "conv_only", "lstm", "lnlstm", "cnn_lstm",
               "cnn_lnlstm", "impala_cnn_lstm")


def get_network(name: str, **kwargs) -> nn.Module:
    """Build a network by name with the JAX package's keywords (``num_layers``,
    ``num_hidden``, ``activation``, ``layer_norm``, ``dtype``, which may be a string such
    as ``"bfloat16"``) and ``ob_shape``."""
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    if name in _NOT_PORTED:
        raise NotImplementedError(f"network {name!r} is not ported yet; it comes with item 4 "
                                  "of ROADMAP.md's Queue 1")
    if name not in _NETWORKS:
        raise KeyError(f"unknown network {name!r}; the port has {sorted(_NETWORKS)}")
    return _NETWORKS[name](**kwargs)
