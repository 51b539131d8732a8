"""Networks (counterpart of baselines_tpu/nn/networks.py): the JAX package's eleven
names, ``mlp``, the Nature CNN ``cnn`` and its space-to-depth form ``cnn_s2d``,
``cnn_small``, ``impala_cnn``, ``conv_only``, and the recurrent ``lstm``, ``lnlstm``,
``cnn_lstm``, ``cnn_lnlstm`` and ``impala_cnn_lstm``, in a ``Registry`` to which
``register(name)`` adds a user's network; ``get_network`` also takes a network class or
factory, or a ready-made module, as the JAX package's does.

Mixed precision as in the JAX package: parameters are f32, the layers compute in
``dtype``, u8 images are divided by 255 inside the network, and the latent comes back
in f32; the LSTM always runs in f32, ``dtype`` reaches its encoder alone. Inputs stay
NHWC, as the JAX package lays them out. Module names are the flax names (``mlp_fc0``,
``LayerNorm_0``, ``c1``, ``fc1``, ``Conv_0``, ``_ImpalaResBlock_0``, ``Dense_0``,
``encoder``, ``lstm``), so ``convert.py`` maps a flax tree name for name. Each network
takes ``ob_shape``, the shape of one encoded observation, since a torch layer needs its
input width when it is built. Layers initialise as their flax counterparts do:
orthogonal where the JAX package asks for it, else flax's default ``lecun_normal`` with
zero biases.

A recurrent network (``is_recurrent``) maps ``(x, carry, mask) -> (latent, carry)``;
the carry is ``concat(h, c)``, (B, 2 * nlstm) f32, and a mask of 1 zeroes it before the
step (the first step of a new episode). ``unroll`` runs a time-major sequence: the
encoder and the input's share of the gates over all T * B frames at once, then the cell
step by step, which is the same function as T calls of ``forward``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from baselines_tpu_torch.core.device import resolve_device
from baselines_tpu_torch.core.registry import Registry

_NETWORKS: Registry = Registry("network")


def register(name: str):
    """Register a network under ``name`` (networks.py:34-35), as a decorator of its class
    or factory: ``@networks.register("my_net")``. ``get_network`` calls it with
    ``ob_shape``, the shape of one encoded observation (a torch layer needs its input
    width when it is built, where flax infers it at the first call), ``generator``, the
    ``torch.Generator`` to initialise from (None: torch's global one), and the network
    keywords the caller gave. What it returns is an ``nn.Module`` with ``latent_size``,
    the width of the f32 (B, latent_size) latent that ``forward(x)`` returns, and
    ``is_recurrent``; a recurrent network keeps ``RecurrentNetwork``'s interface
    (``nlstm``, ``initial_state``, ``forward(x, carry, mask)``, ``unroll``). A second
    registration of the same name raises ``ValueError``."""
    return _NETWORKS.register(name)


def _to_float(x: torch.Tensor) -> torch.Tensor:
    """u8 images -> f32 / 255 (models.py:19)."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def _ortho(layer: nn.Module, gain: float, generator: torch.Generator | None) -> nn.Module:
    nn.init.orthogonal_(layer.weight, gain, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


@register("mlp")
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


def _lecun(layer: nn.Module, generator: torch.Generator | None) -> nn.Module:
    """flax's default init, ``lecun_normal``: a normal of standard deviation
    sqrt(1 / fan_in) / 0.8796 truncated at two of them (variance 1 / fan_in after the
    truncation), and zero biases."""
    fan_in = math.prod(layer.weight.shape[1:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def _conv(h: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    return F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride,
                    padding=conv.padding)


def _conv_stack(x: torch.Tensor, convs, dense, dt: torch.dtype) -> torch.Tensor:
    """``convs`` on NHWC input in ``dt``, relu after each, then ``dense`` with a relu on
    the conv output flattened in NHWC order, as the JAX package flattens it; with no
    ``dense``, the NHWC conv output itself. The result comes back in f32."""
    h = _to_float(x).permute(0, 3, 1, 2).to(dt)
    for conv in convs:
        h = F.relu(_conv(h, conv, dt))
    h = h.permute(0, 2, 3, 1)
    if dense is None:
        return h.to(torch.float32)
    h = h.reshape(h.shape[0], -1)
    return F.relu(F.linear(h, dense.weight.to(dt), dense.bias.to(dt))).to(torch.float32)


@register("cnn")
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
        return _conv_stack(x, (self.c1, self.c2, self.c3), self.fc1, self.dtype)


@register("cnn_s2d")
class NatureCNNS2D(nn.Module):
    """The Nature DQN convnet on space-to-depth-packed frames, (B, 21, 21, 64) u8
    (networks.py:107-143): conv 2x2/s1 32, conv 4x4/s2 64, conv 3x3/s1 64, dense 512,
    relu after each, orthogonal init with gain sqrt(2). The dense layer reads the conv
    output flattened in NHWC order, (7, 7, 64) -> 3136, as the JAX package does. With
    ``packed_shape`` (21, 21, 64) it takes the frames as flat (B, 28224) rows (VecS2D's
    ``flat``), viewed as the 3-D frames (networks.py:121-134)."""

    is_recurrent = False
    latent_size = 512

    def __init__(self, ob_shape=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, packed_shape=None):
        super().__init__()
        frame = (21, 21, 64)
        if packed_shape is not None and tuple(packed_shape) != frame:
            raise ValueError(f"cnn_s2d unflattens rows to {frame}, got {tuple(packed_shape)}")
        shapes = (frame,) if packed_shape is None else (frame, (math.prod(frame),))
        if ob_shape is not None and tuple(ob_shape) not in shapes:
            raise ValueError(f"cnn_s2d takes (21, 21, 64) packed frames, got {tuple(ob_shape)}")
        self.packed_shape = None if packed_shape is None else frame
        self.dtype = dtype
        gain = math.sqrt(2)
        self.c1 = _ortho(nn.Conv2d(64, 32, 2), gain, generator)
        self.c2 = _ortho(nn.Conv2d(32, 64, 4, stride=2), gain, generator)
        self.c3 = _ortho(nn.Conv2d(64, 64, 3), gain, generator)
        self.fc1 = _ortho(nn.Linear(7 * 7 * 64, 512), gain, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.view((x.shape[0],) + self.packed_shape)
        return _conv_stack(x, (self.c1, self.c2, self.c3), self.fc1, self.dtype)


@register("cnn_small")
class CNNSmall(nn.Module):
    """The small convnet (networks.py:146-160, models.py:118-129): conv 8x8/s4 8, conv
    4x4/s2 16, dense 128, relu after each, orthogonal init with gain sqrt(2), the conv
    output flattened in NHWC order."""

    is_recurrent = False
    latent_size = 128

    def __init__(self, ob_shape=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if ob_shape is None:
            raise ValueError("cnn_small needs ob_shape, the shape of one encoded observation")
        self.dtype = dtype
        h, w, c = ob_shape
        gain = math.sqrt(2)
        self.Conv_0 = _ortho(nn.Conv2d(c, 8, 8, stride=4), gain, generator)
        self.Conv_1 = _ortho(nn.Conv2d(8, 16, 4, stride=2), gain, generator)
        for k, s in ((8, 4), (4, 2)):
            h, w = _conv_out(h, k, s), _conv_out(w, k, s)
        self.Dense_0 = _ortho(nn.Linear(h * w * 16, 128), gain, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_stack(x, (self.Conv_0, self.Conv_1), self.Dense_0, self.dtype)


def _same_pool_pads(size: int) -> tuple[int, int]:
    """The (low, high) padding of a 3-wide, stride-2 ``SAME`` window along one axis, as
    XLA pads it: ceil(size / 2) outputs, the total short of covering them split with the
    smaller half low (84 -> (0, 1), 42 -> (0, 1), 21 -> (1, 1))."""
    total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
    return total // 2, total - total // 2


def _max_pool_same(h: torch.Tensor) -> torch.Tensor:
    """flax's ``max_pool(h, (3, 3), strides=(2, 2), padding="SAME")`` on NCHW input: padded
    with -inf by each axis's own ``_same_pool_pads``, which ``max_pool2d``'s symmetric
    padding cannot express."""
    (top, bottom), (left, right) = _same_pool_pads(h.shape[2]), _same_pool_pads(h.shape[3])
    h = F.pad(h, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(h, 3, stride=2)


class _ImpalaResBlock(nn.Module):
    """relu, conv 3x3 SAME, relu, conv 3x3 SAME, plus the input (networks.py:163-173)."""

    def __init__(self, depth: int, generator: torch.Generator | None):
        super().__init__()
        self.Conv_0 = _lecun(nn.Conv2d(depth, depth, 3, padding=1), generator)
        self.Conv_1 = _lecun(nn.Conv2d(depth, depth, 3, padding=1), generator)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        h = _conv(F.relu(x), self.Conv_0, dt)
        return _conv(F.relu(h), self.Conv_1, dt) + x


@register("impala_cnn")
class ImpalaCNN(nn.Module):
    """The IMPALA residual convnet (networks.py:176-195, models.py:28-71): for each of
    ``depths``, conv 3x3 SAME, max-pool 3x3/s2 SAME and two residual blocks; then relu,
    the NHWC flatten and dense 256 with a relu (3872 -> 256 at 84x84). flax's default
    init throughout."""

    is_recurrent = False
    latent_size = 256

    def __init__(self, ob_shape=(84, 84, 4), depths=(16, 32, 32),
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        h, w, c = ob_shape
        for i, depth in enumerate(self.depths):
            self.add_module(f"Conv_{i}", _lecun(nn.Conv2d(c, depth, 3, padding=1), generator))
            for j in (2 * i, 2 * i + 1):
                self.add_module(f"_ImpalaResBlock_{j}", _ImpalaResBlock(depth, generator))
            h, w, c = -(-h // 2), -(-w // 2), depth
        self.Dense_0 = _lecun(nn.Linear(h * w * c, 256), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = _to_float(x).permute(0, 3, 1, 2).to(dt)
        for i in range(len(self.depths)):
            h = _max_pool_same(_conv(h, getattr(self, f"Conv_{i}"), dt))
            for j in (2 * i, 2 * i + 1):
                h = getattr(self, f"_ImpalaResBlock_{j}")(h, dt)
        h = F.relu(h).permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return F.relu(F.linear(h, self.Dense_0.weight.to(dt),
                               self.Dense_0.bias.to(dt))).to(torch.float32)


@register("conv_only")
class ConvOnly(nn.Module):
    """The conv stack without a dense layer (networks.py:198-216, models.py:221-249):
    VALID convs of ``convs`` (filters, kernel, stride), relu after each, flax's default
    init. The latent is the 4-D NHWC conv output in f32, which deepq's ``QNet.head``
    flattens; ``latent_size`` is its flattened width (7 * 7 * 64 at 84x84)."""

    is_recurrent = False

    def __init__(self, ob_shape=(84, 84, 4), convs=((32, 8, 4), (64, 4, 2), (64, 3, 1)),
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        h, w, c = ob_shape
        for i, (filters, kernel, stride) in enumerate(convs):
            self.add_module(f"Conv_{i}", _lecun(nn.Conv2d(c, filters, kernel, stride=stride),
                                                generator))
            h, w, c = _conv_out(h, kernel, stride), _conv_out(w, kernel, stride), filters
        self.nconvs = len(convs)
        self.latent_size = h * w * c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [getattr(self, f"Conv_{i}") for i in range(self.nconvs)]
        return _conv_stack(x, convs, None, self.dtype)


class LSTMCell(nn.Module):
    """The JAX package's LSTM step (networks.py:223-251, a2c/utils.py:81-102): the carry
    is concat(h, c); a mask of 1 zeroes both before the step; gates ``x wx + h wh + b``
    (``wx`` and ``wh`` orthogonal, gain 1, without bias; ``b`` zero) in the order i, f,
    o, u; with ``layer_norm`` the two products and the new cell pass through LayerNorms
    (``ln_x``, ``ln_h``, ``ln_c``, flax's eps of 1e-6). Computes in f32. ``project``
    takes the input's share of the gates, which no carry enters, so a sequence projects
    all its frames at once and ``step`` adds the rest."""

    def __init__(self, nin: int, nlstm: int = 128, layer_norm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nlstm = int(nlstm)
        self.layer_norm = layer_norm
        self.wx = nn.Linear(nin, 4 * self.nlstm, bias=False)
        self.wh = nn.Linear(self.nlstm, 4 * self.nlstm, bias=False)
        for layer in (self.wx, self.wh):
            nn.init.orthogonal_(layer.weight, 1.0, generator=generator)
        self.b = nn.Parameter(torch.zeros(4 * self.nlstm))
        if layer_norm:
            self.ln_x = nn.LayerNorm(4 * self.nlstm, eps=1e-6)
            self.ln_h = nn.LayerNorm(4 * self.nlstm, eps=1e-6)
            self.ln_c = nn.LayerNorm(self.nlstm, eps=1e-6)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        xw = self.wx(x)
        return self.ln_x(xw) if self.layer_norm else xw

    def step(self, xw: torch.Tensor, carry: torch.Tensor, mask: torch.Tensor):
        h, c = carry.chunk(2, dim=-1)
        keep = 1.0 - mask.reshape(-1, 1).to(h.dtype)
        h, c = h * keep, c * keep
        hw = self.wh(h)
        if self.layer_norm:
            hw = self.ln_h(hw)
        i, f, o, u = (xw + hw + self.b).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
        h = torch.sigmoid(o) * torch.tanh(self.ln_c(c) if self.layer_norm else c)
        return h, torch.cat([h, c], dim=-1)

    def forward(self, x: torch.Tensor, carry: torch.Tensor, mask: torch.Tensor):
        return self.step(self.project(x), carry, mask)


class RecurrentNetwork(nn.Module):
    """``encoder`` (or the flattened f32 observation when None) -> ``lstm``
    (networks.py:254-273); ``(x, carry, mask) -> (latent, carry)``."""

    is_recurrent = True

    def __init__(self, encoder: nn.Module | None, ob_shape=None, nlstm: int = 128,
                 layer_norm: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        if encoder is None and ob_shape is None:
            raise ValueError("an lstm without an encoder needs ob_shape, the shape of one "
                             "encoded observation")
        self.encoder = encoder
        nin = encoder.latent_size if encoder is not None else math.prod(ob_shape)
        self.lstm = LSTMCell(nin, nlstm, layer_norm, generator)
        self.nlstm = self.latent_size = int(nlstm)

    def initial_state(self, batch_size: int, device=None) -> torch.Tensor:
        """The zero carry of ``batch_size`` envs on ``device``, the card unless the caller
        passes ``"cpu"``."""
        return torch.zeros((batch_size, 2 * self.nlstm), dtype=torch.float32,
                           device=resolve_device(device))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        if self.encoder is not None:
            return self.encoder(x)
        return _to_float(x).reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor, carry: torch.Tensor, mask: torch.Tensor):
        return self.lstm(self.encode(x), carry, mask)

    def unroll(self, x: torch.Tensor, carry: torch.Tensor, masks: torch.Tensor):
        """A time-major sequence: ``x`` (T * B, ...) flattened time-major, ``masks``
        (T, B), ``carry`` (B, 2 * nlstm) before the first step. Returns the latents,
        (T * B, nlstm) in the same order, and the carry after the last step."""
        nsteps, nb = masks.shape
        xw = self.lstm.project(self.encode(x)).reshape(nsteps, nb, -1)
        latents = []
        for t in range(nsteps):
            h, carry = self.lstm.step(xw[t], carry, masks[t])
            latents.append(h)
        return torch.cat(latents), carry


@register("lstm")
def lstm(ob_shape=None, nlstm: int = 128, layer_norm: bool = False,
         generator: torch.Generator | None = None) -> RecurrentNetwork:
    """The flattened observation straight into the LSTM (models.py:131-183)."""
    return RecurrentNetwork(None, ob_shape, nlstm, layer_norm, generator)


@register("lnlstm")
def lnlstm(ob_shape=None, nlstm: int = 128,
           generator: torch.Generator | None = None) -> RecurrentNetwork:
    return RecurrentNetwork(None, ob_shape, nlstm, True, generator)


@register("cnn_lstm")
def cnn_lstm(ob_shape=(84, 84, 4), nlstm: int = 128, layer_norm: bool = False,
             generator: torch.Generator | None = None, **conv_kwargs) -> RecurrentNetwork:
    """The Nature CNN, in ``conv_kwargs``' dtype, into the f32 LSTM (models.py:186-210)."""
    encoder = NatureCNN(ob_shape, generator=generator, **conv_kwargs)
    return RecurrentNetwork(encoder, ob_shape, nlstm, layer_norm, generator)


@register("cnn_lnlstm")
def cnn_lnlstm(ob_shape=(84, 84, 4), nlstm: int = 128,
               generator: torch.Generator | None = None, **conv_kwargs) -> RecurrentNetwork:
    return cnn_lstm(ob_shape, nlstm, True, generator, **conv_kwargs)


@register("impala_cnn_lstm")
def impala_cnn_lstm(ob_shape=(84, 84, 4), nlstm: int = 256,
                    generator: torch.Generator | None = None, **kwargs) -> RecurrentNetwork:
    encoder = ImpalaCNN(ob_shape, generator=generator, **kwargs)
    return RecurrentNetwork(encoder, ob_shape, nlstm, False, generator)


def network_names() -> list[str]:
    return _NETWORKS.names()


def get_network(name, **kwargs) -> nn.Module:
    """Build a network (models.get_network_builder, networks.py:38-46): by a registered
    name, or by a callable (a network class or factory), either called with the keywords
    the port passes (``ob_shape``, ``generator``) and the JAX package's network keywords
    (``num_layers``, ``num_hidden``, ``activation``, ``layer_norm``, ``depths``,
    ``convs``, ``nlstm``, ``dtype``, which may be a string such as ``"bfloat16"``); a
    ready-made ``nn.Module`` is returned as it is. An unknown name raises
    ``ValueError``, as the JAX package's registry does."""
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    if isinstance(name, nn.Module):
        return name
    if callable(name):
        return name(**kwargs)
    return _NETWORKS.get(name)(**kwargs)
