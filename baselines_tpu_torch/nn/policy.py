"""Policy (counterpart of baselines_tpu/nn/policy.py:30-175).

``PolicyValueNet`` encodes the observation (one-hot for ``Discrete`` and
``MultiDiscrete``), runs a latent network, and puts a distribution head (orthogonal
init, gain 0.01) and a value head (gain 1.0) on the shared latent. For a ``Box`` action
space the head is the diagonal Gaussian's: ``pi`` gives the mean and a ``logstd``
parameter of shape (1, d), initialised to zero, the log standard deviation.
``Policy.step`` and ``Policy.value`` serve the rollout and ``Policy.mode_step`` the
deterministic play, without gradients, all through the action space's ``PdType``: when
the network is the space-to-depth Nature CNN in bf16, its forward is the fused CUDA
kernel (``ops/fused_cnn.py``), whose arithmetic is that network's; any other network
runs its own forward. The loss calls the module itself, with autograd.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from baselines_tpu_torch.envs.spaces import Box, Discrete, MultiBinary, MultiDiscrete
from baselines_tpu_torch.nn.distributions import PdType, make_pdtype
from baselines_tpu_torch.nn.networks import NatureCNNS2D, _ortho, get_network
from baselines_tpu_torch.ops.fused_cnn import fused_cnn_forward, pack_params


def encode_observation(space, obs: torch.Tensor) -> torch.Tensor:
    """input.py:43-63: one-hot f32 for ``Discrete``, the one-hots of the components
    side by side for ``MultiDiscrete``; a ``Box`` or ``MultiBinary`` passes through (the
    networks divide u8 images by 255)."""
    if isinstance(space, Discrete):
        return F.one_hot(obs.long(), space.n).to(torch.float32)
    if isinstance(space, MultiDiscrete):
        nvec = np.asarray(space.nvec).ravel()
        obs = obs.long()
        return torch.cat([F.one_hot(obs[..., i], int(n)).to(torch.float32)
                          for i, n in enumerate(nvec)], dim=-1)
    if isinstance(space, (Box, MultiBinary)):
        return obs
    raise NotImplementedError(f"the port cannot encode observations for {space!r} yet")


def encoded_shape(space) -> tuple:
    """The shape of one observation as ``encode_observation`` gives it."""
    if isinstance(space, Discrete):
        return (space.n,)
    if isinstance(space, MultiDiscrete):
        return (int(np.asarray(space.nvec).sum()),)
    return tuple(space.shape)


def uses_fused_kernel(network: nn.Module) -> bool:
    """Whether the act step of ``network`` runs through the fused CNN kernel: the
    space-to-depth Nature CNN in bf16."""
    return isinstance(network, NatureCNNS2D) and network.dtype == torch.bfloat16


def act_latent(network: nn.Module, obs: torch.Tensor, packed=None) -> torch.Tensor:
    """The f32 latent of the act step: the fused CNN kernel on ``packed`` (weights
    packed from the current params when None) where ``uses_fused_kernel``, else the
    network's own forward."""
    if uses_fused_kernel(network):
        return fused_cnn_forward(obs, pack_params(network) if packed is None else packed)
    return network(obs)


class PolicyValueNet(nn.Module):
    def __init__(self, network: nn.Module, ob_space, pdtype: PdType,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.network = network
        self.ob_space = ob_space
        self.gaussian = pdtype.kind == "diag_gaussian"
        width = pdtype.param_size // 2 if self.gaussian else pdtype.param_size
        self.pi = _ortho(nn.Linear(network.latent_size, width), 0.01, generator)
        if self.gaussian:
            self.logstd = nn.Parameter(torch.zeros((1, width)))
        self.vf = _ortho(nn.Linear(network.latent_size, 1), 1.0, generator)

    def heads(self, latent: torch.Tensor):
        """(flat distribution parameters, value) from the f32 latent."""
        pdflat = self.pi(latent)
        if self.gaussian:
            pdflat = torch.cat([pdflat, self.logstd.expand_as(pdflat)], dim=-1)
        return pdflat, self.vf(latent)[..., 0]

    def forward(self, obs: torch.Tensor):
        return self.heads(self.network(encode_observation(self.ob_space, obs)))


class Policy:
    def __init__(self, module: PolicyValueNet, ob_space, ac_space):
        self.module = module
        self.ob_space = ob_space
        self.ac_space = ac_space
        self.pdtype = make_pdtype(ac_space)

    @property
    def uses_kernel(self) -> bool:
        return uses_fused_kernel(self.module.network)

    def pack(self):
        """The fused kernel's weights, packed from the current params, or None when
        the network does not run through the kernel."""
        return pack_params(self.module.network) if self.uses_kernel else None

    def _heads(self, obs: torch.Tensor, packed):
        obs = encode_observation(self.ob_space, obs)
        return self.module.heads(act_latent(self.module.network, obs, packed))

    @torch.no_grad()
    def step(self, obs: torch.Tensor, draws, packed=None):
        """(action, value, neglogp) (policies.py:77-96), the action sampled from the
        distribution with noise from ``draws``; ``packed`` is ``pack()``'s result,
        taken once for a rollout."""
        pdflat, value = self._heads(obs, packed)
        pd = self.pdtype.pdfromflat(pdflat)
        action = pd.sample(pd.noise(draws))
        return action, value, pd.neglogp(action)

    @torch.no_grad()
    def mode_step(self, obs: torch.Tensor, packed=None):
        """(action, value) with the distribution's mode (policy.py:131-134): the first of
        equal maxima of a categorical, as ``jnp.argmax`` takes it, or the Gaussian's
        mean, for deterministic play."""
        pdflat, value = self._heads(obs, packed)
        return self.pdtype.pdfromflat(pdflat).mode(), value

    @torch.no_grad()
    def value(self, obs: torch.Tensor, packed=None) -> torch.Tensor:
        return self._heads(obs, packed)[1]


def build_policy(ob_space, ac_space, network: str = "mlp", *, device,
                 generator: torch.Generator | None = None, **network_kwargs) -> Policy:
    """policies.build_policy for a shared latent: ``Discrete``, ``MultiDiscrete`` or
    ``Box`` observations, and ``Discrete``, ``MultiDiscrete``, ``Box`` or
    ``MultiBinary`` actions."""
    if not isinstance(ob_space, (Discrete, MultiDiscrete, Box)):
        raise NotImplementedError(f"the port's policies do not take {ob_space!r} observations")
    pdtype = make_pdtype(ac_space)
    net = get_network(network, ob_shape=encoded_shape(ob_space), generator=generator,
                      **network_kwargs)
    module = PolicyValueNet(net, ob_space, pdtype, generator).to(device)
    return Policy(module, ob_space, ac_space)
