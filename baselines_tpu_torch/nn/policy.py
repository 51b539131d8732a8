"""Policy (counterpart of baselines_tpu/nn/policy.py:46-138).

``PolicyValueNet`` is a latent network with a categorical head (orthogonal init, gain
0.01) and a value head (gain 1.0) on the shared latent. ``Policy.step`` and
``Policy.value`` serve the rollout and ``Policy.mode_step`` the deterministic play,
without gradients: when the network is the
space-to-depth Nature CNN in bf16, its forward is the fused CUDA kernel
(``ops/fused_cnn.py``), whose arithmetic is that network's; any other network runs its
own forward. The loss calls the module itself, with autograd.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from baselines_tpu_torch.envs.spaces import Box, Discrete
from baselines_tpu_torch.nn.distributions import CategoricalPd
from baselines_tpu_torch.nn.networks import NatureCNNS2D, _ortho, get_network
from baselines_tpu_torch.ops.fused_cnn import fused_cnn_forward, pack_params


def encode_observation(space, obs: torch.Tensor) -> torch.Tensor:
    """input.py:43-63: one-hot f32 for ``Discrete``; a ``Box`` passes through (the
    networks divide u8 images by 255)."""
    if isinstance(space, Discrete):
        return F.one_hot(obs.long(), space.n).to(torch.float32)
    if isinstance(space, Box):
        return obs
    raise NotImplementedError(f"the port cannot encode observations for {space!r} yet")


def encoded_shape(space) -> tuple:
    """The shape of one observation as ``encode_observation`` gives it."""
    if isinstance(space, Discrete):
        return (space.n,)
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
    def __init__(self, network: nn.Module, n_actions: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.network = network
        self.pi = _ortho(nn.Linear(network.latent_size, n_actions), 0.01, generator)
        self.vf = _ortho(nn.Linear(network.latent_size, 1), 1.0, generator)

    def heads(self, latent: torch.Tensor):
        """(logits, value) from the f32 latent."""
        return self.pi(latent), self.vf(latent)[..., 0]

    def forward(self, obs: torch.Tensor):
        return self.heads(self.network(obs))


class Policy:
    def __init__(self, module: PolicyValueNet, ob_space, ac_space):
        self.module = module
        self.ob_space = ob_space
        self.ac_space = ac_space

    @property
    def uses_kernel(self) -> bool:
        return uses_fused_kernel(self.module.network)

    def pack(self):
        """The fused kernel's weights, packed from the current params, or None when
        the network does not run through the kernel."""
        return pack_params(self.module.network) if self.uses_kernel else None

    @torch.no_grad()
    def step(self, obs: torch.Tensor, draws, packed=None):
        """(action, value, neglogp) (policies.py:77-96); ``packed`` is ``pack()``'s
        result, taken once for a rollout."""
        logits, value = self.module.heads(act_latent(self.module.network, obs, packed))
        pd = CategoricalPd(logits)
        action = pd.sample(draws.uniform(logits.shape, 1e-10, 1.0))
        return action, value, pd.neglogp(action)

    @torch.no_grad()
    def mode_step(self, obs: torch.Tensor, packed=None):
        """(action, value) with the most probable action, the first of equal maxima as
        ``jnp.argmax`` takes it (policy.py:131-134), for deterministic play."""
        logits, value = self.module.heads(act_latent(self.module.network, obs, packed))
        return CategoricalPd(logits).mode(), value

    @torch.no_grad()
    def value(self, obs: torch.Tensor, packed=None) -> torch.Tensor:
        return self.module.heads(act_latent(self.module.network, obs, packed))[1]


def build_policy(ob_space, ac_space, network: str = "mlp", *, device,
                 generator: torch.Generator | None = None, **network_kwargs) -> Policy:
    """policies.build_policy for a shared latent, a ``Box`` observation and a
    ``Discrete`` action space."""
    if not isinstance(ac_space, Discrete):
        raise NotImplementedError(f"the port has only categorical policies, not {ac_space!r}")
    if not isinstance(ob_space, Box):
        raise NotImplementedError(f"the port's policies take Box observations, not {ob_space!r}")
    net = get_network(network, ob_shape=encoded_shape(ob_space), generator=generator,
                      **network_kwargs)
    module = PolicyValueNet(net, ac_space.n, generator).to(device)
    return Policy(module, ob_space, ac_space)
