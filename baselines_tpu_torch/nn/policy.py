"""Policy (counterpart of baselines_tpu/nn/policy.py:46-138).

``PolicyValueNet`` is a latent network with a categorical head (orthogonal init, gain
0.01) and a value head (gain 1.0) on the shared latent. ``Policy.step`` and
``Policy.value`` serve the rollout, without gradients: when the network is the
space-to-depth Nature CNN in bf16, its forward is the fused CUDA kernel
(``ops/fused_cnn.py``), whose arithmetic is that network's; any other network runs its
own forward. The loss calls the module itself, with autograd.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from baselines_tpu_torch.envs.spaces import Discrete
from baselines_tpu_torch.nn.distributions import CategoricalPd
from baselines_tpu_torch.nn.networks import NatureCNNS2D, _ortho, get_network
from baselines_tpu_torch.ops.fused_cnn import fused_cnn_forward, pack_params


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
        net = module.network
        self.uses_kernel = isinstance(net, NatureCNNS2D) and net.dtype == torch.bfloat16

    def pack(self):
        """The fused kernel's weights, packed from the current params, or None when
        the network does not run through the kernel."""
        return pack_params(self.module.network) if self.uses_kernel else None

    def _latent(self, obs: torch.Tensor, packed) -> torch.Tensor:
        if self.uses_kernel:
            return fused_cnn_forward(obs, self.pack() if packed is None else packed)
        return self.module.network(obs)

    @torch.no_grad()
    def step(self, obs: torch.Tensor, draws, packed=None):
        """(action, value, neglogp) (policies.py:77-96); ``packed`` is ``pack()``'s
        result, taken once for a rollout."""
        logits, value = self.module.heads(self._latent(obs, packed))
        pd = CategoricalPd(logits)
        action = pd.sample(draws.uniform(logits.shape, 1e-10, 1.0))
        return action, value, pd.neglogp(action)

    @torch.no_grad()
    def value(self, obs: torch.Tensor, packed=None) -> torch.Tensor:
        return self.module.heads(self._latent(obs, packed))[1]


def build_policy(ob_space, ac_space, network: str = "cnn_s2d", *, device,
                 generator: torch.Generator | None = None, **network_kwargs) -> Policy:
    """policies.build_policy for a shared latent and a Discrete action space."""
    if not isinstance(ac_space, Discrete):
        raise NotImplementedError(f"the port has only categorical policies, not {ac_space!r}")
    net = get_network(network, generator=generator, **network_kwargs)
    module = PolicyValueNet(net, ac_space.n, generator).to(device)
    return Policy(module, ob_space, ac_space)
