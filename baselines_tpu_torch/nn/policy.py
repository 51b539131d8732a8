"""Policy (counterpart of baselines_tpu/nn/policy.py:30-175).

``PolicyValueNet`` encodes the observation (one-hot for ``Discrete`` and
``MultiDiscrete``), runs a latent network, and puts a distribution head (orthogonal
init, gain 0.01) and a value head (gain 1.0) on the latent, or the value head on a
separate value tower of the same architecture (``value_network="copy"``). For a ``Box``
action space the head is the diagonal Gaussian's: ``pi`` gives the mean and a ``logstd``
parameter of shape (1, d), initialised to zero, the log standard deviation. A recurrent
network threads a carry and a mask through ``forward``, and ``unroll`` runs it over a
time-major sequence for the loss.
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
    """The latent network, an optional separate value tower (``value_network``), the
    distribution head and the value head (policy.py:44-90). ``forward(obs, rnn_state,
    rnn_mask) -> (pdflat, vf, rnn_state)``; a feedforward network passes the carry
    through as it came (None)."""

    def __init__(self, network: nn.Module, ob_space, pdtype: PdType,
                 generator: torch.Generator | None = None,
                 value_network: nn.Module | None = None):
        super().__init__()
        self.network = network
        self.is_recurrent = bool(network.is_recurrent)
        if value_network is not None and self.is_recurrent:
            raise NotImplementedError("a recurrent network with value_network='copy' is not "
                                      "supported, as in the JAX package (policy.py:66-67)")
        self.value_network = value_network
        self.ob_space = ob_space
        self.gaussian = pdtype.kind == "diag_gaussian"
        width = pdtype.param_size // 2 if self.gaussian else pdtype.param_size
        self.pi = _ortho(nn.Linear(network.latent_size, width), 0.01, generator)
        if self.gaussian:
            self.logstd = nn.Parameter(torch.zeros((1, width)))
        self.vf = _ortho(nn.Linear(network.latent_size, 1), 1.0, generator)

    def heads(self, latent: torch.Tensor, vlatent: torch.Tensor | None = None):
        """(flat distribution parameters, value) from the f32 latent, the value from the
        value tower's latent ``vlatent`` where there is one."""
        pdflat = self.pi(latent)
        if self.gaussian:
            pdflat = torch.cat([pdflat, self.logstd.expand_as(pdflat)], dim=-1)
        return pdflat, self.vf(latent if vlatent is None else vlatent)[..., 0]

    def forward(self, obs: torch.Tensor, rnn_state: torch.Tensor | None = None,
                rnn_mask: torch.Tensor | None = None):
        x = encode_observation(self.ob_space, obs)
        if self.is_recurrent:
            latent, rnn_state = self.network(x, rnn_state, rnn_mask)
        else:
            latent = self.network(x)
        vlatent = None if self.value_network is None else self.value_network(x)
        pdflat, vf = self.heads(latent, vlatent)
        return pdflat, vf, rnn_state

    def unroll(self, obs: torch.Tensor, rnn_state: torch.Tensor, masks: torch.Tensor):
        """A recurrent policy over a time-major sequence, ``obs`` (T, B, ...) and
        ``masks`` (T, B) from the carry before its first step: (pdflat (T * B, ...), vf
        (T * B,), the carry after the last step), flattened time-major. The same
        function as T calls of ``forward``, with the encoder run once over all frames
        (``RecurrentNetwork.unroll``)."""
        nsteps, nb = masks.shape
        x = encode_observation(self.ob_space, obs.reshape((nsteps * nb,) + obs.shape[2:]))
        latent, rnn_state = self.network.unroll(x, rnn_state, masks)
        pdflat, vf = self.heads(latent)
        return pdflat, vf, rnn_state


class Policy:
    """The act surface over a ``PolicyValueNet``. A recurrent policy
    (``is_recurrent``) steps with a carry from ``initial_state`` and a mask (1 where the
    env starts a new episode, zeros when None); ``step`` and ``mode_step`` then return
    the new carry after their other outputs."""

    def __init__(self, module: PolicyValueNet, ob_space, ac_space):
        self.module = module
        self.ob_space = ob_space
        self.ac_space = ac_space
        self.pdtype = make_pdtype(ac_space)
        self.is_recurrent = module.is_recurrent

    @property
    def uses_kernel(self) -> bool:
        return uses_fused_kernel(self.module.network)

    def initial_state(self, batch_size: int) -> torch.Tensor | None:
        """The zero carry of ``batch_size`` envs, or None for a feedforward policy."""
        if not self.is_recurrent:
            return None
        device = next(self.module.parameters()).device
        return self.module.network.initial_state(batch_size, device)

    def pack(self):
        """The fused kernel's weights, packed from the current params, or None when
        the network does not run through the kernel."""
        return pack_params(self.module.network) if self.uses_kernel else None

    def _heads(self, obs: torch.Tensor, packed, rnn_state, rnn_mask):
        x = encode_observation(self.ob_space, obs)
        net, vnet = self.module.network, self.module.value_network
        if self.is_recurrent:
            if rnn_state is None:
                raise ValueError("a recurrent policy steps with a carry (initial_state)")
            if rnn_mask is None:
                rnn_mask = torch.zeros(x.shape[:1], dtype=torch.float32, device=x.device)
            latent, rnn_state = net(x, rnn_state, rnn_mask)
        else:
            latent = act_latent(net, x, packed)
        vlatent = None if vnet is None else act_latent(vnet, x)
        return self.module.heads(latent, vlatent) + (rnn_state,)

    @torch.no_grad()
    def step(self, obs: torch.Tensor, draws, packed=None, rnn_state=None, rnn_mask=None):
        """(action, value, neglogp) (policies.py:77-96), the action sampled from the
        distribution with noise from ``draws``; ``packed`` is ``pack()``'s result,
        taken once for a rollout. With a carry, the new carry comes last."""
        pdflat, value, rnn_state = self._heads(obs, packed, rnn_state, rnn_mask)
        pd = self.pdtype.pdfromflat(pdflat)
        action = pd.sample(pd.noise(draws))
        out = (action, value, pd.neglogp(action))
        return out if rnn_state is None else out + (rnn_state,)

    @torch.no_grad()
    def mode_step(self, obs: torch.Tensor, packed=None, rnn_state=None, rnn_mask=None):
        """(action, value) with the distribution's mode (policy.py:131-134): the first of
        equal maxima of a categorical, as ``jnp.argmax`` takes it, or the Gaussian's
        mean, for deterministic play. With a carry, the new carry comes last."""
        pdflat, value, rnn_state = self._heads(obs, packed, rnn_state, rnn_mask)
        out = (self.pdtype.pdfromflat(pdflat).mode(), value)
        return out if rnn_state is None else out + (rnn_state,)

    @torch.no_grad()
    def value(self, obs: torch.Tensor, packed=None, rnn_state=None,
              rnn_mask=None) -> torch.Tensor:
        return self._heads(obs, packed, rnn_state, rnn_mask)[1]


def build_policy(ob_space, ac_space, network: str = "mlp", *, device,
                 generator: torch.Generator | None = None, value_network: str | None = None,
                 **network_kwargs) -> Policy:
    """policies.build_policy (policy.py:143-175): ``Discrete``, ``MultiDiscrete`` or
    ``Box`` observations, and ``Discrete``, ``MultiDiscrete``, ``Box`` or
    ``MultiBinary`` actions. ``value_network`` None or "shared" shares the latent;
    "copy" builds an independent value tower of the same architecture, initialised
    after the policy's."""
    if not isinstance(ob_space, (Discrete, MultiDiscrete, Box)):
        raise NotImplementedError(f"the port's policies do not take {ob_space!r} observations")
    if value_network not in (None, "shared", "copy"):
        raise ValueError(f"value_network must be None, 'shared' or 'copy', got {value_network!r}")
    pdtype = make_pdtype(ac_space)

    def make_net():
        return get_network(network, ob_shape=encoded_shape(ob_space), generator=generator,
                           **network_kwargs)

    net = make_net()
    vnet = make_net() if value_network == "copy" else None
    module = PolicyValueNet(net, ob_space, pdtype, generator, vnet).to(device)
    return Policy(module, ob_space, ac_space)
