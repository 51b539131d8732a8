"""Custom-network example (counterpart of baselines_tpu/examples/custom_network.py) —
parity with baselines/deepq/experiments/custom_cartpole.py: register your own torch
module in the network registry and train ppo2 with its name in place of a zoo name.

A port network keeps the contract of ``networks.register``: it is built with
``ob_shape``, the shape of one encoded observation (torch needs the input width where
flax infers it), ``generator`` and the network keywords (here ``width``), and has
``latent_size`` and ``is_recurrent``. The layers carry the flax module's names,
``Dense_0`` and ``Dense_1``, and flax's default Dense init, so
``convert.network_state_dict`` carries the JAX example's params across unchanged.

    python -m baselines_tpu_torch.examples.custom_network
"""

import math

import torch
import torch.nn as nn

from baselines_tpu_torch.algos.ppo.ppo import learn
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.nn import networks
from baselines_tpu_torch.nn.networks import _lecun


@networks.register("my_tiny_net")
class MyTinyNet(nn.Module):
    is_recurrent = False

    def __init__(self, ob_shape, width: int = 32, generator: torch.Generator | None = None):
        super().__init__()
        self.latent_size = width
        self.Dense_0 = _lecun(nn.Linear(math.prod(ob_shape), width), generator)
        self.Dense_1 = _lecun(nn.Linear(width, width), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(torch.float32).reshape(x.shape[0], -1)
        h = torch.relu(self.Dense_0(h))
        return torch.relu(self.Dense_1(h))


LEARN_KWARGS = dict(
    env_id="CartPole-v1",
    network="my_tiny_net",
    width=64,
    total_timesteps=100_000,
    num_envs=8,
    nsteps=128,
    lr=2.5e-3,
)


def main():
    logger.configure()
    learn(**LEARN_KWARGS)


if __name__ == "__main__":
    main()
