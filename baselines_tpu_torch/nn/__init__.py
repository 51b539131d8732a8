"""The port's distributions, networks and policies (counterpart of
baselines_tpu/nn/__init__.py), with the same exports."""

from baselines_tpu_torch.nn.distributions import (
    CategoricalPd,
    DiagGaussianPd,
    BernoulliPd,
    MultiCategoricalPd,
    make_pdtype,
)
from baselines_tpu_torch.nn.networks import get_network, network_names
from baselines_tpu_torch.nn.policy import PolicyValueNet, Policy, build_policy

__all__ = [
    "CategoricalPd",
    "DiagGaussianPd",
    "BernoulliPd",
    "MultiCategoricalPd",
    "make_pdtype",
    "get_network",
    "network_names",
    "PolicyValueNet",
    "Policy",
    "build_policy",
]
