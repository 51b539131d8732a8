"""The port's spaces, envs and env registry (counterpart of
baselines_tpu/envs/__init__.py). The exports are the JAX package's under the port's
names where they differ: ``TorchEnv`` for ``JaxEnv`` and ``VecTorchEnv`` for
``VecJaxEnv``."""

from baselines_tpu_torch.envs.spaces import Box, Discrete, MultiBinary, MultiDiscrete, Space
from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.vec import VecTorchEnv, EpisodeStats
from baselines_tpu_torch.envs.registry import make_env, register_env, env_names

__all__ = [
    "Box",
    "Discrete",
    "MultiBinary",
    "MultiDiscrete",
    "Space",
    "TorchEnv",
    "VecTorchEnv",
    "EpisodeStats",
    "make_env",
    "register_env",
    "env_names",
]
