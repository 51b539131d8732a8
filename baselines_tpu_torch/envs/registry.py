"""Environment registry (counterpart of baselines_tpu/envs/registry.py). Only the env of
the port's first slice is registered so far."""

from __future__ import annotations

from typing import Callable

from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.testing.atari_sim import AtariSim

_ENVS: dict[str, Callable[[], TorchEnv]] = {
    "AtariSim-v0": lambda: AtariSim(),
}


def env_names():
    return sorted(_ENVS)


def make_env(env_id: str) -> TorchEnv:
    """Instantiate an env by id."""
    if env_id not in _ENVS:
        raise KeyError(f"unknown env {env_id!r}; the port has {env_names()}")
    return _ENVS[env_id]()
