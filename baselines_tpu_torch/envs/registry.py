"""Environment registry (counterpart of baselines_tpu/envs/registry.py).

Registered so far: ``CartPole-v0``, ``CartPole-v1`` and ``AtariSim-v0``, all stepped on
the device. An id that the JAX package serves as a pure env the port has not ported
yet, or through its host bridge (gymnasium ids, ``native:`` ids), raises
``NotImplementedError`` naming the item of ROADMAP.md's Queue 1 that brings it.
"""

from __future__ import annotations

from typing import Callable

from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.classic.cartpole import make_cartpole
from baselines_tpu_torch.envs.testing.atari_sim import AtariSim

# env id -> (factory, env type)
_ENVS: dict[str, tuple[Callable[[], TorchEnv], str]] = {
    "CartPole-v0": (lambda: make_cartpole(0), "classic_control"),
    "CartPole-v1": (lambda: make_cartpole(1), "classic_control"),
    "AtariSim-v0": (lambda: AtariSim(), "testing"),
}

# the JAX package's other device envs, and the Queue 1 item that ports each
_NOT_PORTED = {
    **{name: "item 3 (envs and wrappers)" for name in (
        "Pendulum-v1", "MountainCar-v0", "MountainCarContinuous-v0", "Acrobot-v1",
        "DiscreteIdentity-v0", "BoxIdentity-v0", "MultiDiscreteIdentity-v0",
        "ImageIdentity-v0", "ImageIdentity36-v0", "FixedSequence-v0",
        "ImageFixedSequence-v0")},
    "PointReach-v0": "item 7 (her and the goal envs)",
}


def env_names():
    return sorted(_ENVS)


def is_torch_env(env_id: str) -> bool:
    """Whether the port steps ``env_id`` on the device (the counterpart of is_jax_env)."""
    return env_id in _ENVS


def get_env_type(env_id: str) -> str:
    """classic_control / mujoco / atari / testing / robotics, the key of the per-algorithm
    defaults (registry.py:34-50)."""
    if env_id.startswith("native:"):
        env_id = env_id.split(":", 1)[1]
    if env_id in _ENVS:
        return _ENVS[env_id][1]
    lid = env_id.lower()
    if "noframeskip" in lid or "ale/" in lid:
        return "atari"
    for name in ("halfcheetah", "hopper", "walker", "ant", "humanoid", "swimmer",
                 "reacher", "invertedpendulum", "inverteddoublependulum", "pusher"):
        if lid.startswith(name):
            return "mujoco"
    if lid.startswith("fetch") or lid.startswith("hand"):
        return "robotics"
    return "classic_control"


def make_env(env_id: str) -> TorchEnv:
    """Instantiate a batched device env by id."""
    if env_id in _ENVS:
        return _ENVS[env_id][0]()
    item = _NOT_PORTED.get(env_id, "item 8 (the host env bridge)")
    raise NotImplementedError(f"env {env_id!r} is not ported yet; it comes with {item} of "
                              f"ROADMAP.md's Queue 1. The port has {env_names()}")

