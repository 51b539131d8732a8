"""Environment registry (counterpart of baselines_tpu/envs/registry.py).

Registered, all stepped on the device: the classic envs ``CartPole-v0``/``-v1``,
``Pendulum-v1``, ``MountainCar-v0``, ``MountainCarContinuous-v0`` and ``Acrobot-v1``;
the fixture envs ``DiscreteIdentity-v0``, ``BoxIdentity-v0``,
``MultiDiscreteIdentity-v0``, ``ImageIdentity-v0``, ``ImageIdentity36-v0``,
``FixedSequence-v0`` and ``ImageFixedSequence-v0``; and ``AtariSim-v0``. The goal env
``PointReach-v0`` and the ids the JAX package serves through its host bridge (gymnasium
ids, ``native:`` ids) raise ``NotImplementedError`` naming the item of ROADMAP.md's
Queue 1 that brings them.
"""

from __future__ import annotations

from typing import Callable

from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.classic.acrobot import make_acrobot
from baselines_tpu_torch.envs.classic.cartpole import make_cartpole
from baselines_tpu_torch.envs.classic.mountain_car import (make_mountain_car,
                                                           make_mountain_car_continuous)
from baselines_tpu_torch.envs.classic.pendulum import make_pendulum
from baselines_tpu_torch.envs.testing.atari_sim import AtariSim
from baselines_tpu_torch.envs.testing.fixed_sequence import (FixedSequenceEnv,
                                                             ImageFixedSequenceEnv)
from baselines_tpu_torch.envs.testing.identity import (BoxIdentityEnv, DiscreteIdentityEnv,
                                                       ImageIdentityEnv,
                                                       MultiDiscreteIdentityEnv)

# env id -> (factory, env type), as registry.py:73-101 registers them
_ENVS: dict[str, tuple[Callable[[], TorchEnv], str]] = {
    "CartPole-v0": (lambda: make_cartpole(0), "classic_control"),
    "CartPole-v1": (lambda: make_cartpole(1), "classic_control"),
    "Pendulum-v1": (make_pendulum, "classic_control"),
    "MountainCar-v0": (make_mountain_car, "classic_control"),
    "MountainCarContinuous-v0": (make_mountain_car_continuous, "classic_control"),
    "Acrobot-v1": (make_acrobot, "classic_control"),
    "DiscreteIdentity-v0": (lambda: DiscreteIdentityEnv(10), "testing"),
    "BoxIdentity-v0": (lambda: BoxIdentityEnv((1,)), "testing"),
    "MultiDiscreteIdentity-v0": (lambda: MultiDiscreteIdentityEnv((3, 3)), "testing"),
    "ImageIdentity-v0": (lambda: ImageIdentityEnv(), "testing"),
    "ImageIdentity36-v0": (lambda: ImageIdentityEnv(size=36), "testing"),
    "FixedSequence-v0": (lambda: FixedSequenceEnv(), "testing"),
    # seed 3 draws an all-distinct action sequence (registry.py:97-99)
    "ImageFixedSequence-v0": (lambda: ImageFixedSequenceEnv(seed=3), "testing"),
    "AtariSim-v0": (lambda: AtariSim(), "testing"),
}

# the JAX package's other device env, and the Queue 1 item that ports it
_NOT_PORTED = {"PointReach-v0": ("item 7 (her and the goal envs)", "robotics")}


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
    if env_id in _NOT_PORTED:
        return _NOT_PORTED[env_id][1]
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
    item = _NOT_PORTED.get(env_id, ("item 8 (the host env bridge)",))[0]
    raise NotImplementedError(f"env {env_id!r} is not ported yet; it comes with {item} of "
                              f"ROADMAP.md's Queue 1. The port has {env_names()}")
