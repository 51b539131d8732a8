"""Environment registry (counterpart of baselines_tpu/envs/registry.py).

Registered, all stepped on the device: the classic envs ``CartPole-v0``/``-v1``,
``Pendulum-v1``, ``MountainCar-v0``, ``MountainCarContinuous-v0`` and ``Acrobot-v1``;
the fixture envs ``DiscreteIdentity-v0``, ``BoxIdentity-v0``,
``MultiDiscreteIdentity-v0``, ``ImageIdentity-v0``, ``ImageIdentity36-v0``,
``FixedSequence-v0`` and ``ImageFixedSequence-v0``; ``AtariSim-v0``; and the goal env
``PointReach-v0``; ``register_env`` adds a user's. ``make_env`` serves the registered
device ids only, as the JAX package's does; gymnasium ids and ``native:`` ids are host
envs, which ``algos.common.build_env`` builds behind the host bridge
(``envs/gym_bridge.py``, ``native/``).
"""

from __future__ import annotations

from typing import Callable

from baselines_tpu_torch.core.registry import Registry
from baselines_tpu_torch.envs.base import TorchEnv
from baselines_tpu_torch.envs.classic.acrobot import make_acrobot
from baselines_tpu_torch.envs.classic.cartpole import make_cartpole
from baselines_tpu_torch.envs.classic.mountain_car import (make_mountain_car,
                                                           make_mountain_car_continuous)
from baselines_tpu_torch.envs.classic.pendulum import make_pendulum
from baselines_tpu_torch.envs.goal.point_reach import make_point_reach
from baselines_tpu_torch.envs.testing.atari_sim import AtariSim
from baselines_tpu_torch.envs.testing.fixed_sequence import (FixedSequenceEnv,
                                                             ImageFixedSequenceEnv)
from baselines_tpu_torch.envs.testing.identity import (BoxIdentityEnv, DiscreteIdentityEnv,
                                                       ImageIdentityEnv,
                                                       MultiDiscreteIdentityEnv)

_ENVS: Registry = Registry("env")  # env id -> (factory, env type)


def register_env(env_id: str, env_type: str = "classic_control"):
    """Register a device env factory under ``env_id`` with its ``env_type``, the key of
    the per-algorithm defaults (registry.py:20-22), as a decorator:
    ``register_env("MyEnv-v0", "testing")(factory)``. The factory takes no argument and
    returns a ``TorchEnv``. A second registration of the same id raises ``ValueError``."""
    def deco(factory: Callable[[], TorchEnv]) -> Callable[[], TorchEnv]:
        _ENVS.register(env_id)((factory, env_type))
        return factory

    return deco


# as registry.py:73-101 registers them
register_env("CartPole-v0")(lambda: make_cartpole(0))
register_env("CartPole-v1")(lambda: make_cartpole(1))
register_env("Pendulum-v1")(make_pendulum)
register_env("MountainCar-v0")(make_mountain_car)
register_env("MountainCarContinuous-v0")(make_mountain_car_continuous)
register_env("Acrobot-v1")(make_acrobot)
register_env("PointReach-v0", "robotics")(make_point_reach)
register_env("DiscreteIdentity-v0", "testing")(lambda: DiscreteIdentityEnv(10))
register_env("BoxIdentity-v0", "testing")(lambda: BoxIdentityEnv((1,)))
register_env("MultiDiscreteIdentity-v0", "testing")(
    lambda: MultiDiscreteIdentityEnv((3, 3)))
register_env("ImageIdentity-v0", "testing")(lambda: ImageIdentityEnv())
register_env("ImageIdentity36-v0", "testing")(lambda: ImageIdentityEnv(size=36))
register_env("FixedSequence-v0", "testing")(lambda: FixedSequenceEnv())
# seed 3 draws an all-distinct action sequence (registry.py:97-99)
register_env("ImageFixedSequence-v0", "testing")(lambda: ImageFixedSequenceEnv(seed=3))
register_env("AtariSim-v0", "testing")(lambda: AtariSim())


def env_names():
    return _ENVS.names()


def is_torch_env(env_id: str) -> bool:
    """Whether the port steps ``env_id`` on the device (the counterpart of is_jax_env)."""
    return env_id in _ENVS


def get_env_type(env_id: str) -> str:
    """classic_control / mujoco / atari / testing / robotics, the key of the per-algorithm
    defaults (registry.py:34-50)."""
    if env_id.startswith("native:"):
        env_id = env_id.split(":", 1)[1]
    if env_id in _ENVS:
        return _ENVS.get(env_id)[1]
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
        return _ENVS.get(env_id)[0]()
    raise ValueError(f"{env_id!r} is not a device env (the device envs are {env_names()}); "
                   "a gymnasium or native: id is a host env, which "
                   "baselines_tpu_torch.algos.common.build_env builds")
