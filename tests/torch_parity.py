"""Helpers for the tests that hold the PyTorch port against the JAX package on the CPU.

JAX draws with threefry keys and the port with a torch.Generator, so the two cannot
share a seed. These helpers rebuild what the JAX package draws, from the same key
splits it makes, and hand those numbers to the port through a stand-in for its
``Draws`` (baselines_tpu_torch/core/rng.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

# the suite runs in several worker processes at once; one torch thread each keeps them
# from oversubscribing the cores
torch.set_num_threads(1)


class ReplayDraws:
    """Serves the port recorded draws, in the order it asks for them."""

    def __init__(self):
        self.queue = []

    def push(self, kind: str, values) -> None:
        self.queue.append((kind, np.asarray(values)))

    def _pop(self, kind: str, shape) -> np.ndarray:
        assert self.queue, f"the port asked for more draws than were recorded ({kind})"
        got_kind, values = self.queue.pop(0)
        assert got_kind == kind and values.shape == tuple(shape), (
            f"the port asked for {kind} {tuple(shape)}, the next draw is {got_kind} "
            f"{values.shape}"
        )
        return values

    def uniform(self, shape, low, high):
        return torch.from_numpy(self._pop("uniform", shape).astype(np.float32))

    def randint(self, low, high, shape):
        return torch.from_numpy(self._pop("randint", shape).astype(np.int32))

    def permutation(self, n):
        return torch.from_numpy(self._pop("permutation", (n,)).astype(np.int64))


def push_reset(draws: ReplayDraws, env, key, num_envs: int) -> None:
    """The draws of VecJaxEnv.reset(key) on AtariSim: its sprite positions, then
    velocities."""
    _, st = jax.vmap(env.reset)(jax.random.split(key, num_envs))
    draws.push("randint", st.x)
    draws.push("randint", st.v)


def push_env_step(draws: ReplayDraws, env, key, num_envs: int) -> None:
    """The reset draws of VecJaxEnv.step(key, ...) (envs/vec.py:161-177), which the
    port takes at every step."""
    _, kreset = jax.random.split(key)
    push_reset(draws, env, kreset, num_envs)


def push_rollout_step(draws: ReplayDraws, env, key, num_envs: int, n_actions: int):
    """One step of run_rollout (algos/common.py:228-230): the Gumbel uniforms of
    policy.step, then the env's draws. Returns the carried key."""
    key, kact, kstep = jax.random.split(key, 3)
    draws.push("uniform", jax.random.uniform(kact, (num_envs, n_actions), jnp.float32, 1e-10, 1.0))
    push_env_step(draws, env, kstep, num_envs)
    return key


def push_epochs(draws: ReplayDraws, key, noptepochs: int, nbatch: int) -> None:
    """The epoch permutations of one update (algos/ppo/ppo.py:374-375, :321)."""
    ekeys = jax.random.split(key, noptepochs + 1)
    for ekey in ekeys[1:]:
        draws.push("permutation", jax.random.permutation(ekey, nbatch))


def policy_params(seed: int, n_actions: int = 6) -> dict:
    """Params of the JAX PolicyValueNet(NatureCNNS2D) in flax layout, made with numpy
    (quicker than flax's orthogonal init): kernels scaled like that init, gain over the
    root of the fan-in, and small nonzero biases."""
    rng = np.random.RandomState(seed)

    def layer(shape, gain):
        kernel = rng.randn(*shape) * gain / np.sqrt(np.prod(shape[:-1]))
        return {"kernel": kernel.astype(np.float32),
                "bias": (rng.randn(shape[-1]) * 0.01).astype(np.float32)}

    g = np.sqrt(2)
    network = {"c1": layer((2, 2, 64, 32), g), "c2": layer((4, 4, 32, 64), g),
               "c3": layer((3, 3, 64, 64), g), "fc1": layer((3136, 512), g)}
    return {"params": {"network": network, "pi": layer((512, n_actions), 0.01),
                       "vf": layer((512, 1), 1.0)}}


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))
