"""The random draws of a run.

The JAX package threads ``jax.random`` keys through its state; the port draws from one
``torch.Generator`` instead. Everything random that a run takes (env reset states, the
Gumbel uniforms and Gaussian noise of action sampling, the identity envs' targets, the
epoch permutations) goes through a ``Draws``, so a test can hand the port the very
numbers the JAX package drew by passing an object with the same methods.

Under a data-parallel mesh every rank seeds the same generator, as the JAX package
replicates its key, and steps its envs through a ``ShardedDraws``: each draw on the env
axis is taken at the global shape and the rank keeps its own rows, so that a W-rank run
draws what a one-process run draws.
"""

from __future__ import annotations

import torch


class Draws:
    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, shape, low: float, high: float) -> torch.Tensor:
        """f32 uniforms in [low, high), as ``jax.random.uniform(key, shape, f32, low, high)``."""
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return torch.clamp(u * (high - low) + low, min=low)

    def normal(self, shape) -> torch.Tensor:
        """f32 standard normals, as ``jax.random.normal(key, shape)``."""
        return torch.randn(shape, generator=self.generator, device=self.device)

    def randint(self, low: int, high: int, shape) -> torch.Tensor:
        """int32 integers in [low, high)."""
        return torch.randint(low, high, shape, generator=self.generator, device=self.device,
                             dtype=torch.int32)

    def state_dict(self) -> dict:
        """The generator's state, a CPU byte tensor also for a generator on the card."""
        return {"generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.generator.set_state(state["generator"].cpu())

    def permutation(self, n: int) -> torch.Tensor:
        """A random permutation of range(n), int64."""
        return torch.randperm(n, generator=self.generator, device=self.device)


class ShardedDraws:
    """A rank's view of the run's draws under a mesh of ``mesh.size`` ranks.

    ``uniform``, ``normal`` and ``randint`` take the rank's shape, whose leading axis is
    its envs (reset states, action noise, epsilon-greedy draws, identity targets), draw
    at the global shape and keep the rank's rows. ``permutation(n)`` is the epoch
    shuffle of ppo's shard-local epochs (ppo.py:263-306, 331-372): one permutation of
    ``n`` local samples or envs for each shard, drawn in rank order, of which the rank
    keeps its own. ``replicated`` is the generator's own ``Draws``, for the draws every
    rank takes alike (the replay sample)."""

    def __init__(self, draws: Draws, mesh):
        self.replicated = draws
        self.rank, self.size = mesh.rank, mesh.size

    def _global(self, shape) -> tuple:
        shape = tuple(shape)
        return (shape[0] * self.size,) + shape[1:]

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0] // self.size
        return x[self.rank * n:(self.rank + 1) * n]

    def uniform(self, shape, low: float, high: float) -> torch.Tensor:
        return self._rows(self.replicated.uniform(self._global(shape), low, high))

    def normal(self, shape) -> torch.Tensor:
        return self._rows(self.replicated.normal(self._global(shape)))

    def randint(self, low: int, high: int, shape) -> torch.Tensor:
        return self._rows(self.replicated.randint(low, high, self._global(shape)))

    def permutation(self, n: int) -> torch.Tensor:
        perms = [self.replicated.permutation(n) for _ in range(self.size)]
        return perms[self.rank]

    def state_dict(self) -> dict:
        return self.replicated.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.replicated.load_state_dict(state)
