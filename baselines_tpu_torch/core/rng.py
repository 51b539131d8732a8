"""The random draws of a run.

The JAX package threads ``jax.random`` keys through its state; the port draws from one
``torch.Generator`` instead. Everything random that a run takes (env reset states, the
Gumbel uniforms of action sampling, the epoch permutations) goes through a ``Draws``,
so a test can hand the port the very numbers the JAX package drew by passing an object
with the same three methods.
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

    def randint(self, low: int, high: int, shape) -> torch.Tensor:
        """int32 integers in [low, high)."""
        return torch.randint(low, high, shape, generator=self.generator, device=self.device,
                             dtype=torch.int32)

    def permutation(self, n: int) -> torch.Tensor:
        """A random permutation of range(n), int64."""
        return torch.randperm(n, generator=self.generator, device=self.device)
