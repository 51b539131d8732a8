"""The random draws of a run.

The JAX package threads ``jax.random`` keys through its state; the port draws from one
``torch.Generator`` instead. Everything random that a run takes (env reset states, the
Gumbel uniforms and Gaussian noise of action sampling, the identity envs' targets, the
epoch permutations) goes through a ``Draws``, so a test can hand the port the very
numbers the JAX package drew by passing an object with the same methods.
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
