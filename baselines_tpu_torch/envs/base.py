"""The batched environment interface (counterpart of baselines_tpu/envs/base.py:39-57).

The JAX package writes one env as pure functions and vmaps them over N copies. The
port writes the batch directly: an env holds no state of its own, and every tensor of
its state has the batch as its first axis.

    obs, state = env.reset(draws, num_envs, device)
    obs, state, reward, done, info = env.step(state, action)

- ``state`` is a dataclass of tensors, each (N, ...).
- ``draws`` (core/rng.py) supplies every random number a reset takes.
- ``done`` is the combined terminated-or-truncated flag.
- Auto-reset is not done here; the vector layer does it (envs/vec.py).
"""

from __future__ import annotations

import torch

from baselines_tpu_torch.envs.spaces import Space


class TorchEnv:
    observation_space: Space
    action_space: Space

    def reset(self, draws, num_envs: int, device: torch.device):
        raise NotImplementedError

    def step(self, state, action):
        raise NotImplementedError
