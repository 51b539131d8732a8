"""The port's returns and replay buffers (counterpart of baselines_tpu/data/__init__.py),
with the same exports."""

from baselines_tpu_torch.data.gae import gae, nstep_returns, discount_with_dones
from baselines_tpu_torch.data.replay import ReplayBuffer, ReplayState
from baselines_tpu_torch.data.prioritized import PrioritizedReplayBuffer, PrioritizedState

__all__ = [
    "gae",
    "nstep_returns",
    "discount_with_dones",
    "ReplayBuffer",
    "ReplayState",
    "PrioritizedReplayBuffer",
    "PrioritizedState",
]
