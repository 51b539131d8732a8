"""Proportional prioritized replay on the device (counterpart of
baselines_tpu/data/prioritized.py).

The priorities are a dense vector of p_i^alpha, 0 where unfilled. Semantics of
deepq/replay_buffer.py: new transitions enter with the running max priority^alpha;
sampling is stratified, one uniform for each of ``batch_size`` equal slices of the
total mass; the importance weights are (n P(i))^-beta over their max; priorities are
updated with |td| + eps by the caller, alpha applied here.

The indices come from the stratified-sampling kernel (``ops/stratified_sample.py``),
the JAX package's ``use_pallas=True`` route: its tie-break is ``side='right'``, where
the JAX package's default route (cumsum + searchsorted) takes ``side='left'``, so the
two differ only on a target that lands exactly on a prefix boundary. The priority
vector is padded with zeros to a multiple of 2048 slots, which the kernel needs (the
JAX package asks for a multiple of 16384, a rule of the TPU's tiles), and the index is
clipped to ``capacity - 1``. The state is updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from baselines_tpu_torch.data.replay import ReplayBuffer, ReplayState
from baselines_tpu_torch.ops.gather import take_rows
from baselines_tpu_torch.ops.stratified_sample import BLOCK, stratified_sample


@dataclass
class PrioritizedState:
    buffer: ReplayState
    priorities: torch.Tensor  # (capacity,) p_i^alpha, zero-padded to a multiple of 2048 slots
    max_priority: torch.Tensor  # () f32, the raw (un-alpha'd) running max


class PrioritizedReplayBuffer:
    def __init__(self, capacity: int, alpha: float = 0.6):
        self.buffer = ReplayBuffer(capacity)
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self.slots = -(-self.capacity // BLOCK) * BLOCK

    def init(self, sample_item: dict) -> PrioritizedState:
        device = next(iter(sample_item.values())).device
        return PrioritizedState(
            buffer=self.buffer.init(sample_item),
            priorities=torch.zeros((self.slots,), dtype=torch.float32, device=device),
            max_priority=torch.ones((), dtype=torch.float32, device=device),
        )

    def add_batch(self, state: PrioritizedState, batch: dict) -> PrioritizedState:
        b = next(iter(batch.values())).shape[0]
        new_prio = state.max_priority ** self.alpha
        for dst, _ in self.buffer.ring_slices(state.buffer.ptr, b):
            state.priorities[dst] = new_prio
        return replace(state, buffer=self.buffer.add_batch(state.buffer, batch))

    def sample(self, state: PrioritizedState, draws, batch_size: int, beta: float):
        """Returns (batch, idx, is_weights); idx is int64."""
        u = draws.uniform((batch_size,), 0.0, 1.0)
        prios = state.priorities[: self.capacity]
        idx = stratified_sample(state.priorities, u, batch_size)
        idx = torch.clamp(idx, 0, self.capacity - 1).to(torch.int64)
        batch = {k: take_rows(buf, idx) for k, buf in state.buffer.data.items()}
        # importance weights; p / total is monotone in p, so the least probability is
        # the least positive priority over the total, as the JAX package's min of p / total
        n = torch.full((), float(max(state.buffer.size, 1)), device=prios.device)
        total = torch.clamp(torch.sum(prios), min=1e-12)
        min_prob = torch.where(prios > 0, prios, torch.inf).min() / total
        max_weight = (min_prob * n) ** (-beta)
        weights = (prios[idx] / total * n) ** (-beta) / torch.clamp(max_weight, min=1e-12)
        return batch, idx, weights

    def update_priorities(self, state: PrioritizedState, idx: torch.Tensor,
                          priorities: torch.Tensor) -> PrioritizedState:
        """``priorities`` are raw (|td| + eps); alpha is applied here
        (replay_buffer.py:178-191)."""
        priorities = priorities.to(torch.float32)
        state.priorities[idx] = priorities ** self.alpha
        return replace(state, max_priority=torch.maximum(state.max_priority, priorities.max()))

    def can_sample(self, state: PrioritizedState, n: int) -> bool:
        return state.buffer.size >= n
