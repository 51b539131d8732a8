"""Uniform replay buffer on the device (counterpart of baselines_tpu/data/replay.py).

The transitions are a dict of preallocated device tensors, capacity-major, with the
storage dtypes of a sample item. ``add_batch`` writes the ring ``(ptr + arange(b)) %
capacity`` in place, so no iteration copies the buffer (the JAX package's buffers are
immutable and rely on XLA aliasing the update). ``ptr`` and ``size`` are host integers:
they follow from the number of writes alone, so reading them never waits on the card.
``sample`` draws with replacement and gathers every field through the row-gather kernel
(``ops/gather.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from baselines_tpu_torch.ops.gather import take_rows


@dataclass
class ReplayState:
    data: dict  # name -> (capacity, ...) tensor
    ptr: int = 0  # next write slot
    size: int = 0  # current fill


class ReplayBuffer:
    def __init__(self, capacity: int):
        self.capacity = int(capacity)

    def init(self, sample_item: dict) -> ReplayState:
        """``sample_item``: tensors shaped like ONE transition (no batch axis), on the
        buffer's device; storage dtypes are taken from them."""
        data = {k: torch.zeros((self.capacity,) + tuple(x.shape), dtype=x.dtype, device=x.device)
                for k, x in sample_item.items()}
        return ReplayState(data=data)

    def ring_slices(self, ptr: int, b: int):
        """The ring slots ``(ptr + arange(b)) % capacity`` as at most two (buffer slice,
        batch slice) pairs."""
        if not 0 < b <= self.capacity:
            raise ValueError(f"a batch of {b} does not fit a ring of {self.capacity}")
        first = min(b, self.capacity - ptr)
        out = [(slice(ptr, ptr + first), slice(0, first))]
        if first < b:
            out.append((slice(0, b - first), slice(first, b)))
        return out

    def add_batch(self, state: ReplayState, batch: dict) -> ReplayState:
        """Write B transitions (leading batch axis) at the ring cursor, in place."""
        b = next(iter(batch.values())).shape[0]
        for dst, src in self.ring_slices(state.ptr, b):
            for k, buf in state.data.items():
                buf[dst] = batch[k][src]
        return replace(state, ptr=(state.ptr + b) % self.capacity,
                       size=min(state.size + b, self.capacity))

    def sample(self, state: ReplayState, draws, batch_size: int):
        """Uniform with replacement over the filled region; returns (batch, idx)."""
        idx = draws.randint(0, max(state.size, 1), (batch_size,)).to(torch.int64)
        return {k: take_rows(buf, idx) for k, buf in state.data.items()}, idx

    def can_sample(self, state: ReplayState, n: int) -> bool:
        return state.size >= n
