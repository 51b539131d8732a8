"""Segment trees as tensors (counterpart of baselines_tpu/data/segment_tree.py, after
baselines/common/segment_tree.py:4-145): ``SumSegmentTree`` and ``MinSegmentTree`` over
a power-of-two number of leaves, stored as one (2 * capacity,) f32 tensor with the
root at 1 and the leaves at [capacity, 2 * capacity).

The reference walks the tree item by item in Python; here a batch of point sets
rebuilds the tree level by level (one op a level, over every node of the level, so each
node is the sum or min of its two children in the order the JAX package takes them),
and a batch of prefix-sum searches descends one level a step for every query at once.
The tensors stay on the device the state was made on. deepq's prioritized replay does
not use the tree (``data/prioritized.py`` keeps a dense priority vector); it serves
callers that want range sums or minima.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from baselines_tpu_torch.core.device import resolve_device


@dataclass
class SegmentTreeState:
    tree: torch.Tensor  # (2 * capacity,) f32, the leaves at [capacity, 2 * capacity)


class SegmentTree:
    def __init__(self, capacity: int, operation: str):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be positive and a power of 2, got {capacity}")
        if operation not in ("sum", "min"):
            raise ValueError(f"operation must be 'sum' or 'min', got {operation!r}")
        self.capacity = capacity
        self.operation = operation
        self._op = torch.add if operation == "sum" else torch.minimum
        self._neutral = 0.0 if operation == "sum" else float("inf")
        self.levels = capacity.bit_length()  # log2(capacity) + 1

    def init(self, device=None) -> SegmentTreeState:
        """Every leaf the operation's neutral value, on ``device`` (the card when
        None)."""
        return SegmentTreeState(tree=torch.full((2 * self.capacity,), self._neutral,
                                                dtype=torch.float32,
                                                device=resolve_device(device)))

    def set(self, state: SegmentTreeState, idx, vals) -> SegmentTreeState:
        """The leaves ``idx`` set to ``vals`` and every level above rebuilt, bottom up
        (segment_tree.py:63-77); a new state."""
        tree = state.tree.clone()
        idx = torch.as_tensor(idx, dtype=torch.int64, device=tree.device)
        tree[idx + self.capacity] = torch.as_tensor(vals, dtype=torch.float32,
                                                    device=tree.device)
        size = self.capacity // 2
        while size >= 1:  # nodes [size, 2 size) from their children [2 size, 4 size)
            tree[size:2 * size] = self._op(tree[2 * size:4 * size:2],
                                           tree[2 * size + 1:4 * size:2])
            size //= 2
        return SegmentTreeState(tree=tree)

    def get(self, state: SegmentTreeState, idx) -> torch.Tensor:
        idx = torch.as_tensor(idx, dtype=torch.int64, device=state.tree.device)
        return state.tree[idx + self.capacity]

    def reduce_all(self, state: SegmentTreeState) -> torch.Tensor:
        return state.tree[1]

    def reduce(self, state: SegmentTreeState, start: int, end: int) -> torch.Tensor:
        """The sum or min of the leaves [start, end) (segment_tree.py:37-61)."""
        leaves = state.tree[self.capacity + start:self.capacity + end]
        return leaves.sum() if self.operation == "sum" else leaves.min()


class SumSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, "sum")

    def find_prefixsum_idx(self, state: SegmentTreeState, prefixsum) -> torch.Tensor:
        """For each query, the largest leaf index i with sum(leaves[:i]) <= prefixsum
        (segment_tree.py:97-123): one descent of log2(capacity) steps for the whole
        batch, going left only where the left subtree holds more than the rest of the
        query."""
        tree = state.tree
        remaining = torch.as_tensor(prefixsum, dtype=torch.float32, device=tree.device)
        node = torch.ones(remaining.shape, dtype=torch.int64, device=tree.device)
        for _ in range(self.levels - 1):
            left = 2 * node
            left_val = tree[left]
            go_right = left_val <= remaining
            node = torch.where(go_right, left + 1, left)
            remaining = torch.where(go_right, remaining - left_val, remaining)
        return node - self.capacity


class MinSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, "min")
