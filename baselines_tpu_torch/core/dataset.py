"""Shuffled minibatches over host arrays (counterpart of baselines_tpu/core/dataset.py,
after baselines/common/dataset.py:1-60).

The arrays are never permuted in place: each epoch takes an index permutation from the
dataset's own ``numpy.random.Generator``, so the caller's arrays stay as they are and a
``seed`` (or ``rng``) makes the shuffle reproducible.
"""

from __future__ import annotations

import numpy as np


class Dataset:
    """Minibatches of a dict of equally long arrays: ``iterate_once(batch_size)`` gives
    one epoch's whole batches; ``next_batch(batch_size)`` takes the next rows and
    reshuffles when the epoch is used up (dataset.py:1-40)."""

    def __init__(self, data_map, deterministic=False, shuffle=True, seed=None):
        self.data_map = dict(data_map)
        self.deterministic = deterministic
        self.enable_shuffle = shuffle
        sizes = {k: v.shape[0] for k, v in self.data_map.items()}
        assert len(set(sizes.values())) == 1, f"ragged arrays: {sizes}"
        self.n = next(iter(sizes.values()))
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(self.n)
        self._cursor = 0
        if self.enable_shuffle:
            self.shuffle()

    def shuffle(self):
        if not self.deterministic:
            self._order = self._rng.permutation(self.n)
        self._cursor = 0

    def next_batch(self, batch_size):
        if self._cursor >= self.n and self.enable_shuffle:
            self.shuffle()
        take = self._order[self._cursor:self._cursor + batch_size]
        self._cursor += len(take)
        return {k: v[take] for k, v in self.data_map.items()}

    def iterate_once(self, batch_size):
        if self.enable_shuffle:
            self.shuffle()
        while self.n - self._cursor >= batch_size:
            yield self.next_batch(batch_size)
        self._cursor = 0

    def subset(self, num_elements, deterministic=True):
        """The first ``num_elements`` rows as a new Dataset (dataset.py:33-39)."""
        return Dataset({k: v[:num_elements] for k, v in self.data_map.items()},
                       deterministic=deterministic)


def iterbatches(arrays, *, num_batches=None, batch_size=None, shuffle=True,
                include_final_partial_batch=True, rng=None):
    """One epoch of aligned minibatches of ``arrays``, as tuples (dataset.py:41-60),
    shuffled by ``rng`` (a fresh generator when None)."""
    if (num_batches is None) == (batch_size is None):
        raise ValueError("specify exactly one of num_batches / batch_size")
    arrays = tuple(np.asarray(a) for a in arrays)
    n = arrays[0].shape[0]
    assert all(a.shape[0] == n for a in arrays)
    order = (rng or np.random.default_rng()).permutation(n) if shuffle else np.arange(n)
    if batch_size is not None:
        starts = range(0, n, batch_size)
    else:
        edges = np.linspace(0, n, num_batches + 1).astype(int)
        starts, ends = edges[:-1], edges[1:]
    for i, s in enumerate(starts):
        e = min(s + batch_size, n) if batch_size is not None else ends[i]
        if batch_size is None or include_final_partial_batch or e - s == batch_size:
            take = order[s:e]
            yield tuple(a[take] for a in arrays)
