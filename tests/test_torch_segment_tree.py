"""The port's segment trees (baselines_tpu_torch/data/segment_tree.py) on the CPU against
the JAX package's (baselines_tpu/data/segment_tree.py): the five cases of
tests/test_segment_tree.py on both, and batched point sets and prefix-sum searches at
4096 leaves. The trees are equal bit for bit (each node is its children's f32 sum or
min, taken alike), and so are the searches and the minima; a range sum over the leaves
sums them in another order, to 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines_tpu.data import segment_tree as jax_st
from baselines_tpu_torch.data import segment_tree as st


def _set(m, tree, state, idx, vals):
    if m is jax_st:
        return tree.set(state, jnp.asarray(idx), jnp.asarray(vals, jnp.float32))
    return tree.set(state, torch.as_tensor(idx), torch.as_tensor(vals, dtype=torch.float32))


def _init(m, tree):
    return tree.init() if m is jax_st else tree.init("cpu")


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _case_tree_set(m):
    tree = m.SumSegmentTree(4)
    s = _set(m, tree, _init(m, tree), [2, 3], [1.0, 3.0])
    return [tree.reduce_all(s), tree.reduce(s, 0, 2), tree.reduce(s, 2, 3), tree.reduce(s, 2, 4),
            s.tree]


def _case_tree_set_overlap(m):
    tree = m.SumSegmentTree(4)
    s = _set(m, tree, _init(m, tree), [2], [1.0])
    s = _set(m, tree, s, [2], [3.0])
    return [tree.reduce_all(s), tree.reduce(s, 2, 4), s.tree]


def _case_prefixsum_idx(m):
    tree = m.SumSegmentTree(4)
    s = _set(m, tree, _init(m, tree), [2, 3], [1.0, 3.0])
    q = [0.0, 0.5, 0.99, 1.01, 3.0, 4.0]
    return [tree.find_prefixsum_idx(s, jnp.asarray(q) if m is jax_st else torch.tensor(q))]


def _case_prefixsum_idx2(m):
    tree = m.SumSegmentTree(4)
    s = _set(m, tree, _init(m, tree), [0, 1, 2, 3], [0.5, 1.0, 1.0, 3.0])
    q = [0.0, 0.55, 0.99, 1.51, 3.0, 5.5]
    return [tree.find_prefixsum_idx(s, jnp.asarray(q) if m is jax_st else torch.tensor(q))]


def _case_max_interval_tree(m):
    tree = m.MinSegmentTree(4)
    s = _set(m, tree, _init(m, tree), [0, 2, 3], [1.0, 0.5, 3.0])
    out = [tree.reduce_all(s), tree.reduce(s, 0, 2), tree.reduce(s, 2, 4), tree.reduce(s, 2, 3)]
    s = _set(m, tree, s, [2], [0.7])
    return out + [tree.reduce_all(s), s.tree]


CASES = {"tree_set": (_case_tree_set, [4.0, 0.0, 1.0, 4.0]),
         "tree_set_overlap": (_case_tree_set_overlap, [3.0, 3.0]),
         "prefixsum_idx": (_case_prefixsum_idx, [[2, 2, 2, 3, 3, 3]]),
         "prefixsum_idx2": (_case_prefixsum_idx2, [[0, 1, 1, 2, 3, 3]]),
         "max_interval_tree": (_case_max_interval_tree, [0.5, 1.0, 0.5, 0.5, 0.7])}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_case_matches_jax(name):
    """The case's values on the port's tree equal the JAX tree's, and the reference
    test's expected values."""
    case, expected = CASES[name]
    ours, theirs = case(st), case(jax_st)
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(_np(got), _np(want))
    for got, want in zip(ours, expected):
        np.testing.assert_array_equal(_np(got), np.asarray(want, _np(got).dtype))


@pytest.mark.parametrize("kind", ["sum", "min"])
def test_batched_sets_and_searches_match_jax(kind):
    """Three batches of 512 point sets (repeated indices within a batch excluded, as
    neither side orders them) on 4096 leaves, then 16 range reductions and, for the sum
    tree, 2048 prefix-sum searches over the whole mass: the trees bit for bit, the
    searches and minima exactly, the range sums to 1e-6."""
    cap = 4096
    rng = np.random.RandomState(0 if kind == "sum" else 1)
    ours = st.SumSegmentTree(cap) if kind == "sum" else st.MinSegmentTree(cap)
    theirs = jax_st.SumSegmentTree(cap) if kind == "sum" else jax_st.MinSegmentTree(cap)
    s, js = ours.init("cpu"), theirs.init()
    for _ in range(3):
        idx = rng.choice(cap, 512, replace=False)
        vals = rng.uniform(0.0, 10.0, 512).astype(np.float32)
        s, js = _set(st, ours, s, idx, vals), _set(jax_st, theirs, js, idx, vals)
        np.testing.assert_array_equal(s.tree.numpy(), np.asarray(js.tree))
    for start in rng.randint(0, cap - 1, 16):
        end = int(rng.randint(start + 1, cap + 1))
        got = float(ours.reduce(s, int(start), end))
        want = float(theirs.reduce(js, int(start), end))
        if kind == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            assert got == want
    if kind == "sum":
        q = rng.uniform(0.0, float(ours.reduce_all(s)), 2048).astype(np.float32)
        got = ours.find_prefixsum_idx(s, torch.from_numpy(q))
        want = theirs.find_prefixsum_idx(js, jnp.asarray(q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.min() >= 0 and got.max() < cap


def test_capacity_must_be_a_power_of_two():
    for cap in (0, 3, 12):
        with pytest.raises(ValueError, match="power of 2"):
            st.SumSegmentTree(cap)
