"""The port's replay buffers (data/replay.py, data/prioritized.py) against the JAX
package's, on the CPU, from the same transitions and the same draws: the JAX draws are
handed to the port through torch_parity.ReplayDraws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ReplayDraws, rel_err

from baselines_tpu.data.pallas_sampler import pallas_stratified_sample
from baselines_tpu.data.prioritized import PrioritizedReplayBuffer as JaxPrioritized
from baselines_tpu.data.replay import ReplayBuffer as JaxReplay
from baselines_tpu_torch.data.prioritized import PrioritizedReplayBuffer
from baselines_tpu_torch.data.replay import ReplayBuffer


def _item():
    return {"obs": np.zeros((3, 2), np.uint8), "act": np.zeros((), np.int32),
            "rew": np.zeros((), np.float32)}


def _batches(rng, sizes):
    return [{"obs": rng.randint(0, 256, (b, 3, 2)).astype(np.uint8),
             "act": rng.randint(0, 6, (b,)).astype(np.int32),
             "rew": rng.randn(b).astype(np.float32)} for b in sizes]


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_same_data(tdata, jdata):
    assert set(tdata) == set(jdata)
    for k in jdata:
        np.testing.assert_array_equal(tdata[k].numpy(), np.asarray(jdata[k]), err_msg=k)


@pytest.mark.parametrize("sizes", [(5, 5, 5), (8, 3, 7, 1)], ids=["wrap", "ragged"])
def test_replay_ring_matches_jax(sizes):
    """ptr, size and every slot bit for bit as the ring wraps, with batches that reach
    the end of the ring and batches of the whole capacity."""
    rng = np.random.RandomState(0)
    jrb, trb = JaxReplay(8), ReplayBuffer(8)
    jstate, tstate = jrb.init(_jax(_item())), trb.init(_torch(_item()))
    for batch in _batches(rng, sizes):
        jstate = jrb.add_batch(jstate, _jax(batch))
        tstate = trb.add_batch(tstate, _torch(batch))
        assert (tstate.ptr, tstate.size) == (int(jstate.ptr), int(jstate.size))
        _assert_same_data(tstate.data, jstate.data)
    assert trb.can_sample(tstate, 8) and not trb.can_sample(tstate, 9)


def test_replay_sample_matches_jax():
    """The same draws give the same indices and rows."""
    rng = np.random.RandomState(1)
    jrb, trb = JaxReplay(16), ReplayBuffer(16)
    jstate, tstate = jrb.init(_jax(_item())), trb.init(_torch(_item()))
    for batch in _batches(rng, (6, 5)):
        jstate = jrb.add_batch(jstate, _jax(batch))
        tstate = trb.add_batch(tstate, _torch(batch))
    key = jax.random.PRNGKey(3)
    jbatch, jidx = jrb.sample(jstate, key, 32)
    draws = ReplayDraws()
    draws.push("randint", jax.random.randint(key, (32,), 0, jnp.maximum(jstate.size, 1)))
    tbatch, tidx = trb.sample(tstate, draws, 32)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _assert_same_data(tbatch, jbatch)
    with pytest.raises(ValueError):
        trb.add_batch(tstate, _torch(_batches(rng, (17,))[0]))  # more than the ring holds


@pytest.mark.parametrize("capacity", [64, 2048], ids=["padded", "whole_blocks"])
def test_prioritized_add_and_update_match_jax(capacity):
    """New slots get max_priority^alpha and updates apply alpha and the running max, to
    1e-6 relative (f32 powers computed by two libraries); the vector is padded with
    zeros to a multiple of 2048 slots."""
    rng = np.random.RandomState(2)
    jrb, trb = JaxPrioritized(capacity, alpha=0.6), PrioritizedReplayBuffer(capacity, alpha=0.6)
    jstate, tstate = jrb.init(_jax(_item())), trb.init(_torch(_item()))
    assert tstate.priorities.shape == (2048,)
    for step, batch in enumerate(_batches(rng, (24, 24, 24))):
        jstate = jrb.add_batch(jstate, _jax(batch))
        tstate = trb.add_batch(tstate, _torch(batch))
        idx = rng.randint(0, min(capacity, 24 * (step + 1)), 10)
        prios = (np.abs(rng.randn(10)) * (step + 1)).astype(np.float32) + 1e-6
        jstate = jrb.update_priorities(jstate, jnp.asarray(idx), jnp.asarray(prios))
        tstate = trb.update_priorities(tstate, torch.from_numpy(idx), torch.from_numpy(prios))
        want = np.asarray(jstate.priorities)
        assert rel_err(tstate.priorities[:capacity], want) < 1e-6
        assert rel_err(tstate.max_priority, jstate.max_priority) < 1e-6
        assert (tstate.buffer.ptr, tstate.buffer.size) == (int(jstate.buffer.ptr),
                                                           int(jstate.buffer.size))
        _assert_same_data(tstate.buffer.data, jstate.buffer.data)
    assert float(tstate.max_priority) > 1.0
    assert not tstate.priorities[capacity:].any()


def _filled(rng):
    """Both buffers with 40 of 64 slots filled and integer priorities (zeros included)
    set with alpha = 1, so every sum is exact."""
    jrb = JaxPrioritized(64, alpha=1.0)
    trb = PrioritizedReplayBuffer(64, alpha=1.0)
    jstate, tstate = jrb.init(_jax(_item())), trb.init(_torch(_item()))
    for batch in _batches(rng, (20, 20)):
        jstate = jrb.add_batch(jstate, _jax(batch))
        tstate = trb.add_batch(tstate, _torch(batch))
    prios = rng.randint(0, 5, 40).astype(np.float32)
    prios[:3] = 0.0
    idx = np.arange(40)
    jstate = jrb.update_priorities(jstate, jnp.asarray(idx), jnp.asarray(prios))
    tstate = trb.update_priorities(tstate, torch.from_numpy(idx), torch.from_numpy(prios))
    return jrb, jstate, trb, tstate


def _jax_kernel_route(jstate, u, batch_size, beta, capacity):
    """prioritized.py:75-91 with use_pallas=True, the Pallas kernel in interpret mode on
    the priorities zero-padded to the 16384 slots it takes."""
    prios = jstate.priorities
    padded = jnp.concatenate([prios, jnp.zeros((16384 - capacity,), jnp.float32)])
    idx = pallas_stratified_sample(padded, u, batch_size, interpret=True)
    total = jnp.sum(prios)
    idx = jnp.clip(idx, 0, capacity - 1)
    batch = jax.tree_util.tree_map(lambda buf: buf[idx], jstate.buffer.data)
    n = jnp.maximum(jstate.buffer.size, 1).astype(jnp.float32)
    probs = prios / jnp.maximum(total, 1e-12)
    min_prob = jnp.min(jnp.where(prios > 0, probs, jnp.inf))
    max_weight = (min_prob * n) ** (-beta)
    weights = (probs[idx] * n) ** (-beta) / jnp.maximum(max_weight, 1e-12)
    return batch, idx, weights


def _on_boundary(jstate, u, batch_size):
    """Whether each stratified target equals a prefix sum of the priorities."""
    cum = jnp.cumsum(jstate.priorities)
    targets = (jnp.arange(batch_size) + u) / batch_size * cum[-1]
    return np.asarray(jnp.isin(targets, cum))


@pytest.mark.parametrize("reference", ["pallas_route", "jax_sample"])
def test_prioritized_sample_matches_jax(reference):
    """Integer priorities, alpha 1 and zero-priority slots: the indices bit for bit, the
    rows bit for bit, the weights to 1e-6 relative. Held against the JAX package's
    ``use_pallas=True`` composition on the Pallas kernel, with random uniforms and with
    zero ones, which put some targets on slot boundaries; and against JAX's ``sample``
    (its cumsum + searchsorted route) with random uniforms, whose targets all lie off
    the boundaries, where the two tie-breaks agree."""
    rng = np.random.RandomState(4)
    jrb, jstate, trb, tstate = _filled(rng)
    seeds = (0, 1, 2, None) if reference == "pallas_route" else (0, 1, 2)
    for seed in seeds:
        key = jax.random.PRNGKey(0 if seed is None else seed)
        beta = np.float32(0.4 + 0.3 * (seed or 0))
        u = jnp.zeros((16,)) if seed is None else jax.random.uniform(key, (16,))
        if reference == "pallas_route":
            assert _on_boundary(jstate, u, 16).any() == (seed is None)
            jbatch, jidx, jw = _jax_kernel_route(jstate, u, 16, beta, 64)
        else:
            assert not _on_boundary(jstate, u, 16).any()
            jbatch, jidx, jw = jrb.sample(jstate, key, 16, beta)
        draws = ReplayDraws()
        draws.push("uniform", u)
        tbatch, tidx, tw = trb.sample(tstate, draws, 16, float(beta))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        _assert_same_data(tbatch, jbatch)
        assert tw.dtype == torch.float32 and rel_err(tw, jw) < 1e-6
        assert (np.asarray(tstate.priorities[tidx]) > 0).all()


def test_prioritized_tie_break_differs_from_jax_sample():
    """On a target that lands exactly on a prefix boundary, JAX's ``sample`` takes the
    slot whose prefix reaches it (searchsorted left) and the port's kernel the next
    slot with mass (right), as the Pallas kernel does; elsewhere they agree."""
    rng = np.random.RandomState(5)
    jrb, jstate, trb, tstate = _filled(rng)
    u = np.zeros(16, np.float32)
    draws = ReplayDraws()
    draws.push("uniform", u)
    _, ti, _ = trb.sample(tstate, draws, 16, 0.4)
    prios = np.asarray(jstate.priorities).astype(np.float64)
    cum = np.cumsum(prios)
    targets = np.arange(16) / 16 * cum[-1]
    on_boundary = np.isin(targets, cum)
    assert on_boundary.any() and not on_boundary.all()
    np.testing.assert_array_equal(ti.numpy(), np.searchsorted(cum, targets, side="right"))
    # JAX's sample with zero uniforms: jax.random.uniform cannot be made to give zeros,
    # so its route is composed here as prioritized.py:80-86 computes it
    jcum = jnp.cumsum(jstate.priorities)
    jidx = np.asarray(jnp.clip(jnp.searchsorted(jcum, jnp.asarray(targets, jnp.float32),
                                                side="left"), 0, 63))
    np.testing.assert_array_equal(jidx, np.searchsorted(cum, targets, side="left"))
    np.testing.assert_array_equal(ti.numpy()[~on_boundary], jidx[~on_boundary])
    assert (ti.numpy()[on_boundary] != jidx[on_boundary]).any()
