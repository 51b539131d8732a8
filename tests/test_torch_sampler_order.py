"""The summation order of the port's one-launch stratified sampler
(baselines_tpu_torch/csrc/stratified_sample.cu), emulated step by step in numpy, against
the plain version (ops/stratified_sample.py) and the Pallas kernels it replaces
(baselines_tpu/data/pallas_sampler.py, in interpret mode).

The kernel associates its f64 sums otherwise than the plain version: a warp a block of
priorities (lane-strided 16-byte chunks, then a butterfly), the block prefix in runs of
a lane with a warp scan of the run totals, and in the search lane-owned chunks of 64
slots (4 chains of 16, a warp scan of the lane totals, then 4 walks that count the
prefixes). This file shows on the CPU that the new association keeps the
results: bit for bit on integer priorities, within the tolerance of
tests/test_pallas_sampler.py on random ones. The card holds the kernel itself against
the plain version (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines_tpu.data.pallas_sampler import BLOCK, ROWS_PER_TILE, pallas_stratified_sample
from baselines_tpu_torch.ops import stratified_sample as ss
from torch_parity import integer_priorities

LANES = 32
CHUNKS = BLOCK // 4 // LANES  # 16-byte chunks a lane
NCHAINS, CHAIN = 4, 16  # a lane's 64 slots as 4 chains of 16


def warp_inclusive_scan(v: np.ndarray) -> np.ndarray:
    """The kernel's Hillis-Steele scan over the last axis (32 lanes): at each step lane l
    adds lane l - off, taken before the step."""
    for off in (1, 2, 4, 8, 16):
        up = np.zeros_like(v)
        up[..., off:] = v[..., :-off]
        v = v + up
    return v


def shift_up(v: np.ndarray) -> np.ndarray:
    """__shfl_up_sync by one lane, lane 0 taking 0."""
    out = np.zeros_like(v)
    out[..., 1:] = v[..., :-1]
    return out


def emulate_block_sums(prios: np.ndarray) -> np.ndarray:
    """One warp a block: lane l sums chunks k * 32 + l as (x + y) + (z + w) in f64, in k
    order, then a butterfly over 16, 8, 4, 2, 1 lanes; rounded to f32."""
    chunks = prios.reshape(-1, CHUNKS, LANES, 4).astype(np.float64)
    pairs = (chunks[..., 0] + chunks[..., 1]) + (chunks[..., 2] + chunks[..., 3])
    s = np.zeros((pairs.shape[0], LANES))
    for k in range(CHUNKS):
        s = s + pairs[:, k]
    lanes = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ off]
    return s[:, 0].astype(np.float32)


def emulate_block_prefix(sums: np.ndarray) -> np.ndarray:
    """The prefix every block of a cluster builds from the gathered sums, in one warp:
    lane l takes the run [l * run, (l + 1) * run), a warp scan of the run totals gives
    each run its offset, then each run's f64 prefixes are rounded to f32."""
    n = sums.shape[0]
    run = -(-n // LANES)
    padded = np.zeros(LANES * run)
    padded[:n] = sums
    runs = padded.reshape(LANES, run)
    totals = np.zeros(LANES)
    for j in range(run):
        totals = totals + runs[:, j]
    acc = shift_up(warp_inclusive_scan(totals))
    prefix = np.zeros((LANES, run), np.float32)
    for j in range(run):
        acc = acc + runs[:, j]
        prefix[:, j] = acc
    return prefix.reshape(-1)[:n]


def emulate_stratified_sample(prios: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The whole op as the kernel computes it."""
    batch = u.shape[0]
    nblocks = prios.shape[0] // BLOCK
    prefix = emulate_block_prefix(emulate_block_sums(prios))
    total = prefix[-1]
    t = (np.arange(batch, dtype=np.float32) + u) / np.float32(batch) * total
    blk = np.zeros(batch, np.int64)
    for i in range(batch):  # the kernel's binary search, clamped to the last block
        lo, hi = 0, nblocks - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if prefix[mid] <= t[i]:
                lo = mid + 1
            else:
                hi = mid
        blk[i] = lo
    base = np.where(blk > 0, prefix[np.maximum(blk - 1, 0)], np.float32(0))
    rem = (t - base).astype(np.float64)[:, None]
    vals = prios.reshape(nblocks, LANES, BLOCK // LANES)[blk].astype(np.float64)  # (B, 32, 64)
    chains = []
    for m in range(NCHAINS):
        s = np.zeros((batch, LANES))
        for j in range(CHAIN):
            s = s + vals[:, :, m * CHAIN + j]
        chains.append(s)
    start = shift_up(warp_inclusive_scan((chains[0] + chains[1]) + (chains[2] + chains[3])))
    count = np.zeros(batch, np.int64)
    for m in range(NCHAINS):
        acc = start
        for j in range(CHAIN):
            acc = acc + vals[:, :, m * CHAIN + j]
            count += (acc <= rem).sum(axis=1)
        start = start + chains[m]
    return (blk * BLOCK + np.minimum(count, BLOCK - 1)).astype(np.int32)


def pallas_sample(prios: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The Pallas kernels in interpret mode, on the vector zero-padded to the multiple of
    8 blocks they take."""
    pad = -(prios.shape[0] // BLOCK) % ROWS_PER_TILE * BLOCK
    padded = np.concatenate([prios, np.zeros(pad, np.float32)])
    return np.asarray(pallas_stratified_sample(jnp.asarray(padded), jnp.asarray(u), u.shape[0],
                                               interpret=True))


def plain_sample(prios: np.ndarray, u: np.ndarray) -> np.ndarray:
    return ss.plain_stratified_sample(torch.from_numpy(prios), torch.from_numpy(u),
                                      u.shape[0]).numpy()


@pytest.mark.parametrize("nblocks", [1, 5, 17])
@pytest.mark.parametrize("case", ["integer_boundary_targets", "integer_random", "randn"])
def test_kernel_order_matches_plain_and_pallas(nblocks, case):
    """1, 5 and 17 blocks (one block, deepq's 10240 slots, more blocks than a cluster
    of 8 has), with nblocks * 16 targets: on integer priorities with zero uniforms every
    16th target lands on a block boundary and the others on slot boundaries."""
    rng = np.random.RandomState(nblocks)
    batch = nblocks * 16
    if case == "randn":
        prios = np.abs(rng.randn(nblocks * BLOCK)).astype(np.float32)
    else:
        prios = integer_priorities(rng, nblocks)
    if case == "integer_boundary_targets":
        u = np.zeros(batch, np.float32)
    else:
        u = rng.rand(batch).astype(np.float32)
    got = emulate_stratified_sample(prios, u)
    assert got.dtype == np.int32 and got.shape == (batch,)
    assert got.max() < nblocks * BLOCK
    for want in (plain_sample(prios, u), pallas_sample(prios, u)):
        if case == "randn":
            assert np.abs(got.astype(np.int64) - want).max() <= 2
            assert (got != want).mean() < 0.05
        else:
            np.testing.assert_array_equal(got, want)
    if case == "integer_boundary_targets":  # the f32 targets are exactly i * 256
        targets = np.arange(batch, dtype=np.float32) / np.float32(batch) * np.float32(
            nblocks * 4096)
        np.testing.assert_array_equal(targets, np.arange(batch) * 256.0)
        cum = np.cumsum(prios.astype(np.float64))
        assert np.isin(targets[16::16], cum[BLOCK - 1::BLOCK]).all()
        assert np.isin(targets, cum).sum() >= 3  # on slot boundaries inside blocks
        assert (prios[got] > 0).all()


@pytest.mark.parametrize("nblocks", [1, 5, 17, 300, 600])
def test_kernel_block_sums_and_prefix_match_plain(nblocks):
    """The warp's block sums and the cluster's fixed-order prefix against the plain
    version's f64 sums and sequential f64 cumsum: equal on integer priorities (every sum
    exact), within one f32 ulp on |randn| (f64 sums in two orders, each rounded once to
    f32). 300 and 600 blocks give each lane a run of 10 and 19 sums."""
    rng = np.random.RandomState(nblocks)
    for prios, exact in ((integer_priorities(rng, nblocks), True),
                         (np.abs(rng.randn(nblocks * BLOCK)).astype(np.float32), False)):
        sums = emulate_block_sums(prios)
        want_sums = ss.plain_block_sums(torch.from_numpy(prios)).numpy()
        prefix = emulate_block_prefix(sums)
        want_prefix = torch.cumsum(torch.from_numpy(want_sums).double(), 0).float().numpy()
        if exact:
            np.testing.assert_array_equal(sums, want_sums)
            np.testing.assert_array_equal(prefix, want_prefix)
        else:
            assert (np.abs(sums - want_sums) <= np.spacing(want_sums)).all()
            assert (np.abs(prefix - want_prefix) <= np.spacing(want_prefix)).all()
