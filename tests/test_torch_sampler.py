"""The plain version of the port's stratified sampler (ops/stratified_sample.py) against
the Pallas kernels it replaces (baselines_tpu/data/pallas_sampler.py), run in interpret
mode as tests/test_pallas_sampler.py runs them, and the checks of its wrappers. The
CUDA kernels themselves run only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold them against this plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines_tpu.data.pallas_sampler import BLOCK, pallas_stratified_sample
from baselines_tpu_torch.ops import stratified_sample as ss
from torch_parity import integer_priorities

N = 8 * BLOCK  # the least size the Pallas kernel takes


def jax_sample(prios: np.ndarray, u: np.ndarray) -> np.ndarray:
    return np.asarray(pallas_stratified_sample(jnp.asarray(prios), jnp.asarray(u), u.shape[0],
                                               interpret=True))


def port_sample(prios: np.ndarray, u: np.ndarray) -> np.ndarray:
    return ss.stratified_sample(torch.from_numpy(prios), torch.from_numpy(u), u.shape[0]).numpy()


@pytest.mark.parametrize("zero_uniforms", [True, False], ids=["boundary_targets", "random"])
def test_plain_matches_pallas_interpret_on_integer_priorities(zero_uniforms):
    """Bit for bit: every sum is exact, so no summation order can move a boundary."""
    rng = np.random.RandomState(0)
    prios = integer_priorities(rng, N // BLOCK)
    u = np.zeros(128, np.float32) if zero_uniforms else rng.rand(128).astype(np.float32)
    got = port_sample(prios, u)
    want = jax_sample(prios, u)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if zero_uniforms:  # the targets i * 256 hit block boundaries, and slots the zeros precede
        cum = np.cumsum(prios.astype(np.float64))
        targets = np.arange(128) * 256.0
        assert np.isin(targets[16::16], cum[BLOCK - 1::BLOCK]).all()
        assert np.isin(targets, cum).mean() > 0.3
        assert (prios[got] > 0).all()


def test_plain_matches_pallas_interpret_on_random_priorities():
    """Within 2 slots and under 5 % of the slots differing, the tolerance of
    tests/test_pallas_sampler.py: block-wise sums in another order can move a
    boundary."""
    rng = np.random.RandomState(0)
    prios = np.abs(rng.randn(N)).astype(np.float32)
    u = rng.rand(128).astype(np.float32)
    got = port_sample(prios, u)
    for want in (jax_sample(prios, u), _searchsorted_right(prios, u)):
        assert np.abs(got.astype(np.int64) - want).max() <= 2
        assert (got != want).mean() < 0.05


def _searchsorted_right(prios: np.ndarray, u: np.ndarray) -> np.ndarray:
    cum = jnp.cumsum(jnp.asarray(prios))
    targets = (jnp.arange(u.shape[0]) + jnp.asarray(u)) / u.shape[0] * cum[-1]
    return np.clip(np.asarray(jnp.searchsorted(cum, targets, side="right")), 0, len(prios) - 1)


def test_plain_sampler_distribution():
    """Sampled frequencies follow the priority masses (tests/test_pallas_sampler.py:29-42,
    with numpy's uniforms)."""
    prios = np.full(N, 1e-3, np.float32)
    prios[7] = N * 1e-3  # about half the total mass
    rng = np.random.RandomState(1)
    counts = np.zeros(N)
    for _ in range(20):
        idx = port_sample(prios, rng.rand(256).astype(np.float32))
        counts += np.bincount(idx, minlength=N)
    assert abs(counts[7] / counts.sum() - prios[7] / prios.sum()) < 0.05


@pytest.mark.parametrize("kind", ["integer", "random"])
def test_plain_takes_sizes_the_pallas_kernel_does_not(kind):
    """N = 10240 (5 blocks, not a multiple of the TPU's 16384) against the Pallas kernel
    on the same vector zero-padded to 16384: bit for bit on integer priorities, within
    the tolerance above on random ones."""
    rng = np.random.RandomState(2)
    n = 5 * BLOCK
    if kind == "integer":
        prios = integer_priorities(rng, 5)
    else:
        prios = np.abs(rng.randn(n)).astype(np.float32)
    u = rng.rand(256).astype(np.float32)
    got = port_sample(prios, u)
    want = jax_sample(np.concatenate([prios, np.zeros(N - n, np.float32)]), u)
    assert got.max() < n
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(np.int64) - want).max() <= 2
        assert (got != want).mean() < 0.05


def test_block_sums_and_search_compose():
    """The plain block sums and plain search, composed, are the one wrapper's result, and
    the block sums it returns on request are the plain ones."""
    rng = np.random.RandomState(3)
    prios = torch.from_numpy(integer_priorities(rng, 3))
    sums = ss.plain_block_sums(prios)
    assert sums.tolist() == [4096.0] * 3
    u = torch.from_numpy(rng.rand(40).astype(np.float32))  # not a multiple of 32
    got, got_sums = ss.stratified_sample(prios, u, 40, return_block_sums=True)
    assert torch.equal(ss.plain_search(prios, sums, u, 40), got)
    assert torch.equal(ss.plain_stratified_sample(prios, u, 40), got)
    assert torch.equal(ss.stratified_sample(prios, u, 40), got)
    assert torch.equal(got_sums, sums)


def test_wrappers_reject_what_the_kernels_do_not_take():
    prios = torch.ones(2 * BLOCK)
    u = torch.zeros(8)
    with pytest.raises(ValueError):
        ss.stratified_sample(torch.ones(BLOCK + 1), u, 8)  # not a multiple of 2048
    with pytest.raises(ValueError):
        ss.stratified_sample(prios.double(), u, 8)
    with pytest.raises(ValueError):
        ss.stratified_sample(torch.ones(2, BLOCK), u, 8)
    with pytest.raises(ValueError):
        ss.stratified_sample(torch.ones(4 * BLOCK)[::2], u, 8)
    with pytest.raises(ValueError):
        ss.stratified_sample(prios, u, 9)  # uniforms of another length
    with pytest.raises(ValueError):
        ss.stratified_sample(prios, u.double(), 8)  # uniforms of another type
    with pytest.raises(ValueError):
        ss.stratified_sample(prios.to("meta"), u.to("meta"), 8)  # neither cuda nor cpu
    before = ss.stratified_sample.launches
    ss.stratified_sample(prios, u, 8)
    assert ss.stratified_sample.launches == before  # CPU: no launch
