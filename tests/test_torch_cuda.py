"""The port's CUDA kernels against their plain versions, on the card, at shapes that
reach every path of each kernel (batch tails, every split of the dense stage's depth,
every copy width of the gather). Without a card these tests skip. On a machine with the card, where JAX is
not installed, run them without the suite's conftest.py, which sets JAX up:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports nothing of JAX or of baselines_tpu."""

import pytest
import torch

from baselines_tpu_torch.nn.networks import NatureCNNS2D
from baselines_tpu_torch.ops.fused_cnn import fused_cnn_forward, pack_params, reference_forward
from baselines_tpu_torch.ops.gather import take_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("batch", [1, 3, 63, 64, 65, 256, 600, 1029, 8192])
def test_fused_cnn_kernel_matches_plain(dev, batch):
    """Relative error < 2e-2 (bf16 activations, sums in another order) at batches that
    end in a partial 64-sample tile and that split the dense stage's depth 8 (up to 512
    samples), 4 (600), 2 (1029) ways or not at all (8192); the same bits from a second
    call (the split sums in a fixed order)."""
    gen = torch.Generator(device=dev).manual_seed(batch)
    x = torch.randint(0, 256, (batch, 21, 21, 64), dtype=torch.uint8, device=dev, generator=gen)
    net = NatureCNNS2D(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).to(dev)
    packed = pack_params(net)
    before = fused_cnn_forward.launches
    got = fused_cnn_forward(x, packed)
    want = reference_forward(x, packed)
    torch.cuda.synchronize()
    assert fused_cnn_forward.launches == before + 1
    assert got.shape == (batch, 512) and bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 2e-2, rel
    assert torch.equal(fused_cnn_forward(x, packed), got)
    with torch.no_grad():
        module = net(x)
    assert float((got - module).abs().max() / module.abs().max()) < 2e-2


@pytest.mark.parametrize("m", [1, 7, 256, 32768])
@pytest.mark.parametrize("shape,dtype", [
    ((300, 21, 21, 64), torch.uint8),  # wide rows of 16-byte units
    ((300, 21, 21, 63), torch.uint8),  # wide rows that are not a multiple of 16 bytes
    ((300,), torch.float32),  # 4-byte units
    ((300, 2), torch.float32),  # 8-byte units
    ((300,), torch.int64),  # 8-byte units
    ((300, 3), torch.int16),  # 2-byte units
    ((300, 7), torch.uint8),  # single bytes
    ((300,), torch.bool),  # single bytes
], ids=["u8_obs", "u8_ragged", "f32", "f32x2", "i64", "i16x3", "u8x7", "bool"])
def test_take_rows_kernel_matches_x_idx(dev, shape, dtype, m):
    """Bit for bit, with duplicate indices, from 1 row to the epoch shuffle's 32768."""
    gen = torch.Generator(device=dev).manual_seed(m)
    x = torch.randint(-100, 100, shape, device=dev, generator=gen).to(dtype)
    idx = torch.randint(0, shape[0], (m,), device=dev, generator=gen)
    got = take_rows(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, x[idx])


def test_take_rows_kernel_on_unaligned_rows(dev):
    """A view that starts one byte in falls back to narrower units and stays exact."""
    base = torch.randint(0, 256, (65 * 64 + 1,), dtype=torch.uint8, device=dev)
    x = base[1:].view(65, 64)
    idx = torch.arange(64, -1, -1, device=dev)
    assert torch.equal(take_rows(x, idx), x[idx])


@pytest.mark.parametrize("shape", [(4, 5), (4, 21, 21, 64)])
def test_take_rows_kernel_zeroes_rows_of_out_of_range_indices(dev, shape):
    x = torch.ones(shape, device=dev)
    idx = torch.tensor([0, 4, -1, 3], device=dev)
    got = take_rows(x, idx)
    row = float(x[0].numel())
    assert torch.equal(got.reshape(4, -1).sum(dim=1).cpu(), torch.tensor([row, 0.0, 0.0, row]))


def _integer_priorities(gen, n, dev, block_total=4096):
    """Integer priorities with runs of zeros and equal block sums (see
    tests/test_torch_sampler.py): every sum is exact."""
    p = torch.randint(0, 4, (n // 2048, 2048), generator=gen, device=dev).float()
    p[:, 100:300] = 0.0
    p[:, -1] = 0.0
    p[:, -1] = block_total - p.sum(dim=1)
    return p.reshape(-1).contiguous()


@pytest.mark.parametrize("n,batch", [
    (2 ** 20, 32), (2 ** 20, 256), (10240, 256),  # the shapes of chip_smoke.py
    (2048, 64),  # one block
    (6144, 45),  # a batch that is not a multiple of 32, nor of the 8 targets of a block
])
def test_stratified_sample_kernel_matches_plain(dev, n, batch):
    """Bit for bit on integer priorities, with zero uniforms (targets on block and slot
    boundaries) and random ones, block sums included; within 2 slots, under 5 %
    differing, on |randn|. One launch a call."""
    from baselines_tpu_torch.ops import stratified_sample as ss

    gen = torch.Generator(device=dev).manual_seed(n + batch)
    ints = _integer_priorities(gen, n, dev)
    before = ss.stratified_sample.launches
    for u in (torch.zeros(batch, device=dev), torch.rand(batch, generator=gen, device=dev)):
        got, sums = ss.stratified_sample(ints, u, batch, return_block_sums=True)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (batch,)
        assert torch.equal(sums, ss.plain_block_sums(ints))
        assert torch.equal(got, ss.plain_stratified_sample(ints, u, batch))
    assert ss.stratified_sample.launches == before + 2
    prios = torch.randn(n, generator=gen, device=dev).abs()
    u = torch.rand(batch, generator=gen, device=dev)
    got = ss.stratified_sample(prios, u, batch).long()
    want = ss.plain_stratified_sample(prios, u, batch).long()
    assert int((got - want).abs().max()) <= 2
    assert float((got != want).float().mean()) < 0.05


@pytest.mark.parametrize("batch", [1, 31, 256, 257, 1024])
@pytest.mark.parametrize("nblocks", [1, 5, 8, 9, 16, 17, 512])
def test_stratified_sample_kernel_cluster_and_target_edges(dev, nblocks, batch):
    """Bit for bit on integer priorities (zero and random uniforms, block sums included)
    where the cluster's share of the blocks changes (fewer blocks than a cluster's 8, 8, 9,
    16, 17, and a million slots streamed from device memory) and where the targets fill
    part of a warp, one warp, more than one and several in turn; within 2 slots on
    |randn|."""
    from baselines_tpu_torch.ops import stratified_sample as ss

    n = nblocks * 2048
    gen = torch.Generator(device=dev).manual_seed(nblocks * 10007 + batch)
    ints = _integer_priorities(gen, n, dev)
    for u in (torch.zeros(batch, device=dev), torch.rand(batch, generator=gen, device=dev)):
        got, sums = ss.stratified_sample(ints, u, batch, return_block_sums=True)
        torch.cuda.synchronize()
        assert torch.equal(sums, ss.plain_block_sums(ints))
        assert torch.equal(got, ss.plain_stratified_sample(ints, u, batch))
    prios = torch.randn(n, generator=gen, device=dev).abs()
    u = torch.rand(batch, generator=gen, device=dev)
    got = ss.stratified_sample(prios, u, batch).long()
    want = ss.plain_stratified_sample(prios, u, batch).long()
    assert int((got - want).abs().max()) <= 2
    assert int((got != want).sum()) <= 0.05 * batch


def test_stratified_sample_kernel_names_its_shared_memory_limit(dev):
    from baselines_tpu_torch.ops import stratified_sample as ss

    prios = torch.zeros((ss.MAX_BLOCKS + 1) * 2048, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ss.stratified_sample(prios, torch.zeros(8, device=dev), 8)


def test_prioritized_buffer_samples_through_the_kernel(dev):
    """One whole PrioritizedReplayBuffer.sample on the card, with a capacity padded to
    10240 slots: the kernel's indices equal the plain version's on
    the same (integer) priorities, the batch is the rows at those indices and the
    weights are finite and at most 1."""
    from baselines_tpu_torch.data.prioritized import PrioritizedReplayBuffer
    from baselines_tpu_torch.ops import stratified_sample as ss

    class Uniforms:
        def __init__(self, u):
            self.u = u

        def uniform(self, shape, low, high):
            return self.u

    cap, batch = 10000, 256
    rb = PrioritizedReplayBuffer(cap, alpha=1.0)
    item = {"obs": torch.zeros((21, 21, 64), dtype=torch.uint8, device=dev),
            "reward": torch.zeros((), device=dev)}
    state = rb.init(item)
    assert state.priorities.shape == (10240,)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        b = 4000
        state = rb.add_batch(state, {
            "obs": torch.randint(0, 256, (b, 21, 21, 64), dtype=torch.uint8, device=dev,
                                 generator=gen),
            "reward": torch.randn(b, generator=gen, device=dev)})
    assert state.buffer.size == cap and state.buffer.ptr == 2000
    new = torch.randint(1, 5, (cap,), generator=gen, device=dev).float()
    state = rb.update_priorities(state, torch.arange(cap, device=dev), new)
    u = torch.rand(batch, generator=gen, device=dev)
    before = ss.stratified_sample.launches
    got, idx, weights = rb.sample(state, Uniforms(u), batch, beta=0.4)
    torch.cuda.synchronize()
    assert ss.stratified_sample.launches == before + 1
    want = ss.plain_stratified_sample(state.priorities, u, batch).long().clamp(max=cap - 1)
    assert torch.equal(idx, want)
    assert torch.equal(got["obs"], state.buffer.data["obs"][idx])
    assert torch.equal(got["reward"], state.buffer.data["reward"][idx])
    assert bool(torch.isfinite(weights).all()) and float(weights.max()) <= 1.0
