"""The port's CUDA kernels against their plain versions, on the card, at shapes that
reach every path of each kernel (batch tails, the two sample-per-block counts, every
copy width). Without a card these tests skip. On a machine with the card, where JAX is
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


@pytest.mark.parametrize("batch", [1, 3, 256, 1029])
def test_fused_cnn_kernel_matches_plain(dev, batch):
    """Relative error < 2e-2 (bf16 activations, sums in another order) at batches that
    end in a partial block, for both sample-per-block counts (below and above 1024)."""
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
    with torch.no_grad():
        module = net(x)
    assert float((got - module).abs().max() / module.abs().max()) < 2e-2


@pytest.mark.parametrize("shape,dtype", [
    ((300, 21, 21, 64), torch.uint8),  # 16-byte units
    ((300,), torch.float32),  # 4-byte units
    ((300, 2), torch.float32),  # 8-byte units
    ((300, 3), torch.int16),  # 2-byte units
    ((300, 7), torch.uint8),  # single bytes
])
def test_take_rows_kernel_matches_x_idx(dev, shape, dtype):
    """Bit for bit, with duplicate indices."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-100, 100, shape, device=dev, generator=gen).to(dtype)
    idx = torch.randint(0, shape[0], (517,), device=dev, generator=gen)
    got = take_rows(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, x[idx])


def test_take_rows_kernel_on_unaligned_rows(dev):
    """A view that starts one byte in falls back to narrower units and stays exact."""
    base = torch.randint(0, 256, (65 * 64 + 1,), dtype=torch.uint8, device=dev)
    x = base[1:].view(65, 64)
    idx = torch.arange(64, -1, -1, device=dev)
    assert torch.equal(take_rows(x, idx), x[idx])


def test_take_rows_kernel_zeroes_rows_of_out_of_range_indices(dev):
    x = torch.ones((4, 5), device=dev)
    got = take_rows(x, torch.tensor([0, 4, -1, 3], device=dev))
    assert torch.equal(got.sum(dim=1).cpu(), torch.tensor([5.0, 0.0, 0.0, 5.0]))
