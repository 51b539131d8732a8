"""The plain versions of the port's two kernels against the Pallas kernels they
replace, run as tests/test_fused_cnn.py and tests/test_gather_ops.py run them (in
interpret mode), and the checks of the kernels' wrappers. The kernels themselves run
only on the card: tests/test_torch_cuda.py and chip_smoke.py hold them against these
plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from baselines_tpu.ops import fused_cnn as jfc
from baselines_tpu.ops.gather import take_rows as jax_take_rows
from baselines_tpu_torch import convert
from baselines_tpu_torch.nn.networks import NatureCNNS2D
from baselines_tpu_torch.ops import fused_cnn
from baselines_tpu_torch.ops.gather import take_rows


@pytest.fixture(scope="module")
def setup():
    """tests/test_fused_cnn.py's inputs: 16 u8 frames and scaled Gaussian weights."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (16, 21, 21, 64)).astype(np.uint8)

    def pr(*shape, s=0.05):
        return rng.randn(*shape).astype(np.float32) * s

    params = (
        pr(2, 2, 64, 32), pr(32), pr(4, 4, 32, 64), pr(64),
        pr(3, 3, 64, 64), pr(64), pr(3136, 512, s=0.01), pr(512),
    )
    net = NatureCNNS2D(dtype=torch.bfloat16)
    tree = {name: {"kernel": params[2 * i], "bias": params[2 * i + 1]}
            for i, name in enumerate(("c1", "c2", "c3", "fc1"))}
    net.load_state_dict(convert.network_state_dict(tree))
    return x, params, fused_cnn.pack_params(net)


def test_fused_cnn_plain_matches_pallas_kernel_and_reference(setup):
    """Relative error < 2e-2 against the Pallas kernel in interpret mode and against
    its XLA reference, the tolerance of tests/test_fused_cnn.py."""
    x, params, packed = setup
    jparams = tuple(jnp.asarray(p) for p in params)
    got = fused_cnn.fused_cnn_forward(torch.from_numpy(x), packed)
    assert got.shape == (16, 512) and got.dtype == torch.float32
    kernel = np.asarray(jfc.fused_cnn_forward(jnp.asarray(x), jparams, interpret=True))
    ref = np.asarray(jfc.reference_forward(jnp.asarray(x), jparams))
    assert rel_err(got, kernel) < 2e-2
    assert rel_err(got, ref) < 2e-2
    assert (ref > 0).mean() > 0.1


def test_fused_cnn_wrapper_rejects_what_the_kernel_does_not_take(setup):
    x, _, packed = setup
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError):
        fused_cnn.fused_cnn_forward(xt.float(), packed)
    with pytest.raises(ValueError):
        fused_cnn.fused_cnn_forward(xt[:, :20], packed)
    with pytest.raises(ValueError):
        fused_cnn.fused_cnn_forward(xt.permute(0, 2, 1, 3), packed)
    with pytest.raises(ValueError):
        fused_cnn.fused_cnn_forward(xt, packed[:7])
    with pytest.raises(ValueError):
        fused_cnn.fused_cnn_forward(xt, (packed[0].float(),) + packed[1:])
    before = fused_cnn.fused_cnn_forward.launches
    fused_cnn.fused_cnn_forward(xt, packed)
    assert fused_cnn.fused_cnn_forward.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("x", [
    np.random.RandomState(2).randint(0, 255, (32, 8192)).astype(np.uint8),
    np.random.RandomState(3).randn(32, 1024).astype(np.float32),  # non-u8 rows
    np.random.RandomState(4).randint(0, 255, (32, 8, 8, 64)).astype(np.uint8),  # rank > 2
], ids=["u8", "f32", "rank4"])
def test_take_rows_plain_matches_pallas_kernel(x):
    """Bit for bit against the Pallas ring-DMA kernel in interpret mode, with duplicate
    indices (rows of 4096 bytes or more, so the Pallas kernel itself runs)."""
    idx = np.random.RandomState(5).randint(0, 32, (32,)).astype(np.int64)
    assert len(np.unique(idx)) < 32
    want = np.asarray(jax_take_rows(jnp.asarray(x), jnp.asarray(idx, jnp.int32), interpret=True))
    got = take_rows(torch.from_numpy(x), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_take_rows_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((8, 3))
    with pytest.raises(ValueError):
        take_rows(x, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        take_rows(x, torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        take_rows(x.t(), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(IndexError):
        take_rows(x, torch.tensor([8]))
