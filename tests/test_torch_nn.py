"""The port's distribution, network and policy against the JAX package's, on the CPU,
with weights carried across by baselines_tpu_torch/convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import policy_params, rel_err

from baselines_tpu.envs.spaces import Box as JaxBox, Discrete as JaxDiscrete
from baselines_tpu.nn.distributions import CategoricalPd as JaxCategoricalPd
from baselines_tpu.nn.networks import NatureCNNS2D as JaxNatureCNNS2D
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.envs.spaces import Box, Discrete
from baselines_tpu_torch.nn.distributions import CategoricalPd
from baselines_tpu_torch.nn.networks import NatureCNNS2D
from baselines_tpu_torch.nn.policy import build_policy
from baselines_tpu_torch.ops import fused_cnn


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(0).randint(0, 256, (8, 21, 21, 64)).astype(np.uint8)


def test_categorical_pd_matches_jax():
    """neglogp and entropy to 1e-6 (f32 softmax in another order); the Gumbel-max
    sample with JAX's own uniforms injected picks the same actions."""
    rng = np.random.RandomState(1)
    logits = (rng.randn(64, 6) * 3).astype(np.float32)
    x = rng.randint(0, 6, (64,)).astype(np.int32)
    jpd, tpd = JaxCategoricalPd(jnp.asarray(logits)), CategoricalPd(torch.from_numpy(logits))
    np.testing.assert_allclose(tpd.neglogp(torch.from_numpy(x)).numpy(),
                               np.asarray(jpd.neglogp(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tpd.entropy().numpy(), np.asarray(jpd.entropy()),
                               rtol=1e-6, atol=1e-6)
    other = (rng.randn(64, 6)).astype(np.float32)
    np.testing.assert_allclose(tpd.kl(CategoricalPd(torch.from_numpy(other))).numpy(),
                               np.asarray(jpd.kl(JaxCategoricalPd(jnp.asarray(other)))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tpd.mode().numpy(), np.asarray(jpd.mode()))
    key = jax.random.PRNGKey(7)
    u = jax.random.uniform(key, logits.shape, jnp.float32, 1e-10, 1.0)
    np.testing.assert_array_equal(tpd.sample(torch.from_numpy(np.array(u))).numpy(),
                                  np.asarray(jpd.sample(key)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_nature_cnn_s2d_through_convert(frames, dtype, tol):
    """f32 to 1e-5 relative (convolution sums in another order); bf16 to 2e-2 (the
    activations round to bf16 between layers, tests/test_fused_cnn.py's tolerance)."""
    jnet = JaxNatureCNNS2D(dtype=getattr(jnp, dtype))
    params = {"params": policy_params(0)["params"]["network"]}
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(frames)))
    net = NatureCNNS2D(dtype=getattr(torch, dtype))
    net.load_state_dict(convert.network_state_dict(params))
    with torch.no_grad():
        got = net(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == want.shape == (8, 512)
    assert rel_err(got, want) < tol
    assert (want > 0).mean() > 0.1


def _policies(dtype):
    ob_space, ac_space = JaxBox(0, 255, (21, 21, 64), np.uint8), JaxDiscrete(6)
    jpol = jax_build_policy(ob_space, ac_space, "cnn_s2d", dtype=getattr(jnp, dtype))
    tpol = build_policy(Box(0, 255, (21, 21, 64), np.uint8), Discrete(6), "cnn_s2d",
                        device="cpu", dtype=getattr(torch, dtype))
    return jpol, tpol


class _Uniforms:
    def __init__(self, u):
        self.u = u

    def uniform(self, shape, low, high):
        assert tuple(shape) == self.u.shape
        return torch.from_numpy(self.u)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_policy_step_and_value_match_jax(frames, dtype):
    """Policy.step with JAX's Gumbel uniforms injected. In bf16 the port's step runs the
    fused kernel's plain version (on the CPU), whose arithmetic is the bf16 network's:
    values and neglogps to 2e-2 relative, in f32 to 1e-5."""
    jpol, tpol = _policies(dtype)
    assert tpol.uses_kernel == (dtype == "bfloat16")
    # a policy head 100 times its init scale keeps the actions away from near ties
    params = policy_params(1)
    params["params"]["pi"]["kernel"] = params["params"]["pi"]["kernel"] * 100
    tpol.module.load_state_dict(convert.policy_state_dict(params))
    key = jax.random.PRNGKey(2)
    jaction, jvalue, jneglogp, _ = jpol.step(params, key, jnp.asarray(frames))
    u = np.array(jax.random.uniform(key, (8, 6), jnp.float32, 1e-10, 1.0))
    action, value, neglogp = tpol.step(torch.from_numpy(frames), _Uniforms(u), tpol.pack())
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
    assert rel_err(value, jvalue) < tol
    assert rel_err(neglogp, jneglogp) < tol
    assert rel_err(tpol.value(torch.from_numpy(frames)), jpol.value(params, jnp.asarray(frames))) < tol


def test_pack_params_is_tap_major(frames):
    """The packed conv weights are (k*k, Cout, Cin) with tap dy*k+dx, the dense weight
    keeps the NHWC flatten order."""
    net = NatureCNNS2D(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    packed = fused_cnn.pack_params(net)
    w2 = net.c2.weight.detach()
    for dy, dx in ((0, 0), (1, 3), (3, 2)):
        np.testing.assert_array_equal(
            packed[2][dy * 4 + dx].float().numpy(),
            w2[:, :, dy, dx].to(torch.bfloat16).float().numpy(),
        )
    with torch.no_grad():
        want = net(torch.from_numpy(frames))
    got = fused_cnn.reference_forward(torch.from_numpy(frames), packed)
    assert rel_err(got, want) < 2e-2
