"""Parts of the port's ppo2 against the JAX package's, on the CPU: one optimizer step
against optax on identical gradients, and the PPO loss and its gradients on a fixed
batch, from weights carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import policy_params, rel_err

from baselines_tpu.algos.common import adam_optimizer, apply_updates_lr
from baselines_tpu.algos.ppo.ppo import _normalize_advs as jax_normalize_advs
from baselines_tpu.algos.ppo.ppo import make_ppo_loss as jax_make_ppo_loss
from baselines_tpu.envs.spaces import Box as JaxBox, Discrete as JaxDiscrete
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import ClipAdam
from baselines_tpu_torch.algos.ppo.ppo import _normalize_advs, make_ppo_loss
from baselines_tpu_torch.envs.spaces import Box, Discrete
from baselines_tpu_torch.nn.policy import build_policy


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_clip_adam_matches_optax(scale):
    """Three steps on the same gradients: params to 1e-6 (one f32 rounding of values
    near 1), and the change each made to 1e-3 of the change (updates of about 1e-3
    against those roundings). The large gradients trip the global-norm clip, the small
    ones do not."""
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (3,), (2, 2, 5)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * scale).astype(np.float32) for s in shapes] for _ in range(3)]
    tx = adam_optimizer(0.5, eps=1e-5)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = ClipAdam(tp, 0.5, eps=1e-5)
    for g in grads:
        jp, jstate = apply_updates_lr(tx, jp, jstate, [jnp.asarray(x) for x in g], jnp.float32(3e-4))
        opt.step([torch.tensor(x) for x in g], 3e-4)
    for got, want, start in zip(tp, jp, params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        start = start.astype(np.float64)
        assert rel_err(got.numpy() - start, np.asarray(want, np.float64) - start) < 1e-3


@pytest.fixture(scope="module")
def loss_setup():
    rng = np.random.RandomState(1)
    b = 32
    ob, ac = JaxBox(0, 255, (21, 21, 64), np.uint8), JaxDiscrete(6)
    jpol = jax_build_policy(ob, ac, "cnn_s2d")
    obs = rng.randint(0, 256, (b, 21, 21, 64)).astype(np.uint8)
    params = policy_params(0)
    tpol = build_policy(Box(0, 255, (21, 21, 64), np.uint8), Discrete(6), "cnn_s2d", device="cpu")
    tpol.module.load_state_dict(convert.policy_state_dict(params))
    batch = (
        obs,
        rng.randint(0, 6, (b,)).astype(np.int32),
        rng.randn(b).astype(np.float32),  # returns
        rng.randn(b).astype(np.float32) * 0.1,  # old values
        (1.79 + rng.randn(b) * 0.3).astype(np.float32),  # old neglogps: ratios off 1
        np.zeros((b,), np.float32),
    )
    return jpol, params, tpol, batch


def test_ppo_loss_and_grads_match_jax(loss_setup):
    """Loss, every logged metric and every gradient to 1e-5 relative (f32 convolution
    sums in another order), at a clip range the old values and ratios cross."""
    jpol, params, tpol, batch = loss_setup
    jloss_fn = jax_make_ppo_loss(jpol, 0.01, 0.5)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    jadvs = jax_normalize_advs(jbatch[2], jbatch[3])
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        params, jbatch, jadvs, jnp.float32(0.1))
    tloss_fn = make_ppo_loss(tpol, 0.01, 0.5)
    tbatch = [torch.from_numpy(x) for x in batch]
    tadvs = _normalize_advs(tbatch[2], tbatch[3])
    assert rel_err(tadvs, jadvs) < 1e-6
    tloss, tmetrics = tloss_fn(tbatch, tadvs, 0.1)
    tloss.backward()
    assert rel_err(tloss.detach(), jloss) < 1e-5
    assert 0 < float(jmetrics["clipfrac"]) < 1
    for k, v in jmetrics.items():
        assert abs(float(tmetrics[k].detach()) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k
    want = convert.policy_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in tpol.module.named_parameters():
        assert rel_err(p.grad, want[name]) < 1e-4, name
