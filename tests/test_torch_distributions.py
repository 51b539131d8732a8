"""The port's action distributions, ``PdType`` and the policies over every action space
against the JAX package's, on the CPU.

Tolerances: each distribution's ``neglogp``, ``kl`` and ``entropy`` to rtol 1e-5 / atol
1e-6 (exp, log and sums in another order); ``mode`` and the categorical samples from
the same noise equal; the Gaussian's samples (mean + std * noise) to rtol 1e-6. The
policies through ``convert.py``: mlp latents to 1e-5 relative, as tests/test_torch_mlp.py
holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ReplayDraws, mlp_policy_params, push_policy_noise, rel_err

from baselines_tpu.envs import spaces as jspaces
from baselines_tpu.nn import distributions as jd
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.envs import spaces as tspaces
from baselines_tpu_torch.nn import distributions as td
from baselines_tpu_torch.nn.policy import build_policy

N = 64
TOL = dict(rtol=1e-5, atol=1e-6)
# (name, JAX space, port space): one of each distribution's action spaces
SPACES = [
    ("categorical", jspaces.Discrete(5), tspaces.Discrete(5)),
    ("multicategorical", jspaces.MultiDiscrete([3, 4, 2]), tspaces.MultiDiscrete([3, 4, 2])),
    ("diag_gaussian", jspaces.Box(-1, 1, (3,)), tspaces.Box(-1, 1, (3,))),
    ("bernoulli", jspaces.MultiBinary(4), tspaces.MultiBinary(4)),
]
KINDS = [s[0] for s in SPACES]


def _flat(rng, pdtype, scale=2.0):
    flat = rng.randn(N, pdtype.param_size).astype(np.float32) * scale
    if pdtype.kind == "diag_gaussian":  # log standard deviations of moderate size
        flat[:, pdtype.param_size // 2:] *= 0.3
    return flat


@pytest.mark.parametrize("kind,jspace,tspace", SPACES, ids=KINDS)
def test_pdtype_matches_jax(kind, jspace, tspace):
    """make_pdtype's kind, flat-parameter width, sample shape and dtype."""
    jt, tt = jd.make_pdtype(jspace), td.make_pdtype(tspace)
    assert tt.kind == jt.kind == kind
    assert tt.param_size == jt.param_size and tt.sample_shape == tuple(jt.sample_shape)
    assert str(tt.sample_dtype).split(".")[-1] == np.dtype(jt.sample_dtype).name
    with pytest.raises(ValueError, match="flat vectors"):
        td.make_pdtype(tspaces.Box(-1, 1, (2, 2)))


@pytest.mark.parametrize("kind,jspace,tspace", SPACES, ids=KINDS)
def test_distribution_matches_jax(kind, jspace, tspace):
    """neglogp (of samples and of other actions), kl, entropy and mode of each
    distribution on the same flat parameters; ``sample`` on the noise the JAX
    distribution draws, fed through ``noise(draws)`` in its order."""
    rng = np.random.RandomState(KINDS.index(kind))
    jt, tt = jd.make_pdtype(jspace), td.make_pdtype(tspace)
    flat, other = _flat(rng, jt), _flat(rng, jt)
    jpd, tpd = jt.pdfromflat(jnp.asarray(flat)), tt.pdfromflat(torch.from_numpy(flat))
    jother, tother = jt.pdfromflat(jnp.asarray(other)), tt.pdfromflat(torch.from_numpy(other))
    np.testing.assert_allclose(tpd.kl(tother).numpy(), np.asarray(jpd.kl(jother)), **TOL)
    np.testing.assert_allclose(tpd.entropy().numpy(), np.asarray(jpd.entropy()), **TOL)
    np.testing.assert_array_equal(tpd.mode().numpy(), np.asarray(jpd.mode()))
    assert torch.equal(tpd.flatparam(), torch.from_numpy(flat))

    key = jax.random.PRNGKey(7)
    draws = ReplayDraws()
    push_policy_noise(draws, key, N, jspace)
    got = tpd.sample(tpd.noise(draws))
    assert not draws.queue
    want = np.asarray(jpd.sample(key))
    assert got.shape == (N,) + tt.sample_shape and got.dtype == tt.sample_dtype
    if kind == "diag_gaussian":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(tpd.neglogp(got).numpy(), np.asarray(jpd.neglogp(jnp.asarray(want))),
                               **TOL)
    x = np.asarray(jother.mode())
    np.testing.assert_allclose(tpd.neglogp(torch.from_numpy(x)).numpy(),
                               np.asarray(jpd.neglogp(jnp.asarray(x))), **TOL)


# observation space, action space for a policy of each distribution
POLICY_SPACES = [
    ("diag_gaussian", (jspaces.Box(-1, 1, (3,)), jspaces.Box(-2, 2, (2,))),
     (tspaces.Box(-1, 1, (3,)), tspaces.Box(-2, 2, (2,)))),
    ("multicategorical", (jspaces.MultiDiscrete([3, 3]), jspaces.MultiDiscrete([3, 3])),
     (tspaces.MultiDiscrete([3, 3]), tspaces.MultiDiscrete([3, 3]))),
    ("bernoulli", (jspaces.Box(-1, 1, (5,)), jspaces.MultiBinary(4)),
     (tspaces.Box(-1, 1, (5,)), tspaces.MultiBinary(4))),
]


@pytest.mark.parametrize("kind,jsp,tsp", POLICY_SPACES, ids=[p[0] for p in POLICY_SPACES])
def test_policy_over_each_action_space_matches_jax(kind, jsp, tsp):
    """build_policy with mlp (2 x 16) from the JAX params through convert.py (the
    Gaussian's ``logstd`` leaf included, MultiDiscrete observations one-hot encoded):
    ``step``'s action on the fed noise, its value and neglogp, ``mode_step`` and
    ``value``, against the JAX policy's."""
    (jobs_space, jac_space), (tobs_space, tac_space) = jsp, tsp
    rng = np.random.RandomState(3)
    if kind == "multicategorical":
        obs = np.stack([rng.randint(0, 3, N), rng.randint(0, 3, N)], -1).astype(np.int32)
        ob_width = 6
    else:
        obs = rng.uniform(-1, 1, (N,) + jobs_space.shape).astype(np.float32)
        ob_width = jobs_space.shape[0]
    jt = jd.make_pdtype(jac_space)
    gaussian = kind == "diag_gaussian"
    width = jt.param_size // 2 if gaussian else jt.param_size
    params = mlp_policy_params(5, ob_width, width, num_hidden=16)
    if gaussian:
        params["params"]["logstd"] = np.array([[-0.3, 0.2]], np.float32)
    jpol = jax_build_policy(jobs_space, jac_space, "mlp", num_hidden=16)
    tpol = build_policy(tobs_space, tac_space, "mlp", device="cpu", num_hidden=16)
    assert (hasattr(tpol.module, "logstd")) == gaussian
    tpol.module.load_state_dict(convert.policy_state_dict(params))

    key = jax.random.PRNGKey(1)
    jaction, jvalue, jneglogp, _ = jpol.step(params, key, jnp.asarray(obs))
    draws = ReplayDraws()
    push_policy_noise(draws, key, N, jac_space)
    action, value, neglogp = tpol.step(torch.from_numpy(obs), draws)
    assert not draws.queue and action.dtype == tpol.pdtype.sample_dtype
    if gaussian:
        np.testing.assert_allclose(action.numpy(), np.asarray(jaction), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
    assert rel_err(value, jvalue) < 1e-5 and rel_err(neglogp, jneglogp) < 1e-5
    jmode, jmvalue, _ = jpol.mode_step(params, jnp.asarray(obs))
    mode, mvalue = tpol.mode_step(torch.from_numpy(obs))
    if gaussian:
        assert rel_err(mode, jmode) < 1e-5
    else:
        np.testing.assert_array_equal(mode.numpy(), np.asarray(jmode))
    assert rel_err(mvalue, jmvalue) < 1e-5
    assert rel_err(tpol.value(torch.from_numpy(obs)), jpol.value(params, jnp.asarray(obs))) < 1e-5
