"""The port's return estimators against the JAX package's, on random time-major
(T, N) arrays with dones. Tolerance 1e-6 relative to the largest return: the port runs
the reverse loop and JAX an associative scan, which add in another order."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

# both packages re-export gae(), which shadows the module's name in the package
tgae = importlib.import_module("baselines_tpu_torch.data.gae")
jgae = importlib.import_module("baselines_tpu.data.gae")

T, N = 37, 5
TOL = 1e-6


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.RandomState(0)
    return dict(
        rewards=rng.randn(T, N).astype(np.float32),
        values=rng.randn(T, N).astype(np.float32),
        dones=rng.rand(T, N) < 0.15,
        last_value=rng.randn(N).astype(np.float32),
    )


def _j(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _t(a):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}


def test_gae_matches_jax(arrays):
    j, t = _j(arrays), _t(arrays)
    jadv, jret = jgae.gae(j["rewards"], j["values"], j["dones"], j["last_value"], 0.99, 0.95)
    tadv, tret = tgae.gae(t["rewards"], t["values"], t["dones"], t["last_value"], 0.99, 0.95)
    assert tadv.shape == (T, N) and tadv.dtype == torch.float32
    assert rel_err(tadv, jadv) < TOL
    assert rel_err(tret, jret) < TOL


def test_nstep_returns_and_discount_match_jax(arrays):
    j, t = _j(arrays), _t(arrays)
    want = jgae.nstep_returns(j["rewards"], j["dones"], j["last_value"], 0.9)
    got = tgae.nstep_returns(t["rewards"], t["dones"], t["last_value"], 0.9)
    assert rel_err(got, want) < TOL
    want = jgae.discount_with_dones(j["rewards"], j["dones"], 0.9)
    got = tgae.discount_with_dones(t["rewards"], t["dones"], 0.9)
    assert rel_err(got, want) < TOL
