"""The port's trpo (algos/trpo/trpo.py, core/cg.py and the tree helpers of core/math.py)
against the JAX package's, on the CPU: conjugate gradient on seeded SPD systems, the
tree flattening, the Fisher-vector product against ``jax.jvp`` of the KL's gradient, and
the slice as a whole, one trpo update of each side from the same weights (carried
across by convert.py), the same env state and the same draws (the rollout's, then the
value fit's epoch permutations, rebuilt from the JAX learner's key splits)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (ReplayDraws, base_env, mlp_policy_params, push_epochs, push_reset,
                          push_rollout_step, rel_err)

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.trpo import trpo as jtrpo
from baselines_tpu.core import logger as jax_logger
from baselines_tpu.core.cg import cg as jax_cg
from baselines_tpu.core.math import flatten_tree as jax_flatten_tree
from baselines_tpu.core.math import global_norm as jax_global_norm
from baselines_tpu.core.math import unflatten_like as jax_unflatten_like
from baselines_tpu.nn.distributions import make_pdtype as jax_make_pdtype
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import ClipAdam, build_env
from baselines_tpu_torch.algos.trpo import trpo
from baselines_tpu_torch.core.cg import cg
from baselines_tpu_torch.core.math import flatten_tree, global_norm, unflatten_like
from baselines_tpu_torch.nn.policy import build_policy


def _converged_trip(a: np.ndarray, b: np.ndarray, iters: int, tol: float):
    """The first trip (0-based) after which the f32 recurrence's residual is below
    ``tol``, or None."""
    x, r, p = np.zeros_like(b), b.copy(), b.copy()
    rdotr = np.float32(b @ b)
    for i in range(iters):
        z = a @ p
        v = rdotr / max(np.float32(p @ z), np.float32(1e-12))
        r = r - v * z
        newrdotr = np.float32(r @ r)
        if newrdotr < tol:
            return i
        p = r + newrdotr / max(rdotr, np.float32(1e-12)) * p
        rdotr = newrdotr
    return None


@pytest.mark.parametrize("n,iters,tol", [(40, 10, 1e-10), (6, 10, 1e-10), (30, 10, 1e-3)])
def test_cg_matches_jax(n, iters, tol):
    """To 1e-5 on seeded SPD systems, with exactly ``cg_iters`` operator calls; the last
    two cases reach ``residual_tol`` before the last trip, where the carry freezes."""
    rng = np.random.RandomState(n)
    m = rng.randn(n, n).astype(np.float32)
    a = (m @ m.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    trip = _converged_trip(a, b, iters, tol)
    assert (trip is None) if n == 40 else (trip is not None and trip < iters - 1)
    want = np.asarray(jax_cg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), iters, tol))
    calls = []

    def f_ax(v):
        calls.append(1)
        return torch.from_numpy(a) @ v

    got = cg(f_ax, torch.from_numpy(b), iters, tol).numpy()
    assert len(calls) == iters
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if trip is not None:  # the carry froze: the trips after convergence change nothing
        early = cg(lambda v: torch.from_numpy(a) @ v, torch.from_numpy(b), trip + 1, tol)
        np.testing.assert_array_equal(got, early.numpy())
    if tol < 1e-6:
        assert rel_err(got, np.linalg.solve(a.astype(np.float64), b)) < 1e-3


def test_flatten_tree_round_trips_and_matches_jax():
    """flatten_tree concatenates in the tree's order, as the JAX package's does on a dict
    of sorted keys; unflatten_like gives the shapes, dtypes and structure back;
    global_norm agrees; a vector of the wrong length raises."""
    rng = np.random.RandomState(0)
    arrays = {"a": rng.randn(3, 4), "b": rng.randn(5), "c": rng.randn(2, 1, 3)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    tree = {k: torch.from_numpy(v) for k, v in arrays.items()}
    jtree = {k: jnp.asarray(v) for k, v in arrays.items()}
    flat = flatten_tree(tree)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jax_flatten_tree(jtree)))
    back = unflatten_like(flat, tree)
    assert list(back) == list(tree)
    for k in tree:
        assert torch.equal(back[k], tree[k])
    jback = jax_unflatten_like(jnp.asarray(flat.numpy()), jtree)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(jback[k]), arrays[k])
    np.testing.assert_allclose(float(global_norm(tree)), float(jax_global_norm(jtree)),
                               rtol=1e-6)

    leaves = [torch.randn(2, 3), torch.randn(4).to(torch.bfloat16)]
    back = unflatten_like(flatten_tree(leaves), leaves)
    assert isinstance(back, list) and back[1].dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(back, leaves))
    assert isinstance(unflatten_like(flatten_tree(tuple(leaves)), tuple(leaves)), tuple)
    with pytest.raises(ValueError):
        unflatten_like(flat[:-1], tree)


ENVS = {"cartpole": "CartPole-v1", "box": "BoxIdentity-v0"}


def _params(jvenv, gaussian_logstd: float = -0.5) -> dict:
    """Numpy-made params of an mlp PolicyValueNet with a value tower, in flax layout."""
    pdtype = jax_make_pdtype(jvenv.action_space)
    gaussian = pdtype.kind == "diag_gaussian"
    width = pdtype.param_size // 2 if gaussian else pdtype.param_size
    ob_dim = int(np.prod(jvenv.observation_space.shape))
    params = mlp_policy_params(0, ob_dim, width)
    params["params"]["value_network"] = mlp_policy_params(1, ob_dim, width)["params"]["network"]
    if gaussian:
        params["params"]["logstd"] = np.full((1, width), gaussian_logstd, np.float32)
    return params


def _to_port_flat(jflat, jpol: dict, names) -> torch.Tensor:
    """A flat vector over the JAX policy params, in the port's order and layout."""
    tree = jax.tree_util.tree_map(np.asarray, jax_unflatten_like(jnp.asarray(jflat), jpol))
    sd = convert.policy_state_dict(tree)
    return torch.cat([sd[name].reshape(-1) for name in names])


@pytest.mark.parametrize("env", list(ENVS))
def test_fisher_vector_product_matches_jax_jvp(env):
    """The double-backward product of the port against ``jax.jvp(jax.grad(mean_kl))``
    of trpo.py:171-181 at the same params, observations and vector, to 1e-4 relative."""
    jvenv = jax_build_env(ENVS[env], 4)
    params = _params(jvenv)
    jpolicy = jax_build_policy(jvenv.observation_space, jvenv.action_space, "mlp",
                               value_network="copy")
    rng = np.random.RandomState(3)
    ob = rng.randn(64, int(np.prod(jvenv.observation_space.shape))).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    pol, vf = jtrpo.split_params(jparams)
    old = jpolicy.apply(jparams, jnp.asarray(ob))[0]

    def mean_kl(pp):
        pdflat = jpolicy.apply(jtrpo.merge_params(pp, vf), jnp.asarray(ob))[0]
        return jnp.mean(jpolicy.pdtype.pdfromflat(old).kl(jpolicy.pdtype.pdfromflat(pdflat)))

    n = int(jax_flatten_tree(pol).shape[0])
    v = rng.randn(n).astype(np.float32)
    _, hv = jax.jvp(jax.grad(mean_kl), (pol,), (jax_unflatten_like(jnp.asarray(v), pol),))
    want = np.asarray(jax_flatten_tree(hv)) + 0.1 * v

    tvenv = build_env(ENVS[env], 4, device="cpu")
    tpol = build_policy(tvenv.observation_space, tvenv.action_space, "mlp", device="cpu",
                        value_network="copy")
    tpol.module.load_state_dict(convert.policy_state_dict(params))
    theta = {k: p.detach() for k, p in trpo.split_params(tpol.module)[0].items()}
    assert set(theta) == {"network.mlp_fc0.weight", "network.mlp_fc0.bias",
                          "network.mlp_fc1.weight", "network.mlp_fc1.bias", "pi.weight",
                          "pi.bias"} | ({"logstd"} if env == "box" else set())
    tob = torch.from_numpy(ob)
    with torch.no_grad():
        told = tpol.module(tob)[0]
    np.testing.assert_allclose(told.numpy(), np.asarray(old), rtol=1e-5, atol=1e-6)
    hvp = trpo.fisher_vector_product(tpol, theta, tob, told, 0.1)
    got = hvp(_to_port_flat(v, pol, theta))
    want_port = _to_port_flat(want, pol, theta)
    assert float(want_port.abs().max()) > 0
    assert rel_err(got.numpy(), want_port.numpy()) < 1e-4
    # the graph is kept: a second product on the same KL gradient agrees too
    assert rel_err(hvp(_to_port_flat(v, pol, theta)).numpy(), want_port.numpy()) < 1e-4


NENVS, NSTEPS = 8, 32  # 256 samples: 4 value minibatches of 64 an epoch
CASES = {
    "cartpole": dict(env_id="CartPole-v1", max_kl=0.01, gamma=0.99, lam=0.98, ent_coef=0.01),
    # BoxIdentity's Fisher carries its curvature in a few directions: CG's residual falls
    # to f32 round-off by the fourth trip, after which the two sides' iterates part (a
    # trip's p.z falls to 1e-5 of the first and the freeze comes a trip apart), so the
    # case runs the three trips before that
    "box": dict(env_id="BoxIdentity-v0", max_kl=0.01, gamma=0.9, lam=1.0, ent_coef=0.0,
                cg_iters=3),
    # a step so small that it moves no f32 param: no probe improves, none passes
    "no_probe_passes": dict(env_id="CartPole-v1", max_kl=1e-20, gamma=0.99, lam=0.98,
                            ent_coef=0.0),
}
HPARAMS = dict(cg_damping=0.1, vf_stepsize=1e-3, vf_iters=2, fvp_subsample=5)


def _one_update(case: str) -> dict:
    """One trpo update of the JAX learner (learn for one batch, its initial params
    replaced by numpy-made ones through a wrapped ``jit_init``, its metrics caught from
    ``logger.logkv``) and of the port's ``make_update_fn`` from the same state and
    draws. The port's ``unflatten_like`` calls are recorded: the line search's probes,
    then the final params."""
    spec = dict(CASES[case])
    env_id = spec.pop("env_id")
    spec.setdefault("cg_iters", 10)
    jvenv = jax_build_env(env_id, NENVS)
    params = _params(jvenv)
    starts, logged = [], {}

    def start_from_params(make_state, key):
        state = jax_common.dealias(make_state(key))  # as the jitted init leaves it
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
        starts.append(jax.device_get((state.key, state.obs)))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", start_from_params)
        mp.setattr(jax_logger, "logkv", lambda k, v: logged.__setitem__(k, v))
        mp.setattr(jax_logger, "dumpkvs", lambda: None)
        jmodel = jtrpo.learn(env_id=env_id, network="mlp", total_timesteps=NENVS * NSTEPS,
                             seed=0, num_envs=NENVS, timesteps_per_batch=NENVS * NSTEPS,
                             log_interval=1, **spec, **HPARAMS)
    (jkey, jobs), = starts
    jnew = jax.tree_util.tree_map(np.asarray, jmodel.state.params)

    base = base_env(jvenv)
    draws = ReplayDraws()
    _, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    push_reset(draws, base, kreset, NENVS)
    k = jkey
    for _ in range(NSTEPS):
        k = push_rollout_step(draws, base, k, NENVS, jvenv.action_space)
    push_epochs(draws, k, HPARAMS["vf_iters"], NENVS * NSTEPS)

    tvenv = build_env(env_id, NENVS, device="cpu")
    tpol = build_policy(tvenv.observation_space, tvenv.action_space, "mlp", device="cpu",
                        value_network="copy")
    start = convert.policy_state_dict(params)
    tpol.module.load_state_dict(start)
    vf_opt = ClipAdam(trpo.split_params(tpol.module)[1].values(), None, eps=1e-8)
    obs, env_state = tvenv.reset(draws)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-6, atol=1e-7)
    state = trpo.TRPOTrainState(env_state=env_state, obs=obs,
                                last_done=torch.zeros((NENVS,), dtype=torch.bool))
    update_fn = trpo.make_update_fn(
        tpol, tvenv, vf_opt, nsteps=NSTEPS, max_kl=spec["max_kl"], cg_iters=spec["cg_iters"],
        gamma=spec["gamma"], lam=spec["lam"], ent_coef=spec["ent_coef"],
        cg_damping=HPARAMS["cg_damping"], vf_stepsize=HPARAMS["vf_stepsize"],
        vf_iters=HPARAMS["vf_iters"], fvp_subsample=HPARAMS["fvp_subsample"])
    recorded = []

    def recording_unflatten(vec, tree):
        recorded.append(vec.clone())
        return unflatten_like(vec, tree)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trpo, "unflatten_like", recording_unflatten)
        tnew, tmetrics = update_fn(state, draws)
    assert not draws.queue, "the port took fewer draws than the JAX update made"
    return dict(jnew=jnew, jmetrics=logged, tnew=tnew, tmetrics=tmetrics, tpol=tpol,
                start=start, probes=recorded[:-1], jstart=params)


@pytest.fixture(scope="module", params=list(CASES))
def update(request):
    return request.param, _one_update(request.param)


def test_update_metrics_match_jax(update):
    """Every metric of the update to 1e-4 relative (1e-6 absolute for the gains, which
    are about 0 at the old params); ``linesearch_success`` exactly; where no probe
    passes, ``improve`` 0 and ``meankl`` probe 0's on both sides."""
    case, run = update
    jm, tm = run["jmetrics"], run["tmetrics"]
    assert set(tm) <= set(jm)
    for k in tm:
        got, want = float(tm[k]), float(jm[k])
        assert abs(got - want) <= 1e-6 + 1e-4 * abs(want), (k, got, want)
    assert float(tm["linesearch_success"]) == float(jm["linesearch_success"]) == (
        0.0 if case == "no_probe_passes" else 1.0)
    if case == "no_probe_passes":
        assert float(tm["improve"]) == float(jm["improve"]) == 0.0
        assert len(run["probes"]) == 10
    assert int(jm["iters"]) == 1 and run["tnew"].iters == 1


def test_update_takes_the_line_search_step_of_jax(update):
    """The chosen probe is the JAX learner's: the port's policy change is its probe k's
    step, fullstep / 2^k, and the JAX learner's change is fullstep / 2^k for the same k
    (to 1e-3 in log2; a neighbouring probe is a factor 2 away); each policy param's
    change to 2e-4 of the JAX change, beside the ulp in which each side rounds the f32
    param it steps (the step is about 1e-5 of a param of about 1, so that ulp is about 1 %
    of the change); none where no probe passes."""
    case, run = update
    pol = trpo.split_params(run["tpol"].module)[0]
    names = list(pol)
    before = torch.cat([run["start"][n].reshape(-1) for n in names]).double()
    after = torch.cat([p.detach().reshape(-1) for p in pol.values()]).double()
    want_sd = convert.policy_state_dict(run["jnew"])
    jafter = torch.cat([want_sd[n].reshape(-1) for n in names]).double()
    if case == "no_probe_passes":
        assert torch.equal(after, before) and torch.equal(jafter, before)
        return
    k_port = len(run["probes"]) - 1
    fullstep = run["probes"][0].double() - before
    assert torch.allclose((after - before) * 2.0 ** k_port, fullstep, rtol=1e-4, atol=1e-7)
    k_jax = math.log2(float(fullstep.norm() / (jafter - before).norm()))
    assert abs(k_jax - k_port) < 1e-3, (k_jax, k_port)
    for n in names:
        base = run["start"][n].double()
        delta_want = want_sd[n].double() - base
        assert float(delta_want.abs().max()) > 0, n
        ulp = torch.from_numpy(np.spacing(np.abs(want_sd[n].numpy()))).double()
        err = (pol[n].detach().double() - base - delta_want).abs()
        assert bool((err <= 2e-4 * delta_want.abs().max() + ulp).all()), n


def test_update_value_fit_matches_jax(update):
    """Each value-tower param's change over the vf_iters epochs of Adam to 2e-4 of the
    JAX change, as tests/test_torch_update.py holds ppo2's params."""
    _, run = update
    want_sd = convert.policy_state_dict(run["jnew"])
    vf = trpo.split_params(run["tpol"].module)[1]
    assert vf and all(n.startswith(("value_network.", "vf.")) for n in vf)
    for n, p in vf.items():
        base = run["start"][n].double()
        delta_want = want_sd[n].double() - base
        assert float(delta_want.abs().max()) > 0, n
        assert rel_err(p.detach().double() - base, delta_want) < 2e-4, n


def test_learn_runs_on_the_cpu_saves_and_resumes(tmp_path):
    """The entry point at a tiny size: the JAX keys logged, ``save_interval`` writes the
    whole state and a second run resumes its iteration count from it; ``load_path``
    loads params only and wins over that resume; a mesh that is not a ``Mesh`` raises
    TypeError."""
    from baselines_tpu_torch.core import logger

    logger.configure(dir=str(tmp_path), format_strs=["json"])
    try:
        kwargs = dict(env_id="CartPole-v1", total_timesteps=128, num_envs=4,
                      timesteps_per_batch=64, vf_iters=1, save_interval=1, seed=0,
                      device="cpu")
        first = trpo.learn(**kwargs)
        assert first.state.iters == 2
        assert (tmp_path / "checkpoints" / "00002").exists()
        resumed = trpo.learn(**dict(kwargs, total_timesteps=192))
        assert resumed.state.iters == 3
        first.save(str(tmp_path / "model.pt"))
        loaded = trpo.learn(**dict(kwargs, total_timesteps=0,
                                   load_path=str(tmp_path / "model.pt")))
        assert loaded.state.iters == 0
        for a, b in zip(first.policy.module.parameters(), loaded.policy.module.parameters()):
            assert torch.equal(a, b)
    finally:
        logger.reset()
    rows = [__import__("json").loads(line) for line in (tmp_path / "progress.json").open()]
    assert {"iters", "timesteps", "EpRewMean", "EpLenMean", "fps", "optimgain", "meankl",
            "entropy", "surrgain", "expectedimprove", "improve", "linesearch_success",
            "ev_tdlam_before"} == set(rows[0])
    with pytest.raises(TypeError, match="Mesh"):
        trpo.learn(env_id="CartPole-v1", total_timesteps=0, device="cpu", mesh=object())
