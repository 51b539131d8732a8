"""trpo and gail under a data-parallel mesh, on two gloo ranks on the CPU
(tests/torch_dist_worker.py, one pair of processes for the whole file).

- One trpo iteration on two ranks against the JAX learner's iteration on the whole batch
  (its mesh run computes the one-process numbers, trpo.py:283-286), from the same
  converted weights: each rank is handed its rows of every env-axis draw (reset states,
  the policy's noise) and the value epochs' permutations whole. 8 envs x 32 steps: 128
  samples a rank, not a multiple of 5, so that a rank's own ``[::5]`` is not its share
  of the global batch's Fisher subsample. Tolerances as tests/test_torch_trpo.py.
- Whole ``learn`` runs at tests/test_mesh_learners.py:84-117's configurations: trpo
  finite and bit for bit equal on both ranks (that file's ``compare=False``), its
  logged episode statistics the one process's; gail, which runs unsharded on every rank,
  bit for bit the one process's run on both ranks.
- trpo's checkpoints: a two-rank run resumed from its ``save_interval`` checkpoint of
  iteration 2 ends bit for bit where the uninterrupted two-rank run ends; only rank 0
  writes.
"""

import math

import jax
import numpy as np
import pytest
import torch
from torch_dist_worker import RecordingOutput, run_ranks
from torch_parity import (RankShares, base_env, mlp_policy_params, push_epochs, push_reset,
                          push_rollout_step, rel_err)

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.trpo import trpo as jtrpo
from baselines_tpu.core import logger as jax_logger
from baselines_tpu.nn.distributions import make_pdtype as jax_make_pdtype
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos import get_learn_function
from baselines_tpu_torch.algos.trpo import trpo
from baselines_tpu_torch.core import logger

NDEV, NENVS, NSTEPS = 2, 8, 32
CASES = {
    "cartpole": dict(env_id="CartPole-v1", max_kl=0.01, gamma=0.99, lam=0.98, ent_coef=0.01),
    # three CG trips, as tests/test_torch_trpo.py runs this case
    "box": dict(env_id="BoxIdentity-v0", max_kl=0.01, gamma=0.9, lam=1.0, ent_coef=0.0,
                cg_iters=3),
}
HPARAMS = dict(cg_damping=0.1, vf_stepsize=1e-3, vf_iters=2, fvp_subsample=5)


def _params(jvenv) -> dict:
    """Numpy-made params of an mlp PolicyValueNet with a value tower, in flax layout
    (tests/test_torch_trpo.py's)."""
    pdtype = jax_make_pdtype(jvenv.action_space)
    gaussian = pdtype.kind == "diag_gaussian"
    width = pdtype.param_size // 2 if gaussian else pdtype.param_size
    ob_dim = int(np.prod(jvenv.observation_space.shape))
    params = mlp_policy_params(0, ob_dim, width)
    params["params"]["value_network"] = mlp_policy_params(1, ob_dim, width)["params"]["network"]
    if gaussian:
        params["params"]["logstd"] = np.full((1, width), -0.5, np.float32)
    return params


def _jax_iteration(case: str) -> dict:
    """The JAX learner's iteration on the whole batch (learn for one batch, its params
    replaced through a wrapped ``jit_init``, its metrics caught from ``logger.logkv``),
    and the spec of each rank's half: its rows of each rollout draw, then the value
    epochs' permutations of the whole batch."""
    spec = dict(CASES[case])
    env_id = spec.pop("env_id")
    spec.setdefault("cg_iters", 10)
    jvenv = jax_build_env(env_id, NENVS)
    params = _params(jvenv)
    starts, logged = [], {}

    def start_from_params(make_state, key):
        state = jax_common.dealias(make_state(key))
        state = state.replace(params=jax.tree_util.tree_map(jax.numpy.asarray, params))
        starts.append(jax.device_get(state.key))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", start_from_params)
        mp.setattr(jax_logger, "logkv", lambda k, v: logged.__setitem__(k, v))
        mp.setattr(jax_logger, "dumpkvs", lambda: None)
        jmodel = jtrpo.learn(env_id=env_id, network="mlp", total_timesteps=NENVS * NSTEPS,
                             seed=0, num_envs=NENVS, timesteps_per_batch=NENVS * NSTEPS,
                             log_interval=1, **spec, **HPARAMS)
    jkey, = starts

    base = base_env(jvenv)
    shares = RankShares(NDEV)
    _, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    push_reset(shares.env, base, kreset, NENVS)
    k = jkey
    for _ in range(NSTEPS):
        k = push_rollout_step(shares.env, base, k, NENVS, jvenv.action_space)
    push_epochs(shares.whole, k, HPARAMS["vf_iters"], NENVS * NSTEPS)
    hparams = dict(HPARAMS, **{key: spec[key] for key in ("max_kl", "cg_iters", "gamma",
                                                          "lam", "ent_coef")})
    return dict(jnew=jax.tree_util.tree_map(np.asarray, jmodel.state.params),
                jmetrics=logged, start=convert.policy_state_dict(params),
                spec=dict(env_id=env_id, nenvs=NENVS, nsteps=NSTEPS, hparams=hparams,
                          start=convert.policy_state_dict(params), draws=shares.ranks))


def _expert_npz(path) -> str:
    obs = np.random.RandomState(0).uniform(-1, 1, (1, 512, 1)).astype(np.float32)
    np.savez(path, obs=obs, acs=obs)
    return str(path)


def _learner_runs(tmp) -> dict:
    return {
        # tests/test_mesh_learners.py:104-110, logged every iteration
        "trpo": ("trpo", dict(env_id="DiscreteIdentity-v0", network="mlp",
                              total_timesteps=1536, seed=0, num_envs=8,
                              timesteps_per_batch=512, max_kl=0.01, gamma=0.9, lam=1.0,
                              log_interval=1)),
        "gail": ("gail", dict(env_id="BoxIdentity-v0", network="mlp", total_timesteps=1536,
                              seed=0, num_envs=8, timesteps_per_batch=512, g_step=1,
                              d_step=2, vf_iters=2, num_hidden=16,
                              expert_path=_expert_npz(tmp / "expert.npz"))),
    }


TRPO_CKPT = dict(env_id="CartPole-v1", network="mlp", total_timesteps=3 * 256, seed=0,
                 num_envs=8, timesteps_per_batch=256, vf_iters=1)


def _one_process(alg, kwargs):
    recorder = RecordingOutput()
    logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
    try:
        model = get_learn_function(alg)(device="cpu", **kwargs)
    finally:
        logger.reset()
    return dict(params=model.policy.module.state_dict(), rows=recorder.rows)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_trpo")
    jax_runs = {}

    def jax_refs() -> dict:  # while the ranks run the tasks that need none
        jax_runs.update({name: _jax_iteration(name) for name in CASES})
        return {"update": {"cases": {n: r["spec"] for n, r in jax_runs.items()}}}

    learners = _learner_runs(tmp)
    tasks = {"learners": ("learners", {"runs": learners}),
             "checkpoints": ("trpo_checkpoints", {"kwargs": TRPO_CKPT}),
             "update": ("trpo_update", None)}
    ranks = run_ranks("sequence", tmp, spec={"tasks": tasks}, later=jax_refs)
    return dict(jax=jax_runs, ranks=ranks, workdir=tmp,
                single={name: _one_process(*run) for name, run in learners.items()})


@pytest.mark.parametrize("case", list(CASES))
def test_iteration_metrics_match_jax_on_two_ranks(runs, case):
    """Every metric to 1e-4 relative (1e-6 absolute for the gains) of the JAX
    iteration's on the whole batch, on each rank; ``linesearch_success`` exactly; every
    draw taken; the collectives of an iteration: the monitor's gather, the advantage
    moments, the gradient's all-reduce, one a Fisher-vector product (cg_iters + 1), one
    a line-search probe, and the value fit's gather."""
    jm = runs["jax"][case]["jmetrics"]
    cg_iters = CASES[case].get("cg_iters", 10)
    for out in runs["ranks"]:
        res = out["update"][case]
        tm = res["metrics"]
        assert set(tm) <= set(jm) and res["draws_left"] == 0
        for k in tm:
            assert abs(tm[k] - float(jm[k])) <= 1e-6 + 1e-4 * abs(float(jm[k])), (k, tm[k], jm[k])
        assert tm["linesearch_success"] == float(jm["linesearch_success"]) == 1.0
        probes = res["collectives"] - (4 + cg_iters + 1)
        assert 1 <= probes <= 10, res["collectives"]


@pytest.mark.parametrize("case", list(CASES))
def test_iteration_params_match_jax_on_two_ranks(runs, case):
    """Both ranks' params bit for bit alike; each policy param's change to 2e-4 of the
    JAX change beside the ulp each side rounds its f32 param to, and each value-tower
    param's change to 2e-4 (tests/test_torch_trpo.py's tolerances)."""
    run = runs["jax"][case]
    a, b = (out["update"][case]["params"] for out in runs["ranks"])
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    want = convert.policy_state_dict(run["jnew"])
    for name, p in a.items():
        base = run["start"][name].double()
        delta_want = want[name].double() - base
        assert float(delta_want.abs().max()) > 0, name
        if name.split(".")[0] in trpo.POLICY_KEYS:
            ulp = torch.from_numpy(np.spacing(np.abs(want[name].numpy()))).double()
            err = (p.double() - base - delta_want).abs()
            assert bool((err <= 2e-4 * delta_want.abs().max() + ulp).all()), name
        else:
            assert rel_err(p.double() - base, delta_want) < 2e-4, name


def test_trpo_learn_on_two_ranks_is_finite_alike_and_logs_the_one_process_episodes(runs):
    """trpo's params finite and bit for bit alike on both ranks (the consistency check
    holds); rank 0 logs every iteration with the one process's EpRewMean and EpLenMean,
    since each rank's draws are its rows of the one-process draws and the monitor takes
    both ranks' episodes; rank 1 writes no row."""
    rank0, rank1 = (out["learners"]["trpo"] for out in runs["ranks"])
    single = runs["single"]["trpo"]
    for k, v in rank0["params"].items():
        assert torch.equal(v, rank1["params"][k]) and bool(torch.isfinite(v).all()), k
    assert rank0["consistent"] and rank1["consistent"]
    assert len(single["rows"]) == len(rank0["rows"]) == 3 and rank1["rows"] == []
    for key in ("EpRewMean", "EpLenMean"):
        np.testing.assert_array_equal([r[key] for r in rank0["rows"]],
                                      [r[key] for r in single["rows"]])
    assert rank0["episodes"] >= 8 and rank0["episodes"] == rank1["episodes"]
    assert torch.equal(rank0["ret_buffer"], rank1["ret_buffer"])


def test_gail_on_two_ranks_is_the_one_process_run(runs):
    """gail is not sharded: each rank runs the whole learner, so both end bit for bit
    where the one process ends, and rank 0 logs the one process's rows but for the
    rate."""
    single = runs["single"]["gail"]
    for rank, out in enumerate(runs["ranks"]):
        res = out["learners"]["gail"]
        assert res["consistent"]
        for k, v in single["params"].items():
            assert torch.equal(res["params"][k], v), (rank, k)
    rows = runs["ranks"][0]["learners"]["gail"]["rows"]
    assert len(rows) == len(single["rows"]) == 3
    for got, want in zip(rows, single["rows"]):
        for k in want:
            if k != "fps":
                assert got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k])), k


def test_trpo_resume_on_two_ranks_reproduces_the_uninterrupted_run(runs):
    """Resumed on two ranks from the checkpoint of iteration 2, trpo ends bit for bit
    where the uninterrupted two-rank run ends, on each rank: params, the value tower's
    Adam moments and count, the rank's envs and observations, the generator's state;
    rank 0 wrote every checkpoint (in the one-process layout) and rank 1 none."""
    def walk(x, y, where):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), where
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), where
            for k in x:
                walk(x[k], y[k], f"{where}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, (a, b) in enumerate(zip(x, y)):
                walk(a, b, f"{where}[{i}]")
        else:
            assert x == y, where

    rank0, rank1 = (out["checkpoints"] for out in runs["ranks"])
    for rank, res in enumerate((rank0, rank1)):
        assert res["full"]["iters"] == res["resumed"]["iters"] == 3
        walk(res["full"]["tree"], res["resumed"]["tree"], f"rank {rank}")
        assert res["full"]["tree"]["state"]["obs"].shape == (4, 4)
    assert rank0["full"]["checkpoints"] == ["00001", "00002", "00003"]
    assert rank0["resumed"]["checkpoints"] == ["00002", "00003"]
    assert rank0["writes"] == ["00001", "00002", "00003", "00003"] and rank1["writes"] == []
    layout = torch.load(runs["workdir"] / "trpo_full" / "checkpoints" / "00003",
                        weights_only=True)
    assert layout["state"]["obs"].shape == (8, 4) and layout["state"]["iters"] == 3
