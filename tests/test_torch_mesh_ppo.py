"""ppo2's data-parallel update on two gloo ranks against the JAX package's sharded update
(``make_update_fn(..., ndev=2)``, the math of its mesh run, on one CPU device).

Each case runs one update at ``torch_parity.one_ppo_update``'s size. The JAX side draws
at the global shape; each rank of the port is handed its rows of every env-axis draw
(reset states, Gumbel uniforms, identity targets) and its shard's epoch permutations,
drawn from the JAX update's own key splits (ppo.py:263-306, 331-372). The cases:

- ``cnn_s2d``: the main path's network in f32 on AtariSim-v0 packed by VecS2D, 8 envs x
  16 steps, 2 epochs of 2 minibatches, each an equal slice of both ranks' shuffles;
- ``lstm``: recurrent, 8 cells on FixedSequenceEnv(10, episode_len=5), 4 envs, each
  minibatch one whole env of each rank replayed from its carry;
- ``adv_norm_batch``: ppo1's update (``adv_norm="batch"``, ``clip_value=False``) with an
  mlp on DiscreteIdentity-v0, the advantages standardized over both ranks' batches;
- ``microbatch``: ``microbatch_size=16`` on the same env, 8 rows of each rank in each of
  the 4 microbatches of a 64-sample minibatch;
- ``normalize``: a Gaussian head on Pendulum-v1 behind VecNormalize, whose running
  statistics fold in both ranks' observations and returns.

Tolerances as tests/test_torch_update.py: the metrics to 1e-4 relative or 1e-6
absolute, each param's change to 2e-4 of that change; the rollout bit for bit, but on
Pendulum, whose sin/cos and normalization sums round otherwise, to 1e-4 relative or
1e-6 absolute (``torch_parity.ROLLOUT_RTOL``); the two ranks' params bit for bit."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import run_ranks
from torch_parity import (NENVS, ROLLOUT_ATOL, ROLLOUT_RTOL, UPDATE_HPARAMS, ReplayDraws,
                          assert_update_metrics_match, assert_update_params_match, base_env,
                          init_params, mlp_policy_params, policy_params, push_reset,
                          push_rollout_step)

from baselines_tpu.algos.common import adam_optimizer
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.ppo.ppo import PPOTrainState as JaxTrainState
from baselines_tpu.algos.ppo.ppo import make_update_fn as jax_make_update_fn
from baselines_tpu.core.schedules import resolve_fraction_schedule as jax_schedule
from baselines_tpu.envs.testing.fixed_sequence import FixedSequenceEnv as JaxFixedSequence
from baselines_tpu.envs.vec import VecJaxEnv
from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert

NDEV = 2
CASES = {
    "cnn_s2d": dict(env_id="AtariSim-v0", network="cnn_s2d", s2d=4),
    "lstm": dict(env_id="FixedSequence", network="lstm", network_kwargs={"nlstm": 8},
                 nenvs=4),
    "adv_norm_batch": dict(env_id="DiscreteIdentity-v0", network="mlp",
                           options=dict(adv_norm="batch", clip_value=False)),
    "microbatch": dict(env_id="DiscreteIdentity-v0", network="mlp",
                       options=dict(microbatch_size=16)),
    "normalize": dict(env_id="Pendulum-v1", network="mlp", env_kwargs={"normalize": True}),
}


def jax_sharded_update(case: dict):
    """The JAX package's update with ``ndev=2`` from learn()'s make_state, and the draws
    each rank of the port takes: its rows of every rollout draw, then its shard's
    permutation of each epoch."""
    hp = dict(UPDATE_HPARAMS)
    nenvs = case.get("nenvs", NENVS)
    nsteps, noptepochs = hp["nsteps"], hp["noptepochs"]
    network_kwargs = case.get("network_kwargs", {})
    if case["env_id"] == "FixedSequence":
        venv = JaxVecMonitor(VecJaxEnv(JaxFixedSequence(10, episode_len=5), nenvs))
    else:
        venv = jax_build_env(case["env_id"], nenvs, s2d=case.get("s2d", 0),
                             **case.get("env_kwargs", {}))
    ac_space = venv.action_space
    jpol = jax_build_policy(venv.observation_space, ac_space, case["network"],
                            **network_kwargs)
    tx = adam_optimizer(0.5, eps=1e-5)
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    obs, env_state = venv.reset(kreset)
    if case["network"] == "cnn_s2d":
        params = policy_params(0, int(ac_space.n))
    elif case["network"] == "mlp" and hasattr(ac_space, "n"):
        params = mlp_policy_params(0, int(venv.observation_space.n), int(ac_space.n))
    elif case["network"] == "mlp":  # a Gaussian head, logstd at -0.5 (one_ppo_update's)
        width = int(np.prod(ac_space.shape))
        params = mlp_policy_params(0, int(np.prod(venv.observation_space.shape)), width)
        params["params"]["logstd"] = np.full((1, width), -0.5, np.float32)
    else:
        params = init_params(jpol.init, 0, obs)
    state = JaxTrainState(params=params, opt_state=tx.init(params), key=key,
                          env_state=env_state, obs=obs, rnn_state=jpol.initial_state(nenvs),
                          last_done=jnp.zeros((nenvs,), bool),
                          update_idx=jnp.zeros((), jnp.int32))
    update = jax.jit(jax_make_update_fn(jpol, venv, tx, lr_fn=jax_schedule(3e-4),
                                        cliprange_fn=jax_schedule(0.2), ndev=NDEV, **hp,
                                        **case.get("options", {})))
    jnew, jmetrics = update(state)

    base = base_env(venv)
    draws = ReplayDraws()
    push_reset(draws, base, kreset, nenvs)
    k = key
    for _ in range(nsteps):
        k = push_rollout_step(draws, base, k, nenvs, ac_space)
    nl = nenvs // NDEV
    per_rank = [[(kind, v[r * nl:(r + 1) * nl]) for kind, v in draws.queue]
                for r in range(NDEV)]
    n_local = nl if jpol.is_recurrent else nl * nsteps
    for ekey in jax.random.split(k, noptepochs + 1)[1:]:
        for r, skey in enumerate(jax.random.split(ekey, NDEV)):
            per_rank[r].append(("permutation", np.asarray(jax.random.permutation(skey, n_local))))
    spec = dict(env_id=case["env_id"], s2d=case.get("s2d", 0),
                env_kwargs=case.get("env_kwargs", {}), network=case["network"],
                network_kwargs=network_kwargs, nenvs=nenvs, hparams=hp,
                options=case.get("options", {}), start=convert.policy_state_dict(params),
                draws=per_rank)
    return dict(jnew=jnew, jmetrics=jmetrics, reset_obs=np.asarray(obs), spec=spec)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {name: jax_sharded_update(case) for name, case in CASES.items()}
    ranks = run_ranks("ppo_update", tmp_path_factory.mktemp("ppo_update"),
                      spec={"cases": {name: r["spec"] for name, r in jax_runs.items()}})
    return {name: dict(jax_runs[name], ranks=[out[name] for out in ranks])
            for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_update_metrics_match_jax(runs, name):
    """Every metric to 1e-4 relative or 1e-6 absolute, on each rank: the minibatch
    losses are means over both ranks' rows, and explained_variance merges their
    moments."""
    for out in runs[name]["ranks"]:
        assert_update_metrics_match(runs[name]["jmetrics"], out["metrics"])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_update_params_match_jax(runs, name):
    """Each param tensor's change to 2e-4 of the JAX change, and the two ranks' params
    bit for bit (the gradients are averaged before the clip)."""
    run = runs[name]
    a, b = (out["params"] for out in run["ranks"])
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    tpol = types.SimpleNamespace(module=types.SimpleNamespace(state_dict=lambda: a))
    assert_update_params_match(run["jnew"].params, tpol, run["spec"]["start"])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_update_collectives(runs, name):
    """The collectives of one update on each rank: at each minibatch step the gradient
    all-reduce and the advantage moments (once over the batch with adv_norm="batch"),
    one gather of the monitor's episodes for the rollout, and VecNormalize's two merges
    at each env step. The metrics are reduced apart, on the updates that log."""
    spec = runs[name]["spec"]
    hp = spec["hparams"]
    steps = hp["noptepochs"] * hp["nminibatches"]
    advs = 1 if spec["options"].get("adv_norm") == "batch" else steps
    normalize = 2 * hp["nsteps"] if spec["env_kwargs"].get("normalize") else 0
    for out in runs[name]["ranks"]:
        assert out["collectives"] == steps + advs + 1 + normalize


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_rollout_matches_jax(runs, name):
    """Each rank's reset and rollout are its rows of the JAX run's, bit for bit (on
    Pendulum to the rollout tolerance), every draw is taken, and the episode ring is the
    JAX run's whole ring."""
    run = runs[name]
    nl = run["spec"]["nenvs"] // NDEV
    jstats = JaxVecMonitor.get_stats(run["jnew"].env_state)
    if name == "normalize":
        def same(got, want):
            np.testing.assert_allclose(got, want, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)
    else:
        same = np.testing.assert_array_equal
    for r, out in enumerate(run["ranks"]):
        rows = slice(r * nl, (r + 1) * nl)
        assert out["draws_left"] == 0
        same(out["reset_obs"].numpy(), run["reset_obs"][rows])
        same(out["obs"].numpy(), np.asarray(run["jnew"].obs)[rows])
        same(out["ep_return"].numpy(), np.asarray(jstats.ep_return)[rows])
        np.testing.assert_array_equal(out["ep_length"].numpy(), np.asarray(jstats.ep_length)[rows])
        np.testing.assert_array_equal(out["ret_buffer"].numpy(), np.asarray(jstats.ret_buffer))
        assert out["episodes"] == int(jstats.episodes)
    if name == "lstm":  # 16 steps of 5-step episodes: the ring holds both ranks' ends
        assert int(jstats.episodes) == 12
