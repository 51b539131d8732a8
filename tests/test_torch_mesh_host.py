"""Host envs under a data-parallel mesh, on gloo ranks on the CPU
(tests/torch_dist_worker.py): each rank's pool holds its rows of the one-process batch,
its envs seeded by their global index from the one reset seed every rank draws alike.

- The fault this closes: ppo2 on ``native:CartPole-v1`` under a one-rank mesh ran into
  an ``IndexError`` at the pool's reset (its seed was drawn on the env axis). It now
  runs, bit for bit the run without the mesh.
- Two ranks against the JAX package's update on a two-device mesh (``make_update_fn(...,
  ndev=2)``) over its native pool of all 8 envs: each rank handed the JAX side's reset
  seed whole and its rows of the sampling noise, and its shard's epoch permutations.
  Each rank's reset and rollout are its rows of the JAX run's bit for bit; the update's
  metrics and params to ``torch_parity``'s tolerances.
- The same two ranks against the port's one process from one seed over a whole
  ``learn`` of one update in whole-batch minibatches (the ranks shuffle shard by shard,
  as the JAX package's mesh run does, and draw one permutation a rank): the same envs
  in the same order, the params to float sums.
- her on FetchReach-v4 (gymnasium-robotics), one cycle of 2 episodes and 4 train steps,
  on two ranks, one pool of one env each, against one process with a pool of both: the
  same goals in the same buffer slots, the observations and actions to 1e-4 (a rank's
  actor runs on one row, the one process's on two, which round otherwise), and the
  params within tests/test_mesh_learners.py's 5e-3 (Adam turns those roundings into
  steps of up to its learning rate where a gradient is near 0).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import run_ranks
from torch_parity import (UPDATE_HPARAMS, ReplayDraws, assert_update_metrics_match,
                          assert_update_params_match, mlp_policy_params, push_policy_noise)

from baselines_tpu.algos.common import adam_optimizer
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.ppo.ppo import PPOTrainState as JaxTrainState
from baselines_tpu.algos.ppo.ppo import make_update_fn as jax_make_update_fn
from baselines_tpu.core.schedules import resolve_fraction_schedule as jax_schedule
from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.her import her
from baselines_tpu_torch.algos.ppo import ppo

NDEV, NENVS = 2, 8
ENV_ID = "native:CartPole-v1"
PPO_KW = dict(env_id=ENV_ID, network="mlp", seed=5, num_envs=NENVS, nsteps=32,
              nminibatches=4, noptepochs=2, total_timesteps=2 * NENVS * 32, log_interval=1)
# two ranks shuffle shard by shard, so only whole-batch minibatches (and one update, before
# the ranks' epoch draws part from the one process's) take the same samples
PPO_W2_KW = dict(PPO_KW, nminibatches=1, total_timesteps=NENVS * 32)
HER_KW = dict(env_id="FetchReach-v4", seed=2, num_envs=2, n_cycles=1, n_batches=4,
              batch_size=32, buffer_size_episodes=64, n_test_rollouts=2, total_timesteps=100)


def jax_sharded_update() -> dict:
    """The JAX package's ppo2 update with ``ndev=2`` on its native pool of 8 CartPoles,
    from learn()'s key splits, and what each rank of the port takes: the pool's reset
    seed whole (``draws.replicated``), its rows of each step's sampling noise, then its
    shard's permutation of each epoch."""
    hp = dict(UPDATE_HPARAMS)
    nsteps, noptepochs = hp["nsteps"], hp["noptepochs"]
    venv = jax_build_env(ENV_ID, NENVS)
    from baselines_tpu.nn.policy import build_policy as jax_build_policy

    jpol = jax_build_policy(venv.observation_space, venv.action_space, "mlp")
    tx = adam_optimizer(0.5, eps=1e-5)
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    obs, env_state = venv.reset(kreset)
    params = mlp_policy_params(0, 4, 2)
    state = JaxTrainState(params=params, opt_state=tx.init(params), key=key,
                          env_state=env_state, obs=obs, rnn_state=jpol.initial_state(NENVS),
                          last_done=jnp.zeros((NENVS,), bool),
                          update_idx=jnp.zeros((), jnp.int32))
    update = jax.jit(jax_make_update_fn(jpol, venv, tx, lr_fn=jax_schedule(3e-4),
                                        cliprange_fn=jax_schedule(0.2), ndev=NDEV, **hp))
    jnew, jmetrics = update(state)
    jstats = JaxVecMonitor.get_stats(jnew.env_state)
    nl = NENVS // NDEV
    seed = np.asarray(jax.random.randint(kreset, (), 0, 2**31 - 1))
    noise = ReplayDraws()
    k = key
    for _ in range(nsteps):
        k, kact, _ = jax.random.split(k, 3)
        push_policy_noise(noise, kact, NENVS, 2)
    per_rank = [[("randint", seed, True)] + [(kind, v[r * nl:(r + 1) * nl], False)
                                             for kind, v in noise.queue] for r in range(NDEV)]
    for ekey in jax.random.split(k, noptepochs + 1)[1:]:
        for r, skey in enumerate(jax.random.split(ekey, NDEV)):
            per_rank[r].append(("permutation",
                                np.asarray(jax.random.permutation(skey, nl * nsteps)), False))
    venv.close()
    spec = dict(env_id=ENV_ID, s2d=0, env_kwargs={}, network="mlp", network_kwargs={},
                nenvs=NENVS, hparams=hp, options={}, start=convert.policy_state_dict(params),
                draws=per_rank)
    return dict(jnew=jnew, jmetrics=jmetrics, jstats=jstats, reset_obs=np.asarray(obs),
                spec=spec)


def _single(learn, kw):
    """The port's one process: params and, for ppo2, the monitor's ring."""
    model = learn(device="cpu", **kw)
    out = dict(params=model.policy.module.state_dict(), state=model.state)
    if learn is ppo.learn:
        from baselines_tpu_torch.envs.vec import VecMonitor

        out["stats"] = VecMonitor.get_stats(model.state.env_state)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One pair of rank processes for the file: the whole learns first, then the update
    held against the JAX reference, which the test process computes meanwhile, with the
    port's one-process learns."""
    single, jax_ref = {}, {}

    def later():
        jax_ref.update(jax_sharded_update())
        single["ppo2"] = _single(ppo.learn, dict(PPO_KW, pipeline=False))
        single["ppo2_w2"] = _single(ppo.learn, dict(PPO_W2_KW, pipeline=False))
        single["her"] = _single(her.learn, HER_KW)
        return {"update": {"cases": {"native": jax_ref["spec"]}}}

    tasks = {"learn": ("learners", {"runs": {"ppo2": ("ppo2", PPO_W2_KW), "her": ("her", HER_KW)}}),
             "update": ("ppo_update", None)}
    ranks = run_ranks("sequence", tmp_path_factory.mktemp("mesh_host"),
                      spec={"tasks": tasks}, later=later)
    return dict(ranks=ranks, single=single, jax=jax_ref)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """ppo2 on the native pool under a one-rank mesh, in a process of its own."""
    out, = run_ranks("learners", tmp_path_factory.mktemp("one_rank"), world=1,
                     spec={"runs": {"ppo2": ("ppo2", PPO_KW)}})
    return out["ppo2"]


def test_one_rank_mesh_runs_a_host_env_bit_for_bit(one_rank, runs):
    """ppo2 on native:CartPole-v1 under a one-rank mesh runs (it raised an IndexError
    at the pool's reset) and ends with the params and episodes of the run without the
    mesh, bit for bit."""
    single = runs["single"]["ppo2"]
    assert one_rank["consistent"]
    for k, v in single["params"].items():
        assert torch.equal(one_rank["params"][k], v), k
    assert torch.equal(one_rank["ret_buffer"], single["stats"].ret_buffer)
    assert one_rank["episodes"] == int(single["stats"].episodes) > 0
    assert len(one_rank["rows"]) == 2


def test_two_ranks_rollout_matches_jax_mesh(runs):
    """Each rank's reset and rollout are its rows of the JAX two-device run over one
    pool, bit for bit: its pool seeds its envs as the JAX pool seeds those rows; the
    episode ring is the JAX run's; every recorded draw was taken, the seed whole."""
    ref = runs["jax"]
    nl = NENVS // NDEV
    for r, rank in enumerate(runs["ranks"]):
        out = rank["update"]["native"]
        rows = slice(r * nl, (r + 1) * nl)
        assert out["draws_left"] == 0
        np.testing.assert_array_equal(out["reset_obs"].numpy(), ref["reset_obs"][rows])
        np.testing.assert_array_equal(out["obs"].numpy(), np.asarray(ref["jnew"].obs)[rows])
        np.testing.assert_array_equal(out["ep_length"].numpy(),
                                      np.asarray(ref["jstats"].ep_length)[rows])
        np.testing.assert_array_equal(out["ret_buffer"].numpy(),
                                      np.asarray(ref["jstats"].ret_buffer))
        assert out["episodes"] == int(ref["jstats"].episodes) > 0


def test_two_ranks_update_matches_jax_mesh(runs):
    """The update's metrics to 1e-4 relative or 1e-6 absolute on each rank, each param
    tensor's change to 2e-4 of the JAX change, and the two ranks' params bit for bit."""
    ref = runs["jax"]
    a, b = (rank["update"]["native"]["params"] for rank in runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    for rank in runs["ranks"]:
        assert_update_metrics_match(ref["jmetrics"], rank["update"]["native"]["metrics"])
    tpol = types.SimpleNamespace(module=types.SimpleNamespace(state_dict=lambda: a))
    assert_update_params_match(ref["jnew"].params, tpol, ref["spec"]["start"])


@pytest.mark.parametrize("alg", ["ppo2", "her"])
def test_two_ranks_learn_matches_one_process(runs, alg):
    """A whole learn on two ranks against the port's one process from the same seed:
    the params held equal on both ranks; for ppo2 within float sums of the one
    process's, and the episodes of the same envs in the same order (the monitor's
    ring); for her the same goals in the same slots of the episode buffer, the
    observations and actions to 1e-4, and the params within 5e-3."""
    rank0, rank1 = (rank["learn"][alg] for rank in runs["ranks"])
    single = runs["single"]["ppo2_w2" if alg == "ppo2" else alg]
    assert rank0["consistent"] and rank1["consistent"]
    assert rank1["rows"] == [] and len(rank0["rows"]) >= 1
    if alg == "ppo2":
        for k, v in single["params"].items():
            torch.testing.assert_close(rank0["params"][k], v, rtol=1e-4, atol=1e-6)
        assert torch.equal(rank0["ret_buffer"], single["stats"].ret_buffer)
        assert rank0["episodes"] == rank1["episodes"] == int(single["stats"].episodes) > 0
        return
    for k, v in single["params"].items():
        torch.testing.assert_close(rank0["params"][k], v, rtol=0.0, atol=5e-3)
    ours, theirs = rank0["buffer"], single["state"].buffer
    assert ours.n_episodes == theirs.n_episodes == 2
    assert torch.equal(ours.g, theirs.g)
    for k in ("o", "ag", "u"):
        torch.testing.assert_close(getattr(ours, k), getattr(theirs, k), rtol=0.0, atol=1e-4)
