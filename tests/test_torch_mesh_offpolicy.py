"""ddpg, her, acer and acktr under a data-parallel mesh, on two gloo ranks on the CPU
(tests/torch_dist_worker.py, one pair of processes for the whole file).

Against the JAX learner on the whole batch, from the same converted weights, each rank
handed its rows of every env-axis draw and every replicated draw whole, each draw checked
to be taken from the stream it was recorded for (``draws.replicated`` or the env axis):
- ddpg: one cycle of 4 envs (2 a rank) of each case of tests/test_torch_ddpg.py, held
  as that file holds the one process's: the replay, the statistics, the rank's rows of
  the OU state, the params and targets (2e-4 of the JAX change).
- her: one cycle of 4 episodes (2 a rank), held as tests/test_torch_her.py holds the one
  process's: the episode buffer, the normalizers, the params and targets.
- acer: one on-policy update, then one replay update, of 4 envs (2 a rank) of each case
  of tests/test_torch_acer.py: params, average params and RMSProp's nu to 1e-4 relative.
- acktr: two updates (a cold-start step, then a K-FAC step) of 8 envs: the factors are
  the whole batch's only when the ranks' moments are averaged and each row is scaled by
  the whole batch's size. Tolerances as tests/test_torch_acktr.py (1e-4 relative).

Against the port's one process from the same seed:
- acer: one on-policy update, then one replay update, within 1e-4 relative: each rank
  trains on its env rows and the gradients are averaged, with the flat replay layout
  and with the frame-deduplicated one.
- Whole ``learn`` runs at tests/test_mesh_learners.py:84-117's configurations (logged
  more often): ddpg, her and acer within that file's 5e-3 of the port's one process;
  acktr finite and bit for bit alike on both ranks (that file's ``compare=False``);
  every learner's params held equal by ``param_consistency_check``, and the logged
  episode statistics the one process's.
"""

import math

import jax
import numpy as np
import pytest
import torch
from test_torch_acer import CASES as ACER_JAX_CASES
from test_torch_acer import check_updates as check_acer_updates
from test_torch_acer import jax_two_chunks
from test_torch_ddpg import CYCLE_CASES, ROLLOUT, TRAINS, check_cycle_state
from test_torch_ddpg import check_cycle_params as check_ddpg_params
from test_torch_ddpg import jax_cycle as jax_ddpg_cycle
from test_torch_her import CYCLE_KW as HER_KW
from test_torch_her import check_cycle_buffer_and_normalizers
from test_torch_her import check_cycle_params as check_her_params
from test_torch_her import jax_cycle as jax_her_cycle
from torch_dist_worker import RecordingOutput, acer_two_updates, run_ranks
from torch_parity import RankShares, base_env, move_params, push_reset, push_rollout_step, rel_err

from baselines_tpu.algos import common as jax_common
from baselines_tpu.algos.acktr import acktr as jacktr
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.core import logger as jax_logger
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos import get_learn_function
from baselines_tpu_torch.algos.acktr import acktr
from baselines_tpu_torch.core import logger
from baselines_tpu_torch.envs.registry import make_env

NDEV, NENVS, NSTEPS = 2, 8, 8
ACKTR_CASES = {"mlp": ("DiscreteIdentity-v0", "mlp"),
               "cnn_small": ("ImageIdentity-v0", "cnn_small")}
ACKTR_HPARAMS = dict(cold_iter=1, kfac_update=1, gamma=0.9, lr=0.25, kfac_clip=0.001)


def _jax_acktr(case: str) -> dict:
    """The JAX learner's two updates on the whole batch (tests/test_torch_acktr.py's
    ``two_updates``) and the spec of each rank's half: its rows of each rollout draw,
    then each update's Fisher noise whole."""
    env_id, network = ACKTR_CASES[case]
    jvenv = jax_build_env(env_id, NENVS)
    starts = []

    def start_from_moved(make_state, key):
        state = make_state(key)
        state = state.replace(params=move_params(state.params, 3))
        starts.append(jax.device_get(state))
        return jax_common.dealias(state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "jit_init", start_from_moved)
        mp.setattr(jax_logger, "logkv", lambda k, v: None)
        mp.setattr(jax_logger, "dumpkvs", lambda: None)
        jmodel = jacktr.learn(env_id=env_id, network=network, seed=0, num_envs=NENVS,
                              nsteps=NSTEPS, total_timesteps=2 * NENVS * NSTEPS,
                              log_interval=1, **ACKTR_HPARAMS)
    jstart, = starts

    base = base_env(jvenv)
    shares = RankShares(NDEV)
    _, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    push_reset(shares.env, base, kreset, NENVS)
    k = jstart.key
    for _ in range(2):
        for _ in range(NSTEPS):
            k = push_rollout_step(shares.env, base, k, NENVS, jvenv.action_space)
        k, knoise = jax.random.split(k)
        shares.whole.push("normal", jax.random.normal(knoise, (NENVS * NSTEPS,)))
    tenv = make_env(env_id)
    net = acktr.KfacPolicyNet(tenv.observation_space, tenv.action_space, network)
    start = convert.kfac_state_dict(jstart.params, net.conv_out_hw)
    hparams = dict(ACKTR_HPARAMS, nsteps=NSTEPS, ent_coef=0.01, vf_coef=0.5,
                   vf_fisher_coef=1.0, max_grad_norm=0.5, lrschedule="linear", epsilon=0.01,
                   stats_decay=0.99, momentum=0.9, nupdates=2)
    return dict(jnew=jax.device_get(jmodel.state), start=start, conv_hw=net.conv_out_hw,
                names=[n for n, _ in net.named_parameters()],
                spec=dict(env_id=env_id, network=network, nenvs=NENVS, hparams=hparams,
                          start=start, draws=shares.ranks))


CYCLE_NENVS = 4  # ddpg's envs and her's and acer's (tests/test_torch_her.py, test_torch_acer.py)


def _jax_cycles() -> dict:
    """The JAX learner's ddpg cycles, her cycle and acer updates on the whole batch of
    ``CYCLE_NENVS`` envs, each with the spec of the ranks' runs: the start weights and
    each rank's recording of the draws."""
    out = {}
    for case in CYCLE_CASES:
        shares = RankShares(NDEV)
        run = jax_ddpg_cycle(case, CYCLE_NENVS, shares.env, shares.whole)
        out[f"ddpg_{case}"] = dict(run, spec=dict(run["spec"], draws=shares.ranks))
    shares = RankShares(NDEV)
    jend, start = jax_her_cycle(shares.env, shares.whole)
    out["her"] = dict(jend=jend, start=start,
                      spec=dict(kwargs=HER_KW, start=start, draws=shares.ranks))
    for case in ACER_JAX_CASES:
        shares = RankShares(NDEV)
        run = jax_two_chunks(case, shares.env)
        out[f"acer_{case}"] = dict(run, spec=dict(run["case"], start=run["start"],
                                                  draws=shares.ranks))
    return out


ACER_CASES = {
    "flat": dict(env_id="DiscreteIdentity-v0", num_envs=8, nsteps=8, seed=0),
    "dedup": dict(env_id="CartPole-v1", num_envs=8, nsteps=8, seed=1, frame_stack=2,
                  dedup_frames=2),
}

# tests/test_mesh_learners.py:84-117, each logged more often
RUNS = {
    "ddpg": ("ddpg", dict(env_id="BoxIdentity-v0", network="mlp", total_timesteps=1024,
                          seed=0, num_envs=8, gamma=0.9, actor_lr=1e-3, critic_lr=1e-3,
                          log_interval=1)),
    "acer": ("acer", dict(env_id="DiscreteIdentity-v0", network="mlp", total_timesteps=2048,
                          seed=0, num_envs=8, nsteps=16, replay_start=512, buffer_size=2048,
                          replay_ratio=2, log_interval=4)),
    "acktr": ("acktr", dict(env_id="DiscreteIdentity-v0", network="mlp",
                            total_timesteps=1600, seed=0, num_envs=8, nsteps=20, gamma=0.9,
                            log_interval=5)),
    "her": ("her", dict(env_id="PointReach-v0", network="mlp", total_timesteps=8192, seed=0,
                        num_envs=16, n_cycles=2, n_batches=4, batch_size=64,
                        n_test_rollouts=0, log_interval=1)),
}
LOGGED = {"ddpg": ("rollout/return_history", "total/steps"),
          "acer": ("mean_episode_reward", "total_timesteps"),
          "acktr": ("eprewmean", "total_timesteps"),
          "her": ("train/episode", "train/success_rate", "test/success_rate")}


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
    """The ranks' runs; the JAX references are computed while the ranks run the tasks
    that need none, and the port's one-process runs after."""
    refs = {}

    def jax_refs() -> dict:
        refs.update(acktr={name: _jax_acktr(name) for name in ACKTR_CASES}, cycles=_jax_cycles())
        cycles = refs["cycles"]
        return {"acktr": {"cases": {n: r["spec"] for n, r in refs["acktr"].items()}},
                "cycles": {"ddpg": {c: cycles[f"ddpg_{c}"]["spec"] for c in CYCLE_CASES},
                           "her": cycles["her"]["spec"]},
                "acer_jax": {"cases": {c: cycles[f"acer_{c}"]["spec"] for c in ACER_JAX_CASES}}}

    tasks = {"acer": ("acer_updates", {"cases": ACER_CASES}),
             "learners": ("learners", {"runs": RUNS}),
             "acktr": ("acktr_update", None), "cycles": ("cycles", None),
             "acer_jax": ("acer_updates", None)}
    ranks = run_ranks("sequence", tmp_path_factory.mktemp("mesh_offpolicy"),
                      spec={"tasks": tasks}, later=jax_refs)
    return dict(jax=refs["acktr"], cycles=refs["cycles"], ranks=ranks,
                acer={name: acer_two_updates(case) for name, case in ACER_CASES.items()},
                single={name: _one_process(*run) for name, run in RUNS.items()})


@pytest.mark.parametrize("case", list(ACKTR_CASES))
def test_acktr_updates_on_two_ranks_match_jax(runs, case):
    """After the cold-start step and the K-FAC step on two ranks: each param's change
    and each momentum tensor to 1e-4 relative of the JAX learner's on the whole batch;
    both ranks' params, momentum and factors bit for bit alike; every draw taken; the
    collectives: the monitor's gather, the gradient's all-reduce and the factor
    moments' all-reduce an update."""
    run = runs["jax"][case]
    want = convert.kfac_state_dict(run["jnew"].params, run["conv_hw"])
    jmom = convert.kfac_state_dict(run["jnew"].kfac.momentum, run["conv_hw"])
    outs = [out["acktr"][case] for out in runs["ranks"]]
    for out in outs:
        assert out["step"] == 2 and out["draws_left"] == 0 and out["collectives"] == 2 * 3
        for name, p in out["params"].items():
            base = run["start"][name].double()
            delta_want = want[name].double() - base
            assert float(delta_want.abs().max()) > 0, name
            assert rel_err(p.double() - base, delta_want) < 1e-4, name
        for name, m in zip(run["names"], out["momentum"]):
            assert rel_err(m.double(), jmom[name].double()) < 1e-4, name
    a, b = outs
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"]))
    for (A0, S0), (A1, S1) in zip(a["factors"], b["factors"]):
        assert torch.equal(A0, A1) and torch.equal(S0, S1)
        assert not torch.equal(A0, torch.eye(A0.shape[0]))
    assert a["metrics"] == b["metrics"]


def _alike(a, b) -> None:
    """Two ranks' modules (or state dicts) bit for bit alike."""
    sa, sb = (m if isinstance(m, dict) else m.state_dict() for m in (a, b))
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("case", list(CYCLE_CASES))
def test_ddpg_cycle_on_two_ranks_matches_jax(runs, case):
    """One ddpg cycle of 4 envs on two ranks (2 each) against the JAX learner's cycle on
    the whole batch: on each rank the reset and the OU state are its envs' rows, and the
    replay, the statistics, the params and the targets as tests/test_torch_ddpg.py holds
    the one process's; every draw taken, each from the stream it was recorded for; the
    collectives: a gather a rollout step, the monitor's sync, the actor's and the
    critic's gradient all-reduce a train step. Both ranks' params bit for bit alike."""
    run = runs["cycles"][f"ddpg_{case}"]
    outs = [out["cycles"][f"ddpg_{case}"] for out in runs["ranks"]]
    nl = CYCLE_NENVS // NDEV
    for rank, out in enumerate(outs):
        rows = slice(rank * nl, (rank + 1) * nl)
        np.testing.assert_allclose(out["reset_obs"].numpy(), np.asarray(run["jstart"].obs)[rows],
                                   rtol=1e-6, atol=1e-7)
        assert out["draws_left"] == 0 and out["collectives"] == ROLLOUT + 1 + 2 * TRAINS
        check_cycle_state(case, CYCLE_NENVS, run["jend"], out["state"], out["losses"], rows)
        check_ddpg_params(run["jend"], run["spec"]["start"], out["actor"], out["critic"],
                          out["state"])
    for m in ("actor", "critic"):
        _alike(outs[0][m], outs[1][m])


def test_her_cycle_on_two_ranks_matches_jax(runs):
    """One her cycle of 4 episodes on two ranks (2 each) against the JAX learner's cycle
    on the whole batch: on each rank the stored episodes, the normalizers, the params
    and the targets as tests/test_torch_her.py holds the one process's; every draw taken,
    each from the stream it was recorded for; the collectives: the episodes' gather and
    two gradient all-reduces a train step. Both ranks' params bit for bit alike."""
    run = runs["cycles"]["her"]
    outs = [out["cycles"]["her"] for out in runs["ranks"]]
    for out in outs:
        assert out["draws_left"] == 0 and out["collectives"] == 1 + 2 * HER_KW["n_batches"]
        check_cycle_buffer_and_normalizers(run["jend"], out["state"])
        check_her_params(run["jend"], run["start"], out["actor"], out["critic"], out["state"])
        assert all(bool(torch.isfinite(x)) for x in out["losses"])
    for m in ("actor", "critic"):
        _alike(outs[0][m], outs[1][m])


@pytest.mark.parametrize("case", list(ACER_JAX_CASES))
def test_acer_updates_on_two_ranks_match_jax(runs, case):
    """An acer on-policy update, then a replay update, of 4 envs on two ranks (2 each)
    against the JAX learner's on the whole batch: on each rank the reset its envs' rows,
    the params, the average params and RMSProp's nu as tests/test_torch_acer.py holds the
    one process's; every draw taken (the replay's chunk indices the rank's rows). Both
    ranks' params bit for bit alike."""
    run = runs["cycles"][f"acer_{case}"]
    outs = [out["acer_jax"][case] for out in runs["ranks"]]
    nl = CYCLE_NENVS // NDEV
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["reset_obs"].numpy(),
                                      np.asarray(run["jstart"].obs)[rank * nl:(rank + 1) * nl])
        assert out["draws_left"] == 0
        check_acer_updates(run["jnew"], run["start"], out)
    _alike(outs[0]["replay"]["params"], outs[1]["replay"]["params"])


@pytest.mark.parametrize("case", list(ACER_CASES))
@pytest.mark.parametrize("kind", ["onpolicy", "replay"])
def test_acer_updates_on_two_ranks_match_one_process(runs, case, kind):
    """An on-policy update, then a replay update of a chunk sampled for all 8 envs, on
    two ranks (4 env rows each): each param's and each average-policy param's change
    from the start to 1e-4 relative of the one process's, the metrics to 1e-4 relative
    (1e-6 absolute), and both ranks' params bit for bit alike; both rings hold the one
    process's 8 chunks."""
    single = runs["acer"][case]
    outs = [out["acer"][case] for out in runs["ranks"]]
    for out in outs:
        assert out["replay_size"] == single["replay_size"] == 8
        for field in ("params", "avg"):
            for name, p in out[kind][field].items():
                base = single["start"][name].double()
                delta_want = single[kind][field][name].double() - base
                assert float(delta_want.abs().max()) > 0, (field, name)
                assert rel_err(p.double() - base, delta_want) < 1e-4, (field, name)
        for k, want in single[kind]["metrics"].items():
            got = out[kind]["metrics"][k]
            assert abs(got - want) <= 1e-6 + 1e-4 * abs(want), (k, got, want)
    a, b = (out[kind]["params"] for out in outs)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", ["ddpg", "her", "acer"])
def test_learn_on_two_ranks_matches_one_process(runs, name):
    """The params within tests/test_mesh_learners.py:130's 5e-3 of the one process's
    and bit for bit alike on both ranks."""
    single = runs["single"][name]["params"]
    a, b = (out["learners"][name] for out in runs["ranks"])
    for k, want in single.items():
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert bool(torch.isfinite(a["params"][k]).all()), k
        torch.testing.assert_close(a["params"][k], want, atol=5e-3, rtol=5e-3)


def test_acktr_learn_on_two_ranks_is_finite_and_alike(runs):
    a, b = (out["learners"]["acktr"] for out in runs["ranks"])
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]) and bool(torch.isfinite(v).all()), k


@pytest.mark.parametrize("name", list(RUNS))
def test_learn_on_two_ranks_logs_the_one_process_episodes(runs, name):
    """``param_consistency_check`` true on both ranks; rank 0 logs the one process's
    rows of episode statistics (rank 1 writes none), and the monitor's ring, where the
    learner has one, is the one process's on both ranks."""
    rank0, rank1 = (out["learners"][name] for out in runs["ranks"])
    single = runs["single"][name]
    assert rank0["consistent"] and rank1["consistent"]
    assert len(rank0["rows"]) == len(single["rows"]) >= 1 and rank1["rows"] == []
    for got, want in zip(rank0["rows"], single["rows"]):
        for key in LOGGED[name]:
            assert got[key] == want[key] or (math.isnan(got[key]) and math.isnan(want[key])), (
                key, got[key], want[key])
    if name != "her":
        assert rank0["episodes"] == rank1["episodes"] > 0
        assert torch.equal(rank0["ret_buffer"], rank1["ret_buffer"])


def test_her_refuses_a_host_goal_env_under_a_mesh():
    """her no longer refuses a host goal env under a mesh: the pools' one reset seed is
    drawn from the replicated draws, and rank r's pools hold its envs, seeded by their
    global index (tests/test_torch_mesh_host.py runs it on two ranks). Here rank 1 of a
    mesh of 2 builds its pools of one env each, env 1 of the whole batch, and resets
    them without a collective."""
    from baselines_tpu_torch.distributed import Mesh

    mesh = Mesh(group=None, rank=1, size=2, device=torch.device("cpu"))
    model = get_learn_function("her")(env_id="FetchReach-v4", num_envs=2, total_timesteps=0,
                                      device="cpu", mesh=mesh, seed=0)
    assert model.state.obs["observation"].shape == (1, 10) and model.state.env_state == 0
