"""The port's data-parallel layer on two gloo ranks on the CPU (the analog of
tests/test_multidevice.py): psum and pmean, the row gather, the consistency check, the
count-weighted mean of the logger's rows, RunningMeanStd merged over the ranks against
the JAX package's ``shard_map`` on two devices, the sharded draws against a one-process
``Draws``, the state gather, the monitor's episodes folded over the ranks against one
process, and the dry run of every learner, each of which refuses a mesh that is not a
``Mesh``.

The ranks are subprocesses of the test (tests/torch_dist_worker.py) that import nothing
of JAX; the JAX side runs here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_dist_worker import run_ranks

from baselines_tpu.core.running_stats import RunningMeanStd as JaxRunningMeanStd
from baselines_tpu.distributed import DATA_AXIS, data_sharding
from baselines_tpu.distributed import make_mesh as jax_make_mesh
from baselines_tpu_torch.algos import get_learn_function
from baselines_tpu_torch.algos.common import build_env
from baselines_tpu_torch.core.rng import Draws, ShardedDraws
from baselines_tpu_torch.distributed import Mesh, psum
from baselines_tpu_torch.distributed.dryrun import dryrun_multichip
from baselines_tpu_torch.distributed.mesh import shard_state
from baselines_tpu_torch.envs.vec import EpisodeStats

X = (np.random.RandomState(0).randn(64, 3) * 2 + 1).astype(np.float32)
# 40 steps of 140 envs, 70 a rank: most envs end an episode at most steps, all of them
# at step 5, so more than 100 end between two syncs and in one step
_EPISODES = np.random.RandomState(1)
REWARDS = _EPISODES.randn(40, 140).astype(np.float32)
DONES = _EPISODES.rand(40, 140) < 0.6
DONES[5] = True
SYNCS = (9, 10, 25, 39)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("collectives")


@pytest.fixture(scope="module")
def ranks(workdir):
    return run_ranks("collectives", workdir, spec={
        "x": torch.from_numpy(X), "rewards": torch.from_numpy(REWARDS),
        "dones": torch.from_numpy(DONES), "syncs": SYNCS})


def test_psum_and_pmean_over_two_ranks(ranks):
    """Sums over the ranks of a list of f32 tensors in one all-reduce and of an int64
    one, and the means, alike on both ranks; a list of two dtypes is refused."""
    for out in ranks:
        a, b, i64 = out["psum"]
        assert torch.equal(a, torch.full((2, 3), 3.0)) and torch.equal(b, torch.full((5,), 1.5))
        assert torch.equal(i64, torch.arange(4) * 3) and i64.dtype == torch.int64
        assert torch.equal(out["pmean"][0], torch.full((2, 3), 1.5))
        assert torch.equal(out["pmean"][1], torch.full((5,), 0.75))
        assert out["rows"].tolist() == [0, 1, 2, 10, 11, 12]


def test_psum_keeps_a_channels_last_layout(ranks):
    """A channels-last tensor (a conv's gradient may come so) is summed and handed back
    channels-last, so that a norm over it sums in the order it does without a mesh."""
    want = torch.arange(120, dtype=torch.float32).reshape(2, 3, 4, 5) * 3
    for out in ranks:
        got = out["channels_last"]
        assert torch.equal(got, want)
        assert got.is_contiguous(memory_format=torch.channels_last)


def test_all_gather_fields_is_one_call(ranks):
    """Fields of four dtypes and shapes gathered in one call: each the ranks' rows in
    rank order, its dtype kept."""
    want = {"u8": torch.cat([torch.arange(24, dtype=torch.uint8).reshape(2, 3, 4) + 100 * r
                             for r in range(2)]),
            "i32": torch.tensor([-1, 7, -2, 14], dtype=torch.int32),
            "f32": torch.tensor([[0.5], [-2.25], [1.5], [-1.25]]),
            "bool": torch.tensor([True, False, True, True])}
    for out in ranks:
        assert out["fields_calls"] == 1
        assert out["fields"].keys() == want.keys()
        for k, v in want.items():
            assert out["fields"][k].dtype == v.dtype and torch.equal(out["fields"][k], v), k


def test_episode_stats_fold_matches_one_process(ranks):
    """Two ranks' monitors, folded at four syncs, hold the ring, the episode count and
    the steps of one process stepping all 140 envs, and each rank its envs'
    accumulators; a sync is the one collective, and the last leaves nothing pending."""
    whole = EpisodeStats.create(140, "cpu")
    for t in range(len(DONES)):
        whole = whole.update(torch.from_numpy(REWARDS[t]), torch.from_numpy(DONES[t]))
    assert int(whole.episodes) > 1000
    for r, out in enumerate(ranks):
        stats, calls = out["episode_stats"]
        assert calls == len(SYNCS)
        for k in ("ret_buffer", "len_buffer", "episodes", "total_steps"):
            assert torch.equal(getattr(stats, k), getattr(whole, k)), k
        assert torch.equal(stats.ep_return, whole.ep_return[70 * r:70 * (r + 1)])
        assert torch.equal(stats.ep_length, whole.ep_length[70 * r:70 * (r + 1)])
        assert int(stats.n_pending) == int(stats.pending_steps) == 0
        assert not stats.pending.any()


def test_param_consistency_check(ranks):
    """True on replicas; false on both ranks once rank 1's params are moved by 1e-3."""
    assert [out["consistent"] for out in ranks] == [True, True]
    assert [out["perturbed"] for out in ranks] == [False, False]


def test_psum_refuses_mixed_dtypes():
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="one dtype"):
        psum([torch.zeros(2), torch.zeros(2, dtype=torch.float64)], mesh)


def test_host_weighted_mean_and_the_logger(ranks):
    """The count-weighted mean over the processes, (0 * 1 + 1 * 2) / 3 as
    tests/multiproc_worker.py:85-92 has it, both directly and as the logger's
    collective ``dumpkvs`` returns it; a value that is not a number is left out; only
    rank 0 writes (``test_only_rank_0_writes_the_rows``)."""
    for out in ranks:
        assert out["weighted"] == pytest.approx({"probe": 2.0 / 3.0}, rel=1e-12)
        assert out["dumped"]["probe"] == pytest.approx(2.0 / 3.0, rel=1e-6)


def test_only_rank_0_writes_the_rows(workdir, ranks):
    """configure_for_process gives rank 1 a log of its own and no csv."""
    logdir = workdir / "log"
    assert (logdir / "progress.csv").exists()
    assert not (logdir / "progress-proc001.csv").exists()
    assert (logdir / "log-proc001.txt").exists()


def test_running_stats_merge_matches_jax_shard_map(ranks):
    """RunningMeanStd.update(axis_name=mesh) on two shards of randn(64, 3) * 2 + 1
    against the JAX package's update under ``shard_map`` over two devices
    (tests/test_multidevice.py:72-92), to 1e-5; the counts bit for bit."""
    mesh = jax_make_mesh(jax.devices()[:2])

    def f(xs):
        return JaxRunningMeanStd.create((3,)).update(xs, axis_name=DATA_AXIS)

    xs = jax.device_put(jnp.asarray(X), data_sharding(mesh, 2))
    want = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(DATA_AXIS, None),),
                                 out_specs=P()))(xs)
    for out in ranks:
        mean, var, count = out["rms"]
        np.testing.assert_allclose(mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), np.asarray(want.var), rtol=1e-5, atol=1e-5)
        assert float(count) == float(want.count)
        np.testing.assert_allclose(mean.numpy(), X.mean(0), atol=1e-4)


def test_sharded_draws_are_the_one_process_rows(ranks):
    """Each rank's env-axis draws are its rows of what one process draws at the global
    shape from the same seed, and its permutation is its shard's of the W drawn in
    rank order."""
    one = Draws(0, "cpu")
    want = (one.uniform((8, 3), -1.0, 1.0), one.randint(0, 9, (8,)), one.normal((8, 2)),
            [one.permutation(6) for _ in range(2)])
    for rank, out in enumerate(ranks):
        u, i, n, perm = out["draws"]
        rows = slice(4 * rank, 4 * rank + 4)
        assert torch.equal(u, want[0][rows]) and torch.equal(i, want[1][rows])
        assert torch.equal(n, want[2][rows]) and torch.equal(perm, want[3][rank])


def test_sharded_draws_on_one_rank_are_the_draws():
    """A one-rank mesh draws what the plain ``Draws`` draws, so a one-rank run is the
    run without a mesh."""
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    a, b = Draws(3, "cpu"), ShardedDraws(Draws(3, "cpu"), mesh)
    assert torch.equal(a.uniform((5, 2), 0.0, 1.0), b.uniform((5, 2), 0.0, 1.0))
    assert torch.equal(a.permutation(7), b.permutation(7))
    assert torch.equal(a.state_dict()["generator"], b.state_dict()["generator"])


def test_state_gather_and_shard(ranks):
    """gather_state gives the env state one process with all 8 envs holds (the
    observations and the normalization's per-env returns stacked in rank order, the
    monitor's ring and the running statistics as they are, alike on both ranks), and
    shard_state gives each rank its rows back."""
    wholes = [out["state"][1] for out in ranks]
    for rank, out in enumerate(ranks):
        state, whole, back = out["state"]
        assert whole.ret.shape == (8,) and state.ret.shape == (4,)
        inner = whole.inner.inner  # TimeLimitState
        assert inner.t.shape == (8,) and inner.inner.x.shape == (8,)
        assert torch.equal(inner.inner.x[4 * rank:4 * rank + 4], state.inner.inner.inner.x)
        assert torch.equal(whole.ob_rms.mean, state.ob_rms.mean)
        assert float(whole.ob_rms.count) == pytest.approx(1e-4 + 8)
        assert whole.inner.stats.ret_buffer.shape == (100,)
        assert torch.equal(wholes[0].inner.inner.inner.x, whole.inner.inner.inner.x)
        assert torch.equal(back.inner.inner.inner.x, state.inner.inner.inner.x)
        assert torch.equal(back.inner.stats.ep_length, state.inner.stats.ep_length)


def test_local_state_layout_of_a_mesh_of_one():
    """shard_state of a one-rank mesh copies every env leaf as it is and leaves the
    replicated ones alone."""
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    venv = build_env("CartPole-v1", 3, device="cpu")
    _, state = venv.reset(Draws(0, "cpu"))
    back = shard_state(state, mesh)
    assert torch.equal(back.inner.inner.x, state.inner.inner.x)
    assert back.inner.inner.x is not state.inner.inner.x
    assert back.stats.ret_buffer is state.stats.ret_buffer


LEARNERS = ["ppo2", "ppo1", "deepq", "a2c", "trpo", "acktr", "acer", "ddpg", "her", "gail"]


def test_dryrun_multichip_on_two_gloo_ranks():
    """Every learner takes one update (a ddpg or her cycle) on two gloo ranks, and ppo2
    one on the native engine's host pool, with finite params equal on both ranks (the
    port's __graft_entry__.dryrun_multichip)."""
    outs = dryrun_multichip(2, device="cpu")
    for rank, out in enumerate(outs):
        for alg in LEARNERS + ["ppo2 native"]:
            assert f"rank {rank}/2 on cpu: {alg} ok" in out


@pytest.mark.parametrize("alg", LEARNERS)
def test_learners_refuse_what_is_not_a_mesh(alg):
    with pytest.raises(TypeError, match="Mesh"):
        get_learn_function(alg)(env_id="CartPole-v1", total_timesteps=0, device="cpu",
                                mesh="dp")
