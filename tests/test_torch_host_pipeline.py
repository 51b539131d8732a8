"""The port's pipelined host env pair (baselines_tpu_torch/envs/host_pipeline.py and
algos/common.py's init_pipe_state / run_rollout_pipelined) on the CPU.

On the counting fixture of tests/test_host_pipeline.py (``CountingHost``, a
deterministic host pool, and ``StubPolicy``, whose outputs are functions of the obs),
ported here: the trajectory and last value against the JAX package's
``run_rollout_pipelined`` exactly, against the port's serial ``run_rollout``, the
order of submits and collects, and VecNormalize's statistics after a rollout against
the JAX package's (to f32 rounding: the two sum in another order). Then one pipelined
ppo2 update with mlp on native:CartPole-v1, 4 envs x 16 steps, against the JAX
package's ``make_update_fn(pipelined=True)``: the same weights (convert.py), the JAX
draws replayed in the pipelined body's key-split order, the metrics and params within
test_torch_update.py's tolerances and the env state bit for bit."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_host_pipeline import CountingHost as JaxCountingHost
from test_host_pipeline import StubPolicy as JaxStubPolicy
from torch_dist_worker import ReplayDraws
from torch_parity import (UPDATE_HPARAMS, assert_update_metrics_match,
                          assert_update_params_match, mlp_policy_params, push_epochs,
                          push_policy_noise)

from baselines_tpu.algos.common import adam_optimizer
from baselines_tpu.algos.common import build_env_pair as jax_build_env_pair
from baselines_tpu.algos.common import init_pipe_state as jax_init_pipe_state
from baselines_tpu.algos.common import run_rollout_pipelined as jax_run_rollout_pipelined
from baselines_tpu.algos.ppo.ppo import PPOTrainState as JaxTrainState
from baselines_tpu.algos.ppo.ppo import make_update_fn as jax_make_update_fn
from baselines_tpu.core.schedules import resolve_fraction_schedule as jax_schedule
from baselines_tpu.envs.callback_env import CallbackVecEnv as JaxCallbackVecEnv
from baselines_tpu.envs.host_pipeline import PipelinedHostVecPair as JaxPair
from baselines_tpu.envs.vec import VecMonitor as JaxVecMonitor
from baselines_tpu.envs.vec import VecNormalize as JaxVecNormalize
from baselines_tpu.envs.vec import find_normalize_state as jax_find_normalize_state
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import (ClipAdam, build_env_pair, init_pipe_state,
                                              run_rollout, run_rollout_pipelined)
from baselines_tpu_torch.algos.ppo.ppo import PPOTrainState, make_update_fn
from baselines_tpu_torch.core.schedules import resolve_fraction_schedule
from baselines_tpu_torch.envs.callback_env import CallbackVecEnv
from baselines_tpu_torch.envs.gym_bridge import HostVecEnv
from baselines_tpu_torch.envs.host_pipeline import PipelinedHostVecPair, PipeState
from baselines_tpu_torch.envs.spaces import Box
from baselines_tpu_torch.envs.vec import VecMonitor, VecNormalize, find_normalize_state
from baselines_tpu_torch.nn.policy import build_policy


class CountingHost(HostVecEnv):
    """tests/test_host_pipeline.py:29-72 on the port's spaces: counter += action + 1 a
    step, the reward the new counter, done (and a reset to 0, the terminal obs in the
    info) when it reaches ``limit``; submits and collects go into ``log``."""

    def __init__(self, n, limit=7.0, log=None, name=""):
        self.num_envs = n
        self.observation_space = Box(np.full((1,), -np.inf, np.float32),
                                     np.full((1,), np.inf, np.float32))
        self.action_space = Box(np.full((1,), -10.0, np.float32),
                                np.full((1,), 10.0, np.float32))
        self._c = np.zeros((n, 1), np.float32)
        self.limit = float(limit)
        self.log = log if log is not None else []
        self.name = name
        self._pending = None

    def reset(self, seed=None):
        self._c[:] = 0.0
        return self._c.copy()

    def step_async(self, actions):
        self.log.append(("submit", self.name))
        self._pending = np.asarray(actions, np.float32).reshape(self.num_envs, 1)

    def step_wait(self):
        self.log.append(("collect", self.name))
        self._c = self._c + self._pending + 1.0
        rew = self._c[:, 0].copy()
        done = self._c[:, 0] >= self.limit
        obs, infos = self._c.copy(), []
        for i in range(self.num_envs):
            info = {}
            if done[i]:
                info["terminal_observation"] = obs[i].copy()
                self._c[i] = 0.0
                obs[i] = 0.0
            infos.append(info)
        return obs, rew.astype(np.float32), done, infos

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()


class StubPolicy:
    """tests/test_host_pipeline.py:75-98 with the port's policy interface: action,
    value and neglogp functions of the obs, no draws."""

    is_recurrent = False
    pdtype = SimpleNamespace(sample_shape=(1,), sample_dtype=torch.float32)

    def pack(self):
        return None

    def step(self, obs, draws, packed=None, rnn_state=None, mask=None):
        return torch.remainder(obs, 2.0) * 0.25, obs[..., 0] * 0.1, obs[..., 0] * 0.01 + 1.0

    def value(self, obs, packed=None, rnn_state=None, mask=None):
        return obs[..., 0] * 0.1

    def initial_state(self, n):
        return None


def _chain(host, normalize=False):
    venv = VecMonitor(CallbackVecEnv(host, device="cpu"))
    return VecNormalize(venv) if normalize else venv


def _jax_chain(host, normalize=False):
    venv = JaxVecMonitor(JaxCallbackVecEnv(host))
    return JaxVecNormalize(venv) if normalize else venv


def _seed_draws(*keys) -> ReplayDraws:
    """The reset seeds the JAX CallbackVecEnvs draw from ``keys``."""
    draws = ReplayDraws()
    for key in keys:
        draws.push("randint", jax.random.randint(key, (), 0, 2**31 - 1))
    return draws


def _pipelined_pair(limit=7.0, n=2, normalize=False, log=None):
    """Both sides' pairs of ``n`` counting envs a group, primed and rolled out for 12
    steps from keys 1 and 2: ((jax ps, traj, last value), (port ps, traj, last value))."""
    T = 12
    jpair = JaxPair(_jax_chain(JaxCountingHost(n, limit), normalize),
                    _jax_chain(JaxCountingHost(n, limit), normalize))
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    jps = jax_init_pipe_state(JaxStubPolicy(), jpair, None, key, jpair.a.reset(k1),
                              jpair.b.reset(k2))
    _, jps, jtraj, jlast = jax_run_rollout_pipelined(JaxStubPolicy(), jpair, None, key, jps, T)

    log = [] if log is None else log
    pair = PipelinedHostVecPair(_chain(CountingHost(n, limit, log, "A"), normalize),
                                _chain(CountingHost(n, limit, log, "B"), normalize))
    draws = _seed_draws(k1, k2)
    ps = init_pipe_state(StubPolicy(), pair, draws, pair.a.reset(draws), pair.b.reset(draws))
    assert not draws.queue
    log.clear()
    ps, traj, last = run_rollout_pipelined(StubPolicy(), pair, None, ps, T)
    return (jps, jtraj, jlast), (ps, traj, last)


@pytest.mark.parametrize("limit", [7.0, 3.0])
def test_pipelined_rollout_matches_jax(limit):
    """The trajectory's every field and the last value equal the JAX package's bit for
    bit, group A in the first columns and B in the last, over auto-resets; so do the
    monitors' merged statistics and the final obs of A and the step in flight of B."""
    (jps, jtraj, jlast), (ps, traj, last) = _pipelined_pair(limit)
    for f in ("obs", "actions", "values", "neglogps", "rewards", "dones", "rnn_masks"):
        np.testing.assert_array_equal(getattr(traj, f).numpy(),
                                      np.asarray(getattr(jtraj, f)), err_msg=f)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    assert bool(traj.dones.any())
    np.testing.assert_array_equal(ps.obs_a.numpy(), np.asarray(jps.obs_a))
    np.testing.assert_array_equal(ps.pend_obs_b.numpy(), np.asarray(jps.pend_obs_b))
    np.testing.assert_array_equal(ps.pend_act_b.numpy(), np.asarray(jps.pend_act_b))
    ours, theirs = PipelinedHostVecPair.get_stats(ps), JaxPair.get_stats(jps)
    assert int(ours.episodes) == int(theirs.episodes) > 0
    np.testing.assert_array_equal(ours.mean_return.numpy(), np.asarray(theirs.mean_return))
    np.testing.assert_array_equal(VecMonitor.get_stats(ps).mean_length.numpy(),
                                  np.asarray(JaxVecMonitor.get_stats(jps).mean_length))


def test_pipelined_equals_serial_rollout():
    """Two groups of one counting env pipelined give the serial run_rollout's trajectory
    and last value over two counting envs, exactly."""
    T = 10
    fused = _chain(CountingHost(2))
    draws = _seed_draws(jax.random.PRNGKey(1))
    obs, env_state = fused.reset(draws)
    _, _, _, traj_f, last_f, _ = run_rollout(StubPolicy(), fused, None, env_state, obs,
                                             torch.zeros((2,), dtype=torch.bool), T)
    pair = PipelinedHostVecPair(_chain(CountingHost(1)), _chain(CountingHost(1)))
    draws = _seed_draws(jax.random.PRNGKey(1), jax.random.PRNGKey(2))
    ps = init_pipe_state(StubPolicy(), pair, draws, pair.a.reset(draws), pair.b.reset(draws))
    ps, traj_p, last_p = run_rollout_pipelined(StubPolicy(), pair, None, ps, T)
    for f in ("obs", "actions", "values", "neglogps", "rewards", "dones", "rnn_masks"):
        assert torch.equal(getattr(traj_f, f), getattr(traj_p, f)), f
    assert torch.equal(last_f, last_p)
    assert isinstance(ps, PipeState)


def test_pipelined_overlap_interleaving():
    """Each step submits A, collects B, submits B, then collects A
    (tests/test_host_pipeline.py:163-183): group A's envs step while the device
    computes group B's next actions."""
    log = []
    _pipelined_pair(log=log)
    body = [("submit", "A"), ("collect", "B"), ("submit", "B"), ("collect", "A")]
    assert log == body * 12, log[:8]


def test_pipelined_normalize_stats_match_jax():
    """Under VecNormalize both groups start from the union of their reset statistics and
    are merged after the rollout: ob_rms and ret_rms of both groups equal, and equal the
    JAX package's to 1e-6 relative (f32 sums in another order); the normalized
    trajectory too."""
    (jps, jtraj, _), (ps, traj, _) = _pipelined_pair(limit=5.0, n=3, normalize=True)
    na, nb, jn = find_normalize_state(ps.state_a), find_normalize_state(ps.state_b), \
        jax_find_normalize_state(jps)
    assert find_normalize_state(ps) is na
    for rms, jrms in ((na.ob_rms, jn.ob_rms), (na.ret_rms, jn.ret_rms)):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(rms, f).numpy(), np.asarray(getattr(jrms, f)),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(na.ob_rms, f), getattr(nb.ob_rms, f))
        assert torch.equal(getattr(na.ret_rms, f), getattr(nb.ret_rms, f))
    # 12 steps of 6 envs and the 6 reset observations, over the initial count 1e-4 twice
    # (each group's) less once (the union's zero prior)
    assert abs(float(na.ob_rms.count) - (78 + 1e-4)) < 1e-3
    np.testing.assert_allclose(traj.obs.numpy(), np.asarray(jtraj.obs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(traj.rewards.numpy(), np.asarray(jtraj.rewards), rtol=1e-5,
                               atol=1e-6)


N_ENVS = 4


@pytest.fixture(scope="module")
def native_update():
    """One pipelined ppo2 update on native:CartPole-v1 on both sides, 4 envs (2 a group)
    x 16 steps, 2 epochs of 2 minibatches, mlp from the same numpy weights."""
    hp = dict(UPDATE_HPARAMS)
    nsteps, noptepochs = hp["nsteps"], hp["noptepochs"]
    lr, cliprange = 3e-4, 0.2
    jpair = jax_build_env_pair("native:CartPole-v1", N_ENVS)
    jpol = jax_build_policy(jpair.observation_space, jpair.action_space, "mlp")
    params = mlp_policy_params(0, 4, 2)
    tx = adam_optimizer(0.5, eps=1e-5)
    # ppo.py:474-489: the resets of A and B, then B's first action, from the key splits
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    kra, krb, kprime = jax.random.split(kreset, 3)
    reset_a, reset_b = jpair.a.reset(kra), jpair.b.reset(krb)
    env_state = jax_init_pipe_state(jpol, jpair, params, kprime, reset_a, reset_b)
    state = JaxTrainState(params=params, opt_state=tx.init(params), key=key,
                          env_state=env_state, obs=reset_a[0], rnn_state=None,
                          last_done=jnp.zeros((N_ENVS,), bool),
                          update_idx=jnp.zeros((), jnp.int32))
    update = jax.jit(jax_make_update_fn(jpol, jpair, tx, lr_fn=jax_schedule(lr),
                                        cliprange_fn=jax_schedule(cliprange), pipelined=True,
                                        **hp))
    jnew, jmetrics = update(state)
    jax.block_until_ready(jnew)
    jpair.close()

    half = N_ENVS // 2
    draws = _seed_draws(kra, krb)
    push_policy_noise(draws, kprime, half, 2)
    k = key
    for _ in range(nsteps):  # common.py:329-345: A's noise, then B's, each step
        k, ka, kb = jax.random.split(k, 3)
        push_policy_noise(draws, ka, half, 2)
        push_policy_noise(draws, kb, half, 2)
    push_epochs(draws, k, noptepochs, N_ENVS * nsteps)

    pair = build_env_pair("native:CartPole-v1", N_ENVS, device="cpu")
    tpol = build_policy(pair.observation_space, pair.action_space, "mlp", device="cpu")
    start = convert.policy_state_dict(params)
    tpol.module.load_state_dict(start)
    opt = ClipAdam(tpol.module.parameters(), 0.5, eps=1e-5)
    treset_a, treset_b = pair.a.reset(draws), pair.b.reset(draws)
    np.testing.assert_array_equal(treset_a[0].numpy(), np.asarray(reset_a[0]))
    ps = init_pipe_state(tpol, pair, draws, treset_a, treset_b)
    tstate = PPOTrainState(env_state=ps, obs=treset_a[0],
                           last_done=torch.zeros((N_ENVS,), dtype=torch.bool))
    update_fn = make_update_fn(tpol, pair, opt, lr_fn=resolve_fraction_schedule(lr),
                               cliprange_fn=resolve_fraction_schedule(cliprange),
                               pipelined=True, **hp)
    tnew, tmetrics = update_fn(tstate, draws)
    pair.close()
    assert not draws.queue, "the port took fewer draws than the JAX update made"
    return dict(jnew=jnew, jmetrics=jmetrics, tnew=tnew, tmetrics=tmetrics, tpol=tpol,
                start=start)


def test_pipelined_native_update_matches_jax(native_update):
    """The update's metrics to 1e-4 relative or 1e-6 absolute and each param's change to
    2e-4 of that change (torch_parity's tolerances), its PipeState bit for bit: the native
    engine steps both sides alike, so every action and obs agrees."""
    r = native_update
    assert_update_metrics_match(r["jmetrics"], r["tmetrics"])
    assert_update_params_match(r["jnew"].params, r["tpol"], r["start"])
    jps, ps = r["jnew"].env_state, r["tnew"].env_state
    for f in ("obs_a", "pend_obs_b", "pend_act_b", "last_done_a", "last_done_b"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(jps, f)),
                                      err_msg=f)
    ours, theirs = VecMonitor.get_stats(ps), JaxVecMonitor.get_stats(jps)
    assert int(ours.episodes) == int(theirs.episodes)
    np.testing.assert_allclose(float(ours.mean_return), float(theirs.mean_return), rtol=1e-6)
    assert r["tnew"].update_idx == int(r["jnew"].update_idx) == 1
