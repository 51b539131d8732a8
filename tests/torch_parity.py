"""Helpers for the tests that hold the PyTorch port against the JAX package on the CPU.

JAX draws with threefry keys and the port with a torch.Generator, so the two cannot
share a seed. These helpers rebuild what the JAX package draws, from the same key
splits it makes, and hand those numbers to the port through a stand-in for its
``Draws`` (baselines_tpu_torch/core/rng.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from baselines_tpu.algos.common import adam_optimizer
from baselines_tpu.algos.common import build_env as jax_build_env
from baselines_tpu.algos.ppo.ppo import PPOTrainState as JaxTrainState
from baselines_tpu.algos.ppo.ppo import make_update_fn as jax_make_update_fn
from baselines_tpu.core.schedules import resolve_fraction_schedule as jax_schedule
from baselines_tpu.nn.policy import build_policy as jax_build_policy
from baselines_tpu_torch import convert
from baselines_tpu_torch.algos.common import ClipAdam, build_env
from baselines_tpu_torch.algos.ppo.ppo import PPOTrainState, make_update_fn
from baselines_tpu_torch.core.schedules import resolve_fraction_schedule
from baselines_tpu_torch.nn.policy import build_policy

# the suite runs in several worker processes at once; one torch thread each keeps them
# from oversubscribing the cores
torch.set_num_threads(1)


class ReplayDraws:
    """Serves the port recorded draws, in the order it asks for them."""

    def __init__(self):
        self.queue = []

    def push(self, kind: str, values) -> None:
        self.queue.append((kind, np.asarray(values)))

    def _pop(self, kind: str, shape) -> np.ndarray:
        assert self.queue, f"the port asked for more draws than were recorded ({kind})"
        got_kind, values = self.queue.pop(0)
        assert got_kind == kind and values.shape == tuple(shape), (
            f"the port asked for {kind} {tuple(shape)}, the next draw is {got_kind} "
            f"{values.shape}"
        )
        return values

    def uniform(self, shape, low, high):
        return torch.from_numpy(self._pop("uniform", shape).astype(np.float32))

    def randint(self, low, high, shape):
        return torch.from_numpy(self._pop("randint", shape).astype(np.int32))

    def permutation(self, n):
        return torch.from_numpy(self._pop("permutation", (n,)).astype(np.int64))


def push_reset(draws: ReplayDraws, env, key, num_envs: int) -> None:
    """The draws of VecJaxEnv.reset(key) on AtariSim: its sprite positions, then
    velocities."""
    _, st = jax.vmap(env.reset)(jax.random.split(key, num_envs))
    draws.push("randint", st.x)
    draws.push("randint", st.v)


def push_env_step(draws: ReplayDraws, env, key, num_envs: int) -> None:
    """The reset draws of VecJaxEnv.step(key, ...) (envs/vec.py:161-177), which the
    port takes at every step."""
    _, kreset = jax.random.split(key)
    push_reset(draws, env, kreset, num_envs)


def push_rollout_step(draws: ReplayDraws, env, key, num_envs: int, n_actions: int):
    """One step of run_rollout (algos/common.py:228-230): the Gumbel uniforms of
    policy.step, then the env's draws. Returns the carried key."""
    key, kact, kstep = jax.random.split(key, 3)
    draws.push("uniform", jax.random.uniform(kact, (num_envs, n_actions), jnp.float32, 1e-10, 1.0))
    push_env_step(draws, env, kstep, num_envs)
    return key


def push_epochs(draws: ReplayDraws, key, noptepochs: int, nbatch: int) -> None:
    """The epoch permutations of one update (algos/ppo/ppo.py:374-375, :321)."""
    ekeys = jax.random.split(key, noptepochs + 1)
    for ekey in ekeys[1:]:
        draws.push("permutation", jax.random.permutation(ekey, nbatch))


def policy_params(seed: int, n_actions: int = 6) -> dict:
    """Params of the JAX PolicyValueNet(NatureCNNS2D) in flax layout, made with numpy
    (quicker than flax's orthogonal init): kernels scaled like that init, gain over the
    root of the fan-in, and small nonzero biases."""
    rng = np.random.RandomState(seed)

    def layer(shape, gain):
        kernel = rng.randn(*shape) * gain / np.sqrt(np.prod(shape[:-1]))
        return {"kernel": kernel.astype(np.float32),
                "bias": (rng.randn(shape[-1]) * 0.01).astype(np.float32)}

    g = np.sqrt(2)
    network = {"c1": layer((2, 2, 64, 32), g), "c2": layer((4, 4, 32, 64), g),
               "c3": layer((3, 3, 64, 64), g), "fc1": layer((3136, 512), g)}
    return {"params": {"network": network, "pi": layer((512, n_actions), 0.01),
                       "vf": layer((512, 1), 1.0)}}


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


NENVS, NSTEPS, NMB, NEPOCHS = 8, 16, 2, 2
UPDATE_HPARAMS = dict(nsteps=NSTEPS, nminibatches=NMB, noptepochs=NEPOCHS, gamma=0.99,
                      lam=0.95, ent_coef=0.01, vf_coef=0.5, nupdates=1)


def one_ppo_update(**options) -> dict:
    """One full ppo2 update of the port and of the JAX package on the CPU, at 8 envs x
    16 steps of AtariSim-v0 packed by VecS2D, cnn_s2d in f32, 2 epochs of 2 minibatches,
    with ``options`` (``adv_norm``, ``clip_value``) passed to both ``make_update_fn``.

    Both start from the same weights (carried across by convert.py) and the same env
    state. The port is handed the very draws the JAX update makes, rebuilt from the same
    key splits (algos/ppo/ppo.py:374-375, algos/common.py:228-230): the Gumbel uniforms
    and env reset draws of every rollout step, then the epoch permutations. Returns the
    new states and metrics of both sides, the port's policy and its starting weights."""
    venv = jax_build_env("AtariSim-v0", NENVS, s2d=4)
    jpol = jax_build_policy(venv.observation_space, venv.action_space, "cnn_s2d")
    tx = adam_optimizer(0.5, eps=1e-5)
    # learn()'s make_state (algos/ppo/ppo.py:508-521), with the params made by numpy
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    obs, env_state = venv.reset(kreset)
    params = policy_params(0, venv.action_space.n)
    state = JaxTrainState(params=params, opt_state=tx.init(params), key=key,
                          env_state=env_state, obs=obs, rnn_state=None,
                          last_done=jnp.zeros((NENVS,), bool), update_idx=jnp.zeros((), jnp.int32))
    update = jax.jit(jax_make_update_fn(jpol, venv, tx, lr_fn=jax_schedule(3e-4),
                                        cliprange_fn=jax_schedule(0.2), **UPDATE_HPARAMS,
                                        **options))
    jnew, jmetrics = update(state)

    base = venv.venv.venv.env  # VecS2D -> VecMonitor -> VecJaxEnv -> AtariSim
    draws = ReplayDraws()
    push_reset(draws, base, kreset, NENVS)
    k = key
    for _ in range(NSTEPS):
        k = push_rollout_step(draws, base, k, NENVS, venv.action_space.n)
    push_epochs(draws, k, NEPOCHS, NENVS * NSTEPS)

    tvenv = build_env("AtariSim-v0", NENVS, device="cpu", s2d=4)
    tpol = build_policy(tvenv.observation_space, tvenv.action_space, "cnn_s2d", device="cpu")
    start = convert.policy_state_dict(params)
    tpol.module.load_state_dict(start)
    opt = ClipAdam(tpol.module.parameters(), 0.5, eps=1e-5)
    tobs, tenv_state = tvenv.reset(draws)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
    tstate = PPOTrainState(env_state=tenv_state, obs=tobs,
                           last_done=torch.zeros((NENVS,), dtype=torch.bool))
    update_fn = make_update_fn(tpol, tvenv, opt, lr_fn=resolve_fraction_schedule(3e-4),
                               cliprange_fn=resolve_fraction_schedule(0.2), **UPDATE_HPARAMS,
                               **options)
    tnew, tmetrics = update_fn(tstate, draws)
    assert not draws.queue, "the port took fewer draws than the JAX update made"
    return dict(jnew=jnew, jmetrics=jmetrics, tnew=tnew, tmetrics=tmetrics, tpol=tpol,
                start=start)


def assert_update_metrics_match(jm, tm) -> None:
    """Every metric to 1e-4 relative or 1e-6 absolute: f32 convolutions and reductions
    sum in another order, and the second and later minibatch steps see params that
    already carry those differences."""
    assert set(tm) == set(jm)
    for k in jm:
        got, want = float(tm[k]), float(jm[k])
        assert abs(got - want) <= 1e-6 + 1e-4 * abs(want), (k, got, want)
    assert float(jm["approxkl"]) > 0


def assert_update_params_match(jnew_params, tpol, start) -> None:
    """Each param tensor's change over the update to 2e-4 of that change: Adam divides
    each gradient by its running scale, so a relative difference in a small gradient
    comes through undamped (3e-5 at most, measured on the default update's inputs)."""
    want = convert.policy_state_dict(jax.tree_util.tree_map(np.asarray, jnew_params))
    for name, p in tpol.module.state_dict().items():
        base = start[name].double()
        delta_want = want[name].double() - base
        assert float(delta_want.abs().max()) > 0, name
        assert rel_err(p.double() - base, delta_want) < 2e-4, name


def integer_priorities(rng, nblocks: int, block_total: int = 4096) -> np.ndarray:
    """Priorities in {0, 1, 2, 3} for the stratified sampler, (nblocks * 2048,) f32, with
    runs of zeros and a last slot in each block that brings the block's sum to
    ``block_total``: every sum is an exact integer, and with zero uniforms and a batch of
    nblocks times a power of two the targets land on block and slot boundaries."""
    p = rng.randint(0, 4, (nblocks, 2048)).astype(np.float32)
    p[:, 100:300] = 0.0
    p[:, -1] = 0.0
    p[:, -1] = block_total - p.sum(axis=1)
    assert (p >= 0).all()
    return p.reshape(-1)
