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
from baselines_tpu.envs.classic.acrobot import Acrobot as JaxAcrobot
from baselines_tpu.envs.classic.cartpole import CartPole as JaxCartPole
from baselines_tpu.envs.classic.mountain_car import MountainCar as JaxMountainCar
from baselines_tpu.envs.classic.mountain_car import (
    MountainCarContinuous as JaxMountainCarContinuous)
from baselines_tpu.envs.classic.pendulum import Pendulum as JaxPendulum
from baselines_tpu.envs.testing.atari_sim import AtariSim as JaxAtariSim
from baselines_tpu.envs.testing.fixed_sequence import FixedSequenceEnv as JaxFixedSequence
from baselines_tpu.envs.testing.identity import BoxIdentityEnv as JaxBoxIdentity
from baselines_tpu.envs.testing.identity import MultiDiscreteIdentityEnv as JaxMultiDiscreteIdentity
from baselines_tpu.envs.testing.identity import _IdentityBase as JaxIdentityBase
from baselines_tpu.nn.distributions import make_pdtype as jax_make_pdtype
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

    def normal(self, shape):
        return torch.from_numpy(self._pop("normal", shape).astype(np.float32))

    def permutation(self, n):
        return torch.from_numpy(self._pop("permutation", (n,)).astype(np.int64))


_BATCHED_RESETS = {}


def _batched_reset(base):
    """The JAX env's reset, vmapped over keys and compiled once for each env object."""
    if id(base) not in _BATCHED_RESETS:
        _BATCHED_RESETS[id(base)] = (base, jax.jit(jax.vmap(base.reset)))
    return _BATCHED_RESETS[id(base)][1]


def _push_draws(draws: ReplayDraws, env, keys) -> None:
    """What the port draws where the JAX env (behind its wrappers) resets with ``keys``,
    one per env, batched: CartPole's four uniforms of each env, which are its
    observation; AtariSim's sprite positions, then velocities; Pendulum's angles, then
    speeds; a MountainCar's positions; Acrobot's four state uniforms; an identity env's
    targets (a MultiDiscrete one's uniforms); nothing for FixedSequence."""
    base = env.unwrapped
    if isinstance(base, JaxFixedSequence):
        return
    obs, st = _batched_reset(base)(keys)
    if isinstance(base, JaxCartPole):
        draws.push("uniform", obs)
    elif isinstance(base, JaxAtariSim):
        draws.push("randint", st.x)
        draws.push("randint", st.v)
    elif isinstance(base, JaxPendulum):
        draws.push("uniform", st.theta)
        draws.push("uniform", st.theta_dot)
    elif isinstance(base, (JaxMountainCar, JaxMountainCarContinuous)):
        draws.push("uniform", st.position)
    elif isinstance(base, JaxAcrobot):
        draws.push("uniform", st.s)
    elif isinstance(base, JaxMultiDiscreteIdentity):
        draws.push("uniform", jax.vmap(lambda k: jax.random.uniform(k, base.dims.shape))(keys))
    elif isinstance(base, JaxBoxIdentity):
        draws.push("uniform", st.target)
    elif isinstance(base, JaxIdentityBase):
        draws.push("randint", st.target)
    else:
        raise TypeError(f"no draws known for {type(base).__name__}")


def push_reset(draws: ReplayDraws, env, key, num_envs: int) -> None:
    """The draws of VecJaxEnv.reset(key) (see ``_push_draws``)."""
    _push_draws(draws, env, jax.random.split(key, num_envs))


def base_env(venv):
    """The single JAX env under a chain of vec wrappers."""
    while not hasattr(venv, "env"):
        venv = venv.venv
    return venv.env


def push_env_step(draws: ReplayDraws, env, key, num_envs: int) -> None:
    """The draws of VecJaxEnv.step(key, ...) (envs/vec.py:159-183): the identity envs'
    new targets from the step keys, then the reset draws, which the port takes at every
    step."""
    kstep, kreset = jax.random.split(key)
    if isinstance(env.unwrapped, JaxIdentityBase):
        _push_draws(draws, env, jax.random.split(kstep, num_envs))
    push_reset(draws, env, kreset, num_envs)


def push_policy_noise(draws: ReplayDraws, key, num_envs: int, ac_space) -> None:
    """The noise of Policy.step's sample with ``key`` (nn/distributions.py): Gumbel
    uniforms of a categorical (``ac_space`` may be its action count), one uniform
    tensor for each categorical of a multi-categorical, from the key's split, or a
    Gaussian's normals."""
    if isinstance(ac_space, int):
        draws.push("uniform", jax.random.uniform(key, (num_envs, ac_space), jnp.float32,
                                                 1e-10, 1.0))
        return
    pdtype = jax_make_pdtype(ac_space)
    if pdtype.kind == "categorical":
        push_policy_noise(draws, key, num_envs, int(ac_space.n))
    elif pdtype.kind == "multicategorical":
        for k, n in zip(jax.random.split(key, len(pdtype.nvec)), pdtype.nvec):
            push_policy_noise(draws, k, num_envs, int(n))
    elif pdtype.kind == "diag_gaussian":
        draws.push("normal", jax.random.normal(key, (num_envs,) + tuple(ac_space.shape)))
    else:
        draws.push("uniform", jax.random.uniform(key, (num_envs, ac_space.n)))


def push_rollout_step(draws: ReplayDraws, env, key, num_envs: int, ac_space):
    """One step of run_rollout (algos/common.py:228-230): the noise of policy.step
    (``ac_space`` may be a categorical's action count), then the env's draws. Returns
    the carried key."""
    key, kact, kstep = jax.random.split(key, 3)
    push_policy_noise(draws, kact, num_envs, ac_space)
    push_env_step(draws, env, kstep, num_envs)
    return key


def push_epochs(draws: ReplayDraws, key, noptepochs: int, n: int) -> None:
    """The epoch permutations of one update (algos/ppo/ppo.py:374-375): of the ``n`` =
    T * N samples of a feedforward update (:321), or of the ``n`` = N envs of a
    recurrent one (:241)."""
    ekeys = jax.random.split(key, noptepochs + 1)
    for ekey in ekeys[1:]:
        draws.push("permutation", jax.random.permutation(ekey, n))


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


def mlp_policy_params(seed: int, ob_dim: int, n_actions: int, num_layers: int = 2,
                      num_hidden: int = 64, layer_norm: bool = False) -> dict:
    """Params of the JAX PolicyValueNet(MLP) in flax layout, made with numpy as
    ``policy_params`` makes them; LayerNorm scales and biases away from 1 and 0."""
    rng = np.random.RandomState(seed)

    def layer(n_in, n_out, gain):
        return {"kernel": (rng.randn(n_in, n_out) * gain / np.sqrt(n_in)).astype(np.float32),
                "bias": (rng.randn(n_out) * 0.01).astype(np.float32)}

    network, width = {}, ob_dim
    for i in range(num_layers):
        network[f"mlp_fc{i}"] = layer(width, num_hidden, np.sqrt(2))
        if layer_norm:
            network[f"LayerNorm_{i}"] = {
                "scale": (1 + 0.1 * rng.randn(num_hidden)).astype(np.float32),
                "bias": (0.1 * rng.randn(num_hidden)).astype(np.float32)}
        width = num_hidden
    return {"params": {"network": network, "pi": layer(width, n_actions, 0.01),
                       "vf": layer(width, 1, 1.0)}}


# several CartPole steps: each step's sin/cos ulp carries into the next state, so states
# compared after a rollout are held to the update metrics' 1e-4 relative / 1e-6 absolute
ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-4, 1e-6
CARTPOLE_THRESHOLDS = (2.4, 12 * 2 * np.pi / 360)  # |x|, |theta| (cartpole.py:39-40)
THRESHOLD_MARGIN = 1e-5


class RecordStates:
    """Wraps a port env to keep the observation of every step before any reset, so a
    test can assert that no CartPole state came within ``THRESHOLD_MARGIN`` of a
    termination threshold: the port's and the JAX env's states differ by an ulp or so
    (torch's sin/cos against XLA's), far less than that margin, so on these inputs a
    done flag cannot flip between the two sides unseen. ``margin`` computes that
    distance for another env's observations."""

    def __init__(self, env, margin=None):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.margin = threshold_margin if margin is None else margin
        self.seen = []

    def reset(self, draws, num_envs, device):
        obs, state = self.env.reset(draws, num_envs, device)
        self.seen.append(obs.clone())
        return obs, state

    def step(self, draws, state, action):
        out = self.env.step(draws, state, action)
        self.seen.append(out[0].clone())
        return out

    def min_margin(self) -> float:
        return self.margin(torch.cat(self.seen))


def threshold_margin(obs: torch.Tensor) -> float:
    """The least distance of CartPole observations (..., 4) from a termination threshold."""
    obs = obs.reshape(-1, 4).double()
    x_margin = (CARTPOLE_THRESHOLDS[0] - obs[:, 0].abs()).abs().min()
    theta_margin = (CARTPOLE_THRESHOLDS[1] - obs[:, 2].abs()).abs().min()
    return float(min(x_margin, theta_margin))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


NENVS, NSTEPS, NMB, NEPOCHS = 8, 16, 2, 2
UPDATE_HPARAMS = dict(nsteps=NSTEPS, nminibatches=NMB, noptepochs=NEPOCHS, gamma=0.99,
                      lam=0.95, ent_coef=0.01, vf_coef=0.5, nupdates=1)


def port_vec_env(venv):
    """The VecTorchEnv under a chain of the port's vec wrappers."""
    while not hasattr(venv, "env"):
        venv = venv.venv
    return venv


def init_params(jmodule_init, seed: int, *args) -> dict:
    """Flax's own init of a module (``jmodule_init(key, *args)``), every leaf then moved
    by noise (a tenth of the leaf's spread, or 0.1 where the init made it constant), so
    that biases, the LSTM's ``b`` and the LayerNorms' scales differ from their init
    constants and a tensor mapped to the wrong place cannot go unseen."""
    params = jax.jit(jmodule_init)(jax.random.PRNGKey(seed), *args)
    rng = np.random.RandomState(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        spread = float(x.std()) or 1.0
        return (x + 0.1 * spread * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map(move, params)


def one_ppo_update(env_id: str = "AtariSim-v0", env_kwargs=None, *, network: str | None = None,
                   network_kwargs=None, value_network: str | None = None, make_envs=None,
                   hparams=None, max_grad_norm=0.5, lr=3e-4, cliprange=0.2,
                   **options) -> dict:
    """One full ppo2 update of the port and of the JAX package on the CPU, by default at
    8 envs x 16 steps, 2 epochs of 2 minibatches, with ``env_kwargs`` (``normalize``,
    ``reward_scale``) passed to both ``build_env`` and ``options`` (``adv_norm``,
    ``clip_value``, ``microbatch_size``) to both ``make_update_fn``: on AtariSim-v0
    packed by VecS2D with cnn_s2d in f32, or on another env with mlp (a Gaussian head,
    whose ``logstd`` starts at -0.5, for a Box action space).

    ``network`` with ``network_kwargs`` and ``value_network`` replace that network on
    both sides; ``make_envs(nenvs)`` gives (the JAX venv, the port's venv) in place of
    ``build_env(env_id)``, for an env the registry does not hold; ``hparams`` replace
    entries of ``UPDATE_HPARAMS`` (and ``nenvs``), and ``max_grad_norm``, ``lr`` and
    ``cliprange`` go to both optimizers and schedules.

    Both start from the same weights (carried across by convert.py: made by numpy for
    the default networks, by flax's init moved by noise for any other) and the same env
    state. The port is handed the very draws the JAX update makes, rebuilt from the same
    key splits (algos/ppo/ppo.py:374-375, algos/common.py:228-230): the sampling noise
    and env draws of every rollout step, then the epoch permutations, of the samples or,
    for a recurrent policy, of the envs. Returns the new states and metrics of both
    sides, the port's policy and its starting weights, and on CartPole the port's env,
    which recorded every state it stepped through."""
    hp = dict(UPDATE_HPARAMS, **(hparams or {}))
    nenvs = hp.pop("nenvs", NENVS)
    nsteps, noptepochs = hp["nsteps"], hp["noptepochs"]
    atari = env_id == "AtariSim-v0" and make_envs is None
    default_network, s2d = ("cnn_s2d", 4) if atari else ("mlp", 0)
    custom_net = network is not None or value_network is not None
    network = network or default_network
    network_kwargs = dict(network_kwargs or {})
    env_kwargs = dict(env_kwargs or {})
    if make_envs is None:
        venv = jax_build_env(env_id, nenvs, s2d=s2d, **env_kwargs)
    else:
        venv, tvenv = make_envs(nenvs)
    ac_space = venv.action_space
    jpol = jax_build_policy(venv.observation_space, ac_space, network,
                            value_network=value_network, **network_kwargs)
    tx = adam_optimizer(max_grad_norm, eps=1e-5)
    # learn()'s make_state (algos/ppo/ppo.py:508-521), with the params made by numpy or
    # moved from flax's init
    key, kreset, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    obs, env_state = venv.reset(kreset)
    pdtype = jax_make_pdtype(ac_space)
    gaussian = pdtype.kind == "diag_gaussian"
    width = pdtype.param_size // 2 if gaussian else pdtype.param_size
    ob_space = venv.observation_space
    ob_width = (int(np.sum(ob_space.nvec)) if hasattr(ob_space, "nvec")
                else int(np.prod(ob_space.shape)))
    if custom_net:
        params = init_params(jpol.init, 0, obs)
    else:
        params = policy_params(0, width) if atari else mlp_policy_params(0, ob_width, width)
        if gaussian:
            params["params"]["logstd"] = np.full((1, width), -0.5, np.float32)
    state = JaxTrainState(params=params, opt_state=tx.init(params), key=key,
                          env_state=env_state, obs=obs, rnn_state=jpol.initial_state(nenvs),
                          last_done=jnp.zeros((nenvs,), bool), update_idx=jnp.zeros((), jnp.int32))
    update = jax.jit(jax_make_update_fn(jpol, venv, tx, lr_fn=jax_schedule(lr),
                                        cliprange_fn=jax_schedule(cliprange), **hp, **options))
    jnew, jmetrics = update(state)

    base = base_env(venv)
    draws = ReplayDraws()
    push_reset(draws, base, kreset, nenvs)
    k = key
    for _ in range(nsteps):
        k = push_rollout_step(draws, base, k, nenvs, ac_space)
    push_epochs(draws, k, noptepochs, nenvs if jpol.is_recurrent else nenvs * nsteps)

    recorder = None
    if make_envs is None:
        tvenv = build_env(env_id, nenvs, device="cpu", s2d=s2d, **env_kwargs)
        if env_id.startswith("CartPole"):
            recorder = RecordStates(port_vec_env(tvenv).env)
            port_vec_env(tvenv).env = recorder
    tpol = build_policy(tvenv.observation_space, tvenv.action_space, network, device="cpu",
                        value_network=value_network, **network_kwargs)
    start = convert.policy_state_dict(params)
    tpol.module.load_state_dict(start)
    opt = ClipAdam(tpol.module.parameters(), max_grad_norm, eps=1e-5)
    tobs, tenv_state = tvenv.reset(draws)
    if atari or env_id.startswith("CartPole") or make_envs is not None:
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
    else:  # sin/cos, and the normalization's sums, round otherwise
        np.testing.assert_allclose(tobs.numpy(), np.asarray(obs), rtol=1e-5, atol=1e-5)
    tstate = PPOTrainState(env_state=tenv_state, obs=tobs,
                           last_done=torch.zeros((nenvs,), dtype=torch.bool),
                           rnn_state=tpol.initial_state(nenvs))
    update_fn = make_update_fn(tpol, tvenv, opt, lr_fn=resolve_fraction_schedule(lr),
                               cliprange_fn=resolve_fraction_schedule(cliprange), **hp,
                               **options)
    tnew, tmetrics = update_fn(tstate, draws)
    assert not draws.queue, "the port took fewer draws than the JAX update made"
    return dict(jnew=jnew, jmetrics=jmetrics, tnew=tnew, tmetrics=tmetrics, tpol=tpol,
                start=start, recorder=recorder)


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
