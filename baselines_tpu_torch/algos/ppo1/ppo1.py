"""PPO1, first-generation PPO (counterpart of baselines_tpu/algos/ppo1/ppo1.py, after
baselines/ppo1/pposgd_simple.py), on ppo2's machinery (algos/ppo/ppo.py).

Its update differs from ppo2's in four ways:

1. the advantages are standardized once over the whole actor batch, not per minibatch
   -> ``adv_norm="batch"``;
2. the value loss is a plain MSE, without clipping -> ``clip_value=False``, and
   ``vf_coef=2.0`` cancels the loss's 1/2, so the objective is pol_surr + pol_entpen +
   vf_loss;
3. one multiplier anneals both the Adam step size and the clip range: ``schedule``
   "linear" decays both to 0 over training, "constant" keeps them
   (pposgd_simple.py:116-124, 162-165);
4. Adam with ``adam_epsilon`` and no gradient-norm clipping -> ``max_grad_norm=None``.

The hyperparameters take pposgd_simple's names (``timesteps_per_actorbatch``,
``clip_param``, ``entcoeff``, ``optim_epochs``, ``optim_stepsize``, ``optim_batchsize``,
``schedule``); ppo2's names pass through and win, so ``--alg=ppo1`` takes either from
the command line.
"""

from __future__ import annotations

from baselines_tpu_torch.algos.ppo import ppo


def learn(
    *,
    env=None,
    env_id: str | None = None,
    network: str = "mlp",
    total_timesteps: int,
    seed: int | None = None,
    num_envs: int = 1,
    timesteps_per_actorbatch: int = 256,
    clip_param: float = 0.2,
    entcoeff: float = 0.0,
    optim_epochs: int = 4,
    optim_stepsize: float = 1e-3,
    optim_batchsize: int = 64,
    gamma: float = 0.99,
    lam: float = 0.95,
    schedule: str = "constant",
    adam_epsilon: float = 1e-5,
    **kwargs,
):
    """pposgd_simple.learn, returning ppo2's ``Model``. ``timesteps_per_actorbatch`` is
    the whole batch of an update, split over ``num_envs`` envs."""
    if schedule not in ("constant", "linear"):
        raise ValueError(f"schedule must be 'constant' or 'linear', got {schedule!r}")
    nsteps = max(timesteps_per_actorbatch // max(num_envs, 1), 1)
    nbatch = nsteps * max(num_envs, 1)
    nminibatches = max(nbatch // optim_batchsize, 1)

    if schedule == "linear":
        lr = lambda f: optim_stepsize * f  # noqa: E731
        cliprange = lambda f: clip_param * f  # noqa: E731
    else:
        lr = optim_stepsize
        cliprange = clip_param

    kwargs.setdefault("lr", lr)
    kwargs.setdefault("cliprange", cliprange)
    kwargs.setdefault("nsteps", nsteps)
    kwargs.setdefault("nminibatches", nminibatches)
    kwargs.setdefault("noptepochs", optim_epochs)
    kwargs.setdefault("ent_coef", entcoeff)
    kwargs.setdefault("vf_coef", 2.0)
    kwargs.setdefault("max_grad_norm", None)

    return ppo.learn(env=env, env_id=env_id, network=network, total_timesteps=total_timesteps,
                     seed=seed, num_envs=num_envs, gamma=gamma, lam=lam, adv_norm="batch",
                     clip_value=False, adam_epsilon=adam_epsilon, **kwargs)
