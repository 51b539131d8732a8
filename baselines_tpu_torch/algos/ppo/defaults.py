"""Per-env-type PPO defaults (a copy of baselines_tpu/algos/ppo/defaults.py, which
follows ppo2/defaults.py:1-26)."""


def atari():
    return dict(
        nsteps=128,
        nminibatches=4,
        lam=0.95,
        gamma=0.99,
        noptepochs=4,
        log_interval=1,
        ent_coef=0.01,
        lr=lambda f: f * 2.5e-4,
        cliprange=0.1,
    )


def mujoco():
    return dict(
        nsteps=2048,
        nminibatches=32,
        lam=0.95,
        gamma=0.99,
        noptepochs=10,
        log_interval=1,
        ent_coef=0.0,
        lr=lambda f: 3e-4 * f,
        cliprange=0.2,
        value_network="copy",
        num_envs=1,
    )


def classic_control():
    return dict(
        nsteps=128,
        nminibatches=4,
        noptepochs=4,
        ent_coef=0.0,
        lr=3e-4,
        num_envs=8,
    )


def robotics():
    return mujoco()


def testing():
    return dict(nsteps=64, nminibatches=4, noptepochs=4, num_envs=8, lr=1e-3)
