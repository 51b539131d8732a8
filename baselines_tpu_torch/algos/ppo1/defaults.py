"""Per-env-type ppo1 defaults (a copy of baselines_tpu/algos/ppo1/defaults.py; the
reference has no ppo1/defaults.py, so these follow its run scripts,
ppo1/run_mujoco.py and ppo1/run_atari.py)."""


def mujoco():
    return dict(
        num_envs=1,
        timesteps_per_actorbatch=2048,
        clip_param=0.2,
        entcoeff=0.0,
        optim_epochs=10,
        optim_stepsize=3e-4,
        optim_batchsize=64,
        gamma=0.99,
        lam=0.95,
        schedule="linear",
        value_network="copy",
    )


def atari():
    return dict(
        num_envs=8,
        timesteps_per_actorbatch=256,
        clip_param=0.2,
        entcoeff=0.01,
        optim_epochs=4,
        optim_stepsize=1e-3,
        optim_batchsize=64,
        gamma=0.99,
        lam=0.95,
        schedule="linear",
    )


def robotics():
    return mujoco()


def classic_control():
    return dict(
        num_envs=8,
        timesteps_per_actorbatch=512,
        optim_stepsize=3e-4,
        optim_batchsize=128,
        schedule="constant",
    )


def testing():
    return dict(
        num_envs=8,
        timesteps_per_actorbatch=512,
        optim_stepsize=1e-3,
        optim_batchsize=128,
    )
