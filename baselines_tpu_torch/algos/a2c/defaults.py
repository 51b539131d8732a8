"""Per-env-type a2c defaults (a copy of baselines_tpu/algos/a2c/defaults.py: nsteps=5
and lr=7e-4 are the learner's own defaults, after a2c/a2c.py)."""


def atari():
    return dict(nsteps=5, lrschedule="linear", num_envs=16)


def classic_control():
    return dict(nsteps=5, num_envs=8)


def testing():
    return dict(nsteps=5, num_envs=8, gamma=0.9)
