"""acktr's defaults by env type (a copy of baselines_tpu/algos/acktr/defaults.py)."""


def atari():
    # the reference runs the Nature CNN on Atari with kfac_update=1 and hides the
    # eigendecompositions in queue-runner threads (acktr/acktr.py:126-130); the JAX
    # package refreshes them synchronously every 10 updates
    return dict(network="cnn", nsteps=20, kfac_update=10)


def mujoco():
    return dict(nsteps=2500)


def classic_control():
    return dict(nsteps=20, num_envs=8)


def testing():
    return dict(nsteps=20, num_envs=8, gamma=0.9)
