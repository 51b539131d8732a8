"""acer's defaults by env type (a copy of baselines_tpu/algos/acer/defaults.py)."""


def atari():
    return dict(lrschedule="constant", network="cnn", num_envs=16)


def classic_control():
    return dict(network="mlp", num_envs=8, replay_start=2000, buffer_size=20000)


def testing():
    return dict(network="mlp", num_envs=8, replay_start=1000, buffer_size=5000, gamma=0.9)
