"""Per-env-type DDPG defaults (a copy of baselines_tpu/algos/ddpg/defaults.py; the
reference has no defaults.py for ddpg, these follow its learn() defaults,
ddpg/ddpg.py:21-66)."""


def mujoco():
    return dict(num_envs=1, noise_type="adaptive-param_0.2", layer_norm=True)


def classic_control():
    return dict(num_envs=4, noise_type="ou_0.2", actor_lr=1e-3)


def testing():
    return dict(num_envs=4, gamma=0.9, layer_norm=True)
