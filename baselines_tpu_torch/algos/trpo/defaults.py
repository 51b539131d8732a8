"""Per-env-type TRPO defaults (a copy of baselines_tpu/algos/trpo/defaults.py, which
follows trpo_mpi/defaults.py:4-30)."""


def atari():
    return dict(
        network="cnn",
        timesteps_per_batch=512,
        max_kl=0.001,
        cg_iters=10,
        cg_damping=1e-3,
        gamma=0.98,
        lam=1.0,
        vf_iters=3,
        vf_stepsize=1e-4,
        ent_coef=0.0,
    )


def mujoco():
    return dict(
        timesteps_per_batch=1024,
        max_kl=0.01,
        cg_iters=10,
        cg_damping=0.1,
        gamma=0.99,
        lam=0.98,
        vf_iters=5,
        vf_stepsize=1e-3,
        normalize_observations=True,
    )


def classic_control():
    return dict(timesteps_per_batch=1024, max_kl=0.01, gamma=0.99, lam=0.98,
                vf_iters=5, vf_stepsize=1e-3, num_envs=8)


def testing():
    return dict(timesteps_per_batch=512, max_kl=0.01, gamma=0.9, lam=1.0, num_envs=8)
