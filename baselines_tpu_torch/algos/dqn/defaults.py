"""Per-env-type DQN defaults (a copy of baselines_tpu/algos/dqn/defaults.py, which
follows deepq/defaults.py:1-21)."""


def atari():
    return dict(
        network="conv_only",
        lr=1e-4,
        buffer_size=10000,
        exploration_fraction=0.1,
        exploration_final_eps=0.01,
        train_freq=4,
        learning_starts=10000,
        target_network_update_freq=1000,
        gamma=0.99,
        prioritized_replay=True,
        prioritized_replay_alpha=0.6,
        dueling=True,
    )


def classic_control():
    return dict(gamma=0.99, train_freq=1)


def retro():
    return atari()


def testing():
    return dict(gamma=0.9, buffer_size=5000, learning_starts=500)
