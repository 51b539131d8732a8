"""DQN on CartPole (counterpart of baselines_tpu/examples/train_cartpole.py) — parity
with baselines/deepq/experiments/train_cartpole.py: train, then save the model for
enjoy_cartpole.py. The port saves a torch file, ``cartpole_model.pt``, where the JAX
package saves flax msgpack.

    python -m baselines_tpu_torch.examples.train_cartpole

``learn`` runs on the card; ``learn(**LEARN_KWARGS, device="cpu")`` runs the same
configuration on the CPU.
"""

from baselines_tpu_torch.algos.dqn.dqn import learn
from baselines_tpu_torch.core import logger

MODEL_PATH = "cartpole_model.pt"
LEARN_KWARGS = dict(
    env_id="CartPole-v1",
    network="mlp",
    num_hidden=64,
    lr=1e-3,
    total_timesteps=100_000,
    num_envs=4,
    buffer_size=50000,
    exploration_fraction=0.1,
    exploration_final_eps=0.02,
    gamma=0.99,
    print_freq=10,
)


def main():
    logger.configure()
    model = learn(**LEARN_KWARGS)
    print(f"Saving model to {MODEL_PATH}")
    model.save(MODEL_PATH)


if __name__ == "__main__":
    main()
