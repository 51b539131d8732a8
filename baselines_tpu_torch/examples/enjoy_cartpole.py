"""Watch a trained CartPole DQN (counterpart of baselines_tpu/examples/enjoy_cartpole.py)
— parity with baselines/deepq/experiments/enjoy_cartpole.py: load the model that
train_cartpole.py saved, roll 1000 deterministic steps of 4 envs and print the mean
episode reward, then write a video instead of opening a window (cv2 writes the mp4).

    python -m baselines_tpu_torch.examples.enjoy_cartpole
"""

from baselines_tpu_torch.algos.common import build_env, evaluate
from baselines_tpu_torch.algos.dqn.dqn import learn
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.envs.registry import make_env
from baselines_tpu_torch.envs.video import record_video
from baselines_tpu_torch.examples.train_cartpole import MODEL_PATH

# the model's structure, rebuilt with no training step, then its weights loaded
LOAD_KWARGS = dict(
    env_id="CartPole-v1",
    network="mlp",
    num_hidden=64,
    total_timesteps=0,
    num_envs=4,
    print_freq=0,
    load_path=MODEL_PATH,
)
EVAL_STEPS = 1000
VIDEO_PATH = "cartpole.mp4"
VIDEO_LENGTH = 300


def main():
    model = learn(**LOAD_KWARGS)
    venv = build_env("CartPole-v1", 4, device=model.device)
    ret, length, episodes = evaluate(model, venv, Draws(0, model.device), nsteps=EVAL_STEPS)
    print(f"mean episode reward {ret} over {episodes} episodes")
    record_video(model, make_env("CartPole-v1"), VIDEO_PATH, video_length=VIDEO_LENGTH)


if __name__ == "__main__":
    main()
