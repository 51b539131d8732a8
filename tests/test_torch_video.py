"""Video capture in the port (baselines_tpu_torch/envs/video.py) on the CPU against the
JAX package's (baselines_tpu/envs/video.py): CartPole's ``render_frame`` and the tiled
frames of a batch, bit for bit on the same states; ``VecVideoRecorder`` opening
``video.<step>.mp4`` at the JAX recorder's trigger steps; ``run.main
--save_video_interval`` writing under the log dir's ``videos/``; ``record_video`` of a
policy; and the refusals of ids that cannot render (native, retro). cv2 writes the
files."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from baselines_tpu.algos.common import build_env as jax_build_env  # noqa: E402
from baselines_tpu.envs.classic.cartpole import CartPole as JaxCartPole  # noqa: E402
from baselines_tpu.envs.classic.cartpole import CartPoleState as JaxCartPoleState  # noqa: E402
from baselines_tpu.envs.video import jax_env_frame_fn  # noqa: E402
from baselines_tpu_torch import run  # noqa: E402
from baselines_tpu_torch.algos.common import build_env, make_host_vec_env  # noqa: E402
from baselines_tpu_torch.core.rng import Draws  # noqa: E402
from baselines_tpu_torch.envs.classic.cartpole import CartPole, CartPoleState  # noqa: E402
from baselines_tpu_torch.envs.video import record_video, torch_env_frame_fn  # noqa: E402


def _states(n=7, seed=0):
    """CartPole states over the whole track and past the angle limit, f32."""
    rng = np.random.RandomState(seed)
    return [rng.uniform(lo, hi, n).astype(np.float32)
            for lo, hi in ((-2.6, 2.6), (-3, 3), (-0.6, 0.6), (-3, 3))]


def test_render_frame_matches_jax():
    """One env's frame, 600x400 RGB u8, the JAX env's bit for bit on the same states."""
    x, x_dot, theta, theta_dot = _states()
    ours, theirs = CartPole(), JaxCartPole()
    for i in range(len(x)):
        got = ours.render_frame(CartPoleState(*(torch.tensor(v[i]) for v in
                                                (x, x_dot, theta, theta_dot))))
        want = theirs.render_frame(JaxCartPoleState(x[i], x_dot[i], theta[i], theta_dot[i]))
        assert got.shape == (400, 600, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_batch_frames_match_jax():
    """The frame of a batch of 7 envs under the vec wrappers' states: the first four
    envs tiled 2 x 2, as the JAX package's ``jax_env_frame_fn`` tiles them."""
    from baselines_tpu.envs.base import TimeLimit as JaxTimeLimit
    from baselines_tpu_torch.envs.base import TimeLimitState
    from baselines_tpu_torch.envs.vec import EpisodeStats, MonitorState

    cols = _states()
    ours = CartPoleState(*(torch.from_numpy(v) for v in cols))
    ours = MonitorState(TimeLimitState(ours, torch.zeros(7, dtype=torch.int32)),
                        EpisodeStats.create(7, "cpu"))
    theirs = (JaxCartPoleState(*(jnp.asarray(v) for v in cols)), jnp.zeros(7, jnp.int32))
    got = torch_env_frame_fn(CartPole())(ours)
    want = jax_env_frame_fn(JaxTimeLimit(JaxCartPole(), 500))(theirs)
    assert got.shape == (800, 1200, 3)
    np.testing.assert_array_equal(got, want)


def _videos(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".mp4"))


def test_recorder_trigger_steps_match_jax(tmp_path):
    """build_env's VecVideoRecorder on CartPole-v1 (2 envs, a video of 3 frames every 8
    steps) opens its videos at the JAX recorder's steps over 30 steps of the same
    actions, each a file cv2 wrote."""
    actions = np.random.RandomState(0).randint(0, 2, (30, 2))
    theirs = jax_build_env("CartPole-v1", 2, normalize=False, save_video_interval=8,
                           save_video_length=3, video_dir=str(tmp_path / "jax"))
    key = jax.random.PRNGKey(0)
    _, state = theirs.reset(key)
    for a in actions:
        _, state, *_ = theirs.step(key, state, jnp.asarray(a, jnp.int32))
    theirs.close()
    ours = build_env("CartPole-v1", 2, device="cpu", normalize=False, save_video_interval=8,
                     save_video_length=3, video_dir=str(tmp_path / "port"))
    draws = Draws(0, "cpu")
    _, state = ours.reset(draws)
    for a in actions:
        _, state, *_ = ours.step(draws, state, torch.from_numpy(a))
    ours.close()
    names = _videos(tmp_path / "port")
    assert names == _videos(tmp_path / "jax") == [f"video.{t:09d}.mp4" for t in (0, 8, 16, 24)]
    assert all(os.path.getsize(tmp_path / "port" / n) > 0 for n in names)
    assert state.t == 30


def test_cli_save_video_interval_writes_videos(tmp_path):
    """run.main with --save_video_interval and --save_video_length writes its videos
    under the log dir's videos/ (JAX run.py:70-72), and --gamestate reaches build_env,
    which a non-retro id leaves unused."""
    model = run.main(["--alg=ppo2", "--env=CartPole-v1", "--num_timesteps=256", "--nsteps=32",
                      "--num_env=2", "--log_interval=1000", "--save_video_interval=32",
                      "--save_video_length=4", "--gamestate=Level1", "--device=cpu",
                      f"--log_path={tmp_path}"])
    assert model is not None
    names = _videos(tmp_path / "videos")
    assert names[:2] == ["video.000000000.mp4", "video.000000032.mp4"]


def test_record_video_of_a_policy(tmp_path):
    """record_video rolls a policy on CartPole-v1 and writes an mp4 of its frames."""
    from baselines_tpu_torch.algos.common import Model
    from baselines_tpu_torch.envs.registry import make_env
    from baselines_tpu_torch.nn.policy import build_policy

    env = make_env("CartPole-v1")
    policy = build_policy(env.observation_space, env.action_space, "mlp", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "video.mp4")
    record_video(Model(policy, None), env, path, video_length=30)
    assert os.path.getsize(path) > 1000


def test_ids_that_cannot_render_are_refused(tmp_path):
    """A native id with --save_video_interval raises ValueError before it opens a pool;
    so does a retro chain (retro.make has no render surface the pool can read)."""
    with pytest.raises(ValueError, match="native envs do not render"):
        build_env("native:CartPole-v1", 2, device="cpu", save_video_interval=10,
                  video_dir=str(tmp_path))
    with pytest.raises(ValueError, match="unsupported for retro"):
        make_host_vec_env("SonicTheHedgehog-Genesis", 2, "retro", device="cpu",
                          need_render=True)
