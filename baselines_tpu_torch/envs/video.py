"""Video capture (counterpart of baselines_tpu/envs/video.py, after
baselines/common/vec_env/vec_video_recorder.py).

- ``VideoRecorder``: a frame sink that writes an mp4 with cv2, imported where it writes.
- ``record_video(model, env, path)``: a trained policy rolled on one device env that
  renders (``render_frame(state)``), written to ``path``.
- ``VecVideoRecorder``: the ``--save_video_interval`` / ``--save_video_length``
  wrapper (run.py:104-108): at each step whose global count fires
  ``record_video_trigger``, the next ``video_length`` frames from ``frame_fn(state)``
  go to ``<directory>/video.<step>.mp4``.
- ``torch_env_frame_fn(env)``: the frames of a device env's batch, up to four envs
  tiled; a host pool's frames are its ``render()``.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from baselines_tpu_torch.core import logger
from baselines_tpu_torch.core.rng import Draws
from baselines_tpu_torch.core.tile_images import tile_images
from baselines_tpu_torch.envs.vec import VecWrapper


class VideoRecorder:
    def __init__(self, path: str, fps: int = 30):
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        self.path = path
        self.fps = fps
        self._writer = None

    def append(self, frame: np.ndarray) -> None:
        """Write one HWC u8 RGB frame; the first one sets the video's size."""
        import cv2

        frame = np.asarray(frame)
        if self._writer is None:
            h, w = frame.shape[:2]
            self._writer = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*"mp4v"),
                                           self.fps, (w, h))
        self._writer.write(np.ascontiguousarray(frame[..., ::-1]))  # RGB -> BGR

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            logger.log(f"Saved video to {self.path}")


def base_state(state):
    """The env's own state under the vec wrappers' and TimeLimit's (each has ``inner``)."""
    while dataclasses.is_dataclass(state) and hasattr(state, "inner"):
        state = state.inner
    return state


def env_row(state, i: int):
    """Env ``i``'s state, each field a scalar on the host."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[i].cpu() for f in dataclasses.fields(state)})


def record_video(model, env, path: str, video_length: int = 200, seed: int = 0) -> str:
    """Roll ``model``'s deterministic policy on one env of the device env ``env`` (which
    renders) for ``video_length`` steps, reset where done, and write the frames to
    ``path``."""
    device = model.device
    draws = Draws(seed, device)
    obs, state = env.reset(draws, 1, device)
    rec = VideoRecorder(path)
    try:
        for _ in range(video_length):
            rec.append(env.unwrapped.render_frame(env_row(base_state(state), 0)))
            action = model.policy.mode_step(obs)[0]
            obs, state, _, done, _ = env.step(draws, state, action)
            if bool(done[0]):
                obs, state = env.reset(draws, 1, device)
    finally:
        rec.close()
    return path


@dataclass
class VideoState:
    inner: Any
    t: int  # the global step count


class VecVideoRecorder(VecWrapper):
    """Trigger-based mp4 capture around a training env (video.py:93-160): after each
    step, ``frame_fn`` renders the new env state while a video is open; a video opens at
    a step whose count (from 0) fires ``record_video_trigger`` and closes after
    ``video_length`` frames."""

    def __init__(self, venv, directory, record_video_trigger, video_length=200,
                 frame_fn=None, fps=30):
        super().__init__(venv)
        self.directory = osp.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.trigger = record_video_trigger
        self.video_length = int(video_length)
        self.frame_fn = frame_fn
        self.fps = fps
        self._rec = None
        self._frames_left = 0

    def _tick(self, t: int, state) -> None:
        if self._rec is None and self.trigger(t):
            self._rec = VideoRecorder(osp.join(self.directory, f"video.{t:09d}.mp4"), self.fps)
            self._frames_left = self.video_length
        if self._rec is not None:
            self._rec.append(self.frame_fn(state))
            self._frames_left -= 1
            if self._frames_left <= 0:
                self.close_recorder()

    def close_recorder(self) -> None:
        if self._rec is not None:
            self._rec.close()
            self._rec = None

    def reset(self, draws):
        obs, inner = self.venv.reset(draws)
        return obs, VideoState(inner, 0)

    def unwrap_state(self, state):
        return state.inner

    def post(self, state, obs, inner, rew, done, info):
        self._tick(state.t, inner)
        return obs, VideoState(inner, state.t + 1), rew, done, info

    def close(self) -> None:
        self.close_recorder()
        super().close()


def torch_env_frame_fn(env, max_tiles: int = 4):
    """frame_fn for a device env's batch: the first ``max_tiles`` envs of the base state
    rendered by ``env.unwrapped.render_frame`` and tiled into one image."""

    def fn(state):
        state = base_state(state)
        n = next(getattr(state, f.name) for f in dataclasses.fields(state)).shape[0]
        with torch.no_grad():
            return tile_images([env.unwrapped.render_frame(env_row(state, i))
                                for i in range(min(n, max_tiles))])

    return fn
