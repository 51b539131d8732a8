"""Frame-deduplicated trajectory chunks (counterpart of baselines_tpu/data/frame_chunk.py,
after the reference's ACER buffer, acer/buffer.py:3-156, which keeps raw frames and
restacks them on read, so that a k-frame-stacked replay costs one frame of memory a step
rather than k).

The codec works on chunks of VecFrameStack observations (the last axis is k frames of C
channels, oldest first, the stack zeroed on an episode's reset), with an optional
leading batch axis on every argument:

- ``compress_frames``: obs (T+1, ..., k*C), dones (T,) -> first (..., k*C), the first
  stacked observation whole, and frames (T, ..., C), the newest frame of each later one;
- ``decompress_frames``: the inverse, every stacked observation rebuilt as k shifted
  slices of the frame timeline, each masked to zero where its frame belongs to an earlier
  episode than the observation (done[t] ends the episode of obs[t]).

Both are bit for bit the JAX package's functions.
"""

from __future__ import annotations

import torch


def compress_frames(obs: torch.Tensor, dones: torch.Tensor, k: int):
    """(first, frames) of a stacked chunk ``obs`` (the time axis after the batch axis
    when ``dones`` has one)."""
    kc = obs.shape[-1]
    if kc % k:
        raise ValueError(f"last axis {kc} is not divisible by the stack depth {k}")
    c = kc // k
    t_axis = dones.dim() - 1
    first = obs.select(t_axis, 0)
    frames = obs.narrow(t_axis, 1, obs.shape[t_axis] - 1)[..., -c:]
    return first, frames


def decompress_frames(first: torch.Tensor, frames: torch.Tensor, dones: torch.Tensor,
                      k: int) -> torch.Tensor:
    """The stacked chunk (T+1, ..., k*C) rebuilt from ``compress_frames``' output."""
    batched = dones.dim() == 2
    if not batched:
        first, frames, dones = first[None], frames[None], dones[None]
    n, t_len = dones.shape
    c = frames.shape[-1]
    # the frame timeline: the k frames of the first observation (oldest first), then the
    # T rollout frames, (n, k + T, ..., C)
    init = torch.movedim(first.reshape(first.shape[:-1] + (k, c)), -2, 1)
    f = torch.cat([init, frames], dim=1)
    # the episode of each step 0..T and of each frame; frame j was made at step
    # j - (k - 1), the initial ones at step 0
    epi = torch.cat([torch.zeros((n, 1), dtype=torch.int32, device=dones.device),
                     torch.cumsum(dones.to(torch.int32), dim=1, dtype=torch.int32)], dim=1)
    frame_step = torch.clamp(torch.arange(k + t_len, device=dones.device) - (k - 1), 0, t_len)
    frame_epi = epi[:, frame_step]
    parts = []
    for j in range(k):  # channel group j holds frame t + j
        part = f[:, j:j + t_len + 1]
        alive = (frame_epi[:, j:j + t_len + 1] == epi).reshape(
            (n, t_len + 1) + (1,) * (part.dim() - 2))
        parts.append(torch.where(alive, part, torch.zeros_like(part)))
    out = torch.cat(parts, dim=-1).to(first.dtype)
    return out if batched else out[0]
