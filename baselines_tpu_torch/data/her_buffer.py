"""Episode replay with hindsight goal relabeling on the device (counterpart of
baselines_tpu/data/her_buffer.py, after her/replay_buffer.py:6-108 and
her/her_sampler.py:4-63).

The storage is episode-major and flat: episode slot ``e`` holds its T + 1 observations
and achieved goals in rows ``e * (T + 1) ...`` of ``o`` (C * (T + 1), do) and ``ag``
(C * (T + 1), dg), and its T goals and actions in rows ``e * T ...`` of ``g`` and ``u``,
so that every read of a sample is one row gather (``ops/gather.py``) at ``ep * (T + 1) +
t`` or ``ep * T + t``, the same rows the JAX package reads as ``state.o[ep, t]``.
Episodes go to slots in order until the buffer is full, then to random slots
(replay_buffer.py:60-84). ``sample`` relabels with the 'future' strategy: with
probability 1 - 1 / (1 + replay_k) the goal is the achieved goal of a later step of the
same episode, drawn uniformly from (t, T], and the reward is recomputed by the env's
``compute_reward``.

The episode count is a host integer, as the ring cursor of ``data/replay.py`` is.
Draws: a store takes one ``randint`` of its episodes' random slots, always; a sample
takes the episodes (``randint``), the steps (``randint``), the relabel mask's uniforms
and the future offsets' uniforms, in that order.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from baselines_tpu_torch.ops.gather import take_rows


@dataclass
class HerBufferState:
    o: torch.Tensor  # (C * (T + 1), do) f32
    ag: torch.Tensor  # (C * (T + 1), dg) f32
    g: torch.Tensor  # (C * T, dg) f32
    u: torch.Tensor  # (C * T, du) f32
    n_episodes: int = 0  # ever stored


class HerReplayBuffer:
    def __init__(self, capacity_episodes: int, T: int, dims: dict):
        """``dims``: {'o': do, 'g': dg, 'u': du}."""
        self.C = int(capacity_episodes)
        self.T = int(T)
        self.dims = dims

    def init(self, device) -> HerBufferState:
        C, T, d = self.C, self.T, self.dims

        def zeros(rows, width):
            return torch.zeros((rows, width), dtype=torch.float32, device=device)

        return HerBufferState(o=zeros(C * (T + 1), d["o"]), ag=zeros(C * (T + 1), d["g"]),
                              g=zeros(C * T, d["g"]), u=zeros(C * T, d["u"]))

    def store_episodes(self, state: HerBufferState, draws, o, ag, g, u) -> HerBufferState:
        """Store B episodes, o/ag (B, T + 1, .) and g/u (B, T, .), in place: in order
        while the buffer has room, else at random slots."""
        b, T = o.shape[0], self.T
        dev = o.device
        rand_idx = draws.randint(0, self.C, (b,)).to(torch.int64)
        order = state.n_episodes + torch.arange(b, device=dev)
        idx = torch.where(order < self.C, order % self.C, rand_idx)
        rows1 = (idx[:, None] * (T + 1) + torch.arange(T + 1, device=dev)).reshape(-1)
        rows = (idx[:, None] * T + torch.arange(T, device=dev)).reshape(-1)
        state.o.index_copy_(0, rows1, o.reshape(b * (T + 1), -1))
        state.ag.index_copy_(0, rows1, ag.reshape(b * (T + 1), -1))
        state.g.index_copy_(0, rows, g.reshape(b * T, -1))
        state.u.index_copy_(0, rows, u.reshape(b * T, -1))
        return replace(state, n_episodes=state.n_episodes + b)

    def sample(self, state: HerBufferState, draws, batch_size: int, replay_k: float,
               compute_reward) -> dict:
        """dict(o, o2, g, u, r, ag2) of ``batch_size`` transitions with 'future'
        relabeling (her_sampler.py:14-61)."""
        T = self.T
        n_valid = min(max(state.n_episodes, 1), self.C)
        ep = draws.randint(0, n_valid, (batch_size,)).to(torch.int64)
        t = draws.randint(0, T, (batch_size,)).to(torch.int64)
        her_mask = draws.uniform((batch_size,), 0.0, 1.0) < 1.0 - 1.0 / (1.0 + replay_k)
        offset = draws.uniform((batch_size,), 0.0, 1.0) * (T - t).to(torch.float32)
        future_t = torch.clamp(t + 1 + offset.to(torch.int64), 0, T)

        row1 = ep * (T + 1)
        g_orig = take_rows(state.g, ep * T + t)
        g_future = take_rows(state.ag, row1 + future_t)
        g_used = torch.where(her_mask[:, None], g_future, g_orig)
        ag2 = take_rows(state.ag, row1 + t + 1)
        return {"o": take_rows(state.o, row1 + t), "o2": take_rows(state.o, row1 + t + 1),
                "g": g_used, "u": take_rows(state.u, ep * T + t),
                "r": compute_reward(ag2, g_used), "ag2": ag2}
