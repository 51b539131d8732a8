"""Expert dataset (counterpart of baselines_tpu/algos/gail/dataset.py, after
baselines/gail/dataset/mujoco_dset.py).

``ExpertDataset`` holds (obs, acs) rows on the device: from arrays, or from an ``.npz``
in the reference schema (``obs`` (E, T, do), ``acs`` (E, T, da)), the first
``traj_limitation`` trajectories kept when it is positive, then flattened to rows.
Arrays are placed on ``device``, the card unless the caller passes ``"cpu"``; tensors
stay where they are. ``sample`` draws ``batch_size`` row indices uniformly with
replacement and reads both fields through the row-gather kernel (``ops/gather.py``). f64
arrays are kept in f32, as the JAX package keeps them without x64.
"""

from __future__ import annotations

import numpy as np
import torch

from baselines_tpu_torch.core.device import resolve_device
from baselines_tpu_torch.ops.gather import take_rows


def _device_array(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(x), device=resolve_device(device))


class ExpertDataset:
    def __init__(self, obs=None, acs=None, expert_path: str | None = None,
                 traj_limitation: int = -1, device=None):
        if expert_path is not None:
            with np.load(expert_path, allow_pickle=True) as data:
                obs, acs = data["obs"], data["acs"]
            if traj_limitation > 0:
                obs, acs = obs[:traj_limitation], acs[:traj_limitation]
            obs = obs.reshape((-1,) + obs.shape[2:]) if obs.ndim > 2 else obs
            acs = acs.reshape((-1,) + acs.shape[2:]) if acs.ndim > 2 else acs
        if obs is None or acs is None:
            raise ValueError("an ExpertDataset needs obs and acs, or an expert_path")
        self.obs = obs if isinstance(obs, torch.Tensor) else _device_array(obs, device)
        self.acs = acs if isinstance(acs, torch.Tensor) else _device_array(acs, device)
        self.n = self.obs.shape[0]

    def sample(self, draws, batch_size: int):
        """(obs, acs) of ``batch_size`` rows drawn with replacement."""
        idx = draws.randint(0, self.n, (batch_size,)).to(torch.int64)
        return take_rows(self.obs, idx), take_rows(self.acs, idx)


@torch.no_grad()
def collect_expert(model, venv, draws, nsteps: int = 1000) -> ExpertDataset:
    """Roll a trained model's deterministic policy for ``nsteps`` steps of ``venv`` from
    a reset and keep every (obs, action) pair, time-major flattened (dataset.py:33-59)."""
    policy = model.policy
    obs, env_state = venv.reset(draws)
    rnn = policy.initial_state(venv.num_envs)
    done = torch.zeros((venv.num_envs,), dtype=torch.bool, device=obs.device)
    obs_t, acs_t = [], []
    for _ in range(nsteps):
        if rnn is None:
            action = policy.mode_step(obs)[0]
        else:
            action, _, rnn = policy.mode_step(obs, None, rnn, done.to(torch.float32))
        obs_t.append(obs)
        acs_t.append(action)
        obs, env_state, _, done, _ = venv.step(draws, env_state, action)
    obs_all, acs_all = torch.stack(obs_t), torch.stack(acs_t)
    return ExpertDataset(obs=obs_all.reshape((-1,) + tuple(obs_all.shape[2:])),
                         acs=acs_all.reshape((-1,) + tuple(acs_all.shape[2:])))
