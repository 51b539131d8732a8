"""Action and parameter noise for DDPG (counterpart of baselines_tpu/algos/ddpg/noise.py,
after baselines/ddpg/noise.py).

- ``NormalActionNoise`` (noise.py:36-46): independent Gaussian noise each step.
- ``OUActionNoise`` (noise.py:49-67): Ornstein-Uhlenbeck noise, its state (N, d) carried
  in the train state and zeroed where an env's episode ends.
- Adaptive parameter noise (noise.py:4-31, ddpg_learner.py:155-170): Gaussian noise on
  the actor's parameters except the layer norms', its standard deviation adapted toward
  a desired distance in action space (times or over 1.01).

Every draw comes from the run's ``Draws``: one ``normal`` of the noise state's shape an
action noise sample, one ``normal`` of each perturbable parameter's shape a
perturbation, in the order of the parameters' sorted dotted names, which is the order in
which the JAX package flattens the flax tree (its keys sorted at every level; ``bias``
before ``kernel`` or ``scale`` as before ``weight``). Under a data-parallel mesh the
action noise takes a ``ShardedDraws`` (its state holds the rank's env rows, its normals
the rank's rows of the global draw) and the perturbations the replicated draws.
"""

from __future__ import annotations

import numpy as np
import torch


def parse_noise_type(noise_type: str, nb_actions: int):
    """'adaptive-param_0.2', 'normal_0.1', 'ou_0.2', comma-separated, or 'none'
    (ddpg/ddpg.py:70-92). Returns (action noise or None, parameter noise's initial
    standard deviation or None)."""
    param_noise_std = None
    action_noise = None
    for tok in noise_type.split(","):
        tok = tok.strip()
        if not tok or tok == "none":
            continue
        name, _, val = tok.partition("_")
        std = float(val) if val else 0.1
        if name == "adaptive-param":
            param_noise_std = std
        elif name == "normal":
            action_noise = NormalActionNoise(sigma=std, nb_actions=nb_actions)
        elif name == "ou":
            action_noise = OUActionNoise(sigma=std, nb_actions=nb_actions)
        else:
            raise RuntimeError(f"unknown noise type {tok!r}")
    return action_noise, param_noise_std


class NormalActionNoise:
    stateful = False

    def __init__(self, sigma: float, nb_actions: int, mu: float = 0.0):
        self.sigma = sigma
        self.mu = mu
        self.nb_actions = nb_actions

    def init_state(self, nenvs: int, device) -> torch.Tensor:
        return torch.zeros((nenvs, self.nb_actions), dtype=torch.float32, device=device)

    def sample(self, draws, state: torch.Tensor):
        """(noise, state): mu + sigma * N(0, 1), the state unchanged."""
        return self.mu + self.sigma * draws.normal(state.shape), state


class OUActionNoise:
    """dx = theta (mu - x) dt + sigma sqrt(dt) N(0, 1) (noise.py:49-67)."""

    stateful = True

    def __init__(self, sigma: float, nb_actions: int, mu: float = 0.0, theta: float = 0.15,
                 dt: float = 1e-2):
        self.sigma = sigma
        self.mu = mu
        self.theta = theta
        self.dt = dt
        self.nb_actions = nb_actions
        # sigma * sqrt(dt) in f32, as the JAX package computes it
        self._scale = float(np.float32(sigma) * np.sqrt(np.float32(dt)))

    def init_state(self, nenvs: int, device) -> torch.Tensor:
        return torch.zeros((nenvs, self.nb_actions), dtype=torch.float32, device=device)

    def sample(self, draws, state: torch.Tensor):
        """(noise, state): the new x, which is both."""
        x = (state + self.theta * (self.mu - state) * self.dt
             + self._scale * draws.normal(state.shape))
        return x, x


def is_perturbable(name: str) -> bool:
    """Everything but layer-norm parameters (ddpg/models.py perturbable_vars): no part of
    the dotted ``name`` holds ``LayerNorm`` or starts with ``ln``."""
    return not any("LayerNorm" in part or part.startswith("ln") for part in name.split("."))


def draw_perturbation(draws, params: dict) -> dict:
    """N(0, 1) of each perturbable tensor's shape, by name, drawn in sorted-name order."""
    return {name: draws.normal(params[name].shape)
            for name in sorted(params, key=lambda n: n.split(".")) if is_perturbable(name)}


def add_perturbation(params: dict, noise: dict, stddev: torch.Tensor) -> dict:
    """``params`` with ``stddev`` times ``noise`` added where ``noise`` has the name."""
    return {k: p + stddev * noise[k] if k in noise else p for k, p in params.items()}


def perturb_params(draws, params: dict, stddev: torch.Tensor) -> dict:
    """``params`` (name -> tensor) with N(0, stddev) added to each perturbable tensor
    (ddpg_learner.py get_perturbed_actor_updates)."""
    return add_perturbation(params, draw_perturbation(draws, params), stddev)


def adapt_param_noise_stddev(stddev: torch.Tensor, distance: torch.Tensor, desired: float,
                             coefficient: float = 1.01) -> torch.Tensor:
    """noise.py:12-18: shrink when the actions moved too far, grow otherwise."""
    return torch.where(distance > desired, stddev / coefficient, stddev * coefficient)
