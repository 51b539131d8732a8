"""Advantage and return estimators over time-major (T, N) tensors (counterpart of
baselines_tpu/data/gae.py).

Index t holds (obs_t, value_t, action_t, reward_t, done_t), where done_t means the
episode ended AT step t. The recursions are the reference's reverse loops
(ppo2/runner.py:56-65, a2c/utils.py:147-153); the JAX package evaluates them as an
associative scan, which is a TPU choice.
"""

from __future__ import annotations

import torch


def affine_reverse_scan(coefs: torch.Tensor, deltas: torch.Tensor, init: torch.Tensor):
    """y_t = deltas_t + coefs_t * y_{t+1} along axis 0, with y_T = init (gae.py:22-44):
    the first-order linear recurrence under ``gae``, ``nstep_returns`` and
    ``core.math.discount``, run backwards step by step."""
    out = torch.empty_like(deltas)
    y = init
    for t in range(deltas.shape[0] - 1, -1, -1):
        y = deltas[t] + coefs[t] * y
        out[t] = y
    return out


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """Generalized advantage estimation; returns (advantages, returns) with
    returns = advantages + values (ppo2/runner.py:56-65)."""
    nonterminal = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rewards + gamma * next_values * nonterminal - values
    advs = affine_reverse_scan(gamma * lam * nonterminal, deltas, torch.zeros_like(last_value))
    return advs, advs + values


def nstep_returns(rewards, dones, last_value, gamma: float):
    """Bootstrapped n-step returns R_t = r_t + gamma * R_{t+1} * (1 - done_t), with
    R_T = V(obs_T) (a2c/runner.py:58-69)."""
    nonterminal = 1.0 - dones.to(torch.float32)
    return affine_reverse_scan(gamma * nonterminal, rewards, last_value)


def discount_with_dones(rewards, dones, gamma: float):
    """Discounted sum with done masking and no bootstrap (a2c/utils.py:147-153)."""
    return nstep_returns(rewards, dones, torch.zeros_like(rewards[-1]), gamma)
