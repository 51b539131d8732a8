"""Small math utilities (counterpart of baselines_tpu/core/math.py)."""

from __future__ import annotations

import torch

from baselines_tpu_torch.data.gae import affine_reverse_scan


def discount(x, gamma: float) -> torch.Tensor:
    """y[t] = x[t] + gamma * x[t+1] + gamma^2 * x[t+2] + ... along axis 0
    (math_util.py:8-27), the reverse recurrence y[t] = x[t] + gamma * y[t+1]. An f64
    input is summed in f32, as the JAX package sums it without x64."""
    x = torch.as_tensor(x)
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    return affine_reverse_scan(torch.full_like(x, gamma), x, torch.zeros_like(x[0]))


def explained_variance(ypred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - Var[y - ypred] / Var[y], nan when Var[y] == 0 (math_util.py:29-47)."""
    ypred = ypred.reshape(-1).to(torch.float32)
    y = y.reshape(-1).to(torch.float32)
    vary = torch.var(y, correction=0)
    ev = 1.0 - torch.var(y - ypred, correction=0) / vary
    return torch.where(vary == 0, torch.full_like(ev, float("nan")), ev)


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Quadratic within |x| <= delta, linear outside (tf_util.py:39-49)."""
    abs_x = torch.abs(x)
    quad = torch.clamp(abs_x, max=delta)
    return 0.5 * quad * quad + delta * (abs_x - quad)


def _leaves(tree) -> list:
    """The tensors of a list, tuple or dict of tensors, in its order (a dict's in key
    order as inserted)."""
    if isinstance(tree, dict):
        return list(tree.values())
    return list(tree)


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every tensor of ``tree``, in f32 (math.py:48-53,
    tf.global_norm)."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def flatten_tree(tree) -> torch.Tensor:
    """Every tensor of ``tree`` raveled and concatenated into one f32 vector, in the
    tree's order (math.py:56-60, tf_util's GetFlat/flatgrad)."""
    return torch.cat([x.reshape(-1).to(torch.float32) for x in _leaves(tree)])


def unflatten_like(vec: torch.Tensor, tree):
    """The inverse of ``flatten_tree``: ``vec`` cut into the shapes and dtypes of
    ``tree``'s tensors, in the same structure (math.py:63-72, SetFromFlat)."""
    leaves = _leaves(tree)
    total = sum(x.numel() for x in leaves)
    if total != vec.numel():
        raise ValueError(f"a vector of {vec.numel()} values for a tree of {total}")
    out, i = [], 0
    for x in leaves:
        out.append(vec[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), out))
    return type(tree)(out) if isinstance(tree, tuple) else out
