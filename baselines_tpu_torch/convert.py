"""Carry weights across: the JAX package's flax params, as numpy arrays, to the port's
``state_dict``.

- conv kernels HWIO -> OIHW;
- Dense kernels (in, out) -> Linear weights (out, in);
- LayerNorm ``scale`` -> ``weight``;
- the fc layer's input order stays NHWC on both sides, since the port's CNNs flatten in
  NHWC order;
- the port's modules carry the flax names, so each flax leaf maps to the module of its
  own name: ``mlp_fc{i}`` and ``LayerNorm_{i}`` of ``mlp``, ``c1``, ``c2``, ``c3``,
  ``fc1`` of ``cnn`` and ``cnn_s2d`` (nn/networks.py:61-143), ``pi``, ``vf`` and, for a
  ``Box`` action space, the diagonal Gaussian's ``logstd`` parameter of the policy
  (nn/policy.py:73-88), and the QNet streams of deepq (algos/dqn/dqn.py:54-81). The
  ``pi`` layer's width is the distribution's: the action count, the sum of a
  MultiDiscrete's counts, or the Gaussian's dimension.
"""

from __future__ import annotations

import numpy as np
import torch


def _layer(prefix: str, leaf: dict) -> dict:
    kernel = np.asarray(leaf["kernel"])
    if kernel.ndim == 4:  # conv, HWIO
        weight = kernel.transpose(3, 2, 0, 1)
    elif kernel.ndim == 2:  # dense, (in, out)
        weight = kernel.T
    else:
        raise ValueError(f"{prefix}: unexpected kernel shape {kernel.shape}")
    return {
        f"{prefix}weight": torch.tensor(np.asarray(weight, np.float32)),
        f"{prefix}bias": torch.tensor(np.asarray(leaf["bias"], np.float32)),
    }


def _module(prefix: str, leaf: dict) -> dict:
    """One flax module's leaves: a LayerNorm's (``scale``) or a Dense or Conv layer's."""
    if "scale" in leaf:
        return {f"{prefix}weight": torch.tensor(np.asarray(leaf["scale"], np.float32)),
                f"{prefix}bias": torch.tensor(np.asarray(leaf["bias"], np.float32))}
    return _layer(prefix, leaf)


def network_state_dict(params: dict) -> dict:
    """A network's flax params (``mlp``: {'mlp_fc0': ..., 'LayerNorm_0': ...}; ``cnn``
    and ``cnn_s2d``: {'c1': ..., 'fc1': ...}; with or without the outer 'params') -> its
    state_dict, each flax module mapped to the port's module of the same name."""
    params = params.get("params", params)
    out = {}
    for name, leaf in params.items():
        out.update(_module(f"{name}.", leaf))
    return out


def policy_state_dict(params: dict) -> dict:
    """A PolicyValueNet's flax params ({'network': ..., 'pi': ..., 'vf': ...} and
    'logstd' for a Gaussian head, with or without the outer 'params') -> the port's
    PolicyValueNet state_dict."""
    params = params.get("params", params)
    out = {f"network.{k}": v for k, v in network_state_dict(params["network"]).items()}
    out.update(_layer("pi.", params["pi"]))
    if "logstd" in params:
        out["logstd"] = torch.tensor(np.asarray(params["logstd"], np.float32))
    out.update(_layer("vf.", params["vf"]))
    return out


def q_state_dict(params: dict) -> dict:
    """A QNet's flax params ({'network': ..., 'action_value_fc0': ..., ...}, with or
    without the outer 'params') -> the port's QNet state_dict: the network as
    ``network_state_dict`` takes it, each stream's Dense layers as Linear layers, and
    each LayerNorm's ``scale`` as its ``weight``."""
    params = params.get("params", params)
    out = {f"network.{k}": v for k, v in network_state_dict(params["network"]).items()}
    for name, leaf in params.items():
        if name != "network":
            out.update(_module(f"{name}.", leaf))
    return out
