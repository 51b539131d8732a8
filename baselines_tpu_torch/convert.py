"""Carry weights across: the JAX package's flax params, as numpy arrays, to the port's
``state_dict``.

- conv kernels HWIO -> OIHW;
- Dense kernels (in, out) -> Linear weights (out, in);
- the fc layer's input order stays NHWC (7, 7, 64) -> 3136 on both sides, since the
  port's network flattens in NHWC order;
- names ``c1``, ``c2``, ``c3``, ``fc1`` of the network (nn/networks.py:139-143),
  ``pi``, ``vf`` of the policy (nn/policy.py:75-88) and the QNet streams of deepq
  (algos/dqn/dqn.py:54-81).
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


def network_state_dict(params: dict) -> dict:
    """A NatureCNNS2D's flax params ({'c1': {'kernel', 'bias'}, ...}, with or without
    the outer 'params') -> its state_dict."""
    params = params.get("params", params)
    out = {}
    for name in ("c1", "c2", "c3", "fc1"):
        out.update(_layer(f"{name}.", params[name]))
    return out


def policy_state_dict(params: dict) -> dict:
    """A PolicyValueNet's flax params ({'network': ..., 'pi': ..., 'vf': ...}, with or
    without the outer 'params') -> the port's PolicyValueNet state_dict."""
    params = params.get("params", params)
    out = {f"network.{k}": v for k, v in network_state_dict(params["network"]).items()}
    out.update(_layer("pi.", params["pi"]))
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
        if name == "network":
            continue
        if "_ln" in name:
            out[f"{name}.weight"] = torch.tensor(np.asarray(leaf["scale"], np.float32))
            out[f"{name}.bias"] = torch.tensor(np.asarray(leaf["bias"], np.float32))
        else:
            out.update(_layer(f"{name}.", leaf))
    return out
