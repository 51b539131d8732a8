"""Carry weights across: the JAX package's flax params, as numpy arrays, to the port's
``state_dict``.

- conv kernels HWIO -> OIHW;
- Dense kernels (in, out) -> Linear weights (out, in), with a ``bias`` where the flax
  layer has one (the LSTM's ``wx`` and ``wh`` have none);
- LayerNorm ``scale`` -> ``weight``;
- a raw parameter (the LSTM's ``b``, the diagonal Gaussian's ``logstd``) as it is;
- the fc layer's input order stays NHWC on both sides, since the port's CNNs flatten in
  NHWC order;
- the port's modules carry the flax names, nested as flax nests them, so each flax
  module maps to the module of its own dotted path: ``network.mlp_fc0``,
  ``network._ImpalaResBlock_3.Conv_1``, ``network.encoder.c1``, ``network.lstm.wx``,
  ``value_network.mlp_fc0`` (a policy built with ``value_network="copy"``), ``pi``,
  ``vf``, and the QNet streams of deepq (algos/dqn/dqn.py:54-81). The ``pi`` layer's
  width is the distribution's: the action count, the sum of a MultiDiscrete's counts,
  or the Gaussian's dimension.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _layer(prefix: str, leaf: Mapping) -> dict:
    """A Dense or Conv layer's ``kernel`` and optional ``bias``."""
    kernel = np.asarray(leaf["kernel"])
    if kernel.ndim == 4:  # conv, HWIO
        weight = kernel.transpose(3, 2, 0, 1)
    elif kernel.ndim == 2:  # dense, (in, out)
        weight = kernel.T
    else:
        raise ValueError(f"{prefix}: unexpected kernel shape {kernel.shape}")
    out = {f"{prefix}weight": _tensor(weight)}
    if "bias" in leaf:
        out[f"{prefix}bias"] = _tensor(leaf["bias"])
    return out


def _tree(prefix: str, params: Mapping) -> dict:
    """Each flax module of ``params`` under its dotted path: a Dense or Conv layer
    (``kernel``), a LayerNorm (``scale``), a raw parameter, or a module of modules."""
    out = {}
    for name, leaf in params.items():
        path = f"{prefix}{name}"
        if not isinstance(leaf, Mapping):
            out[path] = _tensor(leaf)
        elif "kernel" in leaf:
            out.update(_layer(f"{path}.", leaf))
        elif "scale" in leaf:
            out[f"{path}.weight"] = _tensor(leaf["scale"])
            out[f"{path}.bias"] = _tensor(leaf["bias"])
        else:
            out.update(_tree(f"{path}.", leaf))
    return out


def network_state_dict(params: Mapping) -> dict:
    """Flax params, with or without the outer 'params', -> the state_dict of the port's
    module of the same tree: a network's ({'mlp_fc0': ..., 'LayerNorm_0': ...}; {'c1':
    ..., 'fc1': ...}; {'encoder': {...}, 'lstm': {'wx': ..., 'b': ...}}), a
    PolicyValueNet's ({'network': ..., 'pi': ..., 'vf': ...}, with 'value_network' for
    a separate value tower and 'logstd' for a Gaussian head) or a QNet's ({'network':
    ..., 'action_value_fc0': ..., ...})."""
    return _tree("", params.get("params", params))


# the same mapping, under the names of the module each tree belongs to
policy_state_dict = q_state_dict = network_state_dict
