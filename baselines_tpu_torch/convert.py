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
  ``vf``, the QNet streams of deepq (algos/dqn/dqn.py:54-81), ddpg's ``Actor`` (``network``,
  ``pi``) and ``Critic`` (``network``, ``output``), her's ``GoalActor`` and ``GoalCritic``
  of the same names, and ``network.LayerNorm_{i}`` where the MLP has layer norms. The
  ``pi`` layer's width is the distribution's: the action count, the sum of a
  MultiDiscrete's counts, or the Gaussian's dimension; trpo's policy is a PolicyValueNet
  with its ``value_network`` tower, acer's has a ``q`` head in place of ``vf``, and gail's
  discriminator is ``Dense_0``..``Dense_2``;
- gail's filtered policy, {"pi": <policy tree>, "ob_rms": <RunningMeanStd>}, to
  ``pi.<policy>`` and the ``ob_rms_mean``/``_var``/``_count`` buffers
  (``obs_norm_policy_state_dict``);
- acktr's explicit tree {"layers": [(W, b), ...], "pi": (W, b), "vf": (W, b),
  ["logstd"]} to ``layers.<i>``, ``pi``, ``vf`` (``kfac_state_dict``), where the first
  dense layer after the convs reads (C, H, W) rows in the port and (H, W, C) rows in
  the JAX package: its rows are permuted here, once.
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
    a separate value tower and 'logstd' for a Gaussian head), a QNet's ({'network':
    ..., 'action_value_fc0': ..., ...}), an actor's ({'network': ..., 'pi': ...}) or a
    critic's ({'network': ..., 'output': ...})."""
    return _tree("", params.get("params", params))


# the same mapping, under the names of the module each tree belongs to
policy_state_dict = q_state_dict = actor_state_dict = critic_state_dict = network_state_dict


def obs_norm_policy_state_dict(params: Mapping) -> dict:
    """gail's {"pi": flax policy params, "ob_rms": RunningMeanStd} -> the state_dict of
    ``algos.gail.gail.ObsNormPolicyValueNet``."""
    out = {f"pi.{k}": v for k, v in network_state_dict(params["pi"]).items()}
    rms = params["ob_rms"]
    for field in ("mean", "var", "count"):
        out[f"ob_rms_{field}"] = _tensor(getattr(rms, field))
    return out


def kfac_state_dict(params: Mapping, conv_hw: tuple | None) -> dict:
    """acktr's KfacPolicyNet params -> the state_dict of the port's ``KfacPolicyNet``.
    Conv kernels HWIO -> OIHW, dense kernels transposed; the first dense layer after a
    conv has its input rows permuted from (H, W, C) to (C, H, W), with (H, W) =
    ``conv_hw`` the last conv's output size (``KfacPolicyNet.conv_out_hw``, None for an
    mlp)."""
    out, prev_channels = {}, None
    for i, (w, b) in enumerate(params["layers"]):
        w = np.asarray(w)
        if w.ndim == 4:
            out[f"layers.{i}.weight"] = _tensor(w.transpose(3, 2, 0, 1))
            prev_channels = w.shape[3]
        else:
            if prev_channels is not None:  # the flatten of the last conv's output
                h, wd = conv_hw
                if h * wd * prev_channels != w.shape[0]:
                    raise ValueError(f"layers.{i}: {w.shape[0]} rows are not "
                                     f"{h}x{wd}x{prev_channels}")
                w = w.reshape(h, wd, prev_channels, -1).transpose(2, 0, 1, 3).reshape(w.shape)
                prev_channels = None
            out[f"layers.{i}.weight"] = _tensor(w.T)
        out[f"layers.{i}.bias"] = _tensor(b)
    for name in ("pi", "vf"):
        w, b = params[name]
        out[f"{name}.weight"] = _tensor(np.asarray(w).T)
        out[f"{name}.bias"] = _tensor(b)
    if "logstd" in params:
        out["logstd"] = _tensor(params["logstd"])
    return out
