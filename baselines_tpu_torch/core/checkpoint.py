"""Whole-train-state checkpoints (counterpart of baselines_tpu/core/checkpoint.py).

The port's format is ``torch.save`` of a nested dict of tensors, ints and floats, read
back with ``torch.load(weights_only=True)``, which unpickles nothing else. A state is
turned into that tree on save:

- a dataclass becomes a dict of its fields by name;
- an object with ``state_dict()`` (an ``nn.Module``, ``ClipAdam``, ``Draws``) becomes
  that dict;
- a list or tuple becomes a list;
- None (the carry of a feedforward policy) stays None.

``load_state(path, target)`` rebuilds the tree into a template of the same structure (a
freshly built train state): dataclasses are made anew, objects with
``load_state_dict`` are loaded in place, and each tensor lands on the device of the
template's tensor, so a checkpoint written on the card loads on the CPU and back. Its
shape and dtype must match. Periodic checkpoints go to ``<dir>/checkpoints/<step:05d>``,
as ppo2 writes them (ppo2/ppo2.py:211-216). Reading the JAX package's msgpack files is
not supported; JAX params reach the port through ``convert.py``.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp

import torch

_LEAVES = (int, float)


def to_tree(obj):
    """``obj`` as a nested dict of tensors and plain numbers (see the module's doc)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if obj is None or isinstance(obj, _LEAVES):
        return obj
    if hasattr(obj, "state_dict"):
        return to_tree(obj.state_dict())
    if dataclasses.is_dataclass(obj):
        return {f.name: to_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_tree(v) for v in obj]
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def from_tree(tree, target, where: str = "state"):
    """``tree`` rebuilt in the structure of ``target``."""
    if isinstance(target, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != target.shape \
                or tree.dtype != target.dtype:
            got = (f"{tree.dtype} {tuple(tree.shape)}" if isinstance(tree, torch.Tensor)
                   else type(tree).__name__)
            raise ValueError(f"checkpoint {where}: {got}, expected {target.dtype} "
                             f"{tuple(target.shape)}")
        return tree.to(target.device)
    if target is None:
        if tree is not None:
            raise ValueError(f"checkpoint {where}: a {type(tree).__name__}, expected None")
        return None
    if isinstance(target, _LEAVES):
        return tree
    if hasattr(target, "load_state_dict"):
        target.load_state_dict(from_tree(tree, target.state_dict(), where))
        return target
    if dataclasses.is_dataclass(target):
        return dataclasses.replace(target, **{
            f.name: from_tree(tree[f.name], getattr(target, f.name), f"{where}.{f.name}")
            for f in dataclasses.fields(target)})
    if isinstance(target, dict):
        if set(tree) != set(target):
            raise ValueError(f"checkpoint {where}: keys {sorted(tree)}, expected "
                             f"{sorted(target)}")
        return {k: from_tree(tree[k], v, f"{where}.{k}") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(tree) != len(target):
            raise ValueError(f"checkpoint {where}: {len(tree)} items, expected {len(target)}")
        return type(target)(from_tree(a, b, f"{where}[{i}]")
                            for i, (a, b) in enumerate(zip(tree, target)))
    raise TypeError(f"cannot restore a {type(target).__name__}")


def save_state(path: str, state) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    torch.save(to_tree(state), path)


def load_state(path: str, target=None, map_location="cpu"):
    """The tree saved at ``path``, rebuilt into ``target`` when one is given."""
    tree = torch.load(path, map_location=map_location, weights_only=True)
    return tree if target is None else from_tree(tree, target)


def periodic_path(logdir: str, step: int) -> str:
    d = osp.join(logdir, "checkpoints")
    os.makedirs(d, exist_ok=True)
    return osp.join(d, f"{step:05d}")


def latest_checkpoint(logdir: str) -> str | None:
    d = osp.join(logdir, "checkpoints")
    if not osp.isdir(d):
        return None
    names = [n for n in os.listdir(d) if n.isdigit()]
    if not names:
        return None
    return osp.join(d, max(names, key=int))
