"""Small helpers (counterpart of baselines_tpu/core/misc_util.py, after
baselines/common/misc_util.py): global seeding (:45-58), paired boolean flags
(:61-73), pickling by constructor arguments (:76-108) and a readable ETA (:111-145)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_global_seeds(i):
    """Seed Python's, numpy's and torch's global generators (the reference seeds
    TensorFlow's). The learners draw from their own ``Draws`` (core/rng.py), which this
    does not touch."""
    if i is None:
        return
    random.seed(i)
    np.random.seed(i % 2**32)
    torch.manual_seed(i)


def boolean_flag(parser, name, default=False, help=None):
    """``--name`` and ``--no-name`` on an ArgumentParser, setting one boolean."""
    dest = name.replace("-", "_")
    parser.add_argument(f"--{name}", dest=dest, action="store_true", default=default, help=help)
    parser.add_argument(f"--no-{name}", dest=dest, action="store_false")


class EzPickle:
    """Pickled as its constructor's arguments and rebuilt by calling ``__init__`` again,
    for objects whose unpicklable state follows from those arguments."""

    def __init__(self, *args, **kwargs):
        self._ctor_args = (args, kwargs)

    def __getstate__(self):
        return {"ctor": self._ctor_args}

    def __setstate__(self, state):
        args, kwargs = state["ctor"]
        rebuilt = type(self)(*args, **kwargs)
        self.__dict__.update(rebuilt.__dict__)


def pretty_eta(seconds_left):
    """The time left as '2 days and 3 hours': the two largest units that are not zero,
    'less than a minute' below a minute."""
    seconds_left = int(seconds_left)
    units = []
    for name, size in (("day", 86400), ("hour", 3600), ("minute", 60)):
        count, seconds_left = divmod(seconds_left, size)
        units.append((name, count))
    parts = [f"{c} {n}{'s' if c > 1 else ''}" for n, c in units if c > 0]
    if not parts:
        return "less than a minute"
    return " and ".join(parts[:2])
