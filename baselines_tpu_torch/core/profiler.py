"""Profiling helpers (counterpart of baselines_tpu/core/profiler.py, after the
reference's wall-clock instrumentation, SURVEY §5.1).

- ``trace(logdir)``: a ``torch.profiler`` trace around a block, of the CPU and, where
  a card is present, of CUDA activity; the Chrome trace lands in ``logdir`` and the
  profile itself is the context's value (``key_averages()``, ``events()``).
- ``annotate(name)``: a named range in the trace (``record_function``), and an NVTX
  range on a machine with a card.
- ``device_timer``: seconds per call of a function, with a hard sync.
- the KV timers (``logger.profile_kv``) remain the cheap always-on path.

Nothing on the learners' paths calls these, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


@contextmanager
def trace(logdir: str):
    """``with profiler.trace('/tmp/prof') as prof: step()`` writes
    ``<logdir>/trace_<pid>_<n>.json``, a Chrome trace (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


@contextmanager
def annotate(name: str):
    """A named range inside a trace; ranges nest."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync(result, sync_leaf) -> None:
    """Wait for the card: for the device of ``sync_leaf(result)`` (of the result when
    it is one tensor), for every device otherwise; a CPU tensor waits for nothing."""
    leaf = result if sync_leaf is None else sync_leaf(result)
    device = leaf.device if isinstance(leaf, torch.Tensor) else None
    if torch.cuda.is_available() and (device is None or device.type == "cuda"):
        torch.cuda.synchronize(device)


def device_timer(fn, *args, iters: int = 10, sync_leaf=None) -> float:
    """Run ``fn(*args)`` once to warm up, then ``iters`` times; returns seconds a call,
    the clock read after a hard sync of the card. ``sync_leaf(result)`` picks the
    tensor whose device to wait for; by default every device."""
    _sync(fn(*args), sync_leaf)
    t0 = time.perf_counter()
    result = None
    for _ in range(iters):
        result = fn(*args)
    _sync(result, sync_leaf)
    return (time.perf_counter() - t0) / iters
