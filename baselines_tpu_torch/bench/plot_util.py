"""Result loading + learning-curve plotting (a copy of baselines_tpu/bench/plot_util.py,
which imports no JAX; the port imports nothing of the JAX package) — parity with
baselines/common/plot_util.py: smooth (:14-37), one_sided_ema /
symmetric_ema resampling (:39-147), Result/load_results directory walking
(:152-222), and plot_results grid with std shading and curve averaging
(:245-434)."""

from __future__ import annotations

import json
import os
import os.path as osp
from collections import defaultdict, namedtuple

import numpy as np

from baselines_tpu_torch.bench import monitor_io


def _windowed_mean(y, lo_idx, hi_idx):
    """Mean of y[lo:hi] per output element via one prefix sum."""
    prefix = np.concatenate([[0.0], np.cumsum(y, dtype=np.float64)])
    return (prefix[hi_idx] - prefix[lo_idx]) / (hi_idx - lo_idx)


def smooth(y, radius, mode="two_sided", valid_only=False):
    """Moving-average smoothing with the same semantics as the reference's
    convolution version (plot_util.py:14-37): ``two_sided`` averages a
    (2*radius+1)-wide centered window, ``causal`` the trailing ``radius``
    samples; windows shrink at the array edges.  Implemented with prefix
    sums rather than convolutions."""
    y = np.asarray(y, dtype=np.float64)
    n = len(y)
    if n < 2 * radius + 1:
        return np.full_like(y, y.mean())
    idx = np.arange(n)
    if mode == "two_sided":
        out = _windowed_mean(y, np.maximum(idx - radius, 0), np.minimum(idx + radius + 1, n))
        if valid_only:
            out[:radius] = out[-radius:] = np.nan
    elif mode == "causal":
        out = _windowed_mean(y, np.maximum(idx - radius + 1, 0), idx + 1)
        if valid_only:
            out[:radius] = np.nan
    else:
        raise ValueError(f"unknown smooth mode {mode!r}")
    return out


def one_sided_ema(xolds, yolds, low=None, high=None, n=512, decay_steps=1.0,
                  low_counts_threshold=1e-8):
    """Resample an irregular series onto a uniform n-point grid with a
    causal exponential moving average (capability parity with
    plot_util.py:39-90, vectorized).

    Each source sample (x0, y0) contributes to every grid point g >= x0
    with weight exp(-(g - x0)/tau), tau = grid_spacing * decay_steps.
    Vectorized as: (1) bin samples to their first grid point with a partial
    decay, (2) propagate across the grid with the one-pole recurrence
    s[i] = d * s[i-1] + b[i], d = exp(-1/decay_steps)."""
    xolds = np.asarray(xolds, dtype=np.float64)
    yolds = np.asarray(yolds, dtype=np.float64)
    assert len(xolds) == len(yolds)
    low = xolds[0] if low is None else low
    high = xolds[-1] if high is None else high
    assert xolds[0] <= low and high <= xolds[-1], "grid must lie inside the data range"

    grid = np.linspace(low, high, n)
    tau = (high - low) / (n - 1) * decay_steps
    pole = np.exp(-1.0 / decay_steps)

    # first grid point at or after each sample; samples past `high` drop out
    bins = np.searchsorted(grid, xolds, side="left")
    keep = bins < n
    bins = bins[keep]
    # decay from sample x up to its grid point (<= one grid interval except
    # for samples left of `low`, which fold into grid point 0)
    partial = np.exp(-(grid[bins] - xolds[keep]) / tau)
    binned_sum = np.bincount(bins, weights=partial * yolds[keep], minlength=n)
    binned_cnt = np.bincount(bins, weights=partial, minlength=n)

    sum_ys = _one_pole(binned_sum, pole)
    count_ys = _one_pole(binned_cnt, pole)

    with np.errstate(invalid="ignore", divide="ignore"):
        ys = sum_ys / count_ys
    ys[count_ys < low_counts_threshold] = np.nan
    return grid, ys, count_ys


def _one_pole(b, d):
    """s[i] = d*s[i-1] + b[i] for the whole array (IIR filter)."""
    try:
        from scipy.signal import lfilter

        return lfilter([1.0], [1.0, -d], b)
    except ImportError:  # pragma: no cover - scipy is available in CI
        out = np.empty_like(b)
        acc = 0.0
        for i, v in enumerate(b):
            acc = d * acc + v
            out[i] = acc
        return out


def symmetric_ema(xolds, yolds, low=None, high=None, n=512, decay_steps=1.0,
                  low_counts_threshold=1e-8):
    """Two one-sided EMAs (forward + time-reversed) blended by their
    confidence weights — same estimator as plot_util.py:93-147."""
    xolds = np.asarray(xolds, dtype=np.float64)
    yolds = np.asarray(yolds, dtype=np.float64)
    low = xolds[0] if low is None else low
    high = xolds[-1] if high is None else high
    grid, fwd, fwd_cnt = one_sided_ema(xolds, yolds, low, high, n, decay_steps, 0)
    _, bwd, bwd_cnt = one_sided_ema(
        -xolds[::-1], yolds[::-1], -high, -low, n, decay_steps, 0
    )
    bwd, bwd_cnt = bwd[::-1], bwd_cnt[::-1]
    total = fwd_cnt + bwd_cnt
    with np.errstate(invalid="ignore", divide="ignore"):
        ys = (np.nan_to_num(fwd) * fwd_cnt + np.nan_to_num(bwd) * bwd_cnt) / total
    ys[total < low_counts_threshold] = np.nan
    return grid, ys, total


Result = namedtuple("Result", "monitor progress dirname metadata")
Result.__new__.__defaults__ = (None,) * len(Result._fields)


def load_results(root_dir_or_dirs, enable_progress=True, enable_monitor=True,
                 verbose=False):
    """plot_util.py:152-222: walk dirs, build Result per run directory."""
    import pandas

    if isinstance(root_dir_or_dirs, str):
        rootdirs = [osp.expanduser(root_dir_or_dirs)]
    else:
        rootdirs = [osp.expanduser(d) for d in root_dir_or_dirs]
    allresults = []
    for rootdir in rootdirs:
        assert osp.exists(rootdir), f"{rootdir} doesn't exist"
        for dirname, dirs, files in os.walk(rootdir):
            if "-proc" in dirname:
                files[:] = []
                continue
            monitor_re = any(f.endswith("monitor.csv") for f in files)
            if set(["metadata.json", "monitor.json", "progress.json", "progress.csv"]).intersection(files) or monitor_re:
                result = {"dirname": dirname}
                if "metadata.json" in files:
                    with open(osp.join(dirname, "metadata.json")) as fh:
                        result["metadata"] = json.load(fh)
                progjson = osp.join(dirname, "progress.json")
                progcsv = osp.join(dirname, "progress.csv")
                if enable_progress:
                    if osp.exists(progjson):
                        result["progress"] = pandas.DataFrame(
                            [json.loads(line) for line in open(progjson)]
                        )
                    elif osp.exists(progcsv):
                        try:
                            result["progress"] = pandas.read_csv(progcsv, index_col=None)
                        except pandas.errors.EmptyDataError:
                            pass
                if enable_monitor and monitor_re:
                    try:
                        result["monitor"] = monitor_io.load_results(dirname)
                    except monitor_io.LoadMonitorResultsError:
                        pass
                if result.get("monitor") is not None or result.get("progress") is not None:
                    allresults.append(Result(**result))
                    if verbose:
                        print(f"successfully loaded {dirname}")
    if verbose:
        print(f"loaded {len(allresults)} results")
    return allresults


COLORS = (
    ["blue", "green", "red", "cyan", "magenta", "yellow", "black", "purple", "pink",
     "brown", "orange", "teal", "coral", "lightblue", "lime", "lavender", "turquoise",
     "darkgreen", "tan", "salmon", "gold", "lightpurple", "darkred", "darkblue"]
)


def default_xy_fn(r):
    """plot_util.py:232-236: cumulative episode lengths vs smoothed return."""
    x = np.cumsum(r.monitor.l)
    y = smooth(r.monitor.r, radius=10)
    return x, y


def default_split_fn(r):
    import re

    match = re.search(r"[^/-]+(?=(-\d+)?\Z)", r.dirname)
    if match:
        return match.group(0)


def plot_results(
    allresults,
    xy_fn=default_xy_fn,
    split_fn=default_split_fn,
    group_fn=default_split_fn,
    average_group=False,
    shaded_std=True,
    shaded_err=True,
    figsize=None,
    legend_outside=False,
    resample=0,
    smooth_step=1.0,
    tiling="vertical",
    xlabel=None,
    ylabel=None,
):
    """plot_util.py:245-434: grid of curves split/grouped by callables, with
    optional EMA resampling and std/stderr shading."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if split_fn is None:
        split_fn = lambda _: ""
    if group_fn is None:
        group_fn = lambda _: ""
    sk2r = defaultdict(list)
    for result in allresults:
        sk2r[split_fn(result)].append(result)
    assert len(sk2r) > 0
    assert isinstance(resample, int)

    nrows = len(sk2r)
    ncols = 1
    figsize = figsize or (6, 6 * nrows)
    f, axarr = plt.subplots(nrows, ncols, sharex=False, squeeze=False, figsize=figsize)

    groups = sorted({group_fn(result) for result in allresults})
    g2l = {}
    for isplit, sk in enumerate(sorted(sk2r.keys())):
        g2c = defaultdict(int)
        sresults = sk2r[sk]
        gresults = defaultdict(list)
        ax = axarr[isplit][0]
        for result in sresults:
            group = group_fn(result)
            g2c[group] += 1
            x, y = xy_fn(result)
            if x is None:
                x = np.arange(len(y))
            x, y = map(np.asarray, (x, y))
            if average_group:
                gresults[group].append((x, y))
            else:
                color = COLORS[groups.index(group) % len(COLORS)]
                (l,) = ax.plot(x, y, color=color)
                g2l[group] = l
        if average_group:
            for group in sorted(groups):
                xys = gresults[group]
                if not xys:
                    continue
                color = COLORS[groups.index(group) % len(COLORS)]
                origxs = [xy[0] for xy in xys]
                minxlen = min(map(len, origxs))
                def allequal(qs):
                    return all((q == qs[0]).all() for q in qs[1:])
                if resample:
                    low = max(x[0] for x in origxs)
                    high = min(x[-1] for x in origxs)
                    usex = np.linspace(low, high, resample)
                    ys = []
                    for x, y in xys:
                        ys.append(symmetric_ema(x, y, low, high, resample,
                                                decay_steps=smooth_step)[1])
                else:
                    assert allequal([x[:minxlen] for x in origxs]), (
                        "x values must be the same for all curves; use resample=<n>"
                    )
                    usex = origxs[0][:minxlen]
                    ys = [xy[1][:minxlen] for xy in xys]
                ymean = np.mean(ys, axis=0)
                ystd = np.std(ys, axis=0)
                ystderr = ystd / np.sqrt(len(ys))
                (l,) = ax.plot(usex, ymean, color=color)
                g2l[group] = l
                if shaded_err:
                    ax.fill_between(usex, ymean - ystderr, ymean + ystderr,
                                    color=color, alpha=0.4)
                if shaded_std:
                    ax.fill_between(usex, ymean - ystd, ymean + ystd,
                                    color=color, alpha=0.2)
        plt.tight_layout()
        ax.set_title(sk)
        if xlabel is not None:
            ax.set_xlabel(xlabel)
        if ylabel is not None:
            ax.set_ylabel(ylabel)
    if any(g2l.keys()):
        f.legend(
            g2l.values(),
            g2l.keys(),
            loc="center right" if legend_outside else "upper right",
        )
    return f, axarr
