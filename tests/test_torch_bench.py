"""The port's results and plotting tools (``baselines_tpu_torch/bench``) against the JAX
package's on the CPU: the ``monitor.csv`` bytes, the frames both loaders read back, the
smoothing and EMA arrays and ``results_plotter``'s windows bit for bit, the benchmark
suites as equal dicts, and the plots' grids and lines."""

import os

import matplotlib
import numpy as np
import pandas
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from baselines_tpu.bench import benchmarks as jax_benchmarks  # noqa: E402
from baselines_tpu.bench import monitor_io as jax_monitor_io  # noqa: E402
from baselines_tpu.bench import plot_util as jax_plot_util  # noqa: E402
from baselines_tpu.bench import results_plotter as jax_results_plotter  # noqa: E402
from baselines_tpu_torch import bench  # noqa: E402
from baselines_tpu_torch.bench import benchmarks, monitor_io, plot_util  # noqa: E402
from baselines_tpu_torch.bench import results_plotter  # noqa: E402

SIZES = (7, 64, 1000)


def _rows(seed: int, n: int, extra: bool) -> list:
    """Episode rows as a monitor writes them: float returns, int lengths, rounded times."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        row = {"r": round(float(rng.randn() * 10), 6), "l": int(rng.randint(1, 500)),
               "t": round(0.5 * i + float(rng.rand()), 6)}
        if extra:
            row["is_success"] = bool(rng.rand() > 0.5)
        rows.append(row)
    return rows


def _write(module, path: str, rows: list, extra: bool, t_start: float = 1234.5) -> str:
    w = module.ResultsWriter(path, header={"t_start": t_start, "env_id": "CartPole-v1"},
                             extra_keys=("is_success",) if extra else ())
    for row in rows:
        w.write_row(row)
    w.close()
    return w.f.name


@pytest.mark.parametrize("extra", [False, True])
def test_monitor_csv_is_the_jax_writers_byte_for_byte(tmp_path, extra):
    rows = _rows(0, 25, extra)
    port = _write(monitor_io, str(tmp_path / "port"), rows, extra)
    ref = _write(jax_monitor_io, str(tmp_path / "jax"), rows, extra)
    assert port.endswith("port.monitor.csv") and ref.endswith("jax.monitor.csv")
    with open(port, "rb") as f, open(ref, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want
    assert got.startswith(b'#{"t_start": 1234.5, "env_id": "CartPole-v1"}\n')
    # a directory as the path names the file monitor.csv inside it
    os.makedirs(tmp_path / "d")
    assert _write(monitor_io, str(tmp_path / "d"), rows, extra).endswith("d/monitor.csv")


def test_load_results_frames_equal(tmp_path):
    """Both loaders over one directory of two runs (other starts, other lengths) give
    equal frames and headers; an empty directory raises the loader's error."""
    for i, t_start in enumerate((100.0, 97.25)):
        _write(monitor_io, str(tmp_path / f"{i}"), _rows(i, 10 + 5 * i, False), False,
               t_start)
    got = monitor_io.load_results(str(tmp_path))
    want = jax_monitor_io.load_results(str(tmp_path))
    pandas.testing.assert_frame_equal(got, want)
    assert got.headers == want.headers and len(got) == 25
    assert float(got["t"].min()) >= 0.0
    os.makedirs(tmp_path / "empty")
    with pytest.raises(monitor_io.LoadMonitorResultsError):
        monitor_io.load_results(str(tmp_path / "empty"))


def test_plot_util_load_results_equal(tmp_path):
    """``plot_util.load_results`` walks the same tree to the same Results: the monitor
    frames, a progress.csv and metadata.json, and skips ``-proc`` directories."""
    for run in ("ppo2-CartPole-0", "ppo2-CartPole-1", "x-proc001"):
        d = tmp_path / run
        os.makedirs(d)
        _write(monitor_io, str(d / "0"), _rows(len(run), 12, False), False)
        pandas.DataFrame({"steps": [1, 2, 3], "eprewmean": [1.0, 2.5, 3.0]}).to_csv(
            d / "progress.csv", index=False)
    (tmp_path / "ppo2-CartPole-0" / "metadata.json").write_text('{"seed": 0}')
    got = sorted(plot_util.load_results(str(tmp_path)), key=lambda r: r.dirname)
    want = sorted(jax_plot_util.load_results(str(tmp_path)), key=lambda r: r.dirname)
    assert [r.dirname for r in got] == [r.dirname for r in want] and len(got) == 2
    for a, b in zip(got, want):
        pandas.testing.assert_frame_equal(a.monitor, b.monitor)
        pandas.testing.assert_frame_equal(a.progress, b.progress)
        assert a.metadata == b.metadata
    assert got[0].metadata == {"seed": 0}


@pytest.mark.parametrize("mode", ["two_sided", "causal"])
@pytest.mark.parametrize("n", SIZES)
def test_smooth_bit_for_bit(n, mode):
    y = np.random.RandomState(n).randn(n).astype(np.float32)
    for radius in (0, 1, 3, 10):
        for valid_only in (False, True):
            got = plot_util.smooth(y, radius, mode, valid_only)
            want = jax_plot_util.smooth(y, radius, mode, valid_only)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype == np.float64
    with pytest.raises(ValueError):
        plot_util.smooth(np.arange(50.0), 2, "sideways")


@pytest.mark.parametrize("n", SIZES)
def test_emas_bit_for_bit(n):
    """one_sided_ema and symmetric_ema on irregular sorted samples, over the data's
    range and over a grid inside it, at two decays and two grid sizes."""
    rng = np.random.RandomState(100 + n)
    x = np.sort(rng.uniform(0, 1000, n))
    y = rng.randn(n) * 5 + np.linspace(0, 10, n)
    for kwargs in ({}, dict(low=x[1], high=x[-2], n=64, decay_steps=3.0),
                   dict(n=7, decay_steps=0.5)):
        for name in ("one_sided_ema", "symmetric_ema"):
            got = getattr(plot_util, name)(x, y, **kwargs)
            want = getattr(jax_plot_util, name)(x, y, **kwargs)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", SIZES)
def test_results_plotter_windows_and_axes_bit_for_bit(n):
    rng = np.random.RandomState(200 + n)
    x, y = np.cumsum(rng.randint(1, 9, n)), rng.randn(n)
    for window in sorted({1, min(5, n), n}):
        assert np.array_equal(results_plotter.rolling_window(y, window),
                              jax_results_plotter.rolling_window(y, window))
        for func in (np.mean, np.std):
            for a, b in zip(results_plotter.window_func(x, y, window, func),
                            jax_results_plotter.window_func(x, y, window, func)):
                np.testing.assert_array_equal(a, b)
    ts = pandas.DataFrame({"r": y, "l": rng.randint(1, 200, n),
                           "t": np.cumsum(rng.rand(n))})
    for axis in results_plotter.POSSIBLE_X_AXES:
        got, want = results_plotter.ts2xy(ts, axis), jax_results_plotter.ts2xy(ts, axis)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        results_plotter.ts2xy(ts, "lifetimes")


def test_benchmark_suites_are_equal_dicts():
    assert benchmarks.list_benchmarks() == jax_benchmarks.list_benchmarks()
    assert len(benchmarks.list_benchmarks()) == 6
    for name in benchmarks.list_benchmarks():
        assert benchmarks.get_benchmark(name) == jax_benchmarks.get_benchmark(name)
    pong = "PongNoFrameskip-v4"
    assert benchmarks.get_task(benchmarks.get_benchmark("Atari10M"), pong) == \
        jax_benchmarks.get_task(jax_benchmarks.get_benchmark("Atari10M"), pong)
    with pytest.raises(ValueError):
        benchmarks.get_benchmark("NoSuchSuite")
    with pytest.raises(ValueError):
        bench.register_benchmark({"name": "Mujoco1M", "tasks": []})
    assert bench.get_benchmark is benchmarks.get_benchmark
    assert bench.ResultsWriter is monitor_io.ResultsWriter


def _lines(axarr) -> list:
    return [[len(ax.get_lines()), len(ax.collections)] for ax in np.ravel(axarr)]


@pytest.mark.parametrize("average_group", [False, True])
def test_plot_results_grids_and_lines_match_jax(tmp_path, average_group):
    """plot_util.plot_results over two tasks of two seeds each: the same grid shape and
    the same lines and shaded areas on each axis as the JAX package's; with
    ``average_group`` (and ``resample``) one mean curve a group."""
    for task in ("CartPole", "Pendulum"):
        for seed in range(2):
            d = tmp_path / f"ppo2-{task}-{seed}"
            os.makedirs(d)
            _write(monitor_io, str(d / "0"), _rows(seed, 40, False), False)
    kw = dict(average_group=average_group, resample=32 if average_group else 0,
              split_fn=lambda r: os.path.basename(r.dirname).split("-")[1],
              group_fn=lambda r: os.path.basename(r.dirname).split("-")[0])
    f, axarr = plot_util.plot_results(plot_util.load_results(str(tmp_path)), **kw)
    g, jaxarr = jax_plot_util.plot_results(jax_plot_util.load_results(str(tmp_path)),
                                           **kw)
    try:
        assert axarr.shape == jaxarr.shape == (2, 1)
        assert _lines(axarr) == _lines(jaxarr)
        assert _lines(axarr)[0] == ([1, 2] if average_group else [2, 0])
        assert [ax.get_title() for ax in np.ravel(axarr)] == ["CartPole", "Pendulum"]
        f.savefig(tmp_path / "plot.png")
        assert os.path.getsize(tmp_path / "plot.png") > 0
    finally:
        plt.close(f)
        plt.close(g)


def test_results_plotter_plot_results_matches_jax(tmp_path):
    dirs = []
    for i in range(2):
        d = tmp_path / f"run{i}"
        os.makedirs(d)
        _write(monitor_io, str(d / "0"), _rows(i, 150, False), False)
        dirs.append(str(d))
    figs = []
    for module in (results_plotter, jax_results_plotter):
        module.plot_results(dirs, 10 ** 9, results_plotter.X_TIMESTEPS, "CartPole-v1")
        figs.append(plt.gcf())
    try:
        (a,), (b,) = figs[0].axes, figs[1].axes
        assert [len(a.get_lines()), len(a.collections)] == \
            [len(b.get_lines()), len(b.collections)] == [2, 2]
        assert a.get_title() == b.get_title() == "CartPole-v1"
        assert a.get_xlim() == b.get_xlim()
    finally:
        for fig in figs:
            plt.close(fig)
