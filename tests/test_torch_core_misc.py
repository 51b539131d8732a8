"""The port's smaller parts on the CPU against the JAX package's: ``VecS2D(flat=True)``
and ``cnn_s2d`` on its flat rows; the logger's tensorboard format; ``core/console_util``,
``core/dataset``, ``core/misc_util``; and the schedules ``ConstantSchedule``,
``PiecewiseSchedule`` and ``constant_fraction_schedule``."""

import argparse
import contextlib
import io
import pickle
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baselines_tpu.core import console_util as jax_console
from baselines_tpu.core import dataset as jax_dataset
from baselines_tpu.core import misc_util as jax_misc
from baselines_tpu.core import schedules as jax_schedules
from baselines_tpu_torch.core import console_util, dataset, misc_util, schedules


def test_vec_s2d_flat_rows_match_jax():
    """VecS2D(flat=True) on AtariSim-v0: each (84, 84, 4) frame packed into one row of
    28224 values, equal to the JAX package's flat rows of the same frames and to the
    3-D packing flattened; the space carries ``packed_shape`` (21, 21, 64)."""
    from baselines_tpu.envs.registry import make_env as jax_make_env
    from baselines_tpu.envs.vec import VecJaxEnv, VecS2D as JaxVecS2D
    from baselines_tpu_torch.core.rng import Draws
    from baselines_tpu_torch.envs.registry import make_env
    from baselines_tpu_torch.envs.vec import VecS2D, VecTorchEnv

    flat = VecS2D(VecTorchEnv(make_env("AtariSim-v0"), 3, "cpu"), 4, flat=True)
    packed = VecS2D(VecTorchEnv(make_env("AtariSim-v0"), 3, "cpu"), 4)
    jflat = JaxVecS2D(VecJaxEnv(jax_make_env("AtariSim-v0"), 3), 4, flat=True)
    assert flat.observation_space.shape == jflat.observation_space.shape == (28224,)
    assert flat.observation_space.packed_shape == tuple(jflat.observation_space.packed_shape)
    frames = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (3, 84, 84, 4), np.uint8))
    rows = flat._pack(frames)
    want = np.asarray(jflat._pack(jnp.asarray(frames.numpy())))
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(rows.numpy(), packed._pack(frames).reshape(3, -1).numpy())
    obs, _ = flat.reset(Draws(0, "cpu"))
    assert obs.dtype == torch.uint8 and tuple(obs.shape) == (3, 28224)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cnn_s2d_on_flat_rows_equals_3d(dtype):
    """A cnn_s2d policy built on the flat space (``packed_shape``) has the 3-D policy's
    weights from the same generator and the same outputs on the same frames as rows,
    bit for bit; with bf16 its act step goes through the fused kernel's wrapper, which
    views the rows as the frames without a copy."""
    from baselines_tpu_torch.envs.spaces import Box, Discrete
    from baselines_tpu_torch.nn.policy import act_latent, build_policy
    from baselines_tpu_torch.ops.fused_cnn import _frames

    frame_space = Box(0, 255, (21, 21, 64), np.uint8)
    row_space = Box(0, 255, (28224,), np.uint8)
    row_space.packed_shape = (21, 21, 64)
    pols = [build_policy(sp, Discrete(6), "cnn_s2d", device="cpu", dtype=dtype,
                         generator=torch.Generator().manual_seed(3))
            for sp in (frame_space, row_space)]
    x = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (5, 21, 21, 64), np.uint8))
    rows = x.reshape(5, -1)
    with torch.no_grad():
        a = pols[0].module(x)[:2]
        b = pols[1].module(rows)[:2]
        for p, q in zip(a, b):
            assert torch.equal(p, q)
        assert torch.equal(act_latent(pols[0].module.network, x),
                           act_latent(pols[1].module.network, rows))
    assert _frames(rows).data_ptr() == rows.data_ptr()


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(logdir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_match_jax(tmp_path):
    """The logger's tensorboard format writes the rows' numbers as scalars at steps 1,
    2, ...; read back from the event files, the port's equal the JAX package's."""
    pytest.importorskip("tensorboard")
    from baselines_tpu.core import logger as jax_logger
    from baselines_tpu_torch.core import logger

    rows = [{"loss": 0.5, "fps": 120, "name": "text", "misc/steps": 64},
            {"loss": np.float32(0.25), "fps": 240, "misc/steps": 128}]
    for m, d in ((logger, tmp_path / "port"), (jax_logger, tmp_path / "jax")):
        fmt = m.make_output_format("tensorboard", str(d))
        for row in rows:
            fmt.writekvs(row)
        fmt.close()
    ours, theirs = _scalars(str(tmp_path / "port" / "tb")), _scalars(str(tmp_path / "jax" / "tb"))
    assert ours == theirs
    assert ours["loss"] == [(1, 0.5), (2, 0.25)] and "name" not in ours


def test_console_util_matches_jax():
    """Table cells and rows, colours, and the stopwatch's lines (without its time)."""
    items = [1.5, 1e-6, 123456.0, 0.0, 42, "text", np.float64(3.25).item(), np.array(2.5)]
    for m_item in (7, 12):
        assert [console_util.fmt_item(v, m_item) for v in items] == \
            [jax_console.fmt_item(v, m_item) for v in items]
    assert console_util.fmt_row(8, ["a", 1.0, 2], header=True) == \
        jax_console.fmt_row(8, ["a", 1.0, 2], header=True)
    for kw in ({}, {"color": "red", "bold": True}, {"color": "cyan", "highlight": True}):
        assert console_util.colorize("x", **kw) == jax_console.colorize("x", **kw)

    def lines(m):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            with m.timed("outer"):
                with m.timed("inner"):
                    pass
        return [line.split(" in ")[0] for line in out.getvalue().splitlines()]

    assert lines(console_util) == lines(jax_console)


def test_dataset_matches_jax():
    """Dataset's batches from the same seed (next_batch across epochs, iterate_once,
    subset, unshuffled) and iterbatches' from generators of the same seed."""
    data = {"x": np.arange(23 * 2).reshape(23, 2), "y": np.arange(23) * 10}

    def batches(m):
        out = []
        ds = m.Dataset(data, seed=4)
        out += [ds.next_batch(5) for _ in range(7)]
        out += list(ds.iterate_once(6))
        out += list(ds.subset(9).iterate_once(4))
        out += list(m.Dataset(data, shuffle=False).iterate_once(10))
        out += list(m.iterbatches([data["x"], data["y"]], batch_size=7,
                                  rng=np.random.default_rng(2)))
        out += list(m.iterbatches([data["x"]], num_batches=4, shuffle=False))
        out += list(m.iterbatches([data["y"]], batch_size=5, include_final_partial_batch=False,
                                  rng=np.random.default_rng(3)))
        return out

    ours, theirs = batches(dataset), batches(jax_dataset)
    assert len(ours) == len(theirs) > 20
    for a, b in zip(ours, theirs):
        a, b = (list(a.values()) if isinstance(a, dict) else a), (
            list(b.values()) if isinstance(b, dict) else b)
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)
    with pytest.raises(ValueError):
        next(dataset.iterbatches([data["y"]]))


class _Pickled(misc_util.EzPickle):
    def __init__(self, n, scale=1.0):
        super().__init__(n, scale=scale)
        self.values = np.arange(n) * scale
        self.handle = lambda: None  # cannot be pickled


def test_misc_util_matches_jax():
    """set_global_seeds leaves Python's and numpy's generators where the JAX package's
    does (and seeds torch's); boolean_flag's two flags; EzPickle rebuilds from its
    constructor's arguments; pretty_eta's strings."""
    states = []
    for m in (misc_util, jax_misc):
        m.set_global_seeds(2**33 + 5)
        states.append((random.random(), np.random.rand()))
    assert states[0] == states[1]
    misc_util.set_global_seeds(7)
    t = torch.rand(3)
    torch.manual_seed(7)
    assert torch.equal(t, torch.rand(3))
    for m in (misc_util, jax_misc):
        p = argparse.ArgumentParser()
        m.boolean_flag(p, "render-eval", default=True)
        assert p.parse_args([]).render_eval is True
        assert p.parse_args(["--no-render-eval"]).render_eval is False
    obj = pickle.loads(pickle.dumps(_Pickled(4, scale=0.5)))
    np.testing.assert_array_equal(obj.values, np.arange(4) * 0.5)
    assert callable(obj.handle)
    for s in (0, 59, 60, 61, 3599, 3600, 7260, 86400, 90061, 200000):
        assert misc_util.pretty_eta(s) == jax_misc.pretty_eta(s)


def test_schedules_match_jax():
    """ConstantSchedule, PiecewiseSchedule (the reference test's endpoints, with and
    without an outside value, and random steps) and constant_fraction_schedule against
    the JAX package's f32 values: exact at the reference's points, to 1e-6 elsewhere;
    LinearSchedule as before."""
    ours, theirs = schedules.ConstantSchedule(5.0), jax_schedules.ConstantSchedule(5.0)
    assert all(ours.value(t) == float(theirs.value(t)) == 5.0 for t in (0, 1, 100, 10**6))
    endpoints = [(-5, 100.0), (5, 200.0), (10, 50.0), (100, 50.0), (200, -50.0)]
    for outside in (500.0, None):
        ours = schedules.PiecewiseSchedule(endpoints, outside_value=outside)
        theirs = jax_schedules.PiecewiseSchedule(endpoints, outside_value=outside)
        for t in (-10, 0, 5, 9, 50, 80, 150, 175, 201, 500):
            assert ours.value(t) == float(theirs.value(t)), t
        for t in np.random.RandomState(0).uniform(-20, 220, 50):
            np.testing.assert_allclose(ours(t), float(theirs(t)), rtol=1e-6, atol=1e-5)
    assert schedules.PiecewiseSchedule(endpoints, outside_value=500.0).value(150) == 0.0
    with pytest.raises(ValueError):
        schedules.PiecewiseSchedule([(5, 1.0), (0, 2.0)])
    f = schedules.constant_fraction_schedule(2.5e-4)
    g = jax_schedules.constant_fraction_schedule(2.5e-4)
    for frac in (1.0, 0.5, 0.1234, 0.0):
        assert f(frac) == float(g(frac))
    lin, jlin = schedules.LinearSchedule(100, 0.02), jax_schedules.LinearSchedule(100, 0.02)
    assert all(lin.value(t) == float(jlin.value(t)) for t in (0, 37, 100, 1000))
