"""The port, chip_smoke.py and sampler_grid.py stand without JAX: in a process where
jax, flax, optax and baselines_tpu cannot be imported, and neither can gymnasium,
gymnasium_robotics, mujoco, cloudpickle, cv2, ale_py, retro, tensorboard, pandas and
matplotlib (which the machine with the card may lack), every module of
baselines_tpu_torch imports, and
chip_smoke.py and sampler_grid.py, finding no card, exit nonzero with their "no CUDA
device" message rather than an ImportError."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("import sys\nfor m in ('jax', 'flax', 'optax', 'baselines_tpu', 'gymnasium', "
           "'gymnasium_robotics', 'mujoco', 'cloudpickle', 'cv2', 'ale_py', 'retro', "
           "'tensorboard', 'pandas', 'matplotlib'):\n    sys.modules[m] = None\n")


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", BLOCKED + code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_without_jax():
    proc = _run(
        "import importlib, pkgutil\n"
        "import baselines_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(baselines_tpu_torch.__path__,"
        " 'baselines_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(' '.join(names))\n"
        "print(len(names))\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 106
    imported = set(proc.stdout.split())
    for name in ("core.cg", "algos.trpo.trpo", "algos.ddpg.ddpg", "algos.ddpg.noise",
                 "algos.her.her", "data.her_buffer", "envs.goal.point_reach",
                 "algos.gail.gail", "algos.gail.adversary", "algos.gail.behavior_clone",
                 "algos.gail.dataset", "algos.acktr.acktr", "algos.acktr.kfac",
                 "algos.acer.acer", "data.frame_chunk", "native", "envs.gym_bridge",
                 "envs.callback_env", "envs.host_pipeline", "core.profiler",
                 "core.tile_images", "envs.atari", "envs.retro_wrappers", "envs.video",
                 "data.segment_tree", "core.console_util", "core.dataset",
                 "core.misc_util", "core.registry", "bench", "bench.benchmarks",
                 "bench.monitor_io", "bench.plot_util", "bench.results_plotter", "examples",
                 "examples.train_cartpole", "examples.enjoy_cartpole",
                 "examples.custom_network"):
        assert f"baselines_tpu_torch.{name}" in imported, name


def test_chip_smoke_without_a_card_exits_nonzero_before_importing_anything():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so chip_smoke.py would run")
    proc = _run(
        "import runpy\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit code', e.code)\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert "exit code 1" in proc.stdout
    assert "no CUDA device" in proc.stderr
    assert "ImportError" not in proc.stderr and '"ok"' not in proc.stdout


def test_sampler_grid_without_a_card_exits_nonzero_without_jax():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so sampler_grid.py would run")
    proc = _run(
        "import runpy\n"
        "try:\n"
        "    runpy.run_path('sampler_grid.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit code', e.code)\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert "exit code 1" in proc.stdout
    assert "no CUDA device" in proc.stderr
    assert "ImportError" not in proc.stderr
