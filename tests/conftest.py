"""Test harness configuration.

The test strategy mirrors the reference's ladder (SURVEY.md §4): pure-unit
math tests, fake fixture envs, learning tests, serialization round-trips,
and collective/multi-device tests on a virtual CPU mesh.

Multi-device tests need an 8-way CPU device mesh
(`--xla_force_host_platform_device_count=8`), configured before the jax
backend initializes — this replaces the reference's @with_mpi decorator
that re-launched test bodies under mpiexec (common/tests/test_with_mpi.py:14-38).
"""

import os

import jax

# must run before any jax backend use anywhere in the test session
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
jax.config.update("jax_platforms", "cpu")

assert jax.devices()[0].platform == "cpu" and len(jax.devices()) == 8, (
    "test harness expected 8 virtual CPU devices, got "
    f"{len(jax.devices())}x {jax.devices()[0].platform}"
)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run CNN-scale learning tests (the reference's RUNSLOW ladder, "
        "common/tests/test_cartpole.py:16-42 pattern)",
    )


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: CNN-scale learning test, needs --runslow or RUNSLOW=1")
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips where there is none")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUNSLOW"):
        return
    skip = pytest.mark.skip(reason="needs --runslow (or RUNSLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
