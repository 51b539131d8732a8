"""Benchmark registry (a copy of baselines_tpu/bench/benchmarks.py, which imports no
JAX; the port imports nothing of the JAX package) — parity with
baselines/bench/benchmarks.py:13-47 (register_benchmark/get_benchmark and the shipped
suites: Atari10M/50M, Mujoco1M, Fetch1M… :49-164).  Task dicts carry {env_id, trials,
num_timesteps} exactly like the reference so harnesses can iterate suites.
"""

from __future__ import annotations

_BENCHMARKS = []

_ATARI7 = ["BeamRider", "Breakout", "Enduro", "Pong", "Qbert", "Seaquest", "SpaceInvaders"]
_MUJOCO_SMALL = [
    "InvertedDoublePendulum-v5", "InvertedPendulum-v5",
    "HalfCheetah-v5", "Hopper-v5", "Walker2d-v5", "Reacher-v5", "Swimmer-v5",
]


def register_benchmark(benchmark):
    for b in _BENCHMARKS:
        if b["name"] == benchmark["name"]:
            raise ValueError(f"Benchmark with name {b['name']} already registered!")
    if "tasks" in benchmark:
        for t in benchmark["tasks"]:
            if "desc" not in t:
                t["desc"] = t.get("env_id", t.get("game", ""))
    _BENCHMARKS.append(benchmark)


def list_benchmarks():
    return [b["name"] for b in _BENCHMARKS]


def get_benchmark(benchmark_name):
    for b in _BENCHMARKS:
        if b["name"] == benchmark_name:
            return b
    raise ValueError(f"{benchmark_name!r} not found! Known benchmarks: {list_benchmarks()}")


def get_task(benchmark, env_id):
    return next(
        (task for task in benchmark["tasks"] if task["env_id"] == env_id), None
    )


register_benchmark({
    "name": "Atari10M",
    "description": "7 Atari games, 6 trials of 10M timesteps each (benchmarks.py:58-62)",
    "tasks": [
        {"desc": g, "env_id": g + "NoFrameskip-v4", "trials": 6, "num_timesteps": int(10e6)}
        for g in _ATARI7
    ],
})

register_benchmark({
    "name": "Atari50M",
    "description": "7 Atari games, 2 trials of 50M timesteps",
    "tasks": [
        {"desc": g, "env_id": g + "NoFrameskip-v4", "trials": 2, "num_timesteps": int(50e6)}
        for g in _ATARI7
    ],
})

register_benchmark({
    "name": "Atari1Hr",
    "description": "7 Atari games, 2 trials of 1 hour walltime",
    "tasks": [
        {"desc": g, "env_id": g + "NoFrameskip-v4", "trials": 2, "num_seconds": 3600}
        for g in _ATARI7
    ],
})

register_benchmark({
    "name": "Mujoco1M",
    "description": "Mujoco benchmark with 1M timesteps (benchmarks.py:83-87)",
    "tasks": [
        {"env_id": e, "trials": 6, "num_timesteps": int(1e6)} for e in _MUJOCO_SMALL
    ],
})

register_benchmark({
    "name": "ClassicControl2-1M",
    "description": "classic control with 1M timesteps",
    "tasks": [
        {"env_id": e, "trials": 3, "num_timesteps": int(1e6)}
        for e in ["CartPole-v1", "Pendulum-v1", "MountainCar-v0", "Acrobot-v1"]
    ],
})

register_benchmark({
    "name": "Fetch1M",
    "description": "Fetch* benchmarks for 1M timesteps",
    "tasks": [
        {"env_id": e, "trials": 6, "num_timesteps": int(1e6)}
        for e in ["FetchReach-v1", "FetchPush-v1", "FetchSlide-v1"]
    ],
})
