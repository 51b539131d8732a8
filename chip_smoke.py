#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (baselines_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the port's kernel library (seconds and -Xptxas -v lines);
  3. the fused CNN forward kernel against its plain version, at batch 64 (deepq's act
     step), 256 (ppo2's rollout step) and 8192 (ppo2's minibatch), timed whole and by
     stage (conv, dense), and at batches that end in a partial tile;
  4. the row-gather kernel against x[idx], on the PPO obs and one f32 field, and on the
     deepq replay sample (256 rows of the 10000-slot ring), with out-of-range indices,
     timed against index_select in three rounds of turns;
  5. the stratified sampler's one launch against its plain version, at a million slots
     with 32 and 256 targets, at the deepq path's 10240 padded slots with 256 targets and
     at 35 edge shapes (1 to 512 blocks, 1 to 1024 targets): bit for bit on integer
     priorities (block sums included), within 2 slots on random ones, and the sampled
     frequencies of one heavy slot; timed in turns against cumsum + searchsorted and
     the launch floor (a one-element op);
  6. main path 1: two full-width ppo2 updates (256 envs x 128 steps, cnn_s2d in bf16,
     AtariSim-v0 packed 4x4 space-to-depth), whose launch counts show the CNN and
     gather kernels on the path and whose logged losses must be finite;
  7. main path 2: deepq with prioritized, dueling, double-Q replay at the Atari
     defaults (64 envs, batch 256, cnn_s2d in bf16, 16384 steps, 193 training
     iterations), whose launch counts show all three kernels on the path;
  8. main path 3, the CLI on CartPole-v1 through baselines_tpu_torch.run.main:
     a. ppo2 with mlp at 1024 envs x 128 steps, 4 epochs x 4 minibatches, 2 updates,
        --save_path and --play: finite losses, 48 gather launches, a play report;
     b. --load_path of that file, --num_timesteps=0 --play: the same params bit for bit
        and the same play report;
     c. deepq at the classic-control defaults with a checkpoint_path, 1280 steps: the
        `latest` checkpoint written, 5 gather launches a training iteration;
     d. the row gather against x[idx] at the CartPole shapes, f32 (131072, 4) obs and an
        f32 (131072,) field by a 131072-row permutation, timed in turns against
        index_select;
  9. main path 4, continuous control and the env layer through run.main:
     a. ppo2 with mlp (a diagonal-Gaussian head) on Pendulum-v1 at 1024 envs x 128
        steps, 2 updates, --reward_scale=0.1, --env_kwargs="{'normalize': True}",
        --save_path and --play: finite losses, 48 gather launches, ob_rms's count grown
        by 2 x 131072, a play report;
     b. --load_path of that file, --num_timesteps=0 --play: the params (logstd
        included) and both running statistics bit for bit, the same play report;
     c. deepq with prioritized replay on Acrobot-v1 at the classic-control defaults
        (buffer 50000, batch 32), 1280 steps: one sampler launch and 5 gather launches a
        training iteration, finite priorities and a finite TD loss;
     d. the gather against x[idx] at this path's shapes (Pendulum's f32 (131072, 3) obs
        and (131072, 1) actions by a permutation; 32 rows of Acrobot's (50000, 6) and
        CartPole's (50000, 4) f32 rings) and the sampler at 51200 slots (25 blocks) with
        32 targets, timed in turns against index_select and cumsum + searchsorted.
  10. main path 5, the remaining networks and PPO variants:
     a. ppo2 with impala_cnn in bf16 on AtariSim-v0's unpacked 84x84x4 frames at path 1's
        width (256 envs x 128 steps, 4 epochs x 4 minibatches of 8192), 2 updates: finite
        losses, 48 gather launches; then the gather on those 28,224-byte obs rows by a
        32768-row permutation, bit for bit, timed in turns against index_select;
     b. ppo2 with cnn_lstm (128 cells, f32) at the same width, 4 minibatches of 64 whole
        envs, 2 updates: first the first update's rollout, rebuilt from the same seed,
        and a second from its carry with half the envs done before the first step, each
        replayed as the loss replays it (neglogps, values and carry to 1e-4 relative);
        then learn: finite losses, a nonzero carry;
     c. ppo2 with lstm (32 cells) on FixedSequenceEnv(10, episode_len=5), 8 envs x 10
        steps, 50000 steps: a deterministic return over 3.5 of 5;
     d. through run.main on CartPole-v1: (i) ppo1 --value_network=copy at its
        classic-control defaults, 4 updates, save, play and the --load_path round trip
        bit for bit; (ii) ppo2 with mlp at 1024 x 128 and --microbatch_size=8192, 2
        updates, its params within 1e-5 of the same run without microbatches;
     e. deepq at its Atari defaults (conv_only, prioritized, dueling) through run.main on
        AtariSim-v0 with --env_type=atari, learning_starts 1000, 1280 steps: one sampler
        and 5 gather launches in each of its 71 training iterations, finite priorities;
        then the gather on 32 rows of a (10000, 84, 84, 4) u8 ring and the sampler at
        10240 slots with 32 targets, checked and timed in turns as in phases 4 and 5.
  11. main path 6, data parallelism under a one-rank NCCL mesh (torchrun's variables for
     rank 0 of 1, maybe_initialize_distributed, make_mesh):
     a. path 1's ppo2 (cnn_s2d bf16, 256 x 128, 2 updates) with mesh=: the same kernel
        launches as path 1, finite params, param_consistency_check true, and 34
        collectives an update (16 gradient all-reduces, 16 advantage merges, one gather
        of the monitor's episodes, one of the logged metrics);
     b. ppo2 with mlp on CartPole-v1 at 256 x 128, 2 updates, with and without the mesh
        from the same seed: the params and observations bit for bit (a one-rank
        all-reduce changes no value), or, where two runs without the mesh already differ,
        within that difference;
     c. prioritized deepq with mlp on CartPole-v1 under the mesh, 4 envs, 512 steps: one
        sampler and 5 gather launches in each of its 97 training iterations, finite params;
     d. a2c with mlp on CartPole-v1 at its classic-control defaults under the mesh,
        20000 steps: finite params, two collectives an update and one more an update that
        logs, env-steps/s;
     e. dryrun_multichip(2) over NCCL where the machine has two cards or more; with one
        card it says why it did not run (NCCL puts no two ranks on one GPU).
  12. main path 7, trpo, ddpg with deepq's param_noise, and her:
     a. trpo at trpo/defaults.py atari() with cnn_s2d in bf16 on AtariSim-v0, 16 envs x 32
        steps, 4 iterations: finite metrics with linesearch_success, >= 128 fused CNN and
        24 gather launches (2 fields x 3 value epochs an iteration);
     b. trpo with mlp on CartPole-v1 through run.main at the classic-control defaults,
        40 iterations of 1024 steps, saved and played: 10 gathers an iteration, a
        deterministic return >= 150 over 600 steps of 8 envs, the --load_path round trip
        bit for bit;
     c. ddpg through run.main on Pendulum-v1 at its classic-control defaults, one epoch of
        10 cycles x (100 steps, 50 train steps), saved and played: 5 gathers a train
        step, finite losses, the --load_path round trip bit for bit (actor, critic,
        targets, obs_rms, ret_rms) with the same play report; ddpg with adaptive-param_0.2
        and layer norms on BoxIdentity-v0 (a finite, adapted param_noise_stddev) and
        deepq with param_noise on CartPole-v1 for 1280 steps (a finite, adapted
        param_noise_scale);
     d. her through run.main on PointReach-v0 (16 envs, 10 cycles, 40 batches of 256,
        3 x 256 relu, 200000 steps), saved and played on dict observations: 6 gathers a
        train step, a deterministic success over 0.5 on 64 episodes, the --load_path round
        trip bit for bit with the same play report;
     e. the gather on 64 rows of ddpg's (10^6, 3) f32 ring and on 256 of her's flattened
        (510000, 2) f32 obs rows, bit for bit, timed in turns against index_select.
  13. main path 8, acer, acktr and gail:
     a. acer at acer/defaults.py atari() (cnn, 16 envs x 20 steps) on AtariSim-v0 with a
        2500-chunk replay of flat 592,704-byte obs rows (1.48 GB on the card), replay
        ratio 4 from 10000 steps, the trust region on, 40 updates: 5 gathers a replay
        update (the count recomputed from numpy's RandomState(0) Poisson draws), finite
        losses and average params; then the gather on 16 rows of that ring, bit for bit,
        timed in turns against index_select on rows read cold (20 disjoint sets of 16
        rows in turn) and warm (the same 16);
     b. acer with mlp on CartPole-v1 through run.main (4 envs, --frame_stack=2
        --dedup_frames=2, replay_start 2000, buffer_size 10000, 72000 steps), saved and
        played: 6 gathers a replay update, a deterministic return over 100 on 600 steps
        of 4 envs, the --load_path round trip bit for bit with the same play report;
     c. acktr at acktr/defaults.py atari() (the Nature cnn, eigendecompositions every 10
        updates) on AtariSim-v0, 8 envs x 20 steps, 20 updates: finite losses, finite
        spectra clamped at 0, and the time of one eigh of the (3137, 3137) first-dense
        factor; then acktr with mlp on DiscreteIdentity-v0 through run.main at the testing
        defaults, 60000 steps: a deterministic return over 90 on 300 steps of 8 envs, the
        --load_path round trip bit for bit;
     d. gail on BoxIdentity-v0 through run.main with --expert_path (an .npz written to a
        temporary directory: 5000 observations uniform in [-1, 1] from seed 0, acs = obs),
        8 envs, 512 steps a batch, g_step 1, d_step 3, 80000 steps: 12 gathers an
        iteration (10 in the value fit, 2 for the expert sample), a deterministic return
        over -10 on 300 steps of 8 envs, the --load_path round trip bit for bit with the
        adversary, its Adam states, the iteration count and the same play report;
     e. the gather at gail's shapes (512 rows of f32 (512, 1) value-fit obs and of the
        (5000, 1) expert table), bit for bit, timed in turns against index_select.
  14. main path 9, the host env path (``host_env_path``): g++ builds the native engine,
     held against the device envs on the card; the pipelined pair on a counting fixture;
     ppo2 with mlp on native:CartPole-v1 fused and pipelined at 8 envs x 64 steps;
     run.main at 1024 native envs x 128 steps with the --load_path round trip; one
     pipelined update under profiler.trace; the gather at this path's shapes.
  15. main path 10, the remaining learners under a one-rank NCCL mesh
     (``mesh_learners_path``), each run without the mesh and with it from the same seed
     (cudnn deterministic): the same kernel launches, the params bit for bit (or within
     the spread of two runs without the mesh), param_consistency_check true, the NCCL
     calls an iteration, and the steady rate of each printed (the median of the
     intervals between logged rows of two runs with the mesh and two without, run
     without, with, with, without):
     a. trpo at trpo/defaults.py atari() with cnn_s2d in bf16 on AtariSim-v0, 16 envs x
        32 steps (phase 12a's width), 7 iterations: K1 at every step, 42 gathers;
     b. ddpg on Pendulum-v1 at its classic-control defaults, 7 cycles of 100 steps and
        50 train steps: 1750 gathers, 201 NCCL calls a cycle;
     c. her on PointReach-v0 at phase 12d's width (16 envs, 40 batches of 256), 7 cycles:
        1680 gathers, 82 NCCL calls a cycle;
     d. acktr at acktr/defaults.py atari() on AtariSim-v0, 8 envs x 20 steps, 11 updates
        (two eigendecomposition rounds): 4 NCCL calls an update;
     e. acer at acer/defaults.py atari() with phase 13a's 2500-chunk flat ring, 10
        updates and the replay from update 4: 5 gathers a replay update;
     f. gail on BoxIdentity-v0 from an expert .npz written here, 7 iterations: 12
        gathers an iteration, no NCCL call (gail is not sharded);
     g. dryrun_multichip(2) over NCCL where the machine has two cards or more; with one
        card it says why it did not run.
  16. main path 11, the host side (``host_side_path``):
     a. ppo2 with cnn_s2d in bf16 at ppo/defaults.py atari() on the DeepMind chain
        (make_atari's NoopResetEnv(30) and MaxAndSkipEnv(4), then wrap_deepmind with the
        numpy WarpFrame) over ``AleStandIn``, a numpy stand-in for the ALE (the card's
        machine has no ale_py): 16 envs in worker processes forked after CUDA is up,
        CallbackVecEnv, VecFrameStack(4), VecMonitor, VecS2D(4), 128 steps, 3 updates:
        129 K1 and 24 K2 launches an update, finite losses, the rate with set-up and
        steady over updates 2-3, peak memory, and the time of one CallbackVecEnv step of
        the 16 envs;
     b. ppo2 with mlp on native:CartPole-v1, 8 envs x 64 steps, 2 updates, under a
        one-rank NCCL mesh and without it from the same seed: params and observations
        bit for bit, param_consistency_check true;
     c. K1 at B=16 (the rollout step) against its plain version, flat rows bit for bit
        the frames', and K2 on (2048, 21, 21, 64) u8 obs by a 2048-row permutation, bit
        for bit, each timed in turns against its library call (the cuDNN bf16 module,
        index_select);
     d. SumSegmentTree and MinSegmentTree at 2^20 leaves on the card: 4096 point sets, 64
        range sums and minima, 4096 prefix-sum searches, against numpy in f64;
     e. where the machine has cv2, VecVideoRecorder on CartPole-v1 on the card writes its
        mp4s at the trigger steps; where it has tensorboard, the logger's tensorboard
        format writes scalars that read back. A line names what the machine lacks (retro
        for the retro chain) and did not run.
  17. main path 12, the examples and the results tools (``examples_path``):
     a. train_cartpole's configuration (``examples/train_cartpole.LEARN_KWARGS``: deepq,
        mlp with 64 hidden, 4 envs, a 50000-row ring) through the port's learn on the
        card, at the depth ``TRAIN_CARTPOLE_STEPS`` (printed with its cut): 5 gathers a
        training iteration, finite logged rewards and params, the rate with set-up and
        steady after the first chunk, peak memory, the final mean episode return; saved;
     b. enjoy_cartpole on that file: learn with total_timesteps=0 and load_path, 1000
        deterministic evaluation steps of 4 envs, the trained model's report bit for bit,
        and its 300-frame mp4 (cv2 on the card's machine; without it the phase fails);
     c. custom_network's configuration (ppo2 on the registered my_tiny_net, width 64, 8
        envs x 128 steps) at ``CUSTOM_NETWORK_STEPS``: 24 gathers an update, finite
        losses, the rates; a second my_tiny_net registration raises ValueError;
     d. the gather on 32 rows of the (50000, 4) f32 ring and on (1024, 4) f32 obs by a
        1024-row permutation, bit for bit, timed in turns against index_select;
     e. one monitor.csv a run by bench.monitor_io.ResultsWriter from the episodes (a) and
        (c) logged, read back by both loaders where the machine has pandas, and drawn by
        plot_util.plot_results and results_plotter.plot_results to PNG where it has
        matplotlib too (a line says what did not run and why).
  18. main path 13, the API surface (``api_surface_path``):
     a. gail on BoxIdentity-v0 at phase 13d's widths (8 envs, 512 steps a batch, g_step
        1, d_step 3), 2 iterations, through the port's learn with no device argument,
        from an ExpertDataset that the caller built from an expert .npz (5000 rows from
        seed 0) with no device argument, so on the card: 12 gathers an iteration (2 for
        each of the 5 value epochs, 2 for the expert sample), finite params; then the
        gather on 512 rows of that (5000, 1) f32 table, bit for bit, timed in turns
        against index_select;
     b. a policy step of mlp on MultiBinary(16) observations with Discrete(4) actions at
        batch 256 on the card, against the same params on the CPU: logits, values and
        the neglogp of the card's sampled actions to 1e-5 relative;
     c. with a Draws on the card: 10,000 samples of each space (Discrete, bounded,
        u8 and unbounded Box, MultiDiscrete, MultiBinary, DictSpace), each on the card
        and in its space; discount and affine_reverse_scan at (128, 1024) f32 on the
        card against the CPU to 1e-6 relative; logger.profile_kv around one gather
        launch, which writes its wait_ key.
  Every sub-phase prints its seconds, env-steps/s (set-up included) and peak memory.
Then one JSON line with every kernel's numbers (launches summed over the main paths,
and by path), and last the contract line {"ok": true, "device": {...}}. Any failed
check raises, and the script exits nonzero. It exits nonzero before building anything
when there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch

sys.dont_write_bytecode = True  # the run writes nothing into the tree but the kernel build

# H100 SXM peaks (NVIDIA's data sheet, dense, at the full 700 W power limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
K1_REL_TOL = 2e-2  # bf16 activations between layers, sums in another order


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters calls, by CUDA events, after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 10) -> float:
    """Mean device time of fn per call, from a CUDA graph of iters calls replayed reps
    times. The host's cost of a call (Python, the wrapper's checks, the launch) is paid
    at capture and not at replay, so a kernel that takes less time than that cost is
    timed by itself; time_ms would time the host instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def turns_ms(fns: dict, iters: int, reps: int = 10, rounds: int = 1) -> tuple[dict, dict]:
    """graph_ms of each fn, measured in turns after one discarded measurement of the
    first: in order, then in reverse order, rounds times. Returns the mean of each fn's
    readings, so that neither the first nor the last place favours one, and the
    readings themselves, in the order taken."""
    graph_ms(next(iter(fns.values())), iters, reps)
    readings = {k: [] for k in fns}
    for _ in range(rounds):
        for order in (list(fns), list(reversed(list(fns)))):
            for k in order:
                readings[k].append(graph_ms(fns[k], iters, reps))
    return {k: sum(v) / len(v) for k, v in readings.items()}, readings


def lead(readings: dict, a: str, b: str) -> str:
    """How a's readings stand against b's, turn by turn: the readings and the number of
    turns in which a took less time."""
    wins = sum(x < y for x, y in zip(readings[a], readings[b]))
    return (f"{a} {', '.join(f'{x:.4f}' for x in readings[a])}; {b} "
            f"{', '.join(f'{y:.4f}' for y in readings[b])}; {a} faster in {wins} of "
            f"{len(readings[a])} turns")


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference over the largest magnitude of want."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Tee:
    """A text stream that writes through to another and keeps what it wrote."""

    def __init__(self, stream):
        self.stream = stream
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


@contextlib.contextmanager
def count_collectives():
    """Counts the calls of torch.distributed's collectives inside the block."""
    names = ("all_reduce", "all_gather", "all_gather_object", "barrier")
    saved = {name: getattr(torch.distributed, name) for name in names}
    calls = [0]

    def counted(fn):
        def call(*args, **kwargs):
            calls[0] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(torch.distributed, name, counted(fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(torch.distributed, name, fn)


def join_one_rank_group():
    """torchrun's variables for rank 0 of 1 on this card, the rendezvous on a free local
    port; returns the mesh of the NCCL group joined (maybe_initialize_distributed)."""
    from baselines_tpu_torch.distributed import make_mesh, maybe_initialize_distributed

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    require(maybe_initialize_distributed() and maybe_initialize_distributed(),
            "maybe_initialize_distributed did not join the group")
    backend = str(torch.distributed.get_backend())
    mesh = make_mesh()
    require(backend == "nccl" and mesh.size == 1 and mesh.device == torch.device("cuda", 0),
            f"the mesh is {mesh} on backend {backend}, expected one NCCL rank on cuda:0")
    return mesh


def timed_output(recording_output):
    """The logger output class ``recording_output`` that also keeps the host clock at
    each row it is given (a row waits for the device)."""

    class TimedOutput(recording_output):
        def __init__(self):
            super().__init__()
            self.times = []

        def writekvs(self, kvs):
            super().writekvs(kvs)
            self.times.append(time.perf_counter())

    return TimedOutput


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            print(f"[phase] {self.name}: {time.perf_counter() - self.start:.2f} s", flush=True)


def host_env_path(dev, card, kernels, counts, reset_counts, read_counts, run_cli,
                  play_report, recording_output):
    """Main path 9, the host env path (phase 14 of the module's docstring): the native
    engine, the pipelined pair on the counting fixture, ppo2 fused and pipelined at
    bench.py:288-299's width, run.main at 1024 native envs, and a profile of one
    pipelined update. Adds the path's launch counts to ``counts`` and K2's times at its
    shapes to ``kernels``."""
    import dataclasses
    from types import SimpleNamespace

    import numpy as np

    from baselines_tpu_torch import native
    from baselines_tpu_torch.algos.common import (ClipAdam, build_env_pair, init_pipe_state,
                                                  run_rollout, run_rollout_pipelined)
    from baselines_tpu_torch.algos.ppo.ppo import PPOTrainState, learn, make_update_fn
    from baselines_tpu_torch.core import logger, profiler
    from baselines_tpu_torch.core.rng import Draws
    from baselines_tpu_torch.envs.callback_env import CallbackVecEnv
    from baselines_tpu_torch.envs.gym_bridge import HostVecEnv
    from baselines_tpu_torch.envs.host_pipeline import PipelinedHostVecPair
    from baselines_tpu_torch.envs.registry import make_env
    from baselines_tpu_torch.envs.spaces import Box, Discrete
    from baselines_tpu_torch.envs.vec import VecMonitor
    from baselines_tpu_torch.nn.policy import build_policy
    from baselines_tpu_torch.ops.gather import take_rows

    # a. the engine built by g++ from the checkout, then each of its envs against the
    # port's device env on the card, 64 envs (OpenMP's branch), from the same physics
    built = native.library_path().exists()
    start = time.perf_counter()
    path = native.build()
    native.library()
    build_s = time.perf_counter() - start
    print(f"main path 9a: native engine {'found built' if built else 'built by g++'} in "
          f"{build_s:.2f} s -> {path}", flush=True)
    worst = {}
    for env_id, n_steps in (("CartPole-v1", 30), ("Pendulum-v1", 50), ("MountainCar-v0", 50),
                            ("MountainCarContinuous-v0", 50), ("Acrobot-v1", 40)):
        pool = native.NativeVecEnv(env_id, 64, seed=11)
        pool.reset(seed=11)
        phys = pool.get_state()
        rng = np.random.RandomState(0)
        discrete = isinstance(pool.action_space, Discrete)
        actions = (rng.randint(0, pool.action_space.n, (n_steps, 64)).astype(np.float32)
                   if discrete else rng.uniform(-1, 1, (n_steps, 64, 1)).astype(np.float32))
        env = make_env(env_id).unwrapped
        draws = Draws(0, dev)
        _, state = env.reset(draws, 64, dev)
        fields, col = {}, 0
        for f in dataclasses.fields(state):
            x = getattr(state, f.name)
            width = int(np.prod(x.shape[1:]))
            vals = phys[:, col:col + width].astype(np.float32).reshape(tuple(x.shape))
            fields[f.name] = torch.from_numpy(vals).to(dev)
            col += width
        state = dataclasses.replace(state, **fields)
        alive = np.ones(64, bool)
        err = 0.0
        for a in actions:
            o, r, d, infos = pool.step(a)
            o = o.copy()
            for i in np.flatnonzero(d):
                o[i] = infos[i]["terminal_observation"]
            act = torch.from_numpy(a).to(dev)
            obs, state, rew, _, _ = env.step(draws, state, act.long() if discrete else act)
            # tests/test_native_env.py's tolerance: |native - device| <= 1e-4 + 1e-4 |device|
            got = np.concatenate([obs.cpu().numpy(), rew.cpu().numpy()[:, None]], axis=1)
            want = np.concatenate([o, r[:, None]], axis=1)[alive]
            diff = np.abs(got[alive] - want)
            err = max(err, float(diff.max(initial=0.0)))
            require(bool(np.all(diff <= 1e-4 + 1e-4 * np.abs(got[alive]))),
                    f"native {env_id} differs from the device env by {diff.max():.3g}")
            alive &= ~d  # past an env's first end the engine has reset it
        pool.close()
        worst[env_id] = err
    print(f"main path 9a [{card}]: the native engine against the port's device envs on the "
          f"card, 64 envs each up to its first end, max abs err {worst} (tol 1e-4 + 1e-4 "
          f"relative)", flush=True)

    # b. the counting fixture of tests/test_host_pipeline.py on CUDA tensors: pipelined
    # equals serial exactly, and each step submits A, collects B, submits B, collects A
    class CountingHost(HostVecEnv):
        def __init__(self, n, log, name):
            self.num_envs, self.log, self.name = n, log, name
            self.observation_space = Box(-np.inf, np.inf, (1,), np.float32)
            self.action_space = Box(-10.0, 10.0, (1,), np.float32)
            self._c = np.zeros((n, 1), np.float32)

        def reset(self, seed=None):
            self._c[:] = 0.0
            return self._c.copy()

        def step_async(self, actions):
            self.log.append(("submit", self.name))
            self._pending = np.asarray(actions, np.float32).reshape(self.num_envs, 1)

        def step_wait(self):
            self.log.append(("collect", self.name))
            self._c = self._c + self._pending + 1.0
            rew, done = self._c[:, 0].copy(), self._c[:, 0] >= 7.0
            obs, infos = self._c.copy(), [{} for _ in range(self.num_envs)]
            for i in np.flatnonzero(done):
                infos[i]["terminal_observation"] = obs[i].copy()
                self._c[i] = obs[i] = 0.0
            return obs, rew, done, infos

        def step(self, actions):
            self.step_async(actions)
            return self.step_wait()

    class StubPolicy:
        is_recurrent = False
        pdtype = SimpleNamespace(sample_shape=(1,), sample_dtype=torch.float32)

        def pack(self):
            return None

        def step(self, obs, draws, packed=None):
            return torch.remainder(obs, 2.0) * 0.25, obs[..., 0] * 0.1, obs[..., 0] * 0.01 + 1

        def value(self, obs, packed=None, rnn_state=None, mask=None):
            return obs[..., 0] * 0.1

    log = []
    chain = lambda n, name: VecMonitor(CallbackVecEnv(CountingHost(n, log, name), device=dev))
    draws = Draws(0, dev)
    fused = chain(8, "F")
    obs, st = fused.reset(draws)
    _, _, _, traj_f, last_f, _ = run_rollout(StubPolicy(), fused, draws, st, obs,
                                             torch.zeros(8, dtype=torch.bool, device=dev), 12)
    pair = PipelinedHostVecPair(chain(4, "A"), chain(4, "B"))
    ps = init_pipe_state(StubPolicy(), pair, draws, pair.a.reset(draws), pair.b.reset(draws))
    log.clear()
    ps, traj_p, last_p = run_rollout_pipelined(StubPolicy(), pair, draws, ps, 12)
    fields = ("obs", "actions", "values", "neglogps", "rewards", "dones", "rnn_masks")
    require(traj_p.obs.is_cuda and all(torch.equal(getattr(traj_f, f), getattr(traj_p, f))
                                       for f in fields) and torch.equal(last_f, last_p),
            "the pipelined counting rollout differs from the serial one")
    body = [("submit", "A"), ("collect", "B"), ("submit", "B"), ("collect", "A")]
    require(log == body * 12, f"the pipelined order is {log[:8]}")
    print(f"main path 9b [{card}]: the counting fixture on cuda, 2 groups of 4 pipelined "
          f"against 8 serial over 12 steps: every field and the last value equal, "
          f"{int(traj_p.dones.sum())} dones; the order submit A, collect B, submit B, "
          f"collect A at each of the 12 steps", flush=True)

    # the raw pool and the host loops, at bench.py's 8 envs, a pipelined group of 512 and
    # 1024: the C call alone, the pool's step (the C call and _collect's dict a env), and
    # CallbackVecEnv's step from and to the card (_format_results, the copies), with zero
    # actions (bench.py's _raw_host_fps), 100 steps of each in turn, 5 rounds, the median
    def per_step_us(fns: dict, iters=100, rounds=5) -> dict:
        for fn in fns.values():
            fn()
        readings = {k: [] for k in fns}
        for _ in range(rounds):
            for k, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                readings[k].append((time.perf_counter() - t0) / iters * 1e6)
        return {k: float(np.median(v)) for k, v in readings.items()}

    raw = {}
    for n in (8, 512, 1024):
        pool = native.NativeVecEnv("CartPole-v1", n)
        pool.reset(0)
        zeros = np.zeros((n,), np.float32)
        acts = pool._actions(zeros)
        venv = CallbackVecEnv(pool, device=dev)
        dev_acts = torch.zeros(n, dtype=torch.int64, device=dev)
        us = per_step_us({
            "c": lambda: pool._lib.btenv_step(pool._handle, acts, pool._obs, pool._rew,
                                              pool._done, pool._terminal_obs),
            "pool": lambda: pool.step(zeros),
            "callback": lambda: venv.step(None, 0, dev_acts)})
        c_us, pool_us, cb_us = us["c"], us["pool"], us["callback"]
        venv.close()
        raw[n] = n / pool_us * 1e6
        print(f"main path 9c [{card}]: native CartPole-v1 pool of {n}: {raw[n]:.0f} raw "
              f"env-steps/s (pool.step {pool_us:.1f} us a step: the C call {c_us:.1f} us, "
              f"_collect's dicts {pool_us - c_us:.1f} us); CallbackVecEnv.step from and to "
              f"the card {cb_us:.1f} us a step ({n / cb_us * 1e6:.0f} env-steps/s): the C call "
              f"{c_us / cb_us:.1%}, _collect {(pool_us - c_us) / cb_us:.1%}, _format_results "
              f"with the copies {(cb_us - pool_us) / cb_us:.1%}", flush=True)

    # c. bench.py:288-299: ppo2 mlp on native:CartPole-v1, 8 envs x 64 steps, 4 epochs x
    # 4 minibatches, fused and pipelined, 4 updates each; steady rate over updates 2-4
    hp = dict(network="mlp", nsteps=64, nminibatches=4, noptepochs=4, seed=0,
              log_interval=1)
    rates = {}
    for mode, pipeline in (("fused", False), ("pipelined", True)):
        recorder = recording_output()
        logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
        reset_counts()
        start = time.perf_counter()
        model = learn(env_id="native:CartPole-v1", num_envs=8, total_timesteps=4 * 512,
                      pipeline=pipeline, **hp)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        logger.reset()
        counts[f"native_{mode}"] = c = read_counts()
        require(c["take_rows"] == 96, f"ppo2 {mode} on native CartPole launched {c}, "
                "expected 96 take_rows (6 fields x 4 epochs x 4 updates)")
        rows = recorder.rows
        require(len(rows) == 4 and all(math.isfinite(float(r[k])) for r in rows
                                       for k in r if k.startswith("loss/")),
                f"ppo2 {mode}: {len(rows)} rows or a loss not finite")
        t = [float(r["misc/time_elapsed"]) for r in rows]
        rates[mode] = 3 * 512 / (t[3] - t[0])
        pipelined = type(model.state.env_state).__name__ == "PipeState"
        require(pipelined == pipeline, f"ppo2 {mode}: the env state is "
                f"{type(model.state.env_state).__name__}")
        print(f"main path 9c [{card}]: ppo2 mlp on native:CartPole-v1 {mode}, 8 x 64, 4 x 4, "
              f"4 updates: launches {c}; steady {rates[mode]:.0f} env-steps/s (updates 2-4); "
              f"{elapsed:.2f} s with set-up; update times {[round(b - a, 4) for a, b in zip([0] + t, t)]} "
              f"s; eprewmean {[r['eprewmean'] for r in rows]}", flush=True)
    print(f"main path 9c [{card}]: raw pool of 8 {raw[8]:.0f} env-steps/s; pipelined / fused "
          f"{rates['pipelined'] / rates['fused']:.3f}", flush=True)

    # d. run.main at 1024 native envs x 128 steps, pipelined (the auto rule), 2 updates,
    # --save_path and --play, then the --load_path round trip; and the same learn fused
    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_")
    try:
        nenv, nsteps = 1024, 128
        nbatch = nenv * nsteps
        model_path = os.path.join(tmp, "ppo2_native.pt")
        argv = ["--alg=ppo2", "--env=native:CartPole-v1", "--network=mlp", "--seed=0",
                f"--num_env={nenv}", f"--nsteps={nsteps}", "--nminibatches=4",
                "--noptepochs=4", "--log_interval=1", "--play"]
        reset_counts()
        start = time.perf_counter()
        model_a, out_a = run_cli(argv + [f"--num_timesteps={2 * nbatch}",
                                         f"--save_path={model_path}",
                                         f"--log_path={os.path.join(tmp, 'a')}"])
        elapsed = time.perf_counter() - start
        counts["cli_native"] = c = read_counts()
        require(c["take_rows"] == 48, f"run.main on native:CartPole-v1 launched {c}, expected "
                "48 take_rows (6 fields x 4 epochs x 2 updates)")
        require(type(model_a.state.env_state).__name__ == "PipeState",
                "run.main at 1024 native envs did not pipeline")
        with open(os.path.join(tmp, "a", "progress.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        require(len(rows) == 2 and all(math.isfinite(float(v)) for r in rows
                                       for k, v in r.items() if k.startswith("loss/")),
                f"run.main on native: {len(rows)} rows or a loss not finite")
        t = [float(r["misc/time_elapsed"]) for r in rows]
        rate_p = nbatch / (t[1] - t[0])
        report_a = play_report(out_a)
        model_b, out_b = run_cli(argv + ["--num_timesteps=0", f"--load_path={model_path}",
                                         f"--log_path={os.path.join(tmp, 'b')}"])
        sa, sb = model_a.policy.module.state_dict(), model_b.policy.module.state_dict()
        require(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
                "run.main on native: the loaded params differ from the saved ones")
        require(play_report(out_b) == report_a, f"run.main on native: play after load "
                f"{play_report(out_b)}, after training {report_a}")
        print(f"main path 9d [{card}]: run.main ppo2 mlp on native:CartPole-v1, {nenv} x "
              f"{nsteps} pipelined (2 groups of 512), 2 updates: launches {c}; update 2 "
              f"{rate_p:.0f} env-steps/s (update 1 {nbatch / t[0]:.0f} with set-up); "
              f"loss/policy_loss {[r['loss/policy_loss'] for r in rows]}; run.main with save "
              f"and play {elapsed:.2f} s; the load round trip bit for bit, {report_a}",
              flush=True)
        del model_a, model_b

        recorder = recording_output()
        logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
        reset_counts()
        learn(env_id="native:CartPole-v1", num_envs=nenv, total_timesteps=2 * nbatch,
              pipeline=False, **dict(hp, nsteps=nsteps))
        torch.cuda.synchronize()
        logger.reset()
        counts["native_fused_1024"] = c = read_counts()
        require(c["take_rows"] == 48, f"fused ppo2 at 1024 native envs launched {c}")
        t = [float(r["misc/time_elapsed"]) for r in recorder.rows]
        rate_f = nbatch / (t[1] - t[0])
        print(f"main path 9d [{card}]: the same 2 updates fused (pipeline=False): launches "
              f"{c}; update 2 {rate_f:.0f} env-steps/s; pipelined / fused "
              f"{rate_p / rate_f:.3f}", flush=True)

        # e. one pipelined update of (d)'s configuration profiled, after one that times
        # group A's native step on its worker thread against group B's device window (from
        # B's collect to its actions back on the host), both on the host's clock
        pair = build_env_pair("native:CartPole-v1", nenv, device=dev)
        policy = build_policy(pair.observation_space, pair.action_space, "mlp", device=dev,
                              generator=torch.Generator().manual_seed(0))
        opt = ClipAdam(policy.module.parameters(), 0.5, eps=1e-5)
        draws = Draws(0, dev)
        reset_a, reset_b = pair.a.reset(draws), pair.b.reset(draws)
        state = PPOTrainState(env_state=init_pipe_state(policy, pair, draws, reset_a, reset_b),
                              obs=reset_a[0],
                              last_done=torch.zeros(nenv, dtype=torch.bool, device=dev))
        update_fn = make_update_fn(policy, pair, opt, nsteps=nsteps, nminibatches=4,
                                   noptepochs=4, gamma=0.99, lam=0.95, ent_coef=0.0,
                                   vf_coef=0.5, lr_fn=lambda f: 3e-4 * f,
                                   cliprange_fn=lambda f: 0.2, nupdates=3, pipelined=True)
        state, _ = update_fn(state, draws)  # warm
        lib_a = pair.base_a.host._lib
        marks = {k: [] for k in ("submit_a", "a_start", "a_end", "b_collected", "b_acted")}

        class TimedLib:
            def __getattr__(self, name):
                return getattr(lib_a, name)

            def btenv_step(self, *args):
                marks["a_start"].append(time.perf_counter())
                lib_a.btenv_step(*args)
                marks["a_end"].append(time.perf_counter())

        swap_ab, submit_a, submit_b = pair.swap_ab, pair.base_a._host_submit, \
            pair.base_b._host_submit

        def timed_submit_a(actions):
            marks["submit_a"].append(time.perf_counter())
            submit_a(actions)

        def timed_swap_ab(actions):
            out = swap_ab(actions)
            marks["b_collected"].append(time.perf_counter())
            return out

        def timed_submit_b(actions):
            submit_b(actions)  # the copy of B's actions waits for B's forward pass
            marks["b_acted"].append(time.perf_counter())

        pair.base_a.host._lib = TimedLib()
        pair.base_a._host_submit, pair.swap_ab = timed_submit_a, timed_swap_ab
        pair.base_b._host_submit = timed_submit_b
        start = time.perf_counter()
        state, _ = update_fn(state, draws)
        torch.cuda.synchronize()
        timed_s = time.perf_counter() - start
        pair.base_a.host._lib = lib_a
        pair.base_a._host_submit, pair.swap_ab = submit_a, swap_ab
        pair.base_b._host_submit = submit_b
        a_start, a_end = np.array(marks["a_start"]), np.array(marks["a_end"])
        submit = np.array(marks["submit_a"])
        b0, b1 = np.array(marks["b_collected"]), np.array(marks["b_acted"])
        require(len(a_start) == len(b0) == len(b1) == nsteps,
                f"timed {len(a_start)} A steps and {len(b0)} B windows, expected {nsteps}")
        overlap = np.clip(np.minimum(a_end, b1) - np.maximum(a_start, b0), 0, None)
        print(f"main path 9e [{card}]: one timed pipelined update, {timed_s:.3f} s: group A's "
              f"native step {np.mean(a_end - a_start) * 1e6:.1f} us (median "
              f"{np.median(a_end - a_start) * 1e6:.1f}), starting {np.median(a_start - submit) * 1e6:.1f} "
              f"us after its submit (median); group B's window {np.mean(b1 - b0) * 1e6:.1f} us; "
              f"A's step within B's window {overlap.sum() / (a_end - a_start).sum():.1%} of its "
              f"time, in {int((overlap > 0).sum())} of {nsteps} steps", flush=True)

        trace_dir = os.path.join(tmp, "trace")
        label = "ppo2 pipelined update"
        reset_counts()
        with profiler.trace(trace_dir) as prof:
            start = time.perf_counter()
            with profiler.annotate(label):
                state, metrics = update_fn(state, draws)
                float(metrics["policy_loss"])
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - start
        counts["native_traced"] = c = read_counts()
        pair.close()
        # the device's kernels, copies and fills; the annotation's range on the device
        # timeline (which spans its first to its last kernel) is none of them
        device_events = [e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and e.name != label and not getattr(e, "is_user_annotation", False)]
        require(any(e.name == label for e in prof.events()),
                "the trace holds no range of profiler.annotate")
        kernels_in_trace = [e for e in device_events
                            if not e.name.startswith(("Memcpy", "Memset"))]
        k2_in_trace = [e for e in kernels_in_trace if "gather_rows_kernel" in e.name]
        spans = sorted((e.time_range.start, e.time_range.end) for e in device_events)
        busy, cur_start, cur_end = 0.0, None, None
        for s0, s1 in spans:
            if cur_end is None or s0 > cur_end:
                busy += 0.0 if cur_end is None else cur_end - cur_start
                cur_start, cur_end = s0, s1
            else:
                cur_end = max(cur_end, s1)
        busy += 0.0 if cur_end is None else cur_end - cur_start
        trace_files = os.listdir(trace_dir)
        require(len(trace_files) == 1 and c["take_rows"] == 24,
                f"the profiled update wrote {trace_files} and launched {c}")
        require(len(k2_in_trace) == 24, f"the trace holds {len(k2_in_trace)} gather kernels "
                f"of the update's 24 ({len(kernels_in_trace)} kernels in all)")
        dur = lambda e: e.time_range.end - e.time_range.start
        k2_us = sum(dur(e) for e in k2_in_trace)
        kernel_us = sum(dur(e) for e in kernels_in_trace)
        copy_us = sum(dur(e) for e in device_events) - kernel_us
        longest = sorted(device_events, key=dur)[-3:]
        print(f"main path 9e [{card}]: profiler.trace of one pipelined update ({traced_s:.3f} "
              f"s traced): {len(kernels_in_trace)} kernels, {kernel_us / 1e3:.2f} ms of device "
              f"time; {len(device_events) - len(kernels_in_trace)} copies and fills, "
              f"{copy_us / 1e3:.2f} ms; {len(k2_in_trace)} take_rows, {k2_us / 1e3:.3f} ms; the "
              f"device busy (the union of those intervals) {busy / 1e6 / traced_s:.1%} of the "
              f"update's wall time, the kernels alone {kernel_us / 1e6 / traced_s:.1%}; longest "
              f"{[(e.name[:40], round(dur(e), 1)) for e in longest]} us; the Chrome trace "
              f"{os.path.getsize(os.path.join(trace_dir, trace_files[0])) / 2**20:.1f} MiB",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # K2 at this path's shapes: bench.py's 8 x 64 batch, obs f32 (512, 4) and an f32
    # (512,) field by a 512-row permutation (the 1024 x 128 batch is path 3d's shapes)
    gen = torch.Generator(device=dev).manual_seed(15)
    perm = torch.randperm(512, device=dev, generator=gen)
    shapes = []
    for x in (torch.randn((512, 4), device=dev, generator=gen),
              torch.randn((512,), device=dev, generator=gen)):
        require(torch.equal(take_rows(x, perm), x[perm]), "take_rows at 8 x 64 differs")
        t, readings = turns_ms({"kernel": lambda: take_rows(x, perm), "plain": lambda: x[perm],
                                "index_select": lambda: x.index_select(0, perm)}, 50, rounds=3)
        bms, by = bound_ms(0, 2 * x.numel() * 4 + perm.numel() * 8)
        shape = f"bench.py's 8 x 64 batch: f32 {tuple(x.shape)} by (512,) int64"
        shapes.append(dict(shape=shape, max_abs_err=0.0, ms=t["kernel"], plain_ms=t["plain"],
                           bound_ms=bms, bound_by=by, library_ms=t["index_select"]))
        print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms, plain "
              f"x[idx] {t['plain']:.4f} ms, index_select {t['index_select']:.4f} ms, bound "
              f"{bms:.6f} ms ({by}); in turns: {lead(readings, 'kernel', 'index_select')} "
              f"[{card}]", flush=True)
    kernels["take_rows"]["path9_shapes"] = shapes


def mesh_learners_path(dev, card, counts, reset_counts, read_counts, recording_output):
    """Main path 10, the remaining learners under a one-rank NCCL mesh (phase 15 of the
    module's docstring): trpo, ddpg, her, acktr, acer and gail at phases 12-13's widths,
    each run without the mesh and with it from the same seed; then dryrun_multichip(2)
    where the machine has two cards. Adds the mesh runs' launch counts to ``counts``."""
    import numpy as np

    from baselines_tpu_torch.algos import get_learn_function
    from baselines_tpu_torch.algos.acer.defaults import atari as acer_atari
    from baselines_tpu_torch.algos.acktr.defaults import atari as acktr_atari
    from baselines_tpu_torch.algos.ddpg.defaults import classic_control as ddpg_classic
    from baselines_tpu_torch.algos.trpo.defaults import atari as trpo_atari
    from baselines_tpu_torch.core import logger
    from baselines_tpu_torch.distributed import param_consistency_check, psum
    from baselines_tpu_torch.distributed.dryrun import dryrun_multichip

    TimedOutput = timed_output(recording_output)

    def replays(updates: int, steps_per_update: int, replay_start: int) -> int:
        rng = np.random.RandomState(0)  # acer's Poisson(4) replay counts
        return sum(rng.poisson(4) for u in range(1, updates + 1)
                   if u * steps_per_update >= replay_start)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice10_")
    expert = np.random.RandomState(0).uniform(-1, 1, size=(1, 5000, 1)).astype(np.float32)
    expert_path = os.path.join(tmp, "expert.npz")
    np.savez(expert_path, obs=expert, acs=expert.copy())
    n_replay = replays(10, 320, 4 * 320)
    # name -> (alg, learn's keywords, env steps a logged row, the rows, the NCCL calls of
    # the mesh run or None where the line search sets them, K2 launches); 7 rows or more
    # each, so that the steady rate is the median of 6 intervals or more
    runs = {
        # a. phase 12a: trpo atari() with cnn_s2d bf16, 16 envs x 32 steps, 7 iterations
        "trpo": ("trpo", dict(dict(trpo_atari(), network="cnn_s2d"), env_id="AtariSim-v0",
                              dtype=torch.bfloat16, env_kwargs={"s2d": 4}, num_envs=16,
                              total_timesteps=7 * 512, log_interval=1), 512, 7, None, 7 * 6),
        # b. ddpg's classic-control defaults on Pendulum-v1 (4 envs, ou_0.2), 7 epochs of
        # one cycle (100 steps, 50 train steps): a gather a step, a sync a cycle, two
        # gradient all-reduces a train step
        "ddpg": ("ddpg", dict(ddpg_classic(), env_id="Pendulum-v1", nb_epochs=7,
                              nb_epoch_cycles=1), 400, 7, 7 * (100 + 1 + 2 * 50), 7 * 250),
        # c. phase 12d's width (16 envs, 40 batches of 256, 3 x 256 relu), 7 epochs of
        # one cycle: a gather of the episodes and two all-reduces a train step, one
        # gather of the evaluator's successes an epoch
        "her": ("her", dict(env_id="PointReach-v0", num_envs=16, n_cycles=1, n_batches=40,
                            batch_size=256, total_timesteps=7 * 16 * 50), 800, 7,
                7 * (1 + 2 * 40 + 1), 7 * 40 * 6),
        # d. acktr atari() (the Nature cnn, eigendecompositions every 10 updates) at
        # phase 13c's 8 envs x 20 steps, 11 updates (two eigendecomposition rounds): the
        # monitor's gather, the gradients', the factor moments', the logged metrics'
        "acktr": ("acktr", dict(acktr_atari(), env_id="AtariSim-v0", num_envs=8,
                                total_timesteps=11 * 160, log_interval=1), 160, 11, 11 * 4, 0),
        # e. acer atari() with phase 13a's 2500-chunk ring of flat obs rows, 10 updates,
        # replay from update 4: the monitor's, the chunk's gather and the gradients' an
        # update, the gradients' a replay update, the logged metrics'
        "acer": ("acer", dict(acer_atari(), env_id="AtariSim-v0", total_timesteps=10 * 320,
                              buffer_size=50000, replay_ratio=4, replay_start=4 * 320,
                              log_interval=1), 320, 10, 10 * 4 + n_replay, 5 * n_replay),
        # f. gail on BoxIdentity-v0 at phase 13d's configuration from the expert .npz
        # written here, 7 iterations; unsharded, it makes no collective
        "gail": ("gail", dict(env_id="BoxIdentity-v0", expert_path=expert_path, num_envs=8,
                              timesteps_per_batch=512, gamma=0.9, lam=0.97, max_kl=0.01,
                              g_step=1, d_step=3, total_timesteps=7 * 512), 512, 7, 0, 7 * 12),
    }

    def trained(model) -> dict:
        """Every trained tensor: the policy's module, and ddpg's and her's critic, gail's
        discriminator."""
        out = dict(model.policy.module.state_dict())
        for owner, name in ((model.policy, "critic"), (model, "disc")):
            if getattr(owner, name, None) is not None:
                out.update({f"{name}.{k}": v for k, v in getattr(owner, name).state_dict().items()})
        return out

    def run(alg, kwargs, mesh):
        recorder = TimedOutput()
        logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by the runs before, not this one's
        reset_counts()
        start = time.perf_counter()
        with count_collectives() as calls:
            model = get_learn_function(alg)(seed=0, mesh=mesh, **kwargs)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        logger.reset()
        return dict(model=model, rows=recorder.rows, times=recorder.times, counts=read_counts(),
                    calls=calls[0], seconds=elapsed,
                    peak=torch.cuda.max_memory_allocated() - held)

    def max_diff(a: dict, b: dict) -> float:
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)

    # bit for bit needs the same algorithms in both runs
    saved_cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    mesh = join_one_rank_group()
    try:
        for letter, (name, (alg, kwargs, row_steps, nrows, want_calls, want_k2)) in zip(
                "abcdef", runs.items()):
            plain = run(alg, kwargs, None)
            meshed = run(alg, kwargs, mesh)
            counts[f"mesh_{name}"] = c = meshed["counts"]
            require(c == plain["counts"], f"{name} under the mesh launched {c}, without it "
                    f"{plain['counts']}")
            require(c["take_rows"] == want_k2, f"{name} launched {c}, expected {want_k2} "
                    "take_rows")
            if name == "trpo":
                require(c["fused_cnn"] >= nrows * 32, f"trpo under the mesh launched {c}, "
                        f"expected >= {nrows * 32} fused_cnn")
            calls = meshed["calls"]
            if want_calls is None:  # an iteration: 4, cg_iters + 1, and 1 to 10 probes
                per_iter = 4 + trpo_atari()["cg_iters"] + 1
                require(nrows * (per_iter + 1) <= calls <= nrows * (per_iter + 10),
                        f"trpo under the mesh made {calls} NCCL calls in {nrows} iterations")
            else:
                require(calls == want_calls, f"{name} under the mesh made {calls} NCCL "
                        f"calls, expected {want_calls}")
            require(len(meshed["rows"]) == len(plain["rows"]) == nrows,
                    f"{name} logged {len(meshed['rows'])} rows, {len(plain['rows'])} without "
                    f"the mesh, expected {nrows}")
            params, want = trained(meshed["model"]), trained(plain["model"])
            require(all(bool(torch.isfinite(v).all()) for v in params.values()),
                    f"{name} under the mesh: params not finite")
            require(param_consistency_check(list(meshed["model"].policy.module.parameters()),
                                            mesh, atol=0.0),
                    f"{name}: param_consistency_check failed")
            # two more runs for the rates, so that the runs go without, with, with, without
            meshed2 = run(alg, kwargs, mesh)
            plain2 = run(alg, kwargs, None)
            diff = max_diff(params, want)
            if diff == 0.0:
                verdict = "bit for bit equal to the run without the mesh"
            else:  # hold the mesh run to the spread of two runs without it
                noise = max_diff(trained(plain2["model"]), want)
                require(diff <= noise, f"{name}: the mesh run differs by {diff}, two runs "
                        f"without the mesh by {noise}")
                verdict = (f"within {diff:.3g} of the run without the mesh, where two runs "
                           f"without it differ by {noise:.3g}")

            def steady(*rs):  # env steps a second, the median of the logged rows' intervals
                return float(np.median(np.concatenate(
                    [row_steps / np.diff(r["times"]) for r in rs])))

            rate, rate_plain = steady(meshed, meshed2), steady(plain, plain2)
            alone = steady(meshed) / steady(plain), steady(meshed2) / steady(plain2)
            print(f"main path 10{letter} [{card}]: {name} under a one-rank NCCL mesh, "
                  f"launches {c} (the same without the mesh); {calls} NCCL calls in {nrows} "
                  f"iterations = {calls / nrows:.2f} an iteration; steady rate, the median of "
                  f"the 2 x {nrows - 1} intervals between logged rows of two runs each (in "
                  f"the order without, with, with, without), {rate:.0f} env-steps/s under the "
                  f"mesh, {rate_plain:.0f} without ({rate / rate_plain:.3f}; the first pair "
                  f"{alone[0]:.3f}, the second {alone[1]:.3f}); "
                  f"{meshed['seconds']:.2f} s with set-up "
                  f"({plain['seconds']:.2f} s without); params {verdict}; peak device memory "
                  f"{meshed['peak'] / 2**30:.2f} GiB ({plain['peak'] / 2**30:.2f} without)",
                  flush=True)
            del plain, meshed, plain2, meshed2, params, want

        # does a collective hold the host until the device has run what was queued
        # before it? 20 f32 matmuls of 4096 x 4096 queued (about 40 ms of device time),
        # then one call timed on the host clock before the device is synchronized: an
        # all-reduce of 1024 f32, and a device op of the same size in its place
        a = torch.randn((4096, 4096), device=dev)
        x = torch.randn((1024,), device=dev)
        waits = {}
        for what, call in (("x * 1.0", lambda: x * 1.0), ("psum", lambda: psum([x], mesh))):
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                a @ a
            queued = time.perf_counter()
            call()
            returned = time.perf_counter()
            torch.cuda.synchronize()
            waits[what] = ((queued - t0) * 1e3, (returned - queued) * 1e3,
                           (time.perf_counter() - t0) * 1e3)
        print(f"main path 10 collectives [{card}]: behind a queue of 20 matmuls "
              + "; ".join(f"{k}: the queue enqueued in {q:.3f} ms, the call returned after "
                          f"{c:.3f} ms, all done at {d:.3f} ms" for k, (q, c, d) in waits.items()),
              flush=True)
        del a, x
    finally:
        torch.distributed.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_cudnn
        shutil.rmtree(tmp, ignore_errors=True)

    # g. two NCCL ranks, one a card, every learner
    if torch.cuda.device_count() >= 2:
        start = time.perf_counter()
        outs = dryrun_multichip(2)
        print(f"main path 10g [{card}]: dryrun_multichip(2) over NCCL, the ten learners, in "
              f"{time.perf_counter() - start:.2f} s:\n{''.join(outs)}", flush=True)
    else:
        print(f"main path 10g [{card}]: dryrun_multichip(2) did not run: this machine has "
              f"{torch.cuda.device_count()} card and NCCL puts no two ranks on one GPU; the "
              "two-rank math is held by the CPU gloo tests", flush=True)


class AleStandIn:
    """A stand-in for an ALE emulator, numpy only (the card's machine has no ale_py or
    gymnasium): 210x160x3 u8 frames that move with the frame count and the actions,
    Breakout's action meanings, 5 lives with one lost every 97 frames, a reward schedule,
    and ``np_random`` seeded by ``reset(seed=)`` as gymnasium's envs are. It declares the
    port's spaces."""

    def __init__(self):
        import numpy as np

        from baselines_tpu_torch.envs.spaces import Box, Discrete

        self.observation_space = Box(0, 255, (210, 160, 3), np.uint8)
        self.action_space = Discrete(4)
        self.np_random = np.random.default_rng(0)
        self.ale = self  # lives() below
        self.t = self.x = 0
        self._lives = 5

    @property
    def unwrapped(self):
        return self

    def get_action_meanings(self):
        return ["NOOP", "FIRE", "RIGHT", "LEFT"]

    def lives(self):
        return self._lives

    def _frame(self):
        import numpy as np

        f = np.zeros((210, 160, 3), np.uint8)
        f[:, :, 0] = (np.arange(160) * 3 + self.t) % 256
        f[:, :, 1] = ((np.arange(210) * 5)[:, None] + 7 * self.t) % 256
        y, x = (self.t * 3) % 200, self.x % 150
        f[y:y + 10, x:x + 10, 2] = 255
        return f

    def reset(self, seed=None, **kwargs):
        import numpy as np

        if seed is not None:
            self.np_random = np.random.default_rng(seed)
        self.t, self._lives = 0, 5
        self.x = int(self.np_random.integers(0, 150))
        return self._frame(), {}

    def step(self, action):
        self.t += 1
        self.x += {2: 3, 3: -3}.get(int(action), 0)
        if self.t % 97 == 0:
            self._lives -= 1
        reward = 1.0 if self.t % 7 == 0 else (-1.0 if self.t % 31 == 0 else 0.0)
        return self._frame(), reward, self._lives == 0, False, {}

    def render(self):
        return self._frame()

    def close(self):
        pass


def deepmind_stand_in():
    """make_atari's and wrap_deepmind's chain of the port over AleStandIn."""
    from baselines_tpu_torch.envs.atari import MaxAndSkipEnv, NoopResetEnv, wrap_deepmind

    return wrap_deepmind(MaxAndSkipEnv(NoopResetEnv(AleStandIn(), noop_max=30), skip=4))


def host_side_path(dev, card, kernels, counts, reset_counts, read_counts, recording_output):
    """Main path 11, the host side (phase 16 of the module's docstring): ppo2 with
    cnn_s2d in bf16 on the DeepMind chain over a stand-in emulator, a host env under a
    one-rank NCCL mesh, K1 and K2 at this path's shapes, and the segment tree on the
    card. Adds the path's launch counts to ``counts`` and the kernels' times at its
    shapes to ``kernels``."""
    import importlib.util

    import numpy as np

    from baselines_tpu_torch.algos.ppo.defaults import atari as ppo_atari
    from baselines_tpu_torch.algos.ppo.ppo import learn
    from baselines_tpu_torch.core import logger
    from baselines_tpu_torch.core.rng import Draws
    from baselines_tpu_torch.data.segment_tree import MinSegmentTree, SumSegmentTree
    from baselines_tpu_torch.distributed import param_consistency_check
    from baselines_tpu_torch.envs.atari import atari_vec_env
    from baselines_tpu_torch.envs.callback_env import CallbackVecEnv
    from baselines_tpu_torch.envs.vec import VecMonitor, VecS2D
    from baselines_tpu_torch.nn.networks import NatureCNNS2D
    from baselines_tpu_torch.ops.fused_cnn import (FC_IN, FC_OUT, fused_cnn_forward,
                                                   pack_params, reference_forward)
    from baselines_tpu_torch.ops.gather import take_rows

    TimedOutput = timed_output(recording_output)

    # a. ppo2 with cnn_s2d in bf16 at ppo/defaults.py atari() on the DeepMind chain over
    # the stand-in: 16 envs in worker processes forked after CUDA is up (they touch numpy
    # only), CallbackVecEnv, VecFrameStack(4), VecMonitor, VecS2D(4); 3 updates
    nenv, updates = 16, 3
    hp = ppo_atari()
    nbatch = nenv * hp["nsteps"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by the phases before, not this run's
    recorder = TimedOutput()
    logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
    start = time.perf_counter()
    venv = VecS2D(VecMonitor(atari_vec_env(deepmind_stand_in, nenv, 4, device=dev)), 4)
    try:
        reset_counts()
        model = learn(env=venv, network="cnn_s2d", dtype=torch.bfloat16, seed=0,
                      total_timesteps=updates * nbatch, device=dev, **hp)
        torch.cuda.synchronize()
        counts["host_atari"] = c = read_counts()
        elapsed = time.perf_counter() - start
        logger.reset()
        peak = torch.cuda.max_memory_allocated() - held
        want = {"fused_cnn": updates * (hp["nsteps"] + 1),
                "take_rows": updates * 6 * hp["noptepochs"], "stratified_sample": 0}
        require(c == want, f"ppo2 on the Atari chain launched {c}, expected {want}")
        keys = ("loss/policy_loss", "loss/value_loss", "loss/policy_entropy", "loss/approxkl")
        require(len(recorder.rows) == updates and all(
            math.isfinite(float(r[k])) for r in recorder.rows for k in keys),
            "ppo2 on the Atari chain: a logged loss is missing or not finite")
        require(all(bool(torch.isfinite(p).all()) for p in model.policy.module.parameters()),
                "ppo2 on the Atari chain: params not finite")
        require(tuple(model.state.obs.shape) == (nenv, 21, 21, 64)
                and model.state.obs.dtype == torch.uint8, "the chain's obs are not packed u8")
        steady = 2 * nbatch / (recorder.times[2] - recorder.times[0])
        stats = VecMonitor.get_stats(model.state.env_state)
        # one CallbackVecEnv step of the 16 envs, from and to the card: 50 steps of random
        # actions, 3 rounds, the median
        bridge = venv
        while not isinstance(bridge, CallbackVecEnv):
            bridge = bridge.venv
        _, st = bridge.reset(model.draws)
        acts = torch.randint(0, 4, (50, nenv), device=dev)
        us = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a in acts:
                _, st, _, _, _ = bridge.step(None, st, a)
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t0) / len(acts) * 1e6)
        # where a step's host time goes: one env's chain in this process, 50 steps, and
        # its WarpFrame alone on the same frames (the pool runs 16 such chains in 16
        # worker processes on the machine's cores, then the pipes)
        one = deepmind_stand_in()
        one.reset(seed=0)
        t0 = time.perf_counter()
        for _ in range(50):
            one.step(2)
        chain_us = (time.perf_counter() - t0) / 50 * 1e6
        frame, warp = one.unwrapped.render(), one.env  # ClipRewardEnv -> WarpFrame
        t0 = time.perf_counter()
        for _ in range(50):
            warp._warp(frame)
        warp_us = (time.perf_counter() - t0) / 50 * 1e6
        losses = [round(float(r["loss/policy_loss"]), 5) for r in recorder.rows]
        print(f"main path 11a [{card}]: ppo2 cnn_s2d bf16 at ppo/defaults.py atari() on the "
              f"DeepMind chain (NoopReset 30, MaxAndSkip 4, EpisodicLife, FireReset, the numpy "
              f"WarpFrame, ClipReward) over the stand-in emulator, {nenv} envs in worker "
              f"processes x {hp['nsteps']} steps, {updates} updates, launches {c}; "
              f"{elapsed:.2f} s with set-up = {updates * nbatch / elapsed:.0f} env-steps/s, "
              f"steady over updates 2-3 {steady:.0f} env-steps/s; policy_loss {losses}; "
              f"{int(stats.episodes)} episodes ended (lost lives), eprewmean "
              f"{float(stats.mean_return):.3f}; one CallbackVecEnv step of the {nenv} envs "
              f"{float(np.median(us)):.0f} us (rounds {[round(u) for u in us]}), of which one "
              f"env's chain takes {chain_us:.0f} us in this process (its WarpFrame "
              f"{warp_us:.0f} us) on {os.cpu_count()} cores; peak device memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        del model
    finally:
        logger.reset()
        venv.close()

    # b. ppo2 with mlp on native:CartPole-v1, 8 envs x 64 steps, 2 updates, without and
    # with a one-rank NCCL mesh from the same seed (the pool's reset seed drawn from the
    # replicated draws): the params and observations bit for bit
    kw = dict(env_id="native:CartPole-v1", network="mlp", seed=3, num_envs=8, nsteps=64,
              nminibatches=4, noptepochs=4, total_timesteps=2 * 8 * 64, log_interval=100)
    mesh = join_one_rank_group()
    try:
        reset_counts()
        plain = learn(pipeline=False, device=dev, **kw)
        plain_counts = read_counts()
        reset_counts()
        start = time.perf_counter()
        meshed = learn(mesh=mesh, **kw)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        counts["host_mesh"] = c = read_counts()
        require(c == plain_counts == {"fused_cnn": 0, "take_rows": 2 * 6 * 4,
                                      "stratified_sample": 0},
                f"ppo2 on the native pool launched {c} under the mesh, {plain_counts} without")
        same = all(torch.equal(a, b) for a, b in zip(plain.policy.module.parameters(),
                                                     meshed.policy.module.parameters()))
        require(same and torch.equal(plain.state.obs, meshed.state.obs),
                "ppo2 on the native pool: the mesh run differs from the run without it")
        require(param_consistency_check(list(meshed.policy.module.parameters()), mesh,
                                        atol=0.0), "param_consistency_check failed")
        print(f"main path 11b [{card}]: ppo2 mlp on native:CartPole-v1, 8 envs x 64 steps, 2 "
              f"updates, under a one-rank NCCL mesh and without it from the same seed: params "
              f"and observations bit for bit, param_consistency_check true, launches {c}; "
              f"{elapsed:.2f} s under the mesh with set-up", flush=True)
        del plain, meshed
    finally:
        torch.distributed.destroy_process_group()
    if torch.cuda.device_count() >= 2:
        print(f"main path 11b [{card}]: two NCCL ranks ran ppo2 on native:CartPole-v1 in "
              "phase 15g's dry run (params equal on both ranks); the two ranks against one "
              "process are held by tests/test_torch_mesh_host.py on gloo", flush=True)
    else:
        print(f"main path 11b [{card}]: two NCCL ranks did not run: this machine has "
              f"{torch.cuda.device_count()} card and NCCL puts no two ranks on one GPU; "
              "tests/test_torch_mesh_host.py holds two gloo ranks against one process and "
              "against the JAX package's two-device run", flush=True)

    # c. K1 at the rollout step's batch of 16 and K2 on the epoch shuffle's obs rows,
    # (2048, 21, 21, 64) u8 by a 2048-row permutation, against their plain versions and
    # timed in turns against the library calls
    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randint(0, 256, (nenv, 21, 21, 64), dtype=torch.uint8, device=dev, generator=gen)
    net = NatureCNNS2D(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(16)).to(dev)
    packed = pack_params(net)
    with torch.no_grad():
        got, want = fused_cnn_forward(x, packed), reference_forward(x, packed)
        rows = x.reshape(nenv, -1)
        require(torch.equal(fused_cnn_forward(rows, packed), got),
                "fused_cnn on flat rows differs from the 3-D frames")
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / max(float(want.abs().max()), 1e-9)
        require(rel_err < K1_REL_TOL, f"fused_cnn at B={nenv}: rel err {rel_err:.3g}")
        t, readings = turns_ms({"kernel": lambda: fused_cnn_forward(x, packed),
                                "plain": lambda: reference_forward(x, packed),
                                "library": lambda: net(x)}, 50, rounds=3)
    flops = nenv * 2 * (400 * 32 * 256 + 81 * 64 * 512 + 49 * 64 * 576 + FC_IN * FC_OUT)
    nbytes = x.numel() + sum(p.numel() * p.element_size() for p in packed) + nenv * FC_OUT * 4
    bms, by = bound_ms(flops, nbytes)
    kernels["fused_cnn"]["path11_shapes"] = [dict(
        shape=f"B={nenv}", max_abs_err=abs_err, ms=t["kernel"], plain_ms=t["plain"],
        bound_ms=bms, bound_by=by, library_ms=t["library"])]
    print(f"fused_cnn B={nenv} (the Atari chain's rollout step): max abs err {abs_err:.3g}, "
          f"rel err {rel_err:.3g} (tol {K1_REL_TOL}), flat rows bit for bit the frames'; "
          f"device times: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, cuDNN bf16 "
          f"module {t['library']:.4f} ms, bound {bms:.4f} ms ({by}); in turns: "
          f"{lead(readings, 'kernel', 'library')} [{card}]", flush=True)
    del x, net, packed, got, want, rows
    n = nbatch
    obs = torch.randint(0, 256, (n, 21, 21, 64), dtype=torch.uint8, device=dev, generator=gen)
    idx = torch.randperm(n, device=dev, generator=gen)
    require(torch.equal(take_rows(obs, idx), obs[idx]), "take_rows on the Atari chain's obs "
            "rows differs from x[idx]")
    t, readings = turns_ms({"kernel": lambda: take_rows(obs, idx), "plain": lambda: obs[idx],
                            "index_select": lambda: obs.index_select(0, idx)}, 20, rounds=3)
    bms, by = bound_ms(0, 2 * obs.numel() + idx.numel() * 8)
    shape = f"the Atari chain's obs: u8 ({n}, 21, 21, 64) by ({n},) int64"
    kernels["take_rows"]["path11_shapes"] = [dict(
        shape=shape, max_abs_err=0.0, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bms,
        bound_by=by, library_ms=t["index_select"])]
    print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms, plain "
          f"x[idx] {t['plain']:.4f} ms, index_select {t['index_select']:.4f} ms, bound "
          f"{bms:.4f} ms ({by}), {bms / t['kernel']:.1%} of it; in turns: "
          f"{lead(readings, 'kernel', 'index_select')} [{card}]", flush=True)
    del obs, idx

    # d. the segment trees at 2^20 leaves on the card: 4096 point sets, 64 range sums and
    # minima, 4096 prefix-sum searches, against numpy in f64 on the same values
    cap = 1 << 20
    rng = np.random.RandomState(11)
    sum_tree, min_tree = SumSegmentTree(cap), MinSegmentTree(cap)
    set_idx = rng.choice(cap, 4096, replace=False)
    vals = rng.uniform(0.5, 2.0, 4096).astype(np.float32)
    tidx, tvals = torch.from_numpy(set_idx).to(dev), torch.from_numpy(vals).to(dev)
    s_sum, s_min = sum_tree.init(dev), min_tree.init(dev)
    set_ms = time_ms(lambda: sum_tree.set(s_sum, tidx, tvals), 5)
    s_sum, s_min = sum_tree.set(s_sum, tidx, tvals), min_tree.set(s_min, tidx, tvals)
    leaves = np.zeros(cap, np.float64)
    leaves[set_idx] = vals
    mins = np.full(cap, np.inf)
    mins[set_idx] = vals
    total = float(s_sum.tree[1])
    require(abs(total - leaves.sum()) <= 1e-5 * leaves.sum(), f"the sum tree's root {total}, "
            f"numpy's {leaves.sum()}")
    ranges = [(int(a), int(a) + int(rng.randint(1, cap // 4)))
              for a in rng.randint(0, 3 * cap // 4, 64)]
    worst = 0.0
    for a, b in ranges:
        got_sum, want_sum = float(sum_tree.reduce(s_sum, a, b)), leaves[a:b].sum()
        worst = max(worst, abs(got_sum - want_sum) / max(want_sum, 1e-12))
        require(float(min_tree.reduce(s_min, a, b)) == mins[a:b].min(),
                f"the min tree over [{a}, {b}) differs from numpy's")
    require(worst <= 1e-5, f"a range sum differs from numpy's by {worst:.3g} relative")
    reduce_ms = time_ms(lambda: [sum_tree.reduce(s_sum, a, b) for a, b in ranges], 3) / 64
    q = torch.from_numpy(rng.uniform(0, total, 4096).astype(np.float32)).to(dev)
    found = sum_tree.find_prefixsum_idx(s_sum, q).cpu().numpy()
    find_ms = time_ms(lambda: sum_tree.find_prefixsum_idx(s_sum, q), 10)
    cum = np.concatenate([[0.0], np.cumsum(leaves)])
    qn, tol = q.cpu().numpy().astype(np.float64), 1e-5 * total
    require(bool(np.all((cum[found] <= qn + tol) & (qn < cum[found + 1] + tol))
                 & np.all(leaves[found] > 0)),
            "a prefix-sum search landed outside its leaf (numpy's f64 prefix sums)")
    exact = float(np.mean(found == np.searchsorted(cum, qn, side="right") - 1))
    print(f"main path 11d [{card}]: segment trees at 2^20 leaves on the card: 4096 point "
          f"sets {set_ms:.3f} ms (20 level rebuilds), the root {total:.6f} against numpy's "
          f"f64 {leaves.sum():.6f}, 64 range sums within {worst:.3g} relative and minima "
          f"exact, {reduce_ms:.4f} ms a range; 4096 prefix-sum searches {find_ms:.3f} ms, "
          f"each in its leaf, {exact:.2%} the leaf of numpy's f64 search", flush=True)

    # e. video capture and the logger's tensorboard format, where the machine has cv2 and
    # tensorboard; the retro chain needs retro, which no such machine has had
    from baselines_tpu_torch.algos.common import build_env

    have = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "tensorboard", "retro")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice11_")
    try:
        if have["cv2"]:
            # CartPole-v1 on the card, 4 envs, a video of 8 frames every 16 steps, 40 steps
            video_dir = os.path.join(tmp, "videos")
            venv = build_env("CartPole-v1", 4, device=dev, save_video_interval=16,
                             save_video_length=8, video_dir=video_dir)
            draws = Draws(0, dev)
            _, st = venv.reset(draws)
            start = time.perf_counter()
            for a in torch.randint(0, 2, (40, 4), device=dev):
                _, st, _, _, _ = venv.step(draws, st, a)
            elapsed = time.perf_counter() - start
            venv.close()
            names = sorted(os.listdir(video_dir))
            want_names = [f"video.{t:09d}.mp4" for t in (0, 16, 32)]
            require(names == want_names and all(
                os.path.getsize(os.path.join(video_dir, f)) > 0 for f in names),
                f"the video recorder wrote {names}, expected {want_names}")
            print(f"main path 11e [{card}]: VecVideoRecorder on CartPole-v1 on the card (4 envs "
                  f"tiled, render_frame of each, cv2's mp4 writer): {names} in 40 steps, "
                  f"{elapsed / 40 * 1e3:.2f} ms a step with its frames", flush=True)
        if have["tensorboard"]:
            from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

            fmt = logger.make_output_format("tensorboard", tmp)
            for step in range(3):
                fmt.writekvs({"loss": 0.5 / (step + 1), "fps": 100 * step, "name": "text"})
            fmt.close()
            acc = EventAccumulator(os.path.join(tmp, "tb"))
            acc.Reload()
            got = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
                   for tag in acc.Tags()["scalars"]}
            want_tb = {"loss": [(i + 1, float(np.float32(0.5 / (i + 1)))) for i in range(3)],
                       "fps": [(i + 1, 100.0 * i) for i in range(3)]}
            require(got == want_tb, f"the tensorboard scalars read back {got}")
            print(f"main path 11e [{card}]: the logger's tensorboard format wrote 3 rows, read "
                  f"back as the scalars {sorted(got)} at steps 1-3", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    not_run = ["video capture (needs cv2)"] * (not have["cv2"]) + [
        "the logger's tensorboard format (needs tensorboard)"] * (not have["tensorboard"]) + [
        "the retro chain (needs retro)"] * (not have["retro"])
    if not_run:
        print(f"main path 11 [{card}]: not run on this machine: {', '.join(not_run)}; the CPU "
              "tests hold them against the JAX package", flush=True)


# main path 12's depths, cut from the examples' 100,000 steps so that the phase fits its
# 150 s: on an H100 at 700 W their full runs took 146.7 s (deepq, 682 env-steps/s) and
# 30.5 s (ppo2) with the phase alone, and the host-bound rates halved inside the whole
# script (325 and 1,719 env-steps/s)
TRAIN_CARTPOLE_STEPS = 20_480  # 20 chunks of 1024
CUSTOM_NETWORK_STEPS = 40_960  # 40 updates of 8 x 128


def monitor_rows(stats, elapsed: float) -> list:
    """The episodes that a run's monitor logged, oldest first, as monitor.csv rows: the
    last min(episodes, 100) returns and lengths of its ring; ``t`` is the run's wall time
    when the ring was read (the ring keeps no time an episode)."""
    n_ep = int(stats.episodes)
    ret, length = stats.ret_buffer.cpu().tolist(), stats.len_buffer.cpu().tolist()
    cap = len(ret)
    return [{"r": ret[i % cap], "l": int(length[i % cap]), "t": round(elapsed, 6)}
            for i in range(max(n_ep - cap, 0), n_ep)]


def examples_path(dev, card, kernels, counts, reset_counts, read_counts, recording_output,
                  train_steps: int = TRAIN_CARTPOLE_STEPS,
                  custom_steps: int = CUSTOM_NETWORK_STEPS):
    """Main path 12, the examples and the results tools (phase 17 of the module's
    docstring): train_cartpole's deepq and custom_network's ppo2 through the port's
    ``learn`` at their widths, enjoy_cartpole's load, evaluation and video, K2 at this
    path's two shapes, and the monitor files written, read back and plotted. Adds the
    path's launch counts to ``counts`` and K2's times at its shapes to ``kernels``."""
    import importlib.util

    from baselines_tpu_torch.algos.common import build_env, evaluate
    from baselines_tpu_torch.algos.dqn.dqn import learn as dqn_learn
    from baselines_tpu_torch.algos.ppo.ppo import learn as ppo_learn
    from baselines_tpu_torch.bench import monitor_io
    from baselines_tpu_torch.core import logger
    from baselines_tpu_torch.core.rng import Draws
    from baselines_tpu_torch.envs.registry import make_env
    from baselines_tpu_torch.envs.vec import VecMonitor
    from baselines_tpu_torch.envs.video import record_video
    from baselines_tpu_torch.examples import custom_network, enjoy_cartpole, train_cartpole
    from baselines_tpu_torch.nn import networks
    from baselines_tpu_torch.ops.gather import take_rows

    TimedOutput = timed_output(recording_output)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice12_")
    path_counts = {"fused_cnn": 0, "take_rows": 0, "stratified_sample": 0}
    try:
        # a. train_cartpole's deepq (mlp, 64 hidden, 4 envs, a 50000-row ring) on the card;
        # a chunk is 256 iterations of the 4 envs, and every iteration from step 1000 on
        # trains on 32 rows (5 gathers)
        kw = dict(train_cartpole.LEARN_KWARGS, total_timesteps=train_steps, seed=0,
                  device=dev)
        nchunks = train_steps // 1024
        train_iters = sum(1 for k in range(1, 256 * nchunks + 1) if 4 * k >= 1000)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        recorder, chunk_times = TimedOutput(), []
        logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
        reset_counts()
        start = time.perf_counter()
        model = dqn_learn(chunk_timing=chunk_times, **kw)
        torch.cuda.synchronize()
        elapsed_a = time.perf_counter() - start
        c = read_counts()
        logger.reset()
        peak = torch.cuda.max_memory_allocated() - held
        want = {"fused_cnn": 0, "take_rows": 5 * train_iters, "stratified_sample": 0}
        require(c == want, f"train_cartpole launched {c}, expected {want}")
        for k in c:
            path_counts[k] += c[k]
        stats_a = VecMonitor.get_stats(model.state.env_state)
        require(model.state.t == 1024 * nchunks and len(recorder.rows) == nchunks
                and all(math.isfinite(float(r["mean 100 episode reward"]))
                        for r in recorder.rows), "train_cartpole: a logged row is missing "
                "or its mean reward is not finite")
        require(all(bool(torch.isfinite(p).all()) for p in model.policy.module.parameters()),
                "train_cartpole: params not finite")
        steady = 1024 * (nchunks - 1) / (chunk_times[-1] - chunk_times[0])
        path = os.path.join(tmp, train_cartpole.MODEL_PATH)
        model.save(path)
        cut = "" if train_steps == train_cartpole.LEARN_KWARGS["total_timesteps"] else (
            f" (cut from {train_cartpole.LEARN_KWARGS['total_timesteps']})")
        means = [round(float(r["mean 100 episode reward"]), 1) for r in recorder.rows]
        print(f"main path 12a [{card}]: train_cartpole's deepq (mlp 64, 4 envs, buffer 50000) "
              f"on CartPole-v1, {train_steps} steps{cut}, {train_iters} training iterations, "
              f"launches {c}; {elapsed_a:.2f} s with set-up = {train_steps / elapsed_a:.0f} "
              f"env-steps/s, steady after the first 1024-step chunk {steady:.0f} env-steps/s; "
              f"mean 100 episode reward by chunk {means[::max(1, len(means) // 10)]}, final "
              f"{float(stats_a.mean_return):.2f} over {int(stats_a.episodes)} episodes; "
              f"peak device memory {peak / 2**20:.2f} MiB; saved to "
              f"{os.path.basename(path)} ({os.path.getsize(path)} bytes)", flush=True)

        # b. enjoy_cartpole on that file: load (no training step), evaluate 1000
        # deterministic steps of 4 envs, the same report as the trained model's bit for
        # bit, then the video
        reset_counts()
        start = time.perf_counter()
        loaded = dqn_learn(**dict(enjoy_cartpole.LOAD_KWARGS, load_path=path, device=dev))
        c = read_counts()
        require(c == {"fused_cnn": 0, "take_rows": 0, "stratified_sample": 0} and
                all(torch.equal(a, b) for a, b in zip(model.policy.module.parameters(),
                                                      loaded.policy.module.parameters())),
                f"enjoy_cartpole: the loaded params differ from the saved ones (launches {c})")

        def report(m):
            return evaluate(m, build_env("CartPole-v1", 4, device=dev), Draws(0, dev),
                            nsteps=enjoy_cartpole.EVAL_STEPS)

        got = report(loaded)
        elapsed_b = time.perf_counter() - start
        want_report = report(model)
        require(got == want_report, f"enjoy_cartpole: the loaded model's report {got}, the "
                f"trained model's {want_report}")
        video = os.path.join(tmp, enjoy_cartpole.VIDEO_PATH)
        start = time.perf_counter()
        record_video(loaded, make_env("CartPole-v1"), video,
                     video_length=enjoy_cartpole.VIDEO_LENGTH)
        video_s = time.perf_counter() - start
        require(os.path.getsize(video) > 0, "enjoy_cartpole: the video is empty")
        print(f"main path 12b [{card}]: enjoy_cartpole: loaded and evaluated "
              f"{enjoy_cartpole.EVAL_STEPS} deterministic steps of 4 envs in {elapsed_b:.2f} s: "
              f"mean episode reward {got[0]} (len {got[1]}) over {got[2]} episodes, the "
              f"trained model's report bit for bit; {enjoy_cartpole.VIDEO_LENGTH} frames to "
              f"{os.path.basename(video)} ({os.path.getsize(video)} bytes) in {video_s:.2f} s",
              flush=True)
        del loaded

        # c. custom_network's ppo2 on the registered my_tiny_net (width 64, 8 envs x 128
        # steps, lr 2.5e-3); 24 gathers an update (6 fields x 4 epochs)
        nupdates = custom_steps // 1024
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        recorder = TimedOutput()
        logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
        reset_counts()
        start = time.perf_counter()
        model_c = ppo_learn(**dict(custom_network.LEARN_KWARGS, total_timesteps=custom_steps,
                                   seed=0, log_interval=1, device=dev))
        torch.cuda.synchronize()
        elapsed_c = time.perf_counter() - start
        c = read_counts()
        logger.reset()
        peak = torch.cuda.max_memory_allocated() - held
        want = {"fused_cnn": 0, "take_rows": 24 * nupdates, "stratified_sample": 0}
        require(c == want, f"custom_network launched {c}, expected {want}")
        for k in c:
            path_counts[k] += c[k]
        keys = ("loss/policy_loss", "loss/value_loss", "loss/policy_entropy", "loss/approxkl")
        require(len(recorder.rows) == nupdates and all(
            math.isfinite(float(r[k])) for r in recorder.rows for k in keys),
            "custom_network: a logged loss is missing or not finite")
        require(isinstance(model_c.policy.module.network, custom_network.MyTinyNet) and all(
            bool(torch.isfinite(p).all()) for p in model_c.policy.module.parameters()),
            "custom_network: the policy is not my_tiny_net or its params are not finite")
        steady_c = 1024 * (nupdates - 1) / (recorder.times[-1] - recorder.times[0])
        stats_c = VecMonitor.get_stats(model_c.state.env_state)
        try:
            networks.register("my_tiny_net")(custom_network.MyTinyNet)
            duplicate = None
        except ValueError as e:
            duplicate = str(e)
        require(duplicate == "duplicate network registration: 'my_tiny_net'",
                f"a second my_tiny_net registration gave {duplicate!r}")
        cut = "" if custom_steps == custom_network.LEARN_KWARGS["total_timesteps"] else (
            f" (cut from {custom_network.LEARN_KWARGS['total_timesteps']})")
        eprew = [round(float(r["eprewmean"]), 1) for r in recorder.rows]
        print(f"main path 12c [{card}]: custom_network's ppo2 on my_tiny_net (width 64, 8 envs "
              f"x 128 steps, lr 2.5e-3) on CartPole-v1, {nupdates} updates = {custom_steps} "
              f"steps{cut}, launches {c}; {elapsed_c:.2f} s with set-up = "
              f"{custom_steps / elapsed_c:.0f} env-steps/s, steady after the first update "
              f"{steady_c:.0f} env-steps/s; finite losses (last policy_loss "
              f"{float(recorder.rows[-1]['loss/policy_loss']):.5f}); eprewmean by update "
              f"{eprew[::max(1, len(eprew) // 10)]}, final {float(stats_c.mean_return):.2f} "
              f"over {int(stats_c.episodes)} episodes; peak device memory "
              f"{peak / 2**20:.2f} MiB; a second my_tiny_net registration raised "
              f"ValueError", flush=True)
        counts["path12"] = path_counts

        # d. K2 at this path's two shapes, against x[idx] and timed in turns against
        # index_select: deepq's replay sample, 32 rows of the (50000, 4) f32 ring, and
        # ppo2's epoch shuffle, (1024, 4) f32 obs by a 1024-row permutation
        gen = torch.Generator(device=dev).manual_seed(17)
        shapes = []
        for what, rows, idx in (
                ("train_cartpole's replay sample", 50000,
                 torch.randint(0, 50000, (32,), device=dev, generator=gen)),
                ("custom_network's epoch shuffle", 1024,
                 torch.randperm(1024, device=dev, generator=gen))):
            x = torch.randn((rows, 4), device=dev, generator=gen)
            require(torch.equal(take_rows(x, idx), x[idx]), f"take_rows on {what} differs")
            t, readings = turns_ms({"kernel": lambda: take_rows(x, idx),
                                    "plain": lambda: x[idx],
                                    "index_select": lambda: x.index_select(0, idx)}, 50,
                                   rounds=3)
            n = idx.numel()
            bms, by = bound_ms(0, 2 * n * 16 + n * 8)
            shape = f"{what}: f32 {tuple(x.shape)} by ({n},) int64"
            shapes.append(dict(shape=shape, max_abs_err=0.0, ms=t["kernel"],
                               plain_ms=t["plain"], bound_ms=bms, bound_by=by,
                               library_ms=t["index_select"]))
            print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms, "
                  f"plain x[idx] {t['plain']:.4f} ms, index_select {t['index_select']:.4f} "
                  f"ms, bound {bms:.7f} ms ({by}); in turns: "
                  f"{lead(readings, 'kernel', 'index_select')} [{card}]", flush=True)
        kernels["take_rows"]["path12_shapes"] = shapes

        # e. one monitor.csv a run from the episodes its monitor logged, read back by both
        # loaders and drawn by both plotters where the machine has pandas and matplotlib
        # (host-side plotting libraries: no device work depends on them)
        runs = {"deepq-CartPole-0": (stats_a, elapsed_a), "ppo2-CartPole-0": (stats_c,
                                                                               elapsed_c)}
        dirs, written = [], []
        for run, (stats, elapsed) in runs.items():
            d = os.path.join(tmp, "results", run)
            os.makedirs(d)
            writer = monitor_io.ResultsWriter(os.path.join(d, "0"), header={
                "t_start": 0.0, "env_id": "CartPole-v1"})
            rows = monitor_rows(stats, elapsed)
            for row in rows:
                writer.write_row(row)
            writer.close()
            with open(writer.f.name) as f:
                lines = f.read().splitlines()
            require(len(rows) == min(int(stats.episodes), 100) and len(lines) == len(rows) + 2
                    and lines[1] == "r,l,t", f"{run}'s monitor.csv has {len(lines)} lines")
            dirs.append(d)
            written.append(f"{run} ({len(rows)} episodes)")
        print(f"main path 12e [{card}]: monitor.csv written by ResultsWriter for "
              f"{', '.join(written)}", flush=True)
        have = {m: importlib.util.find_spec(m) is not None for m in ("pandas", "matplotlib")}
        if have["pandas"]:
            from baselines_tpu_torch.bench import plot_util

            frames = [monitor_io.load_results(d) for d in dirs]
            results = sorted(plot_util.load_results(os.path.join(tmp, "results")),
                             key=lambda r: r.dirname)
            require([r.dirname for r in results] == dirs and all(
                f.equals(r.monitor) for f, r in zip(frames, results)) and [
                list(f["r"]) for f in frames] == [[row["r"] for row in monitor_rows(
                    stats, elapsed)] for stats, elapsed in runs.values()],
                "the monitor files read back other rows, or the two loaders differ")
            print(f"main path 12e [{card}]: read back by monitor_io.load_results and "
                  f"plot_util.load_results, the same frames ({[len(f) for f in frames]} "
                  "rows, the returns written)", flush=True)
        if all(have.values()):
            import matplotlib.pyplot as plt

            from baselines_tpu_torch.bench import results_plotter

            fig, axarr = plot_util.plot_results(results)
            fig.savefig(os.path.join(tmp, "plot_util.png"))
            plt.close(fig)
            results_plotter.plot_results(dirs, 10 ** 9, results_plotter.X_TIMESTEPS,
                                         "CartPole-v1")
            plt.savefig(os.path.join(tmp, "results_plotter.png"))
            plt.close("all")
            sizes = [os.path.getsize(os.path.join(tmp, f))
                     for f in ("plot_util.png", "results_plotter.png")]
            require(all(n > 0 for n in sizes), "a plot is empty")
            print(f"main path 12e [{card}]: plot_util.plot_results ({axarr.shape} axes) and "
                  f"results_plotter.plot_results drawn to PNG ({sizes} bytes)", flush=True)
        else:
            missing = [m for m, ok in have.items() if not ok]
            what = ("reading the monitor files back and plotting them" if not have["pandas"]
                    else "plotting the monitor files")
            print(f"main path 12e [{card}]: not run on this machine: {what} (needs "
                  f"{' and '.join(missing)}, a host-side library); the CPU tests hold bench/ "
                  "against the JAX package", flush=True)
    finally:
        logger.reset()
        shutil.rmtree(tmp, ignore_errors=True)


def api_surface_path(dev, card, kernels, counts, reset_counts, read_counts,
                     recording_output):
    """Main path 13, the API surface (phase 18 of the module's docstring): gail from an
    ExpertDataset the caller built with no device argument, a policy on MultiBinary
    observations on the card against the CPU, and the spaces' samples, ``discount``,
    ``affine_reverse_scan`` and ``logger.profile_kv`` on the card. Adds the path's launch
    counts to ``counts`` and K2's times at the expert sample's shape to ``kernels``."""
    import numpy as np

    from baselines_tpu_torch.algos.gail.dataset import ExpertDataset
    from baselines_tpu_torch.algos.gail.gail import learn as gail_learn
    from baselines_tpu_torch.core import logger
    from baselines_tpu_torch.core.math import discount
    from baselines_tpu_torch.core.rng import Draws
    from baselines_tpu_torch.data.gae import affine_reverse_scan
    from baselines_tpu_torch.envs import spaces
    from baselines_tpu_torch.nn.policy import build_policy
    from baselines_tpu_torch.ops.gather import take_rows

    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice13_")
    try:
        # a. gail from a dataset the caller built from an expert .npz, neither the
        # dataset nor learn given a device: both on the card
        expert = np.random.RandomState(0).uniform(-1, 1, size=(1, 5000, 1)).astype(np.float32)
        path = os.path.join(tmp, "expert.npz")
        np.savez(path, obs=expert, acs=expert.copy())
        dataset = ExpertDataset(expert_path=path)
        require(dataset.n == 5000 and dataset.obs.device.type == dataset.acs.device.type
                == "cuda", f"ExpertDataset with no device put its rows on "
                f"{dataset.obs.device}, expected the card")
        iters = 2
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        start = time.perf_counter()
        model = gail_learn(env_id="BoxIdentity-v0", expert_dataset=dataset, seed=0,
                           num_envs=8, timesteps_per_batch=512, gamma=0.9, lam=0.97,
                           max_kl=0.01, g_step=1, d_step=3, total_timesteps=iters * 512,
                           log_interval=0)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        c = read_counts()
        peak = torch.cuda.max_memory_allocated() - held
        want = {"fused_cnn": 0, "take_rows": iters * (5 * 2 + 2), "stratified_sample": 0}
        require(c == want, f"gail from a caller's ExpertDataset launched {c}, expected {want}")
        require(model.state.iters == iters and model.device.type == "cuda" and all(
            bool(torch.isfinite(p).all()) for p in model.params.values()),
            f"gail: {model.state.iters} iterations on {model.device}, or params not finite")
        path_counts = dict(c)
        print(f"main path 13a [{card}]: gail mlp on BoxIdentity-v0 from a caller's "
              f"ExpertDataset (5000 rows, no device argument, on {dataset.obs.device}), "
              f"{iters} iterations of 8 x 64, launches {c}; {elapsed:.2f} s with set-up = "
              f"{iters * 512 / elapsed:.0f} env-steps/s; peak device memory "
              f"{peak / 2**20:.2f} MiB", flush=True)

        # K2 at the expert sample's shape: 512 rows of the (5000, 1) f32 table
        gen = torch.Generator(device=dev).manual_seed(18)
        x = dataset.obs
        idx = torch.randint(0, 5000, (512,), device=dev, generator=gen)
        require(torch.equal(take_rows(x, idx), x[idx]), "take_rows on the expert rows differs")
        t, readings = turns_ms({"kernel": lambda: take_rows(x, idx), "plain": lambda: x[idx],
                                "index_select": lambda: x.index_select(0, idx)}, 50,
                               rounds=3)
        bms, by = bound_ms(0, 2 * 512 * 4 + 512 * 8)
        shape = (f"gail's expert sample from a caller's dataset: f32 {tuple(x.shape)} by "
                 "(512,) int64")
        kernels["take_rows"]["path13_shapes"] = [dict(
            shape=shape, max_abs_err=0.0, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bms,
            bound_by=by, library_ms=t["index_select"])]
        print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms, "
              f"plain x[idx] {t['plain']:.4f} ms, index_select {t['index_select']:.4f} ms, "
              f"bound {bms:.6f} ms ({by}); in turns: "
              f"{lead(readings, 'kernel', 'index_select')} [{card}]", flush=True)

        # b. mlp on MultiBinary(16) observations, the same params on the card and the CPU
        ob_space, ac_space = spaces.MultiBinary(16), spaces.Discrete(4)
        pols = {d: build_policy(ob_space, ac_space, "mlp", device=d,
                                generator=torch.Generator().manual_seed(0))
                for d in ("cpu", dev)}
        require(all(torch.equal(a.cpu(), b) for a, b in zip(
            pols[dev].module.parameters(), pols["cpu"].module.parameters())),
            "the two MultiBinary policies were built with other params")
        obs = torch.randint(0, 2, (256, 16), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
        start = time.perf_counter()
        action, value, neglogp = pols[dev].step(obs.to(dev), Draws(0, dev))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - start) * 1e3
        with torch.no_grad():
            pdflat_d, vf_d, _ = pols[dev].module(obs.to(dev))
            pdflat_c, vf_c, _ = pols["cpu"].module(obs)
        neglogp_c = pols["cpu"].pdtype.pdfromflat(pdflat_c).neglogp(action.cpu())
        errs = {"logits": rel(pdflat_d.cpu(), pdflat_c), "value": rel(vf_d.cpu(), vf_c),
                "step value": rel(value.cpu(), vf_c), "neglogp": rel(neglogp.cpu(), neglogp_c)}
        require(action.shape == (256,) and action.device.type == "cuda"
                and max(errs.values()) < 1e-5,
                f"the MultiBinary policy on the card against the CPU: {errs}")
        print(f"main path 13b [{card}]: mlp on MultiBinary(16) observations, Discrete(4) "
              f"actions, a policy step at batch 256 in {step_ms:.2f} ms (the first, eager); "
              "relative errors against the CPU "
              f"{', '.join(f'{k} {v:.2g}' for k, v in errs.items())} (tol 1e-5)", flush=True)

        # c. the spaces' samples, discount, affine_reverse_scan and profile_kv on the card
        draws = Draws(0, dev)
        space_list = {
            "Discrete(5)": spaces.Discrete(5),
            "Box(-1, 1, (3,))": spaces.Box(-1.0, 1.0, (3,)),
            "Box(0, 255, (2, 3), u8)": spaces.Box(0, 255, (2, 3), np.uint8),
            "Box(-inf, inf, (4,))": spaces.Box(-np.inf, np.inf, (4,)),
            "MultiDiscrete([3, 7, 2])": spaces.MultiDiscrete([3, 7, 2]),
            "MultiBinary(16)": spaces.MultiBinary(16),
            "DictSpace": spaces.DictSpace({"observation": spaces.Box(-1.0, 1.0, (2,)),
                                           "desired_goal": spaces.MultiBinary(2)})}
        start = time.perf_counter()
        for name, space in space_list.items():
            samples = [space.sample(draws) for _ in range(10000)]
            first = samples[0] if not isinstance(space, spaces.DictSpace) else \
                samples[0]["desired_goal"]
            require(first.device.type == "cuda", f"{name}.sample gave a tensor on "
                    f"{first.device}")
            if isinstance(space, spaces.DictSpace):
                keys = list(samples[0])
                host = {k: torch.stack([s[k] for s in samples]).cpu() for k in keys}
                rows = [{k: host[k][i] for k in keys} for i in range(len(samples))]
                require(keys == sorted(space.spaces), f"DictSpace's keys {keys}")
            else:
                rows = list(torch.stack(samples).cpu())
            require(all(space.contains(r) for r in rows), f"a sample of {name} is outside it")
        spaces_s = time.perf_counter() - start
        gen = torch.Generator().manual_seed(2)
        xs = torch.rand((128, 1024), generator=gen)
        coefs = torch.rand((128, 1024), generator=gen) * 0.99
        init = torch.rand((1024,), generator=gen)
        got = {"discount": discount(xs.to(dev), 0.99).cpu(),
               "affine_reverse_scan": affine_reverse_scan(coefs.to(dev), xs.to(dev),
                                                          init.to(dev)).cpu()}
        want = {"discount": discount(xs, 0.99),
                "affine_reverse_scan": affine_reverse_scan(coefs, xs, init)}
        scan_errs = {k: rel(got[k], want[k]) for k in got}
        require(max(scan_errs.values()) < 1e-6, f"the scans on the card against the CPU: "
                f"{scan_errs}")
        recorder = recording_output()
        logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
        reset_counts()
        with logger.profile_kv("take_rows"):
            take_rows(x, idx)
            torch.cuda.synchronize()
        c = read_counts()
        row = logger.dumpkvs()
        logger.reset()
        require(c["take_rows"] == 1 and row.get("wait_take_rows", -1) > 0
                and recorder.rows == [row], f"profile_kv around one gather: launches {c}, "
                f"row {row}")
        path_counts["take_rows"] += c["take_rows"]
        counts["path13"] = path_counts
        print(f"main path 13c [{card}]: 10000 samples of each of {len(space_list)} spaces on "
              f"the card, each in its space, in {spaces_s:.2f} s; discount and "
              f"affine_reverse_scan at (128, 1024) f32 against the CPU, relative errors "
              f"{', '.join(f'{k} {v:.2g}' for k, v in scan_errs.items())} (bit for bit: "
              f"{all(torch.equal(got[k], want[k]) for k in got)}); profile_kv around one "
              f"gather wrote wait_take_rows = {row['wait_take_rows'] * 1e3:.3f} ms", flush=True)
    finally:
        logger.reset()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    with Phase("device"):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
                  file=sys.stderr)
            return 1
        from baselines_tpu_torch.algos.dqn import dqn
        from baselines_tpu_torch.algos.dqn.defaults import atari as dqn_atari_defaults
        from baselines_tpu_torch import run as cli
        from baselines_tpu_torch.algos.dqn.dqn import td_loss
        from baselines_tpu_torch.algos.common import build_env, evaluate, run_rollout
        from baselines_tpu_torch.algos.a2c import a2c
        from baselines_tpu_torch.algos.ppo.ppo import learn
        from baselines_tpu_torch.distributed import param_consistency_check
        from baselines_tpu_torch.distributed.collectives import all_gather_rows, psum
        from baselines_tpu_torch.distributed.dryrun import dryrun_multichip
        from baselines_tpu_torch.core import logger
        from baselines_tpu_torch.core.rng import Draws
        from baselines_tpu_torch.envs.testing.fixed_sequence import FixedSequenceEnv
        from baselines_tpu_torch.envs.vec import VecMonitor, VecTorchEnv
        from baselines_tpu_torch.nn.policy import build_policy
        from baselines_tpu_torch.nn.networks import NatureCNNS2D
        from baselines_tpu_torch.ops import cuda_lib
        from baselines_tpu_torch.ops import stratified_sample as ss
        from baselines_tpu_torch.ops.fused_cnn import (
            FC_IN, FC_OUT, conv_stage, dense_stage, fused_cnn_forward, pack_params,
            reference_forward,
        )
        from baselines_tpu_torch.ops.gather import take_rows

        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        card = smi.stdout.strip().splitlines()[0]
        print(f"device: {kind}, count {count}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
        print(card, flush=True)
    dev = torch.device("cuda")

    class RecordingOutput(logger.KVWriter):
        """A logger output that keeps every dumped row."""

        def __init__(self):
            self.rows = []

        def writekvs(self, kvs):
            self.rows.append(dict(kvs))

    # the plain versions' f32 convolutions and products see only bf16 operands, which
    # TF32 holds exactly; full f32 is set all the same
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with Phase("build"):
        report = cuda_lib.build()
        cuda_lib.library()
        print(f"build: {report['seconds']:.2f} s -> {report['path']}")
        for line in report["ptxas"]:
            print(f"  {line}")

    kernels = {}
    launchers = {"fused_cnn": fused_cnn_forward, "take_rows": take_rows,
                 "stratified_sample": ss.stratified_sample}
    counts = {}  # main path -> kernel -> launches

    def reset_counts():
        for fn in launchers.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in launchers.items()}

    with Phase("fused_cnn vs plain"):
        # deepq's act step (64), ppo2's rollout (256) and minibatch (8192), and batches
        # that end in a partial 64-sample tile; the dense stage splits its depth 8 ways
        # up to 512 samples, 4 ways at 600, 2 ways at 1029 and not at 8192
        for batch in (64, 65, 100, 256, 257, 600, 1029, 8192):
            gen = torch.Generator(device=dev).manual_seed(batch)
            x = torch.randint(0, 256, (batch, 21, 21, 64), dtype=torch.uint8, device=dev,
                              generator=gen)
            net = NatureCNNS2D(dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(batch)).to(dev)
            packed = pack_params(net)
            got = fused_cnn_forward(x, packed)
            want = reference_forward(x, packed)
            torch.cuda.synchronize()
            require(got.shape == (batch, FC_OUT) and bool(torch.isfinite(got).all()),
                    "fused_cnn: output has the wrong shape or is not finite")
            abs_err = float((got - want).abs().max())
            rel_err = abs_err / max(float(want.abs().max()), 1e-9)
            active = float((want > 0).float().mean())
            require(active > 0.1, f"fused_cnn: degenerate test, {active:.3f} of latents active")
            require(rel_err < K1_REL_TOL, f"fused_cnn at B={batch}: rel err {rel_err:.3g}")
            require(torch.equal(fused_cnn_forward(x, packed), got),
                    f"fused_cnn at B={batch}: a second call gave other bits")
            if batch not in (64, 256, 8192):
                print(f"fused_cnn B={batch}: max abs err {abs_err:.3g}, rel err {rel_err:.3g} "
                      f"(tol {K1_REL_TOL})", flush=True)
                del x, net, packed, got, want
                continue
            iters = 50 if batch <= 256 else 10
            # device times from CUDA graphs, in turns: at small batch a call takes less
            # device time than the host spends issuing it; the eager times are the calls
            # as the path makes them
            # the op's two launches apart, on buffers made once
            a3 = torch.empty((batch, FC_IN), dtype=torch.bfloat16, device=dev)
            latent = torch.empty((batch, FC_OUT), dtype=torch.float32, device=dev)
            with torch.no_grad():
                t, _ = turns_ms({"kernel": lambda: fused_cnn_forward(x, packed),
                              "conv": lambda: conv_stage(x, packed, a3),
                              "dense": lambda: dense_stage(a3, packed, latent),
                              "plain": lambda: reference_forward(x, packed),
                              "library": lambda: net(x)}, iters)
                library_eager_ms = time_ms(lambda: net(x), iters)
            ms, conv_ms, dense_ms, plain_ms, library_ms = (
                t[k] for k in ("kernel", "conv", "dense", "plain", "library"))
            eager_ms = time_ms(lambda: fused_cnn_forward(x, packed), iters)
            flops = batch * 2 * (400 * 32 * 256 + 81 * 64 * 512 + 49 * 64 * 576 + FC_IN * FC_OUT)
            nbytes = x.numel() + sum(p.numel() * p.element_size() for p in packed) + got.numel() * 4
            bms, by = bound_ms(flops, nbytes)
            conv_flops = batch * 2 * (400 * 32 * 256 + 81 * 64 * 512 + 49 * 64 * 576)
            conv_bytes = x.numel() + sum(p.numel() * p.element_size() for p in packed[:6]) \
                + batch * FC_IN * 2
            dense_bytes = batch * FC_IN * 2 + packed[6].numel() * 2 + FC_OUT * 4 + got.numel() * 4
            conv_bms, conv_by = bound_ms(conv_flops, conv_bytes)
            dense_bms, dense_by = bound_ms(batch * 2 * FC_IN * FC_OUT, dense_bytes)
            print(f"fused_cnn B={batch}: max abs err {abs_err:.3g}, rel err {rel_err:.3g} "
                  f"(tol {K1_REL_TOL}); device times: kernel {ms:.4f} ms (conv stage "
                  f"{conv_ms:.4f}, bound {conv_bms:.4f} {conv_by}; dense stage {dense_ms:.4f}, "
                  f"bound {dense_bms:.4f} {dense_by}), plain {plain_ms:.4f} ms, cuDNN bf16 "
                  f"module {library_ms:.4f} ms, bound {bms:.4f} ms ({by}); eager calls: kernel "
                  f"{eager_ms:.4f} ms, cuDNN bf16 module {library_eager_ms:.4f} ms [{card}]",
                  flush=True)
            if batch == 256:  # ppo2's rollout step
                kernels["fused_cnn"] = dict(
                    name="fused_cnn_forward", route="cuda",
                    source="baselines_tpu_torch/csrc/fused_cnn.cu",
                    replaces="baselines_tpu/ops/fused_cnn.py:145", shape=f"B={batch}",
                    max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=library_ms,
                )
            del x, net, packed, got, want, a3, latent

    with Phase("take_rows vs x[idx]"):
        n = 32768
        gen = torch.Generator(device=dev).manual_seed(1)
        obs = torch.randint(0, 256, (n, 21, 21, 64), dtype=torch.uint8, device=dev,
                            generator=gen)
        idx = torch.randint(0, n, (n,), device=dev, generator=gen)  # with duplicates
        field = torch.randn((n,), device=dev, generator=gen)
        require(int(idx.unique().numel()) < n, "take_rows: the test index has no duplicates")
        got = take_rows(obs, idx)
        require(torch.equal(got, obs[idx]), "take_rows: obs rows differ from x[idx]")
        require(torch.equal(take_rows(field, idx), field[idx]),
                "take_rows: f32 field differs from x[idx]")
        for ragged in (obs.view(n, -1)[:, 1:].contiguous(), field.view(-1, 8)):
            require(torch.equal(take_rows(ragged, idx[: ragged.shape[0]] % ragged.shape[0]),
                                ragged[idx[: ragged.shape[0]] % ragged.shape[0]]),
                    f"take_rows: rows of shape {tuple(ragged.shape[1:])} differ from x[idx]")
        # an index outside [0, N) gives a row of zeros
        rows = take_rows(obs, torch.tensor([3, -1, n, 5], device=dev))
        require(torch.equal(rows[0], obs[3]) and torch.equal(rows[3], obs[5])
                and not rows[1:3].any(), "take_rows: out-of-range rows not zero")
        abs_err = float((got.float() - obs[idx].float()).abs().max())
        # device times from CUDA graphs in three rounds of turns, beside the eager calls'
        # CUDA-event times: the kernel and index_select differ by a few percent here
        t, readings = turns_ms({"kernel": lambda: take_rows(obs, idx),
                      "plain": lambda: obs[idx],
                      "index_select": lambda: torch.index_select(obs, 0, idx)}, 5, reps=4,
                               rounds=3)
        ms, plain_ms, library_ms = (t[k] for k in ("kernel", "plain", "index_select"))
        eager_ms = time_ms(lambda: take_rows(obs, idx), 20)
        eager_library_ms = time_ms(lambda: torch.index_select(obs, 0, idx), 20)
        nbytes = 2 * obs.numel() + idx.numel() * 8
        bms, by = bound_ms(0, nbytes)
        field_ms = graph_ms(lambda: take_rows(field, idx), 50)
        print(f"take_rows obs (32768, 21, 21, 64) u8: bit-exact; device times: "
              f"kernel {ms:.4f} ms ({bms / ms:.1%} of the bound), plain x[idx] "
              f"{plain_ms:.4f} ms, index_select {library_ms:.4f} ms, bound {bms:.4f} ms ({by}); "
              f"in turns: {lead(readings, 'kernel', 'index_select')}; "
              f"eager calls: kernel {eager_ms:.4f} ms, index_select {eager_library_ms:.4f} ms; "
              f"f32 (32768,) field: bit-exact, kernel {field_ms:.4f} ms [{card}]", flush=True)
        kernels["take_rows"] = dict(
            name="take_rows", route="cuda", source="baselines_tpu_torch/csrc/gather.cu",
            replaces="baselines_tpu/ops/gather.py:67", shape="obs (32768, 21, 21, 64) u8",
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=library_ms,
        )
        # the deepq replay sample: 256 rows of the 10000-slot ring, obs and an f32 field
        ring, ring_field = obs[:10000], field[:10000]
        ridx = torch.randint(0, 10000, (256,), device=dev, generator=gen)
        require(torch.equal(take_rows(ring, ridx), ring[ridx])
                and torch.equal(take_rows(ring_field, ridx), ring_field[ridx]),
                "take_rows: the replay sample differs from x[idx]")
        t, ring_readings = turns_ms({"kernel": lambda: take_rows(ring, ridx),
                      "index_select": lambda: ring.index_select(0, ridx)}, 50, rounds=3)
        ring_ms, ring_plain_ms = t["kernel"], t["index_select"]
        ring_field_ms = graph_ms(lambda: take_rows(ring_field, ridx), 50)
        ring_bms, _ = bound_ms(0, 2 * 256 * ring[0].numel() + 256 * 8)
        print(f"take_rows replay sample (10000, 21, 21, 64) u8 by 256: bit-exact; device "
              f"times: kernel {ring_ms:.4f} ms, index_select {ring_plain_ms:.4f} ms, "
              f"in turns: {lead(ring_readings, 'kernel', 'index_select')}, "
              f"bound {ring_bms:.4f} ms (bytes); f32 field {ring_field_ms:.4f} ms [{card}]",
              flush=True)
        del obs, idx, field, got, ring, ring_field

    with Phase("stratified_sample vs plain"):
        def integer_priorities(gen, n, block_total=4096):
            """Priorities in {0, 1, 2, 3} with runs of zeros and a last slot in each
            block that brings the block's sum to block_total: every sum is exact, and
            zero uniforms put the targets on block and slot boundaries."""
            p = torch.randint(0, 4, (n // ss.BLOCK, ss.BLOCK), generator=gen, device=dev)
            p = p.float()
            p[:, 100:300] = 0.0
            p[:, -1] = 0.0
            p[:, -1] = block_total - p.sum(dim=1)
            require(bool((p >= 0).all()), "stratified_sample: a negative test priority")
            return p.reshape(-1).contiguous()

        def check_sampler(n, batch, gen):
            """Bit for bit against the plain version on integer priorities, zero and
            random uniforms, block sums included; on |randn| the largest slot difference
            and the count of differing indices, which must be <= 2 and < 5 %."""
            ints = integer_priorities(gen, n)
            for u in (torch.zeros(batch, device=dev),
                      torch.rand(batch, generator=gen, device=dev)):
                got, sums = ss.stratified_sample(ints, u, batch, return_block_sums=True)
                torch.cuda.synchronize()
                require(got.dtype == torch.int32 and got.shape == (batch,),
                        "stratified_sample: wrong output type or shape")
                require(torch.equal(sums, ss.plain_block_sums(ints)),
                        f"stratified_sample at N={n}: block sums not bit-exact on integer "
                        "priorities")
                require(torch.equal(got, ss.plain_stratified_sample(ints, u, batch)),
                        f"stratified_sample at N={n}, B={batch}: not bit-exact on integer "
                        "priorities")
            prios = torch.randn(n, generator=gen, device=dev).abs()
            u = torch.rand(batch, generator=gen, device=dev)
            got, sums = ss.stratified_sample(prios, u, batch, return_block_sums=True)
            got = got.long()
            want = ss.plain_stratified_sample(prios, u, batch).long()
            max_slots = int((got - want).abs().max())
            n_diff = int((got != want).sum())
            require(max_slots <= 2 and n_diff < 0.05 * batch,
                    f"stratified_sample at N={n}, B={batch}: {n_diff} indices differ, by up "
                    f"to {max_slots} slots")
            sums_err = float((sums - ss.plain_block_sums(prios)).abs().max())
            return prios, u, got, max_slots, n_diff, sums_err

        # where the cluster's share of the blocks changes (1 to 17 blocks, and a million
        # slots streamed from device memory) and where the targets fill part of a warp,
        # a warp, more than one and several in turn
        edges = [(nb, b) for nb in (1, 5, 8, 9, 16, 17, 512) for b in (1, 31, 256, 257, 1024)]
        worst = 0
        for nblocks, batch in edges:
            gen = torch.Generator(device=dev).manual_seed(nblocks * 10007 + batch)
            worst = max(worst, check_sampler(nblocks * ss.BLOCK, batch, gen)[3])
        print(f"stratified_sample edges: {len(edges)} shapes (blocks 1, 5, 8, 9, 16, 17, 512 "
              f"x targets 1, 31, 256, 257, 1024) bit-exact on integer priorities, |randn| "
              f"within {worst} slots [{card}]", flush=True)

        floor_x = torch.zeros(1, device=dev)
        for n, batch in ((2 ** 20, 32), (2 ** 20, 256), (10240, 256)):
            gen = torch.Generator(device=dev).manual_seed(n + batch)
            prios, u, got, max_slots, n_diff, sums_err = check_sampler(n, batch, gen)
            heavy = torch.full((n,), 1e-3, device=dev)
            heavy[7] = n * 1e-3  # about half the total mass
            hits = sum(int((ss.stratified_sample(heavy, torch.rand(batch, generator=gen,
                                                                   device=dev), batch) == 7).sum())
                       for _ in range(20))
            frac, expect = hits / (20 * batch), float(heavy[7] / heavy.sum())
            require(abs(frac - expect) < 0.05, f"stratified_sample: slot 7 drawn {frac:.3f} "
                    f"of the time, expected {expect:.3f}")

            total = torch.cumsum(ss.plain_block_sums(prios).double(), 0)[-1].float()
            targets = ss.stratified_targets(total.view(1), u, batch)
            # device times from CUDA graphs, in three rounds of turns: the op, the library's
            # cumsum + searchsorted, and the launch floor, a one-element add timed the same
            # way, which no kernel launched here can beat; the eager call is host time
            t, readings = turns_ms({
                "kernel": lambda: ss.stratified_sample(prios, u, batch),
                "cumsum+searchsorted": lambda: torch.searchsorted(
                    torch.cumsum(prios, 0), targets, right=True),
                "floor": lambda: floor_x.add_(1)}, 50, rounds=3)
            ms, library_ms, floor_ms = (t[k] for k in ("kernel", "cumsum+searchsorted", "floor"))
            plain_ms = graph_ms(lambda: ss.plain_stratified_sample(prios, u, batch), 10)
            eager_ms = time_ms(lambda: ss.stratified_sample(prios, u, batch), 200)
            # bytes the op must move: every priority and uniform read once, every index
            # written once
            bms, by = bound_ms(0, 4 * n + 8 * batch)
            print(f"launch floor (one-element add_, graph_ms, in turns with the sampler at "
                  f"N={n}, B={batch}): {floor_ms:.4f} ms [{card}]", flush=True)
            print(f"stratified_sample N={n} B={batch} [{card}]: integer priorities bit-exact "
                  f"(zero and random uniforms, block sums); |randn|: {n_diff} of {batch} "
                  f"indices differ from plain (max {max_slots} slots), block sums max abs err "
                  f"{sums_err:.3g}; heavy slot {frac:.4f} vs {expect:.4f}; device times: one "
                  f"launch {ms:.4f} ms, cumsum+searchsorted {library_ms:.4f}, launch floor "
                  f"{floor_ms:.4f}, plain {plain_ms:.4f}, bound {bms:.6f} ({by}); in turns: "
                  f"{lead(readings, 'kernel', 'cumsum+searchsorted')}; eager call "
                  f"{eager_ms:.4f} ms", flush=True)
            if n == 10240:  # the deepq path's padded buffer and batch
                kernels["stratified_sample"] = dict(
                    name="stratified_sample", route="cuda",
                    source="baselines_tpu_torch/csrc/stratified_sample.cu",
                    replaces="baselines_tpu/data/pallas_sampler.py:41 and :48",
                    shape=f"N={n}, B={batch}", max_abs_err=float(max_slots), ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                )
            del prios, heavy, got

    with Phase("main path 1: ppo2 learn, 2 updates of 256 x 128"):
        recorder = RecordingOutput()
        logger.Logger.CURRENT = logger.Logger(
            dir=None, output_formats=[logger.HumanOutputFormat(sys.stdout), recorder])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        model = learn(
            env_id="AtariSim-v0", network="cnn_s2d", dtype=torch.bfloat16,
            env_kwargs={"s2d": 4}, num_envs=256, nsteps=128, nminibatches=4, noptepochs=4,
            total_timesteps=2 * 32768, seed=0, log_interval=1,
        )
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        counts["ppo2"] = read_counts()
        k1, k2 = fused_cnn_forward.launches, take_rows.launches
        require(k1 >= 2 * 129, f"fused_cnn_forward launched {k1} times, expected >= 258")
        require(k2 >= 2 * 4 * 6, f"take_rows launched {k2} times, expected >= 48")
        require(len(recorder.rows) == 2, f"expected 2 logged rows, got {len(recorder.rows)}")
        for row in recorder.rows:
            for key, val in row.items():
                if key.startswith("loss/"):
                    require(math.isfinite(val), f"logged {key} = {val} is not finite")
        ent = recorder.rows[0]["loss/policy_entropy"]
        require(abs(ent - math.log(6)) < 0.05, f"initial policy entropy {ent}, expected ~ln 6")
        obs = model.state.obs
        require(obs.shape == (256, 21, 21, 64) and obs.dtype == torch.uint8,
                "final obs has the wrong shape")
        peak = torch.cuda.max_memory_allocated()
        print(f"main path [{card}]: launches fused_cnn_forward {k1}, take_rows {k2}; "
              f"{elapsed:.2f} s for 65536 env steps = {65536 / elapsed:.0f} env-steps/s "
              f"(first update included); logged fps {[r['fps'] for r in recorder.rows]}; "
              f"peak device memory {peak / 2**30:.2f} GiB")
        print(f"logged keys [{card}]: {sorted(recorder.rows[-1])}", flush=True)

    with Phase("main path 2: deepq learn, 16384 steps of 64 envs"):
        # dqn/defaults.py:4-18 (Atari), with cnn_s2d in bf16 in place of conv_only, so
        # that the act step runs the fused CNN kernel (phase 10 runs conv_only), with
        # 64 envs and batch 256 as scripts/profile_dqn.py:49,85 runs deepq, and
        # learning_starts cut from 10000 to 4096 so that 193 of the 256 iterations train
        hparams = dict(dqn_atari_defaults(), env_id="AtariSim-v0", network="cnn_s2d",
                       dtype=torch.bfloat16, env_kwargs={"s2d": 4}, num_envs=64,
                       batch_size=256, chunk_size=64,
                       total_timesteps=16384, learning_starts=4096, seed=0)
        train_iters = sum(1 for k in range(1, 257) if 64 * k >= 4096)
        recorder = RecordingOutput()
        logger.Logger.CURRENT = logger.Logger(
            dir=None, output_formats=[logger.HumanOutputFormat(sys.stdout), recorder])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        model = dqn.learn(**hparams)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        counts["deepq"] = read_counts()
        c = counts["deepq"]
        require(train_iters == 193, f"{train_iters} training iterations, expected 193")
        require(c["fused_cnn"] >= 256, f"fused_cnn_forward launched {c['fused_cnn']} times, "
                "expected >= 256")
        require(c["stratified_sample"] == train_iters,
                f"the sampler ran {c['stratified_sample']} times, expected {train_iters}")
        require(c["take_rows"] >= 5 * train_iters,
                f"take_rows launched {c['take_rows']} times, expected >= {5 * train_iters}")
        state = model.state
        replay = state.replay
        prios = replay.priorities[:10000]
        require(state.t == 16384 and state.n_target_syncs == 16,
                f"t {state.t}, target syncs {state.n_target_syncs}: expected 16384, 16")
        require(replay.buffer.size == 10000 and replay.buffer.ptr == 16384 % 10000,
                "the replay ring did not wrap as expected")
        require(bool(torch.isfinite(prios).all()) and bool((prios > 0).all()),
                "a stored priority is not finite and positive")
        changed = int((prios != 1.0).sum())
        require(changed > 0, "no priority was updated")
        require(not replay.priorities[10000:].any(), "a padding slot got a priority")
        require(len(recorder.rows) == 2, f"expected 2 logged rows, got {len(recorder.rows)}")
        for row in recorder.rows:
            for key, val in row.items():
                if key == "mean 100 episode reward" and row["episodes"] == 0:
                    # no episode of 1000 steps ends in 256 steps of each env: the mean
                    # of none is nan, as in the JAX package
                    require(math.isnan(val), f"{key} = {val} with no episode finished")
                else:
                    require(math.isfinite(val), f"logged {key} = {val} is not finite")
        with torch.no_grad():
            q = model.policy.act_q_values(state.obs)
        require(q.shape == (64, 6) and bool(torch.isfinite(q).all()),
                "the trained net's q-values are not finite")
        peak = torch.cuda.max_memory_allocated()
        print(f"main path 2 [{card}]: launches {c}; {train_iters} training iterations; "
              f"{elapsed:.2f} s for 16384 env steps = {16384 / elapsed:.0f} env-steps/s "
              f"(set-up included); logged fps {[r['fps'] for r in recorder.rows]}; "
              f"{changed} of 10000 priorities updated, max priority "
              f"{float(replay.max_priority):.4f}; peak device memory {peak / 2**30:.2f} GiB")
        print(f"logged keys [{card}]: {sorted(recorder.rows[-1])}", flush=True)

    def run_cli(argv):
        """run.main(argv) with its standard output kept; returns (model, output)."""
        tee = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            try:
                model = cli.main(argv)
            finally:
                logger.reset()
        torch.cuda.synchronize()
        return model, tee.text()

    def play_report(out: str) -> str:
        lines = [ln for ln in out.splitlines() if ln.startswith("episode_rew mean=")]
        require(len(lines) == 1, f"expected one play report, got {lines}")
        return lines[0]

    with Phase("main path 3: the CLI on CartPole-v1 (ppo2 and deepq)"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
        try:
            # a. bench.py:388-397's MLP secondary at full width: 1024 envs x 128 steps
            model_path = os.path.join(tmp, "ppo2_cartpole.pt")
            nenv, nsteps = 1024, 128
            argv = ["--alg=ppo2", "--env=CartPole-v1", "--network=mlp", "--seed=0",
                    f"--num_env={nenv}", f"--nsteps={nsteps}", "--nminibatches=4",
                    "--noptepochs=4", "--log_interval=1", "--play"]
            reset_counts()
            start = time.perf_counter()
            model_a, out_a = run_cli(argv + [f"--num_timesteps={2 * nenv * nsteps}",
                                             f"--save_path={model_path}",
                                             f"--log_path={os.path.join(tmp, 'a')}"])
            elapsed = time.perf_counter() - start
            counts["cli_ppo2"] = c = read_counts()
            require(c["take_rows"] == 48, f"take_rows launched {c['take_rows']} times in the "
                    "CLI's ppo2 run, expected 48 (6 fields x 4 epochs x 2 updates)")
            with open(os.path.join(tmp, "a", "progress.csv"), newline="") as f:
                rows = list(csv.DictReader(f))
            require(len(rows) == 2, f"expected 2 logged rows, got {len(rows)}")
            for row in rows:
                for key, val in row.items():
                    if key.startswith("loss/"):
                        require(math.isfinite(float(val)), f"logged {key} = {val} is not finite")
            report_a = play_report(out_a)
            require(model_a.state.obs.shape == (nenv, 4) and model_a.device.type == "cuda",
                    "the CLI's ppo2 state has the wrong shape or device")
            rate = 2 * nenv * nsteps / float(rows[-1]["misc/time_elapsed"])
            print(f"main path 3a [{card}]: launches {c}; 2 updates of {nenv} x {nsteps} in "
                  f"{float(rows[-1]['misc/time_elapsed']):.2f} s = {rate:.0f} env-steps/s "
                  f"(first update included); logged fps {[int(r['fps']) for r in rows]}; "
                  f"eprewmean {[float(r['eprewmean']) for r in rows]}; run.main with save "
                  f"and play {elapsed:.2f} s; {report_a}", flush=True)

            # b. the saved file back through --load_path, nothing trained, the same play
            model_b, out_b = run_cli(argv + ["--num_timesteps=0", f"--load_path={model_path}",
                                             f"--log_path={os.path.join(tmp, 'b')}"])
            saved, loaded = model_a.policy.module.state_dict(), model_b.policy.module.state_dict()
            require(saved.keys() == loaded.keys()
                    and all(torch.equal(saved[k], loaded[k]) for k in saved),
                    "the loaded params differ from the saved ones")
            report_b = play_report(out_b)
            require(report_b == report_a, f"play after load: {report_b}, after training: "
                    f"{report_a}")
            print(f"main path 3b [{card}]: {len(saved)} param tensors loaded bit for bit; "
                  f"{report_b}, the same as after training", flush=True)

            # c. deepq at the classic-control defaults (1 env, learning_starts 1000,
            # checkpoint_freq 10000): latest is written at the first chunk past 1000 steps
            ckpt_dir = os.path.join(tmp, "dqn")
            steps = 1280
            train_iters = sum(1 for t in range(1, steps + 1) if t >= 1000)
            reset_counts()
            start = time.perf_counter()
            model_c, _ = run_cli(["--alg=deepq", "--env=CartPole-v1", "--seed=0",
                                  f"--num_timesteps={steps}", f"--checkpoint_path={ckpt_dir}",
                                  f"--log_path={os.path.join(tmp, 'c')}"])
            elapsed = time.perf_counter() - start
            counts["cli_deepq"] = c = read_counts()
            require(c["take_rows"] == 5 * train_iters, f"take_rows launched {c['take_rows']} "
                    f"times in the CLI's deepq run, expected {5 * train_iters}")
            require(model_c.state.t == steps, f"deepq ran to t {model_c.state.t}")
            latest = torch.load(os.path.join(ckpt_dir, "latest"), weights_only=True,
                                map_location="cpu")
            require(latest["t"] == 1024 and set(latest) == {
                "params", "target_params", "opt", "t", "n_target_syncs"},
                f"latest holds {sorted(latest)} at t {latest.get('t')}")
            print(f"main path 3c [{card}]: launches {c}; {train_iters} training iterations; "
                  f"{steps} env steps in {elapsed:.2f} s with set-up; latest written at t "
                  f"{latest['t']}", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # d. the gather at the CartPole shapes of path 3a: obs rows of 16 bytes and one
        # 4-byte field, by the epoch's permutation of 131072 rows
        n = 1024 * 128  # one update's batch
        gen = torch.Generator(device=dev).manual_seed(8)
        perm = torch.randperm(n, device=dev, generator=gen)
        cartpole_shapes = []
        for x in (torch.randn((n, 4), device=dev, generator=gen),
                  torch.randn((n,), device=dev, generator=gen)):
            got = take_rows(x, perm)
            require(torch.equal(got, x[perm]), f"take_rows on f32 {tuple(x.shape)} differs "
                    "from x[idx]")
            t, readings = turns_ms({"kernel": lambda: take_rows(x, perm),
                                    "plain": lambda: x[perm],
                                    "index_select": lambda: x.index_select(0, perm)}, 50,
                                   rounds=3)
            bms, by = bound_ms(0, 2 * x.numel() * 4 + perm.numel() * 8)
            shape = f"f32 {tuple(x.shape)} by ({n},) int64"
            cartpole_shapes.append(dict(shape=shape, max_abs_err=0.0, ms=t["kernel"],
                                        plain_ms=t["plain"], bound_ms=bms, bound_by=by,
                                        library_ms=t["index_select"]))
            print(f"take_rows CartPole {shape}: bit-exact; device times: kernel "
                  f"{t['kernel']:.4f} ms, plain x[idx] {t['plain']:.4f} ms, index_select "
                  f"{t['index_select']:.4f} ms, bound {bms:.4f} ms ({by}); in turns: "
                  f"{lead(readings, 'kernel', 'index_select')} [{card}]", flush=True)
        kernels["take_rows"]["cartpole_shapes"] = cartpole_shapes

    with Phase("main path 4: the CLI on Pendulum-v1 (ppo2, VecNormalize) and Acrobot-v1 "
               "(prioritized deepq)"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_continuous_")
        try:
            # a. ppo2 with a Gaussian head at the width of path 3a, its env chain
            # ClipActions -> VecMonitor -> VecRewardScale -> VecNormalize
            model_path = os.path.join(tmp, "ppo2_pendulum.pt")
            nenv, nsteps = 1024, 128
            argv = ["--alg=ppo2", "--env=Pendulum-v1", "--network=mlp", "--seed=0",
                    f"--num_env={nenv}", f"--nsteps={nsteps}", "--nminibatches=4",
                    "--noptepochs=4", "--log_interval=1", "--play",
                    "--env_kwargs={'normalize': True}"]
            reset_counts()
            start = time.perf_counter()
            model_a, out_a = run_cli(argv + [f"--num_timesteps={2 * nenv * nsteps}",
                                             "--reward_scale=0.1", f"--save_path={model_path}",
                                             f"--log_path={os.path.join(tmp, 'a')}"])
            elapsed = time.perf_counter() - start
            counts["cli_ppo2_pendulum"] = c = read_counts()
            require(c["take_rows"] == 48 and c["fused_cnn"] == 0 and c["stratified_sample"] == 0,
                    f"the CLI's ppo2 run on Pendulum launched {c}, expected 48 gathers (6 fields "
                    "x 4 epochs x 2 updates) and nothing else")
            with open(os.path.join(tmp, "a", "progress.csv"), newline="") as f:
                rows = list(csv.DictReader(f))
            require(len(rows) == 2, f"expected 2 logged rows, got {len(rows)}")
            for row in rows:
                for key, val in row.items():
                    if key.startswith("loss/"):
                        require(math.isfinite(float(val)), f"logged {key} = {val} is not finite")
            ns_a = model_a._normalize_state()
            require(ns_a is not None, "the Pendulum model carries no VecNormalize statistics")
            grown = float(ns_a.ob_rms.count) - (1e-4 + nenv)  # after the reset's fold
            require(abs(grown - 2 * nenv * nsteps) <= 1, f"ob_rms's count grew by {grown}, "
                    f"expected {2 * nenv * nsteps}")
            report_a = play_report(out_a)
            require(model_a.state.obs.shape == (nenv, 3) and model_a.device.type == "cuda"
                    and model_a.policy.module.logstd.shape == (1, 1),
                    "the CLI's Pendulum state has the wrong shape or device")
            rate = 2 * nenv * nsteps / float(rows[-1]["misc/time_elapsed"])
            print(f"main path 4a [{card}]: launches {c}; 2 updates of {nenv} x {nsteps} in "
                  f"{float(rows[-1]['misc/time_elapsed']):.2f} s = {rate:.0f} env-steps/s "
                  f"(first update included); logged fps {[int(r['fps']) for r in rows]}; "
                  f"eprewmean {[float(r['eprewmean']) for r in rows]}; entropy "
                  f"{[float(r['loss/policy_entropy']) for r in rows]}; ob_rms count "
                  f"{float(ns_a.ob_rms.count):.1f}; run.main with save and play {elapsed:.2f} s; "
                  f"{report_a}", flush=True)

            # b. the saved file back through --load_path into a fresh normalized learner
            model_b, out_b = run_cli(argv + ["--num_timesteps=0", f"--load_path={model_path}",
                                             f"--log_path={os.path.join(tmp, 'b')}"])
            saved, loaded = model_a.policy.module.state_dict(), model_b.policy.module.state_dict()
            require(saved.keys() == loaded.keys() and "logstd" in saved
                    and all(torch.equal(saved[k], loaded[k]) for k in saved),
                    "the loaded params differ from the saved ones")
            ns_b = model_b._normalize_state()
            for name in ("ob_rms", "ret_rms"):
                for field in ("mean", "var", "count"):
                    require(torch.equal(getattr(getattr(ns_a, name), field),
                                        getattr(getattr(ns_b, name), field)),
                            f"the loaded {name}.{field} differs from the saved one")
            report_b = play_report(out_b)
            require(report_b == report_a, f"play after load: {report_b}, after training: "
                    f"{report_a}")
            print(f"main path 4b [{card}]: {len(saved)} param tensors (logstd included) and "
                  f"both running statistics loaded bit for bit; {report_b}, the same as after "
                  "training", flush=True)

            # c. prioritized deepq at the classic-control defaults: the 50000-slot ring
            # padded to 51200 slots, 25 blocks of the sampler, batch 32
            steps = 1280
            train_iters = sum(1 for t in range(1, steps + 1) if t >= 1000)
            reset_counts()
            start = time.perf_counter()
            model_c, _ = run_cli(["--alg=deepq", "--env=Acrobot-v1", "--seed=0",
                                  f"--num_timesteps={steps}", "--prioritized_replay=True",
                                  f"--log_path={os.path.join(tmp, 'c')}"])
            elapsed = time.perf_counter() - start
            counts["cli_deepq_acrobot"] = c = read_counts()
            require(c["stratified_sample"] == train_iters and c["take_rows"] == 5 * train_iters,
                    f"the CLI's deepq run on Acrobot launched {c}, expected {train_iters} "
                    f"samplers and {5 * train_iters} gathers")
            replay = model_c.state.replay
            size = replay.buffer.size
            require(model_c.state.t == steps and size == steps
                    and replay.priorities.shape == (51200,), "the replay ring has the wrong size")
            prios = replay.priorities[:size]
            require(bool(torch.isfinite(prios).all()) and bool((prios > 0).all())
                    and int((prios != 1.0).sum()) > 0 and not replay.priorities[size:].any(),
                    "the priorities are not finite, positive and updated")
            batch = {k: v[:32] for k, v in replay.buffer.data.items()}
            with torch.no_grad():
                loss, _ = td_loss(model_c.policy, model_c.state.target, batch,
                                  torch.ones(32, device=dev), gamma=0.99, double_q=True)
            require(math.isfinite(float(loss)), f"the TD loss on stored transitions is {loss}")
            print(f"main path 4c [{card}]: launches {c}; {train_iters} training iterations; "
                  f"{steps} env steps in {elapsed:.2f} s with set-up; max priority "
                  f"{float(replay.max_priority):.4f}; TD loss on 32 stored transitions "
                  f"{float(loss):.4f}", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # d. the gather at this path's shapes: Pendulum's 12-byte obs rows and 4-byte
        # action rows by the epoch's permutation, and 32 rows of the deepq rings
        n = 1024 * 128
        gen = torch.Generator(device=dev).manual_seed(9)
        perm = torch.randperm(n, device=dev, generator=gen)
        ring_idx = torch.randint(0, 50000, (32,), device=dev, generator=gen)
        path4_shapes = []
        for x, idx, what in ((torch.randn((n, 3), device=dev, generator=gen), perm, "Pendulum obs"),
                             (torch.randn((n, 1), device=dev, generator=gen), perm,
                              "Pendulum actions"),
                             (torch.randn((50000, 6), device=dev, generator=gen), ring_idx,
                              "Acrobot ring obs"),
                             (torch.randn((50000, 4), device=dev, generator=gen), ring_idx,
                              "CartPole ring obs")):
            got = take_rows(x, idx)
            require(torch.equal(got, x[idx]), f"take_rows on {what} f32 {tuple(x.shape)} differs "
                    "from x[idx]")
            t, readings = turns_ms({"kernel": lambda: take_rows(x, idx),
                                    "plain": lambda: x[idx],
                                    "index_select": lambda: x.index_select(0, idx)}, 50,
                                   rounds=3)
            bms, by = bound_ms(0, 2 * idx.numel() * x[0].numel() * 4 + idx.numel() * 8)
            shape = f"{what}: f32 {tuple(x.shape)} by ({idx.numel()},) int64"
            path4_shapes.append(dict(shape=shape, max_abs_err=0.0, ms=t["kernel"],
                                     plain_ms=t["plain"], bound_ms=bms, bound_by=by,
                                     library_ms=t["index_select"]))
            print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms, "
                  f"plain x[idx] {t['plain']:.4f} ms, index_select {t['index_select']:.4f} ms, "
                  f"bound {bms:.6f} ms ({by}); in turns: "
                  f"{lead(readings, 'kernel', 'index_select')} [{card}]", flush=True)
        kernels["take_rows"]["path4_shapes"] = path4_shapes

        # the sampler at the Acrobot ring's 51200 padded slots with deepq's 32 targets
        n, batch = 51200, 32
        gen = torch.Generator(device=dev).manual_seed(n + batch)
        prios, u, got, max_slots, n_diff, sums_err = check_sampler(n, batch, gen)
        total = torch.cumsum(ss.plain_block_sums(prios).double(), 0)[-1].float()
        targets = ss.stratified_targets(total.view(1), u, batch)
        t, readings = turns_ms({
            "kernel": lambda: ss.stratified_sample(prios, u, batch),
            "cumsum+searchsorted": lambda: torch.searchsorted(
                torch.cumsum(prios, 0), targets, right=True),
            "floor": lambda: floor_x.add_(1)}, 50, rounds=3)
        plain_ms = graph_ms(lambda: ss.plain_stratified_sample(prios, u, batch), 10)
        bms, by = bound_ms(0, 4 * n + 8 * batch)
        print(f"stratified_sample N={n} (25 blocks) B={batch} [{card}]: integer priorities "
              f"bit-exact (zero and random uniforms, block sums); |randn|: {n_diff} of {batch} "
              f"indices differ from plain (max {max_slots} slots), block sums max abs err "
              f"{sums_err:.3g}; device times: one launch {t['kernel']:.4f} ms, "
              f"cumsum+searchsorted {t['cumsum+searchsorted']:.4f}, launch floor "
              f"{t['floor']:.4f}, plain {plain_ms:.4f}, bound {bms:.6f} ({by}); in turns: "
              f"{lead(readings, 'kernel', 'cumsum+searchsorted')}", flush=True)
        kernels["stratified_sample"]["path4_shape"] = dict(
            shape=f"N={n}, B={batch}", max_abs_err=float(max_slots), ms=t["kernel"],
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=t["cumsum+searchsorted"])

    with Phase("main path 5: impala_cnn, the recurrent ppo2, ppo1, microbatching and deepq "
               "on conv_only"):
        # a. ppo2 with impala_cnn in bf16 on the unpacked 84x84x4 frames, at bench.py's
        # primary width: 256 envs x 128 steps, 4 epochs x 4 minibatches of 8192, 2 updates
        recorder = RecordingOutput()
        logger.Logger.CURRENT = logger.Logger(
            dir=None, output_formats=[logger.HumanOutputFormat(sys.stdout), recorder])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = time.perf_counter()
        model = learn(env_id="AtariSim-v0", network="impala_cnn", dtype=torch.bfloat16,
                      num_envs=256, nsteps=128, nminibatches=4, noptepochs=4,
                      total_timesteps=2 * 32768, seed=0, log_interval=1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        counts["impala_ppo2"] = c = read_counts()
        require(c == {"fused_cnn": 0, "take_rows": 48, "stratified_sample": 0},
                f"ppo2 on impala_cnn launched {c}, expected 48 gathers (6 fields x 4 epochs x "
                "2 updates) and nothing else")
        require(len(recorder.rows) == 2, f"expected 2 logged rows, got {len(recorder.rows)}")
        for row in recorder.rows:
            for key, val in row.items():
                if key.startswith("loss/"):
                    require(math.isfinite(val), f"impala_cnn: logged {key} = {val} is not finite")
        ent = recorder.rows[0]["loss/policy_entropy"]
        require(abs(ent - math.log(6)) < 0.05, f"impala_cnn: initial policy entropy {ent}")
        require(model.policy.module.network.Dense_0.in_features == 3872,
                "impala_cnn's dense layer does not read 11 x 11 x 32")
        peak = torch.cuda.max_memory_allocated()
        print(f"main path 5a [{card}]: ppo2 impala_cnn bf16, launches {c}; {elapsed:.2f} s for "
              f"65536 env steps = {65536 / elapsed:.0f} env-steps/s (first update included); "
              f"logged fps {[r['fps'] for r in recorder.rows]}; losses "
              f"{[round(r['loss/policy_loss'], 6) for r in recorder.rows]}; peak device memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        del model
        # the gather at this path's shape: u8 obs rows of 84 x 84 x 4 = 28,224 bytes by
        # an epoch's permutation of the 32768 samples
        n = 32768
        gen = torch.Generator(device=dev).manual_seed(10)
        obs = torch.randint(0, 256, (n, 84, 84, 4), dtype=torch.uint8, device=dev, generator=gen)
        perm = torch.randperm(n, device=dev, generator=gen)
        require(torch.equal(take_rows(obs, perm), obs[perm]),
                "take_rows on the unpacked obs differs from x[idx]")
        t, readings = turns_ms({"kernel": lambda: take_rows(obs, perm),
                                "plain": lambda: obs[perm],
                                "index_select": lambda: obs.index_select(0, perm)}, 5, reps=4,
                               rounds=3)
        bms, by = bound_ms(0, 2 * obs.numel() + perm.numel() * 8)
        shape = f"impala obs: u8 {tuple(obs.shape)} by ({n},) int64"
        kernels["take_rows"]["path5_shapes"] = [dict(
            shape=shape, max_abs_err=0.0, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bms,
            bound_by=by, library_ms=t["index_select"])]
        print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms "
              f"({bms / t['kernel']:.1%} of the bound), plain x[idx] {t['plain']:.4f} ms, "
              f"index_select {t['index_select']:.4f} ms, bound {bms:.4f} ms ({by}); in turns: "
              f"{lead(readings, 'kernel', 'index_select')} [{card}]", flush=True)
        del obs, perm

        # b. ppo2 with cnn_lstm (the Nature CNN into 128 LSTM cells) in f32 at the same
        # width, 4 minibatches of 64 whole envs. First the first update's rollout, rebuilt
        # as learn builds it from the same seed, replayed as the loss replays it from the
        # carry before the rollout: the rollout's neglogps and values to 1e-4 relative;
        # then a second rollout from that carry with half the envs done before its first
        # step, whose masks zero a nonzero carry, replayed the same way
        torch.cuda.reset_peak_memory_stats()
        venv = build_env("AtariSim-v0", 256, device=dev)
        policy = build_policy(venv.observation_space, venv.action_space, "cnn_lstm",
                              device=dev, generator=torch.Generator().manual_seed(0), nlstm=128)
        draws = Draws(0, dev)
        obs, env_state = venv.reset(draws)
        done = torch.zeros((256,), dtype=torch.bool, device=dev)
        carry = policy.initial_state(256)
        replay_errs = []
        for rollout in range(2):
            init = carry
            env_state, obs, done, traj, _, carry = run_rollout(
                policy, venv, draws, env_state, obs, done, 128, init)
            with torch.no_grad():
                pdflat, vf, replayed = policy.module.unroll(traj.obs, init, traj.rnn_masks)
            neglogp = policy.pdtype.pdfromflat(pdflat).neglogp(traj.actions.reshape(-1))
            errs = (rel(neglogp, traj.neglogps.reshape(-1)), rel(vf, traj.values.reshape(-1)),
                    rel(replayed, carry))
            require(max(errs) < 1e-4, f"cnn_lstm: the replay of rollout {rollout} differs from "
                    f"it by {errs} (neglogps, values, carry)")
            require(float(carry.abs().max()) > 0, "cnn_lstm: the carry after the rollout is zero")
            replay_errs.append(errs)
            done = torch.arange(256, device=dev) % 2 == 0
        require(int(traj.rnn_masks[0].sum()) == 128 and float(init.abs().max()) > 0,
                "cnn_lstm: the second rollout did not mask a nonzero carry")
        del venv, policy, traj, pdflat, vf, neglogp
        recorder = RecordingOutput()
        logger.Logger.CURRENT = logger.Logger(
            dir=None, output_formats=[logger.HumanOutputFormat(sys.stdout), recorder])
        reset_counts()
        start = time.perf_counter()
        model = learn(env_id="AtariSim-v0", network="cnn_lstm", nlstm=128, num_envs=256,
                      nsteps=128, nminibatches=4, noptepochs=4, total_timesteps=2 * 32768,
                      seed=0, log_interval=1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        counts["cnn_lstm_ppo2"] = c = read_counts()
        require(len(recorder.rows) == 2, f"expected 2 logged rows, got {len(recorder.rows)}")
        for row in recorder.rows:
            for key, val in row.items():
                if key.startswith("loss/"):
                    require(math.isfinite(val), f"cnn_lstm: logged {key} = {val} is not finite")
        carry = model.state.rnn_state
        require(carry.shape == (256, 256) and float(carry.abs().max()) > 0,
                "cnn_lstm: the carry after training is zero or misshapen")
        peak = torch.cuda.max_memory_allocated()
        print(f"main path 5b [{card}]: ppo2 cnn_lstm f32, launches {c}; replay of the first "
              f"and second rollouts (neglogps, values, carry) rel err {replay_errs}; "
              f"{elapsed:.2f} s for 65536 env steps = {65536 / elapsed:.0f} env-steps/s (first "
              f"update included); logged fps {[r['fps'] for r in recorder.rows]}; carry max "
              f"{float(carry.abs().max()):.4f}; peak device memory {peak / 2**30:.2f} GiB",
              flush=True)
        del model, carry

        # c. ppo2 with lstm on FixedSequenceEnv(10, episode_len=5), which only memory
        # solves (tests/test_ppo_learning.py:78-102's run)
        def fixed_sequence():
            return VecMonitor(VecTorchEnv(FixedSequenceEnv(10, episode_len=5), 8, dev))

        logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[RecordingOutput()])
        reset_counts()
        start = time.perf_counter()
        model = learn(env=fixed_sequence(), network="lstm", nlstm=32, total_timesteps=50_000,
                      seed=0, nsteps=10, nminibatches=1, noptepochs=4, lr=1e-3, ent_coef=0.0,
                      log_interval=1000)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        counts["lstm_fixed_sequence"] = c = read_counts()
        ret, length, episodes = evaluate(model, fixed_sequence(), Draws(1, dev), nsteps=100,
                                         deterministic=True)
        # the bar of the JAX package's test; a policy without memory sees one constant
        # observation, so it plays one action and scores at most that action's count in
        # the sequence, 2 of 5 for this env's (5, 0, 3, 3, 7)
        require(ret > 3.5, f"lstm on FixedSequence: mean return {ret}, want > 3.5 of 5")
        print(f"main path 5c [{card}]: ppo2 lstm on FixedSequence, 50000 steps in "
              f"{elapsed:.2f} s = {50000 / elapsed:.0f} env-steps/s, launches {c}; "
              f"deterministic return {ret} of 5 (len {length}, {episodes} episodes)", flush=True)
        del model

        tmp = tempfile.mkdtemp(prefix="chip_smoke_variants_")
        try:
            # d (i). ppo1 with a separate value tower at its classic-control defaults (8
            # envs, 512 steps an update, 4 epochs of minibatches of 128), 4 updates, save
            # and play, then the --load_path round trip
            model_path = os.path.join(tmp, "ppo1.pt")
            argv = ["--alg=ppo1", "--env=CartPole-v1", "--seed=0", "--value_network=copy",
                    "--play"]
            reset_counts()
            start = time.perf_counter()
            model_a, out_a = run_cli(argv + [f"--num_timesteps={4 * 512}",
                                             f"--save_path={model_path}",
                                             f"--log_path={os.path.join(tmp, 'a')}"])
            elapsed = time.perf_counter() - start
            counts["cli_ppo1"] = c = read_counts()
            require(c["take_rows"] == 7 * 4 * 4, f"ppo1 launched {c}, expected 112 gathers (6 "
                    "fields and the batch's advantages x 4 epochs x 4 updates)")
            with open(os.path.join(tmp, "a", "progress.csv"), newline="") as f:
                rows = list(csv.DictReader(f))
            for row in rows:
                for key, val in row.items():
                    if key.startswith("loss/"):
                        require(math.isfinite(float(val)), f"ppo1: logged {key} = {val}")
            require(model_a.state.update_idx == 4 and model_a.opt.max_grad_norm is None,
                    f"ppo1 ran {model_a.state.update_idx} updates, expected 4 without gradient "
                    "clipping")
            report_a = play_report(out_a)
            model_b, out_b = run_cli(argv + ["--num_timesteps=0", f"--load_path={model_path}",
                                             f"--log_path={os.path.join(tmp, 'b')}"])
            saved, loaded = model_a.policy.module.state_dict(), model_b.policy.module.state_dict()
            require(saved.keys() == loaded.keys() and "value_network.mlp_fc0.weight" in saved
                    and all(torch.equal(saved[k], loaded[k]) for k in saved),
                    "ppo1: the loaded params differ from the saved ones")
            require(play_report(out_b) == report_a, "ppo1: play after load differs")
            print(f"main path 5d(i) [{card}]: ppo1 --value_network=copy, launches {c}; "
                  f"4 updates, run.main with save and play {elapsed:.2f} s; eprewmean at the "
                  f"first {[float(r['eprewmean']) for r in rows]}; {len(saved)} param tensors (the "
                  f"value tower's included) loaded bit for bit; {report_a}, the same after "
                  "load", flush=True)

            # d (ii). ppo2 with mlp at 1024 envs x 128 steps, each 32768-sample minibatch
            # as 4 microbatches of 8192, 2 updates, against the same run without them
            argv = ["--alg=ppo2", "--env=CartPole-v1", "--network=mlp", "--seed=0",
                    "--num_env=1024", "--nsteps=128", "--nminibatches=4", "--noptepochs=4",
                    f"--num_timesteps={2 * 1024 * 128}"]
            reset_counts()
            start = time.perf_counter()
            micro, _ = run_cli(argv + ["--microbatch_size=8192",
                                       f"--log_path={os.path.join(tmp, 'micro')}"])
            elapsed = time.perf_counter() - start
            counts["cli_ppo2_microbatch"] = c = read_counts()
            whole, _ = run_cli(argv + [f"--log_path={os.path.join(tmp, 'whole')}"])
            require(c["take_rows"] == 48, f"microbatched ppo2 launched {c}, expected 48 gathers")
            diff = max(float((p - q).abs().max()) for p, q in zip(
                micro.policy.module.parameters(), whole.policy.module.parameters()))
            require(diff < 1e-5, f"microbatched ppo2's params differ from the whole "
                    f"minibatch's by {diff}")
            print(f"main path 5d(ii) [{card}]: ppo2 --microbatch_size=8192, launches {c}; "
                  f"run.main {elapsed:.2f} s; params within {diff:.3g} of the run without "
                  "microbatches", flush=True)
            del micro, whole

            # e. deepq at its Atari defaults (conv_only, prioritized, dueling; buffer 10000
            # padded to 10240 slots, batch 32, one env), learning_starts cut from 10000 to
            # 1000 and the run to 1280 steps, so that 71 iterations train
            steps, starts = 1280, 1000
            train_iters = sum(1 for t in range(1, steps + 1) if t >= starts and t % 4 == 0)
            reset_counts()
            start = time.perf_counter()
            model_e, _ = run_cli(["--alg=deepq", "--env=AtariSim-v0", "--env_type=atari",
                                  "--seed=0", f"--num_timesteps={steps}",
                                  f"--learning_starts={starts}",
                                  f"--log_path={os.path.join(tmp, 'e')}"])
            elapsed = time.perf_counter() - start
            counts["cli_deepq_atari"] = c = read_counts()
            require(train_iters >= 32 and c["stratified_sample"] == train_iters
                    and c["take_rows"] == 5 * train_iters and c["fused_cnn"] == 0,
                    f"deepq on conv_only launched {c}, expected {train_iters} samplers and "
                    f"{5 * train_iters} gathers")
            qnet = model_e.policy.module
            require(type(qnet.network).__name__ == "ConvOnly" and qnet.dueling,
                    "deepq's Atari defaults did not build a dueling QNet on conv_only")
            replay = model_e.state.replay
            prios = replay.priorities[:replay.buffer.size]
            require(replay.priorities.shape == (10240,) and bool(torch.isfinite(prios).all())
                    and bool((prios > 0).all()) and int((prios != 1.0).sum()) > 0,
                    "deepq on conv_only: the priorities are not finite, positive and updated")
            print(f"main path 5e [{card}]: deepq at the Atari defaults on conv_only, launches "
                  f"{c}; {train_iters} training iterations; {steps} env steps in {elapsed:.2f} s "
                  f"with set-up; max priority {float(replay.max_priority):.4f}", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # the kernels at path e's shapes: the gather of 32 rows of the 10000-slot ring of
        # 84x84x4 frames, and the sampler over its 10240 padded slots with 32 targets
        gen = torch.Generator(device=dev).manual_seed(11)
        ring = torch.randint(0, 256, (10000, 84, 84, 4), dtype=torch.uint8, device=dev,
                             generator=gen)
        ridx = torch.randint(0, 10000, (32,), device=dev, generator=gen)
        require(torch.equal(take_rows(ring, ridx), ring[ridx]),
                "take_rows on the conv_only replay ring differs from x[idx]")
        t, readings = turns_ms({"kernel": lambda: take_rows(ring, ridx),
                                "plain": lambda: ring[ridx],
                                "index_select": lambda: ring.index_select(0, ridx)}, 50,
                               rounds=3)
        bms, by = bound_ms(0, 2 * 32 * ring[0].numel() + 32 * 8)
        shape = f"conv_only replay ring: u8 {tuple(ring.shape)} by (32,) int64"
        kernels["take_rows"]["path5_shapes"].append(dict(
            shape=shape, max_abs_err=0.0, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bms,
            bound_by=by, library_ms=t["index_select"]))
        print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms, plain "
              f"x[idx] {t['plain']:.4f} ms, index_select {t['index_select']:.4f} ms, bound "
              f"{bms:.6f} ms ({by}); in turns: {lead(readings, 'kernel', 'index_select')} "
              f"[{card}]", flush=True)
        del ring
        n, batch = 10240, 32
        gen = torch.Generator(device=dev).manual_seed(n + batch)
        prios, u, got, max_slots, n_diff, sums_err = check_sampler(n, batch, gen)
        total = torch.cumsum(ss.plain_block_sums(prios).double(), 0)[-1].float()
        targets = ss.stratified_targets(total.view(1), u, batch)
        t, readings = turns_ms({
            "kernel": lambda: ss.stratified_sample(prios, u, batch),
            "cumsum+searchsorted": lambda: torch.searchsorted(
                torch.cumsum(prios, 0), targets, right=True),
            "floor": lambda: floor_x.add_(1)}, 50, rounds=3)
        plain_ms = graph_ms(lambda: ss.plain_stratified_sample(prios, u, batch), 10)
        bms, by = bound_ms(0, 4 * n + 8 * batch)
        print(f"stratified_sample N={n} B={batch} [{card}]: integer priorities bit-exact (zero "
              f"and random uniforms, block sums); |randn|: {n_diff} of {batch} indices differ "
              f"from plain (max {max_slots} slots), block sums max abs err {sums_err:.3g}; "
              f"device times: one launch {t['kernel']:.4f} ms, cumsum+searchsorted "
              f"{t['cumsum+searchsorted']:.4f}, launch floor {t['floor']:.4f}, plain "
              f"{plain_ms:.4f}, bound {bms:.6f} ({by}); in turns: "
              f"{lead(readings, 'kernel', 'cumsum+searchsorted')}", flush=True)
        kernels["stratified_sample"]["path5_shape"] = dict(
            shape=f"N={n}, B={batch}", max_abs_err=float(max_slots), ms=t["kernel"],
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=t["cumsum+searchsorted"])

    with Phase("main path 6: data parallelism under a one-rank NCCL mesh"):
        # a one-rank NCCL group on this card; no mesh run below falls back to anything else
        mesh = join_one_rank_group()
        try:

            def check_params(module, what):
                params = list(module.parameters())
                require(all(bool(torch.isfinite(p).all()) for p in params),
                        f"{what}: params are not finite")
                require(param_consistency_check(params, mesh, atol=0.0),
                        f"{what}: param_consistency_check failed")

            # a. path 1 under the mesh
            recorder = RecordingOutput()
            logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # by earlier phases, in the peak too
            reset_counts()
            start = time.perf_counter()
            with count_collectives() as calls:
                model = learn(env_id="AtariSim-v0", network="cnn_s2d", dtype=torch.bfloat16,
                              env_kwargs={"s2d": 4}, num_envs=256, nsteps=128, nminibatches=4,
                              noptepochs=4, total_timesteps=2 * 32768, seed=0, log_interval=1,
                              mesh=mesh)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            ppo2_calls = calls[0]
            require(ppo2_calls == 2 * (16 + 16 + 1 + 1),
                    f"ppo2 under the mesh made {ppo2_calls} collectives in 2 logged updates, "
                    "expected 68")
            counts["mesh_ppo2"] = c = read_counts()
            require(c == counts["ppo2"], f"ppo2 under the mesh launched {c}, path 1 "
                    f"launched {counts['ppo2']}")
            check_params(model.policy.module, "ppo2 cnn_s2d under the mesh")
            require(len(recorder.rows) == 2 and all(
                math.isfinite(v) for r in recorder.rows for k, v in r.items()
                if k.startswith("loss/")), "ppo2 under the mesh: logged losses not finite")
            peak = torch.cuda.max_memory_allocated()
            print(f"main path 6a [{card}]: ppo2 cnn_s2d bf16 under a one-rank NCCL mesh, "
                  f"launches {c} (path 1: {counts['ppo2']}), {ppo2_calls} NCCL calls in 2 "
                  f"logged updates; {elapsed:.2f} s for 65536 env "
                  f"steps = {65536 / elapsed:.0f} env-steps/s (first update included); logged "
                  f"fps {[r['fps'] for r in recorder.rows]}; peak device memory "
                  f"{peak / 2**30:.2f} GiB, {held / 2**30:.2f} GiB of it held before the run",
                  flush=True)
            del model
            logger.reset()

            # the cost of one collective on the one-rank NCCL group, host clock over 200
            # calls each, the device synchronized at the end (the device's own time by
            # CUDA events), beside a device op of the same output
            rows = torch.randn((256, 3), device=dev)
            grads = torch.randn((1_700_000,), device=dev)
            calls = {"all_gather (256, 3) f32": lambda: all_gather_rows(rows, mesh),
                     "torch.cat of the same": lambda: torch.cat([rows]),
                     "psum (1.7M,) f32": lambda: psum([grads], mesh),
                     "grads * 1.0": lambda: grads * 1.0}
            costs = {}
            for name, fn in calls.items():
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                ev0.record()
                for _ in range(200):
                    fn()
                ev1.record()
                torch.cuda.synchronize()
                costs[name] = ((time.perf_counter() - t0) * 1e3 / 200, ev0.elapsed_time(ev1) / 200)
            print(f"one-rank NCCL collectives [{card}]: " + "; ".join(
                f"{k} {h:.4f} ms a call (host), {d:.4f} ms (device)"
                for k, (h, d) in costs.items()), flush=True)
            del rows, grads

            # b. CartPole with and without the mesh, from one seed
            def cartpole(**extra):
                logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[])
                m = learn(env_id="CartPole-v1", network="mlp", num_envs=256, nsteps=128,
                          nminibatches=4, noptepochs=4, total_timesteps=2 * 256 * 128, seed=0,
                          log_interval=1, **extra)
                torch.cuda.synchronize()
                logger.reset()
                return m

            def max_diff(a, b):
                sa, sb = a.policy.module.state_dict(), b.policy.module.state_dict()
                diffs = [float((sa[k] - sb[k]).abs().max()) for k in sa]
                diffs.append(float((a.state.obs - b.state.obs).abs().max()))
                return max(diffs)

            start = time.perf_counter()
            plain = cartpole()
            plain_s = time.perf_counter() - start
            reset_counts()
            start = time.perf_counter()
            meshed = cartpole(mesh=mesh)
            elapsed = time.perf_counter() - start
            counts["mesh_cartpole"] = c = read_counts()
            require(c["take_rows"] == 48, f"ppo2 on CartPole under the mesh launched {c}, "
                    "expected 48 gathers")
            check_params(meshed.policy.module, "ppo2 on CartPole under the mesh")
            diff = max_diff(meshed, plain)
            if diff == 0.0:
                verdict = "bit for bit equal to the run without the mesh"
            else:  # hold the mesh run to the spread of two runs without it
                noise = max_diff(cartpole(), plain)
                require(diff <= noise, f"the mesh run differs by {diff}, two runs without the "
                        f"mesh by {noise}")
                verdict = (f"within {diff:.3g} of the run without the mesh, where two runs "
                           f"without it differ by {noise:.3g}")
            print(f"main path 6b [{card}]: ppo2 mlp on CartPole-v1 256 x 128 under the mesh, "
                  f"launches {c}; {elapsed:.2f} s for 65536 env steps ({plain_s:.2f} s without "
                  f"the mesh); params and obs {verdict}", flush=True)
            del plain, meshed

            # c. prioritized deepq under the mesh
            logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[])
            steps, starts, nenv = 512, 128, 4
            train_iters = sum(1 for t in range(nenv, steps + 1, nenv) if t >= starts)
            reset_counts()
            start = time.perf_counter()
            model = dqn.learn(env_id="CartPole-v1", network="mlp", num_envs=nenv,
                              total_timesteps=steps, learning_starts=starts, batch_size=32,
                              chunk_size=16, prioritized_replay=True, print_freq=0, seed=0,
                              mesh=mesh)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            logger.reset()
            counts["mesh_deepq"] = c = read_counts()
            require(train_iters == 97 and c["stratified_sample"] == train_iters
                    and c["take_rows"] == 5 * train_iters,
                    f"deepq under the mesh launched {c}, expected {train_iters} samplers and "
                    f"{5 * train_iters} gathers")
            check_params(model.policy.module, "deepq under the mesh")
            require(model.state.t == steps, f"deepq under the mesh ran to t {model.state.t}")
            print(f"main path 6c [{card}]: prioritized deepq mlp on CartPole-v1 under the "
                  f"mesh, launches {c}; {train_iters} training iterations; {steps} env steps "
                  f"in {elapsed:.2f} s with set-up", flush=True)

            # d. a2c under the mesh, at the classic-control defaults (8 envs x 5 steps),
            # after the same run without it, whose time splits off the collectives' cost
            steps = 20000
            logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[])
            start = time.perf_counter()
            a2c.learn(env_id="CartPole-v1", network="mlp", num_envs=8, nsteps=5,
                      total_timesteps=steps, seed=0, log_interval=100)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - start
            logger.reset()
            recorder = RecordingOutput()
            logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
            reset_counts()
            start = time.perf_counter()
            with count_collectives() as calls:
                model = a2c.learn(env_id="CartPole-v1", network="mlp", num_envs=8, nsteps=5,
                                  total_timesteps=steps, seed=0, log_interval=100, mesh=mesh)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            a2c_calls = calls[0]
            require(a2c_calls == 2 * 500 + 6, f"a2c under the mesh made {a2c_calls} "
                    "collectives in 500 updates, 6 of them logged; expected 1006")
            logger.reset()
            counts["mesh_a2c"] = c = read_counts()
            check_params(model.policy.module, "a2c under the mesh")
            require(model.state.update_idx == steps // 40 and recorder.rows and all(
                math.isfinite(r["policy_loss"]) for r in recorder.rows),
                "a2c under the mesh: wrong update count or losses not finite")
            print(f"main path 6d [{card}]: a2c mlp on CartPole-v1 under the mesh, launches "
                  f"{c}, {a2c_calls} NCCL calls; {model.state.update_idx} updates, {steps} env steps in {elapsed:.2f} s "
                  f"= {steps / elapsed:.0f} env-steps/s (set-up included; without the mesh "
                  f"{plain_s:.2f} s = {steps / plain_s:.0f}); eprewmean "
                  f"{[round(r['eprewmean'], 2) for r in recorder.rows]}", flush=True)
            del model
        finally:
            torch.distributed.destroy_process_group()

        # e. two NCCL ranks, one a card
        if torch.cuda.device_count() >= 2:
            start = time.perf_counter()
            outs = dryrun_multichip(2)
            print(f"main path 6e [{card}]: dryrun_multichip(2) over NCCL in "
                  f"{time.perf_counter() - start:.2f} s:\n{''.join(outs)}", flush=True)
        else:
            print(f"main path 6e [{card}]: dryrun_multichip(2) did not run: this machine has "
                  f"{torch.cuda.device_count()} card and NCCL puts no two ranks on one GPU; "
                  "the two-rank math is held by the CPU gloo tests", flush=True)

    with Phase("main path 7: trpo, ddpg with deepq's param_noise, and her"):
        from baselines_tpu_torch.algos.ddpg import ddpg
        from baselines_tpu_torch.algos.trpo import trpo
        from baselines_tpu_torch.algos.trpo.defaults import atari as trpo_atari_defaults
        from baselines_tpu_torch.envs.goal.point_reach import PointReach

        def begin():
            """Counts to 0, the peak memory statistics reset; the start time."""
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            return time.perf_counter()

        def peak_gib() -> str:
            return f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"

        def same_params(a, b) -> bool:
            sa, sb = a.state_dict(), b.state_dict()
            return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)

        def same_rms(a, b) -> bool:
            return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))

        tmp = tempfile.mkdtemp(prefix="chip_smoke_slice7_")
        try:
            # a. trpo on AtariSim-v0 at trpo/defaults.py atari(), cnn_s2d in bf16 for the
            # Nature cnn (as path 2 runs deepq), 16 envs x 32 steps, 4 iterations
            hp = dict(trpo_atari_defaults(), network="cnn_s2d")
            recorder = RecordingOutput()
            logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
            start = begin()
            trpo.learn(env_id="AtariSim-v0", dtype=torch.bfloat16, env_kwargs={"s2d": 4},
                       num_envs=16, total_timesteps=4 * 512, seed=0, log_interval=1, **hp)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            logger.reset()
            counts["trpo_atari"] = c = read_counts()
            require(c["fused_cnn"] >= 4 * 32 and c["take_rows"] == 4 * 3 * 2,
                    f"trpo on AtariSim launched {c}, expected >= 128 fused_cnn and 24 take_rows")
            require(len(recorder.rows) == 4 and all(
                math.isfinite(r[k]) for r in recorder.rows for k in (
                    "optimgain", "meankl", "entropy", "surrgain", "expectedimprove", "improve",
                    "linesearch_success", "ev_tdlam_before")),
                "trpo on AtariSim: a logged metric is missing or not finite")
            print(f"main path 7a [{card}]: trpo cnn_s2d bf16 on AtariSim-v0, 16 x 32, 4 "
                  f"iterations, launches {c}; {elapsed:.2f} s for 2048 env steps = "
                  f"{2048 / elapsed:.0f} env-steps/s (set-up included); linesearch_success "
                  f"{[r['linesearch_success'] for r in recorder.rows]}, meankl "
                  f"{[round(r['meankl'], 6) for r in recorder.rows]}; {peak_gib()}", flush=True)

            # b. trpo with mlp on CartPole-v1 through run.main at the classic-control
            # defaults (tests/test_trpo_learning.py:37-55's run), 40 iterations of its
            # 1024 steps where the test runs 146, so that the script keeps to its time
            # (50 until phase 15 came): the return it checks is reached by then; saved,
            # and the file back through --load_path
            steps = 40 * 1024
            path = os.path.join(tmp, "trpo.pt")
            argv = ["--alg=trpo_mpi", "--env=CartPole-v1", "--seed=0", "--play"]
            start = begin()
            model_b, out_b = run_cli(argv + [f"--num_timesteps={steps}", f"--save_path={path}",
                                             f"--log_path={os.path.join(tmp, 'trpo')}"])
            elapsed = time.perf_counter() - start
            counts["cli_trpo"] = c = read_counts()
            iters = steps // 1024
            require(c["take_rows"] == iters * 5 * 2, f"trpo on CartPole launched {c}, "
                    f"expected {iters * 10} take_rows (2 fields x 5 value epochs an iteration)")
            ret, length, episodes = evaluate(model_b, build_env("CartPole-v1", 8, device=dev),
                                             Draws(1, dev), nsteps=600)
            require(ret >= 150, f"trpo on CartPole: deterministic return {ret}, want >= 150")
            model_l, out_l = run_cli(argv + ["--num_timesteps=0", f"--load_path={path}",
                                             f"--log_path={os.path.join(tmp, 'trpo_l')}"])
            require(same_params(model_b.policy.module, model_l.policy.module),
                    "trpo: the loaded params differ from the saved ones")
            require(play_report(out_l) == play_report(out_b),
                    f"trpo: play after load {play_report(out_l)}, after training "
                    f"{play_report(out_b)}")
            print(f"main path 7b [{card}]: trpo mlp on CartPole-v1 through run.main, {iters} "
                  f"iterations of 8 x 128, launches {c}; {elapsed:.2f} s with save and play = "
                  f"{iters * 1024 / elapsed:.0f} env-steps/s (set-up included); deterministic "
                  f"return {ret} (len {length}, {episodes} episodes of 8 envs x 600 steps); "
                  f"the load round trip bit for bit, {play_report(out_l)}; {peak_gib()}",
                  flush=True)
            del model_b, model_l

            # c. ddpg through run.main on Pendulum-v1 at its classic-control defaults (4
            # envs, ou_0.2, actor_lr 1e-3, batch 64): one epoch of 10 cycles x (100
            # steps, 50 train steps) where the defaults run 20, so that the script keeps
            # to its time (20 until phase 15 came); saved, played, and the file back
            # through --load_path
            path = os.path.join(tmp, "ddpg.pt")
            argv = ["--alg=ddpg", "--env=Pendulum-v1", "--seed=0", "--nb_epoch_cycles=10",
                    "--play"]
            start = begin()
            model_c, out_c = run_cli(argv + ["--num_timesteps=4000", f"--save_path={path}",
                                             f"--log_path={os.path.join(tmp, 'ddpg')}"])
            elapsed = time.perf_counter() - start
            counts["cli_ddpg"] = c = read_counts()
            require(c["take_rows"] == 5 * 10 * 50, f"ddpg launched {c}, expected 2500 "
                    "take_rows (5 fields a train step, 500 train steps)")
            with open(os.path.join(tmp, "ddpg", "progress.csv"), newline="") as f:
                rows = list(csv.DictReader(f))
            require(len(rows) == 1 and all(math.isfinite(float(rows[0][k])) for k in (
                "train/loss_actor", "train/loss_critic")), "ddpg: logged losses not finite")
            model_l, out_l = run_cli(argv + ["--num_timesteps=0", f"--load_path={path}",
                                             f"--log_path={os.path.join(tmp, 'ddpg_l')}"])
            trees = model_c._ckpt_tree(), model_l._ckpt_tree()
            require(all(same_params(trees[0][k], trees[1][k]) for k in (
                "actor", "critic", "target_actor", "target_critic"))
                and same_rms(trees[0]["obs_rms"], trees[1]["obs_rms"])
                and same_rms(trees[0]["ret_rms"], trees[1]["ret_rms"]),
                "ddpg: the loaded model differs from the saved one")
            require(play_report(out_l) == play_report(out_c),
                    f"ddpg: play after load {play_report(out_l)}, after training "
                    f"{play_report(out_c)}")
            print(f"main path 7c [{card}]: ddpg on Pendulum-v1 through run.main, 4000 env "
                  f"steps and 500 train steps, launches {c}; {elapsed:.2f} s with save and "
                  f"play = {4000 / elapsed:.0f} env-steps/s (set-up included); losses actor "
                  f"{float(rows[0]['train/loss_actor']):.4f}, critic "
                  f"{float(rows[0]['train/loss_critic']):.4f}; return history "
                  f"{float(rows[0]['rollout/return_history']):.1f}; the load round trip bit for "
                  f"bit (obs_rms count {float(trees[1]['obs_rms'].count):.0f}), "
                  f"{play_report(out_l)}; {peak_gib()}", flush=True)
            del model_c, model_l, trees

            # parameter noise: ddpg with adaptive-param_0.2 and layer norms on
            # BoxIdentity-v0 (the testing defaults), then deepq with param_noise
            recorder = RecordingOutput()
            logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
            start = begin()
            model = ddpg.learn(env_id="BoxIdentity-v0", num_envs=4, gamma=0.9, layer_norm=True,
                               noise_type="adaptive-param_0.2", nb_epoch_cycles=4,
                               total_timesteps=1600, seed=0)
            torch.cuda.synchronize()
            ddpg_s = time.perf_counter() - start
            logger.reset()
            counts["ddpg_param_noise"] = c_pn = read_counts()
            ddpg_peak = peak_gib()
            stddev = float(model.state.param_noise_stddev)
            require(math.isfinite(stddev) and stddev != 0.2 and len(recorder.rows) == 1
                    and math.isfinite(recorder.rows[0]["param_noise_stddev"]),
                    f"ddpg with parameter noise: stddev {stddev}")
            logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[])
            start = begin()
            model = dqn.learn(env_id="CartPole-v1", param_noise=True, total_timesteps=1280,
                              gamma=0.99, seed=0, print_freq=0)
            torch.cuda.synchronize()
            dqn_s = time.perf_counter() - start
            logger.reset()
            counts["deepq_param_noise"] = c_dq = read_counts()
            scale = float(model.state.param_noise_scale)
            require(math.isfinite(scale) and scale != 0.01 and c_dq["take_rows"] == 5 * 281,
                    f"deepq with param_noise: scale {scale}, launches {c_dq}")
            print(f"main path 7c [{card}]: ddpg adaptive-param_0.2 with layer norms on "
                  f"BoxIdentity-v0, 1600 steps in {ddpg_s:.2f} s = {1600 / ddpg_s:.0f} "
                  f"env-steps/s (set-up included), launches {c_pn}, param_noise_stddev "
                  f"{stddev:.5f}, {ddpg_peak}", flush=True)
            print(f"main path 7c [{card}]: deepq param_noise on CartPole-v1, 1280 steps in "
                  f"{dqn_s:.2f} s = {1280 / dqn_s:.0f} env-steps/s (set-up included), launches "
                  f"{c_dq}, param_noise_scale {scale:.5f}, {peak_gib()}", flush=True)
            del model

            # d. her on PointReach-v0 through run.main with tests/test_her_learning.py's
            # configuration (16 envs, 10 cycles, 40 batches of 256, 3 x 256 relu, 200000
            # steps), saved and played on dict observations, then the file back
            path = os.path.join(tmp, "her.pt")
            argv = ["--alg=her", "--env=PointReach-v0", "--seed=0", "--num_env=16",
                    "--n_cycles=10", "--n_batches=40", "--batch_size=256", "--play"]
            start = begin()
            model_d, out_d = run_cli(argv + ["--num_timesteps=200000", f"--save_path={path}",
                                             f"--log_path={os.path.join(tmp, 'her')}"])
            elapsed = time.perf_counter() - start
            counts["cli_her"] = c = read_counts()
            epochs = 200000 // (10 * 16 * 50)
            require(c["take_rows"] == 6 * epochs * 10 * 40, f"her launched {c}, expected "
                    f"{6 * epochs * 400} take_rows (6 reads a train step)")
            env = PointReach()
            draws = Draws(5, dev)
            obs, st = env.reset(draws, 64, dev)
            for _ in range(50):
                obs, st, _, _, info = env.step(draws, st, model_d.policy.mode_step(obs)[0])
            success = float(info["is_success"].float().mean())
            require(success > 0.5, f"her on PointReach: deterministic success {success}")
            with open(os.path.join(tmp, "her", "progress.csv"), newline="") as f:
                rows = list(csv.DictReader(f))
            model_l, out_l = run_cli(argv + ["--num_timesteps=0", f"--load_path={path}",
                                             f"--log_path={os.path.join(tmp, 'her_l')}"])
            require(same_params(model_d.policy.module, model_l.policy.module)
                    and same_rms(model_d.state.o_rms, model_l.state.o_rms)
                    and same_rms(model_d.state.g_rms, model_l.state.g_rms),
                    "her: the loaded actor or normalizers differ from the saved ones")
            require(play_report(out_l) == play_report(out_d),
                    f"her: play after load {play_report(out_l)}, after training "
                    f"{play_report(out_d)}")
            # where a cycle's time goes: one more cycle of the trained model under the
            # profiler, its device time against its wall time, and the host's top ops
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model_d.cycle(model_d.state, Draws(7, dev))
                torch.cuda.synchronize()
                cycle_s = time.perf_counter() - t0
            events = prof.key_averages()
            device_ms = sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3
            ops = sum(e.count for e in events if e.key.startswith("aten::"))
            top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
            print(f"main path 7d profile [{card}]: one cycle (16 episodes of 50 steps, 40 "
                  f"train steps) {cycle_s * 1e3:.1f} ms wall, {device_ms:.1f} ms of device "
                  f"time ({1 - device_ms / (cycle_s * 1e3):.1%} idle), {ops} aten calls; top "
                  f"host self times: " + "; ".join(
                      f"{e.key} x{e.count} {e.self_cpu_time_total / 1e3:.1f} ms" for e in top),
                  flush=True)
            print(f"main path 7d [{card}]: her on PointReach-v0 through run.main, {epochs} "
                  f"epochs of 10 cycles x (16 episodes of 50 steps, 40 train steps), launches "
                  f"{c}; {elapsed:.2f} s with save and play = {200000 / elapsed:.0f} "
                  f"env-steps/s (set-up included); deterministic success {success} over 64 "
                  f"episodes; test/success_rate by epoch "
                  f"{[float(r['test/success_rate']) for r in rows]}; the load round trip bit "
                  f"for bit, {play_report(out_l)}; {peak_gib()}", flush=True)
            del model_d, model_l
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # e. the gather at this path's new shapes: 64 rows of ddpg's (10^6, 3) f32 ring
        # (Pendulum's obs), and 256 rows of her's flattened (10000 * 51, 2) f32 obs rows
        gen = torch.Generator(device=dev).manual_seed(12)
        path7_shapes = []
        for rows_n, width, batch, what in ((10**6, 3, 64, "ddpg ring obs"),
                                           (10000 * 51, 2, 256, "her flattened o rows")):
            x = torch.randn((rows_n, width), device=dev, generator=gen)
            idx = torch.randint(0, rows_n, (batch,), device=dev, generator=gen)
            require(torch.equal(take_rows(x, idx), x[idx]),
                    f"take_rows on {what} differs from x[idx]")
            t, readings = turns_ms({"kernel": lambda: take_rows(x, idx),
                                    "plain": lambda: x[idx],
                                    "index_select": lambda: x.index_select(0, idx)}, 50,
                                   rounds=3)
            bms, by = bound_ms(0, 2 * batch * width * 4 + batch * 8)
            shape = f"{what}: f32 {tuple(x.shape)} by ({batch},) int64"
            path7_shapes.append(dict(shape=shape, max_abs_err=0.0, ms=t["kernel"],
                                     plain_ms=t["plain"], bound_ms=bms, bound_by=by,
                                     library_ms=t["index_select"]))
            print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms, "
                  f"plain x[idx] {t['plain']:.4f} ms, index_select {t['index_select']:.4f} "
                  f"ms, bound {bms:.6f} ms ({by}); in turns: "
                  f"{lead(readings, 'kernel', 'index_select')} [{card}]", flush=True)
            del x, idx
        kernels["take_rows"]["path7_shapes"] = path7_shapes

    with Phase("main path 8: acer, acktr and gail"):
        import numpy as np

        from baselines_tpu_torch.algos.acer import acer
        from baselines_tpu_torch.algos.acer.defaults import atari as acer_atari_defaults
        from baselines_tpu_torch.algos.acktr import acktr
        from baselines_tpu_torch.algos.acktr.defaults import atari as acktr_atari_defaults

        def replays(updates: int, steps_per_update: int, replay_start: int) -> int:
            """The replay updates acer draws in ``updates`` updates: numpy's
            RandomState(0), one Poisson(4) an update from replay_start on."""
            rng = np.random.RandomState(0)
            return sum(rng.poisson(4) for u in range(1, updates + 1)
                       if u * steps_per_update >= replay_start)

        def check_rows(rows, keys, what):
            require(rows and all(math.isfinite(float(r[k])) for r in rows for k in keys),
                    f"{what}: a logged metric is missing or not finite")

        tmp = tempfile.mkdtemp(prefix="chip_smoke_slice8_")
        try:
            # a. acer on AtariSim-v0 at acer/defaults.py atari() (cnn, 16 envs x 20 steps,
            # lrschedule constant), buffer_size 50000 (a ring of 2500 flat chunks),
            # replay_ratio 4, replay_start 10000, the trust region on: 40 updates, replay
            # from update 32 on (a depth cut, to keep the phase's time)
            updates = 40
            recorder = RecordingOutput()
            logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
            start = begin()
            model = acer.learn(env_id="AtariSim-v0", total_timesteps=updates * 320, seed=0,
                               buffer_size=50000, replay_ratio=4, replay_start=10000,
                               log_interval=16, **acer_atari_defaults())
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            logger.reset()
            counts["acer_atari"] = c = read_counts()
            n_replay = replays(updates, 320, 10000)
            require(c["take_rows"] == 5 * n_replay, f"acer on AtariSim launched {c}, expected "
                    f"{5 * n_replay} take_rows (5 fields x {n_replay} replay updates)")
            check_rows(recorder.rows, ("loss_policy", "loss_q", "entropy"), "acer on AtariSim")
            require(all(bool(torch.isfinite(p).all()) for p in model.state.avg.parameters()),
                    "acer on AtariSim: the average params are not finite")
            ring = model.state.replay.data["obs"]
            require(tuple(ring.shape) == (2500, 592704) and ring.dtype == torch.uint8,
                    f"acer's obs ring is {ring.dtype} {tuple(ring.shape)}")
            print(f"main path 8a [{card}]: acer cnn on AtariSim-v0, 16 x 20, {updates} updates "
                  f"and {n_replay} replay updates, launches {c}; {elapsed:.2f} s for "
                  f"{updates * 320} env steps = {updates * 320 / elapsed:.0f} env-steps/s "
                  f"(set-up included); loss_policy "
                  f"{[round(r['loss_policy'], 4) for r in recorder.rows]}, loss_q "
                  f"{[round(r['loss_q'], 4) for r in recorder.rows]}; {peak_gib()}", flush=True)
            # K2 on 16 rows of that ring: timed warm (the same 16 rows each call, 19 MB
            # that stay in the 50 MB L2) and cold (20 calls on 20 disjoint sets of 16
            # rows, 190 MB, so that each call reads its rows from device memory)
            gen = torch.Generator(device=dev).manual_seed(13)
            sets = torch.randperm(2500, device=dev, generator=gen)[:320].reshape(20, 16)
            idx = sets[0].contiguous()
            require(torch.equal(take_rows(ring, idx), ring[idx]),
                    "take_rows on acer's flat obs rows differs from x[idx]")
            cold = [sets[i].contiguous() for i in range(20)]

            def cycling(fn):
                it = iter(cold * 1000)
                return lambda: fn(next(it))

            t_warm, _ = turns_ms({"kernel": lambda: take_rows(ring, idx),
                                  "index_select": lambda: ring.index_select(0, idx)}, 20)
            t, readings = turns_ms({"kernel": cycling(lambda i: take_rows(ring, i)),
                                    "plain": cycling(lambda i: ring[i]),
                                    "index_select": cycling(lambda i: ring.index_select(0, i))},
                                   20, rounds=3)
            bms, by = bound_ms(0, 2 * 16 * 592704 + 16 * 8)
            shape = "acer's flat obs ring: u8 (2500, 592704) by (16,) int64, rows read cold"
            kernels["take_rows"]["path8_shapes"] = [dict(
                shape=shape, max_abs_err=0.0, ms=t["kernel"], plain_ms=t["plain"],
                bound_ms=bms, bound_by=by, library_ms=t["index_select"])]
            print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms, "
                  f"plain x[idx] {t['plain']:.4f} ms, index_select {t['index_select']:.4f} "
                  f"ms, bound {bms:.6f} ms ({by}), {bms / t['kernel']:.1%} of it; in turns: "
                  f"{lead(readings, 'kernel', 'index_select')}; the same 16 rows warm in L2: "
                  f"kernel {t_warm['kernel']:.4f} ms, index_select "
                  f"{t_warm['index_select']:.4f} ms [{card}]", flush=True)
            del model, ring

            # b. acer with mlp on CartPole-v1 through run.main with
            # tests/test_acer_learning.py:108-128's configuration: 4 envs, a 2-frame stack
            # stored deduplicated, replay_start 2000, buffer_size 10000; 72000 steps where
            # the test runs 120000, to keep the script's time (80000 until phase 15
            # came; the return it checks is reached by then)
            path = os.path.join(tmp, "acer.pt")
            steps = 72000
            argv = ["--alg=acer", "--env=CartPole-v1", "--seed=0", "--num_env=4",
                    "--frame_stack=2", "--dedup_frames=2", "--play"]
            start = begin()
            model_b, out_b = run_cli(argv + [f"--num_timesteps={steps}", "--replay_start=2000",
                                             "--buffer_size=10000", f"--save_path={path}",
                                             f"--log_path={os.path.join(tmp, 'acer')}"])
            elapsed = time.perf_counter() - start
            counts["cli_acer"] = c = read_counts()
            n_replay = replays(steps // 80, 80, 2000)
            require(c["take_rows"] == 6 * n_replay, f"acer on CartPole launched {c}, expected "
                    f"{6 * n_replay} take_rows (6 fields x {n_replay} replay updates)")
            ret, length, episodes = evaluate(
                model_b, build_env("CartPole-v1", 4, device=dev, frame_stack=2), Draws(1, dev),
                nsteps=600)
            require(ret > 100, f"acer on CartPole: deterministic return {ret}, want > 100")
            with open(os.path.join(tmp, "acer", "progress.csv"), newline="") as f:
                curve = [(int(float(r["total_timesteps"])), round(float(r["mean_episode_reward"]), 1))
                         for r in csv.DictReader(f)]
            model_l, out_l = run_cli(argv + ["--num_timesteps=0", f"--load_path={path}",
                                             f"--log_path={os.path.join(tmp, 'acer_l')}"])
            require(same_params(model_b.policy.module, model_l.policy.module),
                    "acer: the loaded params differ from the saved ones")
            require(play_report(out_l) == play_report(out_b),
                    f"acer: play after load {play_report(out_l)}, after training "
                    f"{play_report(out_b)}")
            print(f"main path 8b [{card}]: acer mlp on CartPole-v1 (2-frame stack, dedup) "
                  f"through run.main, {steps // 80} updates and {n_replay} replay updates, "
                  f"launches {c}; {elapsed:.2f} s with save and play = {steps / elapsed:.0f} "
                  f"env-steps/s (set-up included); deterministic return {ret} (len {length}, "
                  f"{episodes} episodes of 4 envs x 600 steps); mean_episode_reward by steps "
                  f"{curve}; the load round trip bit for bit, {play_report(out_l)}; "
                  f"{peak_gib()}", flush=True)
            del model_b, model_l

            # c. acktr on AtariSim-v0 at acktr/defaults.py atari() (the Nature cnn on 84x84x4
            # u8, 20 steps, eigendecompositions every 10 updates), 8 envs, 20 updates
            recorder = RecordingOutput()
            logger.Logger.CURRENT = logger.Logger(dir=None, output_formats=[recorder])
            start = begin()
            model = acktr.learn(env_id="AtariSim-v0", num_envs=8, total_timesteps=20 * 160,
                                seed=0, log_interval=1, **acktr_atari_defaults())
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            logger.reset()
            counts["acktr_atari"] = c = read_counts()
            check_rows(recorder.rows, ("policy_loss", "value_loss", "policy_entropy"),
                       "acktr on AtariSim")
            kf = model.state.kfac
            require(kf.step == 20 and all(
                bool(torch.isfinite(x).all()) and float(x.min()) >= 0
                for lay in kf.layers for x in (lay.lamA, lay.lamS)),
                "acktr on AtariSim: the factors' spectra are not finite and clamped")
            dense_a = kf.layers[3].A
            require(tuple(dense_a.shape) == (3137, 3137), f"acktr's first dense factor is "
                    f"{tuple(dense_a.shape)}")
            eigh_ms = time_ms(lambda: torch.linalg.eigh(dense_a), 3)
            print(f"main path 8c [{card}]: acktr cnn on AtariSim-v0, 8 x 20, 20 updates (2 "
                  f"eigendecomposition rounds), launches {c}; {elapsed:.2f} s for 3200 env "
                  f"steps = {3200 / elapsed:.0f} env-steps/s (set-up included); policy_loss "
                  f"{[round(r['policy_loss'], 4) for r in recorder.rows[::5]]}; eigh of the "
                  f"(3137, 3137) first-dense factor {eigh_ms:.2f} ms; the spectra "
                  f"{float(min(x.min() for lay in kf.layers for x in (lay.lamA, lay.lamS))):.3g}"
                  f" to {float(max(x.max() for lay in kf.layers for x in (lay.lamA, lay.lamS))):.3g}"
                  f"; {peak_gib()}", flush=True)
            del model, kf, dense_a

            # acktr with mlp on DiscreteIdentity-v0 through run.main with
            # tests/test_acktr_learning.py:19-32's configuration (the testing defaults:
            # 8 envs x 20 steps, gamma 0.9), 60000 steps
            path = os.path.join(tmp, "acktr.pt")
            argv = ["--alg=acktr", "--env=DiscreteIdentity-v0", "--seed=0", "--play"]
            start = begin()
            model_c, out_c = run_cli(argv + ["--num_timesteps=60000", f"--save_path={path}",
                                             f"--log_path={os.path.join(tmp, 'acktr')}"])
            elapsed = time.perf_counter() - start
            counts["cli_acktr"] = c = read_counts()
            ret, length, episodes = evaluate(model_c, build_env("DiscreteIdentity-v0", 8,
                                                                device=dev),
                                             Draws(1, dev), nsteps=300)
            require(ret > 90, f"acktr on DiscreteIdentity: deterministic return {ret}, want > 90")
            model_l, out_l = run_cli(argv + ["--num_timesteps=0", f"--load_path={path}",
                                             f"--log_path={os.path.join(tmp, 'acktr_l')}"])
            require(same_params(model_c.policy.module, model_l.policy.module),
                    "acktr: the loaded params differ from the saved ones")
            require(play_report(out_l) == play_report(out_c),
                    f"acktr: play after load {play_report(out_l)}, after training "
                    f"{play_report(out_c)}")
            print(f"main path 8c [{card}]: acktr mlp on DiscreteIdentity-v0 through run.main, "
                  f"{60000 // 160} updates, launches {c}; {elapsed:.2f} s with save and play = "
                  f"{60000 / elapsed:.0f} env-steps/s (set-up included); deterministic return "
                  f"{ret} (len {length}, {episodes} episodes of 8 envs x 300 steps); the load "
                  f"round trip bit for bit, {play_report(out_l)}; {peak_gib()}", flush=True)
            del model_c, model_l

            # d. gail on BoxIdentity-v0 through run.main with --expert_path: an .npz in the
            # reference schema, 5000 observations uniform in [-1, 1] from seed 0 with acs =
            # obs (tests/test_gail_learning.py:24-27), and that test's configuration
            expert = np.random.RandomState(0).uniform(-1, 1, size=(1, 5000, 1)).astype(np.float32)
            expert_path = os.path.join(tmp, "expert.npz")
            np.savez(expert_path, obs=expert, acs=expert.copy())
            path = os.path.join(tmp, "gail.pt")
            steps = 80000  # 100000 until phase 15 came, cut to keep the script's time
            argv = ["--alg=gail", "--env=BoxIdentity-v0", "--seed=0", "--num_env=8",
                    "--timesteps_per_batch=512", "--gamma=0.9", "--lam=0.97", "--max_kl=0.01",
                    "--g_step=1", "--d_step=3", f"--expert_path={expert_path}", "--play"]
            start = begin()
            model_d, out_d = run_cli(argv + [f"--num_timesteps={steps}", f"--save_path={path}",
                                             f"--log_path={os.path.join(tmp, 'gail')}"])
            elapsed = time.perf_counter() - start
            counts["cli_gail"] = c = read_counts()
            iters = steps // 512
            require(model_d.state.iters == iters and c["take_rows"] == iters * (5 * 2 + 2),
                    f"gail launched {c} in {model_d.state.iters} iterations, expected "
                    f"{iters * 12} take_rows (10 in the value fit and 2 for the expert sample "
                    "an iteration)")
            ret, length, episodes = evaluate(model_d, build_env("BoxIdentity-v0", 8, device=dev),
                                             Draws(3, dev), nsteps=300)
            require(ret > -10, f"gail on BoxIdentity: deterministic return {ret}, want > -10")
            with open(os.path.join(tmp, "gail", "progress.csv"), newline="") as f:
                rows = list(csv.DictReader(f))
            model_l, out_l = run_cli(argv + ["--num_timesteps=0", f"--load_path={path}",
                                             f"--log_path={os.path.join(tmp, 'gail_l')}"])
            require(same_params(model_d.policy.module, model_l.policy.module)
                    and same_params(model_d.disc, model_l.disc)
                    and same_rms(model_d.state.d_obs_rms, model_l.state.d_obs_rms)
                    and model_l.state.iters == iters
                    and model_d.d_opt.count == model_l.d_opt.count == 3 * iters
                    and all(torch.equal(x, y) for x, y in zip(
                        model_d.d_opt.mu + model_d.d_opt.nu + model_d.opt.mu + model_d.opt.nu,
                        model_l.d_opt.mu + model_l.d_opt.nu + model_l.opt.mu + model_l.opt.nu)),
                    "gail: the loaded model or adversary differs from the saved one")
            require(play_report(out_l) == play_report(out_d),
                    f"gail: play after load {play_report(out_l)}, after training "
                    f"{play_report(out_d)}")
            print(f"main path 8d [{card}]: gail mlp on BoxIdentity-v0 through run.main, {iters} "
                  f"iterations of 8 x 64, launches {c}; {elapsed:.2f} s with save and play = "
                  f"{steps / elapsed:.0f} env-steps/s (set-up included); deterministic return "
                  f"{ret} (len {length}, {episodes} episodes of 8 envs x 300 steps); "
                  f"EpTrueRewMean {[round(float(r['EpTrueRewMean']), 2) for r in rows[::40]]}, "
                  f"d accuracies {float(rows[-1]['d_gen_acc']):.3f} / "
                  f"{float(rows[-1]['d_exp_acc']):.3f}; the load round trip bit for bit "
                  f"(adversary and iters), {play_report(out_l)}; {peak_gib()}", flush=True)
            del model_d, model_l
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # e. the gather at gail's shapes: the value fit's f32 (512, 1) obs rows by a
        # 512-row permutation, and the expert sample, 512 rows of the (5000, 1) f32 table
        gen = torch.Generator(device=dev).manual_seed(14)
        for rows_n, what, idx in (
                (512, "gail's value-fit obs", torch.randperm(512, device=dev, generator=gen)),
                (5000, "gail's expert obs", torch.randint(0, 5000, (512,), device=dev,
                                                          generator=gen))):
            x = torch.randn((rows_n, 1), device=dev, generator=gen)
            require(torch.equal(take_rows(x, idx), x[idx]), f"take_rows on {what} differs")
            t, readings = turns_ms({"kernel": lambda: take_rows(x, idx),
                                    "plain": lambda: x[idx],
                                    "index_select": lambda: x.index_select(0, idx)}, 50,
                                   rounds=3)
            bms, by = bound_ms(0, 2 * 512 * 4 + 512 * 8)
            shape = f"{what}: f32 {tuple(x.shape)} by (512,) int64"
            kernels["take_rows"]["path8_shapes"].append(dict(
                shape=shape, max_abs_err=0.0, ms=t["kernel"], plain_ms=t["plain"],
                bound_ms=bms, bound_by=by, library_ms=t["index_select"]))
            print(f"take_rows {shape}: bit-exact; device times: kernel {t['kernel']:.4f} ms, "
                  f"plain x[idx] {t['plain']:.4f} ms, index_select {t['index_select']:.4f} "
                  f"ms, bound {bms:.6f} ms ({by}); in turns: "
                  f"{lead(readings, 'kernel', 'index_select')} [{card}]", flush=True)

    with Phase("main path 9: the host env path (native engine, pipelined ppo2, profiler)"):
        host_env_path(dev, card, kernels, counts, reset_counts, read_counts, run_cli,
                      play_report, RecordingOutput)

    with Phase("main path 10: the remaining learners under a one-rank NCCL mesh"):
        mesh_learners_path(dev, card, counts, reset_counts, read_counts, RecordingOutput)

    with Phase("main path 11: the host side (the Atari chain, a host env under a mesh)"):
        host_side_path(dev, card, kernels, counts, reset_counts, read_counts, RecordingOutput)

    with Phase("main path 12: the examples and the results tools"):
        examples_path(dev, card, kernels, counts, reset_counts, read_counts, RecordingOutput)

    with Phase("main path 13: the API surface"):
        api_surface_path(dev, card, kernels, counts, reset_counts, read_counts,
                         RecordingOutput)

    for name, entry in kernels.items():
        entry["launches_by_path"] = {path: counts[path][name] for path in counts}
        entry["launches"] = sum(entry["launches_by_path"].values())
    order = ("name", "route", "source", "replaces", "shape", "launches", "launches_by_path",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "cartpole_shapes", "path4_shapes", "path4_shape", "path5_shapes", "path5_shape",
             "path7_shapes", "path8_shapes", "path9_shapes", "path11_shapes",
             "path12_shapes", "path13_shapes")
    line = {"kernels": [{k: kernels[name][k] for k in order if k in kernels[name]}
                        for name in launchers]}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
