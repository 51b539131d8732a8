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


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            print(f"[phase] {self.name}: {time.perf_counter() - self.start:.2f} s", flush=True)


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
        from baselines_tpu_torch.algos.ppo.ppo import learn
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

    for name, entry in kernels.items():
        entry["launches_by_path"] = {path: counts[path][name] for path in counts}
        entry["launches"] = sum(entry["launches_by_path"].values())
    order = ("name", "route", "source", "replaces", "shape", "launches", "launches_by_path",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "cartpole_shapes", "path4_shapes", "path4_shape", "path5_shapes", "path5_shape")
    line = {"kernels": [{k: kernels[name][k] for k in order if k in kernels[name]}
                        for name in launchers]}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
