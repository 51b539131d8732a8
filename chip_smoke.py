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
     iterations), whose launch counts show all three kernels on the path.
Then one JSON line with every kernel's numbers (launches summed over both main paths,
and by path), and last the contract line {"ok": true, "device": {...}}. Any failed
check raises, and the script exits nonzero. It exits nonzero before building anything
when there is no CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
        from baselines_tpu_torch.algos.ppo.ppo import learn
        from baselines_tpu_torch.core import logger
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
        # dqn/defaults.py:4-18 (Atari), with cnn_s2d in bf16 for conv_only (not ported),
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

    for name, entry in kernels.items():
        entry["launches_by_path"] = {path: counts[path][name] for path in counts}
        entry["launches"] = sum(entry["launches_by_path"].values())
    order = ("name", "route", "source", "replaces", "shape", "launches", "launches_by_path",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{k: kernels[name][k] for k in order} for name in launchers]}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
