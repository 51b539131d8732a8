#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (baselines_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. device: the card's name and count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the port's kernel library (seconds and -Xptxas -v lines);
  3. the fused CNN forward kernel against its plain version, at batch 256 and 8192;
  4. the row-gather kernel against x[idx], on the PPO obs and on one f32 field;
  5. the main path: two full-width ppo2 updates (256 envs x 128 steps, cnn_s2d in bf16,
     AtariSim-v0 packed 4x4 space-to-depth), whose launch counts show both kernels on
     the path and whose logged losses must be finite.
Then one JSON line with every kernel's numbers, and last the contract line
{"ok": true, "device": {...}}. Any failed check raises, and the script exits nonzero.
It exits nonzero before building anything when there is no CUDA device.
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
        from baselines_tpu_torch.algos.ppo.ppo import learn
        from baselines_tpu_torch.core import logger
        from baselines_tpu_torch.nn.networks import NatureCNNS2D
        from baselines_tpu_torch.ops import cuda_lib
        from baselines_tpu_torch.ops.fused_cnn import (
            FC_IN, FC_OUT, fused_cnn_forward, pack_params, reference_forward,
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
    with Phase("fused_cnn vs plain"):
        for batch in (256, 8192):
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
            iters = 50 if batch <= 256 else 10
            ms = time_ms(lambda: fused_cnn_forward(x, packed), iters)
            plain_ms = time_ms(lambda: reference_forward(x, packed), iters)
            with torch.no_grad():
                library_ms = time_ms(lambda: net(x), iters)
            flops = batch * 2 * (400 * 32 * 256 + 81 * 64 * 512 + 49 * 64 * 576 + FC_IN * FC_OUT)
            nbytes = x.numel() + sum(p.numel() * p.element_size() for p in packed) + got.numel() * 4
            bms, by = bound_ms(flops, nbytes)
            print(f"fused_cnn B={batch}: max abs err {abs_err:.3g}, rel err {rel_err:.3g} "
                  f"(tol {K1_REL_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"cuDNN bf16 module {library_ms:.4f} ms, bound {bms:.4f} ms ({by}) "
                  f"[{card}]", flush=True)
            if batch == 256:  # the main path's shape
                kernels["fused_cnn"] = dict(
                    name="fused_cnn_forward", route="cuda",
                    source="baselines_tpu_torch/csrc/fused_cnn.cu",
                    replaces="baselines_tpu/ops/fused_cnn.py:145", shape=f"B={batch}",
                    max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=library_ms,
                )
            del x, net, packed, got, want

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
        abs_err = float((got.float() - obs[idx].float()).abs().max())
        ms = time_ms(lambda: take_rows(obs, idx), 20)
        plain_ms = time_ms(lambda: obs.index_select(0, idx), 20)
        library_ms = time_ms(lambda: torch.index_select(obs, 0, idx), 20)
        nbytes = 2 * obs.numel() + idx.numel() * 8
        bms, by = bound_ms(0, nbytes)
        field_ms = time_ms(lambda: take_rows(field, idx), 50)
        print(f"take_rows obs (32768, 21, 21, 64) u8: bit-exact; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, index_select {library_ms:.4f} ms, bound {bms:.4f} ms ({by}); "
              f"f32 (32768,) field: bit-exact, kernel {field_ms:.4f} ms [{card}]", flush=True)
        kernels["take_rows"] = dict(
            name="take_rows", route="cuda", source="baselines_tpu_torch/csrc/gather.cu",
            replaces="baselines_tpu/ops/gather.py:67", shape="obs (32768, 21, 21, 64) u8",
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=library_ms,
        )
        del obs, idx, field, got

    with Phase("main path: ppo2 learn, 2 updates of 256 x 128"):
        class RecordingOutput(logger.KVWriter):
            """A logger output that keeps every dumped row."""

            def __init__(self):
                self.rows = []

            def writekvs(self, kvs):
                self.rows.append(dict(kvs))

        recorder = RecordingOutput()
        logger.Logger.CURRENT = logger.Logger(
            dir=None, output_formats=[logger.HumanOutputFormat(sys.stdout), recorder])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fused_cnn_forward.launches = 0
        take_rows.launches = 0
        start = time.perf_counter()
        model = learn(
            env_id="AtariSim-v0", network="cnn_s2d", dtype=torch.bfloat16,
            env_kwargs={"s2d": 4}, num_envs=256, nsteps=128, nminibatches=4, noptepochs=4,
            total_timesteps=2 * 32768, seed=0, log_interval=1,
        )
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        k1, k2 = fused_cnn_forward.launches, take_rows.launches
        kernels["fused_cnn"]["launches"] = k1
        kernels["take_rows"]["launches"] = k2
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

    order = ("name", "route", "source", "replaces", "shape", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{k: kernels[name][k] for k in order}
                        for name in ("fused_cnn", "take_rows")]}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
