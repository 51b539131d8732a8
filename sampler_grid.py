#!/usr/bin/env python3
"""Time the stratified sampler's one launch (baselines_tpu_torch/csrc/stratified_sample.cu)
at every grid it could take, on one NVIDIA card.

    python3 sampler_grid.py

The wrapper picks the grid by a rule (`choose_grid` in the source): clusters of 8 or 16
blocks, and how many clusters. This script builds the same source once more with a C
entry that takes the grid as arguments (into the git-ignored build directory), checks
every grid bit for bit against the plain version on integer priorities, and prints the
device time of each grid, the wrapper's, and torch's cumsum + searchsorted, by CUDA
graphs taken in turns, at deepq's 10240 slots and at a million slots with 32, 256 and
1024 targets. It exits nonzero without a card or on a mismatch.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs

GRIDS = [(clusters, cluster) for cluster in (8, 16) for clusters in (1, 2, 4, 8)]
SHAPES = [(10240, 256), (10240, 1024), (2 ** 20, 32), (2 ** 20, 256), (2 ** 20, 1024)]
ENTRY = """
#include "{source}"
extern "C" int grid_launch(const void* p, const void* u, int nblocks, int batch, void* out,
                           int clusters, int cluster, void* stream) {{
  return launch(static_cast<const float*>(p), static_cast<const float*>(u), nblocks, batch,
                static_cast<int*>(out), nullptr, clusters, cluster,
                static_cast<cudaStream_t>(stream));
}}
"""


def build_grid_entry():
    from baselines_tpu_torch.ops import cuda_lib

    source = cuda_lib.CSRC_DIR / "stratified_sample.cu"
    cuda_lib.BUILD_DIR.mkdir(exist_ok=True)
    entry = cuda_lib.BUILD_DIR / "sampler_grid.cu"
    entry.write_text(ENTRY.format(source=source))
    lib_path = cuda_lib.BUILD_DIR / "libsampler_grid.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(entry)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.grid_launch.argtypes = [vp, vp, ci, ci, vp, ci, ci, vp]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("sampler_grid: no CUDA device", file=sys.stderr)
        return 1
    from baselines_tpu_torch.ops import stratified_sample as ss

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = build_grid_entry()
    dev = torch.device("cuda")

    def run(prios, u, batch, clusters, cluster, out):
        err = lib.grid_launch(prios.data_ptr(), u.data_ptr(), prios.shape[0] // ss.BLOCK, batch,
                              out.data_ptr(), clusters, cluster,
                              torch.cuda.current_stream().cuda_stream)
        cs.require(err == 0, f"grid {clusters} x {cluster}: CUDA error {err}")
        return out

    for n, batch in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n + batch)
        ints = torch.randint(0, 4, (n,), generator=gen, device=dev).float()
        u = torch.rand(batch, generator=gen, device=dev)
        want = ss.plain_stratified_sample(ints, u, batch)
        out = torch.empty(batch, dtype=torch.int32, device=dev)
        for clusters, cluster in GRIDS:
            got = run(ints, u, batch, clusters, cluster, out)
            cs.require(torch.equal(got, want),
                       f"grid {clusters} x {cluster} at N={n}, B={batch}: not bit-exact")
        prios = torch.randn(n, generator=gen, device=dev).abs()
        total = torch.cumsum(prios.double(), 0)[-1].float()
        targets = ss.stratified_targets(total.view(1), u, batch)
        fns = {"wrapper": lambda: ss.stratified_sample(prios, u, batch),
               "cumsum+searchsorted": lambda: torch.searchsorted(torch.cumsum(prios, 0), targets,
                                                                 right=True)}
        for clusters, cluster in GRIDS:
            fns[f"{clusters}x{cluster}"] = (
                lambda clusters=clusters, cluster=cluster: run(prios, u, batch, clusters, cluster,
                                                               out))
        t, _ = cs.turns_ms(fns, 50)
        print(f"N={n} B={batch} [{card}] device ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
