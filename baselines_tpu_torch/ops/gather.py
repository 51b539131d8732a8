"""Row gather for the epoch shuffle, as one CUDA kernel.

Replaces the Pallas kernel ``_gather_rows_kernel`` of ``baselines_tpu/ops/gather.py``
(reached there through ``take_rows``), a ring of per-row DMAs. ``take_rows(x, idx)``
returns ``x[idx]`` along the first axis, bit for bit, for rows of any shape and dtype.

What bounds it on an H100: it is a pure copy, so device-memory bytes, each selected row
read once and written once; for the PPO obs (32768 rows of 28,224 bytes) that is
1.85 GB, or 552 us at 3.35 TB/s. The kernel (``csrc/gather.cu``) treats a row as flat
bytes and moves it in the widest unit its width and addresses allow, 16-byte vectors
for the obs, with neighbouring threads on neighbouring units and several rows a block.
"""

from __future__ import annotations

import math

import torch

from baselines_tpu_torch.ops import cuda_lib


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = x[idx[i]]: x (N, ...) contiguous, idx (M,) int64.

    On CUDA tensors this launches the kernel, where an index outside [0, N) gives a
    row of zeros; on CPU tensors it runs the plain version, ``index_select``, which
    raises on such an index."""
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError(f"take_rows takes a 1-D int64 index, got {idx.dtype} {tuple(idx.shape)}")
    if x.dim() < 1 or not x.is_contiguous() or not idx.is_contiguous():
        raise ValueError("take_rows takes a contiguous x of rank >= 1 and a contiguous index")
    if x.device != idx.device:
        raise ValueError(f"x is on {x.device}, idx on {idx.device}")
    if x.device.type == "cpu":
        return x.index_select(0, idx)
    if x.device.type != "cuda":
        raise ValueError(f"take_rows runs on cuda or cpu, not {x.device}")
    out = torch.empty((idx.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    row_bytes = math.prod(x.shape[1:]) * x.element_size()
    if out.numel() == 0:
        return out
    err = cuda_lib.library().btt_gather_rows(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], idx.shape[0], row_bytes,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(err, "take_rows")
    take_rows.launches += 1
    return out


take_rows.launches = 0
