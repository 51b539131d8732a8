"""Two-level stratified sampling from a priority vector, as two CUDA kernels.

Replaces the Pallas kernels of ``baselines_tpu/data/pallas_sampler.py`` (reached there
through ``pallas_stratified_sample``): ``block_sums`` replaces ``_block_sums_kernel``
and ``stratified_search`` replaces ``_sample_kernel``. ``stratified_sample(priorities,
uniforms, batch_size)`` composes them: with ``total`` the sum of the block sums, target
``i`` is ``(i + uniforms[i]) / batch_size * total`` in f32, and its index is the slot
where the inclusive prefix of the priorities first exceeds it (searchsorted ``right``).

The search goes in two levels, as the Pallas kernel does: a binary search over the
prefix of the block sums picks the block (clamped to the last), then the count of that
block's inclusive prefixes <= ``target - base`` picks the slot (clamped to 2047).

Every sum is accumulated in f64, and the block sums and block prefix are rounded to f32,
the type the Pallas kernel keeps them in. At a million slots an f32 prefix rounds to
1/16 while a slot holds about 0.8 of mass, so f32 sums taken in two orders (a warp's
tree, a sequential scan) disagree on a slot for some targets in ten; accumulated in f64
they round to the same f32 whatever the order, so the kernel and its plain version
agree bit for bit. On integer priorities every sum is exact either way, and the result
is the Pallas kernel's bit for bit.

What bounds it on an H100: device-memory bytes, one read of the priorities for the block
sums and one 8 KB block a target for the search; see ``csrc/stratified_sample.cu`` for
the design. On a CPU tensor each function runs its plain version, which follows the
Pallas kernel's interpret mode step by step.
"""

from __future__ import annotations

import torch

from baselines_tpu_torch.ops import cuda_lib

BLOCK = 2048  # priorities per block
ROWS, ROW = 16, 128  # a block as 16 rows of 128


def _check_priorities(priorities: torch.Tensor) -> None:
    if priorities.dim() != 1 or priorities.dtype != torch.float32:
        raise ValueError(f"priorities must be 1-D f32, got {priorities.dtype} "
                         f"{tuple(priorities.shape)}")
    n = priorities.shape[0]
    if n == 0 or n % BLOCK:
        raise ValueError(f"pad priorities to a nonzero multiple of {BLOCK}, got {n}")
    if not priorities.is_contiguous():
        raise ValueError("priorities must be contiguous")
    if priorities.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the stratified sampler runs on cuda or cpu, not {priorities.device}")
    if priorities.device.type == "cuda" and priorities.data_ptr() % 16:
        raise ValueError("the stratified sampler needs 16-byte aligned priorities")


def plain_block_sums(priorities: torch.Tensor) -> torch.Tensor:
    return priorities.view(-1, BLOCK).to(torch.float64).sum(dim=1).to(torch.float32)


def block_sums(priorities: torch.Tensor) -> torch.Tensor:
    """(N,) f32 priorities, N a multiple of 2048 -> (N / 2048,) f32 block sums."""
    _check_priorities(priorities)
    if priorities.device.type == "cpu":
        return plain_block_sums(priorities)
    out = torch.empty((priorities.shape[0] // BLOCK,), dtype=torch.float32,
                      device=priorities.device)
    err = cuda_lib.library().btt_block_sums(
        priorities.data_ptr(), priorities.shape[0], out.data_ptr(),
        torch.cuda.current_stream(priorities.device).cuda_stream,
    )
    cuda_lib.check(err, "block_sums")
    block_sums.launches += 1
    return out


block_sums.launches = 0


def stratified_targets(block_prefix: torch.Tensor, uniforms: torch.Tensor,
                       batch_size: int) -> torch.Tensor:
    """(i + u_i) / batch_size * total in f32, total the last block prefix. The divisor is
    a tensor so that the card divides too (it multiplies by the reciprocal of a Python
    number)."""
    i = torch.arange(batch_size, dtype=torch.float32, device=uniforms.device)
    divisor = torch.full((), float(batch_size), dtype=torch.float32, device=uniforms.device)
    return (i + uniforms) / divisor * block_prefix[-1]


def plain_search(priorities: torch.Tensor, sums: torch.Tensor, uniforms: torch.Tensor,
                 batch_size: int) -> torch.Tensor:
    """The Pallas kernel's interpret mode in torch ops, with sums in f64: the block by
    searchsorted right over the block prefix, then the block as (16, 128) with the lane
    prefix plus the exclusive row offsets, and the count of prefixes <= target - base."""
    nblocks = sums.shape[0]
    block_prefix = torch.cumsum(sums.to(torch.float64), dim=0).to(torch.float32)
    targets = stratified_targets(block_prefix, uniforms, batch_size)
    blk = torch.clamp(torch.searchsorted(block_prefix, targets, right=True), max=nblocks - 1)
    base = torch.where(blk > 0, block_prefix[torch.clamp(blk - 1, min=0)],
                       torch.zeros_like(targets))
    vals = priorities.view(nblocks, ROWS, ROW)[blk].to(torch.float64)  # (B, 16, 128)
    lane_prefix = torch.cumsum(vals, dim=2)
    row_sums = vals.sum(dim=2)
    row_offsets = torch.cumsum(row_sums, dim=1) - row_sums
    incl = lane_prefix + row_offsets[:, :, None]
    rem = (targets - base).to(torch.float64)
    local = (incl <= rem[:, None, None]).sum(dim=(1, 2))
    return (blk * BLOCK + torch.clamp(local, max=BLOCK - 1)).to(torch.int32)


def stratified_search(priorities: torch.Tensor, sums: torch.Tensor, uniforms: torch.Tensor,
                      batch_size: int) -> torch.Tensor:
    """The sampled slots, (batch_size,) int32, from the priorities, their block sums and
    one uniform in [0, 1) a target."""
    _check_priorities(priorities)
    nblocks = priorities.shape[0] // BLOCK
    if sums.shape != (nblocks,) or sums.dtype != torch.float32 or not sums.is_contiguous():
        raise ValueError(f"block sums must be contiguous f32 ({nblocks},), got {sums.dtype} "
                         f"{tuple(sums.shape)}")
    if batch_size <= 0 or uniforms.shape != (batch_size,) or uniforms.dtype != torch.float32:
        raise ValueError(f"uniforms must be f32 ({batch_size},), got {uniforms.dtype} "
                         f"{tuple(uniforms.shape)}")
    if not (sums.device == uniforms.device == priorities.device):
        raise ValueError("priorities, block sums and uniforms must be on one device")
    if priorities.device.type == "cpu":
        return plain_search(priorities, sums, uniforms, batch_size)
    lib = cuda_lib.library()
    if nblocks > lib.btt_stratified_search_max_blocks():
        raise ValueError(f"{nblocks} blocks exceed the search kernel's shared memory")
    uniforms = uniforms.contiguous()
    out = torch.empty((batch_size,), dtype=torch.int32, device=priorities.device)
    err = lib.btt_stratified_search(
        priorities.data_ptr(), sums.data_ptr(), uniforms.data_ptr(), nblocks, batch_size,
        out.data_ptr(), torch.cuda.current_stream(priorities.device).cuda_stream,
    )
    cuda_lib.check(err, "stratified_search")
    stratified_search.launches += 1
    return out


stratified_search.launches = 0


def stratified_sample(priorities: torch.Tensor, uniforms: torch.Tensor,
                      batch_size: int) -> torch.Tensor:
    """``batch_size`` slots drawn in proportion to ``priorities`` with stratified targets
    (pallas_sampler.py:118-166): (N,) f32 priorities, N a multiple of 2048 (pad with
    zeros), and (batch_size,) f32 uniforms in [0, 1) -> (batch_size,) int32."""
    return stratified_search(priorities, block_sums(priorities), uniforms, batch_size)


def plain_stratified_sample(priorities: torch.Tensor, uniforms: torch.Tensor,
                            batch_size: int) -> torch.Tensor:
    """The plain version of the whole op, on any device."""
    return plain_search(priorities, plain_block_sums(priorities), uniforms, batch_size)
