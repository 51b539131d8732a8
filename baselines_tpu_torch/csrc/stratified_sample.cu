// Two-level stratified sampling from a priority vector, for Hopper.
//
// Replaces the two Pallas kernels of baselines_tpu/data/pallas_sampler.py, reached there
// through `pallas_stratified_sample`: `_block_sums_kernel` (one sum per block of 2048
// priorities) and `_sample_kernel` (for each stratified target: a binary search over the
// block prefix, a fetch of that block, its inclusive prefix and a count). It serves the
// prioritized replay of deepq, once for every training iteration.
//
// Bound: device-memory bytes. The block sums read the N priorities once (4 MB at one
// million slots, 1.25 us at 3.35 TB/s); the search reads one block of 8 KB for each
// target (2 MB at 256 targets). Design:
// - block sums: one block of 256 threads for each 2048 priorities, two 16-byte loads a
//   thread, a warp-shuffle reduction, then the 8 warp sums in order, all in f64;
// - search: every block first scans the block sums into an inclusive prefix in shared
//   memory (a few KB; each block computes the same prefix in the same order), so the
//   prefix needs no launch of its own. Then one warp takes one target: a binary search
//   over the shared prefix, then the target's block as 16 rows of 128 priorities, each
//   lane holding 4 of a row. All 16 rows are loaded before any is used, so the loads are
//   in flight together. A row's inclusive prefix is the lane's own running sum plus the
//   warp's exclusive scan (`__shfl_up_sync`); the rows before it add a running offset.
//   `__ballot_sync`/`__popc` count the slots whose prefix is <= the target's remainder.
// The TPU kernel's double-buffered DMA ring is not carried over: many warps in flight
// hide the latency of the block fetches.
//
// Semantics are those of the Pallas kernel: the block is the first whose inclusive
// prefix exceeds the target (searchsorted right), clamped to the last block; the slot is
// the count of in-block prefixes <= target - base, clamped to 2047. The targets, block
// sums and block prefix are f32 values as there, but every sum is accumulated in f64:
// at a million slots an f32 prefix rounds to 1/16 while a slot holds about 0.8 of mass,
// so f32 sums taken in two orders disagree on a slot for some targets in ten. Summed in
// f64, a sum is exact or nearly so, and rounds to the same f32 whatever the order; the
// kernel and its plain version then agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 2048;       // priorities per block
constexpr int ROWS = 16;          // a block read as ROWS rows of ROW priorities
constexpr int ROW = 128;
constexpr int SUM_THREADS = 256;  // block sums: 8 priorities a thread
constexpr int SEARCH_THREADS = 256;
constexpr int SEARCH_WARPS = SEARCH_THREADS / 32;  // one target a warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double warp_inclusive_scan(double v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__global__ void __launch_bounds__(SUM_THREADS)
    block_sums_kernel(const float4* __restrict__ prios, float* __restrict__ sums) {
  __shared__ double warp_sums[SUM_THREADS / 32];
  const float4* blk = prios + static_cast<size_t>(blockIdx.x) * (BLOCK / 4);
  const float4 a = __ldg(blk + threadIdx.x);
  const float4 b = __ldg(blk + threadIdx.x + SUM_THREADS);
  double s = ((double(a.x) + a.y) + (double(a.z) + a.w)) +
             ((double(b.x) + b.y) + (double(b.z) + b.w));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < SUM_THREADS / 32; ++w) total += warp_sums[w];
    sums[blockIdx.x] = static_cast<float>(total);
  }
}

__global__ void __launch_bounds__(SEARCH_THREADS)
    search_kernel(const float* __restrict__ prios, const float* __restrict__ block_sums,
                  const float* __restrict__ uniforms, int nblocks, int batch,
                  int* __restrict__ out) {
  extern __shared__ float prefix[];  // nblocks floats: inclusive prefix of the block sums
  __shared__ double warp_totals[SEARCH_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the block prefix: each thread sums its own run of block sums, a block-wide
  //    exclusive scan of those run totals gives each run its offset, and each thread
  //    writes its run's prefixes, rounded to f32.
  const int per = (nblocks + SEARCH_THREADS - 1) / SEARCH_THREADS;
  const int begin = min(tid * per, nblocks), end = min(begin + per, nblocks);
  double run = 0.0;
  for (int k = begin; k < end; ++k) run += block_sums[k];
  const double incl = warp_inclusive_scan(run, lane);
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double w = lane < SEARCH_WARPS ? warp_totals[lane] : 0.0;
    w = warp_inclusive_scan(w, lane);
    if (lane < SEARCH_WARPS) warp_totals[lane] = w;
  }
  __syncthreads();
  double acc = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) acc = 0.0;
  if (warp > 0) acc += warp_totals[warp - 1];
  for (int k = begin; k < end; ++k) {
    acc += block_sums[k];
    prefix[k] = static_cast<float>(acc);
  }
  __syncthreads();

  // 2. one warp a target; the target and the remainder are f32, as in the Pallas kernel
  const int i = blockIdx.x * SEARCH_WARPS + warp;
  if (i >= batch) return;
  const float total = prefix[nblocks - 1];
  const float t = __fmul_rn(__fdiv_rn(__fadd_rn(static_cast<float>(i), uniforms[i]),
                                      static_cast<float>(batch)),
                            total);
  int lo = 0, hi = nblocks - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] <= t) lo = mid + 1; else hi = mid;
  }
  const int blk = lo;
  const double rem = __fsub_rn(t, blk > 0 ? prefix[blk - 1] : 0.f);

  const float4* rows =
      reinterpret_cast<const float4*>(prios + static_cast<size_t>(blk) * BLOCK) + lane;
  float4 v[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = __ldg(rows + r * (ROW / 4));
  double offset = 0.0;  // sum of the rows before this one
  int count = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const double p0 = v[r].x;
    const double p1 = p0 + v[r].y;
    const double p2 = p1 + v[r].z;
    const double p3 = p2 + v[r].w;
    const double lane_incl = warp_inclusive_scan(p3, lane);
    double before = __shfl_up_sync(FULL, lane_incl, 1);  // this lane's row prefix
    before = (lane == 0 ? 0.0 : before) + offset;
    count += __popc(__ballot_sync(FULL, before + p0 <= rem));
    count += __popc(__ballot_sync(FULL, before + p1 <= rem));
    count += __popc(__ballot_sync(FULL, before + p2 <= rem));
    count += __popc(__ballot_sync(FULL, before + p3 <= rem));
    offset += __shfl_sync(FULL, lane_incl, 31);
  }
  if (lane == 0) out[i] = blk * BLOCK + min(count, BLOCK - 1);
}

}  // namespace

// prios: n f32 (n a multiple of 2048, 16-byte aligned) -> sums: n / 2048 f32.
extern "C" int btt_block_sums(const void* prios, long long n, void* sums, void* stream) {
  const long long nblocks = n / BLOCK;
  if (n <= 0 || n % BLOCK != 0 || nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  block_sums_kernel<<<static_cast<unsigned>(nblocks), SUM_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(prios), static_cast<float*>(sums));
  return cudaGetLastError();
}

// The largest block count whose prefix fits the search kernel's shared memory.
extern "C" long long btt_stratified_search_max_blocks() {
  return (232448 - 1024) / static_cast<long long>(sizeof(float));
}

// prios: nblocks * 2048 f32 (16-byte aligned); block_sums: nblocks f32; uniforms: batch
// f32 in [0, 1) -> out: batch int32 slot indices.
extern "C" int btt_stratified_search(const void* prios, const void* block_sums,
                                     const void* uniforms, long long nblocks, int batch,
                                     void* out, void* stream) {
  if (nblocks <= 0 || nblocks > btt_stratified_search_max_blocks() || batch <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(nblocks) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (batch + SEARCH_WARPS - 1) / SEARCH_WARPS;
  search_kernel<<<grid, SEARCH_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prios), static_cast<const float*>(block_sums),
      static_cast<const float*>(uniforms), static_cast<int>(nblocks), batch,
      static_cast<int*>(out));
  return cudaGetLastError();
}
