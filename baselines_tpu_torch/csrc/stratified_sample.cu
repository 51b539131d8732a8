// Two-level stratified sampling from a priority vector, for Hopper: one launch.
//
// Replaces both Pallas kernels of baselines_tpu/data/pallas_sampler.py, reached there
// through `pallas_stratified_sample`: `_block_sums_kernel` (:41, one sum per block of 2048
// priorities) and `_sample_kernel` (:48, for each stratified target: a binary search over
// the block prefix, a fetch of that block, its inclusive prefix and a count). It serves the
// prioritized replay of deepq, once for every training iteration.
//
// Bound: at deepq's 10240 slots the priorities are 40 KB, warm in L2, and the op is bound
// by dependent latency, not by its 41 KB of bytes: a launch, an L2 round trip for the
// sums, a cluster barrier, a scan, then for each target a search, an L2 round trip for
// its block and a scan of 2048 values. At
// a million slots it is bound by how fast the SMs of one cluster read the 4 MB of
// priorities for the sums. Design:
// - One launch: a grid of thread-block clusters of 8 blocks (16 where 8 would each sum
//   more than 16 blocks of priorities), every cluster computing the whole op for its
//   share of the targets. Each block of a cluster sums its share of the 2048-slot blocks,
//   one warp a block, 16 loads of 16 bytes a lane in flight and the next block's issued
//   before the current one is summed, in f64, and writes each sum, rounded to f32, into
//   the shared memory of every block of the cluster (distributed shared memory, one
//   lane a block). After one cluster barrier every block holds all the sums, and one
//   warp builds the inclusive prefix in one fixed order in place: no second launch, no
//   trip through device memory and no remote read come between the sums and the search.
// - One warp a target, the targets spread over the blocks of the grid, several in turn
//   where the batch exceeds the grid's warps; each target's (i + u_i) / batch is computed
//   while the sums run. The target's block comes from L2 by coalesced 16-byte loads into
//   the warp's 8 KB slot, XOR-swizzled so that the lane-strided stores and the lane-owned
//   reads hit each bank once a quarter-warp; the next target's loads are issued before
//   the current one is scanned (the Pallas kernel's two-slot DMA ring, with registers as
//   the second slot). Lane l owns 64 contiguous slots: it sums them in f64 (four chains
//   of 16), one warp scan of the 32 lane totals gives its offset, it walks its 64
//   prefixes counting those <= the target's remainder, and one warp reduction gives the
//   slot. Every prefix is counted: no priority is assumed non-negative.
// - The grid: as many clusters as spread the targets over up to 64 blocks, one target a
//   block at least. More do not all fit the card at once (a cluster takes SMs of one GPC,
//   and a block takes a whole SM's registers), and each cluster sums the vector again.
//   sampler_grid.py times every grid against this rule.
// - Tried on this card and left out, each slower or no faster at the shapes above:
//   keeping the vector in the cluster's shared memory and reading a target's block from
//   its owner over distributed shared memory (generic or ld.shared::cluster loads);
//   prefetching a small vector into L1; converting a block to f64 once into a 16 KB
//   slot; splitting a block's sum over several warps; reading the sums from their owners
//   after the barrier instead of writing them to every block before it; splitting a
//   target over two warps.
//
// Semantics are those of the Pallas kernel: target i is (i + u_i) / batch * total in f32;
// the block is the first whose inclusive prefix exceeds the target (searchsorted right),
// clamped to the last block; the slot is the count of in-block prefixes <= target - base,
// clamped to 2047. The block sums and block prefix are f32 values as there, but every sum
// is accumulated in f64: at a million slots an f32 prefix rounds to 1/16 while a slot
// holds about 0.8 of mass, so f32 sums taken in two orders disagree on a slot for some
// targets in ten. Summed in f64, a sum is exact or nearly so and rounds to the same f32
// whatever the order; the kernel and its plain version then agree bit for bit on integer
// priorities, and within a slot, rarely, on others.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK = 2048;                   // priorities per block
constexpr int VECS = BLOCK / 4;               // 16-byte chunks per block
constexpr int LANE_VECS = VECS / 32;          // 16 chunks (64 slots) a lane
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 32768;             // the block prefix fits shared memory
constexpr int MAX_CTAS = 64;                  // blocks a launch takes at most
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory: [one 8 KB slot a warp][block sums, then their prefix: nblocks f32]
constexpr size_t SLOTS_BYTES = static_cast<size_t>(WARPS) * BLOCK * sizeof(float);

__host__ __device__ constexpr int blocks_per_cta(int nblocks, int cluster) {
  return (nblocks + cluster - 1) / cluster;
}

__host__ __device__ constexpr size_t smem_bytes(int nblocks) {
  return SLOTS_BYTES + static_cast<size_t>(nblocks) * sizeof(float);
}

constexpr size_t MAX_SMEM = smem_bytes(MAX_BLOCKS);

__device__ __forceinline__ double warp_inclusive_scan(double v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// Relaxed: it only says that this block has started, so that the others may write to its
// shared memory once the barrier completes; it publishes no memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A block's chunks, lane-strided (coalesced): v[k] is chunk k * 32 + lane.
__device__ __forceinline__ void load_block(const float4* __restrict__ src, int lane,
                                           float4 (&v)[LANE_VECS]) {
#pragma unroll
  for (int k = 0; k < LANE_VECS; ++k) v[k] = __ldg(src + k * 32 + lane);
}

// 16-byte chunk q of a block, lane-major: chunk q belongs to lane q / 16 (slots
// 4q .. 4q + 3), and its column within the lane's 16 chunks is XORed with the lane, so
// that both the lane-strided stores and the lane-owned reads hit each bank once a
// quarter-warp.
__device__ __forceinline__ int swizzle(int q) { return (q & ~15) | ((q ^ (q >> 4)) & 15); }

__device__ __forceinline__ void store_swizzled(float4* dst, int lane, const float4 (&v)[LANE_VECS]) {
#pragma unroll
  for (int k = 0; k < LANE_VECS; ++k) dst[swizzle(k * 32 + lane)] = v[k];
}

// The count of the block's inclusive prefixes <= rem, the block swizzled in a warp's
// slot. Lane l owns slots 64l .. 64l + 63 as four chains of 16: one pass sums each chain,
// a warp scan of the lane totals gives the lane's offset, a second pass walks the chains'
// prefixes, four walks side by side. Each pass reads the lane's chunks from shared
// memory, which keeps registers free.
__device__ __forceinline__ int count_block(const float4* slot, double rem, int lane) {
  const float4* row = slot + lane * LANE_VECS;
  double c[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = row[(4 * m + j) ^ (lane & 15)];
      s += f.x;
      s += f.y;
      s += f.z;
      s += f.w;
    }
    c[m] = s;
  }
  double start = __shfl_up_sync(FULL, warp_inclusive_scan((c[0] + c[1]) + (c[2] + c[3]), lane), 1);
  if (lane == 0) start = 0.0;
  int count = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    double acc = start;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = row[(4 * m + j) ^ (lane & 15)];
      acc += f.x;
      count += acc <= rem;
      acc += f.y;
      count += acc <= rem;
      acc += f.z;
      count += acc <= rem;
      acc += f.w;
      count += acc <= rem;
    }
    start += c[m];
  }
  return __reduce_add_sync(FULL, count);
}

template <int CLUSTER>
__global__ void __launch_bounds__(THREADS)
    stratified_sample_kernel(const float* __restrict__ prios, const float* __restrict__ uniforms,
                             int nblocks, int batch, int* __restrict__ out,
                             float* __restrict__ sums_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = blocks_per_cta(nblocks, CLUSTER);
  float4* slot = reinterpret_cast<float4*>(smem) + warp * VECS;
  float* prefix = reinterpret_cast<float*>(smem + SLOTS_BYTES);
  const float4* prios4 = reinterpret_cast<const float4*>(prios);

  // the targets are spread over the blocks of the grid: warp w of block c takes targets
  // w * blocks + c, then W on (W the grid's warps). Lane j holds (i + u_i) / batch of the
  // warp's j-th target i, computed now so that it overlaps the sums; the target is that
  // times the total, all in f32 as in the Pallas kernel.
  const int total_warps = gridDim.x * WARPS;
  const int gw = warp * gridDim.x + blockIdx.x;
  auto quotient = [&](long long i) {
    return i < batch ? __fdiv_rn(__fadd_rn(static_cast<float>(i), __ldg(uniforms + i)),
                                 static_cast<float>(batch))
                     : 0.f;
  };
  float q_lane = quotient(gw + static_cast<long long>(lane) * total_warps);
  cluster_arrive();

  // 1. this block's share of the block sums, one warp a block of priorities, the next
  //    block's loads issued before the current one is summed. Each sum goes, rounded to
  //    f32, straight into the shared memory of every block of the cluster (lane r
  //    writes it to block r), once the barrier that the first loads overlap says that
  //    every block has started.
  const int own0 = min(rank * per, nblocks), own1 = min(own0 + per, nblocks);
  int b = own0 + warp;
  float4 v[LANE_VECS];
  if (b < own1) load_block(prios4 + static_cast<size_t>(b) * VECS, lane, v);
  cluster_wait();
  if (b < own1) {
    float4 ahead[LANE_VECS];
    while (true) {
      const int nb = b + WARPS;
      if (nb < own1) load_block(prios4 + static_cast<size_t>(nb) * VECS, lane, ahead);
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < LANE_VECS; ++k)
        s += (static_cast<double>(v[k].x) + v[k].y) + (static_cast<double>(v[k].z) + v[k].w);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane < CLUSTER) *cluster.map_shared_rank(prefix + b, lane) = static_cast<float>(s);
      if (nb >= own1) break;
      b = nb;
#pragma unroll
      for (int k = 0; k < LANE_VECS; ++k) v[k] = ahead[k];
    }
  }
  cluster.sync();  // every block now holds all the sums; no block reads another after this

  // 2. warp 0 scans the sums in place in one fixed order: a run of consecutive sums a
  //    lane, a warp scan of the run totals, each run's f64 prefixes rounded to f32
  if (warp == 0) {
    const int run = (nblocks + 31) / 32;
    const int begin = min(lane * run, nblocks), end = min(begin + run, nblocks);
    double run_total = 0.0;
    for (int k = begin; k < end; ++k) {
      run_total += prefix[k];
      if (sums_out != nullptr && blockIdx.x == 0) sums_out[k] = prefix[k];
    }
    double acc = __shfl_up_sync(FULL, warp_inclusive_scan(run_total, lane), 1);
    if (lane == 0) acc = 0.0;
    for (int k = begin; k < end; ++k) {
      acc += prefix[k];
      prefix[k] = static_cast<float>(acc);
    }
  }
  __syncthreads();

  // 3. one warp a target; the target and the remainder are f32, as in the Pallas kernel.
  //    The target's block comes from device memory (L2) by coalesced loads into the
  //    warp's slot, swizzled; the next target's loads fly while the current one is
  //    scanned.
  const float total = prefix[nblocks - 1];
  auto locate = [&](int i, int j, int& blk, double& rem) {
    if (j > 0 && (j & 31) == 0)  // the next 32 targets
      q_lane = quotient(i + static_cast<long long>(lane) * total_warps);
    const float t = __fmul_rn(__shfl_sync(FULL, q_lane, j & 31), total);
    int lo = 0, hi = nblocks - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (prefix[mid] <= t) lo = mid + 1; else hi = mid;
    }
    blk = lo;
    rem = __fsub_rn(t, lo > 0 ? prefix[lo - 1] : 0.f);
  };

  if (gw < batch) {
    int i = gw, j = 0, blk;
    double rem;
    locate(i, j, blk, rem);
    float4 v[LANE_VECS];
    load_block(prios4 + static_cast<size_t>(blk) * VECS, lane, v);
    while (true) {
      __syncwarp();
      store_swizzled(slot, lane, v);
      __syncwarp();
      const int next = i + total_warps;
      int next_blk = 0;
      double next_rem = 0.0;
      if (next < batch) {
        locate(next, j + 1, next_blk, next_rem);
        load_block(prios4 + static_cast<size_t>(next_blk) * VECS, lane, v);
      }
      const int count = count_block(slot, rem, lane);
      if (lane == 0) out[i] = blk * BLOCK + min(count, BLOCK - 1);
      if (next >= batch) break;
      i = next;
      ++j;
      blk = next_blk;
      rem = next_rem;
    }
  }
}

// Clusters of 8 blocks, or 16 where each block of 8 would sum more than 16 blocks of
// priorities; as many clusters as spread the targets over up to MAX_CTAS blocks, one
// target a block at least. More blocks than that do not all fit the card at once, one
// cluster to a GPC's SMs, and each cluster sums the whole vector again.
void choose_grid(int nblocks, int batch, int* clusters, int* cluster) {
  *cluster = blocks_per_cta(nblocks, 8) > 16 ? 16 : 8;
  *clusters = min((batch + *cluster - 1) / *cluster, MAX_CTAS / *cluster);
}

template <int CLUSTER>
cudaError_t launch_cluster(const float* prios, const float* uniforms, int nblocks, int batch,
                           int* out, float* sums_out, int clusters, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(stratified_sample_kernel<CLUSTER>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(MAX_SMEM));
    if (err == cudaSuccess && CLUSTER > 8)
      err = cudaFuncSetAttribute(stratified_sample_kernel<CLUSTER>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(nblocks);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, stratified_sample_kernel<CLUSTER>, prios,
                                             uniforms, nblocks, batch, out, sums_out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch(const float* prios, const float* uniforms, int nblocks, int batch, int* out,
                   float* sums_out, int clusters, int cluster, cudaStream_t stream) {
  if (cluster == 16)
    return launch_cluster<16>(prios, uniforms, nblocks, batch, out, sums_out, clusters, stream);
  if (cluster == 8)
    return launch_cluster<8>(prios, uniforms, nblocks, batch, out, sums_out, clusters, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// prios: n f32, n a nonzero multiple of 2048 up to 2048 * 32768, 16-byte aligned;
// uniforms: batch f32 in [0, 1) -> out: batch int32 slot indices; sums_out: n / 2048 f32
// block sums, or null. One launch on `stream`.
extern "C" int btt_stratified_sample(const void* prios, const void* uniforms, long long n,
                                     int batch, void* out, void* sums_out, void* stream) {
  const long long nblocks = n / BLOCK;
  if (n <= 0 || n % BLOCK != 0 || nblocks > MAX_BLOCKS || batch <= 0)
    return cudaErrorInvalidValue;
  int clusters, cluster;
  choose_grid(static_cast<int>(nblocks), batch, &clusters, &cluster);
  return launch(static_cast<const float*>(prios), static_cast<const float*>(uniforms),
                static_cast<int>(nblocks), batch, static_cast<int*>(out),
                static_cast<float*>(sums_out), clusters, cluster,
                static_cast<cudaStream_t>(stream));
}
