// Fused forward of the space-to-depth Nature CNN (NatureCNNS2D in bf16) for Hopper.
//
// Replaces the Pallas kernel `_fwd_kernel` of baselines_tpu/ops/fused_cnn.py.
// Computes, for each sample of x u8 (B, 21, 21, 64) NHWC:
//   bf16(x * 1/255) -> conv 2x2/s1 64->32 -> conv 4x4/s2 32->64 -> conv 3x3/s1 64->64
//   -> dense 3136->512, each layer +bias and relu in f32, bf16 between layers,
// and writes the f32 latent (B, 512).
//
// Bound: 18.69 MFLOP a sample against 28,224 input bytes, 2,048 output bytes and 3.37 MB
// of weights: bytes bound it at deepq's batch of 64, tensor-core operations from a few
// hundred samples up (see PERF.md).
//
// Design: two launches under one call, each layer an implicit GEMM on bf16 mma.sync
// (m16n8k16, f32 accumulate) with every fragment loaded from shared memory by ldmatrix.
// - The conv stage takes one sample a block, two blocks an SM (105 KB of shared memory
//   each), so a batch of 64 or 256 spreads over the SMs. Each layer's weights are
//   staged in shared memory by cp.async in the space the layer before has freed (w1
//   16 KB, w2 64 KB, w3 72 KB); the other block on the SM computes while one waits.
//   Activations never leave shared memory; the sample's conv3 output, bf16 in NHWC
//   flatten order, goes to a (B, 3136) scratch tensor. The warps tile each layer's
//   output positions x channels so all eight have work in conv2 and conv3.
// - The dense stage is a tiled GEMM over (batch x 512): 64 x 64 output tiles, a
//   four-stage cp.async ring over depth, so the 3.2 MB weight is read once for each
//   64 samples, not once a block. Where the batch gives too few tiles to fill the card,
//   the depth is split over a thread-block cluster of up to 8 blocks, which sum their
//   partial tiles through distributed shared memory in rank order: the same bits on
//   every run, no atomics.
// Shared-memory rows are XOR-swizzled in 16-byte chunks, keyed to the next layer's
// output position, so the 8 rows an ldmatrix reads fall on distinct banks at every tap;
// conv1 writes its output with even and odd columns apart for conv2's stride 2.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int H0 = 21, W0 = 21, C0 = 64;
constexpr int H1 = 20, W1 = 20, C1 = 32;
constexpr int H2 = 9, W2 = 9, C2 = 64;
constexpr int H3 = 7, W3 = 7, C3 = 64;
constexpr int FC_IN = H3 * W3 * C3, FC_OUT = 512;
constexpr float INV255 = 1.0f / 255.0f;

// ------------------------------------------------------------------ common pieces

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in an array of RB-byte rows (RB = 64 or 128),
// the chunks of each row permuted so that 8 consecutive rows hit distinct banks.
template <int RB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(RB == 64 || RB == 128, "row width");
  if constexpr (RB == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_relu2(void* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
}

// ------------------------------------------------------------------ conv stage

constexpr int CONV_THREADS = 256, CONV_WARPS = CONV_THREADS / 32;

// Shared-memory regions, bytes. R0: the input (bf16, 56,448), then w2 (65,536), then w3
// (73,728, running on into R1); R1: conv1's output (25,600); R2: w1 (16,384), then
// conv2's output (10,368).
constexpr int R0_BYTES = 16 * C2 * C1 * 2;
constexpr int R1_BYTES = H1 * W1 * C1 * 2;
constexpr int R2_BYTES = 4 * C1 * C0 * 2;
constexpr int CONV_SMEM = R0_BYTES + R1_BYTES + R2_BYTES;
static_assert(H0 * W0 * C0 * 2 <= R0_BYTES, "the input fits R0");
static_assert(9 * C3 * C2 * 2 <= R0_BYTES + R1_BYTES, "w3 fits R0 and R1");
static_assert(H2 * W2 * C2 * 2 <= R2_BYTES, "conv2's output fits R2");

// Where the 16-byte chunk c (8 channels) of position (y, x) of an activation lives in
// shared memory, in bytes. Each swizzle is chosen so that the positions an ldmatrix reads
// for 8 consecutive output positions of the next layer, at any tap, fall on 8 distinct
// 16-byte bank groups: the swizzle (or, for 64-byte rows, the row's parity with it) is
// the output position plus a constant, mod 8.
struct Frame {  // the bf16 input, 21 x 21 x 64: rows of 128 bytes; conv1 reads m = 20y + x
  __device__ static uint32_t addr(int y, int x, int c) {
    return (y * W0 + x) * 128 + ((c ^ ((4 * y + x) & 7)) << 4);
  }
};
struct Act1 {  // conv1's output, 20 x 20 x 32: rows of 64 bytes, each image row's even
               // columns first, then its odd ones, for conv2's stride 2; conv2 reads
               // m = 9 (y / 2) + x / 2, and the row's parity carries the low bit
  __device__ static uint32_t addr(int y, int x, int c) {
    const int t = (y >> 1) + (x >> 1);
    const int row = y * W1 + (x & 1) * (W1 / 2) + ((x >> 1) ^ ((y >> 1) & 1));
    return row * 64 + ((c ^ ((t >> 1) & 3)) << 4);
  }
};
struct Act2 {  // conv2's output, 9 x 9 x 64: rows of 128 bytes; conv3 reads m = 7y + x
  __device__ static uint32_t addr(int y, int x, int c) {
    return (y * W2 + x) * 128 + ((c ^ ((7 * y + x) & 7)) << 4);
  }
};

// Each layer as an implicit GEMM: row m an output position (row-major, OW wide), column n
// an output channel, depth (tap, input channel). Output m at tap (ky, kx) reads position
// (STR (m / OW) + ky, STR (m % OW) + kx) of the layer's input In; the weights are rows
// (tap, n) of CIN bf16 in shared memory, swizzled by row. A warp item is MW m-tiles of 16
// rows x NW n-tiles of 8 columns.
struct Conv1 {
  using In = Frame;
  static constexpr int CIN = C0, COUT = C1, K = 2, STR = 1, OW = W1, M = H1 * W1, MW = 2, NW = 4;
};
struct Conv2 {
  using In = Act1;
  static constexpr int CIN = C1, COUT = C2, K = 4, STR = 2, OW = W2, M = H2 * W2, MW = 3, NW = 2;
};
struct Conv3 {
  using In = Act2;
  static constexpr int CIN = C2, COUT = C3, K = 3, STR = 1, OW = W3, M = H3 * W3, MW = 2, NW = 2;
};

template <class L, class Store>
__device__ __forceinline__ void conv_layer(uint32_t in, uint32_t w, const float* __restrict__ bias,
                                           Store store) {
  constexpr int IRB = L::CIN * 2;
  constexpr int MT = (L::M + 15) / 16, MG = (MT + L::MW - 1) / L::MW;
  constexpr int NG = L::COUT / (8 * L::NW);
  static_assert(L::COUT % (8 * L::NW) == 0 && L::NW % 2 == 0 && L::CIN % 16 == 0, "tiles");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = warp; item < MG * NG; item += CONV_WARPS) {
    const int mt0 = (item / NG) * L::MW, n0 = (item % NG) * L::NW * 8;
    // ldmatrix.x4 rows: for A, lane l gives output row l % 16 of the tile at chunk l / 16
    // (rows past the end repeat the last row and are not stored); for B, two n-tiles,
    // lane l gives channel l % 8 + 8 (l / 16) at chunk (l / 8) % 2
    int y0[L::MW], x0[L::MW];
#pragma unroll
    for (int i = 0; i < L::MW; ++i) {
      const int m = min((mt0 + i) * 16 + (lane & 15), L::M - 1);
      y0[i] = (m / L::OW) * L::STR;
      x0[i] = (m % L::OW) * L::STR;
    }
    const int achunk = lane >> 4, bchunk = (lane >> 3) & 1;
    const int bn = n0 + (lane & 7) + ((lane >> 4) << 3);
    float acc[L::MW][L::NW][4];
#pragma unroll
    for (int i = 0; i < L::MW; ++i)
#pragma unroll
      for (int j = 0; j < L::NW; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll
    for (int tap = 0; tap < L::K * L::K; ++tap) {
      const int ky = tap / L::K, kx = tap % L::K;
#pragma unroll
      for (int kc = 0; kc < L::CIN / 16; ++kc) {
        uint32_t a[L::MW][4];
#pragma unroll
        for (int i = 0; i < L::MW; ++i)
          ldsm4(in + L::In::addr(y0[i] + ky, x0[i] + kx, 2 * kc + achunk), a[i]);
#pragma unroll
        for (int j = 0; j < L::NW; j += 2) {
          uint32_t b[4];
          ldsm4(w + swz<IRB>(tap * L::COUT + bn + j * 8, 2 * kc + bchunk), b);
#pragma unroll
          for (int i = 0; i < L::MW; ++i) {
            mma_bf16(acc[i][j], a[i], b[0], b[1]);
            mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < L::NW; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      const float bl = __ldg(bias + n), bh = __ldg(bias + n + 1);
#pragma unroll
      for (int i = 0; i < L::MW; ++i) {
        const int m = (mt0 + i) * 16 + g;
        if (m < L::M) store(m, n, acc[i][j][0] + bl, acc[i][j][1] + bh);
        if (m + 8 < L::M) store(m + 8, n, acc[i][j][2] + bl, acc[i][j][3] + bh);
      }
    }
  }
}

// Weights [tap][COUT][CIN] from global memory into shared memory by cp.async, swizzled
// by row; one commit group.
template <int RB>
__device__ __forceinline__ void stage_weights(uint32_t dst, const __nv_bfloat16* src, int bytes) {
  const char* s = reinterpret_cast<const char*>(src);
  for (int i = threadIdx.x; i < bytes / 16; i += CONV_THREADS)
    cp_async16(dst + swz<RB>(i / (RB / 16), i % (RB / 16)), s + i * 16);
  cp_async_commit();
}

// One sample's u8 NHWC frame -> bf16(x * 1/255) in shared memory, rows of 64 channels;
// every thread issues its seven 16-byte loads before it converts.
__device__ __forceinline__ void load_input(const uint8_t* __restrict__ x, unsigned char* xs) {
  constexpr int N16 = H0 * W0 * C0 / 16, PER = (N16 + CONV_THREADS - 1) / CONV_THREADS;
  const uint4* src = reinterpret_cast<const uint4*>(x);
  uint4 v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * CONV_THREADS;
    if (i < N16) v[j] = __ldg(src + i);
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * CONV_THREADS;
    if (i >= N16) continue;
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v[j]);
    __align__(16) __nv_bfloat162 o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = __floats2bfloat162_rn(static_cast<float>(b[2 * k]) * INV255,
                                   static_cast<float>(b[2 * k + 1]) * INV255);
    const int y = (i >> 2) / W0, col = (i >> 2) % W0, c = (i & 3) * 2;  // first 8-channel chunk
    *reinterpret_cast<uint4*>(xs + Frame::addr(y, col, c)) = reinterpret_cast<const uint4*>(o)[0];
    *reinterpret_cast<uint4*>(xs + Frame::addr(y, col, c + 1)) =
        reinterpret_cast<const uint4*>(o)[1];
  }
}

__global__ void __launch_bounds__(CONV_THREADS, 2)
    conv_stage_kernel(const uint8_t* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                      const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                      const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w3,
                      const float* __restrict__ b3, __nv_bfloat16* __restrict__ a3) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* r0 = smem;
  unsigned char* r1 = r0 + R0_BYTES;
  unsigned char* r2 = r1 + R1_BYTES;
  const uint32_t s0 = smem_addr(r0), s1 = smem_addr(r1), s2 = smem_addr(r2);
  const size_t b = blockIdx.x;

  stage_weights<C0 * 2>(s2, w1, R2_BYTES);
  load_input(x + b * (H0 * W0 * C0), r0);
  cp_async_wait<0>();
  __syncthreads();
  conv_layer<Conv1>(s0, s2, b1, [&](int m, int n, float lo, float hi) {
    store_relu2(r1 + Act1::addr(m / W1, m % W1, n >> 3) + (n & 7) * 2, lo, hi);
  });
  __syncthreads();
  stage_weights<C1 * 2>(s0, w2, 16 * C2 * C1 * 2);
  cp_async_wait<0>();
  __syncthreads();
  conv_layer<Conv2>(s1, s0, b2, [&](int m, int n, float lo, float hi) {
    store_relu2(r2 + Act2::addr(m / W2, m % W2, n >> 3) + (n & 7) * 2, lo, hi);
  });
  __syncthreads();
  stage_weights<C2 * 2>(s0, w3, 9 * C3 * C2 * 2);
  cp_async_wait<0>();
  __syncthreads();
  __nv_bfloat16* out = a3 + b * FC_IN;
  conv_layer<Conv3>(s2, s0, b3, [&](int m, int n, float lo, float hi) {
    store_relu2(out + m * C3 + n, lo, hi);
  });
}

// ------------------------------------------------------------------ dense stage

constexpr int DBM = 64, DBN = 64, DBK = 64, DSTAGES = 4, DTHREADS = 256;
constexpr int KTILES = FC_IN / DBK;  // 49
constexpr int DTILE_BYTES = DBM * DBK * 2;
constexpr int DSMEM = DSTAGES * 2 * DTILE_BYTES;
constexpr int MAX_SPLITS = 8;  // the portable cluster size
static_assert(FC_IN % DBK == 0 && FC_OUT % DBN == 0 && DBM == DBN, "dense tiles");
static_assert(DBM * DBN * 4 <= DSMEM, "the partial tile fits the ring");

// out[m][n] = relu(bfc[n] + sum_k a3[m][k] wfc[n][k]) for a 64 x 64 tile (blockIdx.y,
// blockIdx.x), over the depth tiles of split blockIdx.z. 8 warps as 2 x 4, each 32
// samples x 16 outputs.
__global__ void __launch_bounds__(DTHREADS)
    dense_stage_kernel(const __nv_bfloat16* __restrict__ a3, const __nv_bfloat16* __restrict__ wfc,
                       const float* __restrict__ bfc, float* __restrict__ out, int batch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  const int n0 = blockIdx.x * DBN, m0 = blockIdx.y * DBM;
  const int splits = gridDim.z;
  const int kt0 = blockIdx.z * KTILES / splits, nk = (blockIdx.z + 1) * KTILES / splits - kt0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // stage s: the a3 tile (rows past the batch read as zeros), then the wfc tile, each 64
  // rows of 64 bf16; two 16-byte chunks of each a thread
  auto load_stage = [&](int kt, int s) {
    const uint32_t sa = sbase + s * 2 * DTILE_BYTES, sw = sa + DTILE_BYTES;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * DTHREADS, r = i >> 3, c = i & 7;
      const bool valid = m0 + r < batch;
      cp_async16(sa + swz<DBK * 2>(r, c),
                 a3 + static_cast<size_t>(valid ? m0 + r : 0) * FC_IN + kt * DBK + c * 8, valid);
      cp_async16(sw + swz<DBK * 2>(r, c),
                 wfc + static_cast<size_t>(n0 + r) * FC_IN + kt * DBK + c * 8);
    }
  };

#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < nk) load_stage(kt0 + s, s);
    cp_async_commit();
  }
  const int wm = warp >> 2, wn = warp & 3;
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<DSTAGES - 2>();
    __syncthreads();  // tile k has landed, and every warp is done with tile k - 1
    if (k + DSTAGES - 1 < nk) load_stage(kt0 + k + DSTAGES - 1, (k + DSTAGES - 1) % DSTAGES);
    cp_async_commit();
    const uint32_t sa = sbase + (k % DSTAGES) * 2 * DTILE_BYTES, sw = sa + DTILE_BYTES;
#pragma unroll
    for (int kc = 0; kc < DBK / 16; ++kc) {
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm4(sa + swz<DBK * 2>(wm * 32 + i * 16 + (lane & 15), 2 * kc + (lane >> 4)), a[i]);
      ldsm4(sw + swz<DBK * 2>(wn * 16 + (lane & 7) + ((lane >> 4) << 3), 2 * kc + ((lane >> 3) & 1)),
            b);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][0], a[i], b[0], b[1]);
        mma_bf16(acc[i][1], a[i], b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: its space may hold the partial tile

  const int g = lane >> 2, t = lane & 3;
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + wn * 16 + j * 8 + 2 * t;
      const float bl = __ldg(bfc + n), bh = __ldg(bfc + n + 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + wm * 32 + i * 16 + g;
        if (m < batch)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * FC_OUT + n) =
              make_float2(fmaxf(acc[i][j][0] + bl, 0.f), fmaxf(acc[i][j][1] + bh, 0.f));
        if (m + 8 < batch)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(m + 8) * FC_OUT + n) =
              make_float2(fmaxf(acc[i][j][2] + bl, 0.f), fmaxf(acc[i][j][3] + bh, 0.f));
      }
    }
    return;
  }
  // split depth: each block of the cluster keeps its partial tile in shared memory; block
  // q then sums rows [q * 64 / splits, (q + 1) * 64 / splits) of every partial, in rank
  // order
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = wm * 32 + i * 16 + g, c = wn * 16 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + r * DBN + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(part + (r + 8) * DBN + c) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * DBM / splits, r1 = (rank + 1) * DBM / splits;
  for (int e = tid; e < (r1 - r0) * DBN; e += DTHREADS) {
    const int r = r0 + e / DBN, c = e % DBN;
    float v[MAX_SPLITS];  // every remote load first, then the sum in rank order
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      v[q] = q < splits ? cluster.map_shared_rank(part, q)[r * DBN + c] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) sum += v[q];
    if (m0 + r < batch)
      out[static_cast<size_t>(m0 + r) * FC_OUT + n0 + c] = fmaxf(sum + __ldg(bfc + n0 + c), 0.f);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// ------------------------------------------------------------------ launches

cudaError_t launch_conv(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* w3, const void* b3, void* a3, int batch,
                        cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    // two blocks an SM need the largest shared-memory carveout
    cudaError_t err = cudaFuncSetAttribute(
        conv_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CONV_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(conv_stage_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  conv_stage_kernel<<<batch, CONV_THREADS, CONV_SMEM, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w3),
      static_cast<const float*>(b3), static_cast<__nv_bfloat16*>(a3));
  return cudaGetLastError();
}

// The depth is split in two, four or eight (one cluster) while the 64 x 64 tiles alone
// would give fewer than about two blocks an SM.
int dense_splits(int batch) {
  const int tiles = (batch + DBM - 1) / DBM * (FC_OUT / DBN);
  int splits = 1;
  while (splits < MAX_SPLITS && tiles * splits < 240) splits *= 2;
  return splits;
}

cudaError_t launch_dense(const void* a3, const void* wfc, const void* bfc, void* out, int batch,
                         cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DSMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int splits = dense_splits(batch);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FC_OUT / DBN, (batch + DBM - 1) / DBM, splits);
  cfg.blockDim = dim3(DTHREADS);
  cfg.dynamicSmemBytes = DSMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dense_stage_kernel, static_cast<const __nv_bfloat16*>(a3),
      static_cast<const __nv_bfloat16*>(wfc), static_cast<const float*>(bfc),
      static_cast<float*>(out), batch);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x u8 (batch, 21, 21, 64), 16-byte aligned; w1 bf16 (4, 32, 64), w2 bf16 (16, 64, 32),
// w3 bf16 (9, 64, 64) as [tap][out][in]; wfc bf16 (512, 3136); biases f32; a3 bf16
// (batch, 3136) scratch; out f32 (batch, 512); every pointer 16-byte aligned. The forward is
// the conv stage (x -> a3) then the dense stage (a3 -> out), in order on one stream; each
// entry returns its launch's cudaError_t.
extern "C" int btt_fused_cnn_conv(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, const void* w3, const void* b3, void* a3,
                                  int batch, void* stream) {
  return launch_conv(x, w1, b1, w2, b2, w3, b3, a3, batch, static_cast<cudaStream_t>(stream));
}

extern "C" int btt_fused_cnn_dense(const void* a3, const void* wfc, const void* bfc, void* out,
                                   int batch, void* stream) {
  return launch_dense(a3, wfc, bfc, out, batch, static_cast<cudaStream_t>(stream));
}

extern "C" const char* btt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
