// Fused forward of the space-to-depth Nature CNN (NatureCNNS2D in bf16) for Hopper.
//
// Replaces the Pallas kernel `_fwd_kernel` of baselines_tpu/ops/fused_cnn.py.
// Computes, for each sample of x u8 (B, 21, 21, 64) NHWC:
//   bf16(x * 1/255) -> conv 2x2/s1 64->32 -> conv 4x4/s2 32->64 -> conv 3x3/s1 64->64
//   -> dense 3136->512, each layer +bias and relu in f32, bf16 between layers,
// and writes only the f32 latent (B, 512).
//
// Bound: 18.69 MFLOP a sample against 28,224 input bytes and 2,048 output bytes, so on
// an H100 the work is bound by tensor-core operations at large batch (see PERF.md).
// Design: every layer is an implicit GEMM on bf16 mma.sync (m16n8k16, f32 accumulate).
// One block of 8 warps takes S samples. It stages one sample at a time in shared
// memory (the u8 input widened to bf16, then each activation), runs the three convs on
// it, and keeps the sample's conv3 output; the dense layer then runs once for all S
// samples, so each block streams the 3.2 MB fc weight from L2 once. Activations never
// leave shared memory. Conv weights are read through the read-only cache.
// Shared-memory rows are padded by 8 bf16 so the 8 rows of an mma fragment fall on
// different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H0 = 21, W0 = 21, C0 = 64;
constexpr int H1 = 20, W1 = 20, C1 = 32;
constexpr int H2 = 9, W2 = 9, C2 = 64;
constexpr int H3 = 7, W3 = 7, C3 = 64;
constexpr int FC_IN = H3 * W3 * C3, FC_OUT = 512;
constexpr int THREADS = 256, WARPS = THREADS / 32;

// shared-memory row strides, in bf16 elements
constexpr int XS = C0 + 8;      // input and conv2 output, per position
constexpr int A1S = C1 + 8;     // conv1 output, per position
constexpr int A2S = C2 + 8;     // conv2 output, per position
constexpr int A3S = FC_IN + 8;  // conv3 output (NHWC-flattened), per sample

constexpr int X_ELEMS = H0 * W0 * XS;
constexpr int A1_ELEMS = H1 * W1 * A1S;
static_assert(H2 * W2 * A2S <= X_ELEMS, "conv2 output reuses the input's space");

constexpr float INV255 = 1.0f / 255.0f;

template <int S>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(X_ELEMS + A1_ELEMS + S * A3S) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two consecutive bf16 as one 32-bit register, the lower index in the low half
__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void store_relu2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
}

// One sample's u8 NHWC frame -> bf16(x * 1/255) in shared memory, 16 bytes a thread.
__device__ __forceinline__ void load_input(const uint8_t* __restrict__ x, __nv_bfloat16* xs) {
  const uint4* src = reinterpret_cast<const uint4*>(x);
  for (int i = threadIdx.x; i < H0 * W0 * C0 / 16; i += THREADS) {
    const uint4 v = __ldg(src + i);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
    __align__(16) __nv_bfloat162 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = __floats2bfloat162_rn(static_cast<float>(b[2 * j]) * INV255,
                                   static_cast<float>(b[2 * j + 1]) * INV255);
    uint4* dst = reinterpret_cast<uint4*>(xs + (i >> 2) * XS + (i & 3) * 16);
    dst[0] = reinterpret_cast<const uint4*>(o)[0];
    dst[1] = reinterpret_cast<const uint4*>(o)[1];
  }
}

// Valid KxK convolution with stride STR of one sample in shared memory, as an implicit
// GEMM: row m is an output position (row-major, OH x OW), column n an output channel,
// depth (tap, input channel). in: [positions][IS] bf16; w: [K*K][COUT][CIN] bf16 in
// global memory; out[m * OS + n] = bf16(relu(acc + bias[n])). A warp takes one 16-row
// tile and NT 8-column tiles at a time.
template <int IW, int IS, int CIN, int OH, int OW, int COUT, int OS, int K, int STR, int NT>
__device__ __forceinline__ void conv_layer(const __nv_bfloat16* in,
                                           const __nv_bfloat16* __restrict__ w,
                                           const float* __restrict__ bias, __nv_bfloat16* out) {
  constexpr int M = OH * OW;
  constexpr int MT = (M + 15) / 16;
  constexpr int NG = COUT / (8 * NT);
  static_assert(COUT % (8 * NT) == 0 && CIN % 16 == 0, "tile shape");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int item = warp; item < MT * NG; item += WARPS) {
    const int m0 = (item / NG) * 16 + g, m1 = m0 + 8;
    const int n0 = (item % NG) * NT * 8;
    // rows past the end repeat the last row and are not stored
    const int r0 = min(m0, M - 1), r1 = min(m1, M - 1);
    const __nv_bfloat16* in0 = in + ((r0 / OW) * STR * IW + (r0 % OW) * STR) * IS + 2 * t;
    const __nv_bfloat16* in1 = in + ((r1 / OW) * STR * IW + (r1 % OW) * STR) * IS + 2 * t;
    const __nv_bfloat16* wg = w + (n0 + g) * CIN + 2 * t;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < K * K; ++tap) {
      const int off = ((tap / K) * IW + tap % K) * IS;
      const __nv_bfloat16* wt = wg + tap * COUT * CIN;
#pragma unroll
      for (int kc = 0; kc < CIN; kc += 16) {
        const uint32_t a0 = lds32(in0 + off + kc), a1 = lds32(in1 + off + kc);
        const uint32_t a2 = lds32(in0 + off + kc + 8), a3 = lds32(in1 + off + kc + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* wj = wt + j * 8 * CIN + kc;
          mma_bf16(acc[j], a0, a1, a2, a3, ldg32(wj), ldg32(wj + 8));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      const float bl = __ldg(bias + n), bh = __ldg(bias + n + 1);
      if (m0 < M) store_relu2(out + m0 * OS + n, acc[j][0] + bl, acc[j][1] + bh);
      if (m1 < M) store_relu2(out + m1 * OS + n, acc[j][2] + bl, acc[j][3] + bh);
    }
  }
}

// Dense 3136->512 for the block's samples, computed transposed so the samples are the
// 8-wide mma columns: out[b0 + s][o] = relu(bfc[o] + sum_k wfc[o][k] * a3[s][k]).
template <int S>
__device__ __forceinline__ void fc_layer(const __nv_bfloat16* a3,
                                         const __nv_bfloat16* __restrict__ wfc,
                                         const float* __restrict__ bfc, float* __restrict__ out,
                                         int b0, int nvalid) {
  constexpr int NT = (S + 7) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* bs[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) bs[j] = a3 + min(j * 8 + g, S - 1) * A3S + 2 * t;
  for (int mt = warp; mt < FC_OUT / 16; mt += WARPS) {
    const int o0 = mt * 16 + g;
    const __nv_bfloat16* w0 = wfc + static_cast<size_t>(o0) * FC_IN + 2 * t;
    const __nv_bfloat16* w1 = w0 + 8 * FC_IN;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
    for (int k = 0; k < FC_IN; k += 16) {
      const uint32_t a0 = ldg32(w0 + k), a1 = ldg32(w1 + k);
      const uint32_t a2 = ldg32(w0 + k + 8), a3r = ldg32(w1 + k + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_bf16(acc[j], a0, a1, a2, a3r, lds32(bs[j] + k), lds32(bs[j] + k + 8));
    }
    const float blo = __ldg(bfc + o0), bhi = __ldg(bfc + o0 + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int s = j * 8 + 2 * t;
      if (s < nvalid) {
        out[static_cast<size_t>(b0 + s) * FC_OUT + o0] = fmaxf(acc[j][0] + blo, 0.f);
        out[static_cast<size_t>(b0 + s) * FC_OUT + o0 + 8] = fmaxf(acc[j][2] + bhi, 0.f);
      }
      if (s + 1 < nvalid) {
        out[static_cast<size_t>(b0 + s + 1) * FC_OUT + o0] = fmaxf(acc[j][1] + blo, 0.f);
        out[static_cast<size_t>(b0 + s + 1) * FC_OUT + o0 + 8] = fmaxf(acc[j][3] + bhi, 0.f);
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1)
    fused_cnn_kernel(const uint8_t* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w3,
                     const float* __restrict__ b3, const __nv_bfloat16* __restrict__ wfc,
                     const float* __restrict__ bfc, float* __restrict__ out, int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // input, then conv2 output
  __nv_bfloat16* a1 = xs + X_ELEMS;
  __nv_bfloat16* a3 = a1 + A1_ELEMS;
  const int b0 = blockIdx.x * S;
  const int nvalid = min(S, batch - b0);
  for (int s = 0; s < nvalid; ++s) {
    load_input(x + static_cast<size_t>(b0 + s) * (H0 * W0 * C0), xs);
    __syncthreads();
    conv_layer<W0, XS, C0, H1, W1, C1, A1S, 2, 1, 2>(xs, w1, b1, a1);
    __syncthreads();
    conv_layer<W1, A1S, C1, H2, W2, C2, A2S, 4, 2, 4>(a1, w2, b2, xs);
    __syncthreads();
    conv_layer<W2, A2S, C2, H3, W3, C3, C3, 3, 1, 4>(xs, w3, b3, a3 + s * A3S);
    __syncthreads();
  }
  fc_layer<S>(a3, wfc, bfc, out, b0, nvalid);
}

template <int S>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* w3, const void* b3, const void* wfc,
                   const void* bfc, void* out, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<S>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_cnn_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_cnn_kernel<S><<<(batch + S - 1) / S, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w3),
      static_cast<const float*>(b3), static_cast<const __nv_bfloat16*>(wfc),
      static_cast<const float*>(bfc), static_cast<float*>(out), batch);
  return cudaGetLastError();
}

}  // namespace

// x u8 (batch, 21, 21, 64), 16-byte aligned; w1 bf16 (4, 32, 64), w2 bf16 (16, 64, 32),
// w3 bf16 (9, 64, 64) as [tap][out][in]; wfc bf16 (512, 3136); biases f32; out f32
// (batch, 512). Samples per block: 2 below a batch of 1024, so a rollout batch of 256
// still spreads over 128 SMs, and 8 from there on, so each block's pass over the fc
// weight serves a full 8-column mma tile. Returns the launch's cudaError_t.
extern "C" int btt_fused_cnn_forward(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* w3,
                                     const void* b3, const void* wfc, const void* bfc,
                                     void* out, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch >= 1024) return launch<8>(x, w1, b1, w2, b2, w3, b3, wfc, bfc, out, batch, s);
  return launch<2>(x, w1, b1, w2, b2, w3, b3, wfc, bfc, out, batch, s);
}

extern "C" const char* btt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
