// Row gather out[i] = x[idx[i]] over rows of any fixed byte width, for Hopper.
//
// Replaces the Pallas kernel `_gather_rows_kernel` of baselines_tpu/ops/gather.py (a ring
// of per-row DMAs). It serves the PPO epoch shuffle (every field of the batch, above all
// the 32768 obs rows of 28,224 bytes) and deepq's replay sample (256 rows of each field
// of the ring).
//
// Bound: a pure copy, so device-memory bytes: each selected row read once and written
// once. At 3.35 TB/s the card needs some 25 KB in flight on each SM to reach that rate
// (Little's law), and a grid sized from the row width alone leaves most SMs idle on a
// short gather. So each row is cut into chunks over a 2-D grid of chunks x rows, and 256
// wide rows still fill every SM. Rows move in units of the widest size (16, 8, 4, 2 or 1
// bytes) that divides the row width and both base addresses; a group of 2^k threads
// takes one chunk of a row, each thread issuing UNROLL independent loads before its
// stores; narrow rows put several rows in a block. UNROLL = 2 and 256 threads a block
// were as fast as any in a sweep of 1, 2, 4 and 8 loads and 128 to 1024 threads at both
// shapes. A bulk asynchronous copy (cp.async.bulk through a ring of shared-memory stages
// on mbarriers) measured slower on an H100 at both shapes (PERF.md) and is not kept.
// An index outside [0, n_src) yields a row of zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // independent loads a thread has in flight

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const T* __restrict__ x, const int64_t* __restrict__ idx,
                       T* __restrict__ out, int64_t n_src, int64_t m, int64_t units,
                       int group_log2) {
  const int group = 1 << group_log2;
  const int rows_per_block = THREADS >> group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * group * UNROLL + lane;
  const int64_t left = units - first;  // unit j * group of this thread exists if < left
  for (int64_t row = static_cast<int64_t>(blockIdx.y) * rows_per_block +
                     (threadIdx.x >> group_log2);
       row < m; row += static_cast<int64_t>(gridDim.y) * rows_per_block) {
    const int64_t src = __ldg(reinterpret_cast<const long long*>(idx) + row);
    const bool valid = src >= 0 && src < n_src;
    const T* s = x + (valid ? src : 0) * units + first;
    T* d = out + row * units + first;
    T v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) v[j] = (valid && j * group < left) ? __ldg(s + j * group) : T{};
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      if (j * group < left) d[j * group] = v[j];
  }
}

template <typename T>
cudaError_t launch_threads(const void* x, const void* idx, void* out, int64_t n_src, int64_t m,
                           int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(T));
  // threads per chunk: the power of two at or above units / UNROLL, at most a block
  int group_log2 = 0;
  while ((int64_t(1) << group_log2) < THREADS &&
         (int64_t(UNROLL) << group_log2) < units)
    ++group_log2;
  const int64_t chunk = int64_t(UNROLL) << group_log2;
  const int64_t chunks = (units + chunk - 1) / chunk;
  const int64_t rows_per_block = THREADS >> group_log2;
  int64_t row_blocks = (m + rows_per_block - 1) / rows_per_block;
  if (row_blocks > 65535) row_blocks = 65535;  // the kernel strides over the rest
  if (chunks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(row_blocks));
  gather_rows_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(idx), static_cast<T*>(out), n_src,
      m, units, group_log2);
  return cudaGetLastError();
}

}  // namespace

// x: n_src rows of row_bytes bytes; idx: m int64 indices; out: m rows. Returns the
// launch's cudaError_t.
extern "C" int btt_gather_rows(const void* x, const void* idx, void* out, long long n_src,
                               long long m, long long row_bytes, void* stream) {
  if (m <= 0 || row_bytes <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch_threads<uint4>(x, idx, out, n_src, m, row_bytes, s);
  if (align % 8 == 0) return launch_threads<uint2>(x, idx, out, n_src, m, row_bytes, s);
  if (align % 4 == 0) return launch_threads<uint32_t>(x, idx, out, n_src, m, row_bytes, s);
  if (align % 2 == 0) return launch_threads<uint16_t>(x, idx, out, n_src, m, row_bytes, s);
  return launch_threads<uint8_t>(x, idx, out, n_src, m, row_bytes, s);
}
