// Row gather out[i] = x[idx[i]] over rows of any fixed byte width, for Hopper.
//
// Replaces the Pallas kernel `_gather_rows_kernel` of baselines_tpu/ops/gather.py (a ring
// of per-row DMAs). It serves the PPO epoch shuffle: every field of the batch, above all
// the 32768 obs rows of 28,224 bytes.
//
// Bound: a pure copy, so device-memory bytes: each selected row read once and written
// once. Design: rows are flat bytes, moved in the widest unit (16, 8, 4, 2 or 1 bytes)
// that divides the row width and both base addresses, so the obs rows go as 16-byte
// vector loads and stores. A group of 2^k threads copies one row, neighbouring threads on
// neighbouring units, and a block of 256 threads takes 256 / 2^k rows, each group reading
// its own index. An index outside [0, n_src) yields a row of zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const T* __restrict__ x, const int64_t* __restrict__ idx,
                       T* __restrict__ out, int64_t n_src, int64_t m, int64_t units,
                       int group_log2) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (THREADS >> group_log2) + (threadIdx.x >> group_log2);
  if (row >= m) return;
  const int64_t src = __ldg(reinterpret_cast<const long long*>(idx) + row);
  T* dst = out + row * units;
  const int64_t step = int64_t(1) << group_log2;
  const int64_t first = threadIdx.x & (step - 1);
  if (src < 0 || src >= n_src) {
    for (int64_t u = first; u < units; u += step) dst[u] = T{};
    return;
  }
  const T* s = x + src * units;
  for (int64_t u = first; u < units; u += step) dst[u] = __ldg(s + u);
}

template <typename T>
cudaError_t launch(const void* x, const void* idx, void* out, int64_t n_src, int64_t m,
                   int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(T));
  int group_log2 = 0;  // threads per row: the power of two at or above units, at most 32
  while (group_log2 < 5 && (int64_t(1) << group_log2) < units) ++group_log2;
  const int64_t rows_per_block = THREADS >> group_log2;
  const int64_t blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  gather_rows_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
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
  if (align % 16 == 0) return launch<uint4>(x, idx, out, n_src, m, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(x, idx, out, n_src, m, row_bytes, s);
  if (align % 4 == 0) return launch<uint32_t>(x, idx, out, n_src, m, row_bytes, s);
  if (align % 2 == 0) return launch<uint16_t>(x, idx, out, n_src, m, row_bytes, s);
  return launch<uint8_t>(x, idx, out, n_src, m, row_bytes, s);
}
