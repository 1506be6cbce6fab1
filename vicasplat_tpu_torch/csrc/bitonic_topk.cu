// K4: ascending sort of each row of 32-bit words, keeping the first `keep`.
//
// Replaces the Pallas TPU kernel of
// vicasplat_tpu/ops/rasterize/pallas_bitonic.py:31 (_bitonic_kernel) and
// :59 (bitonic_topk_u32), which origin binning uses to depth-order each
// tile's candidate words (vicasplat_tpu/ops/rasterize/tiles.py:440-448).
// The words arrive as the 32-bit patterns of unsigned values (held in an
// int32 tensor by the port) and leave the same way.
//
// Bound on an H100 at the flagship's shapes (256 tiles, m = 2048, keep =
// 512): 2.1 MB in and 0.5 MB out, against ~17 M compare-exchanges. Neither
// is large; one launch per view is set by launch latency and by the 66
// barrier-separated stages of the network.
//
// Design: one block per row. The row's m words go into shared memory; the
// bitonic network runs there, each thread
// doing the compare-exchange of m / 2 / blockDim pairs per stage with plain
// unsigned compares (the TPU kernel's sign-flip to int32 is not needed).
// The first `keep` words are written out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bitonic_topk_kernel(const uint32_t* __restrict__ words,
                                    uint32_t* __restrict__ out, int m,
                                    int keep) {
  extern __shared__ uint32_t s[];
  const long long row = blockIdx.x;
  const uint32_t* src = words + row * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  const int half = m >> 1;
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i + j;
        const bool asc = (i & k) == 0;  // direction of this k-block
        const uint32_t a = s[i], b = s[l];
        if ((a > b) == asc) {
          s[i] = b;
          s[l] = a;
        }
      }
      __syncthreads();
    }
  }
  uint32_t* dst = out + row * keep;
  for (int i = threadIdx.x; i < keep; i += blockDim.x) dst[i] = s[i];
}

}  // namespace

// words: (rows, m) unsigned 32-bit, m a power of two; out: (rows, keep)
// unsigned 32-bit. Launches on `stream` and returns cudaGetLastError().
extern "C" int vs_bitonic_topk(const void* words, void* out, int rows, int m,
                               int keep, void* stream) {
  const int threads = m / 2 < 1024 ? m / 2 : 1024;
  const size_t smem = static_cast<size_t>(m) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_topk_kernel<<<rows, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), m,
      keep);
  return static_cast<int>(cudaGetLastError());
}
