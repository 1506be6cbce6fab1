// K4: ascending sort of each row of 32-bit words, keeping the first `keep`.
//
// Replaces the Pallas TPU kernel of
// vicasplat_tpu/ops/rasterize/pallas_bitonic.py:31 (_bitonic_kernel) and
// :59 (bitonic_topk_u32), which origin binning uses to depth-order each
// tile's candidate words (vicasplat_tpu/ops/rasterize/tiles.py:440-448).
// The words arrive as the 32-bit patterns of unsigned values (held in an
// int32 tensor by the port) and leave the same way; every compare is
// unsigned (the TPU kernel's sign flip to int32 is not needed).
//
// Bound on an H100 at the flagship's shapes (256 tiles, m = 2048, keep =
// 512): 2.1 MB in and 0.5 MB out, about 0.0008 ms at 3.35 TB/s; the ~8 M
// compare-exchanges are not the limit. What sets the time is the latency of
// the network's dependent stages and their exchanges.
//
// Design: one block per row, V words a thread in registers (thread t holds
// the run t*V .. t*V+V-1: V = 8 at m = 2048, 256 threads). A stage of
// partner distance j runs
// - in registers where j < V,
// - through __shfl_xor_sync where V <= j < 32 V (the partner is in the
//   same warp),
// - through shared memory where j >= 32 V, with one barrier a stage.
// The network is pruned to `keep` (R = the next power of two >= keep):
// runs of R words are sorted, alternately ascending and descending; then,
// while more than one run is left, each ascending run A takes
// min(A[i], B[i]) with the descending run B beside it, a bitonic run that
// holds the R smallest of A and B, and sorts it in log2(R) stages. At the
// flagship shape: four sorts of 512, then two prunes. The first `keep`
// words of the last run are written. Rows of m <= 64 run in one warp.
// kernels/bitonic_topk.py (bitonic_topk_pruned_walk) walks the same stages
// on the CPU.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

// Compare-exchange of a and b (a at the lower index): the lower keeps the
// minimum where `asc`, the maximum otherwise.
__device__ __forceinline__ void cmpx(uint32_t& a, uint32_t& b, bool asc) {
  const uint32_t lo = min(a, b), hi = max(a, b);
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// A stage of distance J < V among a thread's own words; index i = base + r
// is ascending where (i & kdir) == 0, for the whole run where kdir >= V.
template <int V, int J>
__device__ __forceinline__ void reg_stage(uint32_t (&x)[V], int base, int kdir) {
  if (kdir >= V) {
    const bool asc = (base & kdir) == 0;
#pragma unroll
    for (int r = 0; r < V; ++r)
      if ((r & J) == 0) cmpx(x[r], x[r + J], asc);
    return;
  }
#pragma unroll
  for (int r = 0; r < V; ++r)
    if ((r & J) == 0) cmpx(x[r], x[r + J], ((base + r) & kdir) == 0);
}

template <int V>
__device__ __forceinline__ void reg_stage_any(uint32_t (&x)[V], int j, int base,
                                              int kdir) {
  if (j == 1) reg_stage<V, 1>(x, base, kdir);
  if constexpr (V > 2) if (j == 2) reg_stage<V, (V > 2 ? 2 : 1)>(x, base, kdir);
  if constexpr (V > 4) if (j == 4) reg_stage<V, (V > 4 ? 4 : 1)>(x, base, kdir);
  if constexpr (V > 8) if (j == 8) reg_stage<V, (V > 8 ? 8 : 1)>(x, base, kdir);
  if constexpr (V > 16) if (j == 16) reg_stage<V, (V > 16 ? 16 : 1)>(x, base, kdir);
}

// One stage of distance j and direction bit kdir over the row, V words a
// thread in x (thread t holds t*V .. t*V+V-1), with s[] as the row's copy
// for the stages of j >= 32 V; `in_smem` says where the row is now. Only
// the words i with (i & (span - 1)) < R are live (span 0: all): a warp
// with no live word skips a stage in registers or shuffles, and a pair
// whose lower word is dead is skipped in shared memory.
template <int V>
__device__ __forceinline__ void stage(uint32_t (&x)[V], uint32_t* s, int j,
                                      int kdir, int span, int R, int t, int m,
                                      bool& in_smem) {
  const int base = t * V;
  if (j < 32 * V) {
    if (in_smem) {
#pragma unroll
      for (int r = 0; r < V; ++r) x[r] = s[base + r];
      in_smem = false;
    }
    if (span && !__any_sync(~0u, (base & (span - 1)) < R)) return;
    if (j < V) {
      reg_stage_any<V>(x, j, base, kdir);
      return;
    }
    const int d = j / V;  // the partner's lane distance
    // kdir >= 2 j > r: one direction for the thread's run
    const bool keep_min = ((t & d) == 0) == ((base & kdir) == 0);
#pragma unroll
    for (int r = 0; r < V; ++r) {
      const uint32_t y = __shfl_xor_sync(~0u, x[r], d);
      x[r] = keep_min ? min(x[r], y) : max(x[r], y);
    }
    return;
  }
  // j >= 32 V: only where m > 32 V, so every thread holds words
  if (!in_smem) {
#pragma unroll
    for (int r = 0; r < V; ++r) s[base + r] = x[r];
    in_smem = true;
    __syncthreads();
  }
  for (int p = t; p < m / 2; p += blockDim.x) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    if (span && (i & (span - 1)) >= R) continue;
    uint32_t a = s[i], b = s[i + j];
    cmpx(a, b, (i & kdir) == 0);
    s[i] = a;
    s[i + j] = b;
  }
  __syncthreads();
}

template <int V>
__global__ void __launch_bounds__(1024)
bitonic_topk_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                    int m, int keep) {
  extern __shared__ uint32_t s[];  // m words, for the stages of j >= 32 V
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const bool holds = t < m / V;  // the other threads pad a warp
  const int base = t * V;
  uint32_t x[V];
  const uint32_t* src = words + row * m;
#pragma unroll
  for (int r = 0; r < V; ++r) x[r] = holds ? src[base + r] : 0xFFFFFFFFu;

  bool in_smem = false;
  int R = 1;
  while (R < keep) R <<= 1;
  // runs of R words, alternately ascending and descending
  for (int k = 2; k <= R; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) stage<V>(x, s, j, k, 0, R, t, m, in_smem);
  // prune: the live runs sit at multiples of len; runs A (ascending) and B
  // (descending) at distance len: A keeps min(A, B), then sorts it in the
  // direction of its place among the runs left (ascending where
  // (i & 2 len) == 0; the last run ascending)
  for (int len = R; len < m; len <<= 1) {
    // kdir = m: (i & m) == 0 for every i, so the lower keeps the minimum
    stage<V>(x, s, len, m, len << 1, R, t, m, in_smem);
    for (int j = R >> 1; j > 0; j >>= 1)
      stage<V>(x, s, j, len << 1, len << 1, R, t, m, in_smem);
  }
  if (in_smem) {
#pragma unroll
    for (int r = 0; r < V; ++r) x[r] = s[base + r];
  }
  uint32_t* dst = out + row * keep;
#pragma unroll
  for (int r = 0; r < V; ++r)
    if (base + r < keep) dst[base + r] = x[r];
}

template <int V>
int launch(const void* words, void* out, int rows, int m, int keep,
           cudaStream_t stream) {
  static smem_limit::Set smem_set;
  const int threads = m / V < 32 ? 32 : m / V;
  const size_t smem = m > 32 * V ? static_cast<size_t>(m) * sizeof(uint32_t) : 0;
  // once per device: the most a row of 227 KB may need
  const cudaError_t err = smem_limit::allow(bitonic_topk_kernel<V>, 227 * 1024, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_topk_kernel<V><<<rows, threads, smem, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), m, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: (rows, m) unsigned 32-bit, m a power of two from 2 to 32768; out:
// (rows, keep) unsigned 32-bit, 1 <= keep <= m. Words per thread: 2 up to
// m = 64 (one warp), 8 up to m = 8192, then 16 and 32 (1,024 threads).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int vs_bitonic_topk(const void* words, void* out, int rows, int m,
                               int keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 64) return launch<2>(words, out, rows, m, keep, st);
  if (m <= 8192) return launch<8>(words, out, rows, m, keep, st);
  if (m <= 16384) return launch<16>(words, out, rows, m, keep, st);
  if (m <= 32768) return launch<32>(words, out, rows, m, keep, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
