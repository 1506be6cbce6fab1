// K3: the fused DPT head tail, out = conv1x1(relu(conv3x3_SAME(a + m) + b1)) + b2.
//
// Replaces the Pallas TPU kernel of vicasplat_tpu/ops/dpt_tail.py:43
// (_kernel), :92 (_pallas_tail) and :159 (fused_dpt_tail, forward). The sum
// a + m, the 3x3 conv's input, and its F-channel output h never exist in
// device memory: only a, m, the weights and the O-channel output move.
//
// Bound on an H100 at the flagship GS head (a, m (8, 256, 256, 256) bf16,
// F = 256, O = 83): 524,288 px x (2*9*256*256 + 2*256*83) = 641 GFLOP, 0.65
// ms at 989 TFLOP/s, against ~624 MB, 0.19 ms at 3.35 TB/s: the tensor cores
// bound it.
//
// Design (simple first, mma.sync like K1): one block of 8 warps per run of
// 128 output pixels of one image row, holding all F output channels in
// float32 accumulators (warps 4 x 2 over pixels x channels). The 3x3 conv is
// an implicit GEMM: for each chunk of 32 input channels the block stages the
// 3 x 130 input window (a + m, summed in float32 and rounded to bf16 on load,
// zeros outside the image: SAME padding at every edge), then walks the 9
// taps; each tap's (F, 32) weight slice streams through a double buffer
// with cp.async while the previous tap's products run. Then b1 is added,
// relu applied, h rounded to bf16 into shared memory, and the second product
// runs against w2 (padded by the caller to a multiple of 8 rows, the mma
// width). b2 is added and only the first O channels are stored.
//
// Any F that is a multiple of 128 and any O: F = 256 runs as one slice; any
// other F runs in slices of 128 features, each slice's h feeding the second
// product, whose float32 accumulators carry over the slices (h is the same
// per element, so only the order of the second product's sum changes). O
// above 128 is cut into slices of 128 output channels, one block each (the
// wrapper pads w2 and b2 with zero rows to whole slices); each such block
// recomputes the 3x3 conv of its pixels.
// Shared-memory rows are padded by 8 elements so that ldmatrix hits 32
// distinct banks. No wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // output pixels per block
constexpr int kKC = 32;      // input channels per chunk
constexpr int kXS = kKC + 8; // row stride of the staged input and w1 slice
constexpr int kThreads = 256;
constexpr int kMaxNT2 = 16;  // second product: at most 128 output channels

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// FS: the features of one slice (its accumulators); kMulti: F > FS slices.
template <int FS, bool kMulti>
__global__ void __launch_bounds__(kThreads, 1)
dpt_tail_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ m,  // may be null
                const __nv_bfloat16* __restrict__ w1,  // (9, F, C), tap = 3 dy + dx
                const float* __restrict__ b1,          // (F,)
                const __nv_bfloat16* __restrict__ w2,  // (O_pad, F)
                const float* __restrict__ b2,          // (O_pad,)
                __nv_bfloat16* __restrict__ out,       // (N, H, W, O)
                int H, int W, int C, int F, int O, int O_slice, int n_oslices) {
  constexpr int kNT = FS / 16;   // 8-channel n-tiles per warp (FS / 2 channels)
  constexpr int kHS = FS + 8;    // row stride of h and w2 in shared memory
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* sX = smem;                          // [3][kBM + 2][kXS]
  __nv_bfloat16* sW = smem + 3 * (kBM + 2) * kXS;    // [2][FS][kXS]
  __nv_bfloat16* sH = smem;                          // [kBM][kHS], after phase 1
  __nv_bfloat16* sW2 = smem + kBM * kHS;             // [O_slice][kHS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps over pixels x FS
  const int p0 = (blockIdx.x / n_oslices) * kBM;
  const int o0 = (blockIdx.x % n_oslices) * O_slice;  // this block's channels
  const int row = blockIdx.y;
  const int img = blockIdx.z;
  int f0 = 0;  // the current feature slice

  auto load_w1 = [&](int s, int buf) {
    const int tap = s % 9, c0 = (s / 9) * kKC;
    __nv_bfloat16* dst = sW + buf * FS * kXS;
    for (int u = tid; u < FS * (kKC / 8); u += kThreads) {
      const int n = u >> 2, q = u & 3;
      cp_async16(dst + n * kXS + q * 8,
                 w1 + (static_cast<long long>(tap) * F + f0 + n) * C + c0 + q * 8);
    }
    cp_async_commit();
  };

  auto load_x = [&](int c0) {
    for (int u = tid; u < 3 * (kBM + 2) * (kKC / 8); u += kThreads) {
      const int q = u & 3, px = (u >> 2) % (kBM + 2), dy = (u >> 2) / (kBM + 2);
      const int r = row + dy - 1, c = p0 + px - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0 && r < H && c >= 0 && c < W) {
        const long long off =
            ((static_cast<long long>(img) * H + r) * W + c) * C + c0 + q * 8;
        v = *reinterpret_cast<const uint4*>(a + off);
        if (m != nullptr) {
          const uint4 w = *reinterpret_cast<const uint4*>(m + off);
          const __nv_bfloat162* va = reinterpret_cast<const __nv_bfloat162*>(&v);
          const __nv_bfloat162* vm = reinterpret_cast<const __nv_bfloat162*>(&w);
          uint32_t s[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fa = __bfloat1622float2(va[e]);
            const float2 fm = __bfloat1622float2(vm[e]);
            s[e] = pack_bf16x2(fa.x + fm.x, fa.y + fm.y);
          }
          v = make_uint4(s[0], s[1], s[2], s[3]);
        }
      }
      *reinterpret_cast<uint4*>(sX + (dy * (kBM + 2) + px) * kXS + q * 8) = v;
    }
  };

  const int nt2 = O_slice / 8;
  float acc2[kMaxNT2][4];
#pragma unroll
  for (int nt = 0; nt < kMaxNT2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[nt][e] = 0.f;

  const int n_fs = kMulti ? F / FS : 1;
  for (int fs = 0; fs < n_fs; ++fs) {
    f0 = fs * FS;
    if (fs > 0) __syncthreads();  // the previous slice's h and w2 are consumed
    float acc[2][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    // ---- phase 1: 3x3 conv as 9 taps x C / 32 chunks of k = 32 ----
    const int steps = 9 * (C / kKC);
    load_w1(0, 0);
    for (int s = 0; s < steps; ++s) {
      const int tap = s % 9;
      if (tap == 0) load_x((s / 9) * kKC);  // the trailing barrier freed sX
      if (s + 1 < steps) {
        load_w1(s + 1, (s + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int dy = tap / 3, dx = tap % 3;
      const __nv_bfloat16* wb = sW + (s & 1) * FS * kXS;
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + (lane & 15);  // output pixel
          ldsm_x4(af[mt], sX + (dy * (kBM + 2) + r + dx) * kXS + kk * 16 +
                              (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bf[4];
          const int n = wn * (FS / 2) + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(bf, wb + n * kXS + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_16816(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            mma_16816(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
      __syncthreads();  // this buffer (and sX) may be overwritten next
    }

    // ---- h = bf16(relu(acc + b1)) into shared memory; w2 beside it ----
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = wn * (FS / 2) + nt * 8 + 2 * t;
        const float bb0 = b1[f0 + col], bb1 = b1[f0 + col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 32 + mt * 16 + g + 8 * half;
          *reinterpret_cast<uint32_t*>(sH + r * kHS + col) =
              pack_bf16x2(fmaxf(acc[mt][nt][2 * half] + bb0, 0.f),
                          fmaxf(acc[mt][nt][2 * half + 1] + bb1, 0.f));
        }
      }
    for (int u = tid; u < O_slice * (FS / 8); u += kThreads) {
      const int o = u / (FS / 8), q = u % (FS / 8);
      *reinterpret_cast<uint4*>(sW2 + o * kHS + q * 8) = *reinterpret_cast<const uint4*>(
          w2 + static_cast<long long>(o0 + o) * F + f0 + q * 8);
    }
    __syncthreads();

    // ---- phase 2: y += h w2^T, each warp 16 pixels x O_slice channels ----
#pragma unroll 4
    for (int ks = 0; ks < FS / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, sH + (warp * 16 + (lane & 15)) * kHS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < kMaxNT2; ++nt) {
        if (nt < nt2) {
          uint32_t b0, b1r;
          ldsm_x2(b0, b1r, sW2 + (nt * 8 + (lane & 7)) * kHS + ks * 16 +
                               ((lane >> 3) & 1) * 8);
          mma_16816(acc2[nt], af, b0, b1r);
        }
      }
    }
  }  // feature slices

  // ---- + b2, store the first O channels of the pixels inside the row ----
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = p0 + warp * 16 + g + 8 * half;
    if (p >= W) continue;
    __nv_bfloat16* dst = out + ((static_cast<long long>(img) * H + row) * W + p) * O;
#pragma unroll
    for (int nt = 0; nt < kMaxNT2; ++nt) {
      if (nt < nt2) {
        const int col = o0 + nt * 8 + 2 * t;
        if (col < O) dst[col] = __float2bfloat16_rn(acc2[nt][2 * half] + b2[col]);
        if (col + 1 < O)
          dst[col + 1] = __float2bfloat16_rn(acc2[nt][2 * half + 1] + b2[col + 1]);
      }
    }
  }
}

template <int FS, bool kMulti>
int launch(const void* a, const void* m, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int N, int H, int W,
           int C, int F, int O, int O_pad, cudaStream_t stream) {
  const int o_slice = O_pad < kMaxNT2 * 8 ? O_pad : kMaxNT2 * 8;
  const int n_os = O_pad / o_slice;
  const int phase1 = (3 * (kBM + 2) * kXS + 2 * FS * kXS) * 2;
  const int phase2 = (kBM + o_slice) * (FS + 8) * 2;
  const int smem = phase1 > phase2 ? phase1 : phase2;
  cudaError_t err = cudaFuncSetAttribute(
      dpt_tail_kernel<FS, kMulti>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((W + kBM - 1) / kBM) * n_os, H, N);
  dpt_tail_kernel<FS, kMulti><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(m),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), H, W, C, F, O, o_slice, n_os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, m: (N, H, W, C) bf16 (m may be null), C % 32 == 0; w1: (9, F, C) bf16;
// b1: (F,) float32; w2: (O_pad, F) bf16 and b2: (O_pad,) float32, zero rows
// past O, with O_pad a multiple of 8 when it is at most 128 and a multiple
// of 128 above; out: (N, H, W, O) bf16. F is a multiple of 128. All
// contiguous and 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an F or O_pad it does not
// take).
extern "C" int vs_dpt_tail(const void* a, const void* m, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           void* out, int N, int H, int W, int C, int F, int O,
                           int O_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slice = kMaxNT2 * 8;
  if (F <= 0 || F % 128 || O_pad % 8 || O_pad < O ||
      (O_pad > slice && O_pad % slice))
    return static_cast<int>(cudaErrorInvalidValue);
  if (F == 256)
    return launch<256, false>(a, m, w1, b1, w2, b2, out, N, H, W, C, F, O, O_pad, s);
  if (F == 128)
    return launch<128, false>(a, m, w1, b1, w2, b2, out, N, H, W, C, F, O, O_pad, s);
  return launch<128, true>(a, m, w1, b1, w2, b2, out, N, H, W, C, F, O, O_pad, s);
}
