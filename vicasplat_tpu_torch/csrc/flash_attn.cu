// K1: forward flash attention, bf16 in and out, float32 accumulation.
//
// Replaces the Pallas TPU flash-attention kernel that
// vicasplat_tpu/models/vicanet.py:242 (_flash_unmasked) calls for the mix
// decoder's joint image attention: softmax(Q K^T / sqrt(64)) V with no mask,
// Q (B, Sq, H, 64) and K/V (B, Sk, H, 64), Sq != Sk allowed. On the TPU the
// sequences were padded to multiples of 512 with segment ids; here the
// ragged last tiles are masked by bounds instead.
//
// Bound on an H100 at the decoder shape (1, 2056/2064, 12, 64): the two
// products are 4 * Sq * Sk * H * 64 = 13.0 GFLOP against 12.7 MB of inputs
// and output, so the tensor cores bound it (0.013 ms at 989 TFLOP/s, against
// 0.004 ms for the bytes at 3.35 TB/s).
//
// Design (simple first): one block of 4 warps per (query tile of 64, head,
// batch). Each warp owns 16 query rows and keeps them in registers as mma
// A fragments. The block walks the key tiles of 64: K and V (V stored
// transposed) go through shared memory, S = Q K^T and O += P V run on
// mma.sync m16n8k16 bf16 with float32 accumulators, and the softmax is the
// online (running max and sum) form in registers, in the log2 domain. Rows
// of shared memory are padded to 72 elements so that the fragment loads hit
// 32 distinct banks. No cp.async pipelining, TMA or wgmma yet: the loads and
// the products of one tile do not overlap.
//
// For training the kernel also writes each row's log-sum-exp of the scaled
// logits, lse = log(sum_j exp(q.k_j / 8)), in the natural-log domain, float32
// (B, H, Sq): the backward (flash_attn_bwd.cu) recomputes P = exp(S - lse)
// from it. A null lse pointer skips the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;       // head dim
constexpr int kBM = 64;      // query rows per block
constexpr int kBN = 64;      // keys per tile
constexpr int kPad = 72;     // shared-memory row stride, in bf16 elements
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,  // (B, H, Sq) or null
                 int Sq, int Sk, int H, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBM * kPad];
  __shared__ __align__(16) __nv_bfloat16 sK[kBN * kPad];
  __shared__ __align__(16) __nv_bfloat16 sVt[kD * kPad];  // [dim][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long tok = (long long)H * kD;  // elements between tokens
  const __nv_bfloat16* qb = q + (long long)b * Sq * tok + h * kD;
  const __nv_bfloat16* kb = k + (long long)b * Sk * tok + h * kD;
  const __nv_bfloat16* vb = v + (long long)b * Sk * tok + h * kD;

  // Q tile: 64 rows of 8 16-byte chunks; rows past Sq read as zeros
  for (int i = tid; i < kBM * (kD / 8); i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * tok + c);
    *reinterpret_cast<uint4*>(&sQ[r * kPad + c]) = val;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[4][4];  // A fragments of this warp's 16 rows, 4 k-steps of 16
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = ld_u32(&sQ[(wr + g) * kPad + c]);
    qf[kk][1] = ld_u32(&sQ[(wr + g + 8) * kPad + c]);
    qf[kk][2] = ld_u32(&sQ[(wr + g) * kPad + c + 8]);
    qf[kk][3] = ld_u32(&sQ[(wr + g + 8) * kPad + c + 8]);
  }

  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int n_tiles = (Sk + kBN - 1) / kBN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBN * (kD / 8); i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Sk) {  // keys past Sk read as zeros (their P is 0)
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * tok + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * tok + c);
      }
      *reinterpret_cast<uint4*>(&sK[r * kPad + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * kPad + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &sK[(nt * 8 + g) * kPad + kk * 16 + t * 2];
        mma_16816(s[nt], qf[kk], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // online softmax; accumulator element e sits in row g + 8 * (e >> 1)
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const float x = col < Sk ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      alpha[r] = exp2f(m_run[r] - m_new[r]);  // 0 on the first tile
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two adjacent n-tiles form one A
    // fragment of 16 keys; V^T rows give the B fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const __nv_bfloat16* vr = &sVt[(dt * 8 + g) * kPad + kk * 16 + t * 2];
        mma_16816(acc[dt], pa, ld_u32(vr), ld_u32(vr + 8));
      }
    }
  }

  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  const int row0 = q0 + wr + g;
  const int row1 = row0 + 8;
  __nv_bfloat16* ob = o + (long long)b * Sq * tok + h * kD;
  if (lse != nullptr && t == 0) {  // the four threads of a row group agree
    float* lb = lse + ((long long)b * H + h) * Sq;
    const float ln2 = 0.6931471805599453f;
    if (row0 < Sq) lb[row0] = (m_run[0] + log2f(l_run[0])) * ln2;
    if (row1 < Sq) lb[row1] = (m_run[1] + log2f(l_run[1])) * ln2;
  }
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * tok + c) =
          pack_bf16x2(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row1 * tok + c) =
          pack_bf16x2(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

}  // namespace

// q, o: (B, Sq, H, 64) bf16; k, v: (B, Sk, H, 64) bf16; all contiguous and
// 16-byte aligned; lse: (B, H, Sq) float32, or null when no gradient is
// needed. Launches on `stream` and returns cudaGetLastError().
extern "C" int vs_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int Sq, int Sk,
                                 int H, void* stream) {
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  const float scale_log2 = 1.4426950408889634f * 0.125f;  // log2(e)/sqrt(64)
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
