// K1 backward: dQ, dK and dV of softmax(Q K^T / sqrt(64)) V, bf16 in and out,
// float32 accumulation.
//
// Replaces the backward of the Pallas TPU flash attention that
// vicasplat_tpu/models/vicanet.py:242 (_flash_unmasked) calls: the library's
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq kernels
// (jax/experimental/pallas/ops/tpu/flash_attention.py). Q (B, Sq, H, 64),
// K/V (B, Sk, H, 64), Sq != Sk allowed. On the TPU padded keys were
// segment-masked dummies; here a key or query past the end is masked by
// bounds: it gets P = 0 and receives no gradient.
//
// With S = Q K^T / 8, P = exp(S - lse) (lse from the forward, natural log,
// float32 (B, H, Sq)) and D = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  dQ = dS K / 8,
//   dK = dS^T Q / 8.
// Three kernels, none with float atomics, so the result is deterministic:
//   prep  D, one thread per (b, row, h);
//   dkdv  one block per (key tile of 64, head, batch), walking the query
//         tiles: each warp owns 16 keys, keeps its K and V rows in registers
//         as mma A fragments, and accumulates dK and dV (64 x 64 float32 per
//         block) in registers;
//   dq    one block per (query tile of 64, head, batch), walking the key
//         tiles: each warp owns 16 query rows and keeps Q and dO as A
//         fragments.
// Both recompute S and P; P and dS enter the products rounded to bf16.
//
// Bound on an H100 at the decoder shape at batch 2 (q (2, 2056, 12, 64), k/v
// (2, 2064, 12, 64)): five products of 2 * Sq * Sk * 64 operations each per
// head, 10 * Sq * Sk * H * 64 * B = 65 GFLOP, 0.066 ms at 989 TFLOP/s,
// against about 50 MB of inputs and outputs (0.015 ms at 3.35 TB/s): the
// tensor cores bound it. The design is simple first (mma.sync m16n8k16,
// no cp.async pipeline, no wgmma or TMA): the transposed copies in shared
// memory (Q^T and dO^T in dkdv, K^T in dq) are written element by element,
// and S and P are recomputed in both kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;       // head dim
constexpr int kBT = 64;      // rows of a tile (queries or keys)
constexpr int kPad = 72;     // shared-memory row stride, in bf16 elements
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

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

// Copy a tile of 64 rows x 64 dims from (row stride `tok`) global memory into
// shared memory, row-major (`dst`, may be null) and/or transposed (`dst_t`,
// [dim][row], may be null); rows at or past `n` read as zeros.
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, long long tok,
                                          int r0, int n, __nv_bfloat16* dst,
                                          __nv_bfloat16* dst_t) {
  for (int i = threadIdx.x; i < kBT * (kD / 8); i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * tok + c);
    if (dst != nullptr) *reinterpret_cast<uint4*>(&dst[r * kPad + c]) = val;
    if (dst_t != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * kPad + r] = e[j];
    }
  }
}

// A fragments of a warp's 16 rows (from row `wr`) of a row-major smem tile.
__device__ __forceinline__ void load_a(uint32_t f[4][4], const __nv_bfloat16* s,
                                       int wr, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t * 2;
    f[kk][0] = ld_u32(&s[(wr + g) * kPad + c]);
    f[kk][1] = ld_u32(&s[(wr + g + 8) * kPad + c]);
    f[kk][2] = ld_u32(&s[(wr + g) * kPad + c + 8]);
    f[kk][3] = ld_u32(&s[(wr + g + 8) * kPad + c + 8]);
  }
}

// acc[8][4] (16 rows x 64 cols) += A (16 x 64, registers) B^T, where B is a
// row-major smem tile whose rows are the 64 output columns: the product
// over the shared 64-wide axis.
__device__ __forceinline__ void mma_rows(float acc[8][4], const uint32_t a[4][4],
                                         const __nv_bfloat16* s, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* p = &s[(nt * 8 + g) * kPad + kk * 16 + t * 2];
      mma_16816(acc[nt], a[kk], ld_u32(p), ld_u32(p + 8));
    }
}

// acc[8][4] += X B, where X (16 x 64) is given as float accumulators
// x[8][4] (rounded to bf16 here) and B^T is an smem tile [col][k].
__device__ __forceinline__ void mma_acc(float acc[8][4], const float x[8][4],
                                        const __nv_bfloat16* s_t, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const __nv_bfloat16* p = &s_t[(dt * 8 + g) * kPad + kk * 16 + t * 2];
      mma_16816(acc[dt], a, ld_u32(p), ld_u32(p + 8));
    }
  }
}

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// Store a warp's 16 rows x 64 of acc * scale as bf16, rows below n only.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long tok,
                                           int row0, int n, const float acc[8][4],
                                           float scale, int g, int t) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (row0 + g < n)
      *reinterpret_cast<uint32_t*>(base + (long long)(row0 + g) * tok + c) =
          pack_bf16x2(acc[dt][0] * scale, acc[dt][1] * scale);
    if (row0 + g + 8 < n)
      *reinterpret_cast<uint32_t*>(base + (long long)(row0 + g + 8) * tok + c) =
          pack_bf16x2(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

__global__ void flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                                      const __nv_bfloat16* __restrict__ dout,
                                      float* __restrict__ delta, int B, int Sq,
                                      int H) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Sq * H) return;
  const int h = idx % H;
  const long long bi = idx / H;  // b * Sq + i
  const int i = bi % Sq, b = bi / Sq;
  const uint4* po = reinterpret_cast<const uint4*>(o + idx * kD);
  const uint4* pd = reinterpret_cast<const uint4*>(dout + idx * kD);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kD / 8; ++c) {
    const uint4 vo = po[c], vd = pd[c];
    const __nv_bfloat162* eo = reinterpret_cast<const __nv_bfloat162*>(&vo);
    const __nv_bfloat162* ed = reinterpret_cast<const __nv_bfloat162*>(&vd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fo = __bfloat1622float2(eo[j]);
      const float2 fd = __bfloat1622float2(ed[j]);
      acc += fo.x * fd.x + fo.y * fd.y;
    }
  }
  delta[((long long)b * H + h) * Sq + i] = acc;
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                      float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBT * kPad];    // [query][dim]
  __shared__ __align__(16) __nv_bfloat16 sQt[kD * kPad];    // [dim][query]
  __shared__ __align__(16) __nv_bfloat16 sdO[kBT * kPad];   // [query][dim]
  __shared__ __align__(16) __nv_bfloat16 sdOt[kD * kPad];   // [dim][query]
  __shared__ float sL[kBT];  // lse in the log2 domain; +inf past Sq
  __shared__ float sDl[kBT];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const long long tok = (long long)H * kD;
  const __nv_bfloat16* qb = q + (long long)b * Sq * tok + h * kD;
  const __nv_bfloat16* kb = k + (long long)b * Sk * tok + h * kD;
  const __nv_bfloat16* vb = v + (long long)b * Sk * tok + h * kD;
  const __nv_bfloat16* db = dout + (long long)b * Sq * tok + h * kD;
  const float* lb = lse + ((long long)b * H + h) * Sq;
  const float* deb = delta + ((long long)b * H + h) * Sq;
  const float scale_log2 = scale * kLog2e;
  const int wr = warp * 16;

  // this warp's 16 keys and values as A fragments (keys past Sk are zeros)
  uint32_t kf[4][4], vf[4][4];
  load_tile(kb, tok, k0, Sk, sQ, nullptr);
  load_tile(vb, tok, k0, Sk, sdO, nullptr);
  __syncthreads();
  load_a(kf, sQ, wr, g, t);
  load_a(vf, sdO, wr, g, t);

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);

  const int n_tiles = (Sq + kBT - 1) / kBT;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kBT;
    __syncthreads();  // the previous tile (or the K/V staging) is consumed
    load_tile(qb, tok, q0, Sq, sQ, sQt);
    load_tile(db, tok, q0, Sq, sdO, sdOt);
    for (int r = threadIdx.x; r < kBT; r += kThreads) {
      const bool in = q0 + r < Sq;
      sL[r] = in ? lb[q0 + r] * kLog2e : INFINITY;
      sDl[r] = in ? deb[q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T (16 keys x 64 queries) and dP^T = V dO^T
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_rows(s, kf, sQ, g, t);
    mma_rows(dp, vf, sdO, g, t);
    // P^T = exp2(S^T * scale_log2 - lse2[query]); dS^T = P^T (dP^T - D)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        const float p = exp2f(s[nt][e] * scale_log2 - sL[col]);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDl[col]);
      }
    mma_acc(dv_acc, s, sdOt, g, t);   // dV += P^T dO
    mma_acc(dk_acc, dp, sQt, g, t);   // dK += dS^T Q
  }

  __nv_bfloat16* dkb = dk + (long long)b * Sk * tok + h * kD;
  __nv_bfloat16* dvb = dv + (long long)b * Sk * tok + h * kD;
  store_rows(dkb, tok, k0 + wr, Sk, dk_acc, scale, g, t);
  store_rows(dvb, tok, k0 + wr, Sk, dv_acc, 1.f, g, t);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                    float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[kBT * kPad];   // [key][dim]
  __shared__ __align__(16) __nv_bfloat16 sV[kBT * kPad];   // [key][dim]
  __shared__ __align__(16) __nv_bfloat16 sKt[kD * kPad];   // [dim][key]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const long long tok = (long long)H * kD;
  const __nv_bfloat16* qb = q + (long long)b * Sq * tok + h * kD;
  const __nv_bfloat16* kb = k + (long long)b * Sk * tok + h * kD;
  const __nv_bfloat16* vb = v + (long long)b * Sk * tok + h * kD;
  const __nv_bfloat16* db = dout + (long long)b * Sq * tok + h * kD;
  const float scale_log2 = scale * kLog2e;
  const int wr = warp * 16;

  // this warp's 16 query rows of Q and dO as A fragments, and their stats
  uint32_t qf[4][4], df[4][4];
  load_tile(qb, tok, q0, Sq, sK, nullptr);
  load_tile(db, tok, q0, Sq, sV, nullptr);
  __syncthreads();
  load_a(qf, sK, wr, g, t);
  load_a(df, sV, wr, g, t);
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    const long long off = ((long long)b * H + h) * Sq + row;
    l2[r] = row < Sq ? lse[off] * kLog2e : INFINITY;
    dl[r] = row < Sq ? delta[off] : 0.f;
  }

  float dq_acc[8][4];
  zero(dq_acc);
  const int n_tiles = (Sk + kBT - 1) / kBT;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBT;
    __syncthreads();  // the previous tile (or the Q/dO staging) is consumed
    load_tile(kb, tok, k0, Sk, sK, sKt);
    load_tile(vb, tok, k0, Sk, sV, nullptr);
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_rows(s, qf, sK, g, t);   // S = Q K^T
    mma_rows(dp, df, sV, g, t);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const float p =
            col < Sk ? exp2f(s[nt][e] * scale_log2 - l2[e >> 1]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
      }
    mma_acc(dq_acc, dp, sKt, g, t);  // dQ += dS K
  }

  __nv_bfloat16* dqb = dq + (long long)b * Sq * tok + h * kD;
  store_rows(dqb, tok, q0 + wr, Sq, dq_acc, scale, g, t);
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, 64) bf16; k, v, dk, dv: (B, Sk, H, 64) bf16;
// lse: (B, H, Sq) float32 from the forward (natural log); delta: (B, H, Sq)
// float32 scratch. All contiguous and 16-byte aligned. Launches the three
// kernels on `stream` and returns the first cudaGetLastError() that is not 0.
extern "C" int vs_flash_attn_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int Sq, int Sk,
                                 int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 0.125f;  // 1 / sqrt(64)
  const auto* bq = static_cast<const __nv_bfloat16*>(q);
  const auto* bk = static_cast<const __nv_bfloat16*>(k);
  const auto* bv = static_cast<const __nv_bfloat16*>(v);
  const auto* bdo = static_cast<const __nv_bfloat16*>(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  const long long rows = (long long)B * Sq * H;
  flash_bwd_prep_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), bdo, fd, B, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<<<dim3((Sk + kBT - 1) / kBT, H, B), kThreads, 0, st>>>(
      bq, bk, bv, bdo, fl, fd, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<<<dim3((Sq + kBT - 1) / kBT, H, B), kThreads, 0, st>>>(
      bq, bk, bv, bdo, fl, fd, static_cast<__nv_bfloat16*>(dq), Sq, Sk, H,
      scale);
  return static_cast<int>(cudaGetLastError());
}
