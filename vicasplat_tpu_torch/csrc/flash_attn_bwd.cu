// K1 backward for Hopper: dQ, dK and dV of softmax(Q K^T / sqrt(64)) V, bf16
// in and out, float32 accumulation, through TMA, mbarrier rings and wgmma.
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
//   prep  D and lse * log2(e), one thread per (b, row, h), into buffers
//         padded to whole 64-row tiles (lse +inf and D 0 past Sq, so that a
//         padded query gets P = 0 with no test);
//   dkdv  one block per (64 keys, head, batch), walking the query tiles;
//   dq    one block per (64 queries, head, batch), walking the key tiles.
// Each block is one consumer warpgroup and one producer warp, as in the
// forward (flash_attn.cu): the producer's lane 0 loads the block's own tiles
// once and the walked tiles into a 2-stage ring by TMA (Q, dO, K, V as 4-D
// maps with the 128-byte swizzle; the tile's lse and D rows by bulk copy),
// on full and empty mbarriers.
//   dkdv computes S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, all
//   operands K-major in shared memory), so P^T and dS^T come out key-major
//   in the accumulators and feed dV += P^T dO and dK += dS^T Q straight
//   from registers as the A operand, with dO and Q read MN-major through
//   the descriptor's transpose bit.
//   dq computes S = Q K^T and dP = dO V^T the same way and dQ += dS K with
//   dS from registers and K read MN-major.
// No transposed copy is written. S and P are recomputed in both kernels:
// 7 products against the 5 of a design with atomic dQ, the price of a
// deterministic result.
//
// Bound on an H100 at the decoder shape at batch 2 (q (2, 2056, 12, 64), k/v
// (2, 2064, 12, 64)): five products of 2 * Sq * Sk * 64 operations each per
// head, 10 * Sq * Sk * H * 64 * B = 65 GFLOP, 0.066 ms at 989 TFLOP/s,
// against about 50 MB of inputs and outputs (0.015 ms at 3.35 TB/s): the
// tensor cores bound it. The two exponentials of each (query, key) pair add
// 2 * 102M MUFU operations, about 0.05 ms at 16 a clock an SM.
// Waves: 64-row tiles give 33 x 24 = 792 blocks for each kernel. dq holds
// dQ, S and dP (122 registers) and runs 3 blocks an SM: exactly 2 waves on
// 132 SMs. dkdv holds dK, dV, S^T and dP^T, 32 float32 accumulators each
// (158 registers), and runs 2 an SM: exactly 3 waves. At 3 an SM (128
// registers) it spilled and serialized its wgmmas, and walking each query
// tile in halves of 32 to fit was slower on the card than 2 an SM. No
// setmaxnreg (see flash_attn.cu). A tile's P^T and dS^T are packed into bf16
// A fragments as they are computed, so that the four accumulators and the
// two fragments fit.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, one call's device kernels by the profiler: 0.20-0.22 ms at the
// decoder shape at batch 2 (SDPA's backward 0.23-0.25 ms; the mma.sync
// design before it 0.84 ms), 0.09 ms at the encoder shape (16, 257, 16),
// level with SDPA's; errors equal to SDPA's to three digits.

#include "hopper.cuh"
#include "smem_limit.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int kD = 64;       // head dim
constexpr int kBT = 64;      // rows of a tile (queries or keys)
constexpr int kStages = 2;
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;
// dkdv holds four 64 x 64 float32 accumulators a thread (dK, dV, S^T,
// dP^T): 158 registers, so two of its blocks share an SM
constexpr int kDkdvBlocks = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kTileBytes = kBT * kD * 2;  // 8 KB

__global__ void flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                                      const __nv_bfloat16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      float* __restrict__ lse2,
                                      float* __restrict__ delta, int B, int Sq,
                                      int Sq_pad, int H) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Sq_pad * H) return;
  const int h = idx % H;
  const long long bi = idx / H;  // b * Sq_pad + i
  const int i = bi % Sq_pad, b = bi / Sq_pad;
  const long long out = ((long long)b * H + h) * Sq_pad + i;
  if (i >= Sq) {
    lse2[out] = INFINITY;
    delta[out] = 0.f;
    return;
  }
  const long long row = ((long long)b * Sq + i) * H + h;
  const uint4* po = reinterpret_cast<const uint4*>(o + row * kD);
  const uint4* pd = reinterpret_cast<const uint4*>(dout + row * kD);
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
  delta[out] = acc;
  lse2[out] = lse[((long long)b * H + h) * Sq + i] * kLog2e;
}

// The block's own two tiles (once) and a ring of two walked tiles a stage,
// plus the walked tiles' lse and D rows in dkdv.
struct __align__(1024) BwdSmem {
  __nv_bfloat16 own0[kBT * kD];   // dkdv: K; dq: Q
  __nv_bfloat16 own1[kBT * kD];   // dkdv: V; dq: dO
  __nv_bfloat16 walk0[kStages][kBT * kD];  // dkdv: Q; dq: K
  __nv_bfloat16 walk1[kStages][kBT * kD];  // dkdv: dO; dq: V
  float lse2[kStages][kBT];
  float delta[kStages][kBT];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t own_full;
};
constexpr int kSmemBytes = sizeof(BwdSmem) + 1024;  // + alignment slack

__device__ __forceinline__ void init_barriers(BwdSmem& s) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], kConsumers);
    }
    mbar_init(&s.own_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
}

// The producer's loop, run by lane 0 of warp 4: the block's own tiles at
// row `own0` of (map_o0, map_o1), then the n walked tiles of (map_w0,
// map_w1) and, when `lse2` is not null, their lse and D rows.
__device__ __forceinline__ void produce(BwdSmem& s, const CUtensorMap* map_o0,
                                        const CUtensorMap* map_o1,
                                        const CUtensorMap* map_w0,
                                        const CUtensorMap* map_w1, int own0,
                                        int n, int h, int b, const float* lse2,
                                        const float* delta) {
  mbar_expect_tx(&s.own_full, 2 * kTileBytes);
  tma_load_rows(s.own0, map_o0, &s.own_full, h, own0, b);
  tma_load_rows(s.own1, map_o1, &s.own_full, h, own0, b);
  const uint32_t bytes = 2 * kTileBytes + (lse2 != nullptr ? 2 * kBT * 4 : 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % kStages;
    mbar_wait(&s.empty[st], ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(&s.full[st], bytes);
    tma_load_rows(s.walk0[st], map_w0, &s.full[st], h, j * kBT, b);
    tma_load_rows(s.walk1[st], map_w1, &s.full[st], h, j * kBT, b);
    if (lse2 != nullptr) {
      bulk_load(s.lse2[st], lse2 + j * kBT, kBT * 4, &s.full[st]);
      bulk_load(s.delta[st], delta + j * kBT, kBT * 4, &s.full[st]);
    }
  }
}

// acc = X Y^T over the 64 head dims for two 64-row K-major tiles.
__device__ __forceinline__ void rows_product(float (&acc)[32], uint64_t dx,
                                             uint64_t dy) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_m64n64k16(acc, dx + 2 * kk, dy + 2 * kk, kk > 0);
}

// acc += A Y: A (64 x 64) as bf16 A fragments, 4 steps of 16; Y a 64-row
// tile read MN-major.
__device__ __forceinline__ void acc_product(float (&acc)[32],
                                            const uint32_t (&a)[4][4],
                                            uint64_t dy) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_m64n64k16_mn(acc, a[kk], dy + (2048 >> 4) * kk);
}

// Store a warpgroup's 64 rows x 64 of acc * scale as bf16, rows below n.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long tok,
                                           int row0, int n,
                                           const float (&acc)[32], float scale,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    if (row < n)
      *reinterpret_cast<uint32_t*>(base + (long long)row * tok + 8 * (i >> 2) +
                                   2 * t) =
          pack_bf16x2(acc[i] * scale, acc[i + 1] * scale);
  }
}

__global__ void __launch_bounds__(kThreads, kDkdvBlocks)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sq_pad,
                      int Sk, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Sq + kBT - 1) / kBT;
  init_barriers(s);

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      const long long off = ((long long)b * H + h) * Sq_pad;
      produce(s, &map_k, &map_v, &map_q, &map_do, k0, n_tiles, h, b,
              lse2 + off, delta + off);
    }
  } else {
    const int warp = tid >> 5, t = tid & 3;
    const float scale_log2 = scale * kLog2e;
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(&s.own_full, 0);
    const uint64_t d_k = desc_sw128(s.own0), d_v = desc_sw128(s.own1);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(&s.full[st], (j / kStages) & 1);
      const uint64_t d_q = desc_sw128(s.walk0[st]);
      const uint64_t d_do = desc_sw128(s.walk1[st]);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each
      float sc[32], dp[32];
      wgmma_fence();
      rows_product(sc, d_k, d_q);
      rows_product(dp, d_v, d_do);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P^T = 2^(S^T * scale_log2 - lse2[query]), dS^T = P^T (dP^T - D),
      // both packed into bf16 A fragments as they are made; accumulator i
      // holds query column 8(i>>2) + 2t + (i&1)
      const float* l2 = s.lse2[st];
      const float* dl = s.delta[st];
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = 8 * (i >> 2) + 2 * t;
        const float p0 = ex2(fmaf(sc[i], scale_log2, -l2[col]));
        const float p1 = ex2(fmaf(sc[i + 1], scale_log2, -l2[col + 1]));
        pa[i >> 3][(i & 7) >> 1] = pack_bf16x2(p0, p1);
        da[i >> 3][(i & 7) >> 1] = pack_bf16x2(p0 * (dp[i] - dl[col]),
                                               p1 * (dp[i + 1] - dl[col + 1]));
      }

      // dV += P^T dO and dK += dS^T Q, A from registers, B MN-major; the
      // fence follows the last write of the A fragments
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
      acc_product(dv_acc, pa, d_do);
      acc_product(dk_acc, da, d_q);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&s.empty[st]);
    }

    const long long tok = (long long)H * kD;
    const int row0 = k0 + 16 * warp + ((tid & 31) >> 2);
    store_rows(dk + (long long)b * Sk * tok + h * kD, tok, row0, Sk, dk_acc,
               scale, t);
    store_rows(dv + (long long)b * Sk * tok + h * kD, tok, row0, Sk, dv_acc,
               1.f, t);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sq_pad, int Sk,
                    int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Sk + kBT - 1) / kBT;
  init_barriers(s);

  if (tid >= kConsumers) {
    if (tid == kConsumers)
      produce(s, &map_q, &map_do, &map_k, &map_v, q0, n_tiles, h, b, nullptr,
              nullptr);
  } else {
    const int warp = tid >> 5, t = tid & 3;
    const int row0 = q0 + 16 * warp + ((tid & 31) >> 2);
    const float scale_log2 = scale * kLog2e;
    // this thread's rows' lse * log2(e) and D (padded: +inf and 0 past Sq)
    const long long off = ((long long)b * H + h) * Sq_pad + row0;
    const float l2[2] = {lse2[off], lse2[off + 8]};
    const float dl[2] = {delta[off], delta[off + 8]};
    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;

    mbar_wait(&s.own_full, 0);
    const uint64_t d_q = desc_sw128(s.own0), d_do = desc_sw128(s.own1);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(&s.full[st], (j / kStages) & 1);
      const uint64_t d_k = desc_sw128(s.walk0[st]);
      const uint64_t d_v = desc_sw128(s.walk1[st]);

      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys each
      float sc[32], dp[32];
      wgmma_fence();
      rows_product(sc, d_q, d_k);
      rows_product(dp, d_do, d_v);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - D) as bf16 A fragments, P = 0 for keys past Sk (TMA's
      // zero rows)
      const int k0 = j * kBT;
      const bool ragged = k0 + kBT > Sk;
      uint32_t da[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        const int col = k0 + 8 * (i >> 2) + 2 * t;
        float p0 = ex2(fmaf(sc[i], scale_log2, -l2[r]));
        float p1 = ex2(fmaf(sc[i + 1], scale_log2, -l2[r]));
        if (ragged) {
          p0 = col < Sk ? p0 : 0.f;
          p1 = col + 1 < Sk ? p1 : 0.f;
        }
        da[i >> 3][(i & 7) >> 1] = pack_bf16x2(p0 * (dp[i] - dl[r]),
                                               p1 * (dp[i + 1] - dl[r]));
      }

      // dQ += dS K, A from registers, K MN-major
      fence_regs(dq_acc);
      wgmma_fence();
      acc_product(dq_acc, da, d_k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      mbar_arrive(&s.empty[st]);
    }

    const long long tok = (long long)H * kD;
    store_rows(dq + (long long)b * Sq * tok + h * kD, tok, row0, Sq, dq_acc,
               scale, t);
  }
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, 64) bf16; k, v, dk, dv: (B, Sk, H, 64) bf16;
// lse: (B, H, Sq) float32 from the forward (natural log); scratch: float32
// of 2 * B * H * Sq_pad entries, Sq_pad = Sq rounded up to 64 (lse * log2(e)
// and D, padded). All contiguous and 16-byte aligned. Launches the three
// kernels on `stream` and returns the first error that is not 0: a
// cudaError_t, or kTensorMapError + the CUresult of a tensor map that could
// not be encoded.
extern "C" int vs_flash_attn_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* scratch, void* dq,
                                 void* dk, void* dv, int B, int Sq, int Sk,
                                 int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 0.125f;  // 1 / sqrt(64)
  CUtensorMap mq, mk, mv, mdo;
  int rc = encode_bshd_map(&mq, q, B, Sq, H, kBT);
  if (rc == 0) rc = encode_bshd_map(&mk, k, B, Sk, H, kBT);
  if (rc == 0) rc = encode_bshd_map(&mv, v, B, Sk, H, kBT);
  if (rc == 0) rc = encode_bshd_map(&mdo, dout, B, Sq, H, kBT);
  if (rc != 0) return kTensorMapError + rc;
  static smem_limit::Set set_dkdv, set_dq;
  {
    cudaError_t err = smem_limit::allow(flash_bwd_dkdv_kernel, kSmemBytes, set_dkdv);
    if (err == cudaSuccess) err = smem_limit::allow(flash_bwd_dq_kernel, kSmemBytes, set_dq);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int Sq_pad = (Sq + kBT - 1) / kBT * kBT;
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + (long long)B * H * Sq_pad;
  const long long rows = (long long)B * Sq_pad * H;
  flash_bwd_prep_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      lse2, delta, B, Sq, Sq_pad, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<<<dim3((Sk + kBT - 1) / kBT, H, B), kThreads,
                          kSmemBytes, st>>>(
      mq, mk, mv, mdo, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sq_pad, Sk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<<<dim3((Sq + kBT - 1) / kBT, H, B), kThreads,
                        kSmemBytes, st>>>(
      mq, mk, mv, mdo, lse2, delta, static_cast<__nv_bfloat16*>(dq), Sq, Sq_pad,
      Sk, H, scale);
  return static_cast<int>(cudaGetLastError());
}
