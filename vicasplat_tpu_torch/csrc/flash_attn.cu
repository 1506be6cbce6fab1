// K1: forward flash attention for Hopper, bf16 in and out, float32
// accumulation: TMA loads, an mbarrier ring and wgmma.
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
// 0.004 ms for the bytes at 3.35 TB/s). At head dim 64 the exponentials come
// close: Sq * Sk * H = 51M of them at 16 a clock an SM is about 0.013 ms too,
// so the softmax of one block has to overlap the products of another.
//
// Design. One block per (64 query rows, head, batch): one consumer
// warpgroup (warps 0-3) and one producer warp (warp 4).
// - The producer's lane 0 loads the Q tile once and then K and V tiles of
//   128 keys into a ring of 2 stages by TMA (the tensor described as the 4-D
//   map (64, H, S, B), a box of (64, 1, rows, 1), 128-byte swizzle), each
//   stage completed on a "full" mbarrier and handed back on an "empty" one.
// - The consumer runs S = Q K^T as wgmma m64n128k16 (Q and K K-major from
//   shared memory), the online softmax in registers in the log2 domain, and
//   O += P V as wgmma m64n64k16 with P taken from registers (its float32
//   accumulators converted to bf16 in place, the A-fragment layout) and V
//   read MN-major through the descriptor's transpose bit: no transposed
//   copy of V is written.
// - TMA fills rows past S with zeros, and a zero key has the logit 0, not
//   -inf: keys at or past Sk are masked by bounds in the last tile.
// - Every thread runs within the 128 registers that __launch_bounds__(160,
//   3) leaves it. setmaxnreg is not used: with a producer of one warp (not
//   a whole warpgroup), the consumer's setmaxnreg.inc never returned on the
//   H100 (a deadlock, in every register budget tried), and the consumer
//   needs no more than 128.
// Waves: at the decoder shape 64-row tiles give 33 x 12 = 396 blocks, exactly
// 3 an SM on 132 SMs (128-row tiles would give 204, 1.55 an SM). Three blocks
// fit: 73 KB of shared memory each (Q 8 KB, 2 stages of K and V at 32 KB)
// and 160 x 128 registers. Three consumer warpgroups an SM let one block's
// softmax run while another's products do. The encoder shape (8, 257, 16)
// gives 5 x 128 = 640 blocks, 1.6 waves, the last tile 1 row.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, one call's device time by the profiler: 0.034 ms at the decoder
// shape (SDPA 0.049 ms; the mma.sync design before it 0.118 ms), 0.017 ms at
// the encoder shape (8, 257, 16) (SDPA 0.018 ms); 128 registers, no spills.
//
// For training the kernel also writes each row's log-sum-exp of the scaled
// logits, lse = log(sum_j exp(q.k_j / 8)), in the natural-log domain, float32
// (B, H, Sq): the backward (flash_attn_bwd.cu) recomputes P from it. A null
// lse pointer skips the store.

#include "hopper.cuh"
#include "smem_limit.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int kD = 64;        // head dim
constexpr int kBM = 64;       // query rows per block (one warpgroup)
constexpr int kBN = 128;      // keys per stage
constexpr int kStages = 2;
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;

struct __align__(1024) FwdSmem {
  __nv_bfloat16 q[kBM * kD];             // 8 KB
  __nv_bfloat16 k[kStages][kBN * kD];    // 16 KB a stage
  __nv_bfloat16 v[kStages][kBN * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};
constexpr int kSmemBytes = sizeof(FwdSmem) + 1024;  // + alignment slack

__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,  // (B, H, Sq) or null
                 int Sq, int Sk, int H, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Sk + kBN - 1) / kBN;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], kConsumers);
    }
    mbar_init(&s.q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: lane 0 keeps the TMA loads in flight ----
    if (tid == kConsumers) {
      mbar_expect_tx(&s.q_full, kBM * kD * 2);
      tma_load_rows(s.q, &map_q, &s.q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&s.empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], 2 * kBN * kD * 2);
        tma_load_rows(s.k[st], &map_k, &s.full[st], h, j * kBN, b);
        tma_load_rows(s.v[st], &map_v, &s.full[st], h, j * kBN, b);
      }
    }
  } else {
    // ---- consumer warpgroup ----
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;

    // O, 64 x 64: element i at row 16w + g + 8((i>>1)&1), column
    // 8(i>>2) + 2t + (i&1) (the wgmma accumulator layout)
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // raw logits, rows g and g + 8
    float l_run[2] = {0.f, 0.f};  // this thread's part of each row's sum

    mbar_wait(&s.q_full, 0);
    const uint64_t dq = desc_sw128(s.q);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(&s.full[st], (j / kStages) & 1);

      // S = Q K^T: 64 x 128, over 4 steps of 16 dims
      float sc[64];
      const uint64_t dk = desc_sw128(s.k[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n128k16(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int k0 = j * kBN;
      if (k0 + kBN > Sk) {  // the ragged last tile: keys past Sk get -inf
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= Sk) sc[i] = -INFINITY;
      }

      // online softmax in the log2 domain: p = 2^((s - m) * scale_log2)
      float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i)
        m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sc[i]);
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
        alpha[r] = ex2((m_run[r] - m_new[r]) * scale_log2);  // 0 on tile 0
        m_run[r] = m_new[r];
        neg_m[r] = -m_new[r] * scale_log2;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], scale_log2, neg_m[r]));
        l_run[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: P as bf16 A fragments of 16 keys, V MN-major
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      const uint64_t dv = desc_sw128(s.v[st]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_m64n64k16_mn(acc, pa[kk], dv + (2048 >> 4) * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&s.empty[st]);  // this thread is done with the stage
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv[r] = 1.f / l_run[r];
    }
    const int row0 = q0 + 16 * warp + g;
    const long long tok = (long long)H * kD;  // elements between tokens
    __nv_bfloat16* ob = o + (long long)b * Sq * tok + h * kD;
    if (lse != nullptr && t == 0) {  // the four threads of a row agree
      float* lb = lse + ((long long)b * H + h) * Sq;
      const float ln2 = 0.6931471805599453f;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < Sq)
          lb[row0 + 8 * r] = m_run[r] * scale_log2 * ln2 + logf(l_run[r]);
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const int row = row0 + 8 * r;
      if (row < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row * tok + 8 * (i >> 2) +
                                     2 * t) =
            pack_bf16x2(acc[i] * inv[r], acc[i + 1] * inv[r]);
    }
  }
}

}  // namespace

// q, o: (B, Sq, H, 64) bf16; k, v: (B, Sk, H, 64) bf16; all contiguous and
// 16-byte aligned; lse: (B, H, Sq) float32, or null when no gradient is
// needed. Launches on `stream` and returns cudaGetLastError(), or
// kTensorMapError + the CUresult of a tensor map that could not be encoded.
extern "C" int vs_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int Sq, int Sk,
                                 int H, void* stream) {
  CUtensorMap mq, mk, mv;
  int rc = encode_bshd_map(&mq, q, B, Sq, H, kBM);
  if (rc == 0) rc = encode_bshd_map(&mk, k, B, Sk, H, kBN);
  if (rc == 0) rc = encode_bshd_map(&mv, v, B, Sk, H, kBN);
  if (rc != 0) return kTensorMapError + rc;
  static smem_limit::Set smem_set;
  const cudaError_t err = smem_limit::allow(flash_fwd_kernel, kSmemBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  const float scale_log2 = 1.4426950408889634f * 0.125f;  // log2(e)/sqrt(64)
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq,
      Sk, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
