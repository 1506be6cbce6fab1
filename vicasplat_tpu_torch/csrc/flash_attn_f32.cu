// K1's float32 route on Hopper's tensor cores: forward and backward flash
// attention on float32 tensors at any head dim D <= 128, each float32
// product taken as three TF32 products by wgmma (3xTF32).
//
// Replaces the Pallas TPU flash-attention kernel behind
// vicasplat_tpu/models/vicanet.py:242 (_flash_unmasked) and its library VJP
// (_flash_attention_bwd_dkv, _flash_attention_bwd_dq) where the JAX package
// runs them in float32: every run whose trainer.precision is not bfloat16
// (configs/experiment/_tiny_smoke.yaml: decoder heads of D = 12), and bf16
// tensors at a head dim other than 64, which the wrapper upcasts. Same
// functions as the bf16 kernels (flash_attn.cu, flash_attn_bwd.cu): out =
// softmax(Q K^T / sqrt(D)) V with its row log-sum-exp (natural log, float32
// (B, H, Sq)), and dQ, dK, dV from lse and D = rowsum(dO o O), with no float
// atomics, so the backward is deterministic.
//
// Precision. One TF32 product (10 mantissa bits) per float32 product leaves
// attention 3e-4 to 6e-4 off at the repository's shapes, above the 1e-4 the
// route is held to. So every operand x is split into big = rna(x) and
// small = rna(x - big) (cvt.rna.tf32.f32), and A B is taken as
// Ab Bb + Ab Bs + As Bb: three wgmmas into the same float32 accumulators
// (about 3e-7). The softmax, its running max and sum, the rescaling and D
// stay float32, in the log2 domain. P (and dS in the backward) are split in
// registers before they feed a product. kernels/flash_attn.py's
// flash_f32_split_walk repeats this arithmetic tile by tile on the CPU.
//
// Bound on an H100: three TF32 products at 495 TFLOP/s give 165 TFLOP/s of
// float32-accurate products. At the decoder shape in float32 (q (1, 2056,
// 12, 64), k/v (1, 2064, 12, 64)) the forward's 13.0 GFLOP take 0.079 ms and
// the backward's 32.6 GFLOP 0.198 ms, against 25 MB and 51 MB of inputs and
// outputs (0.008 and 0.015 ms at 3.35 TB/s): the products bound it.
//
// Design. TF32 wgmma has no transpose bit: both operands are read K-major
// (the reduced index contiguous). So the products that reduce over keys or
// queries (O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q) read V, K, dO
// and Q transposed, and every operand is held twice (big and small).
// - A block is one consumer warpgroup (warps 0-3) and one producer
//   warpgroup (warps 4-7). The producers read float32 rows from device
//   memory with plain loads, split each value and write both parts into
//   128-byte-swizzled shared memory in the layout its product reads: as the
//   rows are ("rows" tiles: 32 floats to a 128-byte row, a tile of DP head
//   dims being DP / 32 such column blocks), or transposed ("cols" tiles: a
//   row per head dim, 32 keys or queries to it), with rows past S and head
//   dims past D zero. Splitting in shared memory, not in a prep kernel that
//   writes split copies to device memory, keeps the entry points' argument
//   lists (the forward has no scratch), adds no launch at the tiny
//   configuration's launch-bound shapes and no device-memory traffic; TMA
//   is not used because a row of D floats sits at a stride of H * D floats,
//   not 16-byte aligned when D % 4 != 0. The price is the producers' ALU
//   work and shared-memory stores, beside the consumers' products.
// - A block's own tile of 64 rows (Q in the forward and dq, dO in dq, K and
//   V in dkdv) is written once; the walked tiles of 32 rows pass through a
//   ring of slots on full and empty mbarriers.
// - P's accumulators become the A fragment in place. The accumulator gives a
//   thread keys 2t and 2t + 1 of each 8, the tf32 A fragment wants
//   k-columns t and t + 4 (CUTLASS's ALayout_64x8), so a cols tile stores
//   key 8i + pi(c) at column 8i + c, pi = (0, 2, 4, 6, 1, 3, 5, 7): the sum
//   over keys does not depend on their order.
// - A zero key (past Sk) has the logit 0, not -inf: keys at or past Sk are
//   masked by bounds (-inf in the forward, P = 0 in dq); queries at or past
//   Sq get lse = +inf, so P = 0 in dkdv.
// - Head dims are padded with zeros to DP = 32, 64, 96 or 128. Shared memory
//   a block: the forward 512 DP bytes own and 2 slots of 512 DP (97 KB at
//   DP 64: 2 blocks an SM, 396 blocks at the decoder shape); the backward
//   1024 DP own and as many slots of about 512 DP as fit in 200 KB (1 block
//   an SM). No setmaxnreg (see flash_attn.cu).
// The backward is three kernels, as in flash_attn_bwd.cu: prep (D, one
// thread a row); dkdv (a block owns 64 keys and walks the query tiles:
// S^T = K Q^T and dP^T = V dO^T with K and V its own, then dV += P^T dO and
// dK += dS^T Q from registers against dO and Q transposed); dq (a block owns
// 64 queries and walks the key tiles: S = Q K^T, dP = dO V^T, then dQ += dS K
// against K transposed). A walked tile is two items of the ring: its rows
// (with the queries' lse and D in dkdv), then its cols.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, one call's device time: at the decoder shape the forward 0.27 ms
// and the backward 0.94 ms (SDPA in float32 0.42 and 1.28; the SIMT design
// before this one 1.50 and 5.30), at the tiny configuration's shape 0.0041
// and 0.0126 ms (SDPA 0.0082 and 0.0228); within 3.1e-5 of the float32
// plain versions. The producers' device-memory reads bound it
// (diagnostics/k1_f32_variants.py).

#include "hopper.cuh"
#include "smem_limit.cuh"

#include <math.h>

// Diagnostic switch, for diagnostics/k1_f32_variants.py only (the build
// leaves it at 0): K1F32_MODE 1 runs the products without the producers'
// loads, splits and stores ("products only"), 2 the loads, splits and
// stores without the products ("loads only"), 3 the splits and stores of
// values made up in registers, with no device-memory read and no product
// ("stores only"); their outputs are meaningless.
#ifndef K1F32_MODE
#define K1F32_MODE 0
#endif

namespace {

using namespace hopper;

constexpr int kOwn = 64;    // rows of a block's own tile: one wgmma's M
constexpr int kWalk = 32;   // rows of a walked tile: one 128-byte cols row
constexpr int kConsumers = 128;
constexpr int kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kRingBudget = 200 * 1024;  // own tiles and ring of a backward block
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of a tile of `rows` x dp floats, both parts (big, then small).
__host__ __device__ constexpr int tile_bytes(int rows, int dp) { return 2 * rows * dp * 4; }

__host__ __device__ constexpr int clamp_slots(int n) { return n < 1 ? 1 : (n > 4 ? 4 : n); }

enum Kind { kFwd = 0, kDkdv = 1, kDq = 2 };

// A kernel's shared memory: own tiles, then the ring's slots (a walked
// tile's rows or cols of two operands; in dkdv also 32 lse and 32 D), then
// the mbarriers.
template <int DP, int KIND>
struct Plan {
  static constexpr int own = (KIND == kFwd ? 1 : 2) * tile_bytes(kOwn, DP);
  static constexpr int slot = 2 * tile_bytes(kWalk, DP) + (KIND == kDkdv ? 1024 : 0);
  static constexpr int slots =
      KIND == kFwd ? 2 : clamp_slots((kRingBudget - own) / slot);
  static constexpr int bars = own + slots * slot;
  static constexpr int smem = bars + 8 * (2 * slots + 1) + 1024;  // + alignment
  static constexpr int min_blocks =
      (KIND == kFwd && DP <= 64) || (KIND == kDq && DP <= 32) ? 2 : 1;
};

// ---- producers: float32 rows into split, swizzled tiles ----

// Floats d0..d0+3 of row r of an operand whose row r starts at
// src + r * stride; zeros at rows >= n and head dims >= D.
__device__ __forceinline__ float4 load4(const float* __restrict__ src,
                                        long long stride, int r, int n, int d0,
                                        int D) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (K1F32_MODE == 3) return make_float4(r, d0, n, D);
  if (r >= n || d0 >= D) return x;
  const float* p = src + r * stride + d0;
  if ((D & 3) == 0) return __ldg(reinterpret_cast<const float4*>(p));
  x.x = __ldg(p);
  if (d0 + 1 < D) x.y = __ldg(p + 1);
  if (d0 + 2 < D) x.z = __ldg(p + 2);
  if (d0 + 3 < D) x.w = __ldg(p + 3);
  return x;
}

// The chunks of 4 floats a producer thread owns in a tile of ROWS rows: its
// it-th is row r, head dims 4q..4q+3. A warp takes 8 rows x 4 chunks: its
// loads are 64-byte pieces of rows, its 16-byte stores into a rows tile
// fall in 8 distinct chunks of 8 distinct rows (no bank conflict) and its
// 4-byte stores into a cols tile in 16 banks.
template <int ROWS, int DP>
struct Chunks {
  static constexpr int n = ROWS * DP / 4 / kProducers;
};

template <int ROWS>
__device__ __forceinline__ void chunk_at(int it, int ptid, int& r, int& q) {
  const int wb = it * (kProducers / 32) + (ptid >> 5);
  r = 8 * (wb % (ROWS / 8)) + (ptid & 7);
  q = 4 * (wb / (ROWS / 8)) + ((ptid >> 3) & 3);
}

// This thread's chunks of rows 0..ROWS-1 of an operand whose row r starts
// at src + r * stride, n of them valid: every load issued before any is used.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(float4 (&x)[Chunks<ROWS, DP>::n],
                                          const float* src, long long stride,
                                          int n, int D, int ptid) {
#pragma unroll
  for (int it = 0; it < Chunks<ROWS, DP>::n; ++it) {
    int r, q;
    chunk_at<ROWS>(it, ptid, r, q);
    x[it] = load4(src, stride, r, n, 4 * q, D);
  }
}

// Split this thread's chunks into a rows tile: part p, row r, head dim d at
// p ROWS DP 4 + (d / 32) ROWS 128 + r 128 + the 16-byte chunk
// ((d % 32) / 4) ^ (r % 8).
template <int ROWS, int DP>
__device__ __forceinline__ void put_rows(uint8_t* tile,
                                         const float4 (&x)[Chunks<ROWS, DP>::n],
                                         int ptid) {
  if (K1F32_MODE == 1) return;
#pragma unroll
  for (int it = 0; it < Chunks<ROWS, DP>::n; ++it) {
    int r, q;
    chunk_at<ROWS>(it, ptid, r, q);
    uint4 big, small;
    split_tf32(x[it].x, big.x, small.x);
    split_tf32(x[it].y, big.y, small.y);
    split_tf32(x[it].z, big.z, small.z);
    split_tf32(x[it].w, big.w, small.w);
    const int off = (q >> 3) * ROWS * 128 + r * 128 + (((q & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(tile + off) = big;
    *reinterpret_cast<uint4*>(tile + ROWS * DP * 4 + off) = small;
  }
}

// Split this thread's chunks of a walked tile into a cols tile: part p,
// head dim d, row r at p DP 128 + d 128 + column c of the 128-byte row
// (chunk (c / 4) ^ (d % 8)), c = 8 (r / 8) + pi^-1(r % 8).
template <int DP>
__device__ __forceinline__ void put_cols(uint8_t* tile,
                                         const float4 (&x)[Chunks<kWalk, DP>::n],
                                         int ptid) {
  if (K1F32_MODE == 1) return;
#pragma unroll
  for (int it = 0; it < Chunks<kWalk, DP>::n; ++it) {
    int r, q;
    chunk_at<kWalk>(it, ptid, r, q);
    const float v[4] = {x[it].x, x[it].y, x[it].z, x[it].w};
    const int col = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * q + e;
      const int off = d * 128 + (((col >> 2) ^ (d & 7)) << 4) + (col & 3) * 4;
      uint32_t big, small;
      split_tf32(v[e], big, small);
      *reinterpret_cast<uint32_t*>(tile + off) = big;
      *reinterpret_cast<uint32_t*>(tile + DP * 128 + off) = small;
    }
  }
}

// A block's own tile of kOwn rows, loaded and put at once.
template <int DP>
__device__ __forceinline__ void fill_own(uint8_t* tile, const float* src,
                                         long long stride, int n, int D,
                                         int ptid) {
  float4 x[Chunks<kOwn, DP>::n];
  load_tile<kOwn, DP>(x, src, stride, n, D, ptid);
  put_rows<kOwn, DP>(tile, x, ptid);
}

// This producer thread's writes are done: order them before the consumers'
// wgmma reads (the async proxy) and arrive.
__device__ __forceinline__ void produced(uint64_t* bar) {
  fence_proxy_async();
  mbar_arrive(bar);
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          uint64_t* own_full, int slots) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], kProducers);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(own_full, kProducers);
    fence_barrier_init();
  }
  __syncthreads();
}

// ---- consumers: 3xTF32 products ----

// acc (64 x 32) (+)= A B^T over DP head dims: A a 64-row own rows tile, B a
// 32-row walked rows tile (descriptors of their starts); each of the DP / 8
// steps takes Ab Bb + Ab Bs + As Bb.
template <int DP>
__device__ __forceinline__ void rows_product(float (&acc)[16], uint64_t da,
                                             uint64_t db) {
  if (K1F32_MODE >= 2) return;
  constexpr uint32_t a_small = (kOwn * DP * 4) >> 4, b_small = (kWalk * DP * 4) >> 4;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const uint32_t ka = ((kk >> 2) * kOwn * 128 + (kk & 3) * 32) >> 4;
    const uint32_t kb = ((kk >> 2) * kWalk * 128 + (kk & 3) * 32) >> 4;
    wgmma_ss_tf32_n32(acc, da + ka, db + kb, kk > 0);
    wgmma_ss_tf32_n32(acc, da + ka, db + b_small + kb, 1);
    wgmma_ss_tf32_n32(acc, da + a_small + ka, db + kb, 1);
  }
}

// The A fragments of a 64 x 32 accumulator, split: step kk's (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4) take keys 8 kk + 2t (rows g, g + 8) and
// 8 kk + 2t + 1, matching the cols tiles' key order.
__device__ __forceinline__ void split_frags(const float (&x)[16],
                                            uint32_t (&big)[4][4],
                                            uint32_t (&small)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_tf32(x[4 * kk + 0], big[kk][0], small[kk][0]);
    split_tf32(x[4 * kk + 2], big[kk][1], small[kk][1]);
    split_tf32(x[4 * kk + 1], big[kk][2], small[kk][2]);
    split_tf32(x[4 * kk + 3], big[kk][3], small[kk][3]);
  }
}

// acc (64 x DP) += A B over 32 keys or queries: A from split fragments, B a
// cols tile (DP rows).
template <int DP>
__device__ __forceinline__ void cols_product(float (&acc)[DP / 2],
                                             const uint32_t (&ab)[4][4],
                                             const uint32_t (&as)[4][4],
                                             uint64_t db) {
  if (K1F32_MODE >= 2) return;
  constexpr uint32_t b_small = (DP * 128) >> 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs_tf32<DP>(acc, ab[kk], db + 2 * kk);
    wgmma_rs_tf32<DP>(acc, ab[kk], db + b_small + 2 * kk);
    wgmma_rs_tf32<DP>(acc, as[kk], db + 2 * kk);
  }
}

// Store a warpgroup's 64 rows x DP of acc * scale, rows below n and head
// dims below D; row `row` at base + row * stride.
template <int DP>
__device__ __forceinline__ void write_out(float* base, long long stride,
                                           int row0, int n, int D,
                                           const float (&acc)[DP / 2],
                                           float scale, int t) {
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    if (row < n && col < D) base[row * stride + col] = acc[i] * scale;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, Plan<DP, kFwd>::min_blocks)
f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int H, int D,
               float scale_log2) {
  using P = Plan<DP, kFwd>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* ring = sm + P::own;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::bars);
  uint64_t* empty = full + P::slots;
  uint64_t* own_full = empty + P::slots;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Sk + kWalk - 1) / kWalk;
  const long long stride = (long long)H * D;  // floats between tokens
  init_ring(full, empty, own_full, P::slots);

  if (tid >= kConsumers) {
    // ---- producers: Q once, then each key tile's K rows and V cols; a
    // tile's loads are in flight while the producers wait for its slot ----
    const int ptid = tid - kConsumers;
    fill_own<DP>(sm, q + ((long long)b * Sq + q0) * stride + h * D, stride, Sq - q0,
                 D, ptid);
    produced(own_full);
    const long long kv = (long long)b * Sk * stride + h * D;
    float4 xk[Chunks<kWalk, DP>::n], xv[Chunks<kWalk, DP>::n];
    load_tile<kWalk, DP>(xk, k + kv, stride, Sk, D, ptid);
    load_tile<kWalk, DP>(xv, v + kv, stride, Sk, D, ptid);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % P::slots;
      mbar_wait(&empty[st], ((j / P::slots) & 1) ^ 1);
      uint8_t* slot = ring + st * P::slot;
      put_rows<kWalk, DP>(slot, xk, ptid);
      put_cols<DP>(slot + tile_bytes(kWalk, DP), xv, ptid);
      produced(&full[st]);
      if (j + 1 < n_tiles) {
        const long long off = kv + (long long)(j + 1) * kWalk * stride;
        const int n = Sk - (j + 1) * kWalk;
        load_tile<kWalk, DP>(xk, k + off, stride, n, D, ptid);
        load_tile<kWalk, DP>(xv, v + off, stride, n, D, ptid);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // O, 64 x DP: element i at row 16w + g + 8((i>>1)&1), head dim
  // 8(i>>2) + 2t + (i&1) (the wgmma accumulator layout)
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // raw logits, rows g and g + 8
  float l_run[2] = {0.f, 0.f};  // this thread's part of each row's sum

  mbar_wait(own_full, 0);
  const uint64_t d_q = desc_sw128(sm);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % P::slots;
    mbar_wait(&full[st], (j / P::slots) & 1);
    const uint8_t* slot = ring + st * P::slot;

    // S = Q K^T: 64 x 32
    float sc[16];
    wgmma_fence();
    rows_product<DP>(sc, d_q, desc_sw128(slot));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const int k0 = j * kWalk;
    if (k0 + kWalk > Sk) {  // the ragged last tile: keys past Sk get -inf
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= Sk) sc[i] = -INFINITY;
    }

    // online softmax in the log2 domain: p = 2^((s - m) * scale_log2)
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 16; ++i)
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
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], scale_log2, neg_m[r]));
      l_run[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: P split into A fragments, V read as cols
    uint32_t pb[4][4], ps[4][4];
    split_frags(sc, pb, ps);
    fence_regs(acc);
    wgmma_fence();
    cols_product<DP>(acc, pb, ps, desc_sw128(slot + tile_bytes(kWalk, DP)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);  // this thread is done with the slot
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  const int row0 = q0 + 16 * warp + g;
  if (lse != nullptr && t == 0) {  // the four threads of a row agree
    float* lb = lse + ((long long)b * H + h) * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < Sq)
        lb[row0 + 8 * r] = (m_run[r] * scale_log2 + log2f(l_run[r])) * 0.6931471805599453f;
  }
  float* ob = o + (long long)b * Sq * stride + h * D;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    if (row < Sq && col < D) ob[row * stride + col] = acc[i] * inv[(i >> 1) & 1];
  }
}

__global__ void f32_bwd_prep_kernel(const float* __restrict__ o,
                                    const float* __restrict__ dout,
                                    float* __restrict__ delta, int B, int Sq,
                                    int H, int D) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Sq * H) return;
  const int h = idx % H;
  const long long bi = idx / H;
  const int i = bi % Sq, b = bi / Sq;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(o[idx * D + d], dout[idx * D + d], acc);
  delta[((long long)b * H + h) * Sq + i] = acc;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, Plan<DP, kDkdv>::min_blocks)
f32_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int Sq, int Sk, int H, int D,
                    float scale) {
  using P = Plan<DP, kDkdv>;
  constexpr int kTile = tile_bytes(kWalk, DP);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* ring = sm + P::own;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::bars);
  uint64_t* empty = full + P::slots;
  uint64_t* own_full = empty + P::slots;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int n_items = 2 * ((Sq + kWalk - 1) / kWalk);
  const long long stride = (long long)H * D;
  const long long stat = ((long long)b * H + h) * Sq;  // this head's lse and D
  init_ring(full, empty, own_full, P::slots);

  if (tid >= kConsumers) {
    // ---- producers: K and V once; then each query tile's Q and dO rows
    // with its lse * log2(e) and D, and its Q and dO cols, from one load ----
    const int ptid = tid - kConsumers;
    const long long kv = ((long long)b * Sk + k0) * stride + h * D;
    fill_own<DP>(sm, k + kv, stride, Sk - k0, D, ptid);
    fill_own<DP>(sm + tile_bytes(kOwn, DP), v + kv, stride, Sk - k0, D, ptid);
    produced(own_full);
    const long long qb = (long long)b * Sq * stride + h * D;
    float4 xq[Chunks<kWalk, DP>::n], xo[Chunks<kWalk, DP>::n];
    float l2 = 0.f, dl = 0.f;
    for (int i = 0; i < n_items; ++i) {
      const int q0 = (i >> 1) * kWalk;
      if ((i & 1) == 0) {  // load the tile (P = 0 for queries past Sq)
        load_tile<kWalk, DP>(xq, q + qb + (long long)q0 * stride, stride, Sq - q0, D,
                             ptid);
        load_tile<kWalk, DP>(xo, dout + qb + (long long)q0 * stride, stride, Sq - q0,
                             D, ptid);
        if (ptid < kWalk) {
          const int qi = q0 + ptid;
          l2 = qi < Sq ? lse[stat + qi] * kLog2e : INFINITY;
          dl = qi < Sq ? delta[stat + qi] : 0.f;
        }
      }
      const int st = i % P::slots;
      mbar_wait(&empty[st], ((i / P::slots) & 1) ^ 1);
      uint8_t* slot = ring + st * P::slot;
      if ((i & 1) == 0) {
        put_rows<kWalk, DP>(slot, xq, ptid);
        put_rows<kWalk, DP>(slot + kTile, xo, ptid);
        if (ptid < kWalk) {
          float* stats = reinterpret_cast<float*>(slot + 2 * kTile);
          stats[ptid] = l2;
          stats[kWalk + ptid] = dl;
        }
      } else {
        put_cols<DP>(slot, xq, ptid);
        put_cols<DP>(slot + kTile, xo, ptid);
      }
      produced(&full[st]);
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int warp = tid >> 5, t = tid & 3;
  const float scale_log2 = scale * kLog2e;
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(own_full, 0);
  const uint64_t d_k = desc_sw128(sm), d_v = desc_sw128(sm + tile_bytes(kOwn, DP));
  for (int i = 0; i < n_items; i += 2) {
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries each
    int st = i % P::slots;
    mbar_wait(&full[st], (i / P::slots) & 1);
    const uint8_t* slot = ring + st * P::slot;
    float sc[16], dp[16];
    wgmma_fence();
    rows_product<DP>(sc, d_k, desc_sw128(slot));
    rows_product<DP>(dp, d_v, desc_sw128(slot + kTile));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = 2^(S^T scale_log2 - lse2[query]), dS^T = P^T (dP^T - D[query]);
    // accumulator i holds query 8(i>>2) + 2t + (i&1)
    const float* l2 = reinterpret_cast<const float*>(slot + 2 * kTile);
    const float* dl = l2 + kWalk;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int col = 8 * (e >> 2) + 2 * t + (e & 1);
      const float p = ex2(fmaf(sc[e], scale_log2, -l2[col]));
      dp[e] = p * (dp[e] - dl[col]);
      sc[e] = p;
    }
    mbar_arrive(&empty[st]);
    uint32_t pb[4][4], ps[4][4], db[4][4], ds[4][4];
    split_frags(sc, pb, ps);
    split_frags(dp, db, ds);

    // dV += P^T dO and dK += dS^T Q, A from registers, B the cols tiles
    st = (i + 1) % P::slots;
    mbar_wait(&full[st], ((i + 1) / P::slots) & 1);
    slot = ring + st * P::slot;
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    cols_product<DP>(dv_acc, pb, ps, desc_sw128(slot + kTile));
    cols_product<DP>(dk_acc, db, ds, desc_sw128(slot));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(&empty[st]);
  }

  const int row0 = k0 + 16 * warp + ((tid & 31) >> 2);
  const long long base = (long long)b * Sk * stride + h * D;
  write_out<DP>(dk + base, stride, row0, Sk, D, dk_acc, scale, t);
  write_out<DP>(dv + base, stride, row0, Sk, D, dv_acc, 1.f, t);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, Plan<DP, kDq>::min_blocks)
f32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int Sq, int Sk, int H, int D, float scale) {
  using P = Plan<DP, kDq>;
  constexpr int kTile = tile_bytes(kWalk, DP);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* ring = sm + P::own;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::bars);
  uint64_t* empty = full + P::slots;
  uint64_t* own_full = empty + P::slots;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int n_items = 2 * ((Sk + kWalk - 1) / kWalk);
  const long long stride = (long long)H * D;

  init_ring(full, empty, own_full, P::slots);

  if (tid >= kConsumers) {
    // ---- producers: Q and dO once; then each key tile's K and V rows,
    // and its K cols, from one load ----
    const int ptid = tid - kConsumers;
    const long long qo = ((long long)b * Sq + q0) * stride + h * D;
    fill_own<DP>(sm, q + qo, stride, Sq - q0, D, ptid);
    fill_own<DP>(sm + tile_bytes(kOwn, DP), dout + qo, stride, Sq - q0, D, ptid);
    produced(own_full);
    const long long kb = (long long)b * Sk * stride + h * D;
    float4 xk[Chunks<kWalk, DP>::n], xv[Chunks<kWalk, DP>::n];
    for (int i = 0; i < n_items; ++i) {
      const int j0 = (i >> 1) * kWalk;
      if ((i & 1) == 0) {
        load_tile<kWalk, DP>(xk, k + kb + (long long)j0 * stride, stride, Sk - j0, D,
                             ptid);
        load_tile<kWalk, DP>(xv, v + kb + (long long)j0 * stride, stride, Sk - j0, D,
                             ptid);
      }
      const int st = i % P::slots;
      mbar_wait(&empty[st], ((i / P::slots) & 1) ^ 1);
      uint8_t* slot = ring + st * P::slot;
      if ((i & 1) == 0) {
        put_rows<kWalk, DP>(slot, xk, ptid);
        put_rows<kWalk, DP>(slot + kTile, xv, ptid);
      } else {
        put_cols<DP>(slot, xk, ptid);
      }
      produced(&full[st]);
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int warp = tid >> 5, t = tid & 3;
  const int row0 = q0 + 16 * warp + ((tid & 31) >> 2);
  const float scale_log2 = scale * kLog2e;
  // this thread's rows' lse * log2(e) and D; +inf and 0 past Sq (P = 0)
  const long long stat = ((long long)b * H + h) * Sq;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    l2[r] = row < Sq ? lse[stat + row] * kLog2e : INFINITY;
    dl[r] = row < Sq ? delta[stat + row] : 0.f;
  }
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(own_full, 0);
  const uint64_t d_q = desc_sw128(sm), d_do = desc_sw128(sm + tile_bytes(kOwn, DP));
  for (int i = 0; i < n_items; i += 2) {
    // S = Q K^T and dP = dO V^T: 64 queries x 32 keys each
    int st = i % P::slots;
    mbar_wait(&full[st], (i / P::slots) & 1);
    const uint8_t* slot = ring + st * P::slot;
    float sc[16], dp[16];
    wgmma_fence();
    rows_product<DP>(sc, d_q, desc_sw128(slot));
    rows_product<DP>(dp, d_do, desc_sw128(slot + kTile));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive(&empty[st]);

    // dS = P (dP - D), P = 0 for keys past Sk (zero rows, logit 0)
    const int k0 = (i >> 1) * kWalk;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = (e >> 1) & 1;
      const float p = k0 + 8 * (e >> 2) + 2 * t + (e & 1) < Sk
                          ? ex2(fmaf(sc[e], scale_log2, -l2[r]))
                          : 0.f;
      sc[e] = p * (dp[e] - dl[r]);
    }
    uint32_t db[4][4], ds[4][4];
    split_frags(sc, db, ds);

    // dQ += dS K, K read as cols
    st = (i + 1) % P::slots;
    mbar_wait(&full[st], ((i + 1) / P::slots) & 1);
    slot = ring + st * P::slot;
    fence_regs(dq_acc);
    wgmma_fence();
    cols_product<DP>(dq_acc, db, ds, desc_sw128(slot));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    mbar_arrive(&empty[st]);
  }

  write_out<DP>(dq + (long long)b * Sq * stride + h * D, stride, row0, Sq, D, dq_acc,
                 scale, t);
}

template <int DP>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int B, int Sq, int Sk, int H, int D, cudaStream_t st) {
  using P = Plan<DP, kFwd>;
  static smem_limit::Set done;
  const cudaError_t err = smem_limit::allow(f32_fwd_kernel<DP>, P::smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  f32_fwd_kernel<DP><<<dim3((Sq + kOwn - 1) / kOwn, H, B), kThreads, P::smem, st>>>(
      q, k, v, o, lse, Sq, Sk, H, D, kLog2e / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int bwd(const float* q, const float* k, const float* v, const float* o,
        const float* dout, const float* lse, float* delta, float* dq, float* dk,
        float* dv, int B, int Sq, int Sk, int H, int D, cudaStream_t st) {
  static smem_limit::Set done_dkdv, done_dq;
  cudaError_t err =
      smem_limit::allow(f32_bwd_dkdv_kernel<DP>, Plan<DP, kDkdv>::smem, done_dkdv);
  if (err == cudaSuccess)
    err = smem_limit::allow(f32_bwd_dq_kernel<DP>, Plan<DP, kDq>::smem, done_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf((float)D);
  const long long rows = (long long)B * Sq * H;
  f32_bwd_prep_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      o, dout, delta, B, Sq, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  f32_bwd_dkdv_kernel<DP><<<dim3((Sk + kOwn - 1) / kOwn, H, B), kThreads,
                            Plan<DP, kDkdv>::smem, st>>>(q, k, v, dout, lse, delta,
                                                         dk, dv, Sq, Sk, H, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  f32_bwd_dq_kernel<DP><<<dim3((Sq + kOwn - 1) / kOwn, H, B), kThreads,
                          Plan<DP, kDq>::smem, st>>>(q, k, v, dout, lse, delta, dq,
                                                     Sq, Sk, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int plan(int kernel, int* smem, int* slots, int* blocks) {
  static smem_limit::Set done[3];
  cudaError_t err;
  if (kernel == kFwd) {
    *smem = Plan<DP, kFwd>::smem;
    *slots = Plan<DP, kFwd>::slots;
    err = smem_limit::allow(f32_fwd_kernel<DP>, *smem, done[0]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f32_fwd_kernel<DP>,
                                                          kThreads, *smem);
  } else if (kernel == kDkdv) {
    *smem = Plan<DP, kDkdv>::smem;
    *slots = Plan<DP, kDkdv>::slots;
    err = smem_limit::allow(f32_bwd_dkdv_kernel<DP>, *smem, done[1]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, f32_bwd_dkdv_kernel<DP>, kThreads, *smem);
  } else {
    *smem = Plan<DP, kDq>::smem;
    *slots = Plan<DP, kDq>::slots;
    err = smem_limit::allow(f32_bwd_dq_kernel<DP>, *smem, done[2]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f32_bwd_dq_kernel<DP>,
                                                          kThreads, *smem);
  }
  return static_cast<int>(err);
}

}  // namespace

// q, o: (B, Sq, H, D) float32; k, v: (B, Sk, H, D); lse: (B, H, Sq) float32
// or null. All contiguous and 16-byte aligned; 1 <= D <= 128. Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for D out
// of range).
extern "C" int vs_flash_attn_f32_fwd(const void* q, const void* k,
                                     const void* v, void* o, void* lse, int B,
                                     int Sq, int Sk, int H, int D,
                                     void* stream) {
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fo = static_cast<float*>(o);
  auto* fl = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) return fwd<32>(fq, fk, fv, fo, fl, B, Sq, Sk, H, D, st);
  if (D <= 64) return fwd<64>(fq, fk, fv, fo, fl, B, Sq, Sk, H, D, st);
  if (D <= 96) return fwd<96>(fq, fk, fv, fo, fl, B, Sq, Sk, H, D, st);
  return fwd<128>(fq, fk, fv, fo, fl, B, Sq, Sk, H, D, st);
}

// As vs_flash_attn_fwd's backward, in float32: dout, dq like q; dk, dv like
// k; lse from the forward; delta: float32 scratch of B * H * Sq entries.
extern "C" int vs_flash_attn_f32_bwd(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv,
                                     int B, int Sq, int Sk, int H, int D,
                                     void* stream) {
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fo = static_cast<const float*>(o);
  const auto* fdo = static_cast<const float*>(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  auto* fdq = static_cast<float*>(dq);
  auto* fdk = static_cast<float*>(dk);
  auto* fdv = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32)
    return bwd<32>(fq, fk, fv, fo, fdo, fl, fd, fdq, fdk, fdv, B, Sq, Sk, H, D, st);
  if (D <= 64)
    return bwd<64>(fq, fk, fv, fo, fdo, fl, fd, fdq, fdk, fdv, B, Sq, Sk, H, D, st);
  if (D <= 96)
    return bwd<96>(fq, fk, fv, fo, fdo, fl, fd, fdq, fdk, fdv, B, Sq, Sk, H, D, st);
  return bwd<128>(fq, fk, fv, fo, fdo, fl, fd, fdq, fdk, fdv, B, Sq, Sk, H, D, st);
}

// The launch plan of one kernel (0 forward, 1 dkdv, 2 dq) at head dim D:
// its dynamic shared memory, ring slots and resident blocks an SM (by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
extern "C" int vs_flash_attn_f32_plan(int kernel, int D, int* smem, int* slots,
                                      int* blocks) {
  if (D < 1 || D > 128 || kernel < 0 || kernel > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) return plan<32>(kernel, smem, slots, blocks);
  if (D <= 64) return plan<64>(kernel, smem, slots, blocks);
  if (D <= 96) return plan<96>(kernel, smem, slots, blocks);
  return plan<128>(kernel, smem, slots, blocks);
}
