// K3: the fused DPT head tail, out = conv1x1(relu(conv3x3_SAME(a + m) + b1)) + b2,
// channels last, for Hopper: TMA loads, thread block clusters that share
// the weight slices by multicast, wgmma, persistent blocks.
//
// Replaces the Pallas TPU kernel of vicasplat_tpu/ops/dpt_tail.py:43
// (_kernel), :92 (_pallas_tail) and :159 (fused_dpt_tail, forward). The sum
// a + m, the 3x3 conv's input, and its F-channel output h never exist in
// device memory: only a, m, the weights and the O-channel output move.
//
// Bound on an H100 at the flagship GS head (a, m (8, 256, 256, 256) bf16,
// F = 256, O = 83): 524,288 px x (2*9*256*256 + 2*256*83) = 641 GFLOP, 0.65
// ms at 989 TFLOP/s, against ~624 MB, 0.19 ms at 3.35 TB/s: the tensor cores
// bound it. What keeps a kernel from that rate is feeding them from L2:
// every 128 output pixels need all of w1 (1.18 MB at C = F = 256) and three
// window rows of a and m for each 64 input channels: about 6.7 GB into
// shared memory a call (w1 4.8, a and m 1.6, w2 0.2).
//
// Design. A tile is 128 output pixels of one image row x all F features
// (x one slice of at most 128 output channels). Blocks are persistent, in
// clusters of kCluster = 2 on neighbouring SMs: cluster k walks the pairs
// of tiles k, k + clusters, ..., its block of rank r taking tile 2p + r of
// pair p (the odd last tile's partner recomputes it and stores nothing), so
// both blocks run the same sequence of steps. A block has two consumer
// warpgroups (64 pixels x FS features of float32 accumulators each), one
// producer warp whose lane 0 issues every TMA load, and three adder warps.
// - The 3x3 conv is an implicit GEMM over K = 9 C, in steps of one tap x
//   64 input channels. For each (64-channel chunk, dy) the producer loads
//   the window row a[img, row + dy - 1, x0 - 1 .. x0 + 128, c0 .. c0 + 63]
//   (and m's) as one TMA box at signed coordinates: TMA's zero fill is the
//   SAME padding at every edge, and past a ragged W; no masks. Rows of a go
//   through 3 slots, rows of m through 2. The adder warps sum m into a's
//   box in place (float32, rounded to bf16; both boxes carry the same
//   swizzle, so the sum is elementwise on raw shared memory) a row ahead of
//   the consumers, and each row serves the 3 taps dx = 0, 1, 2 as the A
//   operand shifted by dx rows of 128 bytes. Such a descriptor starts 1 or
//   2 rows past a 1024-byte boundary; the card applies the 128-byte swizzle
//   from the address bits, so its base-offset field stays 0 (setting it to
//   (address >> 7) & 7 gives wrong products; vs_dpt_tail_shift_probe below
//   holds the shift).
// - w1, repacked by the wrapper to (tap, F, C) with C innermost, streams in
//   (FS, 64) slices through a ring of up to 8 stages (4 at the flagship).
//   Each block of the cluster loads its half of a slice and multicasts it
//   to both, so each slice leaves L2 once per cluster. A stage is refilled
//   only when the consumers of every block of the cluster have released
//   it: lane q of each consumer warp arrives on the "empty" mbarrier of
//   block q, with a plain mbarrier.arrive.shared::cluster (hopper.cuh).
// - The first product: wgmma m64n256k16 (FS = 256) or m64n128k16 (FS =
//   128), A and B from shared memory, one step in flight while the next is
//   issued.
// - The 1x1 conv: b1 added, relu, rounded to bf16 and packed in registers
//   into wgmma A fragments; wgmma m64nN2k16 against w2's (N2, FS) slice,
//   which follows each tile's w1 slices through the same ring (each block
//   loads its own: the blocks of a cluster may be on other output slices).
//   N2 (32, 64, 96 or 128) is a template parameter: a runtime choice among
//   wgmma widths made ptxas serialize every wgmma of the kernel.
// - F other than 256 runs in slices of FS = 128 features, each slice's h
//   feeding the second product, whose accumulators carry over the slices.
// - The epilogue adds b2 and stores the first O channels with plain stores,
//   masked at a ragged W: TMA cannot store rows of 166 bytes (O = 83).
// Input channels C are a multiple of 64 (one 128-byte TMA row); F a
// multiple of 128; any O. No setmaxnreg: it deadlocked beside a one-warp
// producer in K1 (flash_attn.cu). ptxas allocates registers for whole
// warpgroups, so the 12 warps get 168 registers each.
//
// Its times on an H100 beside its bound and cuDNN's (chip_smoke.py, phase
// k3), and what holds it back (diagnostics/k3_variants.py): PERF.md §6.
//
// Diagnostic switches, for vicasplat_tpu_torch/diagnostics/k3_variants.py
// only (the build leaves them at their defaults): K3_CLUSTER sets the
// cluster size (1, 2 or 4); K3_MODE 1 runs the products without loading
// anything (its output is meaningless), K3_MODE 2 the loads and sums
// without the products.

#include "hopper.cuh"
#include "smem_limit.cuh"

namespace {

using namespace hopper;

#ifndef K3_CLUSTER
#define K3_CLUSTER 2
#endif
#ifndef K3_MODE
#define K3_MODE 0
#endif
constexpr int kCluster = K3_CLUSTER;      // blocks sharing each w1 slice
constexpr int kTilePx = 128;              // output pixels of a tile
constexpr int kWinPx = kTilePx + 2;       // a window row: x0 - 1 .. x0 + 128
constexpr int kRowBytes = kWinPx * 128;   // 64 channels of bf16 a pixel
constexpr int kRowSlot = 17 * 1024;       // a row, on 1024-byte boundaries
constexpr int kRowSlots = 3;              // a's window rows
constexpr int kMSlots = 2;                // m's, free once summed
constexpr int kConsumers = 256;           // warps 0-7: two warpgroups
constexpr int kAdders = 96;               // warps 9-11: a + m
constexpr int kThreads = kConsumers + 32 + kAdders;  // warp 8: the producer
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;          // 227 KB a block

struct Shape {
  int N, H, W, C, F, O;
  int os_n;      // output channels a slice (32, 64, 96 or 128)
  int n_os;      // output slices
  int n_xt;      // 128-pixel tiles a row
  int tiles;     // N * H * n_xt * n_os
  int pairs;     // tiles / kCluster, rounded up
  int has_m;
  int stages;    // the ring of w1 and w2 slices
};

// Byte offsets in the 1024-aligned dynamic shared memory.
struct Layout {
  int arow, mrow, ring, b1, b2, bars, bytes;
};

__host__ __device__ inline int round_up(int x, int to) { return (x + to - 1) / to * to; }

__host__ __device__ inline Layout layout(int FS, const Shape& s) {
  Layout l;
  l.arow = 0;
  l.mrow = l.arow + kRowSlots * kRowSlot;
  l.ring = l.mrow + (s.has_m ? kMSlots * kRowSlot : 0);
  l.b1 = l.ring + s.stages * FS * 128;
  l.b2 = l.b1 + s.F * 4;
  l.bars = round_up(l.b2 + s.os_n * s.n_os * 4, 8);
  // full/empty a stage, afull/xready/aempty a row slot, mempty an m slot
  l.bytes = l.bars + 8 * (2 * kMaxStages + 3 * kRowSlots + kMSlots) + 1024;  // + alignment
  return l;
}

template <int FS>
__device__ __forceinline__ void wgmma_w1(float (&acc)[FS / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_w1<256>(float (&acc)[128], uint64_t da, uint64_t db) {
  wgmma_ss_m64n256k16(acc, da, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_w1<128>(float (&acc)[64], uint64_t da, uint64_t db) {
  wgmma_ss_m64n128k16(acc, da, db, 1);
}

// acc2 (+)= h w2^T over FS features: h as A fragments, w2's (N, FS) slice
// in FS / 64 ring stages of (N, 64).
template <int N, int FS>
__device__ __forceinline__ void second_product(float (&acc2)[N / 2],
                                               const uint32_t (&ha)[FS / 16][4],
                                               const uint64_t (&dw2)[FS / 64]) {
#pragma unroll
  for (int kk = 0; kk < FS / 16; ++kk)
    wgmma_rs_k<N>(acc2, ha[kk], dw2[kk >> 2] + 2 * (kk & 3));
}

// The tile of pair p for this block: (image, row, first pixel, output slice).
struct Tile {
  int img, row, x0, os;
  bool real;  // false for the odd last tile's partner: computed, not stored
};

__device__ __forceinline__ Tile tile_of(int p, uint32_t rank, const Shape& sh) {
  Tile tl;
  int t = p * kCluster + rank;
  tl.real = t < sh.tiles;
  if (!tl.real) t = sh.tiles - 1;
  tl.os = t % sh.n_os;
  t /= sh.n_os;
  tl.x0 = (t % sh.n_xt) * kTilePx;
  t /= sh.n_xt;
  tl.row = t % sh.H;
  tl.img = t / sh.H;
  return tl;
}

// FS: the features of one slice; kMulti: F runs in F / FS slices (else F ==
// FS); N2: the output channels of a slice (a template parameter: a runtime
// choice among wgmma widths makes ptxas serialize every wgmma of the kernel).
template <int FS, bool kMulti, int N2>
__global__ void __launch_bounds__(kThreads, 1)
dpt_tail_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_m,
                const __grid_constant__ CUtensorMap map_w1,
                const __grid_constant__ CUtensorMap map_w2,
                const float* __restrict__ b1,   // (F,)
                const float* __restrict__ b2,   // (os_n * n_os,)
                __nv_bfloat16* __restrict__ out,  // (N, H, W, O)
                const Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const Layout L = layout(FS, sh);
  uint8_t* arow = smem + L.arow;
  uint8_t* mrow = smem + L.mrow;
  uint8_t* ring = smem + L.ring;
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* b2s = reinterpret_cast<float*>(smem + L.b2);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;
  uint64_t* afull = empty + kMaxStages;
  uint64_t* aempty = afull + kRowSlots;
  uint64_t* xready = aempty + kRowSlots;  // a + m summed in a's slot
  uint64_t* mempty = xready + kRowSlots;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_ctarank();
  const int cluster = blockIdx.x / kCluster, n_clusters = gridDim.x / kCluster;
  const int S = sh.stages;
  const int n_fs = kMulti ? sh.F / FS : 1;
  const int n_rows = 3 * (sh.C / 64);  // (chunk, dy) window rows a feature slice

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * kCluster);  // each consumer warp of each block
    }
    for (int s = 0; s < kRowSlots; ++s) {
      mbar_init(&afull[s], 1);
      mbar_init(&aempty[s], 8);
      mbar_init(&xready[s], kAdders / 32);
    }
    for (int s = 0; s < kMSlots; ++s) mbar_init(&mempty[s], kAdders / 32);
    fence_barrier_init();
  }
  if (tid < kConsumers) {
    for (int i = tid; i < sh.F; i += kConsumers) b1s[i] = b1[i];
    for (int i = tid; i < sh.os_n * sh.n_os; i += kConsumers) b2s[i] = b2[i];
  }
  // the peer's barriers are initialised before any multicast or remote
  // arrival reaches them
  cluster_sync();

  if (warp == kConsumers / 32) {
    // ---- producer: lane 0 issues every load ----
    if (lane == 0 && K3_MODE != 1) {
      const uint16_t mask = (1u << kCluster) - 1;
      const int half = FS / kCluster;  // w1 rows this block loads a slice
      uint32_t ws = 0, rs = 0;
      // the next ring stage, once every consumer of the cluster released it
      auto stage = [&](uint32_t bytes) {
        const int s = ws % S;
        mbar_wait(&empty[s], ((ws / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        ++ws;
        return s;
      };
      for (int p = cluster; p < sh.pairs; p += n_clusters) {
        const Tile tl = tile_of(p, rank, sh);
        for (int fs = 0; fs < n_fs; ++fs) {
          for (int i = 0; i < n_rows; ++i, ++rs) {
            const int c0 = (i / 3) * 64, dy = i % 3;
            const int slot = rs % kRowSlots, mslot = rs % kMSlots;
            mbar_wait(&aempty[slot], ((rs / kRowSlots) & 1) ^ 1);
            if (sh.has_m) mbar_wait(&mempty[mslot], ((rs / kMSlots) & 1) ^ 1);
            mbar_expect_tx(&afull[slot], kRowBytes * (sh.has_m ? 2 : 1));
            tma_load_4d(arow + slot * kRowSlot, &map_a, &afull[slot], c0, tl.x0 - 1,
                        tl.row + dy - 1, tl.img);
            if (sh.has_m)
              tma_load_4d(mrow + mslot * kRowSlot, &map_m, &afull[slot], c0, tl.x0 - 1,
                          tl.row + dy - 1, tl.img);
            for (int dx = 0; dx < 3; ++dx) {
              const int s = stage(FS * 128);
              tma_load_2d_multicast(ring + s * FS * 128 + rank * half * 128, &map_w1,
                                    &full[s], c0,
                                    (3 * dy + dx) * sh.F + fs * FS + rank * half, mask);
            }
          }
          // w2's (os_n, FS) slice, 64 features a stage; each block its own
          for (int i = 0; i < FS / 64; ++i) {
            const int s = stage(sh.os_n * 128);
            tma_load_2d(ring + s * FS * 128, &map_w2, &full[s], fs * FS + 64 * i,
                        tl.os * sh.os_n);
          }
        }
      }
    }
    __syncwarp();
  } else if (warp > kConsumers / 32) {
    // ---- three adder warps: x = bf16(a + m) in a's slot, a row ahead of
    // the consumers (both boxes carry the same swizzle: elementwise) ----
    if (sh.has_m && K3_MODE != 1) {
      const int at = tid - kConsumers - 32;
      const int rows = ((sh.pairs - cluster + n_clusters - 1) / n_clusters) * n_fs * n_rows;
      for (int rs = 0; rs < rows; ++rs) {
        const int slot = rs % kRowSlots, mslot = rs % kMSlots;
        mbar_wait(&afull[slot], (rs / kRowSlots) & 1);
        uint4* av = reinterpret_cast<uint4*>(arow + slot * kRowSlot);
        const uint4* mv = reinterpret_cast<const uint4*>(mrow + mslot * kRowSlot);
        for (int v = at; v < kRowBytes / 16; v += kAdders) {
          uint4 x = av[v];
          const uint4 y = mv[v];
          uint32_t* xs = reinterpret_cast<uint32_t*>(&x);
          const uint32_t* ys = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fa =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
            const float2 fm =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
            xs[e] = pack_bf16x2(fa.x + fm.x, fa.y + fm.y);
          }
          av[v] = x;
        }
        fence_proxy_async();  // the sums, before wgmma reads them
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&xready[slot]);
          mbar_arrive(&mempty[mslot]);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: pixels 64 wg .. 64 wg + 63 ----
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    uint32_t ws = 0, rs = 0;
    float acc2[N2 / 2];

    // release a ring stage to every block of the cluster, and a row slot
    auto release = [&](int s, int slot, bool last_of_row) {
      if (K3_MODE == 1) return;
      __syncwarp();
      if (lane < kCluster) mbar_arrive_cluster(&empty[s], lane);
      if (last_of_row && lane == 0) mbar_arrive(&aempty[slot]);
    };

    for (int p = cluster; p < sh.pairs; p += n_clusters) {
      const Tile tl = tile_of(p, rank, sh);
      if (kMulti) {
#pragma unroll
        for (int i = 0; i < N2 / 2; ++i) acc2[i] = 0.f;
      }
      for (int fs = 0; fs < n_fs; ++fs) {
        float acc[FS / 2];
#pragma unroll
        for (int i = 0; i < FS / 2; ++i) acc[i] = 0.f;
        int prev_s = 0, prev_slot = 0;
        bool prev_last = false;
        for (int i = 0; i < n_rows; ++i, ++rs) {
          const int slot = rs % kRowSlots;
          uint8_t* win = arow + slot * kRowSlot;
          if (K3_MODE != 1)
            mbar_wait(sh.has_m ? &xready[slot] : &afull[slot], (rs / kRowSlots) & 1);
          for (int dx = 0; dx < 3; ++dx, ++ws) {
            const int s = ws % S;
            if (K3_MODE != 1) mbar_wait(&full[s], (ws / S) & 1);
            // tap dx: window pixels 64 wg + dx .. 64 wg + dx + 63
            const uint64_t da = desc_sw128(win + (64 * wg + dx) * 128);
            const uint64_t db = desc_sw128(ring + s * FS * 128);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              if (K3_MODE != 2) wgmma_w1<FS>(acc, da + 2 * kk, db + 2 * kk);
            wgmma_commit();
            if (i > 0 || dx > 0) {
              wgmma_wait<1>();  // the previous step's products are done
              release(prev_s, prev_slot, prev_last);
            }
            prev_s = s;
            prev_slot = slot;
            prev_last = dx == 2;
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release(prev_s, prev_slot, prev_last);

        // ---- h = bf16(relu(acc + b1)) as A fragments of 16 features ----
        uint32_t ha[FS / 16][4];
        const float* bb = b1s + fs * FS + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < FS / 16; ++kk) {
          const float2 lo = *reinterpret_cast<const float2*>(bb + 16 * kk);
          const float2 hi = *reinterpret_cast<const float2*>(bb + 16 * kk + 8);
          ha[kk][0] = pack_bf16x2(fmaxf(acc[8 * kk + 0] + lo.x, 0.f),
                                  fmaxf(acc[8 * kk + 1] + lo.y, 0.f));
          ha[kk][1] = pack_bf16x2(fmaxf(acc[8 * kk + 2] + lo.x, 0.f),
                                  fmaxf(acc[8 * kk + 3] + lo.y, 0.f));
          ha[kk][2] = pack_bf16x2(fmaxf(acc[8 * kk + 4] + hi.x, 0.f),
                                  fmaxf(acc[8 * kk + 5] + hi.y, 0.f));
          ha[kk][3] = pack_bf16x2(fmaxf(acc[8 * kk + 6] + hi.x, 0.f),
                                  fmaxf(acc[8 * kk + 7] + hi.y, 0.f));
        }
        // ---- acc2 (+)= h w2^T, w2 from the next FS / 64 ring stages ----
        uint64_t dw2[FS / 64];
        int s2[FS / 64];
#pragma unroll
        for (int i = 0; i < FS / 64; ++i, ++ws) {
          s2[i] = ws % S;
          if (K3_MODE != 1) mbar_wait(&full[s2[i]], (ws / S) & 1);
          dw2[i] = desc_sw128(ring + s2[i] * FS * 128);
        }
        if (!kMulti) {
#pragma unroll
          for (int i = 0; i < N2 / 2; ++i) acc2[i] = 0.f;
        }
        wgmma_fence();
        second_product<N2, FS>(acc2, ha, dw2);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc2);
#pragma unroll
        for (int i = 0; i < FS / 64; ++i) release(s2[i], 0, false);
      }

      // ---- + b2, the first O channels of the pixels inside the row ----
      if (tl.real) {
        const int px = tl.x0 + 64 * wg + 16 * wq + g;
        __nv_bfloat16* dst =
            out + ((static_cast<long long>(tl.img) * sh.H + tl.row) * sh.W) * sh.O;
        const int o0 = tl.os * N2;
        // acc2 element 4j + e: pixel px + 8 (e >> 1), channel 8j + 2 t4 + (e & 1)
#pragma unroll
        for (int j = 0; j < N2 / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = px + 8 * (e >> 1);
            const int o = o0 + 8 * j + 2 * t4 + (e & 1);
            if (x < sh.W && o < sh.O)
              dst[static_cast<long long>(x) * sh.O + o] =
                  __float2bfloat16_rn(acc2[4 * j + e] + b2s[o]);
          }
        }
      }
    }
  }
  // no block leaves while a peer may still multicast into it or arrive on
  // its barriers
  cluster_sync();
}

// The dx-shift probe: one warpgroup multiplies rows r .. r + 63 of x (136,
// 64) bf16, loaded by TMA into 128-byte-swizzled shared memory, by w (64,
// 64)^T through a descriptor that starts r rows of 128 bytes into the
// tile, as the kernel's taps dx = 1, 2 do, for r = blockIdx.x; out (8, 64,
// 64) float32.
__global__ void __launch_bounds__(128, 1)
shift_probe_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* xs = smem;               // 136 rows of 128 bytes, 17 KB
  uint8_t* wt = smem + kRowSlot;    // 64 rows
  uint64_t* bar = reinterpret_cast<uint64_t*>(wt + 64 * 128);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (136 + 64) * 128);
    tma_load_2d(xs, &map_x, bar, 0, 0);
    tma_load_2d(wt, &map_w, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint64_t da = desc_sw128(xs + blockIdx.x * 128);
  const uint64_t db = desc_sw128(wt);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_m64n64k16(acc, da + 2 * kk, db + 2 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float* o = out + blockIdx.x * 64 * 64;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    o[(16 * warp + g + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * t4 + (i & 1)] = acc[i];
}

template <int FS, bool kMulti, int N2>
int launch(const CUtensorMap& ma, const CUtensorMap& mm, const CUtensorMap& mw1,
           const CUtensorMap& mw2, const float* b1, const float* b2,
           __nv_bfloat16* out, Shape sh, cudaStream_t stream) {
  auto kernel = dpt_tail_kernel<FS, kMulti, N2>;
  static smem_limit::Set smem_set;
  {
    const cudaError_t err = smem_limit::allow(kernel, kMaxSmem, smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // as many ring stages as shared memory holds, 2 to kMaxStages
  sh.stages = kMaxStages;
  while (sh.stages > 2 && layout(FS, sh).bytes > kMaxSmem) --sh.stages;
  const int smem = layout(FS, sh).bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // one cluster for every pair of SMs that can hold one, or fewer; the
  // count is the device's, kept for each device and size
  static int cached_smem[smem_limit::kMaxDevices], cached_clusters[smem_limit::kMaxDevices];
  const int slot = smem_limit::device_slot();
  int max_clusters = slot >= 0 && cached_smem[slot] == smem ? cached_clusters[slot] : 0;
  if (max_clusters == 0) {
    cfg.gridDim = dim3(kCluster * sh.pairs);
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (slot >= 0) {
      cached_smem[slot] = smem;
      cached_clusters[slot] = max_clusters;
    }
  }
  const int clusters = sh.pairs < max_clusters ? sh.pairs : max_clusters;
  cfg.gridDim = dim3(kCluster * clusters);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, ma, mm, mw1, mw2, b1, b2, out, sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int FS, bool kMulti>
int launch_n2(const CUtensorMap& ma, const CUtensorMap& mm, const CUtensorMap& mw1,
              const CUtensorMap& mw2, const float* b1, const float* b2,
              __nv_bfloat16* out, const Shape& sh, cudaStream_t stream) {
  switch (sh.os_n) {
    case 32: return launch<FS, kMulti, 32>(ma, mm, mw1, mw2, b1, b2, out, sh, stream);
    case 64: return launch<FS, kMulti, 64>(ma, mm, mw1, mw2, b1, b2, out, sh, stream);
    case 96: return launch<FS, kMulti, 96>(ma, mm, mw1, mw2, b1, b2, out, sh, stream);
    default: return launch<FS, kMulti, 128>(ma, mm, mw1, mw2, b1, b2, out, sh, stream);
  }
}

}  // namespace

// a, m: (N, H, W, C) bf16 (m may be null), C % 64 == 0; w1: (9 F, C) bf16,
// row tap * F + f with tap = 3 dy + dx; b1: (F,) float32; w2: (O_pad, F)
// bf16 and b2: (O_pad,) float32, zero rows past O, O_pad = os_n * n_os with
// os_n one of 32, 64, 96, 128; out: (N, H, W, O) bf16. F is a multiple of
// 128. All contiguous and 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take),
// or kTensorMapError + the CUresult of a tensor map that could not be
// encoded.
extern "C" int vs_dpt_tail(const void* a, const void* m, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           void* out, int N, int H, int W, int C, int F, int O,
                           int os_n, int n_os, void* stream) {
  if (C <= 0 || C % 64 || F <= 0 || F % 128 || O < 1 || O > os_n * n_os ||
      (os_n != 32 && os_n != 64 && os_n != 96 && os_n != 128) || N < 1 ||
      H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.N = N;
  sh.H = H;
  sh.W = W;
  sh.C = C;
  sh.F = F;
  sh.O = O;
  sh.os_n = os_n;
  sh.n_os = n_os;
  sh.n_xt = (W + kTilePx - 1) / kTilePx;
  const long long tiles = 1LL * N * H * sh.n_xt * n_os;
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  sh.tiles = static_cast<int>(tiles);
  sh.pairs = (sh.tiles + kCluster - 1) / kCluster;
  sh.has_m = m != nullptr;
  const int FS = F == 256 ? 256 : 128;

  CUtensorMap ma, mm, mw1, mw2;
  const cuuint64_t act_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                  (cuuint64_t)N};
  const cuuint64_t act_strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                     (cuuint64_t)H * W * C * 2};
  const cuuint32_t act_box[4] = {64, kWinPx, 1, 1};
  int rc = encode_bf16_map(&ma, a, 4, act_dims, act_strides, act_box);
  if (rc == 0)
    rc = encode_bf16_map(&mm, m != nullptr ? m : a, 4, act_dims, act_strides, act_box);
  const cuuint64_t w1_dims[2] = {(cuuint64_t)C, (cuuint64_t)9 * F};
  const cuuint64_t w1_strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t w1_box[2] = {64, (cuuint32_t)(FS / kCluster)};
  if (rc == 0) rc = encode_bf16_map(&mw1, w1, 2, w1_dims, w1_strides, w1_box);
  const cuuint64_t w2_dims[2] = {(cuuint64_t)F, (cuuint64_t)os_n * n_os};
  const cuuint64_t w2_strides[1] = {(cuuint64_t)F * 2};
  const cuuint32_t w2_box[2] = {64, (cuuint32_t)os_n};
  if (rc == 0) rc = encode_bf16_map(&mw2, w2, 2, w2_dims, w2_strides, w2_box);
  if (rc != 0) return kTensorMapError + rc;

  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F == 256) return launch_n2<256, false>(ma, mm, mw1, mw2, b1f, b2f, o, sh, s);
  return launch_n2<128, true>(ma, mm, mw1, mw2, b1f, b2f, o, sh, s);
}

// x: (136, 64) bf16, w: (64, 64) bf16, out: (8, 64, 64) float32: out[r] =
// x[r : r + 64] w^T through the kernel's shifted A descriptor, r = 0..7.
extern "C" int vs_dpt_tail_shift_probe(const void* x, const void* w, void* out,
                                       void* stream) {
  CUtensorMap mx, mw;
  const cuuint64_t x_dims[2] = {64, 136}, w_dims[2] = {64, 64};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t x_box[2] = {64, 136}, w_box[2] = {64, 64};
  int rc = encode_bf16_map(&mx, x, 2, x_dims, strides, x_box);
  if (rc == 0) rc = encode_bf16_map(&mw, w, 2, w_dims, strides, w_box);
  if (rc != 0) return kTensorMapError + rc;
  const int smem = kRowSlot + 64 * 128 + 64 + 1024;
  static smem_limit::Set smem_set;
  const cudaError_t err = smem_limit::allow(shift_probe_kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  shift_probe_kernel<<<8, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      mx, mw, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The blocks of a cluster, which share each w1 slice by multicast.
extern "C" int vs_dpt_tail_cluster_size() { return kCluster; }
