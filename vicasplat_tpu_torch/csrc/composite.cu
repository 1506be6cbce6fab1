// K2: per-tile front-to-back alpha compositing with early exit.
//
// Replaces the Pallas TPU kernel of
// vicasplat_tpu/ops/rasterize/pallas_composite.py:59 (_kernel), :122
// (_chunk_math), :151 (_composite_pallas_raw) and :188
// (composite_tiles_pallas, forward): each tile's front-most K binned splats,
// packed as (K, 16) float32 rows (mean2d x/y, conic a/b/c, alpha, rgb,
// depth, pad), are blended over the tile's pixels.
//
// Per pixel and splat, in the TPU kernel's order and with its semantics:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy
//   alpha = min(0.99, opacity * exp(min(power, 0)))
//   skipped where power > 0 or alpha < 1/255
//   w = T * alpha, rgb += w rgb_i, depth += w depth_i, T *= 1 - alpha.
// The TPU kernel skips a chunk once every pixel of the tile has T < 1e-4;
// here each pixel stops on its own once its T < 1e-4, and the block stops
// taking chunks once every pixel has stopped. A contribution dropped that
// way is at most 1e-4 times a splat's feature.
//
// Bound on an H100, per flagship view (256 tiles, K = 512, 16 x 16 pixels):
// columns 0-9 of the payload rows any pixel meets before it saturates in
// and 20 bytes a pixel out, against ~25 float32 operations (one exp) for
// each (pixel, splat) pair that the function blends: met before
// saturation, with power <= 0 and alpha >= 1/255. The pairs that fail that
// test need none of those operations here, since the cull drops them
// before the walk. A sparse scene (the flagship's random weights: alpha
// mean 0.0005) is bound by bytes, about 0.002 ms; a covering scene by its
// blended pairs.
//
// Design (the TPU's log-space triangular-matmul prefix is its answer to
// having no serial per-lane loop, and is not carried over):
// - One block per tile, one thread per pixel; warp w covers a rectangle of
//   the tile (16 x 2 pixels at tile_px 16).
// - Chunks of `chunk` rows stream through a ring of kStages stages in
//   shared memory: thread 0 fills a stage with one cp.async.bulk into an
//   mbarrier, so the next chunk lands while this one is composited. A stage
//   is refilled once every warp has passed the next chunk's barrier.
// - When a chunk lands, thread i culls row i once (cull_row): one bit per
//   warp, set unless no pixel centre of the warp's rectangle can meet the
//   row with alpha >= 1/255. The rule is conservative against the float32
//   rounding of the per-pair arithmetic (margins below), so every pixel
//   blends the same rows in the same order as without the cull, and the
//   per-pair arithmetic is unchanged (expf at the 1/255 test).
// - Each warp walks the rows whose bit it holds, in chunk order: a ballot
//   of 32 rows' bits is the warp's list, and each pixel takes its set bits
//   lowest first, kBatch at a time, until it is done: the batch's alphas,
//   which do not depend on T, are computed side by side with no branch
//   between them, then blended in order, so that the serial chain per row
//   is the blend alone (a pixel on a tile that never saturates walks all
//   512 rows, and that chain sets the kernel's time). A warp whose pixels
//   are all done skips the rest of the chunk, and the block stops taking
//   chunks once every pixel is done (__syncthreads_or). Warps that finish
//   a chunk early cull the next one while the others walk.
// - Outputs rgb + T_final * background, depth and alpha = 1 - T_final (the
//   Pallas path's alpha) go straight into (H, W) image layout; the pixels of
//   ragged edge tiles that lie outside the image are skipped.

#include "hopper.cuh"
#include "smem_limit.cuh"

namespace {

using namespace hopper;

constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinT = 1e-4f;
constexpr int kStages = 2;  // the chunk composited and the next
constexpr int kBatch = 4;   // rows a pixel takes at once
constexpr int kMaxWarps = 32;

// The cull's margins against the kernel's float32 arithmetic (the
// derivation is in ops/rasterize/pallas_composite.py, composite_cull, which
// computes the same bits on the CPU):
// - expf is within 2 ulp and opacity * exp rounds once: an opacity under
//   1/255 / (1 + 2^-20) never reaches 1/255;
// - the same slack in the power: alpha >= 1/255 needs
//   power >= -ln(255 opacity) - 2^-19;
// - the float32 quadratic form is within 2^-17 * skew of its value, skew =
//   (a + c)^2 / det >= the conic's condition number; rows with skew >= 2^16
//   are kept for every warp.
constexpr double kOpacitySlack = 1.0 + 0x1p-20;
constexpr double kPowerSlack = 0x1p-19;
constexpr double kQuadSlack = 0x1p-17;
constexpr double kMaxSkew = 0x1p16;

// Bit w set unless row (p0 = mx, my, a, b; p1 = c, opacity, ...) is dead at
// every pixel centre of warp w's rectangle rects[w] = (x0, x1, y0, y1). The
// box is computed in double, so that the determinant and the logarithm are
// exact to far below the float32 margins, and rounded outward to float for
// the tests. A row holding a NaN or an infinity, or whose conic is not
// positive definite, is kept for every warp.
__device__ uint32_t cull_row(float4 p0, float4 p1, const float4* rects,
                             int nwarps) {
  const uint32_t all = nwarps == 32 ? ~0u : (1u << nwarps) - 1u;
  if (!(isfinite(p0.x) && isfinite(p0.y) && isfinite(p0.z) && isfinite(p0.w) &&
        isfinite(p1.x) && isfinite(p1.y)))
    return all;
  const double mx = p0.x, my = p0.y, a = p0.z, b = p0.w, c = p1.x, op = p1.y;
  if (op * kOpacitySlack < static_cast<double>(kMinAlpha)) return 0u;
  const double det = a * c - b * b;
  if (!(a > 0.0 && c > 0.0 && det > 0.0)) return all;
  const double inv = 1.0 / det;
  const double skew = (a + c) * (a + c) * inv;
  if (!(skew < kMaxSkew)) return all;
  // the live set is inside d^T M d <= q; its box, rounded outward to float
  const double q = fmax(2.0 * (log(op / static_cast<double>(kMinAlpha)) + kPowerSlack),
                        0.0) / (1.0 - kQuadSlack * skew);
  const double hx = sqrt(q * c * inv) * (1.0 + 1e-9) + 1e-6;
  const double hy = sqrt(q * a * inv) * (1.0 + 1e-9) + 1e-6;
  const float x0 = __double2float_rd(mx - hx), x1 = __double2float_ru(mx + hx);
  const float y0 = __double2float_rd(my - hy), y1 = __double2float_ru(my + hy);
  uint32_t bits = 0u;
  for (int w = 0; w < nwarps; ++w) {
    const float4 r = rects[w];
    if (!(x1 < r.x || x0 > r.y || y1 < r.z || y0 > r.w)) bits |= 1u << w;
  }
  return bits;
}

// kMaxThreads: 256 for tiles of up to 16 x 16 pixels (the flagship's), two
// blocks an SM at up to 128 registers a thread; 1024 for larger tiles, where
// ptxas must fit 64 registers a thread.
template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads < 1024 ? 2 : 1)
composite_kernel(const float4* __restrict__ payload, int K, int chunk,
                 int tile_px, int tiles_x, int H, int W,
                 const float* __restrict__ bg, float* __restrict__ rgb,
                 float* __restrict__ depth, float* __restrict__ alpha) {
  extern __shared__ __align__(16) uint8_t smem[];
  float4* ring = reinterpret_cast<float4*>(smem);     // kStages x chunk x 4
  float4* rects = ring + kStages * chunk * 4;         // kMaxWarps
  uint64_t* full = reinterpret_cast<uint64_t*>(rects + kMaxWarps);  // kStages
  uint32_t* masks = reinterpret_cast<uint32_t*>(full + kStages);    // kStages x chunk

  const int P = tile_px * tile_px;
  const int nwarps = (P + 31) / 32;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty0 = (tile / tiles_x) * tile_px, tx0 = (tile % tiles_x) * tile_px;
  const int y = ty0 + tid / tile_px, x = tx0 + tid % tile_px;
  const bool inside = tid < P && y < H && x < W;
  const float px = x + 0.5f, py = y + 0.5f;
  const int n_chunks = K / chunk;
  const uint32_t chunk_bytes = static_cast<uint32_t>(chunk) * 64u;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(
      payload + static_cast<long long>(tile) * K * 4);

  int issued = 0;  // chunks whose load has been issued (thread 0's count)
  auto issue = [&](int c) {
    const int s = c % kStages;
    mbar_expect_tx(&full[s], chunk_bytes);
    bulk_load(ring + s * chunk * 4, src + static_cast<long long>(c) * chunk_bytes,
              chunk_bytes, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    for (; issued < kStages && issued < n_chunks; ++issued) issue(issued);
  }
  if (tid < nwarps) {
    // warp tid's pixel-centre rectangle: its first and last pixel's rows,
    // and the whole tile's width unless they share one row
    const int first = tid * 32, last = min(first + 32, P) - 1;
    const int r0 = first / tile_px, r1 = last / tile_px;
    const int c0 = r0 == r1 ? first % tile_px : 0;
    const int c1 = r0 == r1 ? last % tile_px : tile_px - 1;
    rects[tid] = make_float4(tx0 + c0 + 0.5f, tx0 + c1 + 0.5f, ty0 + r0 + 0.5f,
                             ty0 + r1 + 0.5f);
  }
  __syncthreads();

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, cd = 0.f;
  bool done = !inside;
  int c = 0;
  for (; c < n_chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    const float4* rows = ring + s * chunk * 4;
    uint32_t* mask = masks + s * chunk;
    for (int i = tid; i < chunk; i += blockDim.x)
      mask[i] = cull_row(rows[4 * i], rows[4 * i + 1], rects, nwarps);
    // the masks are visible, and every warp has left chunk c - 1: stop if
    // every pixel is done, else chunk c - 1's stage takes chunk
    // c - 1 + kStages (a warp that finished chunk c - 1 early has culled
    // chunk c meanwhile)
    if (!__syncthreads_or(!done)) break;
    if (tid == 0 && issued < n_chunks && issued < c + kStages) issue(issued++);
    for (int g = 0; g < chunk; g += 32) {
      if (__all_sync(~0u, done)) break;
      // the warp's list: the rows of this group whose bit it holds; each
      // pixel walks it on its own, lowest bit first, until it is done
      uint32_t list = __ballot_sync(~0u, g + lane < chunk && ((mask[g + lane] >> warp) & 1u));
      while (list && !done) {
        // up to kBatch rows of the list: their alphas side by side, then the
        // blends in order
        int j[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          ok[u] = list != 0u;
          j[u] = g + (ok[u] ? __ffs(list) - 1 : 0);
          list &= list - 1;
        }
        float a[kBatch];
        float4 p1[kBatch];
        bool use[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float4 p0 = rows[4 * j[u]];  // mx, my, conic a, conic b
          p1[u] = rows[4 * j[u] + 1];        // conic c, opacity, r, g
          const float dx = px - p0.x;
          const float dy = py - p0.y;
          const float power = -0.5f * (p0.z * dx * dx + p1[u].x * dy * dy) - p0.w * dx * dy;
          a[u] = fminf(kMaxAlpha, p1[u].y * expf(fminf(power, 0.f)));
          use[u] = ok[u] && !(power > 0.f || a[u] < kMinAlpha);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (!use[u] || done) continue;
          const float2 p2 = *reinterpret_cast<const float2*>(&rows[4 * j[u] + 2]);  // b, depth
          const float w = T * a[u];
          cr += w * p1[u].z;
          cg += w * p1[u].w;
          cb += w * p2.x;
          cd += w * p2.y;
          T *= 1.f - a[u];
          done = T < kMinT;
        }
      }
    }
  }
  // a block that stopped early waits for the loads still in flight into
  // its shared memory before it exits
  if (tid == 0)
    for (int d = c + 1; d < issued; ++d) mbar_wait(&full[d % kStages], (d / kStages) & 1);
  if (inside) {
    const long long o = static_cast<long long>(y) * W + x;
    rgb[3 * o] = cr + T * bg[0];
    rgb[3 * o + 1] = cg + T * bg[1];
    rgb[3 * o + 2] = cb + T * bg[2];
    depth[o] = cd;
    alpha[o] = 1.f - T;
  }
}

}  // namespace

// Shared memory of one block at `chunk` rows a stage: the ring, the warp
// rectangles, the mbarriers and a word of cull bits a row of each stage.
extern "C" int vs_composite_smem_bytes(int chunk) {
  return kStages * chunk * 64 + kMaxWarps * 16 + kStages * 8 + kStages * chunk * 4;
}

// payload: (tiles_y * tiles_x, K, 16) float32, contiguous, 16-byte aligned,
// K a multiple of chunk; bg (3,), rgb (H, W, 3), depth and alpha (H, W)
// float32, all on the card. Launches on `stream` and returns
// cudaGetLastError(). The shared-memory attribute is set once per device
// for the largest size asked so far.
extern "C" int vs_composite(const void* payload, int num_tiles, int K,
                            int chunk, int tile_px, int tiles_x, int H, int W,
                            const void* bg, void* rgb, void* depth, void* alpha,
                            void* stream) {
  const int smem = vs_composite_smem_bytes(chunk);
  const int threads = (tile_px * tile_px + 31) / 32 * 32;
  auto kernel = threads <= 256 ? composite_kernel<256> : composite_kernel<1024>;
  static smem_limit::Set smem_set[2];
  if (smem > 48 * 1024) {  // the default any kernel may use
    const cudaError_t err =
        smem_limit::allow(kernel, smem, smem_set[threads <= 256 ? 0 : 1]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<num_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(payload), K, chunk, tile_px, tiles_x, H, W,
      static_cast<const float*>(bg), static_cast<float*>(rgb),
      static_cast<float*>(depth), static_cast<float*>(alpha));
  return static_cast<int>(cudaGetLastError());
}
