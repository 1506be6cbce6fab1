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
// loading chunks once every pixel has stopped. A contribution dropped that
// way is at most 1e-4 times a splat's feature.
//
// Bound on an H100, per flagship view (256 tiles, K = 512, 16 x 16 pixels):
// columns 0-9 of each payload row in (5.2 MB; 10-15 are padding no
// arithmetic reads) and 1.3 MB out, about 0.002 ms at 3.35 TB/s, against
// ~25 float32 operations (one exp) for each (pixel, live splat) pair the
// data needs, up to 33.5 M pairs, about 0.0125 ms at 67 TFLOP/s. Which of
// the two bounds it depends on the data: a sparse scene has few live
// splats (bytes), a dense one many (operations) until its pixels saturate.
// The real time is set by the serial loop over splats in each pixel and by
// the shared-memory reads of each splat.
//
// Design: one block per tile, one thread per pixel (tile_px^2 <= 1024
// threads). The AoS payload is read straight into shared memory, `chunk`
// rows at a time with 16-byte loads (the TPU's SoA transpose is not needed:
// every thread reads the same splat, a broadcast). The kernel writes rgb +
// T_final * background, depth and alpha = 1 - T_final (the Pallas path's
// alpha) straight into (H, W) image layout, and skips the pixels of ragged
// edge tiles that lie outside the image.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinT = 1e-4f;

__global__ void composite_kernel(const float4* __restrict__ payload, int K,
                                 int chunk, int tile_px, int tiles_x, int H,
                                 int W, const float* __restrict__ bg,
                                 float* __restrict__ rgb,
                                 float* __restrict__ depth,
                                 float* __restrict__ alpha) {
  extern __shared__ float4 rows[];  // chunk x 4 float4 (16 floats per splat)
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int y = (tile / tiles_x) * tile_px + tid / tile_px;
  const int x = (tile % tiles_x) * tile_px + tid % tile_px;
  const bool inside = y < H && x < W;
  const float px = x + 0.5f, py = y + 0.5f;
  const float4* src = payload + static_cast<long long>(tile) * K * 4;

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, cd = 0.f;
  bool done = !inside;
  for (int c0 = 0; c0 < K; c0 += chunk) {
    // a barrier too: the previous chunk is consumed before it is replaced
    if (!__syncthreads_or(!done)) break;
    const int n = min(chunk, K - c0);
    for (int i = tid; i < n * 4; i += blockDim.x) rows[i] = src[c0 * 4 + i];
    __syncthreads();
    for (int j = 0; j < n && !done; ++j) {
      const float4 p0 = rows[4 * j];      // mx, my, conic a, conic b
      const float4 p1 = rows[4 * j + 1];  // conic c, opacity, r, g
      const float dx = px - p0.x;
      const float dy = py - p0.y;
      const float power = -0.5f * (p0.z * dx * dx + p1.x * dy * dy) - p0.w * dx * dy;
      const float a = fminf(kMaxAlpha, p1.y * expf(fminf(power, 0.f)));
      if (power > 0.f || a < kMinAlpha) continue;
      const float2 p2 = *reinterpret_cast<const float2*>(&rows[4 * j + 2]);  // b, depth
      const float w = T * a;
      cr += w * p1.z;
      cg += w * p1.w;
      cb += w * p2.x;
      cd += w * p2.y;
      T *= 1.f - a;
      done = T < kMinT;
    }
  }
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

// payload: (tiles_y * tiles_x, K, 16) float32, contiguous, 16-byte aligned;
// bg (3,), rgb (H, W, 3), depth and alpha (H, W) float32, all on the card.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int vs_composite(const void* payload, int num_tiles, int K,
                            int chunk, int tile_px, int tiles_x, int H, int W,
                            const void* bg, void* rgb, void* depth, void* alpha,
                            void* stream) {
  const size_t smem = static_cast<size_t>(chunk) * 16 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_kernel<<<num_tiles, tile_px * tile_px, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(payload), K, chunk, tile_px, tiles_x, H, W,
      static_cast<const float*>(bg), static_cast<float*>(rgb), static_cast<float*>(depth),
      static_cast<float*>(alpha));
  return static_cast<int>(cudaGetLastError());
}
