// K1's float32 route: forward and backward flash attention in full float32
// (float32 inputs, products and sums; no TF32), at any head dim D <= 128.
//
// Replaces the Pallas TPU flash-attention kernel behind
// vicasplat_tpu/models/vicanet.py:242 (_flash_unmasked) and its library VJP
// (_flash_attention_bwd_dkv, _flash_attention_bwd_dq) where the JAX package
// runs them in float32: the training configuration
// configs/experiment/_tiny_smoke.yaml (precision float32; decoder heads of
// D = 12, encoder heads of D = 16), which the Pallas kernel takes and the
// bf16 kernels (flash_attn.cu, flash_attn_bwd.cu) do not. Same functions as
// those: out = softmax(Q K^T / sqrt(D)) V with its row log-sum-exp (natural
// log, (B, H, Sq)), and dQ, dK, dV from lse and D = rowsum(dO o O), with no
// float atomics.
//
// Bound on an H100: float32 outside the tensor cores, 67 TFLOP/s, so the
// products bound it at any shape these configurations give (4 Sq Sk H D
// operations forward against 16 (Sq + Sk) H D bytes). It is off every
// flagship path, so the design is simple: SIMT fused multiply-adds on
// tiles of 32 rows in shared memory (rows padded by one float against bank
// conflicts, head dims padded with zeros to DP = 16, 32, 64 or 128). In
// every kernel a block of 128 threads owns 32 rows, four threads a row:
// thread (r, u) computes the logits of its row against keys u, u + 4, ...
// of a 32-key tile, and the head dims u, u + 4, ... of its outputs.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: within 2e-6 of the float32 plain versions at head dims 12, 16 and
// 64; at the decoder shape in float32 (D = 64) the forward takes 1.49 ms
// and the backward 5.30 ms, 3.6x and 4.1x SDPA's float32 times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kR = 32;  // rows of a tile
constexpr int kThreads = 128;
constexpr int kPS = kR + 1;  // stride of a 32 x 32 probability tile
constexpr float kLog2e = 1.4426950408889634f;

// Rows r0.. of head h of a (B, S, H, D) tensor into shared memory with row
// stride `stride`, zeros past S or D.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, int b, int h,
                                          int r0, int S, int H, int D) {
  for (int i = threadIdx.x; i < kR * DP; i += kThreads) {
    const int rr = i / DP, d = i % DP, row = r0 + rr;
    dst[rr * stride + d] =
        row < S && d < D ? src[(((long long)b * S + row) * H + h) * D + d] : 0.f;
  }
}

template <int DP>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int H, int D,
               float scale_log2) {
  constexpr int DS = DP + 1;
  extern __shared__ float sm[];
  float* sQ = sm;             // [32][DS]
  float* sK = sQ + kR * DS;   // [32][DS]
  float* sV = sK + kR * DS;   // [32][DP]
  float* sP = sV + kR * DP;   // [32][33]
  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int q0 = blockIdx.x * kR, h = blockIdx.y, b = blockIdx.z;

  load_tile<DP>(sQ, DS, q, b, h, q0, Sq, H, D);
  float acc[DP / 4];
#pragma unroll
  for (int j = 0; j < DP / 4; ++j) acc[j] = 0.f;
  float m = -INFINITY, l = 0.f;  // m: raw logits; l: this thread's part

  for (int k0 = 0; k0 < Sk; k0 += kR) {
    __syncthreads();  // the previous tile is consumed
    load_tile<DP>(sK, DS, k, b, h, k0, Sk, H, D);
    load_tile<DP>(sV, DP, v, b, h, k0, Sk, H, D);
    __syncthreads();
    float sv[kR / 4], mx = m;
#pragma unroll
    for (int ii = 0; ii < kR / 4; ++ii) {
      const int c = u + 4 * ii;
      sv[ii] = k0 + c < Sk ? dot<DP>(sQ + r * DS, sK + c * DS) : -INFINITY;
      mx = fmaxf(mx, sv[ii]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2f((m - mx) * scale_log2);  // 0 on the first tile
    m = mx;
    l *= alpha;
#pragma unroll
    for (int ii = 0; ii < kR / 4; ++ii) {
      const float p = exp2f((sv[ii] - mx) * scale_log2);
      sP[r * kPS + u + 4 * ii] = p;
      l += p;
    }
    __syncwarp();  // a row's four threads share one warp
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      float a = acc[j] * alpha;
      for (int c = 0; c < kR; ++c) a = fmaf(sP[r * kPS + c], sV[c * DP + u + 4 * j], a);
      acc[j] = a;
    }
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const int row = q0 + r;
  if (row >= Sq) return;
  const float inv = 1.f / l;
  float* orow = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
  for (int j = 0; j < DP / 4; ++j)
    if (u + 4 * j < D) orow[u + 4 * j] = acc[j] * inv;
  if (lse != nullptr && u == 0)
    lse[((long long)b * H + h) * Sq + row] =
        (m * scale_log2 + log2f(l)) * 0.6931471805599453f;
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
__global__ void __launch_bounds__(kThreads)
f32_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int Sq, int Sk, int H, int D,
                    float scale) {
  constexpr int DS = DP + 1;
  extern __shared__ float sm[];
  float* sK = sm;               // own keys, [32][DS]
  float* sV = sK + kR * DS;     // own values
  float* sQ = sV + kR * DS;     // walked queries
  float* sdO = sQ + kR * DS;
  float* sP = sdO + kR * DS;    // P^T [key][query]
  float* sDS = sP + kR * kPS;   // dS^T
  float* sL = sDS + kR * kPS;   // lse * log2(e) of the walked queries
  float* sDl = sL + kR;         // their D
  const int c = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int k0 = blockIdx.x * kR, h = blockIdx.y, b = blockIdx.z;
  const float scale_log2 = scale * kLog2e;
  const float* lb = lse + ((long long)b * H + h) * Sq;
  const float* db = delta + ((long long)b * H + h) * Sq;

  load_tile<DP>(sK, DS, k, b, h, k0, Sk, H, D);
  load_tile<DP>(sV, DS, v, b, h, k0, Sk, H, D);
  float dk_acc[DP / 4], dv_acc[DP / 4];
#pragma unroll
  for (int j = 0; j < DP / 4; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kR) {
    __syncthreads();
    load_tile<DP>(sQ, DS, q, b, h, q0, Sq, H, D);
    load_tile<DP>(sdO, DS, dout, b, h, q0, Sq, H, D);
    if (threadIdx.x < kR) {
      const int i = q0 + threadIdx.x;
      sL[threadIdx.x] = i < Sq ? lb[i] * kLog2e : INFINITY;  // P = 0 past Sq
      sDl[threadIdx.x] = i < Sq ? db[i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < kR / 4; ++ii) {
      const int i = u + 4 * ii;
      const float p = exp2f(dot<DP>(sK + c * DS, sQ + i * DS) * scale_log2 - sL[i]);
      const float dp = dot<DP>(sV + c * DS, sdO + i * DS);
      sP[c * kPS + i] = p;
      sDS[c * kPS + i] = p * (dp - sDl[i]);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      const int d = u + 4 * j;
      float a = dv_acc[j], e = dk_acc[j];
      for (int i = 0; i < kR; ++i) {
        a = fmaf(sP[c * kPS + i], sdO[i * DS + d], a);
        e = fmaf(sDS[c * kPS + i], sQ[i * DS + d], e);
      }
      dv_acc[j] = a;
      dk_acc[j] = e;
    }
    __syncwarp();
  }
  const int key = k0 + c;
  if (key >= Sk) return;
  const long long off = (((long long)b * Sk + key) * H + h) * D;
#pragma unroll
  for (int j = 0; j < DP / 4; ++j)
    if (u + 4 * j < D) {
      dk[off + u + 4 * j] = dk_acc[j] * scale;
      dv[off + u + 4 * j] = dv_acc[j];
    }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
f32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int Sq, int Sk, int H, int D, float scale) {
  constexpr int DS = DP + 1;
  extern __shared__ float sm[];
  float* sQ = sm;               // own queries, [32][DS]
  float* sdO = sQ + kR * DS;
  float* sK = sdO + kR * DS;    // walked keys
  float* sV = sK + kR * DS;
  float* sDS = sV + kR * DS;    // dS [query][key]
  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int q0 = blockIdx.x * kR, h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + r;
  const float scale_log2 = scale * kLog2e;
  const long long stat = ((long long)b * H + h) * Sq + row;
  const float l2 = row < Sq ? lse[stat] * kLog2e : INFINITY;
  const float dl = row < Sq ? delta[stat] : 0.f;

  load_tile<DP>(sQ, DS, q, b, h, q0, Sq, H, D);
  load_tile<DP>(sdO, DS, dout, b, h, q0, Sq, H, D);
  float dq_acc[DP / 4];
#pragma unroll
  for (int j = 0; j < DP / 4; ++j) dq_acc[j] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kR) {
    __syncthreads();
    load_tile<DP>(sK, DS, k, b, h, k0, Sk, H, D);
    load_tile<DP>(sV, DS, v, b, h, k0, Sk, H, D);
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < kR / 4; ++ii) {
      const int c = u + 4 * ii;
      const float p = k0 + c < Sk
          ? exp2f(dot<DP>(sQ + r * DS, sK + c * DS) * scale_log2 - l2) : 0.f;
      const float dp = dot<DP>(sdO + r * DS, sV + c * DS);
      sDS[r * kPS + c] = p * (dp - dl);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      float a = dq_acc[j];
      for (int c = 0; c < kR; ++c) a = fmaf(sDS[r * kPS + c], sK[c * DS + u + 4 * j], a);
      dq_acc[j] = a;
    }
    __syncwarp();
  }
  if (row >= Sq) return;
  float* out = dq + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
  for (int j = 0; j < DP / 4; ++j)
    if (u + 4 * j < D) out[u + 4 * j] = dq_acc[j] * scale;
}

template <int DP>
constexpr int fwd_smem() { return (2 * kR * (DP + 1) + kR * DP + kR * kPS) * 4; }
template <int DP>
constexpr int dkdv_smem() { return (4 * kR * (DP + 1) + 2 * kR * kPS + 2 * kR) * 4; }
template <int DP>
constexpr int dq_smem() { return (4 * kR * (DP + 1) + kR * kPS) * 4; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return bytes > 48 * 1024
      ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes)
      : cudaSuccess;
}

template <int DP>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int B, int Sq, int Sk, int H, int D, cudaStream_t st) {
  const cudaError_t err = allow_smem(f32_fwd_kernel<DP>, fwd_smem<DP>());
  if (err != cudaSuccess) return static_cast<int>(err);
  f32_fwd_kernel<DP><<<dim3((Sq + kR - 1) / kR, H, B), kThreads, fwd_smem<DP>(),
                       st>>>(q, k, v, o, lse, Sq, Sk, H, D,
                             kLog2e / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int bwd(const float* q, const float* k, const float* v, const float* o,
        const float* dout, const float* lse, float* delta, float* dq, float* dk,
        float* dv, int B, int Sq, int Sk, int H, int D, cudaStream_t st) {
  cudaError_t err = allow_smem(f32_bwd_dkdv_kernel<DP>, dkdv_smem<DP>());
  if (err == cudaSuccess) err = allow_smem(f32_bwd_dq_kernel<DP>, dq_smem<DP>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf((float)D);
  const long long rows = (long long)B * Sq * H;
  f32_bwd_prep_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      o, dout, delta, B, Sq, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  f32_bwd_dkdv_kernel<DP><<<dim3((Sk + kR - 1) / kR, H, B), kThreads,
                            dkdv_smem<DP>(), st>>>(q, k, v, dout, lse, delta,
                                                   dk, dv, Sq, Sk, H, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  f32_bwd_dq_kernel<DP><<<dim3((Sq + kR - 1) / kR, H, B), kThreads,
                          dq_smem<DP>(), st>>>(q, k, v, dout, lse, delta, dq,
                                               Sq, Sk, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, Sq, H, D) float32; k, v: (B, Sk, H, D); lse: (B, H, Sq) float32
// or null. All contiguous; 1 <= D <= 128. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for D out of range).
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
  if (D <= 16) return fwd<16>(fq, fk, fv, fo, fl, B, Sq, Sk, H, D, st);
  if (D <= 32) return fwd<32>(fq, fk, fv, fo, fl, B, Sq, Sk, H, D, st);
  if (D <= 64) return fwd<64>(fq, fk, fv, fo, fl, B, Sq, Sk, H, D, st);
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
  if (D <= 16)
    return bwd<16>(fq, fk, fv, fo, fdo, fl, fd, fdq, fdk, fdv, B, Sq, Sk, H, D, st);
  if (D <= 32)
    return bwd<32>(fq, fk, fv, fo, fdo, fl, fd, fdq, fdk, fdv, B, Sq, Sk, H, D, st);
  if (D <= 64)
    return bwd<64>(fq, fk, fv, fo, fdo, fl, fd, fdq, fdk, fdv, B, Sq, Sk, H, D, st);
  return bwd<128>(fq, fk, fv, fo, fdo, fl, fd, fdq, fdk, fdv, B, Sq, Sk, H, D, st);
}
