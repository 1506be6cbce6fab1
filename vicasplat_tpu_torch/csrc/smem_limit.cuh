// A kernel's opt-in to more than 48 KB of dynamic shared memory
// (cudaFuncAttributeMaxDynamicSharedMemorySize). The attribute belongs to
// the kernel in the current device's context: set on one card, it leaves
// the kernel at the 48 KB default on another, where a larger launch fails.
// So each launch site keeps a smem_limit::Set, the bytes it has allowed on
// each device, and asks `allow` before every launch; the attribute is set
// once per device and size.
#pragma once

#include <cuda_runtime.h>

namespace smem_limit {

constexpr int kMaxDevices = 64;

struct Set {
  int bytes[kMaxDevices] = {};
};

// Allow `kernel` `bytes` of dynamic shared memory on the current device,
// unless `set` has allowed as much there already.
template <typename Kernel>
inline cudaError_t allow(Kernel kernel, int bytes, Set& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev >= 0 && dev < kMaxDevices;
  if (tracked && set.bytes[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && tracked) set.bytes[dev] = bytes;
  return err;
}

// The current device's index into a Set-like per-device table, or -1.
inline int device_slot() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  return dev;
}

}  // namespace smem_limit
