// smem_limit: raising a kernel's dynamic shared-memory limit, shared by the
// kernels that launch with more than the default 48 KB (K1, K3, K5 / K6, K7,
// K10, K12, K13 / K14).
#pragma once

#include <cuda_runtime.h>

// Raises a kernel's dynamic shared-memory limit to `bytes` once per device
// and size (done: the limit set so far on each device), not on every launch:
// the driver call costs host time on the launch path.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kern, size_t bytes, size_t (&done)[16]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && bytes <= done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev < 16) done[dev] = bytes;
  return e;
}
