// Elementwise test entry for the relu_trap device function (relu_trap.cuh):
// out[0..3][i] = (integ, tbar, dIda, dIdb) of (a[i], b[i]). It exists so that
// the device function can be held against its plain PyTorch version
// (thr3ed_atom_tpu_torch/ops/relu_trap.py relu_trap_plain) on the card; the
// render path runs relu_trap inside composite_fused.cu.
//
// Bound on the H100: memory (8 bytes in, 16 out per element); one thread per
// element with a grid-stride loop, coalesced loads and stores.
#include <cuda_runtime.h>

#include "relu_trap.cuh"

template <bool RELU>
__global__ void relu_trap_eval_kernel(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float integ, tbar, dIda, dIdb;
    relu_trap<RELU>(a[i], b[i], integ, tbar, dIda, dIdb);
    out[i] = integ;
    out[n + i] = tbar;
    out[2 * n + i] = dIda;
    out[3 * n + i] = dIdb;
  }
}

extern "C" int relu_trap_eval(const float* a, const float* b, float* out,
                              long long n, int relu, void* stream) {
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? (want > 0 ? want : 1) : 132 * 64);
  cudaStream_t s = (cudaStream_t)stream;
  if (relu)
    relu_trap_eval_kernel<true><<<blocks, threads, 0, s>>>(a, b, out, n);
  else
    relu_trap_eval_kernel<false><<<blocks, threads, 0, s>>>(a, b, out, n);
  return (int)cudaGetLastError();
}
