// resample_rows_adjoint: the adjoint of the banded 1-D scanline resample
// (resample_rows.cu), the warp's backward.
//
// Replaces the TPU kernel thr3ed_atom_tpu/rendering/warp_matmul.py
// _resample_call with adjoint=True (reached through _resample_bwd), which
// contracts the same banded weight matrix W_i[k, n] = K(k - pos[i, n]) over
// the output axis n in 128 x 128 chunks. Computes, for every scanline i,
//   dX[i, c, k] = sum_n K(k - pos[i, n]) dY[i, 0, c, n]
//               + [k == floor(pos[i, n])]     dY[i, 1, c, n]
//               + [k == floor(pos[i, n]) + 1] dY[i, 2, c, n]
// (the tap planes only with `taps`; without them dY is [NB, CH, N]) for
// bilinear (order 1), Catmull-Rom (3) or cubic B-spline (5) K; taps outside
// [0, K) contribute nothing.
//
// Bound on the H100: memory. At the warp's shapes (NB = K = N = 512, CH = 8,
// taps on) a pass reads 25 MB of cotangent and writes 8.4 MB, about 10 us at
// 3.35 TB/s.
// Design: a scatter — many outputs n can land on one k (the warp clips whole
// runs of positions onto the frame's edge, and a row's positions need not be
// monotone). One block owns one scanline i and holds its dX[i] (CH x K f32,
// 16 KB at K = 512) in shared memory; its threads walk the outputs n, compute
// the four weights of each once and add their CH contributions with shared-
// memory atomics (the tap planes folded into the central taps' adds, four
// atomics per output and channel); the row is written to global memory once. No global
// atomics, no band masks. The order of the additions varies from run to run,
// so the result matches the plain version to f32 round-off, not bit for bit.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float kernel_weight(float t, int order) {
  const float at = fabsf(t);
  if (order == 1) return fmaxf(1.0f - at, 0.0f);
  if (order == 3) {
    const float inner = (1.5f * at - 2.5f) * at * at + 1.0f;
    const float outer = ((-0.5f * at + 2.5f) * at - 4.0f) * at + 2.0f;
    return at < 1.0f ? inner : (at < 2.0f ? outer : 0.0f);
  }
  const float inner = (4.0f - 6.0f * at * at + 3.0f * at * at * at) / 6.0f;
  const float o2 = 2.0f - at;
  const float outer = o2 * o2 * o2 / 6.0f;
  return at < 1.0f ? inner : (at < 2.0f ? outer : 0.0f);
}

constexpr int THREADS = 256;

template <int CH>
__global__ void __launch_bounds__(THREADS)
    resample_rows_adjoint_kernel(const float* __restrict__ dY,
                                 const float* __restrict__ pos,
                                 float* __restrict__ dX, int K, int N,
                                 int order, int taps) {
  extern __shared__ float acc[];  // [CH, K]
  const int i = blockIdx.x;
  for (int t = threadIdx.x; t < CH * K; t += THREADS) acc[t] = 0.0f;
  __syncthreads();
  const size_t plane = (size_t)CH * N;
  const float* dyi = dY + (size_t)i * (taps ? 3 : 1) * plane;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    const float p = pos[(size_t)i * N + n];
    const float k0 = floorf(p);
    float w[4];
    int idx[4];
    bool ok[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float k = k0 + (float)(d - 1);
      ok[d] = k >= 0.0f && k <= (float)(K - 1);
      idx[d] = ok[d] ? (int)k : 0;
      w[d] = kernel_weight(k - p, order);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float g = dyi[(size_t)c * N + n];
      float* row = acc + c * K;
      // the tap planes land on the two central taps: one atomic per tap
      const float g1 = taps ? dyi[plane + (size_t)c * N + n] : 0.0f;
      const float g2 = taps ? dyi[2 * plane + (size_t)c * N + n] : 0.0f;
      if (ok[0]) atomicAdd(row + idx[0], w[0] * g);
      if (ok[1]) atomicAdd(row + idx[1], w[1] * g + g1);
      if (ok[2]) atomicAdd(row + idx[2], w[2] * g + g2);
      if (ok[3]) atomicAdd(row + idx[3], w[3] * g);
    }
  }
  __syncthreads();
  float* dxi = dX + (size_t)i * CH * K;
  for (int t = threadIdx.x; t < CH * K; t += THREADS) dxi[t] = acc[t];
}

}  // namespace

// dY [NB, CH, N] (or [NB, 3, CH, N] with taps), pos [NB, 1, N] -> dX
// [NB, CH, K], f32.
extern "C" int resample_rows_adjoint_launch(const float* dY, const float* pos,
                                            float* dX, int NB, int CH, int K,
                                            int N, int order, int taps,
                                            void* stream) {
  if (CH != 8) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)CH * K * sizeof(float);
  auto kern = resample_rows_adjoint_kernel<8>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<NB, THREADS, smem, (cudaStream_t)stream>>>(dY, pos, dX, K, N, order, taps);
  return (int)cudaGetLastError();
}
