// resample_rows: the banded 1-D scanline resample of the two-pass warp.
//
// Replaces the TPU kernel thr3ed_atom_tpu/rendering/warp_matmul.py
// _resample_call (adjoint=False; kernel _make_resample_kernel), which builds
// the banded weight matrix W_i[k, n] = K(k - pos[i, n]) in 128 x 128 chunks
// and runs f32 matmuls over the chunks that the band and a nonzero source
// reach. Computes, for every scanline i and output n,
//   Y[i, c, n] = sum_k K(k - pos[i, n]) X[i, c, k]
// for bilinear (order 1), Catmull-Rom (3) or cubic B-spline (5) K, and with
// `taps` the central taps X[i, c, floor(pos)] and X[i, c, floor(pos) + 1] as
// planes 1 and 2 of [NB, 3, CH, N].
//
// Bound on the H100: memory. At the render path's shapes (NB = K = N = 512,
// CH = 8, taps on) a pass reads 8.4 MB and writes 25 MB, about 10 us at
// 3.35 TB/s; the arithmetic (four weights and 4 x CH products per output
// column) is far below the f32 rate.
// Design: the support of K is at most four texels, so each thread owns one
// (i, n), computes the four weights once, and gathers only floor(pos) - 1 ..
// floor(pos) + 2 for every channel: no weight matrix, no band masks, no
// matmul. Neighbouring threads own neighbouring n, whose positions are
// neighbouring k, so the gathers and the stores coalesce. f32 throughout,
// built with -fmad=false: the taps are summed in the plain version's order.
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

template <int CH>
__global__ void __launch_bounds__(128)
    resample_rows_kernel(const float* __restrict__ X,
                         const float* __restrict__ pos,
                         float* __restrict__ out, int K, int N, int order,
                         int taps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (n >= N) return;
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
  const float* xi = X + (size_t)i * CH * K;
  const size_t plane = (size_t)CH * N;
  float* oi = out + (size_t)i * (taps ? 3 : 1) * plane;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float* xc = xi + (size_t)c * K;
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      if (ok[d]) acc = acc + w[d] * xc[idx[d]];
    oi[(size_t)c * N + n] = acc;
    if (taps) {
      oi[plane + (size_t)c * N + n] = ok[1] ? xc[idx[1]] : 0.0f;
      oi[2 * plane + (size_t)c * N + n] = ok[2] ? xc[idx[2]] : 0.0f;
    }
  }
}

}  // namespace

// X [NB, CH, K], pos [NB, 1, N] -> out [NB, CH, N] or [NB, 3, CH, N], f32.
extern "C" int resample_rows_launch(const float* X, const float* pos,
                                    float* out, int NB, int CH, int K, int N,
                                    int order, int taps, void* stream) {
  const dim3 block(128);
  const dim3 grid((N + 127) / 128, NB);
  cudaStream_t s = (cudaStream_t)stream;
  if (CH == 8)
    resample_rows_kernel<8><<<grid, block, 0, s>>>(X, pos, out, K, N, order, taps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
