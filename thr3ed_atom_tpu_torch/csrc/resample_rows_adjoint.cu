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
//
// Design: one block owns one scanline i. It stages the row's positions in
// shared memory and votes (__syncthreads_and) on whether they never decrease
// or never increase; the warp's rows are monotone maps clipped at both ends,
// so that is the rule.
//  - Monotone rows gather. A thread owns a texel k; the outputs whose taps
//    reach k (floor(pos) in [k - 2, k + 1], [k - 1, k] for order 1) are one
//    contiguous run, found by two binary searches over the staged positions.
//    The thread sums the run's weighted cotangents in registers and writes
//    dX[i, :, k] once: no atomics, a fixed order. A run longer than LONG_RUN
//    (whole stretches clipped onto the frame's edge) is split over the
//    warp's 32 lanes and summed by a butterfly of shuffles, so one thread
//    does not walk it alone.
//  - Other rows scatter into a CH x K copy of dX[i] in shared memory, a
//    thread per output n, one shared-memory atomic per tap and channel. No
//    path of the port sends such rows; the scatter keeps the kernel's
//    contract for any positions.
// The order of the scatter's atomics varies from run to run, and the gather
// sums in n order where the plain version's scatter_add_ sums in another, so
// the result matches the plain version to f32 round-off, not bit for bit.
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
constexpr int LONG_RUN = 16;  // runs longer than this are summed by the whole warp
constexpr unsigned FULL = 0xffffffffu;

// First j in [0, n) with ps[j] >= x, for non-decreasing ps.
__device__ __forceinline__ int lower_bound(const float* ps, int n, float x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (ps[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

struct Row {
  const float* g0;  // [CH, N] the resample's cotangent
  const float* g1;  // [CH, N] the tap planes (nullptr without taps)
  const float* g2;
  const float* ps;  // [N] the positions in non-decreasing order (shared memory)
  int N, order;
  bool reversed;  // ps[j] is pos[N - 1 - j]
};

// a[c] += the contribution of staged output j to texel k
template <int CH>
__device__ __forceinline__ void add_output(const Row& r, int j, int k, float* a) {
  const int n = r.reversed ? r.N - 1 - j : j;
  const float p = r.ps[j];
  const float f = floorf(p);
  const float kf = (float)k;
  const float w = kernel_weight(kf - p, r.order);
#pragma unroll
  for (int c = 0; c < CH; ++c) a[c] = a[c] + w * __ldg(r.g0 + (size_t)c * r.N + n);
  if (r.g1 != nullptr) {
    if (kf == f) {
#pragma unroll
      for (int c = 0; c < CH; ++c) a[c] = a[c] + __ldg(r.g1 + (size_t)c * r.N + n);
    } else if (kf == f + 1.0f) {
#pragma unroll
      for (int c = 0; c < CH; ++c) a[c] = a[c] + __ldg(r.g2 + (size_t)c * r.N + n);
    }
  }
}

template <int CH>
__device__ void gather_row(const Row& r, float* dxi, int K) {
  const int lane = threadIdx.x & 31;
  // outputs reach texel k from floor(pos) in [k - below, k + above]
  const float below = r.order == 1 ? 1.0f : 2.0f;
  const float above = r.order == 1 ? 1.0f : 2.0f;
  for (int kb = threadIdx.x - lane; kb < K; kb += THREADS) {  // warp-uniform
    const int k = kb + lane;
    int lo = 0, hi = 0;
    if (k < K) {
      lo = lower_bound(r.ps, r.N, (float)k - below);
      hi = lower_bound(r.ps, r.N, (float)k + above);
    }
    float a[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) a[c] = 0.0f;
    const bool long_run = hi - lo > LONG_RUN;
    if (!long_run)
      for (int j = lo; j < hi; ++j) add_output<CH>(r, j, k, a);
    for (unsigned todo = __ballot_sync(FULL, long_run); todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const int lo_s = __shfl_sync(FULL, lo, src);
      const int hi_s = __shfl_sync(FULL, hi, src);
      float part[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) part[c] = 0.0f;
      for (int j = lo_s + lane; j < hi_s; j += 32) add_output<CH>(r, j, kb + src, part);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) part[c] = part[c] + __shfl_xor_sync(FULL, part[c], d);
        if (lane == src) a[c] = part[c];
      }
    }
    if (k < K) {
#pragma unroll
      for (int c = 0; c < CH; ++c) dxi[(size_t)c * K + k] = a[c];
    }
  }
}

template <int CH>
__device__ void scatter_row(const float* __restrict__ pi, const Row& r, float* acc, float* dxi,
                            int K) {
  for (int t = threadIdx.x; t < CH * K; t += THREADS) acc[t] = 0.0f;
  __syncthreads();
  for (int n = threadIdx.x; n < r.N; n += THREADS) {
    const float p = pi[n];
    const float k0 = floorf(p);
    float w[4];
    int idx[4];
    bool ok[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float k = k0 + (float)(d - 1);
      ok[d] = k >= 0.0f && k <= (float)(K - 1);
      idx[d] = ok[d] ? (int)k : 0;
      w[d] = kernel_weight(k - p, r.order);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float g = r.g0[(size_t)c * r.N + n];
      float* row = acc + c * K;
      // the tap planes land on the two central taps: one atomic per tap
      const float g1 = r.g1 != nullptr ? r.g1[(size_t)c * r.N + n] : 0.0f;
      const float g2 = r.g2 != nullptr ? r.g2[(size_t)c * r.N + n] : 0.0f;
      if (ok[0]) atomicAdd(row + idx[0], w[0] * g);
      if (ok[1]) atomicAdd(row + idx[1], w[1] * g + g1);
      if (ok[2]) atomicAdd(row + idx[2], w[2] * g + g2);
      if (ok[3]) atomicAdd(row + idx[3], w[3] * g);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < CH * K; t += THREADS) dxi[t] = acc[t];
}

template <int CH>
__global__ void __launch_bounds__(THREADS)
    resample_rows_adjoint_kernel(const float* __restrict__ dY,
                                 const float* __restrict__ pos,
                                 float* __restrict__ dX, int K, int N,
                                 int order, int taps) {
  extern __shared__ float smem[];  // [N] positions, then [CH, K] for a scatter
  const int i = blockIdx.x;
  const float* pi = pos + (size_t)i * N;
  bool up = true, down = true;
  for (int n = threadIdx.x; n + 1 < N; n += THREADS) {
    const float p = pi[n], q = pi[n + 1];
    up = up && p <= q;
    down = down && p >= q;
  }
  const bool rising = __syncthreads_and(up);
  const bool falling = __syncthreads_and(down) && !rising;
  const size_t plane = (size_t)CH * N;
  const float* dyi = dY + (size_t)i * (taps ? 3 : 1) * plane;
  float* dxi = dX + (size_t)i * CH * K;
  Row r{dyi, taps ? dyi + plane : nullptr, taps ? dyi + 2 * plane : nullptr, smem, N, order,
        falling};
  if (rising || falling) {
    for (int j = threadIdx.x; j < N; j += THREADS) smem[j] = pi[falling ? N - 1 - j : j];
    __syncthreads();
    gather_row<CH>(r, dxi, K);
  } else {
    scatter_row<CH>(pi, r, smem + ((N + 3) & ~3), dxi, K);
  }
}

}  // namespace

// dY [NB, CH, N] (or [NB, 3, CH, N] with taps), pos [NB, 1, N] -> dX
// [NB, CH, K], f32.
extern "C" int resample_rows_adjoint_launch(const float* dY, const float* pos,
                                            float* dX, int NB, int CH, int K,
                                            int N, int order, int taps,
                                            void* stream) {
  if (CH != 8) return (int)cudaErrorInvalidValue;
  if (NB <= 0 || K <= 0) return 0;
  const size_t smem = ((size_t)((N + 3) & ~3) + (size_t)CH * K) * sizeof(float);
  auto kern = resample_rows_adjoint_kernel<8>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<NB, THREADS, smem, (cudaStream_t)stream>>>(dY, pos, dX, K, N, order, taps);
  return (int)cudaGetLastError();
}
