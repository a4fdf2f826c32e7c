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
// 3.35 TB/s; the arithmetic (the weights and 2-4 x CH products per output
// column) is far below the f32 rate.
// Design: the support of K is at most four texels, so no weight matrix, no
// band masks, no matmul: each thread owns four consecutive n of one row,
// reads their positions with one 16-byte load, computes each one's weights
// once and gathers only the taps of the support for every channel: two for
// order 1 (the other two weigh zero), four for orders 3 and 5 (the order is
// a template parameter, so no weight function branches at run time). Each
// channel and plane goes out in one 16-byte store. Where the row's [CH, K]
// slab fits the stage (48 KB), the block copies it to shared memory with
// cp.async and the gathers read it there; a longer row is gathered through
// L1. f32 throughout, built with -fmad=false: the taps are summed in the
// plain version's order (ascending k), each product rounded as it rounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NPT = 4;                    // outputs n per thread
constexpr int SPAN = THREADS * NPT;       // outputs n per block and sweep
constexpr size_t STAGE_BYTES = 48 * 1024;  // the row slab staged in shared memory

template <int ORDER>
__device__ __forceinline__ float kernel_weight(float t) {
  const float at = fabsf(t);
  if constexpr (ORDER == 1) {
    return fmaxf(1.0f - at, 0.0f);
  } else if constexpr (ORDER == 3) {
    const float inner = (1.5f * at - 2.5f) * at * at + 1.0f;
    const float outer = ((-0.5f * at + 2.5f) * at - 4.0f) * at + 2.0f;
    return at < 1.0f ? inner : (at < 2.0f ? outer : 0.0f);
  } else {
    const float inner = (4.0f - 6.0f * at * at + 3.0f * at * at * at) / 6.0f;
    const float o2 = 2.0f - at;
    const float outer = o2 * o2 * o2 / 6.0f;
    return at < 1.0f ? inner : (at < 2.0f ? outer : 0.0f);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// One sweep: the thread's outputs n0 .. n0 + 3 of row i. ``xi`` is the row's
// [CH, K] slab (shared or global), ``oi`` the row's first output plane.
template <int CH, int ORDER, bool TAPS>
__device__ __forceinline__ void resample_four(const float* __restrict__ xi,
                                              const float* __restrict__ pi,
                                              float* __restrict__ oi, int K, int N,
                                              int n0, bool vec) {
  // taps floor(pos) + d - 1 for d in [D0, D0 + ND): all four for orders 3
  // and 5, the two central ones for order 1
  constexpr int D0 = ORDER == 1 ? 1 : 0;
  constexpr int ND = ORDER == 1 ? 2 : 4;
  const int nn = min(NPT, N - n0);
  float p[NPT];
  if (vec && nn == NPT) {
    const float4 p4 = *reinterpret_cast<const float4*>(pi + n0);
    p[0] = p4.x, p[1] = p4.y, p[2] = p4.z, p[3] = p4.w;
  } else {
#pragma unroll
    for (int e = 0; e < NPT; ++e) p[e] = e < nn ? pi[n0 + e] : 0.0f;
  }
  float w[NPT][ND];
  int idx[NPT][ND];
  bool ok[NPT][ND];
#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const float k0 = floorf(p[e]);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float k = k0 + (float)(D0 + d - 1);
      ok[e][d] = k >= 0.0f && k <= (float)(K - 1);
      idx[e][d] = ok[e][d] ? (int)k : 0;
      w[e][d] = kernel_weight<ORDER>(k - p[e]);
    }
  }
  const size_t plane = (size_t)CH * N;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float* xc = xi + (size_t)c * K;
    float y[NPT], t0[NPT], t1[NPT];
#pragma unroll
    for (int e = 0; e < NPT; ++e) {
      float v[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) v[d] = ok[e][d] ? xc[idx[e][d]] : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        if (ok[e][d]) acc = acc + w[e][d] * v[d];
      y[e] = acc;
      t0[e] = v[1 - D0];  // floor(pos)
      t1[e] = v[2 - D0];  // floor(pos) + 1
    }
    float* o = oi + (size_t)c * N + n0;
    if (vec && nn == NPT) {
      *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      if constexpr (TAPS) {
        *reinterpret_cast<float4*>(o + plane) = make_float4(t0[0], t0[1], t0[2], t0[3]);
        *reinterpret_cast<float4*>(o + 2 * plane) = make_float4(t1[0], t1[1], t1[2], t1[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < NPT; ++e) {
        if (e >= nn) break;
        o[e] = y[e];
        if constexpr (TAPS) {
          o[plane + e] = t0[e];
          o[2 * plane + e] = t1[e];
        }
      }
    }
  }
}

// Unstaged: block (x, i) owns outputs [x SPAN, (x + 1) SPAN) of row i and
// gathers from device memory (through L1).
template <int CH, int ORDER, bool TAPS>
__global__ void __launch_bounds__(THREADS)
    resample_rows_kernel(const float* __restrict__ X, const float* __restrict__ pos,
                         float* __restrict__ out, int K, int N, int vec) {
  const int i = blockIdx.y;
  const int n0 = (blockIdx.x * THREADS + threadIdx.x) * NPT;
  if (n0 >= N) return;
  resample_four<CH, ORDER, TAPS>(X + (size_t)i * CH * K, pos + (size_t)i * N,
                                 out + (size_t)i * (TAPS ? 3 : 1) * CH * N, K, N, n0,
                                 vec != 0);
}

// Staged: block i copies row i's [CH, K] slab to shared memory, then sweeps
// the row's outputs SPAN at a time.
template <int CH, int ORDER, bool TAPS>
__global__ void __launch_bounds__(THREADS)
    resample_rows_staged_kernel(const float* __restrict__ X, const float* __restrict__ pos,
                                float* __restrict__ out, int K, int N, int vec) {
  extern __shared__ __align__(16) float slab[];  // [CH, K]
  const int i = blockIdx.y;
  const float* xi = X + (size_t)i * CH * K;
  const int chunks = CH * K / 4;
  for (int e = threadIdx.x; e < chunks; e += THREADS) cp_async16(slab + 4 * e, xi + 4 * e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const float* pi = pos + (size_t)i * N;
  float* oi = out + (size_t)i * (TAPS ? 3 : 1) * CH * N;
  for (int n0 = threadIdx.x * NPT; n0 < N; n0 += SPAN)
    resample_four<CH, ORDER, TAPS>(slab, pi, oi, K, N, n0, vec != 0);
}

template <int ORDER, bool TAPS>
int launch(const float* X, const float* pos, float* out, int NB, int K, int N,
           cudaStream_t s) {
  constexpr int CH = 8;
  const size_t slab = (size_t)CH * K * sizeof(float);
  // 16-byte position loads and output stores need 16-byte aligned rows
  const int vec = N % 4 == 0 && (uintptr_t)pos % 16 == 0 && (uintptr_t)out % 16 == 0;
  const bool fits = slab <= STAGE_BYTES && K % 4 == 0 && (uintptr_t)X % 16 == 0;
  if (fits) {
    resample_rows_staged_kernel<CH, ORDER, TAPS>
        <<<dim3(1, NB), THREADS, slab, s>>>(X, pos, out, K, N, vec);
  } else {
    resample_rows_kernel<CH, ORDER, TAPS>
        <<<dim3((N + SPAN - 1) / SPAN, NB), THREADS, 0, s>>>(X, pos, out, K, N, vec);
  }
  return (int)cudaGetLastError();
}

template <int ORDER>
int launch_taps(const float* X, const float* pos, float* out, int NB, int K, int N,
                int taps, cudaStream_t s) {
  return taps ? launch<ORDER, true>(X, pos, out, NB, K, N, s)
              : launch<ORDER, false>(X, pos, out, NB, K, N, s);
}

}  // namespace

// X [NB, CH, K], pos [NB, 1, N] -> out [NB, CH, N] or [NB, 3, CH, N], f32.
extern "C" int resample_rows_launch(const float* X, const float* pos, float* out,
                                    int NB, int CH, int K, int N, int order, int taps,
                                    void* stream) {
  if (CH != 8 || NB <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 1: return launch_taps<1>(X, pos, out, NB, K, N, taps, s);
    case 3: return launch_taps<3>(X, pos, out, NB, K, N, taps, s);
    case 5: return launch_taps<5>(X, pos, out, NB, K, N, taps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
