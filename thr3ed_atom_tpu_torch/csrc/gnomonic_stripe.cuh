// gnomonic_stripe: what the stripe composite (composite_stripe.cu, K5) and its
// replay backwards (composite_stripe_backward.cu, K7 and K8) share: the column
// taps of the v-tent matrix and the two-tap values of a position at a texel
// from the u-resampled stack t1.
//
// The TPU kernels take the v-tents as a dense bf16 matrix RvT [NP, nv, Qn] and
// resample with a matmul, vals[c, p, q] = sum_v t1[c, p, v] RvT[v, q] (bf16
// products, f32 sum). A column of a tent matrix has at most two nonzero rows,
// adjacent: floor(V) and floor(V) + 1. Every bf16 x bf16 product is exact in
// f32, so the sum over a column's two taps, in ascending v, equals the dense
// product exactly. column_taps_kernel reads each column once and keeps
// (first nonzero row, its weight, the next row's weight); a column that is not
// such a tent gets a NaN weight, so the result shows it instead of silently
// differing from the dense product.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include "gnomonic_march.cuh"

namespace gnomonic {

// taps[j, q] = (v0 as int bits, RvT[j, v0, q], RvT[j, v0 + 1, q] or 0, 0);
// v0 = 0 with zero weights for a column without taps. With q_lo / q_hi (both
// [NP, nv], set to INT_MAX / -1 by the caller), also the range of columns
// whose taps reach each row v (atomicMin / atomicMax: order-free), the
// transposed tents the backward folds with.
__global__ void column_taps_kernel(const __nv_bfloat16* __restrict__ rvt,
                                   float4* __restrict__ taps, int* q_lo, int* q_hi,
                                   int NP, int nv, int Qn) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (q >= Qn || j >= NP) return;
  const __nv_bfloat16* col = rvt + (size_t)j * nv * Qn + q;
  int v0 = -1, last = -1;
  for (int v = 0; v < nv; ++v) {
    if (__bfloat162float(col[(size_t)v * Qn]) != 0.0f) {
      if (v0 < 0) v0 = v;
      last = v;
    }
  }
  float w0 = 0.0f, w1 = 0.0f;
  if (v0 >= 0) {
    w0 = __bfloat162float(col[(size_t)v0 * Qn]);
    if (v0 + 1 < nv) w1 = __bfloat162float(col[(size_t)(v0 + 1) * Qn]);
    if (last > v0 + 1) w0 = nanf("");  // not a two-tap tent
    if (q_lo != nullptr) {
      atomicMin(q_lo + (size_t)j * nv + v0, q);
      atomicMax(q_hi + (size_t)j * nv + v0, q);
      if (w1 != 0.0f) {
        atomicMin(q_lo + (size_t)j * nv + v0 + 1, q);
        atomicMax(q_hi + (size_t)j * nv + v0 + 1, q);
      }
    }
  } else {
    v0 = 0;
  }
  taps[(size_t)j * Qn + q] = make_float4(__int_as_float(v0), w0, w1, 0.0f);
}

// The stripe operands of one texel (p, q): t1 [NP, C, Pn, nv] bf16 with unit
// stride along v (strides sj, sc, sp), the column taps, live_u [NP, Pn] and
// live_v [NP, Qn] (f32 0/1).
struct StripeOperands {
  const __nv_bfloat16* t1;
  long long sj, sc, sp;
  const float4* taps;
  const float* live_u;
  const float* live_v;
  int Pn, Qn, nv;
};

// A position's values at one texel from its t1 row (channel c at
// row[c * sc + v], in device or shared memory) and its column taps tp:
// vals[c] = 0 + w0 t1[c, v0] + w1 t1[c, v0 + 1] per used channel (the dense
// product's f32 sum, exactly), then the SH fold.
template <int NCOEFF>
__device__ __forceinline__ void two_tap_values(const __nv_bfloat16* row, long long sc,
                                               float4 tp, int nv, const float* yb,
                                               float& sig, float* rgb, float* dif) {
  constexpr int USED = 3 * NCOEFF + 1;
  const int v0 = __float_as_int(tp.x);
  const int v1 = min(v0 + 1, nv - 1);  // weight 0 past the last row
  sig = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = dif[c] = 0.0f;
#pragma unroll
  for (int c = 0; c < USED; ++c) {
    const __nv_bfloat16* r = row + c * sc;
    fold_channel<NCOEFF>(c, 0.0f + tp.y * __bfloat162float(r[v0]) +
                                tp.z * __bfloat162float(r[v1]),
                         yb, sig, rgb, dif);
  }
}

template <int NCOEFF>
struct StripeSource {
  StripeOperands op;
  int p, q;
  const float* yb;
  // position j's values (two_tap_values); the texel is live where
  // live_u[j, p] * live_v[j, q] is
  __device__ __forceinline__ void values(int j, const float* G, float& sig,
                                         float* rgb, float* dif,
                                         float& live) const {
    (void)G;
    live = op.live_u[(size_t)j * op.Pn + p] * op.live_v[(size_t)j * op.Qn + q];
    two_tap_values<NCOEFF>(op.t1 + j * op.sj + p * op.sp, op.sc,
                           op.taps[(size_t)j * op.Qn + q], op.nv, yb, sig, rgb, dif);
  }
};

}  // namespace gnomonic
