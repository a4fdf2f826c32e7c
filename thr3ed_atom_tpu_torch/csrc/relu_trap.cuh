// relu_trap: closed-form cell integrals of the linear density model.
//
// Replaces the device function _relu_trap of the TPU kernels
// (thr3ed_atom_tpu/ops/pallas/plane_march.py:83), which the gnomonic composite
// (rendering/gnomonic.py _make_composite_kernel_fused) calls once per texel and
// cell. For I = int_0^1 act(a + (b - a) t) dt with act = relu (RELU) or
// identity it returns the mean density, its emission centroid tbar and the
// endpoint derivatives dI/da, dI/db.
//
// Bound on the H100: a handful of f32 operations and one division per call, in
// registers; it costs nothing next to the loads of the kernel that calls it.
// Design: the factored form (p+q)/2 * (p-q)/s is kept exactly, with the same
// |s| <= 1e-6 branch, so near-equal endpoints do not cancel; the operations
// are written in the reference's order and the library is built with
// -fmad=false, so the results match the plain PyTorch version bit for bit.
#pragma once

template <bool RELU>
__device__ __forceinline__ void relu_trap(float a, float b, float& integ,
                                          float& tbar, float& dIda,
                                          float& dIdb) {
  if (!RELU) {
    // identity post-activation: the grid is pre-activated non-negative
    const float mean = 0.5f * (a + b);
    integ = fmaxf(mean, 0.0f);
    const float num = a / 2.0f + (b - a) / 3.0f;
    tbar = fminf(fmaxf(num / fmaxf(integ, 1e-9f), 0.0f), 1.0f);
    const float half = mean > 0.0f ? 0.5f : 0.0f;
    dIda = half;
    dIdb = half;
    return;
  }
  const float p = fmaxf(a, 0.0f);
  const float q = fmaxf(b, 0.0f);
  const float s = a - b;
  const bool both = fabsf(s) <= 1e-6f;
  const float safe = both ? 1.0f : s;
  integ = both ? 0.5f * (p + q) : 0.5f * (p + q) * (p - q) / safe;
  const float ts = fminf(fmaxf(a / safe, 0.0f), 1.0f);
  const bool pos_a = a > 0.0f, pos_b = b > 0.0f;
  // F(t) = int_0^t (a + (b - a) t') t' dt'
  const float F1 = a * 1.0f * 1.0f / 2.0f + (b - a) * 1.0f * 1.0f * 1.0f / 3.0f;
  const float Fts = a * ts * ts / 2.0f + (b - a) * ts * ts * ts / 3.0f;
  float num = (pos_a && pos_b) ? F1 : (pos_a ? Fts : F1 - Fts);
  num = (pos_a || pos_b) ? num : 0.0f;
  tbar = fminf(fmaxf(num / fmaxf(integ, 1e-9f), 0.0f), 1.0f);
  const float om = 1.0f - ts;
  dIda = (pos_a && pos_b) ? 0.5f
         : pos_a          ? ts - 0.5f * ts * ts
         : pos_b          ? 0.5f * om * om
                          : 0.0f;
  dIdb = (pos_a && pos_b) ? 0.5f
         : pos_a          ? 0.5f * ts * ts
         : pos_b          ? 0.5f * (1.0f - ts * ts)
                          : 0.0f;
}
