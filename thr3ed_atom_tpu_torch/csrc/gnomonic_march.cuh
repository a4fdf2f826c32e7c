// gnomonic_march: the per-texel march code shared by the fused composite
// (composite_fused.cu, K1) and its replay backward
// (composite_backward_fused.cu, K3). The backward replays the forward bit for
// bit, so both kernels build a position's values with the same function here:
// the lerp of the two vertex slices, the two bf16 tents, the bf16 u-resample,
// the f32 v-resample and the SH fold, each rounded where the reference rounds.
// Built with -fmad=false by every library that includes it.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gnomonic {

constexpr int TP = 8;   // texel rows (p) per block  — CUDA_EXIT_TILE in gnomonic.py
constexpr int TQ = 32;  // texel columns (q) per block
constexpr int GEOM_COLS = 6;  // s_j, cell_step, bu, ku, bv, kv

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// SH basis of unit direction (x, y, z), PlenOctree convention; the constants
// are the double values rounded to float, as the reference's weak-typed ones
template <int NCOEFF>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* yb) {
  yb[0] = (float)0.28209479177387814 * 1.0f;
  if constexpr (NCOEFF > 1) {
    const float c1 = (float)0.4886025119029199;
    yb[1] = -c1 * y;
    yb[2] = c1 * z;
    yb[3] = -c1 * x;
  }
  if constexpr (NCOEFF > 4) {
    yb[4] = (float)1.0925484305920792 * x * y;
    yb[5] = (float)-1.0925484305920792 * y * z;
    yb[6] = (float)0.31539156525252005 * (2.0f * z * z - x * x - y * y);
    yb[7] = (float)-1.0925484305920792 * x * z;
    yb[8] = (float)0.5462742152960396 * (x * x - y * y);
  }
  if constexpr (NCOEFF > 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    yb[9] = (float)-0.5900435899266435 * y * (3.0f * xx - yy);
    yb[10] = (float)2.890611442640554 * x * y * z;
    yb[11] = (float)-0.4570457994644658 * y * (4.0f * zz - xx - yy);
    yb[12] = (float)0.3731763325901154 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    yb[13] = (float)-0.4570457994644658 * x * (4.0f * zz - xx - yy);
    yb[14] = (float)1.445305721320277 * z * (xx - yy);
    yb[15] = (float)-0.5900435899266435 * x * (xx - 3.0f * yy);
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// the bf16 tent weight of grid line k for coordinate c: 1 - |c - k|, clipped
__device__ __forceinline__ float tent(float c, float k) {
  return bf16r(fmaxf(0.0f, 1.0f - fabsf(c - k)));
}

// The vertex stack [nvert, nu, nv, C] bf16 (C / 8 uint4 per record).
struct VertexStack {
  const uint4* vert;
  int nvert, nu, nv, C, P;
};

// The texel (pf, qf)'s norm and SH basis: read from the materialized
// operands ybasis [NCOEFF, Pn, Qn] and norm [Pn, Qn] (pix = p * Qn + q,
// plane = Pn * Qn), or built from the 4 frame scalars fs = (x0, dx, y0, dy)
// and the axes of the march.
template <int NCOEFF, bool OPERANDS>
__device__ __forceinline__ float texel_basis(const float* ybasis,
                                             const float* norm, const float* fs,
                                             size_t pix, size_t plane, float pf,
                                             float qf, int u_ax, int v_ax,
                                             float g, float* yb) {
  if constexpr (OPERANDS) {
#pragma unroll
    for (int k = 0; k < NCOEFF; ++k) yb[k] = ybasis[k * plane + pix];
    return norm[pix];
  } else {
    (void)ybasis;
    (void)norm;
    const float xs = fs[0] + pf * fs[1];
    const float ys = fs[2] + qf * fs[3];
    const float nm = sqrtf(1.0f + xs * xs + ys * ys);
    const float cu = xs / nm, cv = ys / nm, ca = g / nm;
    const float dx = u_ax == 0 ? cu : (v_ax == 0 ? cv : ca);
    const float dy = u_ax == 1 ? cu : (v_ax == 1 ? cv : ca);
    const float dz = u_ax == 2 ? cu : (v_ax == 2 ? cv : ca);
    sh_basis<NCOEFF>(dx, dy, dz, yb);
    return nm;
  }
}

// Values of position j at texel (pf, qf), G = the position's geometry row:
// sigma, the SH-folded colour, the band-0 (diffuse) colour and the texel's
// liveness. The position's slice is vertex slice j / P, lerped in f32 with
// the next one for interior positions and rounded to bf16; the u-resample
// rounds to bf16 (two taps: the reference's bf16 matmul exactly, the products
// are exact in f32 and the single sum rounds once); the v-resample sums in
// f32; taps outside the grid weigh zero.
template <int NCOEFF>
__device__ __forceinline__ void position_values(const VertexStack& s,
                                                const float* G, int j, float pf,
                                                float qf, const float* yb,
                                                float& sig, float* rgb,
                                                float* dif, float& live) {
  constexpr int USED = 3 * NCOEFF + 1;
  constexpr int NG = (USED + 7) / 8;  // uint4 groups of 8 channels read
  const float s_j = G[0];
  const float U = G[2] + G[3] * pf;
  const float V = G[4] + G[5] * qf;
  const float nu_hi = (float)s.nu - 0.5f, nv_hi = (float)s.nv - 0.5f;
  live = (U >= -0.5f && U <= nu_hi && s_j > 0.0f && V >= -0.5f && V <= nv_hi)
             ? 1.0f
             : 0.0f;

  const float u0f = floorf(U), v0f = floorf(V);
  float wu[2], wv[2];
  bool oku[2], okv[2];
  int iu[2], iv[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float uf = u0f + (float)t, vf = v0f + (float)t;
    wu[t] = tent(U, uf);
    wv[t] = tent(V, vf);
    oku[t] = uf >= 0.0f && uf <= (float)(s.nu - 1);
    okv[t] = vf >= 0.0f && vf <= (float)(s.nv - 1);
    iu[t] = oku[t] ? (int)uf : 0;
    iv[t] = okv[t] ? (int)vf : 0;
  }
  const float inv_p = (float)(1.0 / s.P);
  const int jd = j / s.P;
  const int ia = min(jd, s.nvert - 1), ib = min(jd + 1, s.nvert - 1);
  const float fb = (float)(j - jd * s.P) * inv_p;
  const float fa = 1.0f - fb;
  const bool mix = s.P > 1 && fb != 0.0f;  // fb == 0 lerps to vertex a
  const int recs_per_row = s.nv * (s.C / 8);  // uint4 per (vertex, u)

  sig = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = dif[c] = 0.0f;
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
    float t1[2][8];
#pragma unroll
    for (int tv = 0; tv < 2; ++tv) {
      float a8[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a8[i] = 0.0f;
      if (okv[tv]) {
#pragma unroll
        for (int tu = 0; tu < 2; ++tu) {
          if (!oku[tu]) continue;
          const size_t rec = (size_t)iu[tu] * recs_per_row +
                             (size_t)iv[tv] * (s.C / 8) + grp;
          float sa[8];
          unpack8(s.vert[(size_t)ia * s.nu * recs_per_row + rec], sa);
          if (mix) {
            float sb[8];
            unpack8(s.vert[(size_t)ib * s.nu * recs_per_row + rec], sb);
#pragma unroll
            for (int i = 0; i < 8; ++i) sa[i] = bf16r(fa * sa[i] + fb * sb[i]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) a8[i] = a8[i] + wu[tu] * sa[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) t1[tv][i] = bf16r(a8[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = grp * 8 + i;
      if (c >= USED) break;
      const float val = 0.0f + wv[0] * t1[0][i] + wv[1] * t1[1][i];
      if (c == 3 * NCOEFF) {
        sig = val;
      } else {
        const int colour = c / NCOEFF, k = c % NCOEFF;
        if (k == 0) {
          rgb[colour] = yb[0] * val;
          dif[colour] = yb[0] * val;
        } else {
          rgb[colour] = rgb[colour] + yb[k] * val;
        }
      }
    }
  }
}

}  // namespace gnomonic
