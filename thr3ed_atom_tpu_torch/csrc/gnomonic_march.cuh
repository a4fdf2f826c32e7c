// gnomonic_march: the per-texel march code shared by the gnomonic composites
// and their replay backwards: the fused pair (composite_fused.cu, K1;
// composite_backward_fused.cu, K3) and the stripe pair (composite_stripe.cu,
// K5; composite_stripe_backward.cu, K7). A backward replays its forward bit for
// bit. The cell arithmetic (composite_cell, backward_cell, flush_channel) is
// shared by all four; position_values gathers a position's values at a texel
// from the vertex stack (the fused pair's direct gather; their staged source
// in gnomonic_stage.cuh rounds the same way), and the stripe pair marches
// with march_forward / march_backward over StripeSource (gnomonic_stripe.cuh),
// which reads the u-resampled stack t1 and the v-tents. Built with
// -fmad=false by every library that includes it.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "relu_trap.cuh"

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

// Channel c of a position's resampled values into sigma (c == 3 NCOEFF) or
// the SH fold of its colour (channels colour * NCOEFF + k, k ascending: the
// reference's order); band 0 is also the diffuse colour.
template <int NCOEFF>
__device__ __forceinline__ void fold_channel(int c, float val, const float* yb,
                                             float& sig, float* rgb, float* dif) {
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
      fold_channel<NCOEFF>(c, 0.0f + wv[0] * t1[0][i] + wv[1] * t1[1][i], yb, sig,
                           rgb, dif);
    }
  }
}

// The march's per-block tables in shared memory: geometry rows [NP,
// GEOM_COLS] and the tile's occupancy flags [NP] (and dvals slots [NP] for a
// backward), loaded once by every thread of the block.
struct MarchTables {
  const float* geom;
  const int* cell_live;
  const int* pos_needed;
  const int* slot;
};

__device__ __forceinline__ MarchTables load_tables(void* smem, const float* geom,
                                                   const int* cell_live,
                                                   const int* pos_needed,
                                                   const int* slot, size_t flag_base,
                                                   int NP, int tid, int nthreads) {
  float* s_geom = reinterpret_cast<float*>(smem);  // [NP, GEOM_COLS]
  int* s_cl = reinterpret_cast<int*>(s_geom + NP * GEOM_COLS);
  int* s_pn = s_cl + NP;
  int* s_slot = s_pn + NP;
  for (int i = tid; i < NP; i += nthreads) {
#pragma unroll
    for (int k = 0; k < GEOM_COLS; ++k) s_geom[i * GEOM_COLS + k] = geom[(size_t)i * 8 + k];
    s_cl[i] = cell_live[flag_base + i];
    s_pn[i] = pos_needed[flag_base + i];
    if (slot != nullptr) s_slot[i] = slot[flag_base + i];
  }
  __syncthreads();
  return MarchTables{s_geom, s_cl, s_pn, slot != nullptr ? s_slot : nullptr};
}

__host__ __device__ inline size_t march_tables_bytes(int NP, bool with_slot) {
  return (size_t)NP * (GEOM_COLS * sizeof(float) + (with_slot ? 3 : 2) * sizeof(int));
}

// A position's values at one texel: sigma, liveness, the SH-folded colour
// and the band-0 (diffuse) colour.
struct PosValues {
  float sig, live, rgb[3], dif[3];
};

// The forward composite state of one texel.
struct CompositeState {
  float T, acc, dep, col[3], dif[3];
};

// The relu-trapezoid composite of cell (a, b), b being position G's values:
// accumulates into st (the march's arithmetic, each f32 operation in order).
template <bool DIFFUSE, bool RELU>
__device__ __forceinline__ void composite_cell(const float* G, float nm, const PosValues& a,
                                               const PosValues& b, CompositeState& st) {
  const float s_j = G[0], cell_step = G[1];
  float integ, tbar, dIda, dIdb;
  relu_trap<RELU>(a.sig, b.sig, integ, tbar, dIda, dIdb);
  integ = integ * (a.live * b.live);
  const float delta = cell_step * nm;
  const float alpha = 1.0f - expf(-integ * delta);
  const float w = alpha * st.T;
  const float s_mid = (s_j - cell_step + tbar * cell_step) * nm;
  const float tb1 = 1.0f - tbar;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    st.col[c] = st.col[c] + sigmoid(tb1 * a.rgb[c] + tbar * b.rgb[c]) * w;
  st.acc = st.acc + w;
  st.dep = st.dep + w * s_mid;
  if constexpr (DIFFUSE) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      st.dif[c] = st.dif[c] + sigmoid(tb1 * a.dif[c] + tbar * b.dif[c]) * w;
  }
  st.T = st.T * (1.0f - alpha);
}

// Writes the state rows [T, colour x3, acc, depth (, diffuse x3)] at
// out[row * plane].
template <bool DIFFUSE>
__device__ __forceinline__ void store_state(const CompositeState& st, float* out,
                                            size_t plane) {
  out[0] = st.T;
  out[plane] = st.col[0];
  out[2 * plane] = st.col[1];
  out[3 * plane] = st.col[2];
  out[4 * plane] = st.acc;
  out[5 * plane] = st.dep;
  if constexpr (DIFFUSE) {
    out[6 * plane] = st.dif[0];
    out[7 * plane] = st.dif[1];
    out[8 * plane] = st.dif[2];
  }
}

// The forward march of one texel over positions j = 0 .. NP-1 (front to
// back): the relu-trapezoid composite of cell (j-1, j) for every needed
// position, gated by the tile's flags (uniform over the tile, so the
// early exit's block vote is reached by every thread). Writes the state rows
// [T, colour x3, acc, depth (, diffuse x3)] at out[row * plane].
template <bool DIFFUSE, bool RELU, class Source>
__device__ __forceinline__ void march_forward(const Source& src, const MarchTables& tb,
                                              int NP, float exit_eps, float nm,
                                              float* out, size_t plane) {
  CompositeState st{1.0f, 0.0f, 0.0f, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  PosValues prev{};

  for (int j = 0; j < NP; ++j) {
    if (!tb.pos_needed[j]) continue;  // uniform over the tile
    if (exit_eps > 0.0f && !__syncthreads_or(st.T > exit_eps)) break;
    const float* G = tb.geom + j * GEOM_COLS;
    PosValues cur;
    src.values(j, G, cur.sig, cur.rgb, cur.dif, cur.live);
    if (j > 0 && tb.cell_live[j]) composite_cell<DIFFUSE, RELU>(G, nm, prev, cur, st);
    prev = cur;
  }
  store_state<DIFFUSE>(st, out, plane);
}

// The state cotangent of one texel, read from its gaux rows [SROWS + 2]
// (stride plane): gT, colour, acc, depth (, diffuse), S_total, T_final.
struct StateCotangent {
  float T, acc, dep, col[3], dif[3], S_total, T_fin;
};

template <bool DIFFUSE>
__device__ __forceinline__ StateCotangent load_cotangent(const float* ga, size_t plane) {
  constexpr int SROWS = DIFFUSE ? 9 : 6;
  StateCotangent g;
  g.T = ga[0];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g.col[c] = ga[(1 + c) * plane];
    g.dif[c] = DIFFUSE ? ga[(6 + c) * plane] : 0.0f;
  }
  g.acc = ga[4 * plane];
  g.dep = ga[5 * plane];
  g.S_total = ga[SROWS * plane];
  g.T_fin = ga[(SROWS + 1) * plane];
  return g;
}

// Cotangents of a position's raw values: sigma, colour, diffuse.
struct PosCotangent {
  float sig, rgb[3], dif[3];
};

// The replay VJP of cell (a, b) (b being position G's values) in the
// reference's division-free suffix form
//   dinteg = delta * ((1 - alpha) * T * inner - suffix),
//   suffix = (S_total - S_prefix) + gT * T_final,
// routed to the cell's two endpoints with dI/da, dI/db of the relu
// trapezoid; colour cotangents lerp back with (1 - tbar, tbar), the emission
// centroid tbar held constant (the reference's convention). Returns the
// a-side and b-side cotangents and advances T and the running prefix S.
template <bool DIFFUSE, bool RELU>
__device__ __forceinline__ void backward_cell(const float* G, float nm,
                                              const StateCotangent& g, const PosValues& a,
                                              const PosValues& b, float& T, float& S,
                                              PosCotangent& da, PosCotangent& db) {
  const float s_j = G[0], cell_step = G[1];
  float integ_raw, tbar, dIda, dIdb;
  relu_trap<RELU>(a.sig, b.sig, integ_raw, tbar, dIda, dIdb);
  const float live_pair = a.live * b.live;
  const float integ = integ_raw * live_pair;
  const float delta = cell_step * nm;
  const float e = expf(-integ * delta);
  const float alpha = 1.0f - e;
  const float w = alpha * T;
  const float s_mid = (s_j - cell_step + tbar * cell_step) * nm;
  const float tb1 = 1.0f - tbar;
  float mids[3], dmids[3];
  float inner = g.acc + g.dep * s_mid;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mids[c] = sigmoid(tb1 * a.rgb[c] + tbar * b.rgb[c]);
    inner = inner + g.col[c] * mids[c];
  }
  if constexpr (DIFFUSE) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dmids[c] = sigmoid(tb1 * a.dif[c] + tbar * b.dif[c]);
      inner = inner + g.dif[c] * dmids[c];
    }
  }
  const float S_prefix = S + inner * w;
  const float suffix = (g.S_total - S_prefix) + g.T * g.T_fin;
  const float dinteg = delta * (e * T * inner - suffix) * live_pair;
  da.sig = dinteg * dIda;
  db.sig = dinteg * dIdb;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float dm = g.col[c] * w * mids[c] * (1.0f - mids[c]);
    da.rgb[c] = tb1 * dm;
    db.rgb[c] = tbar * dm;
    if constexpr (DIFFUSE) {
      const float ddm = g.dif[c] * w * dmids[c] * (1.0f - dmids[c]);
      da.dif[c] = tb1 * ddm;
      db.dif[c] = tbar * ddm;
    }
  }
  T = T * (1.0f - alpha);
  S = S_prefix;
}

// Channel ch of a position's cotangent (its pending b-side plus the next
// cell's a-side, summed into d) folded through the SH basis, before the bf16
// rounding: colour channels colour * NCOEFF + k, then sigma.
template <int NCOEFF, bool DIFFUSE>
__device__ __forceinline__ float flush_channel(int ch, const float* yb, const PosCotangent& d) {
  if (ch < 3 * NCOEFF) {
    const int c = ch / NCOEFF, k = ch % NCOEFF;
    float v = yb[k] * d.rgb[c];
    if (DIFFUSE && k == 0) v = v + yb[0] * d.dif[c];
    return v;
  }
  return d.sig;
}

// The replay VJP march of one texel, steps j = 0 .. NP: step j replays
// position j exactly as march_forward computed it, rebuilds T and the running
// prefix S and takes cell (j-1, j)'s VJP (backward_cell). Position j-1's
// cotangent is its pending b-side plus cell j's a-side; its per-channel dvals
// (flush_channel) round to bf16, as the reference rounds them before the
// v-fold, and go to the compact buffer: slot tb.slot[j-1] of
// [n_slots, USED, Pb, Qb], element in_blk of each [Pb, Qb] channel plane.
// Masks are branches, so a stale value of a dead position never enters a sum.
// ``ga`` points at this texel's gaux [SROWS + 2] rows (stride ``plane``).
template <int NCOEFF, bool DIFFUSE, bool RELU, class Source>
__device__ __forceinline__ void march_backward(const Source& src, const MarchTables& tb,
                                               int NP, float nm, const float* yb,
                                               const float* ga, size_t plane,
                                               __nv_bfloat16* dvals, size_t blk,
                                               size_t in_blk) {
  constexpr int USED = 3 * NCOEFF + 1;
  const StateCotangent g = load_cotangent<DIFFUSE>(ga, plane);
  float T = 1.0f, S = 0.0f;
  PosValues prev{};
  PosCotangent pend{};  // the b-side cotangents of the last cell

  // NP + 1 steps: step j composites cell (j-1, j) and flushes position j-1
  for (int j = 0; j <= NP; ++j) {
    const bool replay = j < NP && tb.pos_needed[j];
    const bool flush = j > 0 && tb.pos_needed[j - 1];
    if (!replay && !flush) {  // uniform over the tile
      pend = PosCotangent{};
      continue;
    }
    PosValues cur{};
    const float* G = tb.geom + (j < NP ? j : NP - 1) * GEOM_COLS;
    if (replay) src.values(j, G, cur.sig, cur.rgb, cur.dif, cur.live);

    // cell (j-1, j): its a-side cotangents for position j-1 and its b-side
    // ones, pending for position j
    PosCotangent da{}, db{};
    if (replay && j > 0 && tb.cell_live[j])
      backward_cell<DIFFUSE, RELU>(G, nm, g, prev, cur, T, S, da, db);

    if (flush) {
      PosCotangent d;
      d.sig = pend.sig + da.sig;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d.rgb[c] = pend.rgb[c] + da.rgb[c];
        d.dif[c] = pend.dif[c] + da.dif[c];
      }
      __nv_bfloat16* out = dvals + (size_t)tb.slot[j - 1] * USED * blk + in_blk;
#pragma unroll
      for (int ch = 0; ch < USED; ++ch)
        out[ch * blk] = __float2bfloat16_rn(flush_channel<NCOEFF, DIFFUSE>(ch, yb, d));
    }
    pend = db;
    if (replay) prev = cur;
  }
}

}  // namespace gnomonic
