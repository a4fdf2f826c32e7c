// composite_fused: the gnomonic renderer's fused march (resample + SH +
// relu-trapezoid front-to-back composite) over all positions of one pose.
//
// Replaces the TPU kernel thr3ed_atom_tpu/rendering/gnomonic.py
// composite_positions_fused (kernel _make_composite_kernel_fused, v3 with the
// in-kernel SH basis). That kernel runs positions outermost and keeps the
// whole frame's march state in VMEM. Here one thread owns one texel (p, q) and
// marches positions j = 0 .. NP-1 in an inner loop with its state in
// registers: T, colour, acc, depth (, diffuse) and the previous position's
// sigma, raw colour (, raw diffuse) and liveness.
//
// What it computes per texel and needed position j (bit-compatible with the
// reference's roundings):
//   * the position's slice: vertex slice j/P, lerped with the next one for
//     interior positions in f32 and rounded to bf16;
//   * u-resample: t1(v) = bf16(w_u0 s(u0, v) + w_u1 s(u0 + 1, v)) with the
//     bf16 tent weights of U = bu + ku p (the tent has two taps, so this is
//     the reference's [Pb, nu] x [nu, C nv] bf16 matmul exactly: the products
//     are exact in f32 and the single sum rounds once);
//   * v-resample: val = w_v0 t1(v0) + w_v1 t1(v0 + 1) in f32, likewise exact;
//   * the SH fold with the basis built from the texel direction (4 frame
//     scalars), and the relu-trapezoid composite of cell (j-1, j).
// Occupancy flags of the 128 x Qb block that holds the tile gate the work
// (lossless); with exit_eps > 0 the tile stops once every texel's
// transmittance is <= exit_eps (a finer grain than the TPU's 128 x 128 block;
// the difference is bounded by exit_eps per texel).
//
// Bound on the H100: by its inputs it is memory-bound (the vertex stack,
// 134 MB at 128^3 with 32 bf16 channels, read once, is ~40 us at 3.35 TB/s),
// but this simple version re-gathers every texel's 2 x 2 (x 2 vertices) taps
// of 16-byte channel records from L1/L2, so the gathers and their latency
// set its time. Design: channel-last vertex records ([nvert, nu, nv, C], one
// uint4 per 8 channels) so a tap is a few 16-byte loads and neighbouring
// texels along q read neighbouring records; occupancy flags and the per-
// position geometry sit in shared memory; a texel tile of TP x TQ threads
// lies inside one flag block, so every branch on flags is uniform. Sharing the
// u-resample of a tile through shared memory is left to a later version.
// Built with -fmad=false: each f32 operation rounds as in the plain PyTorch
// version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "relu_trap.cuh"

namespace {

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

struct Params {
  const uint4* vert;  // [nvert, nu, nv, C] bf16, C / 8 uint4 per record
  const float* geom;  // [NP, 8]
  const int* cell_live;   // [PB, QB, NP]
  const int* pos_needed;  // [PB, QB, NP]
  const float* fs;        // [8]: x0, dx, y0, dy
  float* out;             // [SROWS, Pn, Qn]
  int NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb, QB;
  int u_ax, v_ax, axis;
  float g, exit_eps;
};

template <int NCOEFF, bool DIFFUSE, bool RELU>
__global__ void __launch_bounds__(TP * TQ) composite_fused_kernel(Params prm) {
  constexpr int USED = 3 * NCOEFF + 1;
  constexpr int NG = (USED + 7) / 8;  // uint4 groups of 8 channels read
  extern __shared__ float smem[];
  float* s_geom = smem;  // [NP, GEOM_COLS]
  int* s_cl = reinterpret_cast<int*>(s_geom + prm.NP * GEOM_COLS);
  int* s_pn = s_cl + prm.NP;

  const int q = blockIdx.x * TQ + threadIdx.x;
  const int p = blockIdx.y * TP + threadIdx.y;
  const int pb = (blockIdx.y * TP) / prm.Pb;
  const int qb = (blockIdx.x * TQ) / prm.Qb;
  const int tid = threadIdx.y * TQ + threadIdx.x;
  const size_t flag_base = ((size_t)pb * prm.QB + qb) * prm.NP;
  for (int i = tid; i < prm.NP; i += TP * TQ) {
#pragma unroll
    for (int k = 0; k < GEOM_COLS; ++k)
      s_geom[i * GEOM_COLS + k] = prm.geom[(size_t)i * 8 + k];
    s_cl[i] = prm.cell_live[flag_base + i];
    s_pn[i] = prm.pos_needed[flag_base + i];
  }
  __syncthreads();

  const float pf = (float)p, qf = (float)q;
  // texel direction -> norm and SH basis (reference: built at j == 0)
  const float xs = prm.fs[0] + pf * prm.fs[1];
  const float ys = prm.fs[2] + qf * prm.fs[3];
  const float nm = sqrtf(1.0f + xs * xs + ys * ys);
  const float cu = xs / nm, cv = ys / nm, ca = prm.g / nm;
  const float dx = prm.u_ax == 0 ? cu : (prm.v_ax == 0 ? cv : ca);
  const float dy = prm.u_ax == 1 ? cu : (prm.v_ax == 1 ? cv : ca);
  const float dz = prm.u_ax == 2 ? cu : (prm.v_ax == 2 ? cv : ca);
  float yb[NCOEFF];
  sh_basis<NCOEFF>(dx, dy, dz, yb);

  float T = 1.0f, acc = 0.0f, dep = 0.0f;
  float col[3] = {0.0f, 0.0f, 0.0f}, dif[3] = {0.0f, 0.0f, 0.0f};
  float prev_sig = 0.0f, prev_live = 0.0f;
  float prev_rgb[3] = {0.0f, 0.0f, 0.0f}, prev_dif[3] = {0.0f, 0.0f, 0.0f};
  const float nu_hi = (float)prm.nu - 0.5f, nv_hi = (float)prm.nv - 0.5f;
  const float inv_p = (float)(1.0 / prm.P);
  const int recs_per_row = prm.nv * (prm.C / 8);  // uint4 per (vertex, u)

  for (int j = 0; j < prm.NP; ++j) {
    if (!s_pn[j]) continue;  // uniform over the tile
    if (prm.exit_eps > 0.0f && !__syncthreads_or(T > prm.exit_eps)) break;
    const float* G = s_geom + j * GEOM_COLS;
    const float s_j = G[0], cell_step = G[1];
    const float U = G[2] + G[3] * pf;
    const float V = G[4] + G[5] * qf;
    const float live = (U >= -0.5f && U <= nu_hi && s_j > 0.0f &&
                        V >= -0.5f && V <= nv_hi) ? 1.0f : 0.0f;

    // the two taps of each tent; out-of-range taps weigh zero
    const float u0f = floorf(U), v0f = floorf(V);
    float wu[2], wv[2];
    bool oku[2], okv[2];
    int iu[2], iv[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float uf = u0f + (float)t, vf = v0f + (float)t;
      wu[t] = bf16r(fmaxf(0.0f, 1.0f - fabsf(U - uf)));
      wv[t] = bf16r(fmaxf(0.0f, 1.0f - fabsf(V - vf)));
      oku[t] = uf >= 0.0f && uf <= (float)(prm.nu - 1);
      okv[t] = vf >= 0.0f && vf <= (float)(prm.nv - 1);
      iu[t] = oku[t] ? (int)uf : 0;
      iv[t] = okv[t] ? (int)vf : 0;
    }
    const int jd = j / prm.P;
    const int ia = min(jd, prm.nvert - 1), ib = min(jd + 1, prm.nvert - 1);
    const float fb = (float)(j - jd * prm.P) * inv_p;
    const float fa = 1.0f - fb;
    const bool mix = prm.P > 1 && fb != 0.0f;  // fb == 0 lerps to vertex a

    float sig = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f}, dif_j[3] = {0.0f, 0.0f, 0.0f};
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
                               (size_t)iv[tv] * (prm.C / 8) + grp;
            float sa[8];
            unpack8(prm.vert[(size_t)ia * prm.nu * recs_per_row + rec], sa);
            if (mix) {
              float sb[8];
              unpack8(prm.vert[(size_t)ib * prm.nu * recs_per_row + rec], sb);
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
            dif_j[colour] = yb[0] * val;
          } else {
            rgb[colour] = rgb[colour] + yb[k] * val;
          }
        }
      }
    }

    if (j > 0 && s_cl[j]) {
      float integ, tbar, dIda, dIdb;
      relu_trap<RELU>(prev_sig, sig, integ, tbar, dIda, dIdb);
      integ = integ * (prev_live * live);
      const float delta = cell_step * nm;
      const float alpha = 1.0f - expf(-integ * delta);
      const float w = alpha * T;
      const float s_mid = (s_j - cell_step + tbar * cell_step) * nm;
      const float tb1 = 1.0f - tbar;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        col[c] = col[c] + sigmoid(tb1 * prev_rgb[c] + tbar * rgb[c]) * w;
      acc = acc + w;
      dep = dep + w * s_mid;
      if constexpr (DIFFUSE) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          dif[c] = dif[c] + sigmoid(tb1 * prev_dif[c] + tbar * dif_j[c]) * w;
      }
      T = T * (1.0f - alpha);
    }
    prev_sig = sig;
    prev_live = live;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      prev_rgb[c] = rgb[c];
      prev_dif[c] = dif_j[c];
    }
  }

  const size_t plane = (size_t)prm.Pn * prm.Qn;
  float* o = prm.out + (size_t)p * prm.Qn + q;
  o[0] = T;
  o[plane] = col[0];
  o[2 * plane] = col[1];
  o[3 * plane] = col[2];
  o[4 * plane] = acc;
  o[5 * plane] = dep;
  if constexpr (DIFFUSE) {
    o[6 * plane] = dif[0];
    o[7 * plane] = dif[1];
    o[8 * plane] = dif[2];
  }
}

template <int NCOEFF, bool DIFFUSE, bool RELU>
int launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = (size_t)prm.NP * (GEOM_COLS * sizeof(float) + 2 * sizeof(int));
  auto kern = composite_fused_kernel<NCOEFF, DIFFUSE, RELU>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(TQ, TP);
  const dim3 grid(prm.Qn / TQ, prm.Pn / TP);
  kern<<<grid, block, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <int NCOEFF>
int dispatch(const Params& prm, int with_diffuse, int relu, cudaStream_t s) {
  if (with_diffuse)
    return relu ? launch<NCOEFF, true, true>(prm, s) : launch<NCOEFF, true, false>(prm, s);
  return relu ? launch<NCOEFF, false, true>(prm, s) : launch<NCOEFF, false, false>(prm, s);
}

}  // namespace

extern "C" int composite_fused_launch(
    const void* vert, const float* geom, const int* cell_live,
    const int* pos_needed, const float* fs, float* out, int ncoeff,
    int with_diffuse, int relu, int NP, int P, int nvert, int nu, int nv, int C,
    int Pn, int Qn, int Pb, int Qb, int PB, int QB, int u_ax, int v_ax,
    int axis, float g, float exit_eps, void* stream) {
  (void)PB;
  Params prm{reinterpret_cast<const uint4*>(vert), geom, cell_live, pos_needed,
             fs, out, NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb, QB,
             u_ax, v_ax, axis, g, exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncoeff) {
    case 1: return dispatch<1>(prm, with_diffuse, relu, s);
    case 4: return dispatch<4>(prm, with_diffuse, relu, s);
    case 9: return dispatch<9>(prm, with_diffuse, relu, s);
    case 16: return dispatch<16>(prm, with_diffuse, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
