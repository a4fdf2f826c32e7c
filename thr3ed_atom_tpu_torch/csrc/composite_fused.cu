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
//     scalars, the serving path) or read from the materialized ybasis and
//     norm operands (OPERANDS, the training path: its replay backward,
//     composite_backward_fused.cu, folds against the same operands), and the
//     relu-trapezoid composite of cell (j-1, j).
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
// The per-position gather, tents and SH fold live in gnomonic_march.cuh,
// shared with the replay backward. Built with -fmad=false: each f32
// operation rounds as in the plain PyTorch version.
#include <cuda_runtime.h>

#include "gnomonic_march.cuh"
#include "relu_trap.cuh"

namespace {

using namespace gnomonic;

struct Params {
  const uint4* vert;  // [nvert, nu, nv, C] bf16, C / 8 uint4 per record
  const float* geom;  // [NP, 8]
  const int* cell_live;   // [PB, QB, NP]
  const int* pos_needed;  // [PB, QB, NP]
  const float* fs;        // [8]: x0, dx, y0, dy (serving)
  const float* ybasis;    // [ncoeff, Pn, Qn] (OPERANDS)
  const float* norm;      // [Pn, Qn] (OPERANDS)
  float* out;             // [SROWS, Pn, Qn]
  int NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb, QB;
  int u_ax, v_ax, axis;
  float g, exit_eps;
};

template <int NCOEFF, bool DIFFUSE, bool RELU, bool OPERANDS>
__global__ void __launch_bounds__(TP * TQ) composite_fused_kernel(Params prm) {
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
  const size_t plane = (size_t)prm.Pn * prm.Qn;
  const size_t pix = (size_t)p * prm.Qn + q;
  // texel direction -> norm and SH basis (reference: built at j == 0)
  float yb[NCOEFF];
  const float nm = texel_basis<NCOEFF, OPERANDS>(
      prm.ybasis, prm.norm, prm.fs, pix, plane, pf, qf, prm.u_ax, prm.v_ax,
      prm.g, yb);
  const VertexStack vs{prm.vert, prm.nvert, prm.nu, prm.nv, prm.C, prm.P};

  float T = 1.0f, acc = 0.0f, dep = 0.0f;
  float col[3] = {0.0f, 0.0f, 0.0f}, dif[3] = {0.0f, 0.0f, 0.0f};
  float prev_sig = 0.0f, prev_live = 0.0f;
  float prev_rgb[3] = {0.0f, 0.0f, 0.0f}, prev_dif[3] = {0.0f, 0.0f, 0.0f};

  for (int j = 0; j < prm.NP; ++j) {
    if (!s_pn[j]) continue;  // uniform over the tile
    if (prm.exit_eps > 0.0f && !__syncthreads_or(T > prm.exit_eps)) break;
    const float* G = s_geom + j * GEOM_COLS;
    const float s_j = G[0], cell_step = G[1];
    float sig, rgb[3], dif_j[3], live;
    position_values<NCOEFF>(vs, G, j, pf, qf, yb, sig, rgb, dif_j, live);

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

  float* o = prm.out + pix;
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

template <int NCOEFF, bool DIFFUSE, bool RELU, bool OPERANDS>
int launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = (size_t)prm.NP * (GEOM_COLS * sizeof(float) + 2 * sizeof(int));
  auto kern = composite_fused_kernel<NCOEFF, DIFFUSE, RELU, OPERANDS>;
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

template <int NCOEFF, bool OPERANDS>
int dispatch(const Params& prm, int with_diffuse, int relu, cudaStream_t s) {
  if (with_diffuse)
    return relu ? launch<NCOEFF, true, true, OPERANDS>(prm, s)
                : launch<NCOEFF, true, false, OPERANDS>(prm, s);
  return relu ? launch<NCOEFF, false, true, OPERANDS>(prm, s)
              : launch<NCOEFF, false, false, OPERANDS>(prm, s);
}

template <bool OPERANDS>
int dispatch_ncoeff(const Params& prm, int ncoeff, int with_diffuse, int relu,
                    cudaStream_t s) {
  switch (ncoeff) {
    case 1: return dispatch<1, OPERANDS>(prm, with_diffuse, relu, s);
    case 4: return dispatch<4, OPERANDS>(prm, with_diffuse, relu, s);
    case 9: return dispatch<9, OPERANDS>(prm, with_diffuse, relu, s);
    case 16: return dispatch<16, OPERANDS>(prm, with_diffuse, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fs (4 frame scalars) drives the serving branch; with fs == NULL the basis
// and norm come from ybasis / norm (the training branch).
extern "C" int composite_fused_launch(
    const void* vert, const float* geom, const int* cell_live,
    const int* pos_needed, const float* fs, const float* ybasis,
    const float* norm, float* out, int ncoeff, int with_diffuse, int relu,
    int NP, int P, int nvert, int nu, int nv, int C, int Pn, int Qn, int Pb,
    int Qb, int PB, int QB, int u_ax, int v_ax, int axis, float g,
    float exit_eps, void* stream) {
  (void)PB;
  Params prm{reinterpret_cast<const uint4*>(vert), geom, cell_live, pos_needed,
             fs, ybasis, norm, out, NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb,
             QB, u_ax, v_ax, axis, g, exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (fs != nullptr) return dispatch_ncoeff<false>(prm, ncoeff, with_diffuse, relu, s);
  if (ybasis == nullptr || norm == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_ncoeff<true>(prm, ncoeff, with_diffuse, relu, s);
}
