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
// The per-position gather, tents and SH fold, and the march itself, live in
// gnomonic_march.cuh, shared with the replay backward. Built with -fmad=false: each f32
// operation rounds as in the plain PyTorch version.
#include <cuda_runtime.h>

#include "gnomonic_march.cuh"

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
  const int q = blockIdx.x * TQ + threadIdx.x;
  const int p = blockIdx.y * TP + threadIdx.y;
  const int pb = (blockIdx.y * TP) / prm.Pb;
  const int qb = (blockIdx.x * TQ) / prm.Qb;
  const int tid = threadIdx.y * TQ + threadIdx.x;
  const size_t flag_base = ((size_t)pb * prm.QB + qb) * prm.NP;
  const MarchTables tb = load_tables(smem, prm.geom, prm.cell_live, prm.pos_needed,
                                     nullptr, flag_base, prm.NP, tid, TP * TQ);

  const float pf = (float)p, qf = (float)q;
  const size_t plane = (size_t)prm.Pn * prm.Qn;
  const size_t pix = (size_t)p * prm.Qn + q;
  // texel direction -> norm and SH basis (reference: built at j == 0)
  float yb[NCOEFF];
  const float nm = texel_basis<NCOEFF, OPERANDS>(
      prm.ybasis, prm.norm, prm.fs, pix, plane, pf, qf, prm.u_ax, prm.v_ax,
      prm.g, yb);
  const VertexSource<NCOEFF> src{
      VertexStack{prm.vert, prm.nvert, prm.nu, prm.nv, prm.C, prm.P}, pf, qf, yb};
  march_forward<DIFFUSE, RELU>(src, tb, prm.NP, prm.exit_eps, nm, prm.out + pix, plane);
}

template <int NCOEFF, bool DIFFUSE, bool RELU, bool OPERANDS>
int launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = march_tables_bytes(prm.NP, false);
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
