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
// 134 MB at 128^3 with 32 bf16 channels, read once, is ~40 us at 3.35 TB/s).
// A texel gathering its own 2 x 2 (x 2 vertices) taps reloads each record
// ~16-64 times per tile and repeats each u-resample ~8 times, with the loads
// of one position dependent on each other. So a TP x TQ tile stages each
// needed position's footprint once (gnomonic_stage.cuh): cp.async copies into
// a two-stage ring, one position ahead of the composite; the lerp and the
// u-resample once per record and per (row, v line, channel) in shared memory;
// each texel then reads two t1 taps per channel. A footprint over the stage
// budget takes the direct gather inside the same march (counted in
// direct_tiles when that pointer is given); the stage takes what the
// position tables leave of the SM's shared memory (Stage::fit), so a long
// march keeps running with a smaller stage, or none. Occupancy flags and the per-
// position geometry sit in shared memory; a tile lies inside one flag block,
// so every branch on flags is uniform and every barrier is reached by all
// threads. Built with -fmad=false: each f32 operation rounds as in the plain
// PyTorch version.
#include <cuda_runtime.h>

#include "gnomonic_stage.cuh"

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
  int* direct_tiles;      // tiles that took the direct gather (or NULL)
  int NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb, QB;
  int u_ax, v_ax, axis;
  StageSize stage;  // set at launch (Stage::fit)
  float g, exit_eps;
};

template <int NCOEFF, bool DIFFUSE, bool RELU, bool OPERANDS>
__global__ void __launch_bounds__(TP * TQ) composite_fused_kernel(Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p0 = blockIdx.y * TP, q0 = blockIdx.x * TQ;
  const int p = p0 + threadIdx.y, q = q0 + threadIdx.x;
  const int pb = p0 / prm.Pb;
  const int qb = q0 / prm.Qb;
  const int tid = threadIdx.y * TQ + threadIdx.x;
  const size_t flag_base = ((size_t)pb * prm.QB + qb) * prm.NP;
  // the serving branch's frames exit early and leave a few tiles marching
  // long chains of positions: a large stage holds more of them at one block
  // an SM; the training branch marches every tile of the view: a small
  // stage, two blocks an SM
  using S = Stage<NCOEFF, !OPERANDS>;
  const S sm(smem, prm.stage);
  const MarchTables tb = load_tables(smem + S::bytes(prm.stage), prm.geom, prm.cell_live,
                                     prm.pos_needed, nullptr, flag_base, prm.NP, tid,
                                     TP * TQ);

  const TexelAt x{p0, q0, (int)threadIdx.y, (int)threadIdx.x, tid, (float)p, (float)q};
  const size_t plane = (size_t)prm.Pn * prm.Qn;
  const size_t pix = (size_t)p * prm.Qn + q;
  // texel direction -> norm and SH basis (reference: built at j == 0)
  float yb[NCOEFF];
  const float nm = texel_basis<NCOEFF, OPERANDS>(
      prm.ybasis, prm.norm, prm.fs, pix, plane, x.pf, x.qf, prm.u_ax, prm.v_ax,
      prm.g, yb);
  const VertexStack vs{prm.vert, prm.nvert, prm.nu, prm.nv, prm.C, prm.P};
  const bool direct = march_forward_staged<NCOEFF, DIFFUSE, RELU>(
      vs, sm, tb, prm.NP, prm.exit_eps, nm, yb, x, prm.out + pix, plane);
  if (direct && tid == 0 && prm.direct_tiles != nullptr) atomicAdd(prm.direct_tiles, 1);
}

// The stage a march of NP positions takes: what its position tables leave
// of the block's opt-in shared memory (Stage::fit).
template <int NCOEFF, bool OPERANDS>
StageSize fitted_stage(int NP) {
  return Stage<NCOEFF, !OPERANDS>::fit((long long)smem_optin() -
                                       (long long)march_tables_bytes(NP, false));
}

template <int NCOEFF, bool DIFFUSE, bool RELU, bool OPERANDS>
int launch(Params prm, cudaStream_t stream) {
  using S = Stage<NCOEFF, !OPERANDS>;
  prm.stage = fitted_stage<NCOEFF, OPERANDS>(prm.NP);
  const size_t smem = S::bytes(prm.stage) + march_tables_bytes(prm.NP, false);
  auto kern = composite_fused_kernel<NCOEFF, DIFFUSE, RELU, OPERANDS>;
  static size_t smem_allowed[16] = {};
  const cudaError_t e = allow_smem(kern, smem, smem_allowed);
  if (e != cudaSuccess) return (int)e;
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
// and norm come from ybasis / norm (the training branch). direct_tiles, when
// not NULL, gains one for every tile that gathered a position directly.
extern "C" int composite_fused_launch(
    const void* vert, const float* geom, const int* cell_live,
    const int* pos_needed, const float* fs, const float* ybasis,
    const float* norm, float* out, int* direct_tiles, int ncoeff, int with_diffuse, int relu,
    int NP, int P, int nvert, int nu, int nv, int C, int Pn, int Qn, int Pb,
    int Qb, int PB, int QB, int u_ax, int v_ax, int axis, float g,
    float exit_eps, void* stream) {
  (void)PB;
  Params prm{reinterpret_cast<const uint4*>(vert), geom, cell_live, pos_needed,
             fs, ybasis, norm, out, direct_tiles, NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb,
             QB, u_ax, v_ax, axis, StageSize{0, 0}, g, exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (fs != nullptr) return dispatch_ncoeff<false>(prm, ncoeff, with_diffuse, relu, s);
  if (ybasis == nullptr || norm == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_ncoeff<true>(prm, ncoeff, with_diffuse, relu, s);
}

// The stage a launch with these arguments takes: records of a ring stage and
// t1 lines into recs_lines[0], recs_lines[1] (operands: the training branch).
extern "C" int composite_fused_stage(int ncoeff, int operands, int NP, int* recs_lines) {
  StageSize z;
  switch (ncoeff * 2 + (operands ? 1 : 0)) {
    case 2: z = fitted_stage<1, false>(NP); break;
    case 3: z = fitted_stage<1, true>(NP); break;
    case 8: z = fitted_stage<4, false>(NP); break;
    case 9: z = fitted_stage<4, true>(NP); break;
    case 18: z = fitted_stage<9, false>(NP); break;
    case 19: z = fitted_stage<9, true>(NP); break;
    case 32: z = fitted_stage<16, false>(NP); break;
    case 33: z = fitted_stage<16, true>(NP); break;
    default: return (int)cudaErrorInvalidValue;
  }
  recs_lines[0] = z.recs;
  recs_lines[1] = z.nvs;
  return 0;
}
