// composite_stripe: the gnomonic renderer's stripe march (v-resample + SH +
// relu-trapezoid front-to-back composite) over all positions of one pose, from
// the u-resampled position stack t1.
//
// Replaces the TPU kernels thr3ed_atom_tpu/rendering/gnomonic.py
// composite_positions (kernel _make_composite_kernel, the whole-height stripe,
// QB = 1; K5) and _composite_positions_qb (kernel _make_composite_kernel_qb,
// QB = Qn / qb q-blocks of Qb texels; K6). The stripe kernel walks u-blocks
// outermost and positions innermost, and
// per (u-block, position) resamples the block's values with one MXU product
// t1[C Pb, nv] @ RvT[nv, Qn] (bf16 in, f32 sum), folds the SH basis and
// composites with carries in VMEM. Here one thread owns one texel (p, q) and
// marches positions j = 0 .. NP-1 with its state in registers
// (march_forward, gnomonic_march.cuh, the loop the fused composite runs).
//
// The v-resample is not a dense product: a launch first reads every column of
// RvT once and keeps its two taps (column_taps_kernel, gnomonic_stripe.cuh);
// the march then gathers t1[j, c, p, v0] and t1[j, c, p, v0 + 1] per used
// channel and sums w0 t1 + w1 t1 in f32, which equals the dense product
// exactly (bf16 products are exact in f32, the other terms are zeros). A dense
// loop over nv would cost nv / 2 (64 at 128^3) times the arithmetic.
// Occupancy flags of the (128-row u-block, q-block) that holds the tile
// ([PB, QB, NP]; QB = 1 is K5's [PB, NP]) gate the work (lossless); with
// exit_eps > 0 a TP x TQ tile stops once every texel's transmittance is <=
// exit_eps (the TPU stops a whole 128 x Qb block; the difference is bounded
// by exit_eps per texel). K6 is K5 with the q-block grain: a tile lies in one
// q-block (Qb is a multiple of TQ) and reads only that block's flags; with
// QB = 1 the flag row is the u-block's, as before.
//
// Bound on the H100: memory by its byte count. Its inputs are t1 (1.07 GB at
// 128^3, P = 2, 512 x 512 texels: 2 bytes per (position, channel, texel row,
// v)), the dense RvT and the basis operands; the march reads, per marched
// (position, texel), two bf16 of t1 per used channel. Neighbouring texels
// along q read neighbouring v of one t1 row, so a warp's gathers fall in one
// or two 32-byte sectors. In practice the march's dependent loads limit it
// (a position's t1 addresses depend on its taps): a register budget of 128
// a thread (__launch_bounds__(256, 2), two CTAs an SM) lets the compiler
// keep a position's 2 x (3 ncoeff + 1) t1 loads in flight together, where
// unbounded it chose far fewer registers and the march ran slower on the
// H100. Staging the operands in a cp.async ring two positions ahead was
// slower there too (PERF.md). Built with -fmad=false: each f32 operation
// rounds as in the plain PyTorch version.
#include <cuda_runtime.h>

#include "gnomonic_stripe.cuh"
#include "smem_limit.cuh"

namespace {

using namespace gnomonic;

struct Params {
  StripeOperands op;
  const float* geom;      // [NP, 8]
  const int* cell_live;   // [PB, QB, NP]
  const int* pos_needed;  // [PB, QB, NP]
  const float* ybasis;    // [ncoeff, Pn, Qn]
  const float* norm;      // [Pn, Qn]
  float* out;             // [SROWS, Pn, Qn]
  int NP, Pb, QB, Qb;
  float exit_eps;
};

template <int NCOEFF, bool DIFFUSE, bool RELU>
__global__ void __launch_bounds__(TP * TQ, 2) composite_stripe_kernel(Params prm) {
  extern __shared__ float smem[];
  const int q = blockIdx.x * TQ + threadIdx.x;
  const int p = blockIdx.y * TP + threadIdx.y;
  const int pb = (blockIdx.y * TP) / prm.Pb;
  const int qblk = (blockIdx.x * TQ) / prm.Qb;
  const int tid = threadIdx.y * TQ + threadIdx.x;
  const MarchTables tb =
      load_tables(smem, prm.geom, prm.cell_live, prm.pos_needed, nullptr,
                  ((size_t)pb * prm.QB + qblk) * prm.NP, prm.NP, tid, TP * TQ);
  const size_t plane = (size_t)prm.op.Pn * prm.op.Qn;
  const size_t pix = (size_t)p * prm.op.Qn + q;
  float yb[NCOEFF];
  const float nm = texel_basis<NCOEFF, true>(prm.ybasis, prm.norm, nullptr, pix,
                                             plane, 0.0f, 0.0f, 0, 0, 0.0f, yb);
  const StripeSource<NCOEFF> src{prm.op, p, q, yb};
  march_forward<DIFFUSE, RELU>(src, tb, prm.NP, prm.exit_eps, nm, prm.out + pix, plane);
}

template <int NCOEFF, bool DIFFUSE, bool RELU>
int launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = march_tables_bytes(prm.NP, false);
  auto kern = composite_stripe_kernel<NCOEFF, DIFFUSE, RELU>;
  static size_t smem_allowed[16] = {};
  const cudaError_t e = allow_smem(kern, smem, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(TQ, TP);
  const dim3 grid(prm.op.Qn / TQ, prm.op.Pn / TP);
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

// Two launches on one stream: the column taps of rvt into ``taps`` [NP, Qn]
// float4 (scratch), then the march. QB = 1, Qb = Qn is K5; QB > 1 is K6.
extern "C" int composite_stripe_launch(
    const void* t1, long long sj, long long sc, long long sp, const void* rvt,
    void* taps, const float* live_u, const float* live_v, const float* geom,
    const int* cell_live, const int* pos_needed, const float* ybasis,
    const float* norm, float* out, int ncoeff, int with_diffuse, int relu, int NP,
    int nv, int Pn, int Qn, int Pb, int QB, int Qb, float exit_eps, void* stream) {
  if (QB * Qb != Qn || Qb % TQ != 0 || Pb % TP != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 tgrid((Qn + 127) / 128, NP);
  column_taps_kernel<<<tgrid, 128, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(rvt), reinterpret_cast<float4*>(taps),
      nullptr, nullptr, NP, nv, Qn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Params prm{StripeOperands{reinterpret_cast<const __nv_bfloat16*>(t1), sj, sc, sp,
                            reinterpret_cast<const float4*>(taps), live_u, live_v, Pn,
                            Qn, nv},
             geom, cell_live, pos_needed, ybasis, norm, out, NP, Pb, QB, Qb, exit_eps};
  switch (ncoeff) {
    case 1: return dispatch<1>(prm, with_diffuse, relu, s);
    case 4: return dispatch<4>(prm, with_diffuse, relu, s);
    case 9: return dispatch<9>(prm, with_diffuse, relu, s);
    case 16: return dispatch<16>(prm, with_diffuse, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
