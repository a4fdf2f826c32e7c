// composite_stripe_backward: the replay VJP of the stripe composite
// (composite_stripe.cu) with respect to the u-resampled stack t1.
//
// Replaces the TPU kernels thr3ed_atom_tpu/rendering/gnomonic_train.py
// _composite_backward (kernel _make_backward_kernel, QB = 1; K7) and
// _composite_backward_qb (kernel _make_backward_kernel_qb, QB q-blocks of Qb
// texels; K8). The stripe kernel walks
// u-blocks outermost and steps j = 0 .. NP innermost: step j replays position
// j with the forward's MXU product, recomputes cell (j-1, j), assembles
// position j-1's per-channel cotangent dvals [C Pb, Qn], rounds it to bf16 and
// folds it through the v-tents with a second product,
// dt1[j-1] = bf16(bf16(dvals) @ rv) (f32 sum), rv = RvT transposed; blocks of
// dead positions write zeros. Here the work is split in three launches:
//
// 1. column taps (column_taps_kernel, gnomonic_stripe.cuh): every column of
//    RvT read once; its two taps, and for each row v the range of columns
//    whose taps reach it (the transposed tents the fold needs);
// 2. march (one thread per texel, march_backward in gnomonic_march.cuh with
//    the stripe source, as the fused replay backward runs it): the replay VJP,
//    writing bf16 dvals of every needed (u-block, q-block, position) into a
//    compact buffer with one [USED, Pb, Qb] slot per needed block;
// 3. fold (one block per (8 texel rows, position)): for each row p and output
//    (c, v), dt1[j, c, p, v] = bf16(sum over the columns q of v's range, in
//    ascending q, of w(q, v) * dvals[c, p, q]) with the column taps staged in
//    shared memory. Rows of dead blocks and pad channels come out zero.
//
// K8 differs from K7 in the grain and in the fold's association. Its TPU
// kernel sums each live q-block's partial dvals[C Pb, Qb] @ rv[Qb, nv] in f32,
// adds the partials across q-blocks in ascending order into an f32
// accumulator and rounds to bf16 once, after the last q-block. The fold here
// does the same: per q-block with a needed slot, the ascending-q sum over that
// block's part of v's column range, then partial after partial. With QB = 1
// the single partial is K7's sum, bit for bit.
//
// Bound on the H100: memory. The march reads what the forward reads and
// writes 2 bytes per used channel per needed (position, texel); the fold reads
// each needed dvals element about twice (two tents overlap a column) and
// writes dt1 [NP, C, Pn, nv] bf16 once (1.07 GB at 128^3, P = 2, 512 x 512
// texels). Built with -fmad=false: the replay rounds as the forward and the
// plain version; the fold sums in a fixed order (ascending q), which differs
// from a matmul's order only by f32 round-off before the bf16 rounding.
#include <cuda_runtime.h>

#include "gnomonic_stripe.cuh"

namespace {

using namespace gnomonic;

struct MarchParams {
  StripeOperands op;
  const float* geom;      // [NP, 8]
  const int* cell_live;   // [PB, QB, NP]
  const int* pos_needed;  // [PB, QB, NP]
  const int* slot;        // [PB, QB, NP]: dvals slot of a needed block, else -1
  const float* ybasis;    // [ncoeff, Pn, Qn]
  const float* norm;      // [Pn, Qn]
  const float* gaux;      // [SROWS + 2, Pn, Qn]: gstate rows, S_total, T_final
  __nv_bfloat16* dvals;   // [n_slots, USED, Pb, Qb]
  int NP, Pb, QB, Qb;
};

template <int NCOEFF, bool DIFFUSE, bool RELU>
__global__ void __launch_bounds__(TP * TQ) stripe_march_kernel(MarchParams prm) {
  extern __shared__ float smem[];
  const int q = blockIdx.x * TQ + threadIdx.x;
  const int p = blockIdx.y * TP + threadIdx.y;
  const int pb = (blockIdx.y * TP) / prm.Pb;
  const int qblk = (blockIdx.x * TQ) / prm.Qb;
  const int tid = threadIdx.y * TQ + threadIdx.x;
  const MarchTables tb =
      load_tables(smem, prm.geom, prm.cell_live, prm.pos_needed, prm.slot,
                  ((size_t)pb * prm.QB + qblk) * prm.NP, prm.NP, tid, TP * TQ);
  const int Qn = prm.op.Qn;
  const size_t plane = (size_t)prm.op.Pn * Qn;
  const size_t pix = (size_t)p * Qn + q;
  float yb[NCOEFF];
  const float nm = texel_basis<NCOEFF, true>(prm.ybasis, prm.norm, nullptr, pix,
                                             plane, 0.0f, 0.0f, 0, 0, 0.0f, yb);
  const StripeSource<NCOEFF> src{prm.op, p, q, yb};
  const size_t blk = (size_t)prm.Pb * prm.Qb;
  const size_t in_blk = (size_t)(p - pb * prm.Pb) * prm.Qb + (q - qblk * prm.Qb);
  march_backward<NCOEFF, DIFFUSE, RELU>(src, tb, prm.NP, nm, yb, prm.gaux + pix, plane,
                                        prm.dvals, blk, in_blk);
}

struct FoldParams {
  const __nv_bfloat16* dvals;  // [n_slots, used, Pb, Qb]
  const int* slot;             // [PB, QB, NP]
  const float4* taps;          // [NP, Qn]
  const int* q_lo;             // [NP, nv]
  const int* q_hi;             // [NP, nv]
  __nv_bfloat16* dt1;          // [NP, C, Pn, nv]
  int NP, C, used, Pn, Qn, nv, Pb, QB, Qb;
};

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_ROWS = 8;  // texel rows per block (Pn is a multiple of 128)

__host__ __device__ inline size_t fold_smem_bytes(int Qn, int nv) {
  return (size_t)Qn * sizeof(float4) + (size_t)2 * nv * sizeof(int);
}

__global__ void __launch_bounds__(FOLD_THREADS) stripe_fold_kernel(FoldParams prm) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int nv = prm.nv, Qn = prm.Qn;
  float4* s_taps = reinterpret_cast<float4*>(fold_smem);  // [Qn]
  int* s_lo = reinterpret_cast<int*>(s_taps + Qn);        // [nv]
  int* s_hi = s_lo + nv;                                  // [nv]
  for (int q = tid; q < Qn; q += FOLD_THREADS) s_taps[q] = prm.taps[(size_t)j * Qn + q];
  for (int v = tid; v < nv; v += FOLD_THREADS) {
    s_lo[v] = prm.q_lo[(size_t)j * nv + v];
    s_hi[v] = prm.q_hi[(size_t)j * nv + v];
  }
  __syncthreads();

  const int n_out = prm.C * nv;
  for (int r = 0; r < FOLD_ROWS; ++r) {
    const int p = blockIdx.x * FOLD_ROWS + r;
    const int pb = p / prm.Pb, pl = p - pb * prm.Pb;
    const int* slots = prm.slot + (size_t)pb * prm.QB * prm.NP + j;  // stride NP
    __nv_bfloat16* o = prm.dt1 + ((size_t)j * prm.C * prm.Pn + p) * nv;
    for (int i = tid; i < n_out; i += FOLD_THREADS) {
      const int ch = i / nv, v = i - ch * nv;
      float dt = 0.0f;
      bool first = true;
      for (int b = 0; b < prm.QB && ch < prm.used; ++b) {
        const int s = slots[(size_t)b * prm.NP];
        if (s < 0) continue;  // a dead q-block adds nothing
        const int q0 = b * prm.Qb;
        const __nv_bfloat16* d =
            prm.dvals + (((size_t)s * prm.used + ch) * prm.Pb + pl) * prm.Qb;
        float part = 0.0f;
        const int q_end = min(s_hi[v], q0 + prm.Qb - 1);
        for (int q = max(s_lo[v], q0); q <= q_end; ++q) {
          const float4 tp = s_taps[q];
          const int v0 = __float_as_int(tp.x);
          const float w = v0 == v ? tp.y : (v0 + 1 == v ? tp.z : 0.0f);
          if (w != 0.0f) part = part + w * __bfloat162float(d[q - q0]);
        }
        dt = first ? part : dt + part;
        first = false;
      }
      o[(size_t)ch * prm.Pn * nv + v] = __float2bfloat16_rn(dt);
    }
  }
}

template <int NCOEFF, bool DIFFUSE, bool RELU>
int launch_march(const MarchParams& prm, cudaStream_t stream) {
  const size_t smem = march_tables_bytes(prm.NP, true);
  auto kern = stripe_march_kernel<NCOEFF, DIFFUSE, RELU>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(TQ, TP);
  const dim3 grid(prm.op.Qn / TQ, prm.op.Pn / TP);
  kern<<<grid, block, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <int NCOEFF>
int dispatch(const MarchParams& prm, int with_diffuse, int relu, cudaStream_t s) {
  if (with_diffuse)
    return relu ? launch_march<NCOEFF, true, true>(prm, s)
                : launch_march<NCOEFF, true, false>(prm, s);
  return relu ? launch_march<NCOEFF, false, true>(prm, s)
              : launch_march<NCOEFF, false, false>(prm, s);
}

}  // namespace

// Three launches on one stream: the column taps (``taps`` [NP, Qn] float4 and
// ``q_lo`` / ``q_hi`` [NP, nv], preset to INT_MAX / -1 by the caller), the
// march (only the slots of needed blocks of ``dvals``) and the fold, which
// writes every element of dt1. QB = 1, Qb = Qn is K7; QB > 1 is K8.
extern "C" int composite_stripe_backward_launch(
    const void* t1, long long sj, long long sc, long long sp, const void* rvt,
    void* taps, int* q_lo, int* q_hi, const float* live_u, const float* live_v,
    const float* geom, const int* cell_live, const int* pos_needed, const int* slot,
    const float* ybasis, const float* norm, const float* gaux, void* dvals, void* dt1,
    int ncoeff, int with_diffuse, int relu, int NP, int C, int nv, int Pn, int Qn,
    int Pb, int QB, int Qb, void* stream) {
  if (QB * Qb != Qn || Qb % TQ != 0 || Pb % TP != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 tgrid((Qn + 127) / 128, NP);
  column_taps_kernel<<<tgrid, 128, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(rvt), reinterpret_cast<float4*>(taps),
      q_lo, q_hi, NP, nv, Qn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const StripeOperands op{reinterpret_cast<const __nv_bfloat16*>(t1), sj, sc, sp,
                          reinterpret_cast<const float4*>(taps), live_u, live_v, Pn,
                          Qn, nv};
  MarchParams mp{op, geom, cell_live, pos_needed, slot, ybasis, norm, gaux,
                 reinterpret_cast<__nv_bfloat16*>(dvals), NP, Pb, QB, Qb};
  int err;
  switch (ncoeff) {
    case 1: err = dispatch<1>(mp, with_diffuse, relu, s); break;
    case 4: err = dispatch<4>(mp, with_diffuse, relu, s); break;
    case 9: err = dispatch<9>(mp, with_diffuse, relu, s); break;
    case 16: err = dispatch<16>(mp, with_diffuse, relu, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;

  FoldParams fp{reinterpret_cast<const __nv_bfloat16*>(dvals), slot,
                reinterpret_cast<const float4*>(taps), q_lo, q_hi,
                reinterpret_cast<__nv_bfloat16*>(dt1), NP, C, 3 * ncoeff + 1, Pn, Qn,
                nv, Pb, QB, Qb};
  const size_t smem = fold_smem_bytes(Qn, nv);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(stripe_fold_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Pn / FOLD_ROWS, NP);
  stripe_fold_kernel<<<grid, FOLD_THREADS, smem, s>>>(fp);
  return (int)cudaGetLastError();
}
