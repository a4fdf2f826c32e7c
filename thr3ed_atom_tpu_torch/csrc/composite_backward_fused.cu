// composite_backward_fused: the replay VJP of the fused composite
// (composite_fused.cu) with respect to the position slices.
//
// Replaces the TPU kernel thr3ed_atom_tpu/rendering/gnomonic_train.py
// _composite_backward_fused (kernel _make_backward_kernel_fused). That kernel
// runs positions outermost with the whole frame's carries in VMEM and folds
// each position's cotangent through both tents with MXU products. Here the
// work is split in two launches:
//
// 1. march (one thread per texel, positions j = 0 .. NP in an inner loop, as
//    the forward; march_backward in gnomonic_march.cuh): replays position j
//    exactly as the forward computed it, rebuilds T and the running prefix
//    S = sum of inner * w, and forms the per-cell dL/d(integral) in the
//    reference's division-free suffix form
//      dinteg = delta * ((1 - alpha) * T * inner - suffix),
//      suffix = (S_total - S_prefix) + gT * T_final,
//    routed to the cell's two endpoint positions with dI/da, dI/db of the
//    relu trapezoid; colour cotangents lerp back with (1 - tbar, tbar), the
//    emission centroid tbar held constant (the reference's convention).
//    Position j-1's cotangent is its pending b-side plus cell j's a-side; its
//    per-channel dvals (folded through the SH basis) are rounded to bf16, as
//    the reference rounds them before the v-fold, and written to a compact
//    buffer with one [USED, Pb, Qb] slot per needed (u-block, q-block,
//    position) — the occupancy flags, so dead blocks cost no memory. Masks
//    are branches, so a stale value of a dead position never enters a sum.
// 2. fold (one block per (u, position)): dslices[j, u, c, v] =
//      bf16( sum_p w_u(p, u) * bf16( sum_q w_v(q, v) * dvals[j, c, p, q] ) )
//    with the bf16 tents of position j. The tent of u reaches a contiguous
//    range of texel rows p (U is affine in p), and that of v a contiguous
//    range of q; the block builds the v-tents' weights once, stages each
//    row's dvals in shared memory once, and rounds the f32 v-sum of every
//    (c, v) to bf16 before the u-sum, where the reference rounds the
//    q-summed dt1. Pad channels and dead positions come out zero.
//
// Bound on the H100: memory. The march re-reads the forward's vertex records
// (as the forward) and writes 2 bytes per used channel per needed (position,
// texel) pair; the fold reads each live dvals row about twice (two u tents
// overlap a row) and writes the [NP, nu, C, nv] bf16 dslices once.
// Built with -fmad=false: the replay rounds as the forward and the plain
// version; the fold's sums run in a fixed order, which differs from the
// reference's matmul order only by f32 round-off.
#include <cuda_runtime.h>

#include "gnomonic_march.cuh"

namespace {

using namespace gnomonic;

struct MarchParams {
  const uint4* vert;      // [nvert, nu, nv, C] bf16
  const float* geom;      // [NP, 8]
  const int* cell_live;   // [PB, QB, NP]
  const int* pos_needed;  // [PB, QB, NP]
  const int* slot;        // [PB, QB, NP]: dvals slot of a needed block, else -1
  const float* ybasis;    // [ncoeff, Pn, Qn]
  const float* norm;      // [Pn, Qn]
  const float* gaux;      // [SROWS + 2, Pn, Qn]: gstate rows, S_total, T_final
  __nv_bfloat16* dvals;   // [n_slots, USED, Pb, Qb]
  int NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb, QB;
};

template <int NCOEFF, bool DIFFUSE, bool RELU>
__global__ void __launch_bounds__(TP * TQ) backward_march_kernel(MarchParams prm) {
  extern __shared__ float smem[];
  const int q = blockIdx.x * TQ + threadIdx.x;
  const int p = blockIdx.y * TP + threadIdx.y;
  const int pb = (blockIdx.y * TP) / prm.Pb;
  const int qb = (blockIdx.x * TQ) / prm.Qb;
  const int tid = threadIdx.y * TQ + threadIdx.x;
  const size_t flag_base = ((size_t)pb * prm.QB + qb) * prm.NP;
  const MarchTables tb = load_tables(smem, prm.geom, prm.cell_live, prm.pos_needed,
                                     prm.slot, flag_base, prm.NP, tid, TP * TQ);

  const float pf = (float)p, qf = (float)q;
  const size_t plane = (size_t)prm.Pn * prm.Qn;
  const size_t pix = (size_t)p * prm.Qn + q;
  float yb[NCOEFF];
  const float nm = texel_basis<NCOEFF, true>(prm.ybasis, prm.norm, nullptr, pix,
                                             plane, pf, qf, 0, 0, 0.0f, yb);
  const VertexSource<NCOEFF> src{
      VertexStack{prm.vert, prm.nvert, prm.nu, prm.nv, prm.C, prm.P}, pf, qf, yb};
  // the dvals element of this texel inside a [USED, Pb, Qb] slot
  const size_t blk = (size_t)prm.Pb * prm.Qb;
  const size_t in_blk = (size_t)(p - pb * prm.Pb) * prm.Qb + (q - qb * prm.Qb);
  march_backward<NCOEFF, DIFFUSE, RELU>(src, tb, prm.NP, nm, yb, prm.gaux + pix, plane,
                                        prm.dvals, blk, in_blk);
}

struct FoldParams {
  const __nv_bfloat16* dvals;  // [n_slots, used, Pb, Qb]
  const int* slot;             // [PB, QB, NP]
  const float* geom;           // [NP, 8]
  __nv_bfloat16* dsl;          // [NP, nu, C, nv]
  int NP, nu, nv, C, used, Pn, Qn, Pb, Qb, QB;
};

constexpr int FOLD_THREADS = 256;
constexpr int MAXW = 32;  // v-tent taps per grid line kept in shared memory

// [lo, hi] of the grid positions i in [0, n) whose tent at coordinate
// b + k * i can reach grid line x: |b + k i - x| < 1, widened by two so that
// the f32 division can miss none (every weight is recomputed exactly).
__device__ __forceinline__ void tent_range(float b, float k, float x, int n,
                                           int& lo, int& hi) {
  float a = (x - 1.0f - b) / k, z = (x + 1.0f - b) / k;
  if (a > z) {
    const float t = a;
    a = z;
    z = t;
  }
  // fmaxf / fminf drop a NaN (k == 0): the whole range is then searched
  a = fminf(fmaxf(floorf(a) - 2.0f, 0.0f), (float)(n - 1));
  z = fminf(fmaxf(ceilf(z) + 2.0f, 0.0f), (float)(n - 1));
  lo = (int)a;
  hi = (int)z;
  if (!(k > 0.0f || k < 0.0f)) {
    lo = 0;
    hi = n - 1;
  }
}

// Shared memory of the fold: one staged dvals row [used, <= Qn + 8] (bf16,
// as stored; first, so that its 16-byte stores are aligned), f32
// accumulators [used, nv], the v-tents [MAXW, nv] (neighbouring v in
// neighbouring banks) with their first q and count [nv] each, and the row's
// slots [QB].
__host__ __device__ inline size_t fold_row_bytes(int used, int Qn) {
  return ((size_t)used * (Qn + 8) * sizeof(__nv_bfloat16) + 15) / 16 * 16;
}

__host__ __device__ inline size_t fold_smem_bytes(int used, int nv, int Qn, int QB) {
  return fold_row_bytes(used, Qn) + ((size_t)used * nv + (size_t)nv * MAXW) * sizeof(float) +
         ((size_t)2 * nv + QB) * sizeof(int);
}

__global__ void __launch_bounds__(FOLD_THREADS) backward_fold_kernel(FoldParams prm) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  const int u = blockIdx.x, j = blockIdx.y;
  const int tid = threadIdx.x;
  const float bu = prm.geom[(size_t)j * 8 + 2], ku = prm.geom[(size_t)j * 8 + 3];
  const float bv = prm.geom[(size_t)j * 8 + 4], kv = prm.geom[(size_t)j * 8 + 5];
  const int nv = prm.nv, n_out = prm.used * nv;
  // the q window that any v of this position reaches (ranges are monotone in v)
  int qa0, qb0, qa1, qb1;
  tent_range(bv, kv, 0.0f, prm.Qn, qa0, qb0);
  tent_range(bv, kv, (float)(nv - 1), prm.Qn, qa1, qb1);
  // staged in whole 16-byte groups of 8 q (a q-block holds whole groups)
  const int q_lo = min(qa0, qa1) / 8 * 8, q_hi = max(qb0, qb1);
  const int n_grp = (q_hi - q_lo) / 8 + 1;
  const int width = n_grp * 8;
  __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(fold_smem);  // [used, width]
  float* acc = reinterpret_cast<float*>(fold_smem + fold_row_bytes(prm.used, prm.Qn));  // [used, nv]
  float* wv = acc + n_out;                            // [MAXW, nv]
  int* v_lo = reinterpret_cast<int*>(wv + (size_t)nv * MAXW);  // [nv]
  int* v_cnt = v_lo + nv;                             // [nv]; -1: over MAXW taps
  int* row_slot = v_cnt + nv;                         // [QB]
  for (int i = tid; i < n_out; i += FOLD_THREADS) acc[i] = 0.0f;
  // the v-tents of this position, once: w(q, v) for q in v's range
  for (int v = tid; v < nv; v += FOLD_THREADS) {
    int qa, qz;
    tent_range(bv, kv, (float)v, prm.Qn, qa, qz);
    const int cnt = qz - qa + 1;
    v_lo[v] = qa;
    v_cnt[v] = cnt <= MAXW ? cnt : -1;
    for (int i = 0; i < cnt && i < MAXW; ++i)
      wv[i * nv + v] = tent(bv + kv * (float)(qa + i), (float)v);
  }

  int p_lo, p_hi;
  tent_range(bu, ku, (float)u, prm.Pn, p_lo, p_hi);
  const size_t blk = (size_t)prm.Pb * prm.Qb;
  for (int p = p_lo; p <= p_hi; ++p) {
    const float wu = tent(bu + ku * (float)p, (float)u);
    if (wu == 0.0f) continue;  // uniform over the block
    const int pb = p / prm.Pb, pl = p - pb * prm.Pb;
    __syncthreads();
    for (int qb = tid; qb < prm.QB; qb += FOLD_THREADS)
      row_slot[qb] = prm.slot[((size_t)pb * prm.QB + qb) * prm.NP + j];
    __syncthreads();
    // stage row p of the position's dvals (zero where its block is dead),
    // 16 bytes per load, several loads in flight per thread
#pragma unroll 4
    for (int i = tid; i < prm.used * n_grp; i += FOLD_THREADS) {
      const int ch = i / n_grp, g = i - ch * n_grp;
      const int q0 = q_lo + 8 * g;
      const int qb = q0 / prm.Qb;
      const int s = row_slot[qb];
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (s >= 0)
        val = *reinterpret_cast<const uint4*>(
            prm.dvals + ((size_t)s * prm.used + ch) * blk + (size_t)pl * prm.Qb +
            (q0 - qb * prm.Qb));
      *reinterpret_cast<uint4*>(row + (size_t)ch * width + 8 * g) = val;
    }
    __syncthreads();
    for (int i = tid; i < n_out; i += FOLD_THREADS) {
      const int ch = i / nv, v = i - ch * nv;
      const int qa = v_lo[v], cnt = v_cnt[v];
      const __nv_bfloat16* r = row + (size_t)ch * width + (qa - q_lo);
      float dt = 0.0f;
      if (cnt >= 0) {
        const float* w = wv + v;
        for (int k = 0; k < cnt; ++k) dt = dt + w[k * nv] * __bfloat162float(r[k]);
      } else {  // a wide tent (a far-zoomed frame): weights on the fly
        int qa2, qz;
        tent_range(bv, kv, (float)v, prm.Qn, qa2, qz);
        for (int q = qa; q <= qz; ++q)
          dt = dt + tent(bv + kv * (float)q, (float)v) * __bfloat162float(r[q - qa]);
      }
      acc[i] = acc[i] + wu * bf16r(dt);
    }
  }
  __syncthreads();
  __nv_bfloat16* o = prm.dsl + ((size_t)j * prm.nu + u) * prm.C * nv;
  for (int i = tid; i < prm.C * nv; i += FOLD_THREADS)
    o[i] = __float2bfloat16_rn(i < n_out ? acc[i] : 0.0f);
}

template <int NCOEFF, bool DIFFUSE, bool RELU>
int launch_march(const MarchParams& prm, cudaStream_t stream) {
  const size_t smem = march_tables_bytes(prm.NP, true);
  auto kern = backward_march_kernel<NCOEFF, DIFFUSE, RELU>;
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
int dispatch(const MarchParams& prm, int with_diffuse, int relu, cudaStream_t s) {
  if (with_diffuse)
    return relu ? launch_march<NCOEFF, true, true>(prm, s)
                : launch_march<NCOEFF, true, false>(prm, s);
  return relu ? launch_march<NCOEFF, false, true>(prm, s)
              : launch_march<NCOEFF, false, false>(prm, s);
}

}  // namespace

// Both launches on one stream: the march writes dvals (only the slots of
// needed blocks), the fold reads them and writes every element of dsl.
extern "C" int composite_backward_fused_launch(
    const void* vert, const float* geom, const int* cell_live,
    const int* pos_needed, const int* slot, const float* ybasis,
    const float* norm, const float* gaux, void* dvals, void* dsl, int ncoeff,
    int with_diffuse, int relu, int NP, int P, int nvert, int nu, int nv, int C,
    int Pn, int Qn, int Pb, int Qb, int QB, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  MarchParams mp{reinterpret_cast<const uint4*>(vert), geom, cell_live,
                 pos_needed, slot, ybasis, norm, gaux,
                 reinterpret_cast<__nv_bfloat16*>(dvals),
                 NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb, QB};
  int err;
  switch (ncoeff) {
    case 1: err = dispatch<1>(mp, with_diffuse, relu, s); break;
    case 4: err = dispatch<4>(mp, with_diffuse, relu, s); break;
    case 9: err = dispatch<9>(mp, with_diffuse, relu, s); break;
    case 16: err = dispatch<16>(mp, with_diffuse, relu, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;

  FoldParams fp{reinterpret_cast<const __nv_bfloat16*>(dvals), slot, geom,
                reinterpret_cast<__nv_bfloat16*>(dsl), NP, nu, nv, C,
                3 * ncoeff + 1, Pn, Qn, Pb, Qb, QB};
  const size_t smem = fold_smem_bytes(fp.used, nv, Qn, QB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        backward_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nu, NP);
  backward_fold_kernel<<<grid, FOLD_THREADS, smem, s>>>(fp);
  return (int)cudaGetLastError();
}
