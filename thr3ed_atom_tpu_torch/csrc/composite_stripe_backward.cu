// composite_stripe_backward: the replay VJP of the stripe composite
// (composite_stripe.cu) with respect to the u-resampled stack t1.
//
// Replaces the TPU kernels thr3ed_atom_tpu/rendering/gnomonic_train.py
// _composite_backward (kernel _make_backward_kernel, QB = 1; K7) and
// _composite_backward_qb (kernel _make_backward_kernel_qb, QB q-blocks of Qb
// texels; K8). The stripe kernel walks u-blocks outermost and steps j = 0 ..
// NP innermost: step j replays position j with the forward's MXU product,
// recomputes cell (j-1, j), assembles position j-1's per-channel cotangent
// dvals [C Pb, Qn], rounds it to bf16 and folds it through the v-tents with a
// second product, dt1[j-1] = bf16(bf16(dvals) @ rv) (f32 sum), rv = RvT
// transposed; blocks of dead positions write zeros.
//
// K7 (QB = 1) and K8 (QB > 1 q-blocks) here: the column taps
// (column_taps_kernel, gnomonic_stripe.cuh: every column of RvT read once,
// its two taps), then one band kernel. A band CTA owns R texel rows by Qc
// columns, one thread a texel; a cluster of S CTAs spans the row band's
// whole q extent (one CTA up to Qn = 512 where the shared memory allows;
// stripe_band_plan in gnomonic_train.py). The occupancy flags are per
// (u-block, q-block) ([PB, QB, NP]; K7's [PB, NP] is QB = 1); every CTA
// holds, for each position, the flags of all the band's q-blocks as bits
// of one word (QB <= 32), and the cluster steps through the union of the
// q-blocks' needed positions together, one barrier a position of the
// union. Two positions ahead, cp.async copies a position's t1 rows of the
// band ([used, R, nv] bf16), its columns' taps and its liveness to
// shared-memory rings; every texel replays from them under its own
// q-block's flags (march_backward's arithmetic, step for step: where its
// block does not need a position the texel neither replays it nor moves
// its state, and it flushes only what its block needs) and writes its bf16
// cotangent of the flushed position to shared memory, and the band records
// the range of columns whose taps reach each row v (shared atomics of
// order-free min / max). A barrier on, each CTA folds its share of the rows
// v in the TPU kernel's association: for each q-block that needs the
// position, a partial sum over the block's columns of v's range in
// ascending q of w(q, v) * dvals[c, p, q] in f32, the partials added in
// ascending q-block order, dt1[j, c, p, v] = bf16 of the total (QB = 1: one
// partial over the whole range). It reads the other CTAs' cotangents and
// taps through distributed shared memory (a q-block may straddle two CTAs:
// the partials restart at q-block boundaries, not at CTA boundaries) and
// writes dt1's rows coalesced along v, each element once; the next
// position's replay runs in the same phase. Positions no q-block of the
// band needs, and pad channels, get zero rows. No per-texel cotangent
// leaves the cluster: no dvals buffer and no fold launch.
//
// The three launches the band kernel replaced stay for the frames past its
// reach (Qn > 4096: more than 8 CTAs of 512 columns, the portable cluster
// size; more than 32 q-blocks; position tables filling shared memory): the
// column taps (with, for each row v, the range of columns reaching it:
// global atomics), a march with one thread per texel (march_backward over
// the stripe source) writing bf16 dvals of every needed (u-block, q-block,
// position) into a compact buffer, and a fold. Both designs sum in the
// same order, so they give the same bits.
//
// Bound on the H100: memory. The replay reads what the forward reads; dt1
// [NP, C, Pn, nv] bf16 is written once (1.07 GB at 128^3, P = 2, 512 x 512
// texels). The band kernel itself runs below that bound, on the replay's
// arithmetic at one 512-thread CTA an SM (128 registers a thread): every
// needed position costs each texel a few hundred dependent instructions
// between two barriers. With QB > 1 a texel whose q-block skips a position
// of the union sits that phase out. Built with -fmad=false: the replay
// rounds as the forward and the plain version; the fold sums in a fixed
// order (ascending q), which differs from a matmul's order only by f32
// round-off before the bf16 rounding.
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gnomonic_stage.cuh"
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

// ----------------------------------------------------------- K7 / K8: band

struct BandParams {
  const __nv_bfloat16* t1;  // [NP, C, Pn, nv], unit stride along v
  long long sj, sc, sp;
  const float4* taps;       // [NP, Qn]
  const float* live_u;      // [NP, Pn]
  const float* live_v;      // [NP, Qn]
  const float* geom;        // [NP, 8]
  const int* cell_live;     // [PB, QB, NP]
  const int* pos_needed;    // [PB, QB, NP]
  const float* ybasis;      // [ncoeff, Pn, Qn]
  const float* norm;        // [Pn, Qn]
  const float* gaux;        // [SROWS + 2, Pn, Qn]
  __nv_bfloat16* dt1;       // [NP, C, Pn, nv]
  int NP, C, Pn, Qn, nv, Pb, QB, Qb;
  int S, R, Qc, staged;     // cluster size, rows and columns of a CTA, t1 staged
};

constexpr int BAND_MAX_THREADS = 512;
constexpr int BAND_MAX_QBLOCKS = 32;  // a position's q-block flags: the bits of one word

// The band's per-position tables (march_tables_bytes(NP, false) bytes, as
// load_tables lays them out): geometry rows [NP, GEOM_COLS], then for each
// position its cell_live and its pos_needed flags over the u-block's QB
// q-blocks as bits (bit b: q-block b). A position is on the band's schedule
// where its pos_needed word is not 0, as next_needed reads it.
__device__ __forceinline__ MarchTables load_band_tables(void* smem, const BandParams& prm,
                                                        int pb, int tid, int nthreads) {
  const int NP = prm.NP;
  float* s_geom = reinterpret_cast<float*>(smem);  // [NP, GEOM_COLS]
  int* s_cl = reinterpret_cast<int*>(s_geom + NP * GEOM_COLS);
  int* s_pn = s_cl + NP;
  const size_t base = (size_t)pb * prm.QB * NP;
  for (int i = tid; i < NP; i += nthreads) {
#pragma unroll
    for (int k = 0; k < GEOM_COLS; ++k) s_geom[i * GEOM_COLS + k] = prm.geom[(size_t)i * 8 + k];
    unsigned cl = 0u, pn = 0u;
    for (int b = 0; b < prm.QB; ++b) {
      cl |= (unsigned)(prm.cell_live[base + (size_t)b * NP + i] != 0) << b;
      pn |= (unsigned)(prm.pos_needed[base + (size_t)b * NP + i] != 0) << b;
    }
    s_cl[i] = (int)cl;
    s_pn[i] = (int)pn;
  }
  __syncthreads();
  return MarchTables{s_geom, s_cl, s_pn, nullptr};
}

// The schedule, in phases that one barrier (the cluster's for S > 1) ends:
// in the phase that replays slot k (the k-th needed position), the band
// also flushes slot k - 1's cotangents and folds slot k - 2's, flushed a
// phase before. The copies run two slots ahead of the replay, so a slot's
// rows have a whole phase to arrive from device memory. Ring sizes follow
// from the phases in which each slot is read:
constexpr int TAP_SLOTS = 5;    // taps: at the slot's replay and its fold, two phases on
constexpr int ROW_SLOTS = 3;    // t1 rows and liveness: at its replay
constexpr int RANGE_SLOTS = 4;  // column ranges: written at its replay, read at its
                                // fold, cleared the phase after
constexpr int DV_SLOTS = 2;     // flushed cotangents: written one phase, folded the next

// Byte offsets of a band CTA's shared memory: the taps ring ([Qc] float4
// a slot), the liveness ring ([Qc live_v, R live_u, padded to 4] f32), the
// t1 ring ([used, R, nv] bf16, when staged), the per-position tables, the
// column ranges of each row v over the whole frame ([lo | hi][nv] int) and
// the flushed cotangents ([R, Qc, CS] bf16: a texel's channels contiguous,
// in groups of 8 that one 16-byte access moves, CS an odd multiple of 8 so
// that neighbouring texels' groups fall in different banks).
// stripe_band_plan (rendering/gnomonic_train.py) sizes the same layout.
struct BandLayout {
  size_t taps, live, t1, tables, lohi, dv, total;
};

// floats of a liveness slot: the CTA's live_v columns, then its rows' live_u
__host__ __device__ constexpr int band_live_len(int Qc, int R) {
  return (Qc + R + 3) / 4 * 4;
}

// the texel stride of the flushed cotangents: an odd number of 8-channel groups
__host__ __device__ constexpr int band_cs(int used) {
  return 8 * (((used + 7) / 8) | 1);
}

__host__ __device__ inline BandLayout band_layout(int NP, int used, int nv, int R, int Qc,
                                                  int staged) {
  BandLayout L;
  size_t off = 0;
  L.taps = off;
  off += (size_t)TAP_SLOTS * Qc * sizeof(float4);
  L.live = off;
  off += (size_t)ROW_SLOTS * band_live_len(Qc, R) * sizeof(float);
  L.t1 = off;
  off += staged ? (size_t)ROW_SLOTS * used * R * nv * sizeof(__nv_bfloat16) : 0;
  L.tables = off;
  off += march_tables_bytes(NP, false);
  L.lohi = off;
  off += ((size_t)RANGE_SLOTS * 2 * nv * sizeof(int) + 15) / 16 * 16;
  L.dv = off;
  off += (size_t)DV_SLOTS * R * Qc * band_cs(used) * sizeof(__nv_bfloat16);
  L.total = off;
  return L;
}

// x / d (x >= 0) by a shift where d is a power of two, as the band's index
// splits almost always are, else by division
struct FastDiv {
  int d, shift;
  __device__ explicit FastDiv(int d_) : d(d_), shift(0) {
    while ((1 << shift) < d) ++shift;
    if ((1 << shift) != d) shift = -1;
  }
  __device__ __forceinline__ int div(int x) const { return shift >= 0 ? x >> shift : x / d; }
};

__device__ __forceinline__ void band_sync(int S) {
  if (S > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// ``ptr`` in the shared memory of cluster CTA ``rank`` (``me``: this CTA)
template <class T>
__device__ __forceinline__ const T* in_rank(const T* ptr, int rank, int me) {
  if (rank == me) return ptr;
  return cooperative_groups::this_cluster().map_shared_rank(ptr, rank);
}

// QSPLIT: K8's instance (QB > 1: each texel under its q-block's bits, the
// fold by q-block partials); K7's (QB = 1) keeps the plain range sum.
template <int NCOEFF, bool DIFFUSE, bool RELU, bool QSPLIT>
__global__ void __launch_bounds__(BAND_MAX_THREADS) stripe_band_kernel(BandParams prm) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  constexpr int USED = 3 * NCOEFF + 1;
  constexpr int NG = (USED + 7) / 8;  // 8-channel groups of a texel's cotangent
  constexpr int CS = band_cs(USED);
  const int S = prm.S, R = prm.R, Qc = prm.Qc, nv = prm.nv, NP = prm.NP;
  const int Pn = prm.Pn, Qn = prm.Qn, C = prm.C;
  const int nthreads = R * Qc;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;  // the CTA's rank in its cluster (grid.x == S)
  const int r = tid / Qc, ql = tid - r * Qc;
  const int p0 = blockIdx.y * R;
  const int p = p0 + r, q = rank * Qc + ql;
  const bool valid = q < Qn;  // the last CTA of a cluster may have idle columns
  // the texel's q-block as its bit in the flag words (none for an idle column)
  const unsigned mine = valid ? 1u << (q / prm.Qb) : 0u;
  const BandLayout L = band_layout(NP, USED, nv, R, Qc, prm.staged);
  float4* s_taps = reinterpret_cast<float4*>(band_smem + L.taps);
  float* s_live = reinterpret_cast<float*>(band_smem + L.live);
  __nv_bfloat16* s_t1 = reinterpret_cast<__nv_bfloat16*>(band_smem + L.t1);
  int* s_lohi = reinterpret_cast<int*>(band_smem + L.lohi);
  __nv_bfloat16* s_dv = reinterpret_cast<__nv_bfloat16*>(band_smem + L.dv);
  const int live_len = band_live_len(Qc, R);
  const size_t dv_slot = (size_t)R * Qc * CS;

  for (int i = tid; i < RANGE_SLOTS * 2 * nv; i += nthreads)
    s_lohi[i] = (i / nv) & 1 ? -1 : INT_MAX;
  const MarchTables tb = load_band_tables(band_smem + L.tables, prm, p0 / prm.Pb, tid,
                                          nthreads);

  // the texel's constants: SH basis, norm, state cotangent
  const size_t plane = (size_t)Pn * Qn;
  const size_t pix = (size_t)p * Qn + (valid ? q : 0);
  float yb[NCOEFF];
  const float nm = texel_basis<NCOEFF, true>(prm.ybasis, prm.norm, nullptr, pix, plane,
                                             0.0f, 0.0f, 0, 0, 0.0f, yb);
  const StateCotangent g = load_cotangent<DIFFUSE>(prm.gaux + pix, plane);

  // this CTA's share of the rows v of the fold and of the zero rows
  const int nvs = (nv + S - 1) / S;
  const int vbeg = min(rank * nvs, nv);
  const int nvm = min(nv, vbeg + nvs) - vbeg;
  const size_t cstride = (size_t)Pn * nv;  // dt1's channel stride
  const int n_fold = (C / 8) * R * nvm;   // (8-channel group, row, v) items
  // dead rows in 16-byte stores where the share's rows are 16-byte aligned
  const bool vec_rows = nv % 8 == 0 && nvm % 8 == 0 && vbeg % 8 == 0;
  const FastDiv by_nvm(max(nvm, 1)), by_R(R), by_row(max(vec_rows ? nvm / 8 : nvm, 1));
  const FastDiv by_nch(max(nv / 8, 1)), by_per_c(max(R * (nv / 8), 1)), by_Qb(prm.Qb);

  // position j's taps, liveness and band rows of t1 into ring slot k (every
  // thread), one commit group (empty past the last needed position)
  auto stage = [&](int j, int k) {
    if (j >= NP) {
      cp_async_commit();
      return;
    }
    const float4* src = prm.taps + (size_t)j * Qn + rank * Qc;
    float4* dst = s_taps + (k % TAP_SLOTS) * Qc;
    const int ncols = min(Qc, Qn - rank * Qc);  // a multiple of 32
    for (int i = tid; i < ncols; i += nthreads) cp_async16(dst + i, src + i);
    float* lv = s_live + (k % ROW_SLOTS) * live_len;
    for (int i = tid; i < ncols / 4; i += nthreads)
      cp_async16(lv + 4 * i, prm.live_v + (size_t)j * Qn + rank * Qc + 4 * i);
    if (tid < R) cp_async4(lv + Qc + tid, prm.live_u + (size_t)j * Pn + p0 + tid);
    if (prm.staged) {
      const int nch = nv / 8, per_c = R * nch;
      __nv_bfloat16* d = s_t1 + (size_t)(k % ROW_SLOTS) * USED * R * nv;
      const __nv_bfloat16* t1j = prm.t1 + j * prm.sj + p0 * prm.sp;
      for (int i = tid; i < USED * per_c; i += nthreads) {
        const int c = by_per_c.div(i), rem = i - c * per_c, rr = by_nch.div(rem),
                  e = rem - rr * nch;
        cp_async16(d + (c * R + rr) * nv + e * 8, t1j + c * prm.sc + rr * prm.sp + e * 8);
      }
    }
    cp_async_commit();
  };
  auto zero_rows = [&](int j) {
    __nv_bfloat16* o = prm.dt1 + (size_t)j * C * cstride + (size_t)p0 * nv + vbeg;
    const int w = vec_rows ? 8 : 1, n = C * R * (nvm / w);
    for (int i = tid; i < n; i += nthreads) {
      const int rest = by_row.div(i), e = i - rest * by_row.d, c = by_R.div(rest),
                rr = rest - c * R;
      __nv_bfloat16* d = o + c * cstride + (size_t)rr * nv + e * w;
      if (vec_rows)
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      else
        *d = __float2bfloat16_rn(0.0f);
    }
  };
  // the dead positions (zero rows): their cursor and count, and the folds
  // left to spread their stores over
  auto next_dead = [&](int j) {
    for (++j; j < NP && tb.pos_needed[j]; ++j) {
    }
    return j;
  };
  int j_dead = next_dead(-1), folds_left = 0;
  for (int j = 0; j < NP; ++j) folds_left += tb.pos_needed[j] != 0;
  int dead_left = NP - folds_left;

  // s[e] += w(q, v) * dvals[group channel e, row rr, q] over the columns q
  // = qa .. qz in ascending q (the columns of one or more ranks), in ring
  // slot kf
  auto sum_columns = [&](int kf, int v, int rr, int grp, int qa, int qz, float* s) {
    const float4* taps = s_taps + (kf % TAP_SLOTS) * Qc;
    const __nv_bfloat16* dvk = s_dv + (kf % DV_SLOTS) * dv_slot;
    for (int rq = qa / Qc; qa <= qz && rq <= qz / Qc; ++rq) {  // one rank's columns
      const int q0 = rq * Qc;
      const float4* tk = in_rank(taps, rq, rank);
      const __nv_bfloat16* dv = in_rank(dvk, rq, rank) + (size_t)rr * Qc * CS + grp * 8;
      for (int qq = max(qa, q0) - q0; qq <= min(qz, q0 + Qc - 1) - q0; ++qq) {
        const float4 tp = tk[qq];
        const int v0 = __float_as_int(tp.x);
        const float w = v0 == v ? tp.y : (v0 + 1 == v ? tp.z : 0.0f);
        if (w != 0.0f) {
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(dv + (size_t)qq * CS), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) s[e] = s[e] + w * f[e];
        }
      }
    }
  };

  // position jf (ring slot kf): its rows v; items (group, row, v), v
  // fastest: lanes store consecutive v of a channel row. K7: each channel's
  // sum over v's columns in ascending q. K8: for each q-block that needs jf,
  // a partial over the block's columns of v's range, the partials added in
  // ascending block order, as the three-launch fold adds them over every
  // needed block: a needed block with no column in the range adds a +0
  // partial there, which leaves the sum's bits as they are (no partial is
  // -0). Then the zero rows of a share of the dead positions, so that their
  // stores spread over the march.
  auto fold = [&](int jf, int kf) {
    const int* lohi = s_lohi + (kf % RANGE_SLOTS) * 2 * nv;
    __nv_bfloat16* o = prm.dt1 + (size_t)jf * C * cstride + (size_t)p0 * nv + vbeg;
    for (int i = tid; i < n_fold; i += nthreads) {
      const int rest = by_nvm.div(i), vl = i - rest * nvm, grp = by_R.div(rest),
                rr = rest - grp * R;
      const int v = vbeg + vl;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
      if (grp < NG) {
        const int lo = lohi[v], hi = lohi[nv + v];
        if constexpr (QSPLIT) {
          const unsigned need = tb.pos_needed[jf];  // the q-blocks that flushed jf
          bool first = true;
          for (int b = by_Qb.div(lo); lo <= hi && b <= by_Qb.div(hi); ++b) {
            if (!((need >> b) & 1u)) continue;  // a q-block that skips jf adds nothing
            float part[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) part[e] = 0.0f;
            sum_columns(kf, v, rr, grp, max(lo, b * prm.Qb), min(hi, b * prm.Qb + prm.Qb - 1),
                        part);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e] = first ? part[e] : acc[e] + part[e];
            first = false;
          }
        } else {
          sum_columns(kf, v, rr, grp, lo, hi, acc);
        }
      }
      __nv_bfloat16* out = o + (size_t)grp * 8 * cstride + (size_t)rr * nv + vl;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e * cstride] = __float2bfloat16_rn(grp * 8 + e < USED ? acc[e] : 0.0f);
    }
    for (int n = (dead_left + folds_left - 1) / folds_left; n > 0; --n, --dead_left) {
      zero_rows(j_dead);
      j_dead = next_dead(j_dead);
    }
    --folds_left;
  };

  int k = 0;  // ring slot of the next replayed position
  int j_ahead = next_needed(tb, -1, NP);  // the position in ring slot k + 1
  stage(j_ahead, 0);
  j_ahead = next_needed(tb, j_ahead, NP);
  stage(j_ahead, 1);
  cp_async_wait_one();
  band_sync(S);  // every CTA of the cluster runs and has its first slot
  float T = 1.0f, Sp = 0.0f;
  PosValues prev{};
  PosCotangent pend{};  // the b-side cotangents of the last cell
  int j_fold = -1, k_fold = 0;  // a position flushed in the last phase and its slot
  int k_clear = -1;  // the slot folded in the last phase: its ranges are cleared in this one

  // NP + 1 steps, as march_backward: step j composites cell (j-1, j) and
  // flushes position j-1 (slot k - 1); a step that does either for some
  // q-block of the band is a phase. The texel takes it under its own
  // block's flags (my_replay, my_flush), as march_backward over that block.
  for (int j = 0; j <= NP; ++j) {
    const bool replay = j < NP && tb.pos_needed[j];
    const bool flush = j > 0 && tb.pos_needed[j - 1];
    if (!replay && !flush) {  // uniform over the cluster
      pend = PosCotangent{};
      continue;
    }
    const bool my_replay = replay && (QSPLIT ? (tb.pos_needed[j] & mine) != 0 : valid);
    const bool my_flush = flush && (QSPLIT ? (tb.pos_needed[j - 1] & mine) != 0 : valid);
    if (k_clear >= 0) {
      for (int i = tid; i < 2 * nv; i += nthreads)
        s_lohi[(k_clear % RANGE_SLOTS) * 2 * nv + i] = i < nv ? INT_MAX : -1;
      k_clear = -1;
    }
    PosValues cur{};
    const float* G = tb.geom + (j < NP ? j : NP - 1) * GEOM_COLS;
    if (replay) {  // slot k landed before the last barrier
      if (r == 0) {
        // the column range of each row v over the whole frame: this CTA's
        // column ql of every cluster rank (order-free min / max), from the
        // lanes that start (min) or end (max) a run of equal rows in their
        // warp; a row's first tap (w0, NaN if not a tent) and its second (w1)
        int* lo = s_lohi + (k % RANGE_SLOTS) * 2 * nv;
        const int lane = threadIdx.x & 31;
        for (int s = 0; s < S; ++s) {
          const int qs = s * Qc + ql;
          int a = -1, b = -1;
          if (qs < Qn) {
            const float4 tp = in_rank(s_taps + (k % TAP_SLOTS) * Qc, s, rank)[ql];
            if (tp.y != 0.0f) {
              a = __float_as_int(tp.x);
              if (tp.z != 0.0f) b = a + 1;
            }
          }
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int x = t ? b : a;
            const int before = __shfl_up_sync(FULL_MASK, x, 1);
            const int after = __shfl_down_sync(FULL_MASK, x, 1);
            if (x >= 0 && (lane == 0 || before != x)) atomicMin(lo + x, qs);
            if (x >= 0 && (lane == 31 || after != x)) atomicMax(lo + nv + x, qs);
          }
        }
      }
      if (my_replay) {
        const float4 tp = s_taps[(k % TAP_SLOTS) * Qc + ql];
        const __nv_bfloat16* row;
        long long rsc;
        if (prm.staged) {
          row = s_t1 + (size_t)(k % ROW_SLOTS) * USED * R * nv + r * nv;
          rsc = (long long)R * nv;
        } else {
          row = prm.t1 + j * prm.sj + p * prm.sp;
          rsc = prm.sc;
        }
        const float* lv = s_live + (k % ROW_SLOTS) * live_len;
        cur.live = lv[Qc + r] * lv[ql];
        two_tap_values<NCOEFF>(row, rsc, tp, nv, yb, cur.sig, cur.rgb, cur.dif);
      }
    }

    // cell (j-1, j): its a-side cotangents for position j-1 and its b-side
    // ones, pending for position j
    PosCotangent da{}, db{};
    if (my_replay && j > 0 && (QSPLIT ? tb.cell_live[j] & mine : tb.cell_live[j]) != 0)
      backward_cell<DIFFUSE, RELU>(G, nm, g, prev, cur, T, Sp, da, db);
    if (my_flush) {
      PosCotangent d;
      d.sig = pend.sig + da.sig;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d.rgb[c] = pend.rgb[c] + da.rgb[c];
        d.dif[c] = pend.dif[c] + da.dif[c];
      }
      uint4* dst = reinterpret_cast<uint4*>(s_dv + ((k - 1) % DV_SLOTS) * dv_slot +
                                            (size_t)tid * CS);  // tid = r Qc + ql
#pragma unroll
      for (int grp = 0; grp < NG; ++grp) {
        float f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ch = grp * 8 + i;
          f[i] = ch < USED ? flush_channel<NCOEFF, DIFFUSE>(ch, yb, d) : 0.0f;
        }
        dst[grp] = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                              pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
      }
    }
    pend = db;
    if (my_replay) prev = cur;

    if (j_fold >= 0) {
      fold(j_fold, k_fold);
      k_clear = k_fold;
    }
    j_fold = flush ? j - 1 : -1;
    k_fold = k - 1;  // position j-1's slot: the last one replayed
    if (replay) {  // two needed positions ahead
      j_ahead = next_needed(tb, j_ahead, NP);
      stage(j_ahead, k + 2);
      ++k;
    }
    // the next slot's copies landed (issued a phase ago); the phase's
    // cotangents, ranges and folds are complete cluster-wide
    cp_async_wait_one();
    band_sync(S);
  }
  if (j_fold >= 0) {
    fold(j_fold, k_fold);
    if (S > 1) band_sync(S);  // no CTA leaves while another reads its cotangents
  }
  for (; dead_left > 0; --dead_left) {  // a band with no needed position
    zero_rows(j_dead);
    j_dead = next_dead(j_dead);
  }
}

template <int NCOEFF, bool DIFFUSE, bool RELU, bool QSPLIT>
int launch_band(const BandParams& prm, size_t smem, cudaStream_t stream) {
  auto kern = stripe_band_kernel<NCOEFF, DIFFUSE, RELU, QSPLIT>;
  static size_t smem_allowed[16] = {};
  const cudaError_t e = allow_smem(kern, smem, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(prm.S, prm.Pn / prm.R);
  cfg.blockDim = dim3(prm.R * prm.Qc);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = prm.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = prm.S > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kern, prm);
}

template <int NCOEFF, bool QSPLIT>
int dispatch_band(const BandParams& prm, size_t smem, int with_diffuse, int relu,
                  cudaStream_t s) {
  if (with_diffuse)
    return relu ? launch_band<NCOEFF, true, true, QSPLIT>(prm, smem, s)
                : launch_band<NCOEFF, true, false, QSPLIT>(prm, smem, s);
  return relu ? launch_band<NCOEFF, false, true, QSPLIT>(prm, smem, s)
              : launch_band<NCOEFF, false, false, QSPLIT>(prm, smem, s);
}

template <int NCOEFF>
int dispatch_band(const BandParams& prm, size_t smem, int with_diffuse, int relu,
                  cudaStream_t s) {
  return prm.QB > 1 ? dispatch_band<NCOEFF, true>(prm, smem, with_diffuse, relu, s)
                    : dispatch_band<NCOEFF, false>(prm, smem, with_diffuse, relu, s);
}

}  // namespace

// K7 / K8 past the band kernel's reach: three launches on one stream: the
// column taps (``taps`` [NP, Qn] float4 and ``q_lo`` / ``q_hi`` [NP, nv],
// preset to INT_MAX / -1 by the caller), the march (only the slots of needed
// blocks of ``dvals``) and the fold, which writes every element of dt1. The
// design K7 (QB = 1, Qb = Qn) and K8 ran before composite_stripe_band_launch.
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

// K7 (QB = 1) and K8 (QB q-blocks of Qb columns, QB <= 32; flags [PB, QB,
// NP]): the column taps (``taps`` [NP, Qn] float4), then the band kernel
// with cluster size S, R rows and Qc columns a CTA, t1 staged or read from
// device memory, ``smem`` bytes of shared memory (stripe_band_plan; the
// layout is checked against band_layout). Writes every element of dt1.
extern "C" int composite_stripe_band_launch(
    const void* t1, long long sj, long long sc, long long sp, const void* rvt, void* taps,
    const float* live_u, const float* live_v, const float* geom, const int* cell_live,
    const int* pos_needed, const float* ybasis, const float* norm, const float* gaux,
    void* dt1, int ncoeff, int with_diffuse, int relu, int NP, int C, int nv, int Pn, int Qn,
    int Pb, int QB, int Qb, int S, int R, int Qc, int staged, long long smem, void* stream) {
  const int used = 3 * ncoeff + 1;
  const bool aligned = (uintptr_t)t1 % 16 == 0 && sj % 8 == 0 && sc % 8 == 0 &&
                       sp % 8 == 0 && nv % 8 == 0;
  if ((uintptr_t)live_v % 16 != 0 || (uintptr_t)taps % 16 != 0 || Qn % 32 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (S < 1 || S > 8 || R < 1 || Pb % R != 0 || Pn % Pb != 0 || (long long)S * Qc < Qn ||
      (long long)(S - 1) * Qc >= Qn || R * Qc > BAND_MAX_THREADS || Qc % 32 != 0 ||
      (S == 1 && Qc != Qn) || (staged && !aligned) || used > C || QB < 1 ||
      QB > BAND_MAX_QBLOCKS || QB * Qb != Qn ||
      (size_t)smem != band_layout(NP, used, nv, R, Qc, staged).total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 tgrid((Qn + 127) / 128, NP);
  column_taps_kernel<<<tgrid, 128, 0, s>>>(reinterpret_cast<const __nv_bfloat16*>(rvt),
                                           reinterpret_cast<float4*>(taps), nullptr,
                                           nullptr, NP, nv, Qn);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const BandParams prm{reinterpret_cast<const __nv_bfloat16*>(t1), sj, sc, sp,
                       reinterpret_cast<const float4*>(taps), live_u, live_v, geom,
                       cell_live, pos_needed, ybasis, norm, gaux,
                       reinterpret_cast<__nv_bfloat16*>(dt1), NP, C, Pn, Qn, nv, Pb,
                       QB, Qb, S, R, Qc, staged};
  switch (ncoeff) {
    case 1: return dispatch_band<1>(prm, (size_t)smem, with_diffuse, relu, s);
    case 4: return dispatch_band<4>(prm, (size_t)smem, with_diffuse, relu, s);
    case 9: return dispatch_band<9>(prm, (size_t)smem, with_diffuse, relu, s);
    case 16: return dispatch_band<16>(prm, (size_t)smem, with_diffuse, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
