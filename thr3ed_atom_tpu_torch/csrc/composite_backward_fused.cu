// composite_backward_fused: the replay VJP of the fused composite
// (composite_fused.cu) with respect to the position slices.
//
// Replaces the TPU kernel thr3ed_atom_tpu/rendering/gnomonic_train.py
// _composite_backward_fused (kernel _make_backward_kernel_fused). That kernel
// runs positions outermost with the whole frame's carries in VMEM, folds each
// q-block's cotangents through the v-tents with an MXU product inside the
// march (dt1 accumulated in VMEM) and then dt1 through the u-tents with a
// second bf16 product. Here the work is split in two launches:
//
// 1. march (a TP x TQ texel tile per block, one thread per texel, positions
//    j = 0 .. NP in an inner loop; march_backward_staged in
//    gnomonic_stage.cuh): replays position j exactly as the forward computed
//    it, over the same staged footprint (cp.async ring, shared lerp and
//    u-resample), rebuilds T and the running prefix S and takes each cell's
//    VJP in the reference's division-free suffix form (backward_cell,
//    gnomonic_march.cuh). Position j-1's per-channel cotangent, folded
//    through the SH basis and rounded to bf16 as the reference rounds it
//    before the v-fold, goes to shared memory; warp r then folds row r
//    through position j-1's v-tents on the tensor cores (VFold: mma.sync
//    m16n8k16 of the [channels, 32 columns] cotangents by the bf16
//    [32 columns, v lines] tent weights, f32 accumulation), for the v lines
//    that the tile's taps reach. A line no other tile reaches is complete:
//    rounded to bf16 it goes to the position's dense dt1 rows [Pb, USED, nv]
//    of the u-block (one slot per (u-block, position) with a needed
//    q-block). The up to two edge lines on each side go, f32, to the tile's
//    edge record [USED, TP, 4] (one slot per needed (u-block, q-block,
//    position)). Both are sized by the occupancy flags.
// 2. u-fold (one block per (position, 16 u lines), over chunks of 256
//    (channel, v) columns; ufold_kernel): dt1[p, c, v] -- read from the
//    dense rows, or for an edge line bf16(sum of its partials over the tiles
//    that reach it, in ascending tile order): the reference's q-summed dt1,
//    rounded once -- staged in shared memory 32 rows at a time, and
//    dslices[j, u, c, v] = bf16(sum_p w_u(p, u) dt1[p, c, v])
//    as bf16 mma.sync m16n8k16 products with f32 accumulation (the
//    reference's w_uT @ dt1 on the MXU), over only the rows inside the
//    u lines' tents. The bf16 tent weights are built in the kernel. Pad
//    channels and dead positions come out zero.
//
// Bound on the H100: memory. The march re-reads the forward's vertex records
// (staged once per tile and position, as the forward) and writes dt1 (2
// bytes per (row, channel, v line) of a needed u-block) and the edge records
// (64 bytes per (channel, row) of a needed tile); the u-fold reads those
// about once (the tents of neighbouring 16-line u tiles share a few rows)
// and writes the [NP, nu, C, nv] bf16 dslices once. No per-texel
// cotangent leaves a block and no sum takes atomics, so the result does not
// change from run to run. Built with -fmad=false: the replay rounds as the
// forward and the plain version; the tent sums run in another (fixed) order
// than the reference's matmuls, which moves only f32 round-off before a
// bf16 rounding.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gnomonic_stage.cuh"

namespace {

using namespace gnomonic;

struct MarchParams {
  const uint4* vert;      // [nvert, nu, nv, C] bf16
  const float* geom;      // [NP, 8]
  const int* cell_live;   // [PB, QB, NP]
  const int* pos_needed;  // [PB, QB, NP]
  const long long* d_off;  // [PB, NP]: dt1 rows of a u-block with a needed position, else -1
  const long long* s_off;  // [PB, QB, NP]: first edge record of a needed block, else -1
  const float* ybasis;    // [ncoeff, Pn, Qn]
  const float* norm;      // [Pn, Qn]
  const float* gaux;      // [SROWS + 2, Pn, Qn]: gstate rows, S_total, T_final
  __nv_bfloat16* dt1;     // dense dt1 rows
  float* edge;            // edge records
  int* direct_tiles;      // tiles that took the direct gather (or NULL)
  int NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb, QB;
  StageSize stage;  // set at launch (Stage::fit)
};

// The march's shared memory after the stage: this tile's dt1 and edge
// offsets [NP] each, the v-fold buffers and the tables. The stage asks for
// the small size (the replay marches every tile of a training view) and gets
// what these leave (Stage::fit).
template <int NCOEFF>
inline size_t march_rest_bytes(int NP) {
  return (size_t)2 * NP * sizeof(long long) + VFold<NCOEFF>::bytes() +
         march_tables_bytes(NP, false);
}

template <int NCOEFF, bool DIFFUSE, bool RELU>
__global__ void __launch_bounds__(TP * TQ) backward_march_kernel(MarchParams prm) {
  constexpr int USED = 3 * NCOEFF + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int p0 = blockIdx.y * TP, q0 = blockIdx.x * TQ;
  const int p = p0 + threadIdx.y, q = q0 + threadIdx.x;
  const int pb = p0 / prm.Pb;
  const int qb = q0 / prm.Qb;
  const int tid = threadIdx.y * TQ + threadIdx.x;
  const size_t flag_base = ((size_t)pb * prm.QB + qb) * prm.NP;
  const int NP = prm.NP;

  const Stage<NCOEFF> sm(smem, prm.stage);
  long long* s_doff = reinterpret_cast<long long*>(smem + Stage<NCOEFF>::bytes(prm.stage));
  long long* s_soff = s_doff + NP;
  unsigned char* rest = reinterpret_cast<unsigned char*>(s_soff + NP);
  VFold<NCOEFF> vf;
  vf.d = reinterpret_cast<__nv_bfloat16*>(rest);
  vf.v0 = reinterpret_cast<float*>(vf.d + TP * USED * VFold<NCOEFF>::DSTRIDE);
  vf.w0 = vf.v0 + TP * TQ;
  vf.w1 = vf.w0 + TP * TQ;
  unsigned char* tables = reinterpret_cast<unsigned char*>(vf.w1 + TP * TQ);
  // this tile's rows in the u-block's dt1 slot, and its edge record inside
  // its block's slot: blocks hold (Pb / TP) x (Qb / TQ) tiles, row-band major
  const long long row0 = (long long)(p0 - pb * prm.Pb) * USED * prm.nv;
  const long long tile_in_blk =
      (long long)((p0 - pb * prm.Pb) / TP) * (prm.Qb / TQ) + (q0 - qb * prm.Qb) / TQ;
  for (int i = tid; i < NP; i += TP * TQ) {
    const long long d = prm.d_off[(size_t)pb * NP + i], e = prm.s_off[flag_base + i];
    s_doff[i] = d < 0 ? -1 : d + row0;
    s_soff[i] = e < 0 ? -1 : e + tile_in_blk * USED * TP * EDGE_SLOTS;
  }
  const MarchTables tb = load_tables(tables, prm.geom, prm.cell_live, prm.pos_needed, nullptr,
                                     flag_base, NP, tid, TP * TQ);  // ends with a barrier
  vf.d_off = s_doff;
  vf.s_off = s_soff;
  vf.dt1 = prm.dt1;
  vf.edge = prm.edge;

  const TexelAt x{p0, q0, (int)threadIdx.y, (int)threadIdx.x, tid, (float)p, (float)q};
  const size_t plane = (size_t)prm.Pn * prm.Qn;
  const size_t pix = (size_t)p * prm.Qn + q;
  float yb[NCOEFF];
  const float nm = texel_basis<NCOEFF, true>(prm.ybasis, prm.norm, nullptr, pix, plane, x.pf,
                                             x.qf, 0, 0, 0.0f, yb);
  const VertexStack vs{prm.vert, prm.nvert, prm.nu, prm.nv, prm.C, prm.P};
  const bool direct = march_backward_staged<NCOEFF, DIFFUSE, RELU>(
      vs, sm, vf, tb, NP, nm, yb, prm.gaux + pix, plane, x);
  if (direct && tid == 0 && prm.direct_tiles != nullptr) atomicAdd(prm.direct_tiles, 1);
}

struct UFoldParams {
  const __nv_bfloat16* dt1;  // dense dt1 rows
  const float* edge;         // edge records
  const long long* d_off;    // [PB, NP]
  const long long* s_off;    // [PB, QB, NP]
  const float* geom;         // [NP, 8]
  __nv_bfloat16* dsl;        // [NP, nu, C, nv]
  int NP, nu, nv, C, used, Pn, Qn, Pb, Qb, QB;
};

constexpr int UF_WARPS = 8;
constexpr int UF_NT = 4;                       // n8 tiles per warp
constexpr int UF_N = UF_WARPS * UF_NT * 8;     // (channel, v) columns per chunk: one a thread
constexpr int UF_M = 16;                       // u lines per block
constexpr int UF_K = 32;                       // rows per product step (two k16 products)
constexpr int UF_KPAD = 40;                    // staged row stride (bf16): no bank conflicts

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

__host__ __device__ inline size_t ufold_smem_bytes(int Qn, int nv, int PB, int QB) {
  return (size_t)UF_N * UF_KPAD * sizeof(__nv_bfloat16) +
         (size_t)(PB * QB + PB) * sizeof(long long) +
         ((size_t)2 * (Qn / TQ) + 3 * nv + UF_N + UF_WARPS) * sizeof(int);
}

// One block per (position j, 16 u lines): the tables of the position once,
// then (channel, v) chunks of UF_N columns, one a thread.
__global__ void __launch_bounds__(UF_WARPS * 32) ufold_kernel(UFoldParams prm) {
  extern __shared__ __align__(16) unsigned char uf_smem[];
  const int j = blockIdx.y, u0 = blockIdx.x * UF_M;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int nv = prm.nv, nvp = (nv + 7) / 8 * 8, QT = prm.Qn / TQ;
  const int PB = prm.Pn / prm.Pb, QB = prm.QB, NP = prm.NP, used = prm.used;
  const int n_cols = prm.C * nvp;
  const float* G = prm.geom + (size_t)j * 8;
  const float bu = G[2], ku = G[3], bv = G[4], kv = G[5];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(uf_smem);  // [UF_N, UF_KPAD]
  long long* b_soff = reinterpret_cast<long long*>(Bs + UF_N * UF_KPAD);  // [PB, QB]
  long long* b_doff = b_soff + PB * QB;                                  // [PB]
  int* t_lo = reinterpret_cast<int*>(b_doff + PB);                       // [QT]
  int* t_cnt = t_lo + QT;                                                // [QT]
  int* v_ta = t_cnt + QT;  // [nv]: first tile that reaches v
  int* v_tz = v_ta + nv;   // [nv]: last
  int* v_own = v_tz + nv;  // [nv]: 1 where v is a line only one tile reaches
  int* e_cols = v_own + nv;      // [UF_N]: the chunk's edge columns
  int* e_warp = e_cols + UF_N;   // [UF_WARPS]: edge columns per warp

  bool any = false;
  for (int i = tid; i < PB * QB; i += UF_WARPS * 32) {
    b_soff[i] = prm.s_off[(size_t)i * NP + j];
    any = any || b_soff[i] >= 0;
  }
  for (int i = tid; i < PB; i += UF_WARPS * 32) b_doff[i] = prm.d_off[(size_t)i * NP + j];
  for (int t = tid; t < QT; t += UF_WARPS * 32)
    tap_lines(bv + kv * (float)(t * TQ), bv + kv * (float)(t * TQ + TQ - 1), nv, t_lo[t],
              t_cnt[t]);
  // rows whose u-tents reach a line of the block: U is affine in p, so its
  // range over the frame decides whether any does
  const float Ua = bu, Uz = bu + ku * (float)(prm.Pn - 1);
  const bool reach = fmaxf(Ua, Uz) > (float)u0 - 1.0f && fminf(Ua, Uz) < (float)(u0 + UF_M);
  const bool work = __syncthreads_or(any) && reach;  // else: zeros
  if (work) {
    // for each v line the first and last tile whose tap lines hold it, and
    // whether it is inside the one tile's lines (the march wrote it to dt1)
    // or on their edges (the march wrote partials)
    for (int v = tid; v < nv; v += UF_WARPS * 32) {
      int ta = QT, tz = -1;
      for (int t = 0; t < QT; ++t) {
        if (v >= t_lo[t] && v < t_lo[t] + t_cnt[t]) {
          ta = min(ta, t);
          tz = t;
        }
      }
      v_ta[v] = ta;
      v_tz[v] = tz;
      v_own[v] = ta == tz && v >= t_lo[ta] + 2 && v <= t_lo[ta] + t_cnt[ta] - 3;
    }
    __syncthreads();
  }
  const int tiles_q = prm.Qb / TQ;
  int pa, pz, pa2, pz2;
  tent_range(bu, ku, (float)u0, prm.Pn, pa, pz);
  tent_range(bu, ku, (float)min(u0 + UF_M - 1, prm.nu - 1), prm.Pn, pa2, pz2);
  const int p_lo = min(pa, pa2), p_hi = max(pz, pz2);

  for (int n0 = 0; n0 < n_cols; n0 += UF_N) {
    float acc[UF_NT][4];
#pragma unroll
    for (int nt = 0; nt < UF_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    if (work) {
      // this thread's column n0 + tid: (c, v), and whether the march wrote
      // its line to dt1 (own; the owner tile in block column own_qb) or to
      // edge records (listed in e_cols, for the edge pass below)
      const int n = n0 + tid, c = n / nvp, v = n - c * nvp;
      const int vc = min(v, nv - 1);
      const bool ok = c < used && v < nv && v_ta[vc] <= v_tz[vc];
      const bool own = ok && v_own[vc], edge = ok && !v_own[vc];
      const int own_qb = v_ta[vc] / tiles_q;
      const unsigned ballot = __ballot_sync(FULL_MASK, edge);
      if (lane == 0) e_warp[warp] = __popc(ballot);
      __syncthreads();
      int base = 0, n_edge = 0;
      for (int w = 0; w < UF_WARPS; ++w) {
        base += w < warp ? e_warp[w] : 0;
        n_edge += e_warp[w];
      }
      if (edge) e_cols[base + __popc(ballot & ((1u << lane) - 1))] = tid;
      for (int pk = p_lo; pk <= p_hi; pk += UF_K) {
        // own lines: the step's dt1 values, every load in flight before the
        // stores; edge and empty columns stage zero here
        __nv_bfloat16 vals[UF_K];
#pragma unroll
        for (int kk = 0; kk < UF_K; ++kk) {
          const int p = pk + kk;
          const int pb = p / prm.Pb, pl = p - pb * prm.Pb;
          vals[kk] = __float2bfloat16_rn(0.0f);
          if (own && p <= p_hi && b_soff[pb * QB + own_qb] >= 0)  // a dead block's rows are zero
            vals[kk] = __ldg(prm.dt1 + b_doff[pb] + ((long long)pl * used + c) * nv + v);
        }
        __syncthreads();  // the previous step's products have read Bs (and e_cols is in)
        if (!edge)  // an edge column is the edge pass's
#pragma unroll
          for (int kk = 0; kk < UF_K; ++kk) Bs[tid * UF_KPAD + kk] = vals[kk];
        // edge lines, a warp per column and a lane per row: bf16 of the
        // line's partial sums over the tiles that reach it, in ascending tile
        // order (a dead block adds nothing; one or two tiles but in a frame
        // where a tile spans under two v lines)
        {
          const int p = pk + lane;
          const bool row = p <= p_hi;
          const int pb = p / prm.Pb, pl = p - pb * prm.Pb, r = p % TP, band = pl / TP;
          const long long* soff = b_soff + min(pb, PB - 1) * QB;
#pragma unroll 4
          for (int i = warp; i < n_edge; i += UF_WARPS) {
            const int col = e_cols[i], ec = (n0 + col) / nvp, ev = n0 + col - ec * nvp;
            const int ta = v_ta[ev], tz = v_tz[ev];
            float x[2] = {0.0f, 0.0f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = ta + h, qb = t / tiles_q;
              if (row && t <= tz && soff[qb] >= 0) {
                const int lo = t_lo[t], hi = lo + t_cnt[t] - 1;
                const int slot = ev - lo <= 1 ? ev - lo : ev - hi + 3;
                x[h] = __ldg(prm.edge + soff[qb] +
                             ((((long long)band * tiles_q + (t - qb * tiles_q)) * used + ec) *
                                  TP + r) * EDGE_SLOTS + slot);
              }
            }
            float sum = 0.0f + x[0] + x[1];
            for (int t = ta + 2; row && t <= tz; ++t) {
              const int qb = t / tiles_q;
              if (soff[qb] < 0) continue;
              const int lo = t_lo[t], hi = lo + t_cnt[t] - 1;
              const int slot = ev - lo <= 1 ? ev - lo : ev - hi + 3;
              sum = sum + __ldg(prm.edge + soff[qb] +
                                ((((long long)band * tiles_q + (t - qb * tiles_q)) * used + ec) *
                                     TP + r) * EDGE_SLOTS + slot);
            }
            Bs[col * UF_KPAD + lane] = __float2bfloat16_rn(sum);
          }
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < UF_K / 16; ++ks) {
          // A: the bf16 u-tent weights w(p, u), rows u0 + grp (+ 8), columns
          // pk + 16 ks + 2 tig (+ 1, + 8, + 9)
          uint32_t a[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float uf = (float)(u0 + grp + (h & 1) * 8);
            const int pc = pk + ks * 16 + tig * 2 + (h >> 1) * 8;
            a[h] = pack_bf16x2(tent(bu + ku * (float)pc, uf),
                               tent(bu + ku * (float)(pc + 1), uf));
          }
#pragma unroll
          for (int nt = 0; nt < UF_NT; ++nt) {
            const __nv_bfloat16* b =
                Bs + ((warp * UF_NT + nt) * 8 + grp) * UF_KPAD + ks * 16 + tig * 2;
            mma_16816(acc[nt], a, *reinterpret_cast<const uint32_t*>(b),
                      *reinterpret_cast<const uint32_t*>(b + 8));
          }
        }
      }
      __syncthreads();  // e_cols and e_warp are rewritten by the next chunk
    }
    // C fragments: rows u0 + grp (+ 8), columns 2 tig, 2 tig + 1 of each n8
    // tile: one bf16 pair (nvp is a multiple of 8, so a pair shares c)
#pragma unroll
    for (int nt = 0; nt < UF_NT; ++nt) {
      const int n = n0 + (warp * UF_NT + nt) * 8 + tig * 2;
      const int c = n / nvp, v = n - c * nvp;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = u0 + grp + h * 8;
        if (u >= prm.nu || c >= prm.C || v >= nv) continue;
        __nv_bfloat16* o = prm.dsl + (((size_t)j * prm.nu + u) * prm.C + c) * nv + v;
        if (v + 1 < nv && ((reinterpret_cast<size_t>(o) & 3) == 0))
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
        else {
          o[0] = __float2bfloat16_rn(acc[nt][2 * h]);
          if (v + 1 < nv) o[1] = __float2bfloat16_rn(acc[nt][2 * h + 1]);
        }
      }
    }
  }
}

// The stage a march of NP positions takes: what its tables and v-fold
// scratch leave of the block's opt-in shared memory (Stage::fit).
template <int NCOEFF>
StageSize fitted_stage(int NP) {
  return Stage<NCOEFF>::fit((long long)smem_optin() - (long long)march_rest_bytes<NCOEFF>(NP));
}

template <int NCOEFF, bool DIFFUSE, bool RELU>
int launch_march(MarchParams prm, cudaStream_t stream) {
  prm.stage = fitted_stage<NCOEFF>(prm.NP);
  const size_t smem = Stage<NCOEFF>::bytes(prm.stage) + march_rest_bytes<NCOEFF>(prm.NP);
  auto kern = backward_march_kernel<NCOEFF, DIFFUSE, RELU>;
  static size_t smem_allowed[16] = {};
  const cudaError_t e = allow_smem(kern, smem, smem_allowed);
  if (e != cudaSuccess) return (int)e;
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

// Both launches on one stream: the march writes the dt1 rows and edge
// records of every needed (tile, position), the u-fold reads them and writes
// every element of dsl. d_off [PB, NP] and s_off [PB, QB, NP] come from the
// wrapper (fold_records in rendering/gnomonic_train.py); direct_tiles, when
// not NULL, gains one for every tile that gathered a position directly.
extern "C" int composite_backward_fused_launch(
    const void* vert, const float* geom, const int* cell_live,
    const int* pos_needed, const long long* d_off, const long long* s_off,
    const float* ybasis, const float* norm, const float* gaux, void* dt1, float* edge,
    void* dsl, int* direct_tiles, int ncoeff, int with_diffuse, int relu, int NP, int P,
    int nvert, int nu, int nv, int C, int Pn, int Qn, int Pb, int Qb, int QB, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  MarchParams mp{reinterpret_cast<const uint4*>(vert), geom, cell_live, pos_needed, d_off,
                 s_off, ybasis, norm, gaux, reinterpret_cast<__nv_bfloat16*>(dt1), edge,
                 direct_tiles, NP, P, nvert, nu, nv, C, Pn, Qn, Pb, Qb, QB,
                 StageSize{0, 0}};
  int err;
  switch (ncoeff) {
    case 1: err = dispatch<1>(mp, with_diffuse, relu, s); break;
    case 4: err = dispatch<4>(mp, with_diffuse, relu, s); break;
    case 9: err = dispatch<9>(mp, with_diffuse, relu, s); break;
    case 16: err = dispatch<16>(mp, with_diffuse, relu, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;

  UFoldParams fp{reinterpret_cast<const __nv_bfloat16*>(dt1), edge, d_off, s_off, geom,
                 reinterpret_cast<__nv_bfloat16*>(dsl), NP, nu, nv, C, 3 * ncoeff + 1,
                 Pn, Qn, Pb, Qb, QB};
  const size_t smem = ufold_smem_bytes(Qn, nv, Pn / Pb, QB);
  static size_t smem_allowed[16] = {};
  const cudaError_t e = allow_smem(ufold_kernel, smem, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nu + UF_M - 1) / UF_M, NP);
  ufold_kernel<<<grid, UF_WARPS * 32, smem, s>>>(fp);
  return (int)cudaGetLastError();
}

// The stage the march of a launch with these arguments takes: records of a
// ring stage and t1 lines into recs_lines[0], recs_lines[1].
extern "C" int composite_backward_fused_stage(int ncoeff, int NP, int* recs_lines) {
  StageSize z;
  switch (ncoeff) {
    case 1: z = fitted_stage<1>(NP); break;
    case 4: z = fitted_stage<4>(NP); break;
    case 9: z = fitted_stage<9>(NP); break;
    case 16: z = fitted_stage<16>(NP); break;
    default: return (int)cudaErrorInvalidValue;
  }
  recs_lines[0] = z.recs;
  recs_lines[1] = z.nvs;
  return 0;
}
