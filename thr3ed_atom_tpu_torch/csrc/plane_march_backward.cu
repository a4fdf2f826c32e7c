// plane_march_backward: the replay VJP of the plane-march render (K12) with
// respect to the repacked grid [XG, U, V, 256].
//
// Replaces the TPU kernel thr3ed_atom_tpu/ops/pallas/plane_march.py
// _backward_impl (kernel _make_backward_kernel). That kernel replays each
// tile's march with the forward's MXU product, carries the transmittance T and
// the prefix P of the cells' contributions across all cells and entries, takes
// the suffix S = totals - P from the forward outputs, forms per live cell
//   dI = delta ((1 - alpha) T <g, x> - <g, S>),
// splits it onto the cell's two positions by the closed-form dI/da, dI/db,
// lerps the colour cotangents back with (1 - tbar, tbar) (tbar held constant),
// rounds the channel cotangents d_interp to bf16 and adds W^T @ d_interp into
// an f32 cotangent with a read-modify-write DMA per entry (TPU grid steps run
// in order, so the adds are race-free).
//
// Here a block owns a tile and a thread a ray, replaying K11 bit for bit
// (plane_march.cuh) and stopping at the same entry. A position's cotangent is
// complete once the cells on both of its sides are done: position k takes
// dI_a of cell k and dI_b of cell k - 1. The (entry, position) loop is
// uniform over the tile: at step k of an entry, position k - 1 is complete,
// and neighbouring rays of the tile sample neighbouring points of that
// position's [16, 24] patch at once, so one global atomic a tap and channel
// has many rays add into the same few words, serialized at L2. The block
// sums the step's tap products bf16(W) * bf16(d_interp) (exact in f32) by
// patch cell first, as the TPU kernel's W^T @ d_interp does per entry (K10's
// design on the planes patch):
//   1. every ray whose position adds anything (a nonzero tap and channel
//      cotangent) writes its cotangents [CH] f32 and tap weights to shared
//      memory; the block's box of the rays' patch cells (ku, kv) goes to
//      shared memory (min / max);
//   2. a barrier on, each such ray files its id under its cell (a bucket of
//      BUCKET ids a cell, cells of the box in shared memory: an integer
//      atomic for its place);
//   3. a barrier on, a thread a vertex of the box sums the taps of the rays
//      in the vertex's four neighbouring cells (tap 3 - 2 du - dv of cell
//      (u - du, v - dv)) over all its channels and adds each 4 channels'
//      sums into the cotangent with one vector f32 atomic where any is
//      nonzero, in the position's own lane block; a barrier later the
//      buckets are cleared for the next step.
// A ray that adds nothing still reaches every barrier. The buckets hold
// plane_backward_plan's cells (ops/plane_march.py: all 17 x 25 cells a
// [16, 24] patch's taps have corners in, at R = 256): a step whose box holds
// more, and a ray that finds its cell's bucket full, add their taps into
// the cotangent directly (counted). On the planes blob pose 39x fewer
// global atomics than one a tap and channel (PERF.md §6). K10 keeps its own
// copy of steps 1-3 (a thread a vertex and 4 channels, two blocks an SM):
// every shared form measured slowed K10's pose by 5-9% (PERF.md §6). Blocks
// run in no order on the card, so the sums round in another order than the
// plain version's (f32 round-off before the caller's bf16 cast of the
// cotangent). Blocks take the tiles longest first (``tile_by_entries``), as
// K9 and K11 do.
//
// Bound on the H100: the bytes the function must move (what K11 reads, the
// forward totals and output cotangent, the f32 cotangent written), ~0.21 ms
// on the pose; the kernel takes ~1.0 ms there (PERF.md §6): a tile's
// position steps run one after another (a replay and three barriers each),
// and the pose's longest tile has 8.5x the mean entries. A thread sums all
// channels of a vertex (each ray's bucket entry read once). One block of
// 256 threads an SM at up to 255 registers (``__launch_bounds__(256, 1)``):
// at two blocks an SM it spilled and ran ~20% slower. Built with
// -fmad=false.
#include <climits>
#include <cuda_runtime.h>

#include "plane_march.cuh"
#include "smem_limit.cuh"

namespace {

using namespace planes;

constexpr int BUCKET = 16;  // ray ids a cell holds at a step

// shared-memory bytes of a block of R rays with ``cells`` bucket cells and
// ch channels a ray: cotangents [R, ch] f32, tap weights [R] float4, cell
// counts [cells] and buckets [cells, BUCKET] int
__host__ __device__ inline size_t sums_smem_bytes(int R, int ch, int cells) {
  return (size_t)R * ch * sizeof(float) + (size_t)R * sizeof(float4) +
         (size_t)cells * (1 + BUCKET) * sizeof(int);
}

// A ray's taps at a step: their bf16 weights (tap tu * 2 + tv) and the patch
// cell (ku, kv) whose corners they are (``slab::Sample``'s).
struct Taps {
  float w[4];
  int ku, kv;
  __device__ __forceinline__ static Taps of(const slab::Sample& s) {
    return Taps{{s.w[0], s.w[1], s.w[2], s.w[3]}, s.ku, s.kv};
  }
  __device__ __forceinline__ bool any() const {
    return w[0] != 0.0f || w[1] != 0.0f || w[2] != 0.0f || w[3] != 0.0f;
  }
};

__device__ __forceinline__ float tap_of(const float4& w, int k) {
  return k == 0 ? w.x : (k == 1 ? w.y : (k == 2 ? w.z : w.w));
}

// The block's sums (every thread of the block constructs it and calls each
// method, uniformly), in the block's dynamic shared memory (sums_smem_bytes)
// and the kernel's static ``box`` [3][4] and ``s_stats`` [4]. The shared
// arrays' addresses are taken from the shared-memory symbol at each use.
template <int NUSED>
struct TapSums {
  static constexpr int CH = (NUSED + 3) / 4 * 4;  // a ray's channels in shared memory
  static constexpr int CH4 = CH / 4;
  int cells;
  int (*box)[4];  // [3] (a step mod 3): min / max cell row, min / max cell column
  unsigned long long* s_stats;  // the block's counts
  int n_step = 0;
  // this ray's tap products, and its global atomics of direct adds (counting)
  unsigned long long n_products = 0, n_direct = 0;

  __device__ __forceinline__ static float* s_d() {  // [R, CH]
    extern __shared__ __align__(16) unsigned char sums_smem[];
    return reinterpret_cast<float*>(sums_smem);
  }
  __device__ __forceinline__ static float4* s_w() {  // [R]
    return reinterpret_cast<float4*>(s_d() + blockDim.x * CH);
  }
  __device__ __forceinline__ static int* s_cnt() {  // [cells]
    return reinterpret_cast<int*>(s_w() + blockDim.x);
  }
  __device__ __forceinline__ int* s_ids() const { return s_cnt() + cells; }  // [cells, BUCKET]

  __device__ __forceinline__ TapSums(int cells_, int (*box_)[4], unsigned long long* s_stats_)
      : cells(cells_), box(box_), s_stats(s_stats_) {
    const int tid = threadIdx.x, R = blockDim.x;
    float* d = s_d();
    int* cnt = s_cnt();
    for (int i = tid; i < R * CH; i += R) d[i] = 0.0f;  // pad channels stay zero
    for (int i = tid; i < cells; i += R) cnt[i] = 0;
    if (tid < 12) box[tid / 4][tid % 4] = (tid % 2 == 0) ? INT_MAX : INT_MIN;
    if (tid < 4) s_stats[tid] = 0ull;
    __syncthreads();
  }

  // Step 1 of a ray that adds at this step (a nonzero tap and a nonzero
  // channel cotangent), called where its cotangents are computed: its NUSED
  // channel cotangents ``d_int`` (rounded to bf16) and tap weights to shared
  // memory, where a direct add reads them back (no register holds them
  // across the barriers); ``counting``: count its tap products.
  __device__ __forceinline__ void stage(const float* d_int, const Taps& t, bool counting) {
    const int tid = threadIdx.x;
    float* d = s_d();
#pragma unroll
    for (int chn = 0; chn < NUSED; ++chn) d[tid * CH + chn] = d_int[chn];
    s_w()[tid] = make_float4(t.w[0], t.w[1], t.w[2], t.w[3]);
    if (counting) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int chn = 0; chn < NUSED; ++chn) n_products += t.w[k] != 0.0f && d_int[chn] != 0.0f;
    }
  }

  // The rest of the step, on every thread: this ray adds its taps ``t``
  // where ``adds`` (staged) into the cotangent ``dgrid``; ``vertex(u, v)`` is
  // the element offset there of patch vertex (u, v)'s 32-lane block of the
  // step's slab or position; ``counting``: count the global atomics and
  // the steps.
  template <class Vertex>
  __device__ __forceinline__ void step(bool adds, const Taps& t, Vertex vertex, float* dgrid,
                                       bool counting) {
    const int tid = threadIdx.x, R = blockDim.x;
    const float* s_dd = s_d();
    const float4* s_ww = s_w();
    int* s_cc = s_cnt();
    int* s_ii = s_ids();
    const int st = n_step++;
    // 1. the block's box of cells
    int* bx = box[st % 3];
    {
      constexpr unsigned FULL = 0xffffffffu;
      const int a = __reduce_min_sync(FULL, adds ? t.ku : INT_MAX);
      const int b = __reduce_max_sync(FULL, adds ? t.ku : INT_MIN);
      const int c = __reduce_min_sync(FULL, adds ? t.kv : INT_MAX);
      const int d = __reduce_max_sync(FULL, adds ? t.kv : INT_MIN);
      if ((tid & 31) == 0 && a != INT_MAX) {
        atomicMin(bx + 0, a);
        atomicMax(bx + 1, b);
        atomicMin(bx + 2, c);
        atomicMax(bx + 3, d);
      }
    }
    __syncthreads();
    if (tid == 0) {  // the box two steps on: last read in the step before this one
      int* nx = box[(st + 2) % 3];
      nx[0] = INT_MAX;
      nx[1] = INT_MIN;
      nx[2] = INT_MAX;
      nx[3] = INT_MIN;
    }
    const int u_lo = bx[0], v_lo = bx[2];
    if (u_lo == INT_MAX) return;  // no ray adds at this step (uniform)
    const int ncu = bx[1] - u_lo + 1, ncv = bx[3] - v_lo + 1;
    const bool bucketed = ncu * ncv <= cells;  // uniform
    // 2. file the ray under its cell; a step over the buckets' cells, or a
    // ray whose bucket is full, adds its taps directly
    bool direct = adds && !bucketed;
    if (adds && bucketed) {
      const int cell = (t.ku - u_lo) * ncv + (t.kv - v_lo);
      const int slot = atomicAdd(s_cc + cell, 1);
      if (slot < BUCKET)
        s_ii[cell * BUCKET + slot] = tid;
      else
        direct = true;
    }
    if (direct) {
      const float* d = s_dd + tid * CH;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (t.w[k] == 0.0f) continue;
        float* dst = dgrid + vertex(t.ku + k / 2, t.kv + k % 2);
#pragma unroll
        for (int chn = 0; chn < NUSED; ++chn) {
          if (d[chn] != 0.0f) {
            atomicAdd(dst + chn, t.w[k] * d[chn]);
            if (counting) ++n_direct;
          }
        }
      }
    }
    if (counting && tid == 0) atomicAdd(&s_stats[bucketed ? 2 : 3], 1ull);
    if (!bucketed) return;
    __syncthreads();
    // 3. a thread a vertex of the box's (ncu + 1) x (ncv + 1): patch vertex
    // (u_lo + a, v_lo + c), all its channels (each ray's bucket entry and
    // weight read once)
    unsigned long long n_flushed = 0;
    const int nvv = ncv + 1;
    for (int vert = tid; vert < (ncu + 1) * nvv; vert += R) {
      const int a = vert / nvv, c = vert - a * nvv;
      float4 acc[CH4];
#pragma unroll
      for (int q = 0; q < CH4; ++q) acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int du = 0; du < 2; ++du) {
#pragma unroll
        for (int dv = 0; dv < 2; ++dv) {
          const int cu = a - du, cv = c - dv;
          if (cu < 0 || cu >= ncu || cv < 0 || cv >= ncv) continue;
          const int cell = cu * ncv + cv, k = du * 2 + dv;
          const int n = min(s_cc[cell], BUCKET);
          for (int m = 0; m < n; ++m) {
            const int id = s_ii[cell * BUCKET + m];
            const float w = tap_of(s_ww[id], k);
            if (w == 0.0f) continue;
            const float4* d4 = reinterpret_cast<const float4*>(s_dd + id * CH);
#pragma unroll
            for (int q = 0; q < CH4; ++q) {
              const float4 dv4 = d4[q];
              acc[q].x = acc[q].x + w * dv4.x;
              acc[q].y = acc[q].y + w * dv4.y;
              acc[q].z = acc[q].z + w * dv4.z;
              acc[q].w = acc[q].w + w * dv4.w;
            }
          }
        }
      }
      float* dst = dgrid + vertex(u_lo + a, v_lo + c);
#pragma unroll
      for (int q = 0; q < CH4; ++q) {
        if (acc[q].x != 0.0f || acc[q].y != 0.0f || acc[q].z != 0.0f || acc[q].w != 0.0f) {
          atomicAdd(reinterpret_cast<float4*>(dst + 4 * q), acc[q]);
          ++n_flushed;
        }
      }
    }
    if (counting && n_flushed) atomicAdd(&s_stats[1], n_flushed);
    __syncthreads();  // every sum read the step's rays: clear the buckets
    for (int m = tid; m < ncu * ncv; m += R) s_cc[m] = 0;
  }

  // After the last step: the block's counts into ``stats`` (null: none).
  __device__ __forceinline__ void finish(unsigned long long* stats) {
    if (stats == nullptr) return;
    atomicAdd(&s_stats[0], n_products);
    atomicAdd(&s_stats[1], n_direct);
    __syncthreads();
    if (threadIdx.x < 4) atomicAdd(stats + threadIdx.x, s_stats[threadIdx.x]);
  }
};


struct Params {
  const int4* tables;  // [T, G]
  const int* counts;   // [T]
  const float* rays;   // [T, R, 48]
  const __nv_bfloat16* grid;  // [XG, U, V, 256]
  const float* fwd;    // [T, R, 8] forward totals
  const float* gout;   // [T, R, 8] output cotangent
  float* dgrid;        // [XG, U, V, 256] f32, zeroed by the caller
  // [4] or null: tap products added (the atomics a tap-by-tap add would
  // issue), global atomics issued (summed vertex quads and direct adds),
  // steps summed in shared memory, steps added directly
  unsigned long long* stats;
  int T, G, U, V, goff;
  int cells;           // cells of the buckets ([cells, BUCKET] ray ids)
  float exit_eps;
};

// A position's cotangent: density, raw rgb and raw band-0 colour.
struct DPos {
  float sig, rgb[3], dif[3];
};

template <int NCOEFF, bool RELU, bool DIFFUSE>
__global__ void __launch_bounds__(256, 1) plane_march_backward_kernel(Params prm) {
  constexpr int NF = 3 * NCOEFF;
  constexpr int NUSED = NF + 1;
  __shared__ int box[3][4];
  __shared__ unsigned long long s_stats[4];
  __shared__ slab::TileOrder order;
  const int t = slab::tile_by_entries(prm.counts, prm.T, prm.G, order);
  const int R = blockDim.x;
  TapSums<NUSED> sums(prm.cells, box, s_stats);
  const size_t ray_id = (size_t)t * R + threadIdx.x;
  slab::Ray<NCOEFF> ray;
  ray.load(prm.rays + ray_id * slab::RAY_LANES);
  float g[8], tot[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    g[k] = prm.gout[ray_id * 8 + k];
    tot[k] = prm.fwd[ray_id * 8 + k];
  }
  const int count = min(prm.counts[t], prm.G);

  float T = 1.0f;
  float P[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < count; ++i) {
    if (!__syncthreads_or(T > prm.exit_eps)) break;  // the forward's exit
    slab::Entry e;
    e.load(prm.tables + (size_t)t * prm.G + i);
    const float base = (float)(e.xg * STRIDE);
    slab::Sample s;
    Pos prev = position<NCOEFF>(prm.grid, ray, e, 0, prm.U, prm.V, prm.goff, s);
    Taps taps_prev = Taps::of(s);
    // the previous cell's share of the current position (dI_b, tbar parts)
    DPos pend = {0.0f, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    // step k: cell k - 1 (k < GS), then position k - 1 complete
#pragma unroll 1
    for (int k = 1; k <= GS; ++k) {
      Pos cur;
      cur.live = false;
      if (k < GS) cur = position<NCOEFF>(prm.grid, ray, e, k, prm.U, prm.V, prm.goff, s);
      DPos da = {0.0f, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      DPos db = da;
      if (prev.live && cur.live) {  // a dead cell contributes nothing
        const Cell<RELU, DIFFUSE> cell(prev, cur, ray, base, k - 1);
        const float w = cell.alpha * T;
#pragma unroll
        for (int c = 0; c < 3; ++c) P[c] = P[c] + cell.mid[c] * w;
        P[3] = P[3] + w;
        P[4] = P[4] + w * cell.s_dep;
        if constexpr (DIFFUSE) {
#pragma unroll
          for (int c = 0; c < 3; ++c) P[5 + c] = P[5 + c] + cell.dmid[c] * w;
        }
        float S[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) S[j] = tot[j] - P[j];
        float inner = (((g[0] * cell.mid[0] + g[1] * cell.mid[1]) + g[2] * cell.mid[2]) + g[3])
                      + g[4] * cell.s_dep;
        float suff = (((g[0] * S[0] + g[1] * S[1]) + g[2] * S[2]) + g[3] * S[3]) + g[4] * S[4];
        if constexpr (DIFFUSE) {
          inner = inner + ((g[5] * cell.dmid[0] + g[6] * cell.dmid[1]) + g[7] * cell.dmid[2]);
          suff = suff + ((g[5] * S[5] + g[6] * S[6]) + g[7] * S[7]);
        }
        const float dinteg = ray.delta * ((1.0f - cell.alpha) * T * inner - suff);
        da.sig = dinteg * cell.dIda;
        db.sig = dinteg * cell.dIdb;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float dm = g[c] * w * cell.mid[c] * (1.0f - cell.mid[c]);
          da.rgb[c] = (1.0f - cell.tbar) * dm;
          db.rgb[c] = cell.tbar * dm;
          if constexpr (DIFFUSE) {
            const float dd = g[5 + c] * w * cell.dmid[c] * (1.0f - cell.dmid[c]);
            da.dif[c] = (1.0f - cell.tbar) * dd;
            db.dif[c] = cell.tbar * dd;
          }
        }
        T = T * (1.0f - cell.alpha);
      }
      // position k - 1 is complete: cell k - 1's a-share (none past the last
      // cell) plus cell k - 2's b-share; its channel cotangents, rounded to bf16
      bool adds = false;  // a nonzero tap and a nonzero channel cotangent
      if (prev.live) {
        float d_int[NUSED];
        DPos d;
        d.sig = da.sig + pend.sig;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          d.rgb[c] = da.rgb[c] + pend.rgb[c];
          d.dif[c] = da.dif[c] + pend.dif[c];
        }
#pragma unroll
        for (int chn = 0; chn < NF; ++chn) {
          const int c = chn / NCOEFF;
          float v = d.rgb[c];
          if (DIFFUSE) v = v + (chn % NCOEFF == 0 ? d.dif[c] : 0.0f);
          d_int[chn] = slab::bf16r(v * ray.y[chn]);
        }
        d_int[NF] = slab::bf16r(d.sig);
        bool any = false;
#pragma unroll
        for (int chn = 0; chn < NUSED; ++chn) any = any || d_int[chn] != 0.0f;
        adds = any && taps_prev.any();
        if (adds) sums.stage(d_int, taps_prev, prm.stats != nullptr);
      }
      // vertex (u, v) of the entry's patch: lanes 32 (k - 1) .. 32 k - 1 of its row
      const size_t lanes = (size_t)(k - 1) * slab::LPS;
      sums.step(adds, taps_prev, [&](int u, int v) {
        return (((size_t)(e.xg - prm.goff) * prm.U + e.u0 + u) * prm.V + e.v0 + v) * LAN + lanes;
      }, prm.dgrid, prm.stats != nullptr);
      pend = db;
      prev = cur;
      taps_prev = Taps::of(s);
    }
  }
  sums.finish(prm.stats);
}

template <int NCOEFF>
auto kernel_of(int relu, int diffuse) {
  return relu ? (diffuse ? plane_march_backward_kernel<NCOEFF, true, true>
                         : plane_march_backward_kernel<NCOEFF, true, false>)
              : (diffuse ? plane_march_backward_kernel<NCOEFF, false, true>
                         : plane_march_backward_kernel<NCOEFF, false, false>);
}

template <int NCOEFF>
int dispatch(const Params& prm, int T, int R, size_t smem, int relu, int diffuse,
             cudaStream_t s) {
  auto kern = kernel_of<NCOEFF>(relu, diffuse);
  static size_t allowed[2][2][16] = {};  // a limit for each of the four kernels
  const cudaError_t e = allow_smem(kern, smem, allowed[relu != 0][diffuse != 0]);
  if (e != cudaSuccess) return (int)e;
  kern<<<T, R, smem, s>>>(prm);
  return (int)cudaGetLastError();
}

template <int NCOEFF>
int occupancy(int R, size_t smem, int relu, int diffuse, int* regs_blocks) {
  auto kern = kernel_of<NCOEFF>(relu, diffuse);
  static size_t allowed[2][2][16] = {};
  cudaError_t e = allow_smem(kern, smem, allowed[relu != 0][diffuse != 0]);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, (const void*)kern)) != cudaSuccess) return (int)e;
  regs_blocks[0] = attr.numRegs;
  regs_blocks[2] = R;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&regs_blocks[1], kern, R, smem);
}

}  // namespace

// One launch: a block per tile (T), a thread per ray (R = 64 or 256),
// buckets of ``cells`` cells (plane_backward_plan; ``smem`` bytes, checked
// against sums_smem_bytes); dgrid must hold zeros (or a cotangent to add to).
// ``stats`` (null, or four uint64 the caller zeroed) gets the tap products,
// the global atomics, and the steps summed in shared memory and added
// directly. ``group_offset`` rebases the tables' global group indices onto
// the grid operand.
extern "C" int plane_march_backward_launch(const void* tables, const int* counts,
                                           const float* rays, const void* grid,
                                           const float* fwd, const float* gout, float* dgrid,
                                           void* stats, int T, int G, int R, int XG, int U,
                                           int V, int ncoeff, int relu, int with_diffuse,
                                           int group_offset, int cells, long long smem,
                                           float exit_eps, void* stream) {
  if (T <= 0) return 0;
  const int ch = (3 * ncoeff + 1 + 3) / 4 * 4;
  if ((R != 64 && R != 256) || XG <= 0 || cells < 1 ||
      (size_t)smem != sums_smem_bytes(R, ch, cells) || (uintptr_t)dgrid % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params prm{reinterpret_cast<const int4*>(tables), counts, rays,
             reinterpret_cast<const __nv_bfloat16*>(grid), fwd, gout, dgrid,
             reinterpret_cast<unsigned long long*>(stats), T, G, U, V, group_offset, cells,
             exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncoeff) {
    case 1: return dispatch<1>(prm, T, R, (size_t)smem, relu, with_diffuse, s);
    case 4: return dispatch<4>(prm, T, R, (size_t)smem, relu, with_diffuse, s);
    case 9: return dispatch<9>(prm, T, R, (size_t)smem, relu, with_diffuse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch's shape on this card at ``smem`` bytes of dynamic shared memory
// (plane_backward_plan): ptxas's registers a thread, the blocks an SM can hold
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the threads a block,
// into ``regs_blocks_threads`` [3].
extern "C" int plane_march_backward_occupancy(int R, int ncoeff, int relu, int with_diffuse,
                                              long long smem, int* regs_blocks_threads) {
  switch (ncoeff) {
    case 1: return occupancy<1>(R, (size_t)smem, relu, with_diffuse, regs_blocks_threads);
    case 4: return occupancy<4>(R, (size_t)smem, relu, with_diffuse, regs_blocks_threads);
    case 9: return occupancy<9>(R, (size_t)smem, relu, with_diffuse, regs_blocks_threads);
    default: return (int)cudaErrorInvalidValue;
  }
}
