// slab_march_backward: the replay VJP of the slab-march render (K10) with
// respect to the repacked grid [XG, U, V, 128].
//
// Replaces the TPU kernel thr3ed_atom_tpu/ops/pallas/slab_march.py
// _backward_impl (kernel _make_backward_kernel). That kernel replays each
// tile's march with the forward's MXU product, carries the transmittance T
// and the prefix P of the contributions, takes the suffix S = totals - P from
// the forward outputs (no per-sample residuals), forms
//   dsigma = delta ((1 - alpha) T <g, x> - <g, S>)
// (zero where relu cuts, or where sigma delta < 0 clips alpha), the colour
// cotangents through the sigmoid and the SH basis, rounds the channel
// cotangents d_interp to bf16, and adds W^T @ d_interp into an f32 cotangent
// with a read-modify-write DMA per entry; TPU grid steps run in order, so
// the adds are race-free.
//
// Here a block owns a tile and a thread a ray, replaying K9 bit for bit
// (slab_march.cuh) and stopping at the same entry. Blocks run in no order on
// the card, so the cotangent takes f32 atomics, and the sums round in another
// order than the plain version's (f32 round-off before the caller's bf16
// cast of the cotangent).
//
// Bound on the H100: the atomics. The function reads what K9 reads plus the
// forward totals and the output cotangent, and adds (3 ncoeff + 1) values
// per nonzero tap of every live sample (up to 112 a sample at SH degree 2)
// into the cotangent (written once: 4 bytes per element of the grid).
// Neighbouring rays of a tile sample neighbouring points of the entry's
// patch at the same step, so one global atomic a tap has many rays add into
// the same few vertices at once, serialized at L2 (a 16 x 16 tile's taps
// reach about 60 vertices at a step at 0.4 voxels a pixel: ~16 adds a
// vertex and channel). So the block sums a step's taps first, as the TPU
// kernel's W^T @ d_interp does per entry, without float atomics in shared
// memory (a compare-and-swap loop there, which contention makes slower
// than the global atomics it saves). The (entry, slab) loop is uniform over
// the tile, and at each step
//   1. every ray takes its sample and, where it adds anything (a nonzero tap
//      and channel cotangent), writes its cotangents [CH] f32 and tap
//      weights to shared memory; the block's box of the rays' patch cells
//      (ku, kv) goes to shared memory (min / max);
//   2. a barrier on, each such ray files its id under its cell (a bucket of
//      BUCKET ids a cell, cells of the box in shared memory: an integer
//      atomic for its place);
//   3. a barrier on, a thread a (vertex, 4 channels) of the box's vertices
//      sums the taps of the rays in the vertex's four neighbouring cells
//      (tap 3 - 2 du - dv of cell (u - du, v - dv)) and adds the four sums
//      into the global cotangent with one vector f32 atomic where any is
//      nonzero; a barrier later the buckets are cleared for the next step.
// A ray whose sample adds nothing still reaches every barrier. The buckets
// are sized from the tile's footprint (slab_backward_plan in
// ops/slab_march.py: 2 R cells, so that several blocks fit an SM): a step
// whose box holds more cells, and a ray that finds its cell's bucket full,
// add their taps into the global cotangent directly (counted). The replay
// is K9's bit for bit; only the order of the f32 adds changes. Built with
// -fmad=false.
#include <climits>
#include <cuda_runtime.h>

#include "slab_march.cuh"
#include "smem_limit.cuh"

namespace {

using namespace slab;

constexpr int BUCKET = 16;  // ray ids a cell holds at a step

struct Params {
  const int4* tables;  // [T, G]
  const int* counts;   // [T]
  const float* rays;   // [T, R, 48]
  const __nv_bfloat16* grid;  // [XG, U, V, 128]
  const float* fwd;    // [T, R, 8] forward totals
  const float* gout;   // [T, R, 8] output cotangent
  float* dgrid;        // [XG, U, V, 128] f32, zeroed by the caller
  // [4] or null: tap products added (the atomics a tap-by-tap add would
  // issue), global atomics issued (summed vertex quads and direct adds),
  // steps summed in shared memory, steps added directly
  unsigned long long* stats;
  int G, U, V, goff;   // goff: the grid operand's first group (tables are global)
  int cells;           // cells of the buckets ([cells, BUCKET] ray ids)
  float exit_eps;
};

// shared-memory bytes of a block of R rays with ``cells`` bucket cells and
// ch channels a ray: cotangents [R, ch] f32, tap weights [R] float4, cell
// counts [cells] and buckets [cells, BUCKET] int
__host__ __device__ inline size_t backward_smem_bytes(int R, int ch, int cells) {
  return (size_t)R * ch * sizeof(float) + (size_t)R * sizeof(float4) +
         (size_t)cells * (1 + BUCKET) * sizeof(int);
}

__device__ __forceinline__ int warp_min(int x) { return __reduce_min_sync(0xffffffffu, x); }
__device__ __forceinline__ int warp_max(int x) { return __reduce_max_sync(0xffffffffu, x); }

__device__ __forceinline__ float tap_of(const float4& w, int k) {
  return k == 0 ? w.x : (k == 1 ? w.y : (k == 2 ? w.z : w.w));
}

template <int NCOEFF, bool RELU, bool DIFFUSE>
__global__ void __launch_bounds__(256, 2) slab_march_backward_kernel(Params prm) {
  constexpr int NF = 3 * NCOEFF;
  constexpr int NUSED = NF + 1;
  constexpr int CH = (NUSED + 3) / 4 * 4;  // a ray's cotangent channels in shared memory
  constexpr int CH4 = CH / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int box[3][4];  // per step (mod 3): min / max cell row, min / max cell column
  __shared__ unsigned long long s_stats[4];
  const int t = blockIdx.x;
  const int R = blockDim.x;
  const int tid = threadIdx.x;
  float* s_d = reinterpret_cast<float*>(smem);                 // [R, CH]
  float4* s_w = reinterpret_cast<float4*>(s_d + (size_t)R * CH);  // [R]
  int* s_cnt = reinterpret_cast<int*>(s_w + R);                 // [cells]
  int* s_ids = s_cnt + prm.cells;                               // [cells, BUCKET]
  const size_t ray_id = (size_t)t * R + tid;
  const bool counting = prm.stats != nullptr;
  for (int i = tid; i < R * CH; i += R) s_d[i] = 0.0f;  // pad channels stay zero
  for (int i = tid; i < prm.cells; i += R) s_cnt[i] = 0;
  if (tid < 12) box[tid / 4][tid % 4] = (tid % 2 == 0) ? INT_MAX : INT_MIN;
  if (tid < 4) s_stats[tid] = 0ull;
  Ray<NCOEFF> ray;
  ray.load(prm.rays + ray_id * RAY_LANES);
  float g[8], tot[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    g[k] = prm.gout[ray_id * 8 + k];
    tot[k] = prm.fwd[ray_id * 8 + k];
  }
  const int count = min(prm.counts[t], prm.G);
  // this ray's tap products, and its global atomics of direct adds (counting)
  unsigned long long n_products = 0, n_direct = 0;

  float T = 1.0f;
  float P[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int step = 0;  // (entry, slab) steps so far, uniform over the block
  __syncthreads();
  for (int i = 0; i < count; ++i) {
    if (!__syncthreads_or(T > prm.exit_eps)) break;  // the forward's exit
    Entry e;
    e.load(prm.tables + (size_t)t * prm.G + i);
#pragma unroll 1
    for (int b = 0; b < GS; ++b, ++step) {
      const Sample s = sample<SlabGeom>(ray, e, b, prm.U, prm.V, prm.goff);
      bool adds = false;  // a nonzero tap and a nonzero channel cotangent
      if (s.live) {
        float d_int[NUSED];
        float ch[NUSED];
        interp<NUSED>(prm.grid, s, ch);
        const Shade<NCOEFF, RELU> sh(ch, ray);
        const float w = sh.alpha * T;
        const float s_dep = ray.at + ray.bt * s.jg;
#pragma unroll
        for (int c = 0; c < 3; ++c) P[c] = P[c] + sh.rgb[c] * w;
        P[3] = P[3] + w;
        P[4] = P[4] + w * s_dep;
        if constexpr (DIFFUSE) {
#pragma unroll
          for (int c = 0; c < 3; ++c) P[5 + c] = P[5 + c] + sh.dif[c] * w;
        }
        float S[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) S[k] = tot[k] - P[k];
        float inner = ((g[0] * sh.rgb[0] + g[1] * sh.rgb[1]) + g[2] * sh.rgb[2] + g[3]) +
                      g[4] * s_dep;
        float suff = (((g[0] * S[0] + g[1] * S[1]) + g[2] * S[2]) + g[3] * S[3]) + g[4] * S[4];
        if constexpr (DIFFUSE) {
          inner = inner + ((g[5] * sh.dif[0] + g[6] * sh.dif[1]) + g[7] * sh.dif[2]);
          suff = suff + ((g[5] * S[5] + g[6] * S[6]) + g[7] * S[7]);
        }
        float dsig = ray.delta * ((1.0f - sh.alpha) * T * inner - suff);
        const bool keep = RELU ? sh.sigma_raw > 0.0f : sh.sigma * ray.delta >= 0.0f;
        if (!keep) dsig = 0.0f;
        float d_rgb[3], d_dif[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          d_rgb[c] = g[c] * w * sh.rgb[c] * (1.0f - sh.rgb[c]);
          d_dif[c] = DIFFUSE ? g[5 + c] * w * sh.dif[c] * (1.0f - sh.dif[c]) : 0.0f;
        }
#pragma unroll
        for (int chn = 0; chn < NF; ++chn) {
          const int c = chn / NCOEFF, k = chn % NCOEFF;
          float d = d_rgb[c];
          if (DIFFUSE && k == 0) d = d + d_dif[c];
          d_int[chn] = bf16r(d * ray.y[chn]);
        }
        d_int[NF] = bf16r(dsig);
        bool any = false;
#pragma unroll
        for (int chn = 0; chn < NUSED; ++chn) any = any || d_int[chn] != 0.0f;
        adds = any && (s.w[0] != 0.0f || s.w[1] != 0.0f || s.w[2] != 0.0f || s.w[3] != 0.0f);
        T = T * (1.0f - sh.alpha);
        // 1. the ray's cotangents and tap weights (a direct add reads them
        // back: no register holds them across the barriers)
        if (adds) {
#pragma unroll
          for (int chn = 0; chn < NUSED; ++chn) s_d[tid * CH + chn] = d_int[chn];
          s_w[tid] = make_float4(s.w[0], s.w[1], s.w[2], s.w[3]);
          if (counting) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int chn = 0; chn < NUSED; ++chn)
                n_products += s.w[k] != 0.0f && d_int[chn] != 0.0f;
          }
        }
      }
      // and the block's box of cells
      int* bx = box[step % 3];
      {
        const int a = warp_min(adds ? s.ku : INT_MAX), bmax = warp_max(adds ? s.ku : INT_MIN);
        const int c = warp_min(adds ? s.kv : INT_MAX), d = warp_max(adds ? s.kv : INT_MIN);
        if ((tid & 31) == 0 && a != INT_MAX) {
          atomicMin(bx + 0, a);
          atomicMax(bx + 1, bmax);
          atomicMin(bx + 2, c);
          atomicMax(bx + 3, d);
        }
      }
      __syncthreads();
      if (tid == 0) {  // the box two steps on: last read in the step before this one
        int* nx = box[(step + 2) % 3];
        nx[0] = INT_MAX;
        nx[1] = INT_MIN;
        nx[2] = INT_MAX;
        nx[3] = INT_MIN;
      }
      const int u_lo = bx[0], v_lo = bx[2];
      if (u_lo == INT_MAX) continue;  // no ray adds at this step (uniform)
      const int ncu = bx[1] - u_lo + 1, ncv = bx[3] - v_lo + 1;
      const bool bucketed = ncu * ncv <= prm.cells;  // uniform
      // 2. file the ray under its cell; a step over the buckets' cells, or a
      // ray whose bucket is full, adds its taps directly
      bool direct = adds && !bucketed;
      if (adds && bucketed) {
        const int cell = (s.ku - u_lo) * ncv + (s.kv - v_lo);
        const int slot = atomicAdd(s_cnt + cell, 1);
        if (slot < BUCKET)
          s_ids[cell * BUCKET + slot] = tid;
        else
          direct = true;
      }
      if (direct) {
        const float* d_int = s_d + tid * CH;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (s.w[k] == 0.0f) continue;
          float* dst = prm.dgrid + s.off[k];
#pragma unroll
          for (int chn = 0; chn < NUSED; ++chn) {
            const float d = d_int[chn];
            if (d != 0.0f) {
              atomicAdd(dst + chn, s.w[k] * d);
              if (counting) ++n_direct;
            }
          }
        }
      }
      if (counting && tid == 0) atomicAdd(&s_stats[bucketed ? 2 : 3], 1ull);
      if (!bucketed) continue;
      __syncthreads();
      // 3. a thread a (vertex, 4 channels) of the box's (ncu + 1) x (ncv + 1)
      // vertices: vertex (u_lo + a, v_lo + c) of the entry's patch, lanes
      // 4 g4 .. 4 g4 + 3 of slab b's block
      unsigned long long n_flushed = 0;
      const int nvv = ncv + 1;
      for (int idx = tid; idx < (ncu + 1) * nvv * CH4; idx += R) {
        const int vert = idx / CH4, g4 = idx - vert * CH4;
        const int a = vert / nvv, c = vert - a * nvv;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int du = 0; du < 2; ++du) {
#pragma unroll
          for (int dv = 0; dv < 2; ++dv) {
            const int cu = a - du, cv = c - dv;
            if (cu < 0 || cu >= ncu || cv < 0 || cv >= ncv) continue;
            const int cell = cu * ncv + cv, k = du * 2 + dv;
            const int n = min(s_cnt[cell], BUCKET);
            for (int m = 0; m < n; ++m) {
              const int id = s_ids[cell * BUCKET + m];
              const float w = tap_of(s_w[id], k);
              if (w == 0.0f) continue;
              const float4 dv4 = reinterpret_cast<const float4*>(s_d + id * CH)[g4];
              acc.x = acc.x + w * dv4.x;
              acc.y = acc.y + w * dv4.y;
              acc.z = acc.z + w * dv4.z;
              acc.w = acc.w + w * dv4.w;
            }
          }
        }
        if (acc.x != 0.0f || acc.y != 0.0f || acc.z != 0.0f || acc.w != 0.0f) {
          float* dst = prm.dgrid +
                       ((((size_t)(e.xg - prm.goff) * prm.U + e.u0 + u_lo + a) * prm.V + e.v0 + v_lo + c) *
                            LAN +
                        (size_t)b * LPS + 4 * g4);
          atomicAdd(reinterpret_cast<float4*>(dst), acc);
          ++n_flushed;
        }
      }
      if (counting && n_flushed) atomicAdd(&s_stats[1], n_flushed);
      __syncthreads();  // every sum read the step's rays: clear the buckets
      for (int m = tid; m < ncu * ncv; m += R) s_cnt[m] = 0;
    }
  }
  if (counting) {
    atomicAdd(&s_stats[0], n_products);
    atomicAdd(&s_stats[1], n_direct);
    __syncthreads();
    if (tid < 4) atomicAdd(prm.stats + tid, s_stats[tid]);
  }
}

template <int NCOEFF>
int dispatch(const Params& prm, int T, int R, size_t smem, int relu, int diffuse,
             cudaStream_t s) {
  auto kern = relu ? (diffuse ? slab_march_backward_kernel<NCOEFF, true, true>
                              : slab_march_backward_kernel<NCOEFF, true, false>)
                   : (diffuse ? slab_march_backward_kernel<NCOEFF, false, true>
                              : slab_march_backward_kernel<NCOEFF, false, false>);
  static size_t allowed[2][2][16] = {};  // a limit for each of the four kernels
  const cudaError_t e = allow_smem(kern, smem, allowed[relu != 0][diffuse != 0]);
  if (e != cudaSuccess) return (int)e;
  kern<<<T, R, smem, s>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: a block per tile (T), a thread per ray (R = 64 or 256),
// buckets of ``cells`` cells (slab_backward_plan; ``smem`` bytes, checked
// against backward_smem_bytes); dgrid must hold zeros (or a cotangent to add
// to). ``stats`` (null, or four uint64 the caller zeroed) gets the tap
// products, the global atomics, and the steps summed in shared memory and
// added directly. ``group_offset`` rebases the tables' global group indices
// onto the grid operand and its cotangent.
extern "C" int slab_march_backward_launch(const void* tables, const int* counts,
                                          const float* rays, const void* grid,
                                          const float* fwd, const float* gout, float* dgrid,
                                          void* stats, int T, int G, int R, int XG, int U,
                                          int V, int ncoeff, int relu, int with_diffuse,
                                          int group_offset, int cells, long long smem,
                                          float exit_eps, void* stream) {
  if (T <= 0) return 0;
  const int ch = (3 * ncoeff + 1 + 3) / 4 * 4;
  if ((R != 64 && R != 256) || XG <= 0 || group_offset < 0 || cells < 1 ||
      (size_t)smem != backward_smem_bytes(R, ch, cells) || (uintptr_t)dgrid % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params prm{reinterpret_cast<const int4*>(tables), counts, rays,
             reinterpret_cast<const __nv_bfloat16*>(grid), fwd, gout, dgrid,
             reinterpret_cast<unsigned long long*>(stats), G, U, V, group_offset, cells,
             exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncoeff) {
    case 1: return dispatch<1>(prm, T, R, (size_t)smem, relu, with_diffuse, s);
    case 4: return dispatch<4>(prm, T, R, (size_t)smem, relu, with_diffuse, s);
    case 9: return dispatch<9>(prm, T, R, (size_t)smem, relu, with_diffuse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
