// plane_march: the plane-march renderer's fused render (K11): per ray tile,
// front to back over the tile's table entries, the bilinear samples of the
// entry's 8 positions, the SH fold, the closed-form relu-trapezoid integral of
// each of the 7 cells between consecutive positions (relu_trap, K1a), the
// centroid emission lerp and compositing with 1 - exp(-I delta), with a
// per-tile early exit.
//
// Replaces the TPU kernel thr3ed_atom_tpu/ops/pallas/plane_march.py
// plane_march_render (kernel _make_forward_kernel): a grid step per tile that
// DMAs each entry's [16, 24, 256] bf16 patch into VMEM and interpolates all
// 8 x R positions with one one-hot MXU product, then batches the cells. Here a
// block owns a tile (R = 256 or 64 rays) and a group of L lanes a ray
// (slab_march.cuh ``Lanes``: 2 at SH degree 2, so 512 threads a 256-ray
// tile, two blocks an SM at 64 registers a thread): the group shares out
// each position's tents, each lane gathers its channels of the position's
// nonzero taps (at most four 56-byte records at SH degree 2), the colours
// fold on their owner lanes, and every lane keeps the previous position's
// fold of its own colours and the density in registers and composites a
// cell as soon as both its positions are known: each lane computes the
// cell's integral (relu_trap) and opacity itself, the owner lanes their
// colours' emission. Each entry's cells sum into a zeroed partial that is
// then added to the state, as the TPU kernel's per-entry accumulator does.
// The tile's per-entry exit vote (the TPU kernel's while condition before
// each entry) is split in two (slab_march.cuh ``LaggedVote``), and blocks
// take the tiles longest first (``tile_by_entries``), as in K9.
//
// Bound on the H100: the issue of the per-position and per-cell arithmetic
// and the longest tile's serial march (up to ~8x the mean entries a tile),
// not the bytes (the function reads each table entry, ray record and the
// patch records its positions' taps touch, and writes [T, R, 8] f32): with
// every tap read from a 64-row set that stays in cache, the pose is ~3%
// faster (PERF.md §6). The position loop is not unrolled: unrolled, it
// spills at 64 registers. Built with -fmad=false.
#include <cuda_runtime.h>

#include "plane_march.cuh"

namespace {

using namespace planes;

struct Params {
  const int4* tables;  // [T, G] entries (xg, u0, v0, jlo * 256 + jhi)
  const int* counts;   // [T]
  const float* rays;   // [T, R, 48]
  const __nv_bfloat16* grid;  // [XG, U, V, 256]
  float* out;          // [T, R, 8]
  int T, G, U, V, goff;
  float exit_eps;
};


// What lane g holds of one position of an entry: liveness, the raw density,
// the raw SH-folded and band-0 colours of the colours it owns (Pos's values
// on the lane-group layout); zeros where no ray of the warp is live.
template <int NCOEFF>
struct LanePos {
  bool live;
  float sigma, rgb[slab::Lanes<NCOEFF>::S], dif[slab::Lanes<NCOEFF>::S];
};

template <int NCOEFF>
__device__ __forceinline__ LanePos<NCOEFF> lane_position(const Params& prm,
                                                         const slab::LaneRay<NCOEFF>& ray,
                                                         const slab::Entry& e, int k, int g,
                                                         int c0) {
  using Q = slab::Lanes<NCOEFF>;
  LanePos<NCOEFF> p;
  const slab::LaneSample s = slab::lane_sample<Geom, Q::L>(ray, e, k, prm.U, prm.V, prm.goff, g);
  p.live = s.live;
  if (!__any_sync(0xffffffffu, s.live)) {  // uniform over the warp: the fold shuffles
    p.sigma = 0.0f;
#pragma unroll
    for (int j = 0; j < Q::S; ++j) p.rgb[j] = p.dif[j] = 0.0f;
    return p;
  }
  float ch[Q::CPL];
  if (s.live) {
    slab::interp_lane<Q::GPL>(prm.grid + k * slab::LPS + g * Q::CPL, LAN, s, ch);
  } else {
#pragma unroll
    for (int c = 0; c < Q::CPL; ++c) ch[c] = 0.0f;
  }
  const slab::LaneFold<NCOEFF> f(ch, ray, c0);
  p.sigma = f.sigma;
#pragma unroll
  for (int j = 0; j < Q::S; ++j) {
    p.rgb[j] = f.rgb[j];
    p.dif[j] = f.dif[j];
  }
  return p;
}

template <int NCOEFF, bool RELU, bool DIFFUSE>
__global__ void __launch_bounds__(slab::MAX_THREADS, slab::MIN_BLOCKS)
    plane_march_kernel(Params prm) {
  using Q = slab::Lanes<NCOEFF>;
  __shared__ float4 s_y[Q::CPL / 4 * slab::MAX_RAYS * Q::L];
  __shared__ unsigned long long vote_bar[2];
  __shared__ int vote_flag[2];
  __shared__ slab::TileOrder order;
  const int t = slab::tile_by_entries(prm.counts, prm.T, prm.G, order);
  const int R = blockDim.x / Q::L;
  const int g = threadIdx.x % Q::L;  // lane in the ray's group
  const size_t ray_id = (size_t)t * R + threadIdx.x / Q::L;
  const int c0 = Q::first(g), c1 = Q::first(g + 1);  // the colours this lane folds
  slab::LaneRay<NCOEFF> ray;
  ray.load(prm.rays + ray_id * slab::RAY_LANES, g, s_y);
  const int count = min(prm.counts[t], prm.G);
  slab::LaggedVote vote{vote_bar, vote_flag};
  vote.init(blockDim.x / 32);

  float T = 1.0f;
  // this lane's outputs: its colours' rgb and diffuse sums, acc, depth
  float st_rgb[Q::S], st_dif[Q::S], st_acc = 0.0f, st_dep = 0.0f;
#pragma unroll
  for (int j = 0; j < Q::S; ++j) st_rgb[j] = st_dif[j] = 0.0f;
  // every ray's transmittance is 1 before the first entry
  const int n_entries = 1.0f > prm.exit_eps ? count : 0;
  for (int i = 0; i < n_entries; ++i) {
    slab::Entry e;
    e.load(prm.tables + (size_t)t * prm.G + i);
    const float base = (float)(e.xg * STRIDE);
    float a_rgb[Q::S], a_dif[Q::S], a_acc = 0.0f, a_dep = 0.0f;
#pragma unroll
    for (int j = 0; j < Q::S; ++j) a_rgb[j] = a_dif[j] = 0.0f;
    float Tc = T;
    LanePos<NCOEFF> prev = lane_position<NCOEFF>(prm, ray, e, 0, g, c0);
#pragma unroll 1
    for (int k = 1; k < GS; ++k) {
      const LanePos<NCOEFF> cur = lane_position<NCOEFF>(prm, ray, e, k, g, c0);
      // a dead cell has alpha 0: it adds zeros and leaves T
      if (prev.live && cur.live) {
        float integ, tbar, dIda, dIdb;
        relu_trap<RELU>(prev.sigma, cur.sigma, integ, tbar, dIda, dIdb);
        const float alpha = fminf(fmaxf(1.0f - expf(-integ * ray.delta), 0.0f), 1.0f);
        const float w = alpha * Tc;
#pragma unroll
        for (int j = 0; j < Q::S; ++j) {
          if (c0 + j < c1) {
            const float mid = slab::sigmoid((1.0f - tbar) * prev.rgb[j] + tbar * cur.rgb[j]);
            a_rgb[j] = a_rgb[j] + mid * w;
            if constexpr (DIFFUSE) {
              const float dmid =
                  slab::sigmoid((1.0f - tbar) * prev.dif[j] + tbar * cur.dif[j]);
              a_dif[j] = a_dif[j] + dmid * w;
            }
          }
        }
        a_acc = a_acc + w;
        a_dep = a_dep + w * (ray.at + ray.bt * ((base + (float)(k - 1)) + tbar));
        Tc = Tc * (1.0f - alpha);
      }
      prev = cur;
    }
    if (i > 0 && !vote.runs(i)) break;  // the tile stopped before entry i
#pragma unroll
    for (int j = 0; j < Q::S; ++j) {
      st_rgb[j] = st_rgb[j] + a_rgb[j];
      st_dif[j] = st_dif[j] + a_dif[j];
    }
    st_acc = st_acc + a_acc;
    st_dep = st_dep + a_dep;
    T = Tc;
    if (i + 1 < n_entries) vote.cast(i + 1, T > prm.exit_eps);
  }
  float* o = prm.out + ray_id * 8;
#pragma unroll
  for (int j = 0; j < Q::S; ++j) {
    if (c0 + j < c1) {
      o[c0 + j] = st_rgb[j];
      o[5 + c0 + j] = st_dif[j];
    }
  }
  if (g == Q::owner(Q::NF)) {
    o[3] = st_acc;
    o[4] = st_dep;
  }
}

template <int NCOEFF>
auto kernel_of(int relu, int diffuse) {
  return relu ? (diffuse ? plane_march_kernel<NCOEFF, true, true>
                         : plane_march_kernel<NCOEFF, true, false>)
              : (diffuse ? plane_march_kernel<NCOEFF, false, true>
                         : plane_march_kernel<NCOEFF, false, false>);
}

template <int NCOEFF>
int dispatch(const Params& prm, int T, int R, int relu, int diffuse, cudaStream_t s) {
  kernel_of<NCOEFF>(relu, diffuse)<<<T, R * slab::Lanes<NCOEFF>::L, 0, s>>>(prm);
  return (int)cudaGetLastError();
}

template <int NCOEFF>
int occupancy(int R, int relu, int diffuse, int* regs_blocks) {
  const void* kern = (const void*)kernel_of<NCOEFF>(relu, diffuse);
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kern);
  if (err != 0) return err;
  regs_blocks[0] = attr.numRegs;
  regs_blocks[2] = R * slab::Lanes<NCOEFF>::L;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&regs_blocks[1], kern,
                                                            regs_blocks[2], 0);
}

}  // namespace

// One launch: a block per tile (T), L lanes a ray (R = 64 or 256 rays). The
// tables hold global group indices; ``group_offset`` rebases them onto the
// grid operand.
extern "C" int plane_march_launch(const void* tables, const int* counts, const float* rays,
                                  const void* grid, float* out, int T, int G, int R, int XG,
                                  int U, int V, int ncoeff, int relu, int with_diffuse,
                                  int group_offset, float exit_eps, void* stream) {
  if (T <= 0) return 0;
  if ((R != 64 && R != 256) || XG <= 0) return (int)cudaErrorInvalidValue;
  Params prm{reinterpret_cast<const int4*>(tables), counts, rays,
             reinterpret_cast<const __nv_bfloat16*>(grid), out, T, G, U, V, group_offset,
             exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncoeff) {
    case 1: return dispatch<1>(prm, T, R, relu, with_diffuse, s);
    case 4: return dispatch<4>(prm, T, R, relu, with_diffuse, s);
    case 9: return dispatch<9>(prm, T, R, relu, with_diffuse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch's shape on this card: ptxas's registers a thread, the blocks
// an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the
// threads a block, into ``regs_blocks_threads`` [3].
extern "C" int plane_march_occupancy(int R, int ncoeff, int relu, int with_diffuse,
                                     int* regs_blocks_threads) {
  switch (ncoeff) {
    case 1: return occupancy<1>(R, relu, with_diffuse, regs_blocks_threads);
    case 4: return occupancy<4>(R, relu, with_diffuse, regs_blocks_threads);
    case 9: return occupancy<9>(R, relu, with_diffuse, regs_blocks_threads);
    default: return (int)cudaErrorInvalidValue;
  }
}
