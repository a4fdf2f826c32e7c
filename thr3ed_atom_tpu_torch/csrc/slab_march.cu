// slab_march: the bricked renderer's fused slab-march render (K9): per ray
// tile, front to back over the tile's table entries, the bilinear samples of
// the entry's live slabs, the SH fold, the sigmoid tone map and alpha
// compositing with 1 - exp(-sigma delta), with a per-tile early exit.
//
// Replaces the TPU kernel thr3ed_atom_tpu/ops/pallas/slab_march.py
// slab_march_render (kernel _make_forward_kernel): a grid step per tile that
// DMAs each entry's [PU, PV, 128] bf16 patch into VMEM and interpolates all
// GS x R samples with one one-hot MXU product. Here a block owns a tile (R =
// 256 or 64 rays) and a group of L lanes a ray (slab_march.cuh ``Lanes``: 2
// at SH degree 2, so 512 threads a 256-ray tile, two blocks an SM at 64
// registers a thread): the group shares out its sample's tents, each lane
// gathers its channels of the sample's nonzero taps (at most four 56-byte
// records at SH degree 2), the colours fold on their owner lanes, and
// every lane keeps the ray's transmittance and its own colours' sums in
// registers; the SH basis waits in shared memory. The tile's per-entry exit
// vote (the TPU kernel's while condition before each entry) is split in
// two (``LaggedVote``): a warp votes when it has an entry and marches the
// next one before it reads the outcome, so no block-wide barrier stalls the
// SM between entries. Blocks take the tiles longest first
// (``tile_by_entries``).
//
// Bound on the H100: the issue of the per-sample arithmetic and the
// longest tile's serial march, not the bytes (the function reads each table
// entry, ray record and the patch records its samples' taps touch, and
// writes [T, R, 8] f32). The patch is not staged in shared memory: with
// every tap read from a 64-row set that stays in cache, the pose is at most
// ~20% faster (PERF.md §6). Built with -fmad=false.
#include <cuda_runtime.h>

#include "slab_march.cuh"

namespace {

using namespace slab;

struct Params {
  const int4* tables;  // [T, G] entries (xg, u0, v0, jlo * 256 + jhi)
  const int* counts;   // [T]
  const float* rays;   // [T, R, 48]
  const __nv_bfloat16* grid;  // [XG, U, V, 128]
  float* out;          // [T, R, 8]
  int T, G, U, V, goff;
  float exit_eps;
};

template <int NCOEFF, bool RELU, bool DIFFUSE>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) slab_march_kernel(Params prm) {
  using Q = Lanes<NCOEFF>;
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ float4 s_y[Q::CPL / 4 * MAX_RAYS * Q::L];
  __shared__ unsigned long long vote_bar[2];
  __shared__ int vote_flag[2];
  __shared__ TileOrder order;
  const int t = tile_by_entries(prm.counts, prm.T, prm.G, order);
  const int R = blockDim.x / Q::L;
  const int g = threadIdx.x % Q::L;  // lane in the ray's group
  const size_t ray_id = (size_t)t * R + threadIdx.x / Q::L;
  const int c0 = Q::first(g), c1 = Q::first(g + 1);  // the colours this lane folds
  const bool dens = g == Q::owner(Q::NF);  // the lane that writes acc and depth
  LaneRay<NCOEFF> ray;
  ray.load(prm.rays + ray_id * RAY_LANES, g, s_y);
  const int count = min(prm.counts[t], prm.G);
  LaggedVote vote{vote_bar, vote_flag};
  vote.init(blockDim.x / 32);

  float T = 1.0f;
  // this lane's outputs: its colours' rgb and diffuse sums, acc, depth
  float st_rgb[Q::S], st_dif[Q::S], st_acc = 0.0f, st_dep = 0.0f;
#pragma unroll
  for (int s = 0; s < Q::S; ++s) st_rgb[s] = st_dif[s] = 0.0f;
  // every ray's transmittance is 1 before the first entry
  const int n_entries = 1.0f > prm.exit_eps ? count : 0;
  for (int i = 0; i < n_entries; ++i) {
    Entry e;
    e.load(prm.tables + (size_t)t * prm.G + i);
    float a_rgb[Q::S], a_dif[Q::S], a_acc = 0.0f, a_dep = 0.0f;
#pragma unroll
    for (int s = 0; s < Q::S; ++s) a_rgb[s] = a_dif[s] = 0.0f;
    float Tc = T;
#pragma unroll
    for (int b = 0; b < GS; ++b) {
      // a dead sample adds zeros and leaves T; a warp whose samples are all
      // dead skips the step (uniform over the warp: the fold shuffles)
      const LaneSample s = lane_sample<SlabGeom, Q::L>(ray, e, b, prm.U, prm.V, prm.goff, g);
      if (!__any_sync(FULL, s.live)) continue;
      float ch[Q::CPL];
      if (s.live) {
        interp_lane<Q::GPL>(prm.grid + b * LPS + g * Q::CPL, LAN, s, ch);
      } else {
#pragma unroll
        for (int c = 0; c < Q::CPL; ++c) ch[c] = 0.0f;
      }
      const LaneFold<NCOEFF> f(ch, ray, c0);
      if (!s.live) continue;
      const float sigma = RELU ? fmaxf(f.sigma, 0.0f) : f.sigma;
      const float alpha = fminf(fmaxf(1.0f - expf(-sigma * ray.delta), 0.0f), 1.0f);
      const float w = alpha * Tc;
#pragma unroll
      for (int k = 0; k < Q::S; ++k) {
        if (c0 + k < c1) {
          a_rgb[k] = a_rgb[k] + sigmoid(f.rgb[k]) * w;
          if constexpr (DIFFUSE) a_dif[k] = a_dif[k] + sigmoid(f.dif[k]) * w;
        }
      }
      a_acc = a_acc + w;
      a_dep = a_dep + w * (ray.at + ray.bt * s.jg);
      Tc = Tc * (1.0f - alpha);
    }
    if (i > 0 && !vote.runs(i)) break;  // the tile stopped before entry i
#pragma unroll
    for (int k = 0; k < Q::S; ++k) {
      st_rgb[k] = st_rgb[k] + a_rgb[k];
      st_dif[k] = st_dif[k] + a_dif[k];
    }
    st_acc = st_acc + a_acc;
    st_dep = st_dep + a_dep;
    T = Tc;
    if (i + 1 < n_entries) vote.cast(i + 1, T > prm.exit_eps);
  }
  float* o = prm.out + ray_id * 8;
#pragma unroll
  for (int k = 0; k < Q::S; ++k) {
    if (c0 + k < c1) {
      o[c0 + k] = st_rgb[k];
      o[5 + c0 + k] = st_dif[k];
    }
  }
  if (dens) {
    o[3] = st_acc;
    o[4] = st_dep;
  }
}

template <int NCOEFF>
auto kernel_of(int relu, int diffuse) {
  return relu ? (diffuse ? slab_march_kernel<NCOEFF, true, true>
                         : slab_march_kernel<NCOEFF, true, false>)
              : (diffuse ? slab_march_kernel<NCOEFF, false, true>
                         : slab_march_kernel<NCOEFF, false, false>);
}

template <int NCOEFF>
int dispatch(const Params& prm, int T, int R, int relu, int diffuse, cudaStream_t s) {
  kernel_of<NCOEFF>(relu, diffuse)<<<T, R * Lanes<NCOEFF>::L, 0, s>>>(prm);
  return (int)cudaGetLastError();
}

template <int NCOEFF>
int occupancy(int R, int relu, int diffuse, int* regs_blocks) {
  const void* kern = (const void*)kernel_of<NCOEFF>(relu, diffuse);
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kern);
  if (err != 0) return err;
  regs_blocks[0] = attr.numRegs;
  regs_blocks[2] = R * Lanes<NCOEFF>::L;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&regs_blocks[1], kern,
                                                            regs_blocks[2], 0);
}

}  // namespace

// One launch: a block per tile (T), L lanes a ray (R = 64 or 256 rays). The
// tables hold global group indices; ``group_offset`` rebases them onto the
// grid operand (a depth segment's groups).
extern "C" int slab_march_launch(const void* tables, const int* counts, const float* rays,
                                 const void* grid, float* out, int T, int G, int R, int XG,
                                 int U, int V, int ncoeff, int relu, int with_diffuse,
                                 int group_offset, float exit_eps, void* stream) {
  if (T <= 0) return 0;
  if ((R != 64 && R != 256) || XG <= 0 || group_offset < 0) return (int)cudaErrorInvalidValue;
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
extern "C" int slab_march_occupancy(int R, int ncoeff, int relu, int with_diffuse,
                                    int* regs_blocks_threads) {
  switch (ncoeff) {
    case 1: return occupancy<1>(R, relu, with_diffuse, regs_blocks_threads);
    case 4: return occupancy<4>(R, relu, with_diffuse, regs_blocks_threads);
    case 9: return occupancy<9>(R, relu, with_diffuse, regs_blocks_threads);
    default: return (int)cudaErrorInvalidValue;
  }
}
