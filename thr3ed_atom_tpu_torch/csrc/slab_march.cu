// slab_march: the bricked renderer's fused slab-march render (K9): per ray
// tile, front to back over the tile's table entries, the bilinear samples of
// the entry's live slabs, the SH fold, the sigmoid tone map and alpha
// compositing with 1 - exp(-sigma delta), with a per-tile early exit.
//
// Replaces the TPU kernel thr3ed_atom_tpu/ops/pallas/slab_march.py
// slab_march_render (kernel _make_forward_kernel): a grid step per tile that
// DMAs each entry's [PU, PV, 128] bf16 patch into VMEM and interpolates all
// GS x R samples with one one-hot MXU product. Here a block owns a tile and a
// thread a ray (R = 256 or 64); a thread gathers its samples' nonzero taps
// (slab_march.cuh; at most four 56-byte records per sample at SH degree 2)
// and keeps its transmittance and colour in registers. After every entry the
// block votes (__syncthreads_or) whether any ray's transmittance is still
// above exit_eps, as the TPU kernel's while condition does before each entry.
//
// Bound on the H100: memory. The function reads each table entry, ray record
// and the patch records its samples' taps touch, and writes [T, R, 8] f32.
// Neighbouring rays of a tile sample neighbouring grid vertices, so a warp's
// gathers share sectors; the patch is not staged in shared memory (a later
// step: TMA copies of each entry's patch). Built with -fmad=false.
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
  int G, U, V;
  float exit_eps;
};

template <int NCOEFF, bool RELU, bool DIFFUSE>
__global__ void slab_march_kernel(Params prm) {
  constexpr int NUSED = 3 * NCOEFF + 1;
  const int t = blockIdx.x;
  const int R = blockDim.x;
  const size_t ray_id = (size_t)t * R + threadIdx.x;
  Ray<NCOEFF> ray;
  ray.load(prm.rays + ray_id * RAY_LANES);
  const int count = min(prm.counts[t], prm.G);

  float T = 1.0f;
  float state[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < count; ++i) {
    if (!__syncthreads_or(T > prm.exit_eps)) break;  // uniform over the tile
    Entry e;
    e.load(prm.tables + (size_t)t * prm.G + i);
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float Tc = T;
#pragma unroll
    for (int b = 0; b < GS; ++b) {
      // a dead sample adds zeros and leaves T: skipped
      const Sample s = sample<SlabGeom, NCOEFF>(ray, e, b, prm.U, prm.V, 0);
      if (!s.live) continue;
      float ch[NUSED];
      interp<NUSED>(prm.grid, s, ch);
      const Shade<NCOEFF, RELU> sh(ch, ray);
      const float w = sh.alpha * Tc;
      const float s_dep = ray.at + ray.bt * s.jg;
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + sh.rgb[c] * w;
      acc[3] = acc[3] + w;
      acc[4] = acc[4] + w * s_dep;
      if constexpr (DIFFUSE) {
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[5 + c] = acc[5 + c] + sh.dif[c] * w;
      }
      Tc = Tc * (1.0f - sh.alpha);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) state[k] = state[k] + acc[k];
    T = Tc;
  }
  float4* o = reinterpret_cast<float4*>(prm.out + ray_id * 8);
  o[0] = make_float4(state[0], state[1], state[2], state[3]);
  o[1] = make_float4(state[4], state[5], state[6], state[7]);
}

template <int NCOEFF>
int dispatch(const Params& prm, int T, int R, int relu, int diffuse, cudaStream_t s) {
  auto kern = relu ? (diffuse ? slab_march_kernel<NCOEFF, true, true>
                              : slab_march_kernel<NCOEFF, true, false>)
                   : (diffuse ? slab_march_kernel<NCOEFF, false, true>
                              : slab_march_kernel<NCOEFF, false, false>);
  kern<<<T, R, 0, s>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: a block per tile (T), a thread per ray (R = 64 or 256).
// ``reserved`` must be 0.
extern "C" int slab_march_launch(const void* tables, const int* counts, const float* rays,
                                 const void* grid, float* out, int T, int G, int R, int XG,
                                 int U, int V, int ncoeff, int relu, int with_diffuse,
                                 int reserved, float exit_eps, void* stream) {
  if (T <= 0) return 0;
  if ((R != 64 && R != 256) || XG <= 0 || reserved != 0) return (int)cudaErrorInvalidValue;
  Params prm{reinterpret_cast<const int4*>(tables), counts, rays,
             reinterpret_cast<const __nv_bfloat16*>(grid), out, G, U, V, exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncoeff) {
    case 1: return dispatch<1>(prm, T, R, relu, with_diffuse, s);
    case 4: return dispatch<4>(prm, T, R, relu, with_diffuse, s);
    case 9: return dispatch<9>(prm, T, R, relu, with_diffuse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
