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
// block owns a tile and a thread a ray (R = 256 or 64); a thread gathers each
// live position's nonzero taps (plane_march.cuh, slab_march.cuh: at most four
// 56-byte records at SH degree 2), keeps the previous position's fold in
// registers and composites a cell as soon as both its positions are known.
// Each entry's cells sum into a zeroed partial that is then added to the
// state, as the TPU kernel's per-entry accumulator does. After every entry the
// block votes (__syncthreads_or) whether any ray's transmittance is still above
// exit_eps, as the TPU kernel's while condition does before each entry.
//
// Bound on the H100: memory. The function reads each table entry, ray record
// and the patch records its positions' taps touch, and writes [T, R, 8] f32.
// Neighbouring rays of a tile sample neighbouring grid vertices, so a warp's
// gathers share sectors; the patch is not staged in shared memory (a later
// step). Built with -fmad=false.
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
  int G, U, V, goff;
  float exit_eps;
};

template <int NCOEFF, bool RELU, bool DIFFUSE>
__global__ void plane_march_kernel(Params prm) {
  const int t = blockIdx.x;
  const int R = blockDim.x;
  const size_t ray_id = (size_t)t * R + threadIdx.x;
  slab::Ray<NCOEFF> ray;
  ray.load(prm.rays + ray_id * slab::RAY_LANES);
  const int count = min(prm.counts[t], prm.G);

  float T = 1.0f;
  float state[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < count; ++i) {
    if (!__syncthreads_or(T > prm.exit_eps)) break;  // uniform over the tile
    slab::Entry e;
    e.load(prm.tables + (size_t)t * prm.G + i);
    const float base = (float)(e.xg * STRIDE);
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float Tc = T;
    slab::Sample s;
    Pos prev = position<NCOEFF>(prm.grid, ray, e, 0, prm.U, prm.V, prm.goff, s);
#pragma unroll
    for (int k = 1; k < GS; ++k) {
      const Pos cur = position<NCOEFF>(prm.grid, ray, e, k, prm.U, prm.V, prm.goff, s);
      // a dead cell has alpha 0: it adds zeros and leaves T
      if (prev.live && cur.live) {
        const Cell<RELU, DIFFUSE> cell(prev, cur, ray, base, k - 1);
        const float w = cell.alpha * Tc;
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = acc[c] + cell.mid[c] * w;
        acc[3] = acc[3] + w;
        acc[4] = acc[4] + w * cell.s_dep;
        if constexpr (DIFFUSE) {
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[5 + c] = acc[5 + c] + cell.dmid[c] * w;
        }
        Tc = Tc * (1.0f - cell.alpha);
      }
      prev = cur;
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
  auto kern = relu ? (diffuse ? plane_march_kernel<NCOEFF, true, true>
                              : plane_march_kernel<NCOEFF, true, false>)
                   : (diffuse ? plane_march_kernel<NCOEFF, false, true>
                              : plane_march_kernel<NCOEFF, false, false>);
  kern<<<T, R, 0, s>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: a block per tile (T), a thread per ray (R = 64 or 256). The
// tables hold global group indices; ``group_offset`` rebases them onto the
// grid operand.
extern "C" int plane_march_launch(const void* tables, const int* counts, const float* rays,
                                  const void* grid, float* out, int T, int G, int R, int XG,
                                  int U, int V, int ncoeff, int relu, int with_diffuse,
                                  int group_offset, float exit_eps, void* stream) {
  if (T <= 0) return 0;
  if ((R != 64 && R != 256) || XG <= 0) return (int)cudaErrorInvalidValue;
  Params prm{reinterpret_cast<const int4*>(tables), counts, rays,
             reinterpret_cast<const __nv_bfloat16*>(grid), out, G, U, V, group_offset,
             exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncoeff) {
    case 1: return dispatch<1>(prm, T, R, relu, with_diffuse, s);
    case 4: return dispatch<4>(prm, T, R, relu, with_diffuse, s);
    case 9: return dispatch<9>(prm, T, R, relu, with_diffuse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
