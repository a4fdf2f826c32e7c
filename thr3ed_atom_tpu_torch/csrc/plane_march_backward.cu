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
// dI_a of cell k and dI_b of cell k - 1. Blocks run in no order on the card, so
// each tap's product bf16(W) * bf16(d_interp) (exact in f32) is added into the
// f32 cotangent with atomicAdd, in the position's own lane block: the sums
// round in another order than the plain version's (f32 round-off before the
// caller's bf16 cast of the cotangent).
//
// Bound on the H100: the atomics. The function reads what K11 reads plus the
// forward totals and the output cotangent, and adds (3 ncoeff + 1) values per
// nonzero tap of every live position into the cotangent (written once: 4 bytes
// per element of the grid). Built with -fmad=false.
#include <cuda_runtime.h>

#include "plane_march.cuh"

namespace {

using namespace planes;

struct Params {
  const int4* tables;  // [T, G]
  const int* counts;   // [T]
  const float* rays;   // [T, R, 48]
  const __nv_bfloat16* grid;  // [XG, U, V, 256]
  const float* fwd;    // [T, R, 8] forward totals
  const float* gout;   // [T, R, 8] output cotangent
  float* dgrid;        // [XG, U, V, 256] f32, zeroed by the caller
  int G, U, V, goff;
  float exit_eps;
};

// A position's cotangent: density, raw rgb and raw band-0 colour.
struct DPos {
  float sig, rgb[3], dif[3];
};

// Add a live position's channel cotangents, rounded to bf16, times its taps'
// weights into the grid cotangent.
template <int NCOEFF, bool DIFFUSE>
__device__ __forceinline__ void scatter(float* __restrict__ dgrid, const slab::Sample& s,
                                        const slab::Ray<NCOEFF>& ray, const DPos& d) {
  constexpr int NF = 3 * NCOEFF;
  float d_int[NF + 1];
#pragma unroll
  for (int chn = 0; chn < NF; ++chn) {
    const int c = chn / NCOEFF;
    float v = d.rgb[c];
    if (DIFFUSE) v = v + (chn % NCOEFF == 0 ? d.dif[c] : 0.0f);
    d_int[chn] = slab::bf16r(v * ray.y[chn]);
  }
  d_int[NF] = slab::bf16r(d.sig);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (s.w[k] == 0.0f) continue;
    float* dst = dgrid + s.off[k];
#pragma unroll
    for (int chn = 0; chn <= NF; ++chn) {
      if (d_int[chn] != 0.0f) atomicAdd(dst + chn, s.w[k] * d_int[chn]);
    }
  }
}

template <int NCOEFF, bool RELU, bool DIFFUSE>
__global__ void plane_march_backward_kernel(Params prm) {
  const int t = blockIdx.x;
  const int R = blockDim.x;
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
    slab::Sample s_prev, s_cur;
    Pos prev = position<NCOEFF>(prm.grid, ray, e, 0, prm.U, prm.V, prm.goff, s_prev);
    // the previous cell's share of the current position (dI_b, tbar parts)
    DPos pend = {0.0f, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int k = 1; k < GS; ++k) {
      const Pos cur = position<NCOEFF>(prm.grid, ray, e, k, prm.U, prm.V, prm.goff, s_cur);
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
      // position k - 1 is complete: cell k - 1's a-share plus cell k - 2's b-share
      if (prev.live) {
        DPos d;
        d.sig = da.sig + pend.sig;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          d.rgb[c] = da.rgb[c] + pend.rgb[c];
          d.dif[c] = da.dif[c] + pend.dif[c];
        }
        scatter<NCOEFF, DIFFUSE>(prm.dgrid, s_prev, ray, d);
      }
      pend = db;
      prev = cur;
      s_prev = s_cur;
    }
    if (prev.live) {  // the last position: cell GS - 2's b-share only
      DPos d;
      d.sig = 0.0f + pend.sig;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d.rgb[c] = 0.0f + pend.rgb[c];
        d.dif[c] = 0.0f + pend.dif[c];
      }
      scatter<NCOEFF, DIFFUSE>(prm.dgrid, s_prev, ray, d);
    }
  }
}

template <int NCOEFF>
int dispatch(const Params& prm, int T, int R, int relu, int diffuse, cudaStream_t s) {
  auto kern = relu ? (diffuse ? plane_march_backward_kernel<NCOEFF, true, true>
                              : plane_march_backward_kernel<NCOEFF, true, false>)
                   : (diffuse ? plane_march_backward_kernel<NCOEFF, false, true>
                              : plane_march_backward_kernel<NCOEFF, false, false>);
  kern<<<T, R, 0, s>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: a block per tile (T), a thread per ray (R = 64 or 256); dgrid
// must hold zeros (or a cotangent to add to). ``group_offset`` rebases the
// tables' global group indices onto the grid operand.
extern "C" int plane_march_backward_launch(const void* tables, const int* counts,
                                           const float* rays, const void* grid,
                                           const float* fwd, const float* gout, float* dgrid,
                                           int T, int G, int R, int XG, int U, int V,
                                           int ncoeff, int relu, int with_diffuse,
                                           int group_offset, float exit_eps, void* stream) {
  if (T <= 0) return 0;
  if ((R != 64 && R != 256) || XG <= 0) return (int)cudaErrorInvalidValue;
  Params prm{reinterpret_cast<const int4*>(tables), counts, rays,
             reinterpret_cast<const __nv_bfloat16*>(grid), fwd, gout, dgrid, G, U, V,
             group_offset, exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncoeff) {
    case 1: return dispatch<1>(prm, T, R, relu, with_diffuse, s);
    case 4: return dispatch<4>(prm, T, R, relu, with_diffuse, s);
    case 9: return dispatch<9>(prm, T, R, relu, with_diffuse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
