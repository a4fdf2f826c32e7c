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
// the card, so each tap's product bf16(W) * bf16(d_interp) (exact in f32) is
// added into the f32 cotangent with atomicAdd: the sums round in another
// order than the plain version's (f32 round-off before the caller's bf16
// cast of the cotangent).
//
// Bound on the H100: the atomics. The function reads what K9 reads plus the
// forward totals and the output cotangent, and adds (3 ncoeff + 1) values per
// nonzero tap of every live sample into the cotangent (written once: 4 bytes
// per element of the grid). Built with -fmad=false.
#include <cuda_runtime.h>

#include "slab_march.cuh"

namespace {

using namespace slab;

struct Params {
  const int4* tables;  // [T, G]
  const int* counts;   // [T]
  const float* rays;   // [T, R, 48]
  const __nv_bfloat16* grid;  // [XG, U, V, 128]
  const float* fwd;    // [T, R, 8] forward totals
  const float* gout;   // [T, R, 8] output cotangent
  float* dgrid;        // [XG, U, V, 128] f32, zeroed by the caller
  int G, U, V;
  float exit_eps;
};

template <int NCOEFF, bool RELU, bool DIFFUSE>
__global__ void slab_march_backward_kernel(Params prm) {
  constexpr int NF = 3 * NCOEFF;
  constexpr int NUSED = NF + 1;
  const int t = blockIdx.x;
  const int R = blockDim.x;
  const size_t ray_id = (size_t)t * R + threadIdx.x;
  Ray<NCOEFF> ray;
  ray.load(prm.rays + ray_id * RAY_LANES);
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
    Entry e;
    e.load(prm.tables + (size_t)t * prm.G + i);
#pragma unroll
    for (int b = 0; b < GS; ++b) {
      const Sample s = sample<SlabGeom, NCOEFF>(ray, e, b, prm.U, prm.V, 0);
      if (!s.live) continue;  // no taps, no contribution, T unchanged
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
      float d_int[NUSED];
#pragma unroll
      for (int chn = 0; chn < NF; ++chn) {
        const int c = chn / NCOEFF, k = chn % NCOEFF;
        float d = d_rgb[c];
        if (DIFFUSE && k == 0) d = d + d_dif[c];
        d_int[chn] = bf16r(d * ray.y[chn]);
      }
      d_int[NF] = bf16r(dsig);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (s.w[k] == 0.0f) continue;
        float* dst = prm.dgrid + s.off[k];
#pragma unroll
        for (int chn = 0; chn < NUSED; ++chn) {
          if (d_int[chn] != 0.0f) atomicAdd(dst + chn, s.w[k] * d_int[chn]);
        }
      }
      T = T * (1.0f - sh.alpha);
    }
  }
}

template <int NCOEFF>
int dispatch(const Params& prm, int T, int R, int relu, int diffuse, cudaStream_t s) {
  auto kern = relu ? (diffuse ? slab_march_backward_kernel<NCOEFF, true, true>
                              : slab_march_backward_kernel<NCOEFF, true, false>)
                   : (diffuse ? slab_march_backward_kernel<NCOEFF, false, true>
                              : slab_march_backward_kernel<NCOEFF, false, false>);
  kern<<<T, R, 0, s>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: a block per tile (T), a thread per ray (R = 64 or 256); dgrid
// must hold zeros (or a cotangent to add to). ``reserved`` must be 0.
extern "C" int slab_march_backward_launch(const void* tables, const int* counts,
                                          const float* rays, const void* grid,
                                          const float* fwd, const float* gout, float* dgrid,
                                          int T, int G, int R, int XG, int U, int V,
                                          int ncoeff, int relu, int with_diffuse,
                                          int reserved, float exit_eps, void* stream) {
  if (T <= 0) return 0;
  if ((R != 64 && R != 256) || XG <= 0 || reserved != 0) return (int)cudaErrorInvalidValue;
  Params prm{reinterpret_cast<const int4*>(tables), counts, rays,
             reinterpret_cast<const __nv_bfloat16*>(grid), fwd, gout, dgrid, G, U, V,
             exit_eps};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncoeff) {
    case 1: return dispatch<1>(prm, T, R, relu, with_diffuse, s);
    case 4: return dispatch<4>(prm, T, R, relu, with_diffuse, s);
    case 9: return dispatch<9>(prm, T, R, relu, with_diffuse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
