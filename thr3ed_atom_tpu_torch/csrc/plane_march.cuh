// plane_march: what the plane-march render (plane_march.cu, K11) and its replay
// backward (plane_march_backward.cu, K12) share: one position of a table entry
// and the cell between two positions.
//
// The TPU kernels (thr3ed_atom_tpu/ops/pallas/plane_march.py) interpolate each
// ray at the GS = 8 positions of an entry with one one-hot MXU product over a
// [PU, PV] = [16, 24] patch of the repacked grid [XG, U, V, 256] (position k
// of group g in lanes 32 k .. 32 k + 31), then integrate the 7 cells between
// consecutive positions in closed form (relu_trap, K1a). Groups overlap by one
// position: position k of group xg is global position xg * 7 + k.
//
// A position samples exactly as a slab of the slab march does (slab_march.cuh
// on the plane march's shape: bf16 tents, at most 2 x 2 nonzero taps summed in
// ascending patch row, taps outside the patch dropped); a dead position (outside
// [jmin, jmax] or the entry's subrange) interpolates to 0. Its fold keeps the
// raw values: the density lane 3 ncoeff, the SH-folded colour (lanes c < 3
// ncoeff in ascending c) and the band-0 colour. A cell is composited only when
// both of its positions are live; its colour is the sigmoid of the raw colours
// lerped to the density centroid tbar, its depth sits at the centroid.
// Built with -fmad=false, so each f32 operation rounds as in the plain version.
#pragma once

#include "relu_trap.cuh"
#include "slab_march.cuh"

namespace planes {

constexpr int GS = 8;          // positions per entry
constexpr int STRIDE = GS - 1;  // group step: groups overlap by one position
constexpr int LAN = 256;       // lanes per grid row (GS positions of 32 lanes)
using Geom = slab::Geom<STRIDE, 16, 24, LAN>;

// One position of an entry: liveness, raw density, raw SH-folded rgb and raw
// band-0 (diffuse) colour; zeros for a dead position.
struct Pos {
  bool live;
  float sigma, rgb[3], dif[3];
};

template <int NCOEFF>
__device__ __forceinline__ Pos position(const __nv_bfloat16* __restrict__ grid,
                                        const slab::Ray<NCOEFF>& ray, const slab::Entry& e,
                                        int k, int U, int V, int goff, slab::Sample& s) {
  constexpr int NUSED = 3 * NCOEFF + 1;
  Pos p;
  s = slab::sample<Geom>(ray, e, k, U, V, goff);
  p.live = s.live;
  if (!s.live) {
    p.sigma = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) p.rgb[c] = p.dif[c] = 0.0f;
    return p;
  }
  float ch[NUSED];
  slab::interp<NUSED>(grid, s, ch);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float a = ch[c * NCOEFF] * ray.y[c * NCOEFF];
    p.dif[c] = a;
#pragma unroll
    for (int j = 1; j < NCOEFF; ++j) a = a + ch[c * NCOEFF + j] * ray.y[c * NCOEFF + j];
    p.rgb[c] = a;
  }
  p.sigma = ch[3 * NCOEFF];
  return p;
}

// The cell between live positions a and b (cell c of an entry whose first
// global position is ``base``): opacity, emission centroid and the integral's
// endpoint derivatives, the emitted colours and the centroid's depth.
template <bool RELU, bool DIFFUSE>
struct Cell {
  float alpha, tbar, dIda, dIdb, mid[3], dmid[3], s_dep;
  template <int NCOEFF>
  __device__ __forceinline__ Cell(const Pos& a, const Pos& b, const slab::Ray<NCOEFF>& ray,
                                  float base, int c) {
    float integ;
    relu_trap<RELU>(a.sigma, b.sigma, integ, tbar, dIda, dIdb);
    alpha = fminf(fmaxf(1.0f - expf(-integ * ray.delta), 0.0f), 1.0f);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      mid[j] = slab::sigmoid((1.0f - tbar) * a.rgb[j] + tbar * b.rgb[j]);
      dmid[j] = DIFFUSE ? slab::sigmoid((1.0f - tbar) * a.dif[j] + tbar * b.dif[j]) : 0.0f;
    }
    s_dep = ray.at + ray.bt * ((base + (float)c) + tbar);
  }
};

}  // namespace planes
