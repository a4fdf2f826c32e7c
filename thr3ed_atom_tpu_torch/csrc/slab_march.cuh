// slab_march: what the slab-march render (slab_march.cu, K9) and its replay
// backward (slab_march_backward.cu, K10) share: the tile's table entries, one
// ray's record, and the sample a ray takes of one slab of an entry.
//
// The TPU kernels (thr3ed_atom_tpu/ops/pallas/slab_march.py) build, per
// (tile, entry), the bilinear tent weights W [GS R, PU PV] of every ray's
// GS samples over the [PU, PV] patch anchored at (u0, v0) and interpolate with
// one MXU product W @ patch (bf16 in, f32 sum). A row of W holds at most 2 x 2
// nonzero taps: the tent max(0, 1 - |bf16(u - uq)|) is nonzero only for uq =
// floor(u) and floor(u) + 1, and likewise along v. Every bf16 x bf16 product
// is exact in f32, so summing a sample's nonzero taps in ascending patch row
// (u-major, then v) gives the product's value; taps outside the patch are
// not in W and are dropped here too. A thread owns a ray and gathers its
// taps' used channels (3 ncoeff + 1 bf16, 16-byte loads) straight from the
// repacked grid [XG, U, V, 128] in device memory.
//
// Roundings follow the reference: u and v in f32, u - uq rounded to bf16,
// 1 - |du| rounded to bf16, the weight wu * wv rounded to bf16; the colour
// folds over lanes c < 3 ncoeff in ascending c. Built with -fmad=false, so
// each f32 operation rounds as in the plain PyTorch version.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace slab {

constexpr int GS = 4;      // slabs per group
constexpr int LPS = 32;    // lanes per slab
constexpr int LAN = 128;   // lanes per grid row (GS slabs)
constexpr int PU = 24;     // patch extent along u
constexpr int PV = 32;     // patch extent along v
constexpr int RAY_LANES = 48;
constexpr int L_Y0 = 16;   // first SH basis lane of a ray record

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// the bf16 tent weight of patch line k for coordinate c, zero outside [0, n)
__device__ __forceinline__ float tent(float c, float k, int n) {
  const float du = bf16r(c - k);
  const float w = fmaxf(bf16r(1.0f - fabsf(du)), 0.0f);
  return (k >= 0.0f && k <= (float)(n - 1)) ? w : 0.0f;
}

template <int NCOEFF>
struct Ray {
  static constexpr int NF = 3 * NCOEFF;
  float au, bu, av, bv, at, bt, jmin, jmax, delta;
  float y[NF];
  __device__ __forceinline__ void load(const float* rec) {
    au = rec[0]; bu = rec[1]; av = rec[2]; bv = rec[3]; at = rec[4]; bt = rec[5];
    jmin = rec[6]; jmax = rec[7]; delta = rec[8];
#pragma unroll
    for (int c = 0; c < NF; ++c) y[c] = rec[L_Y0 + c];
  }
};

// The march's shape: samples per group step (STRIDE), the patch extent
// (PU, PV) and the lanes of a grid row (LAN). The plane march (plane_march.cuh)
// samples the same way on its own shape.
template <int STRIDE_, int PU_, int PV_, int LAN_>
struct Geom {
  static constexpr int STRIDE = STRIDE_, PU = PU_, PV = PV_, LAN = LAN_;
};
using SlabGeom = Geom<GS, PU, PV, LAN>;

// One table entry: (group xg, patch origin u0 / v0, slab subrange jlo..jhi).
struct Entry {
  int xg, u0, v0, jlo, jhi;
  __device__ __forceinline__ void load(const int4* tab) {
    const int4 e = *tab;
    xg = e.x; u0 = e.y; v0 = e.z; jlo = e.w / 256; jhi = e.w % 256;
  }
};

// The sample of slab b of an entry: its global slab index, liveness, the
// four taps' bf16 weights (zero for a dropped tap) in ascending patch row,
// the patch cell (ku, kv) = (floor(u), floor(v)) whose corners they are
// (tap tu * 2 + tv at patch row ku + tu, column kv + tv; -1 .. PU - 1 and
// -1 .. PV - 1 where a tap is live), and the element offsets of their
// 32-lane slab blocks in the grid. ``goff`` rebases the table's group index
// onto the grid operand.
struct Sample {
  float jg;
  bool live;
  float w[4];
  int ku, kv;
  size_t off[4];
};

template <class G, int NCOEFF>
__device__ __forceinline__ Sample sample(const Ray<NCOEFF>& ray, const Entry& e, int b,
                                         int U, int V, int goff) {
  Sample s;
  s.jg = (float)e.xg * (float)G::STRIDE + (float)b;
  s.live = s.jg >= ray.jmin && s.jg <= ray.jmax && e.jlo <= b && b <= e.jhi;
  if (!s.live) return s;
  const float u = ray.au + ray.bu * s.jg - (float)e.u0;
  const float v = ray.av + ray.bv * s.jg - (float)e.v0;
  const float ku = floorf(u), kv = floorf(v);
  s.ku = (int)fminf(fmaxf(ku, -2.0f), (float)G::PU);
  s.kv = (int)fminf(fmaxf(kv, -2.0f), (float)G::PV);
  float wu[2], wv[2];
  int iu[2], iv[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    wu[t] = tent(u, ku + (float)t, G::PU);
    wv[t] = tent(v, kv + (float)t, G::PV);
    iu[t] = wu[t] != 0.0f ? (int)(ku + (float)t) : 0;
    iv[t] = wv[t] != 0.0f ? (int)(kv + (float)t) : 0;
  }
#pragma unroll
  for (int tu = 0; tu < 2; ++tu) {
#pragma unroll
    for (int tv = 0; tv < 2; ++tv) {
      const int k = tu * 2 + tv;
      s.w[k] = bf16r(wu[tu] * wv[tv]);
      const int gu = e.u0 + iu[tu], gv = e.v0 + iv[tv];
      if (gu >= U || gv >= V) s.w[k] = 0.0f;  // a table past the grid reads nothing
      s.off[k] = (((size_t)(e.xg - goff) * U + gu) * V + gv) * G::LAN + (size_t)b * LPS;
    }
  }
  return s;
}

// The sample's used channels: the nonzero taps' exact products summed in
// ascending patch row.
template <int NUSED>
__device__ __forceinline__ void interp(const __nv_bfloat16* __restrict__ grid,
                                       const Sample& s, float* ch) {
  constexpr int NG = (NUSED + 7) / 8;
#pragma unroll
  for (int c = 0; c < NUSED; ++c) ch[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (s.w[k] == 0.0f) continue;
    const uint4* src = reinterpret_cast<const uint4*>(grid + s.off[k]);
#pragma unroll
    for (int gidx = 0; gidx < NG; ++gidx) {
      const uint4 raw = __ldg(src + gidx);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        const int c = gidx * 8 + 2 * i;
        if (c < NUSED) ch[c] = ch[c] + s.w[k] * f.x;
        if (c + 1 < NUSED) ch[c + 1] = ch[c + 1] + s.w[k] * f.y;
      }
    }
  }
}

// The sample's shading: rgb and band-0 (diffuse) colour through the sigmoid,
// the raw and post-activated density, the opacity.
template <int NCOEFF, bool RELU>
struct Shade {
  float rgb[3], dif[3], sigma_raw, sigma, alpha;
  __device__ __forceinline__ Shade(const float* ch, const Ray<NCOEFF>& ray) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float a = ch[c * NCOEFF] * ray.y[c * NCOEFF];
      dif[c] = sigmoid(a);
#pragma unroll
      for (int k = 1; k < NCOEFF; ++k) a = a + ch[c * NCOEFF + k] * ray.y[c * NCOEFF + k];
      rgb[c] = sigmoid(a);
    }
    sigma_raw = ch[3 * NCOEFF];
    sigma = RELU ? fmaxf(sigma_raw, 0.0f) : sigma_raw;
    alpha = fminf(fmaxf(1.0f - expf(-sigma * ray.delta), 0.0f), 1.0f);
  }
};

}  // namespace slab
