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
// not in W and are dropped here too. The taps' used channels (3 ncoeff + 1
// bf16, 16-byte loads) come straight from the repacked grid [XG, U, V, 128]
// in device memory: in the replay backwards (K10, K12) a thread owns a ray
// and gathers them all (``interp``); in the forward marches (K9, K11) a
// group of lanes owns a ray and each lane gathers its share of the channels
// of every tap (``Lanes``, below).
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

// A ray's geometry: u = au + bu j, v = av + bv j, depth at + bt j at global
// slab j, live for jmin <= j <= jmax, the step delta.
struct RayGeom {
  float au, bu, av, bv, at, bt, jmin, jmax, delta;
  __device__ __forceinline__ void load_geom(const float* rec) {
    au = rec[0]; bu = rec[1]; av = rec[2]; bv = rec[3]; at = rec[4]; bt = rec[5];
    jmin = rec[6]; jmax = rec[7]; delta = rec[8];
  }
};

template <int NCOEFF>
struct Ray : RayGeom {
  static constexpr int NF = 3 * NCOEFF;
  float y[NF];
  __device__ __forceinline__ void load(const float* rec) {
    load_geom(rec);
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

template <class G>
__device__ __forceinline__ Sample sample(const RayGeom& ray, const Entry& e, int b, int U,
                                         int V, int goff) {
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

// ---- The lane-group layout of the forward marches (K9, K11).
//
// L lanes of a warp serve one ray, each holding CPL of the sample's used
// channels: one 16-byte group or more (L = 2 at SH degree 2 and 1, 1 at
// degree 0; CPL = 16 at degree 2), so a warp holds 32 / L rays. At each
// sample the group shares out the tents of its taps (``lane_sample``), and
// lane g loads its CPL channels of every nonzero tap's 64-byte slab block:
// a warp's loads of a tap read 32 / L whole records, where a thread a ray
// read 16 bytes of each of 32 records a load. Lane g sums each of its
// channels over the taps in ascending patch row (``interp``'s per-channel
// sums, so the values are the same bit for bit). Colour c folds its NCOEFF
// channels in ascending order on the lane that holds the first of them (its
// owner), which takes the products it lacks from the lane holding them by
// __shfl_sync (2 at degree 2); every lane takes the density from the lane
// that holds it, so that each computes the opacity itself.
//
// Why two lanes and not four (one 16-byte group a lane): a 256-ray tile is
// a block, and four lanes make it 1024 threads, one block an SM at 64
// registers a thread, where two lanes keep two 512-thread blocks an SM; the
// quad also computes each ray's per-sample scalar work on four lanes. On
// the H100 the quad lost to the two lanes at every shape measured, and a
// thread a ray at 64 registers spilled (PERF.md §6).
constexpr int MAX_LANES = 2;  // lanes a ray at most
constexpr int MAX_RAYS = 256;  // rays a tile (16 x 16 pixels)
constexpr int MAX_THREADS = MAX_RAYS * MAX_LANES;  // a 256-ray tile's lanes
// blocks an SM the launch bounds ask for: 64 registers a thread
constexpr int MIN_BLOCKS = 1024 / MAX_THREADS > 0 ? 1024 / MAX_THREADS : 1;

// the first colour whose first channel lies on lane g or past it, for
// ``cpl`` channels a lane: lane g folds colours lane_first(g) ..
// lane_first(g + 1) - 1
__host__ __device__ constexpr int lane_first(int ncoeff, int cpl, int g) {
  int c = 0;
  while (c < 3 && c * ncoeff / cpl < g) ++c;
  return c;
}

// the most colours one of ``l`` lanes folds
__host__ __device__ constexpr int lane_slots(int ncoeff, int cpl, int l) {
  int n = 0;
  for (int g = 0; g < l; ++g) {
    const int k = lane_first(ncoeff, cpl, g + 1) - lane_first(ncoeff, cpl, g);
    n = k > n ? k : n;
  }
  return n;
}

template <int NCOEFF>
struct Lanes {
  static constexpr int NF = 3 * NCOEFF, NUSED = NF + 1;
  static constexpr int NG = (NUSED + 7) / 8;  // 16-byte groups of the used channels
  static constexpr int L = NG < MAX_LANES ? NG : MAX_LANES;  // lanes a ray
  static constexpr int GPL = NG / L;          // groups a lane
  static constexpr int CPL = 8 * GPL;         // channels a lane
  static constexpr int S = lane_slots(NCOEFF, CPL, L);  // colours a lane at most
  static_assert(NG % L == 0 && (L == 1 || L == 2 || L == 4),
                "a ray's lanes lie in one quad of a warp");
  __host__ __device__ static constexpr int owner(int ch) { return ch / CPL; }
  __device__ static int first(int g) { return lane_first(NCOEFF, CPL, g); }
};

// A sample on the lane-group layout: ``Sample``'s values, with the taps'
// grid rows ((xg - goff) U + gu) V + gv as 32-bit ints (fewer registers).
// The replay backwards keep ``Sample``: K10 files its rays by the patch
// cell (ku, kv).
struct LaneSample {
  float jg;
  bool live;
  float w[4];
  int row[4];
};

// ``sample`` on the lane-group layout: the tents of a sample's four taps
// (wu0, wu1, wv0, wv1) are shared out over the L lanes, each computing 4 / L
// of them, and exchanged by __shfl_sync; the rest as ``sample``, on every
// lane. Every lane of the warp must call it; the same values bit for bit.
template <class G, int L>
__device__ __forceinline__ LaneSample lane_sample(const RayGeom& ray, const Entry& e, int b,
                                                  int U, int V, int goff, int g) {
  constexpr int TPL = 4 / L;  // tents a lane
  LaneSample s;
  s.jg = (float)e.xg * (float)G::STRIDE + (float)b;
  s.live = s.jg >= ray.jmin && s.jg <= ray.jmax && e.jlo <= b && b <= e.jhi;
  const float u = ray.au + ray.bu * s.jg - (float)e.u0;
  const float v = ray.av + ray.bv * s.jg - (float)e.v0;
  const float ku = floorf(u), kv = floorf(v);
  float mine[TPL];
#pragma unroll
  for (int m = 0; m < TPL; ++m) {
    const int idx = g * TPL + m;  // 0, 1: u taps; 2, 3: v taps
    const bool along_u = idx < 2;
    mine[m] = tent(along_u ? u : v, (along_u ? ku : kv) + (float)(idx & 1),
                   along_u ? G::PU : G::PV);
  }
  float t4[4];
#pragma unroll
  for (int idx = 0; idx < 4; ++idx)
    t4[idx] = L == 1 ? mine[idx % TPL]
                     : __shfl_sync(0xffffffffu, mine[idx % TPL], idx / TPL, L);
  const float wu[2] = {t4[0], t4[1]}, wv[2] = {t4[2], t4[3]};
  int iu[2], iv[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    iu[t] = wu[t] != 0.0f ? (int)(ku + (float)t) : 0;
    iv[t] = wv[t] != 0.0f ? (int)(kv + (float)t) : 0;
  }
  const int base = ((e.xg - goff) * U + e.u0) * V + e.v0;
#pragma unroll
  for (int tu = 0; tu < 2; ++tu) {
#pragma unroll
    for (int tv = 0; tv < 2; ++tv) {
      const int k = tu * 2 + tv;
      s.w[k] = bf16r(wu[tu] * wv[tv]);
      if (e.u0 + iu[tu] >= U || e.v0 + iv[tv] >= V) s.w[k] = 0.0f;  // past the grid: nothing
      s.row[k] = base + iu[tu] * V + iv[tv];
    }
  }
  return s;
}

// The per-entry exit vote of a tile without a block-wide stall: a warp
// votes for entry i + 1 as soon as it has entry i (lane 0: an atomicMax of
// i + 1 into a shared flag where any of its rays' transmittance is above
// exit_eps, then an arrival on an mbarrier counting the block's warps),
// marches entry i + 1 into its per-entry partial and only then waits for
// the vote, adding the partial where the tile runs and dropping it where
// it stops. The block stops at the entry where the plain version's
// ``running`` does; a warp runs at most one entry ahead of the others.
// Two flags and mbarriers alternate: vote j (for entry j + 1) uses slot
// j % 2 in its phase (j / 2) % 2.
struct LaggedVote {
  unsigned long long* bar;  // [2] mbarriers in shared memory
  int* flag;                // [2] the latest entry voted to run
  __device__ __forceinline__ void init(int warps) {
    if (threadIdx.x < 2) {
      flag[threadIdx.x] = -1;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       (unsigned)__cvta_generic_to_shared(bar + threadIdx.x)),
                   "r"(warps)
                   : "memory");
    }
    __syncthreads();
  }
  // vote for entry i (i >= 1) from this warp's rays' transmittance
  __device__ __forceinline__ void cast(int i, bool above) {
    const bool any = __any_sync(0xffffffffu, above);
    if ((threadIdx.x & 31) == 0) {
      const int j = i - 1;
      if (any) atomicMax(flag + (j & 1), i);
      unsigned long long state;
      asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
                   : "=l"(state)
                   : "r"((unsigned)__cvta_generic_to_shared(bar + (j & 1)))
                   : "memory");
    }
  }
  // whether the tile runs entry i: waits for every warp's vote
  __device__ __forceinline__ bool runs(int i) {
    const int j = i - 1;
    const unsigned addr = (unsigned)__cvta_generic_to_shared(bar + (j & 1));
    asm volatile(
        "{\n .reg .pred p;\n WAIT_%=:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        " @!p bra WAIT_%=;\n}" ::"r"(addr),
        "r"((unsigned)((j >> 1) & 1))
        : "memory");
    return *(volatile int*)(flag + (j & 1)) == i;
  }
};

// The tile block ``blockIdx.x`` marches: blocks take the tiles in
// descending order of their entries (ties by tile index), so that the
// longest tiles start first and the short ones fill in behind them (a
// pose's tables run from 0 to ~4x the mean entries a tile, and a block
// holds an SM's warps for its tile's whole march). Every block ranks the
// counts itself, with no launch and no scratch in device memory: a
// histogram of min(count, G, NB - 1) in shared memory, warp 0's scan of it
// from the top, then the k-th tile of the rank's bucket by index. Each
// block reads all T counts (T^2 reads a launch: ~25 MB from L2 at 2500
// tiles). Every thread of the block must call it.
constexpr int ORDER_BUCKETS = 256;

struct TileOrder {
  int hist[ORDER_BUCKETS];
  int warp_count[32];
  int bucket, k, tile;
};

__device__ __forceinline__ int tile_by_entries(const int* counts, int T, int G, TileOrder& o) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int NB = ORDER_BUCKETS;
  const int tid = threadIdx.x, n = blockDim.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < NB; c += n) o.hist[c] = 0;
  __syncthreads();
  for (int t = tid; t < T; t += n) atomicAdd(&o.hist[min(min(counts[t], G), NB - 1)], 1);
  __syncthreads();
  if (warp == 0) {
    // lane l holds buckets NB - 1 - 8 l .. NB - 8 - 8 l, from the top
    int loc[NB / 32], sum = 0;
#pragma unroll
    for (int m = 0; m < NB / 32; ++m) {
      loc[m] = o.hist[NB - 1 - (NB / 32) * lane - m];
      sum += loc[m];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    int start = incl - sum;
    const int r = blockIdx.x;
    if (r >= start && r < incl) {
#pragma unroll
      for (int m = 0; m < NB / 32; ++m) {
        if (r >= start && r < start + loc[m]) {
          o.bucket = NB - 1 - (NB / 32) * lane - m;
          o.k = r - start;
        }
        start += loc[m];
      }
    }
  }
  __syncthreads();
  const int bucket = o.bucket;
  int k = o.k;
  for (int base = 0; base < T; base += n) {
    const int t = base + tid;
    const bool in = t < T && min(min(counts[t], G), NB - 1) == bucket;
    const int found = __syncthreads_count(in);
    if (k < found) {  // uniform over the block
      const unsigned ballot = __ballot_sync(FULL, in);
      if (lane == 0) o.warp_count[warp] = __popc(ballot);
      __syncthreads();
      int before = __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) before += o.warp_count[w];
      if (in && before == k) o.tile = t;
      __syncthreads();
      return o.tile;
    }
    k -= found;
  }
  return -1;  // unreachable: gridDim.x == T
}

// A ray's record as lane g of its group holds it: the geometry in
// registers, and the SH basis values of the lane's channels CPL g .. CPL g +
// CPL - 1 (those past 3 NCOEFF are read from the record's remaining lanes
// and never used) in shared memory, CPL / 4 float4 chunks a lane at a
// stride of the block's threads (chunk m of thread x at m * nthreads + x:
// a warp's reads are consecutive), read back at each sample's fold: the
// registers they would take are what keeps two 512-thread blocks on an SM.
template <int NCOEFF>
struct LaneRay : RayGeom {
  static constexpr int CHUNKS = Lanes<NCOEFF>::CPL / 4;
  unsigned ys;  // shared address of this thread's chunk 0
  unsigned ystride;  // bytes between chunks
  __device__ __forceinline__ void load(const float* rec, int g, float4* smem) {
    load_geom(rec);
    const float4* y = reinterpret_cast<const float4*>(rec + L_Y0 + g * Lanes<NCOEFF>::CPL);
#pragma unroll
    for (int m = 0; m < CHUNKS; ++m) smem[m * blockDim.x + threadIdx.x] = y[m];
    ys = (unsigned)__cvta_generic_to_shared(smem + threadIdx.x);
    ystride = blockDim.x * sizeof(float4);
  }
  __device__ __forceinline__ float4 y4(int m) const {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(ys + m * ystride));
    return v;
  }
};

// Lane g's channels of a live sample: groups g GPL .. g GPL + GPL - 1 of
// each nonzero tap's slab block (``src``: the grid at the sample's slab
// block of row 0, plus the lane's groups; rows of ``lan`` lanes), the taps'
// products summed in ascending patch row. A bf16 weight times a bf16 value
// is exact in f32, so a fused multiply-add rounds once where ``interp``'s
// multiply and add round at the add alone: the same value.
template <int GPL>
__device__ __forceinline__ void interp_lane(const __nv_bfloat16* __restrict__ src, int lan,
                                            const LaneSample& s, float* ch) {
#pragma unroll
  for (int c = 0; c < 8 * GPL; ++c) ch[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (s.w[k] == 0.0f) continue;
    const uint4* p = reinterpret_cast<const uint4*>(src + (size_t)s.row[k] * lan);
#pragma unroll
    for (int gi = 0; gi < GPL; ++gi) {
      const uint4 raw = __ldg(p + gi);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        const int c = gi * 8 + 2 * i;
        ch[c] = __fmaf_rn(s.w[k], f.x, ch[c]);
        ch[c + 1] = __fmaf_rn(s.w[k], f.y, ch[c + 1]);
      }
    }
  }
}

__device__ __forceinline__ float pick3(const float* a, int c) {
  return c == 0 ? a[0] : (c == 1 ? a[1] : a[2]);
}

// What lane g holds of a sample after the fold: the raw SH-folded colour and
// band-0 colour of each colour it owns (slot s: colour first(g) + s) and the
// raw density. Every lane of the warp must call it (the shuffles take the
// whole warp); a dead sample's values are garbage and go unused.
template <int NCOEFF>
struct LaneFold {
  float rgb[Lanes<NCOEFF>::S], dif[Lanes<NCOEFF>::S], sigma;
  __device__ __forceinline__ LaneFold(const float* ch, const LaneRay<NCOEFF>& ray, int c0) {
    using Q = Lanes<NCOEFF>;
    constexpr unsigned FULL = 0xffffffffu;
    float p[Q::CPL];
#pragma unroll
    for (int m = 0; m < Q::CPL / 4; ++m) {
      const float4 y = ray.y4(m);
      p[4 * m] = ch[4 * m] * y.x;
      p[4 * m + 1] = ch[4 * m + 1] * y.y;
      p[4 * m + 2] = ch[4 * m + 2] * y.z;
      p[4 * m + 3] = ch[4 * m + 3] * y.w;
    }
    float a[3], a0[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int k = 0; k < NCOEFF; ++k) {
        const int j = c * NCOEFF + k;
        const float v = Q::owner(j) == Q::owner(c * NCOEFF)
                            ? p[j % Q::CPL]
                            : __shfl_sync(FULL, p[j % Q::CPL], Q::owner(j), Q::L);
        if (k == 0) {
          a0[c] = v;
          a[c] = v;
        } else {
          a[c] = a[c] + v;
        }
      }
    }
    sigma = __shfl_sync(FULL, ch[Q::NF % Q::CPL], Q::owner(Q::NF), Q::L);
#pragma unroll
    for (int s = 0; s < Q::S; ++s) {
      rgb[s] = pick3(a, c0 + s);
      dif[s] = pick3(a0, c0 + s);
    }
  }
};

}  // namespace slab
