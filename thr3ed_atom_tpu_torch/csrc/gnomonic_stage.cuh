// gnomonic_stage: the staged vertex source of the fused composite
// (composite_fused.cu, K1) and its replay backward (composite_backward_fused.cu,
// K3), and the two marches that run over it.
//
// A texel tile of TP x TQ threads (warp r = texel row r) shares each
// position's vertex footprint: U is affine in the row p alone and V in the
// column q alone, so the tile's two-tap tents reach the u lines
// floor(U(p0)) .. floor(U(p0 + TP - 1)) + 1 and the v lines
// floor(V(q0)) .. floor(V(q0 + TQ - 1)) + 1 (clipped to the grid) of the 1-2
// vertex slices of position j. Per needed position:
//   1. the footprint's 16-byte channel records are copied to a ring of two
//      shared-memory stages with cp.async, one position ahead: position j+1's
//      records are in flight while position j composites (the next needed j
//      is known from the tile's flags, which are uniform over the tile);
//   2. an interior position's two slices are lerped and rounded to bf16 once
//      per record (in place);
//   3. warp r computes the bf16 u-resample t1[r, channel, v line] of its row
//      once per (v line, channel);
//   4. each texel does only its two-tap v-resample from t1, the SH fold and
//      the composite.
// One block barrier per position (the early exit's vote, and the point after
// which the next position's copies may overwrite the stage read before it),
// one more after the lerp of an interior position. Every rounding is the one
// position_values (gnomonic_march.cuh) makes, at the same point, so a staged
// position's values equal the direct gather's bit for bit. A footprint over
// the stage budget (a far-zoomed frame, |ku| or |kv| >> 1) takes
// position_values, the direct gather, inside the same march. The stage is
// sized at launch (Stage::fit): the kernel's preferred size, or a shorter
// ring where the per-position tables of a long march (NP in the thousands:
// P = 8 on a 256^3 grid) leave less of the SM's shared memory, down to no
// stage at all, where every position takes the direct gather.
//
// The replay backward (march_backward_staged) replays the forward over the
// same stages and folds each flushed position's per-texel bf16 cotangent
// through the position's v-tents inside the march (VFold, warp r for row r):
// per (row, channel, v line of the tile's footprint) the f32 sum over the
// tile's columns in ascending q. A line that only this tile reaches is
// complete and goes to the position's dense dt1 rows in bf16 (the
// reference's q-summed dt1); an edge line that a neighbour may reach goes to
// the tile's f32 edge record, and the u-fold (composite_backward_fused.cu)
// adds those over the tiles in ascending order before its bf16 rounding,
// then folds the rows through the u-tents on the tensor cores. No per-texel
// cotangent leaves the block, and no sum uses atomics.
#pragma once

#include "gnomonic_march.cuh"
#include "smem_limit.cuh"

namespace gnomonic {

constexpr int NTHREADS = TP * TQ;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The stage's size, per kernel instance: a ring stage holds `recs` 16-byte
// records (slices x u lines x v lines x channel groups) and t1 `nvs` v lines.
// stage_small keeps a block of TP x TQ threads within half an SM's shared
// memory (two blocks an SM, as the registers allow: for a frame whose tiles
// all march); stage_large stages footprints up to |ku|, |kv| ~1.3 at one
// block an SM (for a frame where a few tiles march long chains of positions).
struct StageSize {
  int recs, nvs;
};
__host__ __device__ constexpr StageSize stage_small() { return StageSize{1536, 48}; }
__host__ __device__ constexpr StageSize stage_large(int NG) {
  return StageSize{NG > 4 ? 3072 : 4608, 64};
}

// The shared memory a block may opt in to on the current device (queried
// once per device).
inline int smem_optin() {
  static int known[16] = {};
  int dev = 0, bytes = 48 * 1024;
  if (cudaGetDevice(&dev) != cudaSuccess) return bytes;
  if (dev < 16 && known[dev] > 0) return known[dev];
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 48 * 1024;
  if (dev < 16) known[dev] = bytes;
  return bytes;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but the most recent commit group landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += A (16 x 16, row-major fragments) x B (16 x 8, column-major): bf16
// operands, f32 accumulation on the tensor cores (a fixed order per call)
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// [lo, lo + cnt): the grid lines in [0, n) that the two-tap tents of an
// affine run of coordinates c0 .. c1 reach (floor(c), floor(c) + 1).
__device__ __forceinline__ void tap_lines(float c0, float c1, int n, int& lo, int& cnt) {
  const float f0 = floorf(c0), f1 = floorf(c1);
  const float lo_f = fmaxf(fminf(f0, f1), 0.0f);
  const float hi_f = fminf(fmaxf(f0, f1) + 1.0f, (float)(n - 1));
  if (hi_f >= lo_f) {
    lo = (int)lo_f;
    cnt = (int)(hi_f - lo_f) + 1;
  } else {
    lo = 0;
    cnt = 0;
  }
}

// Position j's footprint on a tile (uniform over the tile): its clipped line
// ranges, its vertex slices and lerp weights (as position_values computes
// them), and whether it fits the stage (Stage::footprint).
struct Footprint {
  int ulo, nu_c, vlo, nv_c;
  int ia, ib;
  float fa, fb;
  bool mix, staged;
};

// One texel of the tile at (p0, q0): row r = p - p0 (its warp), column lane
// = q - q0, coordinates (pf, qf).
struct TexelAt {
  int p0, q0, r, lane, tid;
  float pf, qf;
};

// The staging buffers in shared memory: the ring of two stages of records
// [slice, u line, v line, group] (uint4 = 8 bf16 channels) and the
// u-resampled t1 [TP, CH, nvs] bf16 (neighbouring v lines in neighbouring
// banks); the ring's length is the one the launch chose (fit).
template <int NCOEFF, bool LARGE = false>
struct Stage {
  static constexpr int USED = 3 * NCOEFF + 1;
  static constexpr int NG = (USED + 7) / 8;  // uint4 groups of 8 channels
  static constexpr int CH = NG * 8;
  static constexpr StageSize SZ = LARGE ? stage_large(NG) : stage_small();  // preferred
  // t1's line stride stays a constant: its reads and writes then take
  // immediate offsets (a stride read at run time made K1 7-11% slower on
  // the H100 at the dense training grid)
  static constexpr int NVS = SZ.nvs;
  int recs, lines;  // records of a ring stage; t1 lines (NVS, or 0 with no stage)
  uint4* ring[2];
  __nv_bfloat16* t1;

  // shared memory of a ring of two stages and the t1 rows (a multiple of 16)
  __host__ __device__ static constexpr size_t bytes(StageSize z) {
    return (size_t)2 * z.recs * sizeof(uint4) + (size_t)TP * CH * z.nvs * sizeof(__nv_bfloat16);
  }

  // The stage that fits in `avail` bytes: the preferred one, else the t1
  // rows and a ring of what is left (none at all when that is no record).
  static StageSize fit(long long avail) {
    if (avail >= (long long)bytes(SZ)) return SZ;
    const long long recs = (avail - (long long)bytes(StageSize{0, NVS})) /
                           (2 * (long long)sizeof(uint4));
    return recs > 0 ? StageSize{(int)recs, NVS} : StageSize{0, 0};
  }

  __device__ Stage(unsigned char* smem, StageSize z) : recs(z.recs), lines(z.nvs) {
    ring[0] = reinterpret_cast<uint4*>(smem);
    ring[1] = ring[0] + recs;
    t1 = reinterpret_cast<__nv_bfloat16*>(ring[1] + recs);
  }

  // position j's footprint on the tile at rows p0.., columns q0..
  __device__ __forceinline__ Footprint footprint(const VertexStack& s, const float* G, int j,
                                                 int p0, int q0) const {
    Footprint f;
    tap_lines(G[2] + G[3] * (float)p0, G[2] + G[3] * (float)(p0 + TP - 1), s.nu, f.ulo,
              f.nu_c);
    tap_lines(G[4] + G[5] * (float)q0, G[4] + G[5] * (float)(q0 + TQ - 1), s.nv, f.vlo,
              f.nv_c);
    const float inv_p = (float)(1.0 / s.P);
    const int jd = j / s.P;
    f.ia = min(jd, s.nvert - 1);
    f.ib = min(jd + 1, s.nvert - 1);
    f.fb = (float)(j - jd * s.P) * inv_p;
    f.fa = 1.0f - f.fb;
    f.mix = s.P > 1 && f.fb != 0.0f;
    f.staged = f.nv_c <= lines && (f.mix ? 2 : 1) * f.nu_c * f.nv_c * NG <= recs;
    return f;
  }

  // cp.async of footprint f's records into ring stage k (every thread):
  // warp w copies the (slice, u line) rows w, w + TP, ..., whose nv_c x NG
  // records are contiguous in the stage and, but for pad channel groups, in
  // the stack
  __device__ __forceinline__ void issue(const VertexStack& s, const Footprint& f, int k,
                                        const TexelAt& x) const {
    if (!f.staged) return;
    const int ngc = s.C / 8, per_u = f.nv_c * NG, rows = (f.mix ? 2 : 1) * f.nu_c;
    for (int row = x.r; row < rows; row += TP) {
      const int sl = row >= f.nu_c ? 1 : 0;
      const uint4* src = s.vert + (((size_t)(sl ? f.ib : f.ia) * s.nu +
                                    (f.ulo + row - sl * f.nu_c)) * s.nv + f.vlo) * ngc;
      uint4* dst = ring[k] + row * per_u;
      for (int e = x.lane; e < per_u; e += 32) {
        const int vl = e / NG;
        cp_async16(dst + e, src + vl * ngc + (e - vl * NG));
      }
    }
  }

  // Steps 2 and 3 on stage k for position G: every thread lerps an interior
  // position's slices to bf16 in place (then a barrier); warp r then builds
  // t1[r, c, v] = bf16(w_u0 s(u0, v) + w_u1 s(u0 + 1, v)) of its own texel
  // row r, which only it reads.
  __device__ __forceinline__ void prepare(const VertexStack& s, const Footprint& f,
                                          const float* G, int k, const TexelAt& x) const {
    uint4* buf = ring[k];
    if (f.mix) {
      const int n = f.nu_c * f.nv_c * NG;
      for (int i = x.tid; i < n; i += NTHREADS) {
        float sa[8], sb[8];
        unpack8(buf[i], sa);
        unpack8(buf[n + i], sb);
        uint4 o;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = __floats2bfloat162_rn(f.fa * sa[2 * e] + f.fb * sb[2 * e],
                                       f.fa * sa[2 * e + 1] + f.fb * sb[2 * e + 1]);
        buf[i] = o;
      }
      __syncthreads();
    }
    const float U = G[2] + G[3] * (float)(x.p0 + x.r);
    const float u0f = floorf(U);
    const float nu_last = (float)(s.nu - 1);
    constexpr int nvs = NVS;
    __nv_bfloat16* row = t1 + (size_t)x.r * CH * nvs;
    for (int e = x.lane; e < f.nv_c * NG; e += 32) {
      const int vl = e / NG, g = e - vl * NG;
      float a8[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a8[i] = 0.0f;
#pragma unroll
      for (int tu = 0; tu < 2; ++tu) {
        const float uf = u0f + (float)tu;
        if (!(uf >= 0.0f && uf <= nu_last)) continue;
        const float wu = tent(U, uf);
        float sa[8];
        unpack8(buf[(((int)uf - f.ulo) * f.nv_c + vl) * NG + g], sa);
#pragma unroll
        for (int i = 0; i < 8; ++i) a8[i] = a8[i] + wu * sa[i];
      }
      __nv_bfloat16* o = row + g * 8 * nvs + vl;
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i * nvs] = __float2bfloat16_rn(a8[i]);
    }
    __syncwarp();
  }

  // Step 4: the texel's values from t1 (row x.r of the tile), as
  // position_values computes them from the same t1.
  __device__ __forceinline__ void values(const VertexStack& s, const Footprint& f,
                                         const float* G, const TexelAt& x, const float* yb,
                                         PosValues& out) const {
    const float s_j = G[0];
    const float U = G[2] + G[3] * x.pf;
    const float V = G[4] + G[5] * x.qf;
    const float nu_hi = (float)s.nu - 0.5f, nv_hi = (float)s.nv - 0.5f;
    out.live = (U >= -0.5f && U <= nu_hi && s_j > 0.0f && V >= -0.5f && V <= nv_hi)
                   ? 1.0f
                   : 0.0f;
    const float v0f = floorf(V);
    float wv[2];
    bool okv[2];
    int iv[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float vf = v0f + (float)t;
      wv[t] = tent(V, vf);
      okv[t] = vf >= 0.0f && vf <= (float)(s.nv - 1);
      iv[t] = okv[t] ? (int)vf - f.vlo : 0;
    }
    out.sig = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) out.rgb[c] = out.dif[c] = 0.0f;
    constexpr int nvs = NVS;
    const __nv_bfloat16* row = t1 + (size_t)x.r * CH * nvs;
#pragma unroll
    for (int c = 0; c < USED; ++c) {
      const __nv_bfloat16* tc = row + c * nvs;
      const float ta = okv[0] ? __bfloat162float(tc[iv[0]]) : 0.0f;
      const float tb = okv[1] ? __bfloat162float(tc[iv[1]]) : 0.0f;
      fold_channel<NCOEFF>(c, 0.0f + wv[0] * ta + wv[1] * tb, yb, out.sig, out.rgb,
                           out.dif);
    }
  }

  // Position j's values at texel x, staged (f is j's footprint, its records
  // in stage k) or gathered directly; sets direct when it gathers.
  __device__ __forceinline__ void position(const VertexStack& s, const Footprint& f,
                                           const float* G, int j, int k, const TexelAt& x,
                                           const float* yb, PosValues& out,
                                           bool& direct) const {
    if (f.staged) {
      prepare(s, f, G, k, x);
      values(s, f, G, x, yb, out);
    } else {
      direct = true;
      position_values<NCOEFF>(s, G, j, x.pf, x.qf, yb, out.sig, out.rgb, out.dif, out.live);
    }
  }
};

// the next needed position after j (NP if none), from the tile's flags
__device__ __forceinline__ int next_needed(const MarchTables& tb, int j, int NP) {
  for (++j; j < NP && !tb.pos_needed[j]; ++j) {
  }
  return j;
}

// Copies the footprint of the next needed position after j into the ring
// stage other than k (every thread, after the block barrier that puts every
// warp past the position that stage held) and returns it.
template <int NCOEFF, bool LARGE>
__device__ __forceinline__ Footprint advance(const VertexStack& vs,
                                             const Stage<NCOEFF, LARGE>& sm,
                                             const MarchTables& tb, int j, int NP, int k,
                                             const TexelAt& x) {
  const int jn = next_needed(tb, j, NP);
  Footprint fn{};
  if (jn < NP) {
    fn = sm.footprint(vs, tb.geom + jn * GEOM_COLS, jn, x.p0, x.q0);
    sm.issue(vs, fn, k ^ 1, x);
  }
  cp_async_commit();
  return fn;
}

// march_forward over the staged source: the same composite per needed
// position. Returns whether a position took the direct gather.
template <int NCOEFF, bool DIFFUSE, bool RELU, bool LARGE>
__device__ __forceinline__ bool march_forward_staged(const VertexStack& vs,
                                                     const Stage<NCOEFF, LARGE>& sm,
                                                     const MarchTables& tb, int NP,
                                                     float exit_eps, float nm, const float* yb,
                                                     const TexelAt& x, float* out,
                                                     size_t plane) {
  CompositeState st{1.0f, 0.0f, 0.0f, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  PosValues prev{};
  bool direct = false;
  int k = 0;
  int j = next_needed(tb, -1, NP);
  Footprint f = advance(vs, sm, tb, -1, NP, 1, x);  // position j into stage 0
  while (j < NP) {
    cp_async_wait_all();
    if (exit_eps > 0.0f) {
      if (!__syncthreads_or(st.T > exit_eps)) break;
    } else {
      __syncthreads();
    }
    const Footprint fn = advance(vs, sm, tb, j, NP, k, x);
    const float* G = tb.geom + j * GEOM_COLS;
    PosValues cur;
    sm.position(vs, f, G, j, k, x, yb, cur, direct);
    if (j > 0 && tb.cell_live[j]) composite_cell<DIFFUSE, RELU>(G, nm, prev, cur, st);
    prev = cur;
    f = fn;
    j = next_needed(tb, j, NP);
    k ^= 1;
  }
  cp_async_wait_all();
  store_state<DIFFUSE>(st, out, plane);
  return direct;
}

// The in-march v-fold of one texel row (warp r): the flushed position's
// per-texel bf16 cotangents [TP, USED, DSTRIDE] and each warp's column taps
// (floor(V), w0, w1 per column) in shared memory, and where its sums go. A
// tile's tap lines lo .. hi run over an affine V, so no other tile reaches
// lines lo + 2 .. hi - 2 (a neighbour's last tap line is at most floor(V) + 1
// of this tile's first column, and mirrored on the other side): their sums
// are complete in the tile and go, rounded to bf16, to the dense dt1 rows
// [Pb, USED, nv] of the position's u-block (d_off). The up to two edge lines
// on each side may be shared: their f32 partial sums go to the tile's edge
// record [USED, TP, 4] (s_off; slots lo, lo + 1, hi - 1, hi), and the u-fold
// adds them over the tiles that reach the line.
constexpr int EDGE_SLOTS = 4;

template <int NCOEFF>
struct VFold {
  static constexpr int USED = 3 * NCOEFF + 1;
  static constexpr int MT = (USED + 15) / 16;  // m16 tiles of channels
  static constexpr int DSTRIDE = TQ + 8;       // bf16: conflict-free fragment loads
  __nv_bfloat16* d;  // [TP, USED, DSTRIDE]
  float* v0;         // [TP, TQ]
  float* w0;         // [TP, TQ]
  float* w1;         // [TP, TQ]
  const long long* d_off;  // [NP]: this tile's first row in the position's dt1 rows
  const long long* s_off;  // [NP]: this tile's edge record of a needed position
  __nv_bfloat16* dt1;      // dense dt1 rows
  float* edge;             // edge records

  __host__ __device__ static size_t bytes() {
    return (size_t)TP * USED * DSTRIDE * sizeof(__nv_bfloat16) + 3 * TP * TQ * sizeof(float);
  }

  // Flush position jf at texel x (every thread): its per-channel bf16
  // cotangents and column taps to shared memory, then warp x.r folds its row
  // on the tensor cores: [channels, 32 columns] x [32 columns, v lines of the
  // tile's footprint], the bf16 v-tent weights built in registers, f32
  // accumulation (the reference's MXU product of the q-block by the
  // v-tents); one m16n8k16 per (16 channels, 8 lines, 16 columns).
  template <bool DIFFUSE>
  __device__ __forceinline__ void flush(const float* G, int nv, int jf, const TexelAt& x,
                                        const float* yb, const PosCotangent& dc) const {
    const int r = x.r, lane = x.lane, grp = lane >> 2, tig = lane & 3;
    __nv_bfloat16* dr = d + r * USED * DSTRIDE;
#pragma unroll
    for (int ch = 0; ch < USED; ++ch)
      dr[ch * DSTRIDE + lane] = __float2bfloat16_rn(flush_channel<NCOEFF, DIFFUSE>(ch, yb, dc));
    const float V = G[4] + G[5] * x.qf;
    const float v0q = floorf(V);
    float* tv0 = v0 + r * TQ;
    float* tw0 = w0 + r * TQ;
    float* tw1 = w1 + r * TQ;
    tv0[lane] = v0q;
    tw0[lane] = tent(V, v0q);
    tw1[lane] = tent(V, v0q + 1.0f);
    __syncwarp();
    // A: the cotangents, rows = channels, columns = q
    uint32_t a[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int ch = mt * 16 + grp + (h & 1) * 8, q = ks * 16 + tig * 2 + (h >> 1) * 8;
          a[mt][ks][h] =
              ch < USED ? *reinterpret_cast<const uint32_t*>(dr + ch * DSTRIDE + q) : 0u;
        }
    int vlo, nvc;
    tap_lines(G[4] + G[5] * (float)x.q0, G[4] + G[5] * (float)(x.q0 + TQ - 1), nv, vlo, nvc);
    __nv_bfloat16* rows = dt1 + d_off[jf] + (size_t)r * USED * nv + vlo;
    float* rec = edge + s_off[jf] + r * EDGE_SLOTS;
    for (int n0 = 0; n0 < nvc; n0 += 8) {
      // B: w(q, v) of line n0 + grp at columns 2 tig (+ 1, + 8, + 9) (+ 16)
      const float vf = (float)(vlo + n0 + grp);
      uint32_t b[2][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float w[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = ks * 16 + h * 8 + tig * 2 + i;
            w[i] = tv0[q] == vf ? tw0[q] : (tv0[q] + 1.0f == vf ? tw1[q] : 0.0f);
          }
          b[ks][h] = pack_bf16x2(w[0], w[1]);
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_16816(c, a[mt][0], b[0][0], b[0][1]);
        mma_16816(c, a[mt][1], b[1][0], b[1][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = mt * 16 + grp + (e >> 1) * 8, l = n0 + tig * 2 + (e & 1);
          if (ch >= USED || l >= nvc) continue;
          float* es = rec + ch * TP * EDGE_SLOTS;
          if (l <= 1) es[l] = c[e];
          if (l >= nvc - 2) es[l - nvc + EDGE_SLOTS] = c[e];
          if (l >= 2 && l <= nvc - 3) rows[(size_t)ch * nv + l] = __float2bfloat16_rn(c[e]);
        }
      }
    }
    __syncwarp();
  }
};

// march_backward over the staged source, with the v-fold of every flushed
// position inside the march (VFold) instead of a per-texel cotangent buffer.
// A block barrier only where a position is replayed (and after the lerp of
// an interior one); the fold is per warp. Returns whether a replayed
// position took the direct gather.
template <int NCOEFF, bool DIFFUSE, bool RELU>
__device__ __forceinline__ bool march_backward_staged(const VertexStack& vs,
                                                      const Stage<NCOEFF>& sm,
                                                      const VFold<NCOEFF>& vf,
                                                      const MarchTables& tb, int NP, float nm,
                                                      const float* yb, const float* ga,
                                                      size_t plane, const TexelAt& x) {
  const StateCotangent g = load_cotangent<DIFFUSE>(ga, plane);
  float T = 1.0f, S = 0.0f;
  PosValues prev{};
  PosCotangent pend{};
  bool direct = false;
  int k = 0;
  Footprint f = advance(vs, sm, tb, -1, NP, 1, x);  // the first needed position into stage 0

  // NP + 1 steps: step j composites cell (j-1, j) and flushes position j-1
  for (int j = 0; j <= NP; ++j) {
    const bool replay = j < NP && tb.pos_needed[j];
    const bool flush = j > 0 && tb.pos_needed[j - 1];
    if (!replay && !flush) {  // uniform over the tile
      pend = PosCotangent{};
      continue;
    }
    PosValues cur{};
    const float* G = tb.geom + (j < NP ? j : NP - 1) * GEOM_COLS;
    if (replay) {  // position j is the staged one
      cp_async_wait_all();
      __syncthreads();
      const Footprint fn = advance(vs, sm, tb, j, NP, k, x);
      sm.position(vs, f, G, j, k, x, yb, cur, direct);
      f = fn;
      k ^= 1;
    }

    PosCotangent da{}, db{};
    if (replay && j > 0 && tb.cell_live[j])
      backward_cell<DIFFUSE, RELU>(G, nm, g, prev, cur, T, S, da, db);

    if (flush) {
      PosCotangent d;
      d.sig = pend.sig + da.sig;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d.rgb[c] = pend.rgb[c] + da.rgb[c];
        d.dif[c] = pend.dif[c] + da.dif[c];
      }
      vf.template flush<DIFFUSE>(tb.geom + (j - 1) * GEOM_COLS, vs.nv, j - 1, x, yb, d);
    }
    pend = db;
    if (replay) prev = cur;
  }
  cp_async_wait_all();
  return direct;
}

}  // namespace gnomonic
