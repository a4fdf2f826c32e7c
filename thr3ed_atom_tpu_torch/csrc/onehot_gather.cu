// onehot_gather: the weighted one-hot row gather (K13) and its scatter-add
// adjoint (K14).
//
//   K13: out[n, c]    = sum_b W[n, b] table[b, c]
//   K14: dtable[b, c] = sum_n W[n, b] g[n, c]
// with W[n, b] = sum_k [idx[n, k] == b] w[n, k]; an index outside [0, B)
// matches no row and contributes nothing.
//
// Replace the TPU kernels thr3ed_atom_tpu/ops/pallas/onehot_gather.py _forward
// (kernel _weighted_gather_kernel) and _scatter_add (kernel
// _scatter_add_kernel). Those build W one 256-row tile at a time in VMEM (the
// one-hots added in k order) and run W @ table, or W^T @ g accumulated across
// the sequential grid, on the MXU with the table or d_table resident in VMEM.
//
// Here a row's W has at most K nonzeros.
//
// K13: a warp owns a sample row at a time and its lanes own channels, lane
// l on channels c0 + l + 32 v (v < 4: 128 channels a warp, a block's slice),
// so that every output store is a contiguous 128-byte segment. Lanes k < K
// load the row's indices and weights once; __match_any_sync finds repeated
// indices, and each group's lanes sum its weights in k order by shuffles
// (no local arrays; skipped where nothing repeats, and for K = 1, the
// weights' cotangent). The groups' first lanes are then taken in ascending
// index (a warp min reduction a distinct row), and every lane adds W *
// table[b] for its channels: the sums of the dot's order, as the
// thread-a-row kernel this replaces summed them. The table rows come from
// L1 / L2 (the table is 256 KB at B = 512, C = 128, 2 MB at B = 4096); the
// grid is channel slices x ranges of rows, one wave of blocks, as K14's.
// Measured on the H100 (PERF.md §6): a [B, 64] slice staged in shared
// memory for each block (so two merges a row at C = 128), and four rows'
// chains interleaved in a warp, were both slower.
//
// K14: a warp owns a sample row at a time and its lanes own channels. Lanes
// k < K load the row's indices and weights once, and __match_any_sync finds
// repeated indices. A row without repeats (the trilinear corners) adds each
// k's term as it is; in a row with repeats, each group's first lane sums the
// group's weights in k order (shuffles, no local arrays) and adds once. The
// lanes add W * g[n, c], lane l on channels c0 + l + 32 v (v < VEC), so g is
// read in coalesced 128-byte rows and a warp's adds for one index hit 32
// consecutive words: 32 banks, no conflicts. A block of 32 warps
// accumulates a [B, 32 VEC] channel slice of d_table in shared memory (64
// channels up to B = 800, 32 up to B = 1600); the grid is channel slices x
// ranges of rows, one wave of blocks. Each block flushes its slice once
// with one f32 atomicAdd per nonzero word into d_table (zeroed by the
// caller), 4.3M atomics at B = 512, C = 128: per-block partials would write
// as many words, read them back in a second pass, and buy no fixed order,
// since the shared-memory atomics fix none. Past B = 1600 the lanes add
// straight into d_table with f32 atomics, 32 consecutive words a warp
// instruction. Blocks and warps run in no order, so the sums round in
// another order than the plain version's.
//
// What bounds K14 on the card is the shared-memory pipe, not the bytes: an
// f32 atomicAdd on shared memory is a compare-and-swap loop (a load and an
// ATOMS.CAST a word), beside two shuffles an index; skipping the merge where
// nothing repeats and 64-wide slices cut those. Global atomics instead of
// shared ones are bound by the L2's atomic rate (vector float4 atomics too).
//
// Bound on the H100: memory. K13 reads the indices, weights and the table
// once and writes [N, C] f32; K14 reads the indices and weights (once per
// channel slice) and g and writes [B, C] f32.
#include <climits>
#include <cuda_runtime.h>

#include "smem_limit.cuh"

namespace {

constexpr int MAXK = 32;  // indices per row
constexpr unsigned FULL = 0xffffffffu;
// K13
constexpr int GATHER_WARPS = 32;  // warps a block
constexpr int GATHER_ROWS = 4;  // rows a warp loads before it sums them
constexpr int GATHER_VEC = 4;  // channels a lane: 128 a warp
// K14
constexpr int SCATTER_WARPS = 32;  // warps a block
constexpr int SCATTER_ROWS = 4;  // rows a warp loads before it adds them
constexpr size_t SMEM_CAP = 200 * 1024;  // a block's slice: 64 wide to B = 800, 32 to 1600

// K13: row n's sum over its distinct in-range indices b, in ascending order,
// of W[n, b] * table[b] for the lane's channels c0 + lane + 32 v (``rows``:
// the table at the lane's first channel, rows of C), W[n, b] summed in k
// order; lane k < K holds (idx[n, k], w[n, k]), lanes past K carry -1.
__device__ __forceinline__ void gather_row(float (&acc)[GATHER_VEC], const float* rows, int C,
                                           int ik, float wk, int K, int B, int lane,
                                           const bool (&live)[GATHER_VEC]) {
  auto add = [&](int b, float W) {
    const float* row = rows + (size_t)b * C;
#pragma unroll
    for (int v = 0; v < GATHER_VEC; ++v) {
      const float t = live[v] ? __ldg(row + 32 * v) : 0.0f;
      acc[v] = acc[v] + W * t;
    }
  };
#pragma unroll
  for (int v = 0; v < GATHER_VEC; ++v) acc[v] = 0.0f;
  if (K == 1) {  // one index a row (the weights' cotangent): nothing to merge
    const int b = __shfl_sync(FULL, ik, 0);
    const float W = 0.0f + __shfl_sync(FULL, wk, 0);
    if (b >= 0 && b < B) add(b, W);
    return;
  }
  const bool valid = ik >= 0 && ik < B;
  const unsigned peers = __match_any_sync(FULL, valid ? ik : -1);
  float W = 0.0f + wk;  // the group's weights summed in k order
  if (__ballot_sync(FULL, valid && __popc(peers) > 1) != 0u) {
    W = 0.0f;
    for (int j = 0; j < K; ++j) {
      const float wj = __shfl_sync(FULL, wk, j);
      if ((peers >> j) & 1u) W = W + wj;
    }
  }
  // each group's first lane, in ascending index: the least pending index,
  // then the lane that holds it
  bool pending = valid && (peers & ((1u << lane) - 1u)) == 0u;
  for (int m = __popc(__ballot_sync(FULL, pending)); m > 0; --m) {
    const int b = __reduce_min_sync(FULL, pending ? ik : INT_MAX);
    const int src = __ffs(__ballot_sync(FULL, pending && ik == b)) - 1;
    const float Wb = __shfl_sync(FULL, W, src);
    pending = pending && lane != src;
    add(b, Wb);
  }
}

// K13: grid (channel slices of 32 GATHER_VEC, ranges of rows_per_block rows)
__global__ void __launch_bounds__(GATHER_WARPS * 32)
    onehot_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out, int N, int K,
                         int B, int C, int rows_per_block) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * 32 * GATHER_VEC;
  bool live[GATHER_VEC];
#pragma unroll
  for (int v = 0; v < GATHER_VEC; ++v) live[v] = c0 + lane + 32 * v < C;
  const float* rows = table + c0 + lane;
  const int n0 = blockIdx.y * rows_per_block;
  const int n1 = min(N, n0 + rows_per_block);
  for (int base = n0 + warp * GATHER_ROWS; base < n1; base += GATHER_WARPS * GATHER_ROWS) {
    int ik[GATHER_ROWS];
    float wk[GATHER_ROWS];
#pragma unroll
    for (int u = 0; u < GATHER_ROWS; ++u) {  // all loads first, then the sums
      const int n = base + u;
      const bool row = n < n1 && lane < K;
      ik[u] = row ? __ldg(idx + (size_t)n * K + lane) : -1;
      wk[u] = row ? __ldg(w + (size_t)n * K + lane) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < GATHER_ROWS; ++u) {
      const int n = base + u;
      if (n >= n1) break;  // uniform over the warp
      float acc[GATHER_VEC];
      gather_row(acc, rows, C, ik[u], wk[u], K, B, lane, live);
      float* dst = out + (size_t)n * C + c0 + lane;
#pragma unroll
      for (int v = 0; v < GATHER_VEC; ++v)
        if (live[v]) dst[32 * v] = acc[v];
    }
  }
}

// K14: adds W * g[v] into acc row b for the lane's channels
template <int VEC>
__device__ __forceinline__ void add_slice(float* acc, size_t stride, int b, float W,
                                          const float* g, const bool* live) {
  float* dst = acc + (size_t)b * stride;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float x = W * g[v];
    if (live[v] && x != 0.0f) atomicAdd(dst + 32 * v, x);
  }
}

// K14: adds row n's W[n, :] * g[n, c] for the lane's channels into acc
// (row b at acc + b * stride); lane k < K holds (idx[n, k], w[n, k]) and g
// the lane's VEC values of g[n].
template <int VEC>
__device__ __forceinline__ void scatter_row(float* acc, size_t stride, int ik, float wk,
                                            const float* g, int K, int B, int lane,
                                            const bool* live) {
  const bool valid = ik >= 0 && ik < B;  // lanes >= K carry -1
  const unsigned peers = __match_any_sync(FULL, valid ? ik : -1);
  if (__ballot_sync(FULL, valid && __popc(peers) > 1) == 0u) {
    // no index repeats (the trilinear corners): each k's term as it is,
    // fewer shuffles than the merge
    for (int j = 0; j < K; ++j) {
      const int b = __shfl_sync(FULL, ik, j);
      const float Wb = __shfl_sync(FULL, wk, j);
      if (b >= 0 && b < B) add_slice<VEC>(acc, stride, b, Wb, g, live);
    }
    return;
  }
  // each lane's sum of its group's weights in k order (the group's first lane
  // keeps the one that is used)
  float W = 0.0f;
  for (int j = 0; j < K; ++j) {
    const float wj = __shfl_sync(FULL, wk, j);
    if ((peers >> j) & 1u) W = W + wj;
  }
  for (unsigned lead = __ballot_sync(FULL, valid && (peers & ((1u << lane) - 1u)) == 0u);
       lead; lead &= lead - 1) {
    const int j = __ffs(lead) - 1;
    add_slice<VEC>(acc, stride, __shfl_sync(FULL, ik, j), __shfl_sync(FULL, W, j), g, live);
  }
}

// grid: (channel slices of 32 VEC, ranges of rows_per_block rows)
template <int VEC, bool SMEM>
__global__ void __launch_bounds__(SCATTER_WARPS * 32)
    onehot_scatter_add_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                              const float* __restrict__ g, float* __restrict__ dtable, int N,
                              int K, int B, int C, int rows_per_block) {
  constexpr int CS = 32 * VEC;
  extern __shared__ float shared_acc[];  // [B, CS]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * CS;
  bool live[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) live[v] = c0 + lane + 32 * v < C;
  float* acc = SMEM ? shared_acc + lane : dtable + c0 + lane;
  const size_t stride = SMEM ? CS : C;
  if constexpr (SMEM) {
    for (int j = threadIdx.x; j < B * CS; j += blockDim.x) shared_acc[j] = 0.0f;
    __syncthreads();
  }
  const int n0 = blockIdx.y * rows_per_block;
  const int n1 = min(N, n0 + rows_per_block);
  for (int base = n0 + warp * SCATTER_ROWS; base < n1; base += SCATTER_WARPS * SCATTER_ROWS) {
    int ik[SCATTER_ROWS];
    float wk[SCATTER_ROWS], gv[SCATTER_ROWS][VEC];
#pragma unroll
    for (int u = 0; u < SCATTER_ROWS; ++u) {  // all loads first, then the adds
      const int n = base + u;
      const bool row = n < n1 && lane < K;
      ik[u] = row ? __ldg(idx + (size_t)n * K + lane) : -1;
      wk[u] = row ? __ldg(w + (size_t)n * K + lane) : 0.0f;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        gv[u][v] = n < n1 && live[v] ? __ldg(g + (size_t)n * C + c0 + lane + 32 * v) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SCATTER_ROWS; ++u)
      scatter_row<VEC>(acc, stride, ik[u], wk[u], gv[u], K, B, lane, live);
  }
  if constexpr (SMEM) {
    __syncthreads();
    for (int j = threadIdx.x; j < B * CS; j += blockDim.x) {
      const int c = c0 + j % CS;
      if (c < C && shared_acc[j] != 0.0f) atomicAdd(dtable + (size_t)(j / CS) * C + c,
                                                    shared_acc[j]);
    }
  }
}

template <int VEC, bool SMEM, class Kernel, class... Args>
int launch_wave(Kernel kern, int warps, int per_range, int N, int B, int C, cudaStream_t s,
                Args... args) {
  static size_t allowed[16] = {};
  const size_t smem = SMEM ? (size_t)B * 32 * VEC * sizeof(float) : 0;
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, warps * 32, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int slices = (C + 32 * VEC - 1) / (32 * VEC);
  int ranges = (sms * per_sm + slices - 1) / slices;
  const int most = (N + per_range - 1) / per_range;
  if (ranges > most) ranges = most;
  const int rows = (N + ranges - 1) / ranges;
  kern<<<dim3(slices, ranges), warps * 32, smem, s>>>(args..., rows);
  return (int)cudaGetLastError();
}

template <int VEC, bool SMEM>
int launch_scatter(const int* idx, const float* w, const float* g, float* dtable, int N, int K,
                   int B, int C, cudaStream_t s) {
  return launch_wave<VEC, SMEM>(onehot_scatter_add_kernel<VEC, SMEM>, SCATTER_WARPS,
                                SCATTER_WARPS * SCATTER_ROWS, N, B, C, s, idx, w, g, dtable, N,
                                K, B, C);
}

}  // namespace

// K13: out [N, C] f32 from table [B, C] f32, idx [N, K] int32, w [N, K] f32.
extern "C" int onehot_gather_launch(const float* table, const int* idx, const float* w,
                                    float* out, int N, int K, int B, int C, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (K < 1 || K > MAXK || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return launch_wave<GATHER_VEC, false>(onehot_gather_kernel, GATHER_WARPS,
                                        GATHER_WARPS * GATHER_ROWS, N, B, C, s, table, idx, w,
                                        out, N, K, B, C);
}

// K14: adds into dtable [B, C] f32 (zeroed by the caller) from idx [N, K]
// int32, w [N, K] f32 and g [N, C] f32.
extern "C" int onehot_scatter_add_launch(const int* idx, const float* w, const float* g,
                                         float* dtable, int N, int K, int B, int C,
                                         void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (K < 1 || K > MAXK || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t row = 32 * sizeof(float);  // a 32-wide slice's bytes per table row
  // 64-wide slices where C needs them and they fit: half the re-reads of idx
  // and w, and half the shuffles a channel
  if (C > 32 && (size_t)B * 2 * row <= SMEM_CAP)
    return launch_scatter<2, true>(idx, w, g, dtable, N, K, B, C, s);
  if ((size_t)B * row <= SMEM_CAP)
    return launch_scatter<1, true>(idx, w, g, dtable, N, K, B, C, s);
  return launch_scatter<1, false>(idx, w, g, dtable, N, K, B, C, s);
}
