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
// Here a row's W has at most K nonzeros. A thread owns a row and a chunk of
// VEC channels: it merges the row's in-range indices into distinct rows with
// their weights summed in k order (merge_row), orders them by row, and
//   K13: sums W * table[b] over the distinct b in ascending b (the dot's
//        order), VEC channels per 16-byte load;
//   K14: adds W * g[n] into d_table: into a block-private copy in shared
//        memory when [B, C] f32 fits, flushed with one atomicAdd per element,
//        else straight into device memory with f32 atomics. Blocks run in no
//        order, so the sums round in another order than the plain version's.
//
// Bound on the H100: memory. K13 reads the indices, weights and the rows they
// name (the table, 256 KB at B = 512, C = 128, stays in L2) and writes
// [N, C] f32; K14 reads the indices, weights and g and writes [B, C] f32.
#include <cuda_runtime.h>

namespace {

constexpr int MAXK = 32;  // indices per row
constexpr int THREADS = 256;
constexpr size_t SMEM_MAX = 160 * 1024;  // K14's shared-memory copy of d_table

// The row's distinct in-range indices b[0..m) in ascending order, each with
// the sum of its weights in k order.
__device__ __forceinline__ int merge_row(const int* __restrict__ idx, const float* __restrict__ w,
                                         int K, int B, int* b, float* W) {
  int m = 0;
  for (int k = 0; k < K; ++k) {
    const int ik = __ldg(idx + k);
    if (ik < 0 || ik >= B) continue;
    const float wk = __ldg(w + k);
    int j = 0;
    while (j < m && b[j] != ik) ++j;
    if (j == m) {
      b[m] = ik;
      W[m] = 0.0f + wk;
      ++m;
    } else {
      W[j] = W[j] + wk;
    }
  }
  for (int j = 1; j < m; ++j) {  // insertion sort by row
    const int bj = b[j];
    const float Wj = W[j];
    int i = j - 1;
    while (i >= 0 && b[i] > bj) {
      b[i + 1] = b[i];
      W[i + 1] = W[i];
      --i;
    }
    b[i + 1] = bj;
    W[i + 1] = Wj;
  }
  return m;
}

template <int VEC>
__global__ void onehot_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                                     const float* __restrict__ w, float* __restrict__ out, int N,
                                     int K, int B, int C) {
  const int chunks = C / VEC;
  const long long total = (long long)N * chunks;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(e / chunks);
    const int c0 = (int)(e % chunks) * VEC;
    int b[MAXK];
    float W[MAXK];
    const int m = merge_row(idx + (size_t)n * K, w + (size_t)n * K, K, B, b, W);
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    for (int j = 0; j < m; ++j) {
      const float* row = table + (size_t)b[j] * C + c0;
      if constexpr (VEC == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(row));
        acc[0] = acc[0] + W[j] * t.x;
        acc[1] = acc[1] + W[j] * t.y;
        acc[2] = acc[2] + W[j] * t.z;
        acc[3] = acc[3] + W[j] * t.w;
      } else {
        acc[0] = acc[0] + W[j] * __ldg(row);
      }
    }
    float* dst = out + (size_t)n * C + c0;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      dst[0] = acc[0];
    }
  }
}

template <bool SMEM>
__global__ void onehot_scatter_add_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                                          const float* __restrict__ g,
                                          float* __restrict__ dtable, int N, int K, int B, int C) {
  extern __shared__ float shared_acc[];
  float* acc = SMEM ? shared_acc : dtable;
  if constexpr (SMEM) {
    for (int j = threadIdx.x; j < B * C; j += blockDim.x) shared_acc[j] = 0.0f;
    __syncthreads();
  }
  const long long total = (long long)N * C;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(e / C);
    const int c = (int)(e % C);
    int b[MAXK];
    float W[MAXK];
    const int m = merge_row(idx + (size_t)n * K, w + (size_t)n * K, K, B, b, W);
    const float gv = __ldg(g + e);
    for (int j = 0; j < m; ++j) {
      const float v = W[j] * gv;
      if (v != 0.0f) atomicAdd(acc + (size_t)b[j] * C + c, v);
    }
  }
  if constexpr (SMEM) {
    __syncthreads();
    for (int j = threadIdx.x; j < B * C; j += blockDim.x) {
      if (shared_acc[j] != 0.0f) atomicAdd(dtable + j, shared_acc[j]);
    }
  }
}

int blocks_for(long long work, int cap) {
  long long want = (work + THREADS - 1) / THREADS;
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

}  // namespace

// K13: out [N, C] f32 from table [B, C] f32, idx [N, K] int32, w [N, K] f32.
extern "C" int onehot_gather_launch(const float* table, const int* idx, const float* w,
                                    float* out, int N, int K, int B, int C, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (K < 1 || K > MAXK || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = C % 4 == 0 && ((size_t)table % 16 == 0) && ((size_t)out % 16 == 0);
  if (vec4) {
    onehot_gather_kernel<4><<<blocks_for((long long)N * (C / 4), 132 * 64), THREADS, 0, s>>>(
        table, idx, w, out, N, K, B, C);
  } else {
    onehot_gather_kernel<1><<<blocks_for((long long)N * C, 132 * 64), THREADS, 0, s>>>(
        table, idx, w, out, N, K, B, C);
  }
  return (int)cudaGetLastError();
}

// K14: adds into dtable [B, C] f32 (zeroed by the caller) from idx [N, K]
// int32, w [N, K] f32 and g [N, C] f32.
extern "C" int onehot_scatter_add_launch(const int* idx, const float* w, const float* g,
                                         float* dtable, int N, int K, int B, int C,
                                         void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (K < 1 || K > MAXK || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)B * C * sizeof(float);
  const long long work = (long long)N * C;
  if (smem <= SMEM_MAX) {
    cudaError_t err = cudaFuncSetAttribute(onehot_scatter_add_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    // one block per SM: each block flushes its whole copy
    onehot_scatter_add_kernel<true><<<blocks_for(work, 132), THREADS, smem, s>>>(
        idx, w, g, dtable, N, K, B, C);
  } else {
    onehot_scatter_add_kernel<false><<<blocks_for(work, 132 * 16), THREADS, 0, s>>>(
        idx, w, g, dtable, N, K, B, C);
  }
  return (int)cudaGetLastError();
}
