// Masked per-group sums accumulated in the input precision, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_seg_matmul_kernel`
// (dask_sql_tpu/ops/pallas_kernels.py), reached there through
// `_segmented_sums_finite` -> `segmented_sums`.  The TPU walks 1024-row
// blocks in order and accumulates, in the dtype of the values, the product
// of the value tile (A x 1024) with a masked one-hot group matrix
// (1024 x G) into one resident (A x G) output.  Its caller first zeroes the
// non-finite values and stacks 3*A NaN/+Inf/-Inf indicator rows, so that a
// NaN times a zero of the one-hot cannot poison the other groups.
//
// Here blocks run in parallel and in no order, and a float sum depends on
// its order, so the design fixes the order everywhere and uses no float
// atomics:
//
// - pass 1, one block per 1024-row tile (the TPU's BLOCK) and per tile of
//   value rows: each warp takes 32-row chunks of the tile in a fixed order.
//   The lanes of a chunk that share a group code find each other with
//   __match_any_sync; each lane adds its peers' values in lane order, and
//   the lowest lane of the group adds that chunk sum into the warp's own
//   shared-memory accumulator for (row, group) -- one writer, fixed order.
//   The block then adds its 8 warp accumulators in warp order and writes
//   the tile's partial sums to a (tiles, A, G) buffer.  A non-finite value
//   is counted in shared memory (integer atomics: exact in any order) and
//   summed as 0, so no indicator rows are stacked; the counts go to a
//   (3, A, G) int64 output once per block.
// - pass 2 adds the partials of each (row, group) in tile order.
//
// Every value thus goes through at most 32 + 4 + 8 + tiles sequential
// additions, inside the two-level bound (1024 + tiles) * eps * sum|v| that
// the callers hold it to, and two runs on the same inputs give the same
// bits.  The plain PyTorch version is `segsum_accumulate_plain` in
// ops/gpu_kernels.py.
//
// What bounds it on an H100: reading the values once -- at TPC-H Q1, SF 1
// cast to float32 (17 rows x 5.9 M, int32 codes, uint8 mask) about 0.43 GB,
// 0.13 ms at the data sheet's 3.35 TB/s.  The design reads each value once,
// coalesced.  What it does not yet do is avoid the 32 shuffles per value
// that the lane-order sum costs; a faster version would start there
// (a segmented shuffle tree, or sorting each chunk by code).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;        // rows per block (the TPU's BLOCK)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kThreads) segsum_tile_kernel(
    const T* __restrict__ vals, long long n, int A,
    const int* __restrict__ codes, const unsigned char* __restrict__ mask,
    int G, int rows_per_block, T* __restrict__ partial,
    unsigned long long* __restrict__ nonfinite) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int a0 = blockIdx.y * rows_per_block;
  const int a1 = min(A, a0 + rows_per_block);
  const int at = a1 - a0;
  const int per_warp = at * G;
  T* acc = reinterpret_cast<T*>(smem);                       // [warp][row][g]
  unsigned* cnt = reinterpret_cast<unsigned*>(acc + kWarps * per_warp);  // [kind][row][g]
  for (int j = threadIdx.x; j < kWarps * per_warp; j += kThreads) acc[j] = T(0);
  for (int j = threadIdx.x; j < 3 * per_warp; j += kThreads) cnt[j] = 0u;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = blockIdx.x;
  T* my_acc = acc + warp * per_warp;
  for (int chunk = warp; chunk < kTile / 32; chunk += kWarps) {
    const long long i = tile * kTile + chunk * 32 + lane;
    int g = -1;
    if (i < n && mask[i]) {
      const int c = codes[i];
      if (c >= 0 && c < G) g = c;
    }
    if (__ballot_sync(kFull, g >= 0) == 0u) continue;
    const unsigned peers = __match_any_sync(kFull, g);
    const bool leader = g >= 0 && lane == __ffs(peers) - 1;
    for (int a = a0; a < a1; ++a) {
      T v = T(0);
      if (g >= 0) {
        v = vals[(long long)a * n + i];
        if (!isfinite(v)) {
          const int kind = isnan(v) ? 0 : (v > T(0) ? 1 : 2);
          atomicAdd(cnt + (kind * at + (a - a0)) * G + g, 1u);
          v = T(0);
        }
      }
      T s = T(0);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const T x = __shfl_sync(kFull, v, k);
        if ((peers >> k) & 1u) s += x;
      }
      if (leader) my_acc[(a - a0) * G + g] += s;
    }
    __syncwarp();   // the next chunk's leaders read what these wrote
  }
  __syncthreads();

  for (int j = threadIdx.x; j < per_warp; j += kThreads) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += acc[w * per_warp + j];
    const int r = j / G;
    partial[(tile * A + a0 + r) * G + (j - r * G)] = s;
  }
  for (int j = threadIdx.x; j < 3 * per_warp; j += kThreads) {
    const unsigned c = cnt[j];
    if (c == 0u) continue;
    const int kind = j / per_warp;
    const int rest = j - kind * per_warp;
    const int r = rest / G;
    atomicAdd(nonfinite + ((long long)kind * A + a0 + r) * G + (rest - r * G),
              (unsigned long long)c);
  }
}

template <typename T>
__global__ void segsum_reduce_tiles(const T* __restrict__ partial,
                                    long long tiles, int AG,
                                    T* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= AG) return;
  T s = T(0);
  for (long long t = 0; t < tiles; ++t) s += partial[t * AG + j];
  out[j] = s;
}

template <typename T>
int launch(const T* vals, long long n, int A, const int* codes,
           const unsigned char* mask, int G, int rows_per_block,
           T* partial, unsigned long long* nonfinite, T* out, void* stream) {
  if (n <= 0 || A <= 0 || G <= 0) return 0;
  const int at = rows_per_block < A ? rows_per_block : A;
  const int smem = kWarps * at * G * (int)sizeof(T) + 3 * at * G * 4;
  cudaError_t err = cudaFuncSetAttribute(
      segsum_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kTile - 1) / kTile;
  const dim3 grid((unsigned)tiles, (unsigned)((A + at - 1) / at));
  cudaStream_t s = (cudaStream_t)stream;
  segsum_tile_kernel<T><<<grid, kThreads, smem, s>>>(
      vals, n, A, codes, mask, G, at, partial, nonfinite);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int AG = A * G;
  segsum_reduce_tiles<T><<<(AG + 127) / 128, 128, 0, s>>>(partial, tiles, AG, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is device memory:
// vals (A x n), codes (n), mask (n), partial (ceil(n/1024) x A x G) scratch,
// nonfinite (3 x A x G, zeroed), out (A x G).  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int dsql_segsum_accumulate_f32(
    const float* vals, long long n, int A, const int* codes,
    const unsigned char* mask, int G, int rows_per_block, float* partial,
    unsigned long long* nonfinite, float* out, void* stream) {
  return launch<float>(vals, n, A, codes, mask, G, rows_per_block, partial,
                       nonfinite, out, stream);
}

extern "C" int dsql_segsum_accumulate_f64(
    const double* vals, long long n, int A, const int* codes,
    const unsigned char* mask, int G, int rows_per_block, double* partial,
    unsigned long long* nonfinite, double* out, void* stream) {
  return launch<double>(vals, n, A, codes, mask, G, rows_per_block, partial,
                        nonfinite, out, stream);
}
