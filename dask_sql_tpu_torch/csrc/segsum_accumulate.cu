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
// - pass 1: the grid holds as many blocks as the SMs keep resident, and
//   each takes one contiguous range of rows (at most `stage_rows`) and one
//   slice of the groups (over blockIdx.y: as many groups as 8 warps of
//   lane-private sums fit in shared memory; one slice for small G).  The
//   block stages the range's group codes once, as int16 in shared memory
//   (the code within the slice, -1 where the row is masked out or its code
//   is outside the slice), and then walks the value rows one at a time.
//   Each lane adds its own rows, in row order, into LANE-PRIVATE
//   accumulators in shared memory laid out [warp][group][lane ^ (group &
//   31)]: the lanes never share an accumulator, need no atomics, and
//   (without the swizzle) never share a bank while adding; the swizzle keeps
//   the fold below free of conflicts.  A lane issues the loads of kUnroll
//   rows before it adds any of them.  At the end of a value row one lane per
//   group adds the 32 lane sums in lane order, then the warps are added in
//   warp order, and the block writes one partial per (row, group) to a
//   (A, G, blocks) buffer.  A non-finite value is counted in shared memory
//   (integer atomics: exact in any order) and summed as 0, so no indicator
//   rows are stacked; the counts go to a (3, A, G) int64 output once per
//   block and row.
// - pass 2: one warp per (row, group); lane l adds the partials of blocks
//   l, l + 32, ... in block order, then a fixed shuffle tree adds the lanes.
//
// The longest chain of additions a value goes through is
//   rows per lane (<= stage_rows / 256 = 32) + 32 (lane fold) + 8 (warps)
//   + ceil(blocks / 32) + 5 (pass 2),
// where blocks <= max(resident blocks, ceil(n / stage_rows)).  At TPC-H Q1,
// SF 1 on an H100 (5,922,285 rows, 132 SMs x 8 resident blocks): ranges of
// 5,632 rows, 1,052 blocks, so 22 + 32 + 8 + 33 + 5 = 100 additions.  For
// every n the chain stays below the (1024 + ceil(n/1024)) * eps * sum|v|
// bound the callers hold it to.  Two runs on the same inputs and card give
// the same bits (the grid depends only on n, G and the card).  The plain
// PyTorch version is `segsum_accumulate_plain` in ops/gpu_kernels.py.
//
// What bounds it on an H100: reading the values once -- at TPC-H Q1, SF 1
// cast to float32 (17 rows x 5.9 M, int32 codes, uint8 mask) about 0.43 GB,
// 0.13 ms at the data sheet's 3.35 TB/s.  The design reads each value once
// per group slice, coalesced, with kUnroll loads in flight per lane, a
// handful of instructions per value and no shuffles, at full occupancy:
// without the minimum of blocks in __launch_bounds__, ptxas gives the
// float32 kernel more registers, fewer blocks fit on an SM, and it is
// slower on the H100.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;      // loads a lane issues together

// Blocks per SM asked of __launch_bounds__: all 8 that the threads allow
// in float32 (32 registers); float64 takes 6 (40 registers) rather than
// spill.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 8 : 6;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T tree_sum(T s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  return s;   // in lane 0
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) segsum_range_kernel(
    const T* __restrict__ vals, long long n, int A,
    const int* __restrict__ codes, const unsigned char* __restrict__ mask,
    int G, int width, int range, T* __restrict__ partial,
    unsigned long long* __restrict__ nonfinite) {
  // [warp][g] warp sums; [warp][g][lane] lane sums; [kind][g] u32 counts;
  // [row of the range] int16 group codes within the slice
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.y * width;
  const int gs = min(width, G - g0);
  T* wsum = reinterpret_cast<T*>(smem);
  T* lacc = wsum + kWarps * gs;
  unsigned* cnt = reinterpret_cast<unsigned*>(lacc + (size_t)kWarps * gs * 32);
  short* gcode = reinterpret_cast<short*>(cnt + 3 * gs);

  const long long start = (long long)blockIdx.x * range;
  const int rows = (int)min((long long)range, n - start);
  for (int j = threadIdx.x; j < rows; j += kThreads) {
    const long long i = start + j;
    int g = -1;
    if (mask[i]) {
      const int c = codes[i];
      if (c >= g0 && c - g0 < gs) g = c - g0;
    }
    gcode[j] = (short)g;
  }
  for (int j = threadIdx.x; j < 3 * gs; j += kThreads) cnt[j] = 0u;
  __syncthreads();

  T* mine = lacc + (size_t)warp * gs * 32;
  for (int a = 0; a < A; ++a) {
    const T* row = vals + (long long)a * n + start;
    for (int g = 0; g < gs; ++g) mine[g * 32 + (lane ^ (g & 31))] = T(0);
    for (int j0 = warp * 32 + lane; j0 < rows; j0 += kThreads * kUnroll) {
      T v[kUnroll];
      int gg[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads;
        v[u] = j < rows ? row[j] : T(0);
        gg[u] = j < rows ? gcode[j] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int g = gg[u];
        if (g < 0) continue;
        const T x = v[u];
        if (!isfinite(x)) {
          const int kind = isnan(x) ? 0 : (x > T(0) ? 1 : 2);
          atomicAdd(cnt + kind * gs + g, 1u);
          continue;
        }
        mine[g * 32 + (lane ^ (g & 31))] += x;
      }
    }
    __syncwarp();
    for (int g = lane; g < gs; g += 32) {
      T s = T(0);
      for (int l = 0; l < 32; ++l) s += mine[g * 32 + (l ^ (g & 31))];
      wsum[warp * gs + g] = s;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < gs; t += kThreads) {
      T s = T(0);
      for (int w = 0; w < kWarps; ++w) s += wsum[w * gs + t];
      partial[((size_t)a * G + g0 + t) * gridDim.x + blockIdx.x] = s;
    }
    for (int t = threadIdx.x; t < 3 * gs; t += kThreads) {
      const unsigned c = cnt[t];
      if (c == 0u) continue;
      const int kind = t / gs;
      atomicAdd(nonfinite + ((long long)kind * A + a) * G + g0 + (t - kind * gs),
                (unsigned long long)c);
      cnt[t] = 0u;
    }
    __syncthreads();
  }
}

// One warp per (row, group): the partials of the blocks in block order per
// lane, then a fixed tree over the lanes.
template <typename T>
__global__ void segsum_reduce_blocks(const T* __restrict__ partial,
                                     int blocks, int AG, T* __restrict__ out) {
  const int w = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= AG) return;
  const T* p = partial + (size_t)w * blocks;
  T s = T(0);
  for (int b = lane; b < blocks; b += 32) s += p[b];
  s = tree_sum(s);
  if (lane == 0) out[w] = s;
}

template <typename T>
int launch(const T* vals, long long n, int A, const int* codes,
           const unsigned char* mask, int G, int width, int stage_rows,
           int smem, T* partial, long long capacity,
           unsigned long long* nonfinite, T* out, void* stream) {
  if (n <= 0 || A <= 0 || G <= 0) return 0;
  if (width <= 0 || stage_rows < kThreads) return (int)cudaErrorInvalidValue;
  auto kernel = segsum_range_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) per_sm = 1;
  // equal ranges for the resident blocks (shared among the group slices),
  // whole warps of rows, at most the staged rows per block
  const long long slices = (G + width - 1) / width;
  long long resident = (long long)sms * per_sm / slices;
  if (resident < 1) resident = 1;
  long long range = (n + resident - 1) / resident;
  range = (range + kThreads - 1) / kThreads * kThreads;
  if (range > stage_rows) range = stage_rows;
  const long long blocks = (n + range - 1) / range;
  if (blocks * A * G > capacity) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks, (unsigned)slices);
  kernel<<<grid, kThreads, smem, s>>>(vals, n, A, codes, mask, G, width,
                                      (int)range, partial, nonfinite);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int AG = A * G;
  segsum_reduce_blocks<T><<<(AG + 7) / 8, 256, 0, s>>>(partial, (int)blocks,
                                                       AG, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is device memory:
// vals (A x n), codes (n), mask (n), partial scratch of `capacity` elements
// (at least A * G * blocks), nonfinite (3 x A x G, zeroed), out (A x G).
// The wrapper plans the groups per slice (`width`), the staged rows per
// block and the shared memory.  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int dsql_segsum_accumulate_f32(
    const float* vals, long long n, int A, const int* codes,
    const unsigned char* mask, int G, int width, int stage_rows, int smem,
    float* partial, long long capacity, unsigned long long* nonfinite,
    float* out, void* stream) {
  return launch<float>(vals, n, A, codes, mask, G, width, stage_rows, smem,
                       partial, capacity, nonfinite, out, stream);
}

extern "C" int dsql_segsum_accumulate_f64(
    const double* vals, long long n, int A, const int* codes,
    const unsigned char* mask, int G, int width, int stage_rows, int smem,
    double* partial, long long capacity, unsigned long long* nonfinite,
    double* out, void* stream) {
  return launch<double>(vals, n, A, codes, mask, G, width, stage_rows, smem,
                        partial, capacity, nonfinite, out, stream);
}
