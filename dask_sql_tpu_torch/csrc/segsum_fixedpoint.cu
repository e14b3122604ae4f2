// Exact masked per-group sums on a fixed-point limb grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_seg_matmul_perblock_kernel`
// (dask_sql_tpu/ops/pallas_kernels.py), reached there through
// `_segmented_sums_limbs` -> `segmented_sums_fixedpoint`.  The TPU walks
// 4096-row blocks in order and contracts sign-split 12-bit f32 limbs against
// a one-hot group matrix on the MXU; f32 partials below 2^24 stay exact and
// the host side adds them up in f64.
//
// Here blocks run in parallel and in no order, so the sums are INTEGER sums:
// every value becomes sign-split 21-bit limbs (1 limb for a 'unit' row, 3 per
// sign for an 'int' row, 4 per sign for a 'float' row scaled by an exact
// power of two below 2^84), and each (limb row, group) total accumulates in
// unsigned 64-bit two's complement -- first in shared memory per block, then
// once per block into the global int64 output.  Integer addition is
// associative, so the totals are exact, deterministic and bit-identical to
// the plain PyTorch version (`segsum_limb_totals_plain` in
// ops/gpu_kernels.py), whatever order the blocks run in.  NaN/+Inf/-Inf are
// classified in registers and counted per (row, group) in the same pass, so
// each value is read once (the plain version builds the 3*A indicator rows).
//
// Limits: a limb is below 2^21, so a total over n rows is below n * 2^21;
// the wrapper requires n < 2^32, which keeps every total below 2^53 (exact
// in f64 for the recombination) and far from 2^64.
//
// What bounds it on an H100: reading the values once.  At TPC-H Q1, SF 1
// (17 f64 value rows x 6.0 M rows, int32 codes, uint8 mask) that is about
// 0.85 GB, 0.25 ms at the data sheet's 3.35 TB/s.  The design reads each
// value once, coalesced (consecutive threads take consecutive rows of one
// value row), and keeps the one-hot out of memory entirely: the group code
// selects a shared-memory accumulator.  What it does not yet do is avoid the
// shared-memory atomics on a few hot addresses (Q1 has 4 live groups), which
// is where a faster version would start (warp-level pre-reduction, or int8
// tensor-core one-hot products on 7-bit limbs).
//
// The value rows are tiled over blockIdx.y so that one tile's accumulators
// ((limb rows + 3 count rows per value row) x groups x 8 bytes) fit the shared
// memory a block can have; the wrapper plans the tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr double kLimbBase = 2097152.0;             // 2^21
constexpr double kInvLimbBase = 1.0 / 2097152.0;    // 2^-21, exact

// Splits the non-negative integer-valued double h into n_limbs base-2^21
// digits and adds each non-zero digit to acc[lk * G + g].  Every step is
// exact: h * 2^-21 and q * 2^21 are power-of-two scalings and the remainder
// is an integer below 2^21.
__device__ __forceinline__ void add_limbs(unsigned long long* acc, int G, int g,
                                          double h, int n_limbs) {
  for (int lk = 0; lk < n_limbs; ++lk) {
    const double q = floor(h * kInvLimbBase);
    const double r = h - q * kLimbBase;
    if (r != 0.0) atomicAdd(acc + (size_t)lk * G + g, (unsigned long long)r);
    h = q;
  }
}

__global__ void __launch_bounds__(kThreads) segsum_fixedpoint_kernel(
    const double* __restrict__ vals, long long n, int A,
    const int* __restrict__ codes, const unsigned char* __restrict__ mask,
    const double* __restrict__ scale, const int* __restrict__ row_limbs,
    const int* __restrict__ row_signed, const int* __restrict__ row_out0,
    const int* __restrict__ tile_row0, int G,
    unsigned long long* __restrict__ out_limbs,
    unsigned long long* __restrict__ out_nonfinite) {
  extern __shared__ unsigned long long acc[];
  const int a0 = tile_row0[blockIdx.y];
  const int a1 = tile_row0[blockIdx.y + 1];
  const int tile_rows = a1 - a0;
  const int limb0 = row_out0[a0];
  const int n_limb_acc = (row_out0[a1] - limb0) * G;
  const int n_acc = n_limb_acc + 3 * tile_rows * G;
  // count rows follow the limb rows: [kind][row in tile][group]
  unsigned long long* acc_nf = acc + n_limb_acc;
  for (int j = threadIdx.x; j < n_acc; j += blockDim.x) acc[j] = 0ULL;
  __syncthreads();

  const long long per_block = (n + gridDim.x - 1) / gridDim.x;
  const long long start = (long long)blockIdx.x * per_block;
  const long long stop = start + per_block < n ? start + per_block : n;
  for (long long i = start + threadIdx.x; i < stop; i += blockDim.x) {
    if (!mask[i]) continue;
    const int g = codes[i];
    if (g < 0 || g >= G) continue;
    for (int a = a0; a < a1; ++a) {
      const double v = vals[(long long)a * n + i];
      if (!isfinite(v)) {
        const int kind = isnan(v) ? 0 : (v > 0.0 ? 1 : 2);
        atomicAdd(acc_nf + (size_t)(kind * tile_rows + (a - a0)) * G + g, 1ULL);
        continue;
      }
      const double u = v * scale[a];
      const int L = row_limbs[a];
      unsigned long long* row_acc = acc + (size_t)(row_out0[a] - limb0) * G;
      add_limbs(row_acc, G, g, floor(fmax(u, 0.0)), L);
      if (row_signed[a]) {
        add_limbs(row_acc + (size_t)L * G, G, g, floor(fmax(-u, 0.0)), L);
      }
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < n_acc; j += blockDim.x) {
    const unsigned long long s = acc[j];
    if (s == 0ULL) continue;
    if (j < n_limb_acc) {
      atomicAdd(out_limbs + (size_t)limb0 * G + j, s);
    } else {
      const int k = j - n_limb_acc;
      const int row = k / G;
      const int g = k - row * G;
      const int kind = row / tile_rows;
      const int a = a0 + (row - kind * tile_rows);
      atomicAdd(out_nonfinite + ((size_t)kind * A + a) * G + g, s);
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is device memory;
// out_limbs (L x G) and out_nonfinite (3 x A x G) must be zeroed.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dsql_segsum_fixedpoint(
    const double* vals, long long n, int A, const int* codes,
    const unsigned char* mask, const double* scale, const int* row_limbs,
    const int* row_signed, const int* row_out0, const int* tile_row0,
    int n_tiles, int G, int smem_bytes, unsigned long long* out_limbs,
    unsigned long long* out_nonfinite, void* stream) {
  if (n <= 0 || A <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      segsum_fixedpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, segsum_fixedpoint_kernel, kThreads, smem_bytes)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) per_sm = 1;
  long long blocks = (long long)sms * per_sm;
  const long long needed = (n + kThreads - 1) / kThreads;
  if (blocks > needed) blocks = needed;
  const dim3 grid((unsigned)blocks, (unsigned)n_tiles);
  segsum_fixedpoint_kernel<<<grid, kThreads, smem_bytes,
                             (cudaStream_t)stream>>>(
      vals, n, A, codes, mask, scale, row_limbs, row_signed, row_out0,
      tile_row0, G, out_limbs, out_nonfinite);
  return (int)cudaGetLastError();
}
