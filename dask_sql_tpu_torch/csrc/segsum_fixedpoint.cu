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
// unsigned 64-bit two's complement.  Integer addition is associative, so the
// totals are exact, deterministic and bit-identical to the plain PyTorch
// version (`segsum_limb_totals_plain` in ops/gpu_kernels.py) whatever the
// schedule.  NaN/+Inf/-Inf are counted per (row, group) in the same pass.
//
// What bounds it on an H100: reading the values once.  At TPC-H Q1, SF 1
// (17 f64 value rows x 5.9 M rows, int32 codes, uint8 mask) that is 0.835 GB,
// 0.249 ms at the data sheet's 3.35 TB/s; one add per value is 3 us of FP64.
// What held the earlier design (one lane, one value, one shared atomic per
// non-zero limb) at 8x the bound was the instructions per value: Q1's 32
// lanes land on 4 live groups, so each atomic serialised up to 16-way.  The
// design therefore spends as few warp instructions per value as it can, and
// keeps the SM full of warps to hide their latency:
//
// 1. Each warp takes 32-row chunks of a contiguous range of rows per block.
//    It reads a chunk's codes and mask once and finds the chunk's group
//    structure once (__match_any_sync on the code); every value row of the
//    tile shares it.  Rows masked out or with a code outside [0, G) form the
//    "no group" set.
// 2. The limbs come from integers: floor(|u|) of the scaled value u is split
//    exactly into two 42-bit halves (t = floor(|u| * 2^-42), lo = fma(-t,
//    2^42, |u|), both exact, each converted once), and each 21-bit limb is a
//    shift and a mask.  floor(|u|) goes into the half of u's sign.  One
//    __reduce_or_sync per value finds the limbs that are non-zero in some
//    lane, and only those are summed (Q1's quantities, scaled by 2^78, have
//    three zero limbs of four, and no value is negative).  A unit row that
//    holds only 0 and 1 in the chunk (COUNT and occupancy streams) takes a
//    population count of its ballot per group instead.
// 3. Each limb is summed over the lanes of one group in the warp before
//    shared memory is touched: a limb is below 2^21, so 32 of them fit in 32
//    bits, and __reduce_add_sync over the group's lanes (hardware redux.sync;
//    each group's lanes name their own mask) gives the group sum.  One leader
//    lane per group then adds it, so no instruction has two lanes on one
//    address.  When (limb rows x G x 8 B) per warp fits the wrapper's
//    budget (Q1: 66 x 6 x 8 = 3.2 KB), each warp owns its accumulators and
//    adds without atomics; the block folds them at the end.  Above it (G up
//    to 256) the leaders add into block-shared accumulators with 64-bit
//    shared atomics, where codes spread over many slots contend little.
//    Non-finite counts are rare and stay 32-bit shared atomics.
// 4. Loads: each value row's load is issued kRows rows before the row is
//    reduced, from a small queue, so the reduction body exists once in the
//    code.  __launch_bounds__ asks for 8 blocks of 256 threads per SM (32
//    registers, 64 warps): on Q1, occupancy bought more than loads in
//    flight -- 4 queued rows at 8 blocks, or 2 at 3 blocks, were slower.
// 5. The grid holds as many blocks as stay resident; each block adds its
//    totals into the global int64 output once per (limb row, group), with
//    global atomics.
//
// Limits: a limb is below 2^21, so a total over n rows is below n * 2^21;
// the wrapper requires n < 2^32, which keeps every total below 2^53 (exact
// in f64 for the recombination) and far from 2^64.
//
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 8;   // blocks per SM asked of __launch_bounds__
constexpr int kRows = 2;        // value loads queued ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kLimbMask = (1u << 21) - 1u;

// One warp's 32-row chunk: which lanes sum together.
struct Chunk {
  int g;             // this lane's group, -1 if the row contributes nothing
  unsigned peers;    // the lanes with the same g
  bool leader;       // lowest lane of a contributing group
};

__device__ __forceinline__ void add_slot(unsigned long long* slot,
                                         unsigned long long s, bool owned) {
  if (owned) {
    *slot += s;
  } else {
    atomicAdd(slot, s);
  }
}

// Adds, for every group of the chunk, the sum of x over its lanes into
// row[g] (row: one limb row of accumulators).
template <bool kPrivate>
__device__ __forceinline__ void add_group_sums(unsigned long long* row,
                                               unsigned x, const Chunk& ch) {
  const unsigned s = __reduce_add_sync(ch.peers, x);
  if (ch.leader && s != 0u) add_slot(row + ch.g, s, kPrivate);
}

// The L limbs per sign of u = v * scale (0 where the lane contributes
// nothing) into the value row's limb rows: the positive half's L rows, then,
// for a signed row (L > 1), the negative half's.
template <int L, bool kPrivate>
__device__ __forceinline__ void add_value(unsigned long long* acc_row, int G,
                                          double u, const Chunk& ch) {
  double x = fabs(u);
  // a float row's contributing values are below 2^84 by their scale; an
  // int or unit row's limbs are bits of floor(x) below 2^84, which this
  // keeps (the subtraction is exact)
  if (L != 4 && x >= 0x1p84) x -= floor(x * 0x1p-84) * 0x1p84;
  const double t = floor(x * 0x1p-42);
  const unsigned long long hi = (unsigned long long)t;
  const unsigned long long lo = (unsigned long long)fma(-t, 0x1p42, x);
  const unsigned limb[4] = {(unsigned)lo & kLimbMask, (unsigned)(lo >> 21),
                            (unsigned)hi & kLimbMask, (unsigned)(hi >> 21)};
  // floor(x) goes into the half of u's sign (an unsigned row has only the
  // positive one); bit h * L + j of `live` says whether limb j of half h is
  // non-zero in any lane, so one warp reduction finds every limb to skip
  const int half = u < 0.0 ? 1 : 0;
  unsigned mine = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) mine |= (limb[j] != 0u ? 1u : 0u) << j;
  if (L == 1 && half) mine = 0u;
  const unsigned live = __reduce_or_sync(kFull, mine << (half * L));
#pragma unroll
  for (int h = 0; h < (L == 1 ? 1 : 2); ++h) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (((live >> (h * L + j)) & 1u) == 0u) continue;
      add_group_sums<kPrivate>(acc_row + (size_t)(h * L + j) * G,
                               half == h ? limb[j] : 0u, ch);
    }
  }
}

// A unit row (COUNT and occupancy streams) is 0 or 1 almost always: then a
// group's sum is the population count of its lanes that hold 1.
template <bool kPrivate>
__device__ __forceinline__ void add_unit(unsigned long long* acc_row, int G,
                                         double u, const Chunk& ch) {
  const unsigned ones = __ballot_sync(kFull, u == 1.0);
  if (__ballot_sync(kFull, u != 0.0 && u != 1.0) == 0u) {
    const unsigned s = (unsigned)__popc(ones & ch.peers);
    if (ch.leader && s != 0u) add_slot(acc_row + ch.g, s, kPrivate);
    return;
  }
  add_value<1, kPrivate>(acc_row, G, u, ch);
}

// meta: [limbs per sign, A][first limb row, A + 1][tile start rows, tiles + 1]
template <bool kPrivate>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    segsum_fixedpoint_kernel(
    const double* __restrict__ vals, long long n, int A,
    const int* __restrict__ codes, const unsigned char* __restrict__ mask,
    const double* __restrict__ scale, const int* __restrict__ meta, int G,
    long long chunks_per_block, unsigned long long* __restrict__ out_limbs,
    unsigned long long* __restrict__ out_nonfinite) {
  const int* row_limbs = meta;
  const int* row_out0 = meta + A;
  const int* tile_row0 = meta + 2 * A + 1;
  const int a0 = tile_row0[blockIdx.y];
  const int at = tile_row0[blockIdx.y + 1] - a0;
  const int limb0 = row_out0[a0];
  const int tile_acc = (row_out0[a0 + at] - limb0) * G;
  const int n_acc = kPrivate ? kWarps * tile_acc : tile_acc;

  // [warp][limb row][g] (or [limb row][g]) u64, then per tile row its scale,
  // limbs and first limb row, then [kind][row][g] u32 non-finite counts
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* acc = smem;
  double* sc = reinterpret_cast<double*>(acc + n_acc);
  int* lim = reinterpret_cast<int*>(sc + at);
  int* off = lim + at;
  unsigned* cnt = reinterpret_cast<unsigned*>(off + at);
  for (int j = threadIdx.x; j < n_acc; j += kThreads) acc[j] = 0ull;
  for (int j = threadIdx.x; j < 3 * at * G; j += kThreads) cnt[j] = 0u;
  for (int j = threadIdx.x; j < at; j += kThreads) {
    sc[j] = scale[a0 + j];
    lim[j] = row_limbs[a0 + j];
    off[j] = row_out0[a0 + j] - limb0;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long* my_acc = kPrivate ? acc + (size_t)warp * tile_acc : acc;
  const long long n_chunks = (n + 31) >> 5;
  const long long c0 = (long long)blockIdx.x * chunks_per_block;
  const long long c1 = min(n_chunks, c0 + chunks_per_block);
  for (long long c = c0 + warp; c < c1; c += kWarps) {
    const long long i = (c << 5) + lane;
    const bool in = i < n;
    Chunk ch;
    ch.g = -1;
    if (in && mask[i]) {
      const int k = codes[i];
      if (k >= 0 && k < G) ch.g = k;
    }
    if (__ballot_sync(kFull, ch.g >= 0) == 0u) continue;
    ch.peers = __match_any_sync(kFull, ch.g);
    ch.leader = ch.g >= 0 && lane == __ffs(ch.peers) - 1;
    // a queue of the next kRows value loads: each row's load is issued
    // kRows rows before the row is reduced, and the body below exists once
    double q[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      q[r] = (in && r < at) ? vals[(long long)(a0 + r) * n + i] : 0.0;
#pragma unroll 1
    for (int ar = 0; ar < at; ++ar) {
      double x = q[0];
#pragma unroll
      for (int r = 0; r + 1 < kRows; ++r) q[r] = q[r + 1];
      q[kRows - 1] = (in && ar + kRows < at)
                         ? vals[(long long)(a0 + ar + kRows) * n + i]
                         : 0.0;
      if (ch.g < 0) x = 0.0;
      if (!isfinite(x)) {   // rare: lanes diverge only when one is hit
        const int kind = isnan(x) ? 0 : (x > 0.0 ? 1 : 2);
        atomicAdd(cnt + (kind * at + ar) * G + ch.g, 1u);
        x = 0.0;
      }
      const double u = x * sc[ar];
      unsigned long long* row = my_acc + (size_t)off[ar] * G;
      switch (lim[ar]) {
        case 1: add_unit<kPrivate>(row, G, u, ch); break;
        case 3: add_value<3, kPrivate>(row, G, u, ch); break;
        default: add_value<4, kPrivate>(row, G, u, ch); break;
      }
    }
    __syncwarp();   // the next chunk's leaders read what these wrote
  }
  __syncthreads();

  for (int j = threadIdx.x; j < tile_acc; j += kThreads) {
    unsigned long long s = acc[j];
    if (kPrivate) {
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += acc[(size_t)w * tile_acc + j];
    }
    if (s != 0ull) atomicAdd(out_limbs + (size_t)limb0 * G + j, s);
  }
  for (int j = threadIdx.x; j < 3 * at * G; j += kThreads) {
    const unsigned s = cnt[j];
    if (s == 0u) continue;
    const int kind = j / (at * G);
    const int rest = j - kind * at * G;
    const int r = rest / G;
    atomicAdd(out_nonfinite + ((size_t)kind * A + a0 + r) * G + (rest - r * G),
              (unsigned long long)s);
  }
}

template <bool kPrivate>
int launch(const double* vals, long long n, int A, const int* codes,
           const unsigned char* mask, const double* scale, const int* meta,
           int n_tiles, int G, int smem_bytes, unsigned long long* out_limbs,
           unsigned long long* out_nonfinite, cudaStream_t stream) {
  auto kernel = segsum_fixedpoint_kernel<kPrivate>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem_bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) per_sm = 1;
  // as many blocks as stay resident (over the tiles), each a contiguous
  // range of chunks, at least one chunk per warp
  const long long n_chunks = (n + 31) / 32;
  long long blocks = ((long long)sms * per_sm + n_tiles - 1) / n_tiles;
  const long long most = (n_chunks + kWarps - 1) / kWarps;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  const long long per_block = (n_chunks + blocks - 1) / blocks;
  blocks = (n_chunks + per_block - 1) / per_block;
  const dim3 grid((unsigned)blocks, (unsigned)n_tiles);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      vals, n, A, codes, mask, scale, meta, G, per_block, out_limbs,
      out_nonfinite);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is device memory;
// meta is int32 [limbs per sign (A)][first limb row (A + 1)][tile start rows
// (n_tiles + 1)]; out_limbs (L x G) and out_nonfinite (3 x A x G) must be
// zeroed.  private_acc != 0 gives each warp its own accumulators (the
// wrapper sizes smem_bytes for the mode).  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int dsql_segsum_fixedpoint(
    const double* vals, long long n, int A, const int* codes,
    const unsigned char* mask, const double* scale, const int* meta,
    int n_tiles, int G, int private_acc, int smem_bytes,
    unsigned long long* out_limbs, unsigned long long* out_nonfinite,
    void* stream) {
  if (n <= 0 || A <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return private_acc
             ? launch<true>(vals, n, A, codes, mask, scale, meta, n_tiles, G,
                            smem_bytes, out_limbs, out_nonfinite, s)
             : launch<false>(vals, n, A, codes, mask, scale, meta, n_tiles, G,
                             smem_bytes, out_limbs, out_nonfinite, s);
}
