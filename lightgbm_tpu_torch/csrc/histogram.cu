// Gradient/hessian histogram kernel for Hopper (sm_90a): kernel B1 of the
// PyTorch port.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_histogram.py:_hist_kernel
// (launched by hist_pallas, wrapped by build_histograms_pallas). It computes
// what that kernel computes, not how: for every row r of a pass with slot s
// and every feature f, add (g[r], h[r], inc[r] != 0) into
// hist[s, f, X[r, f]]. The TPU contracts a per-feature one-hot against
// slot-weight columns on the MXU because it has no fast scatter; here the
// histogram is a scatter into shared memory.
//
// Rows of a pass: slot-grouped positions 0..n_active-1 over a partition.
// Slot s holds positions [cum[s-1], cum[s]) with cum the inclusive prefix
// sum of slot_counts, and position p of slot s reads row
// perm[p - cum[s-1] + slot_starts[s]] (slot_starts == nullptr: perm[p]).
// The grower passes its leaf-contiguous partition on every wave, so a pass
// reads only the pending leaves' rows; the wrapper derives such positions on
// the device when the caller gives no partition.
//
// Arithmetic: g and h are added as 64-bit fixed-point integers,
// q = __double2ll_rn(x * scale), with one power-of-two scale per tree chosen
// on the card (ops/histogram.py:histogram_scales) so that
// n_rows * max|x| * scale < 2^62; counts are 32-bit.
// Integer addition is associative, so the order in which atomics land does
// not change a bit of the result: two launches are bit-identical and
// training is bit-identical run to run. Error per bin against the exact f64
// sum: |rows_in_bin| / (2 * scale) from the rounding of each q, plus half an
// f32 ulp from the final conversion. The plain version in ops/histogram.py
// does the same arithmetic, so the two agree bit for bit.
//
// Bound at N = 2M rows, F = 28, S = 25, B = 256: every row read once is
// N * (F code bytes + 12 bytes of g/h/inc + 4 bytes of perm), 88 MB, plus
// the 2 MB output: about 27 us at 3.35 TB/s. The work is 1.7e8 (row,
// feature, channel) additions, far below any operation bound, so the kernel
// is bound by bytes in principle; in practice by its shared-memory atomics
// on contiguous rows and by sector-wasting row gathers through perm
// (PERF.md: copies of this file that each left out one cost, timed on the
// card).
//
// Design, against each cost of the first version (grid row blocks x F, one
// feature per block, shared memory for all S slots, 64-bit shared atomics):
//   1. A block takes a contiguous run of positions and a group of fg
//      features, all F when they fit: a sub-histogram [fg, B] of ONE slot,
//      20 bytes a bin (143,360 at F = 28, B = 256, under the 232,448 bytes
//      a block may opt into). The features that do not fit (large F, or
//      B = 512 from uint16 codes) form further groups on the grid's y axis.
//      A row's fg codes are read once, contiguously, as 32-bit words
//      (seven for 28 uint8 codes; a row that does not start on a word is
//      shifted into place), and its
//      g, h and inc are read and quantised once per row and group, not once
//      per feature.
//   2. Block b takes positions [b * R, (b + 1) * R) and splits them where
//      they cross a slot boundary, found from the per-slot prefix in shared
//      memory once per range, not per row. At the end of each slot's range
//      the block adds its non-zero bins into the global [S, F, B] integer
//      accumulators and zeroes them. A root wave (one slot) zeroes and
//      flushes one slot's bins per block, not S.
//   3. Lanes over rows: each thread adds whole rows, a loop over the
//      features of its row, so that a row's adds are independent of each
//      other. Lanes over features (a warp adding one staged row at a time,
//      lane f taking feature f in a layout where no two lanes share a bank)
//      measured 3.4x slower on the card and is not kept (PERF.md).
//   4. No asynchronous copies: a two-stage cp.async ring (each thread
//      copying its next row into shared memory while it adds the current
//      one) gave the same bits but measured slower on every pass, and is
//      not kept (PERF.md).
//   5. No tensor cores: the TPU's one-hot contraction stands in for a
//      scatter the TPU lacks, and the result here is an exact 64-bit
//      fixed-point sum, which no tensor-core format accumulates (int8 MMA
//      accumulates in int32).
//   6. A pass is three operations on the stream: a memset of the
//      accumulators, hist_kernel and finalize_kernel (integer sums to the
//      [S, F, B, 3] f32 output), each behind a C entry of its own. A
//      streamed pass (tpu_residency=stream, kernel B11) runs hist_kernel
//      once per host shard into the same accumulator, each launch reading
//      that shard's code buffer and its rows' g / h / inc at the shard's
//      row offset, and finalize_kernel once per wave; the fold replaces
//      the TPU's f32 accumulator carried across shard legs with its Kahan
//      compensation (lightgbm_tpu/ops/histogram.py:build_histograms
//      acc_init / comp_init). The integer sums make the streamed pass
//      bit-equal to one resident pass; what it adds is the accumulator's
//      traffic, one flush of each block's sub-histogram per shard.
//   7. Sizes on the card: n_active (the sum of slot_counts, or a device
//      int64 the caller writes) and the two fixed-point scales are read
//      from device memory, never from the host, so a pass needs no host
//      read and replays from a CUDA graph. The grid is sized once per shape
//      for the worst case, n_active = N (ops/cuda_histogram.py:
//      grid_blocks); hist_kernel alone derives each block's run from
//      n_active (min(grid, ceil(n_active / min_rows)) blocks of equal runs),
//      and the blocks past the end exit at once. The sums are order-free,
//      so any partition of the positions gives the same bits.
//   8. Wide bins (ROADMAP B1c): a feature whose [B] sub-histogram does not
//      fit one block's shared memory (B above 11,520: max_bin up to the
//      JAX package's 65,535) is cut into bin tiles of at most that width.
//      The grid's y axis walks (feature group, bin tile) pairs; a block
//      adds only the codes inside its tile into its shared sub-histogram
//      and flushes it into the same [S, F, B] integer accumulators at the
//      tile's offset, so finalize_kernel is unchanged and the sums stay
//      the integers of one untiled pass (bit-equal to the plain version,
//      independent of row order and grouping). Such a feature's codes are
//      read once per tile: right first, fast later. Codes of 2^15 or more
//      (a feature of more than 32,768 bins) come as int32 (a third CodeT),
//      so that every torch op on the codes keeps their unsigned value.
//      Features at or below the limit keep the untiled launch exactly
//      (kTiled false: one tile of all B bins).
//   9. Launches are counted on the card: finalize_kernel adds one to a
//      device counter per pass, so a pass replayed from a CUDA graph is
//      counted where it runs and a capture, which runs nothing, counts
//      nothing.
//
// Malformed input (a bin code >= B, a row index outside [0, N), positions
// past the last slot's segment) is not added and fails a device assert at
// the end of the thread's rows, as PyTorch's own index kernels assert: it is
// reported at the next synchronisation as a device-side assert, never
// silently dropped. The plain version raises on the same inputs.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 64;
constexpr int kMaxDevices = 64;      // devices a process may launch on
constexpr int kThreads = 1024;
constexpr int kWordsPerLoad = 8;     // code words a thread loads at once

// A block's sub-histogram of one slot, feature-major (word f * B + bin):
// for each (feature, bin), g and h as 64-bit integers held in two 32-bit
// words each, and a 32-bit count. Hopper has no native 64-bit
// shared-memory atomic add (nvcc emits a compare-and-swap loop,
// ATOMS.CAST.SPIN.64), so a 64-bit add is a native 32-bit add of the low
// word whose returned old value gives the carry, and a 32-bit add of the
// high word plus that carry when it is not zero. The words wrap mod 2^32;
// hi * 2^32 + lo is the exact sum mod 2^64, which is the sum itself, since
// it fits in an int64.
struct SubHist {
  unsigned int* g_lo;
  unsigned int* g_hi;
  unsigned int* h_lo;
  unsigned int* h_hi;
  unsigned int* c;
  int num_bins;      // bins of the block's tile (all B bins untiled)
  int bin0;          // the tile's first bin
  int total_bins;    // B, every code's bound

  __device__ __forceinline__ static void add64(unsigned int* lo,
                                               unsigned int* hi, int i,
                                               unsigned long long q) {
    const unsigned int q_lo = static_cast<unsigned int>(q);
    const unsigned int old = atomicAdd(&lo[i], q_lo);
    const unsigned int up =
        static_cast<unsigned int>(q >> 32) + (old + q_lo < old ? 1u : 0u);
    if (up != 0u) atomicAdd(&hi[i], up);
  }

  // adds one (feature, code) of a row; false for a code out of range.
  // kTiled: a code of another tile is skipped (it is that tile's block's)
  template <bool kTiled>
  __device__ __forceinline__ bool add(int f, unsigned int code,
                                      unsigned long long qg,
                                      unsigned long long qh,
                                      bool counted) const {
    if (kTiled) {
      code -= static_cast<unsigned int>(bin0);   // wraps below the tile
      if (code >= static_cast<unsigned int>(num_bins))
        return code + static_cast<unsigned int>(bin0) <
               static_cast<unsigned int>(total_bins);
    } else if (code >= static_cast<unsigned int>(num_bins)) {
      return false;
    }
    const int i = f * num_bins + static_cast<int>(code);
    add64(g_lo, g_hi, i, qg);
    add64(h_lo, h_hi, i, qh);
    if (counted) atomicAdd(&c[i], 1u);
    return true;
  }
};

// Adds the rows of positions [p0, p1) of one slot (row perm[q + base]),
// lanes over rows: each thread adds whole rows, every feature of the group,
// so that the adds of a row are independent of each other. A row's codes
// are read as aligned 32-bit words, up to kWordsPerLoad at once. kAligned:
// every row and group starts on a word (F * sizeof(CodeT) a multiple of 4).
// Otherwise (e.g. 27 uint8 codes) the words around the row's codes are read
// and shifted into place with a funnel shift (done for aligned rows too, it
// made the 25-slot pass a quarter slower: PERF.md); the first and last words
// may hold bytes of the neighbouring rows, which are not added, and an
// aligned word that holds a byte of the tensor lies inside its allocation,
// whose size the allocator rounds up to a multiple of 4 or more.
template <typename CodeT, bool kAligned, bool kTiled>
__device__ __forceinline__ void add_rows(
    const SubHist& sub, const CodeT* __restrict__ codes, long long num_rows,
    int num_features, int f0, int fg,
    const float* __restrict__ grad, const float* __restrict__ hess,
    const float* __restrict__ inc, const int32_t* __restrict__ perm,
    long long base, long long p0, long long p1, double scale_g,
    double scale_h, bool& bad) {
  constexpr int kPerWord = 4 / sizeof(CodeT);
  constexpr unsigned int kMask =
      static_cast<unsigned int>((1ull << (8 * sizeof(CodeT))) - 1ull);
  const int nwords = (fg + kPerWord - 1) / kPerWord;  // words of codes
  for (long long q = p0 + threadIdx.x; q < p1; q += blockDim.x) {
    const long long row = perm[q + base];
    if (row < 0 || row >= num_rows) {
      bad = true;
      continue;
    }
    const unsigned long long qg = static_cast<unsigned long long>(
        __double2ll_rn(static_cast<double>(grad[row]) * scale_g));
    const unsigned long long qh = static_cast<unsigned long long>(
        __double2ll_rn(static_cast<double>(hess[row]) * scale_h));
    const bool counted = inc[row] != 0.0f;
    const uintptr_t at =
        reinterpret_cast<uintptr_t>(codes + row * num_features + f0);
    const unsigned int lead =
        kAligned ? 0u : static_cast<unsigned int>(at & 3u);
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(at - lead);
    // aligned words holding the group's codes
    const int nload =
        kAligned ? nwords
                 : static_cast<int>((lead + fg * sizeof(CodeT) + 3u) / 4u);
    for (int w0 = 0; w0 < nwords; w0 += kWordsPerLoad) {
      uint32_t wv[kWordsPerLoad + 1];
#pragma unroll
      for (int k = 0; k < kWordsPerLoad + (kAligned ? 0 : 1); ++k)
        wv[k] = w0 + k < nload ? __ldg(wp + w0 + k) : 0u;
#pragma unroll
      for (int k = 0; k < kWordsPerLoad; ++k) {
        const uint32_t w =
            kAligned ? wv[k] : __funnelshift_r(wv[k], wv[k + 1], 8u * lead);
#pragma unroll
        for (int j = 0; j < kPerWord; ++j) {
          const int f = (w0 + k) * kPerWord + j;
          if (f < fg &&
              !sub.add<kTiled>(
                  f, (w >> (8 * sizeof(CodeT) * j)) & kMask, qg, qh,
                  counted))
            bad = true;
        }
      }
    }
  }
}

// 1024 threads and one block an SM: __launch_bounds__ allows 64 registers
template <typename CodeT, bool kAligned, bool kTiled>
__global__ void __launch_bounds__(kThreads, 1)
hist_kernel(const CodeT* __restrict__ codes, long long num_rows,
            int num_features, int group_features, int tile_bins,
            const float* __restrict__ grad,
            const float* __restrict__ hess,
            const float* __restrict__ inc,
            const int32_t* __restrict__ perm,
            const int32_t* __restrict__ slot_counts,
            const int32_t* __restrict__ slot_starts,
            const long long* __restrict__ n_active_dev, long long min_rows,
            int num_slots, int num_bins, const double* __restrict__ scales,
            unsigned long long* __restrict__ acc_g,
            unsigned long long* __restrict__ acc_h,
            unsigned int* __restrict__ acc_c) {
  extern __shared__ unsigned int smem[];
  // blockIdx.y walks (feature group, bin tile) pairs, tiles fastest
  const int tiles = kTiled ? (num_bins + tile_bins - 1) / tile_bins : 1;
  const int group = kTiled ? static_cast<int>(blockIdx.y) / tiles
                           : static_cast<int>(blockIdx.y);
  const int bin0 = kTiled ? (static_cast<int>(blockIdx.y) - group * tiles) *
                                tile_bins
                          : 0;
  const int nb = kTiled ? min(tile_bins, num_bins - bin0) : num_bins;
  const int f0 = group * group_features;
  const int fg = min(group_features, num_features - f0);
  const int GB = fg * nb;                    // words of one array
  const SubHist sub{smem,          smem + GB,     smem + 2 * GB,
                    smem + 3 * GB, smem + 4 * GB, nb, bin0, num_bins};
  __shared__ long long s_cum[kMaxSlots];    // inclusive prefix of slot_counts
  __shared__ long long s_base[kMaxSlots];   // perm index - position, per slot
  __shared__ long long s_n;                 // n_active

  if (threadIdx.x == 0) {
    long long cum = 0;
    for (int s = 0; s < num_slots; ++s) {
      const long long before = cum;
      cum += slot_counts[s];
      s_cum[s] = cum;
      s_base[s] = slot_starts != nullptr ? slot_starts[s] - before : 0;
    }
    s_n = n_active_dev != nullptr ? *n_active_dev : cum;
  }
  __syncthreads();
  // this pass's ranges: min(grid, ceil(n / min_rows)) blocks of R
  // positions (gridDim.x is the block count of a pass over every row)
  const long long n_active = s_n;
  if (n_active <= 0) return;
  const long long want = (n_active + min_rows - 1) / min_rows;
  const long long nblocks = min(static_cast<long long>(gridDim.x), want);
  const long long rows_per_block = (n_active + nblocks - 1) / nblocks;
  const long long start = static_cast<long long>(blockIdx.x) * rows_per_block;
  if (start >= n_active) return;            // block-uniform
  const long long end = min(start + rows_per_block, n_active);
  const double scale_g = scales[0];
  const double scale_h = scales[1];
  for (int i = threadIdx.x; i < 5 * GB; i += blockDim.x) smem[i] = 0u;
  __syncthreads();
  // set by malformed input; such a row is not added, and the thread fails
  // the assert after its rows (an assert inside the loop costs a stack frame)
  bool bad = false;
  int s = 0;
  while (s < num_slots && s_cum[s] <= start) ++s;
  // the range splits at slot boundaries; s, p and seg_end are block-uniform
  for (long long p = start; p < end; ++s) {
    if (s >= num_slots) {                // n_active > sum(slot_counts)
      bad = true;
      break;
    }
    const long long seg_end = min(end, s_cum[s]);
    if (seg_end <= p) continue;          // an empty slot
    add_rows<CodeT, kAligned, kTiled>(sub, codes, num_rows, num_features,
                                      f0, fg, grad, hess, inc, perm,
                                      s_base[s], p, seg_end, scale_g,
                                      scale_h, bad);
    __syncthreads();
    for (int i = threadIdx.x; i < GB; i += blockDim.x) {
      const int f = i / nb;
      const int b = i - f * nb;
      const unsigned long long g =
          (static_cast<unsigned long long>(sub.g_hi[i]) << 32) | sub.g_lo[i];
      const unsigned long long h =
          (static_cast<unsigned long long>(sub.h_hi[i]) << 32) | sub.h_lo[i];
      const unsigned int c = sub.c[i];
      sub.g_lo[i] = sub.g_hi[i] = sub.h_lo[i] = sub.h_hi[i] = sub.c[i] = 0u;
      const long long o =
          (static_cast<long long>(s) * num_features + f0 + f) * num_bins +
          bin0 + b;
      if (g != 0ull) atomicAdd(&acc_g[o], g);
      if (h != 0ull) atomicAdd(&acc_h[o], h);
      if (c != 0u) atomicAdd(&acc_c[o], c);
    }
    __syncthreads();
    p = seg_end;
  }
  assert(!bad);
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ acc_g,
                                const unsigned long long* __restrict__ acc_h,
                                const unsigned int* __restrict__ acc_c,
                                long long n, const double* __restrict__ scales,
                                float* __restrict__ out,
                                unsigned long long* __restrict__ launches) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the pass's launch, counted where it runs (a graph replay included)
  if (i == 0 && launches != nullptr) atomicAdd(launches, 1ull);
  if (i >= n) return;
  // IEEE division, as the host's 1.0 / scale (exact: a power of two)
  const double inv_g = 1.0 / scales[0];
  const double inv_h = 1.0 / scales[1];
  const double g = static_cast<double>(static_cast<long long>(acc_g[i])) * inv_g;
  const double h = static_cast<double>(static_cast<long long>(acc_h[i])) * inv_h;
  out[3 * i + 0] = static_cast<float>(g);
  out[3 * i + 1] = static_cast<float>(h);
  out[3 * i + 2] = static_cast<float>(acc_c[i]);
}

template <typename CodeT, bool kAligned, bool kTiled>
cudaError_t launch(const void* codes, long long num_rows, int num_features,
                   int group_features, int tile_bins, const float* grad,
                   const float* hess, const float* inc, const int32_t* perm,
                   const int32_t* slot_counts, const int32_t* slot_starts,
                   const long long* n_active, long long min_rows,
                   int num_slots, int num_bins, const double* scales,
                   unsigned long long* acc_g, unsigned long long* acc_h,
                   unsigned int* acc_c, dim3 grid, long long smem,
                   cudaStream_t stream) {
  // raised once per device and size (the attribute is per device); the
  // callers run a shape's first pass eagerly, so it is raised outside any
  // graph capture
  static long long opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > opted_in[device]) {
    err = cudaFuncSetAttribute(hist_kernel<CodeT, kAligned, kTiled>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in[device] = smem;
  }
  hist_kernel<CodeT, kAligned, kTiled><<<grid, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(codes), num_rows, num_features,
      group_features, tile_bins, grad, hess, inc, perm, slot_counts,
      slot_starts, n_active, min_rows, num_slots, num_bins, scales,
      acc_g, acc_h, acc_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes of one block: a [group_features, B]
// sub-histogram, 20 bytes a bin.
long long gbdt_hist_smem_bytes(int group_features, int num_bins) {
  return 20LL * group_features * num_bins;
}

// Bytes of the scratch gbdt_hist_build takes: the [S, F, B] accumulators
// of g (u64), h (u64) and counts (u32), in that order.
long long gbdt_hist_scratch_bytes(int num_slots, int num_features,
                                  int num_bins) {
  return static_cast<long long>(num_slots) *
         gbdt_hist_smem_bytes(num_features, num_bins);
}

int gbdt_hist_max_slots() { return kMaxSlots; }

int gbdt_hist_threads() { return kThreads; }

// The three steps of a pass, each an entry of its own so that a streamed
// pass (tpu_residency=stream, B11) can fold several shards' rows into one
// caller-owned accumulator: gbdt_hist_acc_zero once per wave,
// gbdt_hist_acc_add once per shard, gbdt_hist_acc_finalize once per wave.
// The accumulator is the [S, F, B] integer sums of g (u64), h (u64) and
// counts (u32), in that order (gbdt_hist_scratch_bytes); the sums are
// integers, so any split of the rows gives the same bits as one pass.

// Zeroes the accumulator on `stream`.
int gbdt_hist_acc_zero(void* scratch, int num_slots, int num_features,
                       int num_bins, void* stream_ptr) {
  if (num_slots < 1 || num_features < 1 || num_bins < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemsetAsync(
      scratch, 0, gbdt_hist_scratch_bytes(num_slots, num_features, num_bins),
      static_cast<cudaStream_t>(stream_ptr)));
}

// Adds the slot-grouped positions [0, n_active) of `perm` into the
// accumulator: launches hist_kernel on a (blocks_x, ceil(F /
// group_features)) grid. Position p reads row perm[p] of `codes`
// ([num_rows, F]) and of grad / hess / inc, so a streamed shard passes its
// code buffer, num_rows = its real rows (the padded tail rows of the last
// shard are never read), positions within the shard, and grad / hess /
// inc already offset to the shard's first row. Every size that changes
// from pass to pass is read on the card: n_active from `n_active` (a
// device int64; nullptr: the sum of slot_counts) and the g and h scales
// from `scales` (two device doubles). blocks_x is min(the blocks the SMs
// hold at once, ceil(num_rows / min_rows)) (ops/cuda_histogram.py:
// grid_blocks), the most blocks any pass of the shape uses; hist_kernel
// spreads the pass's own n_active over min(blocks_x, ceil(n_active /
// min_rows)) blocks of equal runs, and the rest exit. code_bytes is 1
// (uint8 codes), 2 (uint16 codes stored as int16: every code below 2^15)
// or 4 (int32 codes, for features of more than 32,768 bins). tile_bins
// cuts each feature's bins into tiles of that width (ceil(num_bins /
// tile_bins) tiles on the grid's y axis beside the feature groups);
// tile_bins == num_bins is the untiled launch.
int gbdt_hist_acc_add(const void* codes, int code_bytes, long long num_rows,
                      int num_features, const float* grad, const float* hess,
                      const float* inc, const int32_t* perm,
                      const int32_t* slot_counts, const int32_t* slot_starts,
                      const long long* n_active, int num_slots, int num_bins,
                      int group_features, int tile_bins, int blocks_x,
                      long long min_rows, const double* scales,
                      void* scratch, void* stream_ptr) {
  if ((code_bytes != 1 && code_bytes != 2 && code_bytes != 4) ||
      num_slots < 1 || num_slots > kMaxSlots || group_features < 1 ||
      group_features > num_features || num_bins < 1 || tile_bins < 1 ||
      tile_bins > num_bins || (tile_bins < num_bins && group_features != 1) ||
      blocks_x < 0 || min_rows < 1 || scales == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks_x == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n =
      static_cast<long long>(num_slots) * num_features * num_bins;
  unsigned long long* acc_g = static_cast<unsigned long long*>(scratch);
  unsigned long long* acc_h = acc_g + n;
  unsigned int* acc_c = reinterpret_cast<unsigned int*>(acc_h + n);
  const int groups = (num_features + group_features - 1) / group_features;
  const int tiles = (num_bins + tile_bins - 1) / tile_bins;
  const dim3 grid(static_cast<unsigned int>(blocks_x),
                  static_cast<unsigned int>(groups * tiles));
  const long long smem = gbdt_hist_smem_bytes(group_features, tile_bins);
  // whole 32-bit words per row and per group start
  const bool aligned =
      reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
      (static_cast<long long>(num_features) * code_bytes) % 4 == 0 &&
      (static_cast<long long>(group_features) * code_bytes) % 4 == 0;
  decltype(&launch<uint8_t, true, false>) fn;
  if (code_bytes == 4) {                 // int32 codes: always whole words
    if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
    fn = tiles == 1 ? launch<uint32_t, true, false>
                    : launch<uint32_t, true, true>;
  } else if (tiles > 1) {                // B > 256: uint16 codes only
    if (code_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
    fn = aligned ? launch<uint16_t, true, true>
                 : launch<uint16_t, false, true>;
  } else if (code_bytes == 1) {
    fn = aligned ? launch<uint8_t, true, false> : launch<uint8_t, false, false>;
  } else {
    fn = aligned ? launch<uint16_t, true, false>
                 : launch<uint16_t, false, false>;
  }
  return static_cast<int>(fn(codes, num_rows, num_features, group_features,
                             tile_bins,
                             grad, hess, inc, perm, slot_counts, slot_starts,
                             n_active, min_rows, num_slots, num_bins, scales,
                             acc_g, acc_h, acc_c, grid, smem, stream));
}

// Converts the accumulator to hist[S, F, B, 3] (f32): launches
// finalize_kernel. `launches` (a device uint64, or nullptr) gains one per
// call, added on the card, so a pass replayed from a CUDA graph is counted
// where it runs: one pass per wave, resident or streamed.
int gbdt_hist_acc_finalize(const void* scratch, int num_slots,
                           int num_features, int num_bins,
                           const double* scales, float* out,
                           unsigned long long* launches, void* stream_ptr) {
  if (num_slots < 1 || num_features < 1 || num_bins < 1 || scales == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n =
      static_cast<long long>(num_slots) * num_features * num_bins;
  const unsigned long long* acc_g =
      static_cast<const unsigned long long*>(scratch);
  const unsigned long long* acc_h = acc_g + n;
  const unsigned int* acc_c = reinterpret_cast<const unsigned int*>(acc_h + n);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  finalize_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream_ptr)>>>(
      acc_g, acc_h, acc_c, n, scales, out, launches);
  return static_cast<int>(cudaGetLastError());
}

// One resident pass: hist[S, F, B, 3] (f32) on `stream` from the
// slot-grouped positions [0, n_active) of `perm` — gbdt_hist_acc_zero on
// `scratch` (gbdt_hist_scratch_bytes), gbdt_hist_acc_add and
// gbdt_hist_acc_finalize (see each). Returns cudaGetLastError() after the
// launches (0 = cudaSuccess), or cudaErrorInvalidValue for arguments the
// kernel does not take.
int gbdt_hist_build(const void* codes, int code_bytes, long long num_rows,
                    int num_features, const float* grad, const float* hess,
                    const float* inc, const int32_t* perm,
                    const int32_t* slot_counts, const int32_t* slot_starts,
                    const long long* n_active, int num_slots, int num_bins,
                    int group_features, int tile_bins, int blocks_x,
                    long long min_rows, const double* scales, void* scratch,
                    float* out, unsigned long long* launches,
                    void* stream_ptr) {
  int err = gbdt_hist_acc_zero(scratch, num_slots, num_features, num_bins,
                               stream_ptr);
  if (err != 0) return err;
  err = gbdt_hist_acc_add(codes, code_bytes, num_rows, num_features, grad,
                          hess, inc, perm, slot_counts, slot_starts,
                          n_active, num_slots, num_bins, group_features,
                          tile_bins, blocks_x, min_rows, scales, scratch,
                          stream_ptr);
  if (err != 0) return err;
  return gbdt_hist_acc_finalize(scratch, num_slots, num_features, num_bins,
                                scales, out, launches, stream_ptr);
}

}  // extern "C"
