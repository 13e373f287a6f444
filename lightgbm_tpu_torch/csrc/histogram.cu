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
// One kernel serves both passes of the grower:
//   - full pass (perm == nullptr): rows 0..n_work-1, slot
//     slot_of_leaf[leaf_id[r]], rows with slot < 0 skipped;
//   - compacted pass (perm != nullptr): positions 0..n_work-1 are
//     slot-grouped by slot_counts; the slot of position p is the first s
//     with p < cumsum(slot_counts)[s] and its row is
//     perm[p - cum_before[s] + slot_starts[s]] (slot_starts == nullptr:
//     base 0). Each block loads its own row indices; there is no packed-row
//     gather buffer.
//
// Design: grid (row blocks, F). A block owns one feature and one range of
// rows and accumulates a shared-memory sub-histogram [S, B] of 64-bit g, 64-bit
// h and 32-bit counts (S*B*20 bytes: 128,000 at S=25, B=256, hence the
// dynamic shared memory opt-in above 48 KB). At the end the block adds its
// non-zero bins into the global [S, F, B] integer accumulators, and a
// second launch converts them into the [S, F, B, 3] f32 output. One pass
// is three operations on the stream: a memset of the accumulators,
// hist_kernel and finalize_kernel.
//
// Malformed input (a bin code >= B, a full-pass slot >= S, a compacted
// position past the last segment) is not added and fails a device assert
// at the end of the thread's rows, as PyTorch's own index kernels assert:
// it is reported at the next synchronisation as a device-side assert,
// never silently dropped. The plain version raises on the same inputs.
//
// Determinism: g and h are added as 64-bit fixed-point integers,
// q = __double2ll_rn(x * scale), with one power-of-two scale per tree
// chosen by the wrapper so that n_rows * max|x| * scale < 2^62. Integer
// addition is associative, so the order in which atomics land does not
// change a bit of the result: training is bit-identical run to run. Error
// bound per bin against the exact f64 sum: |rows_in_bin| / (2 * scale) from
// the rounding of each q, plus half an f32 ulp from the final conversion.
// The plain version in ops/histogram.py does the same arithmetic, so the
// two agree bit for bit.
//
// Bound at the slice's shapes (N = 2M rows, F = 28, S = 25, B = 256): the
// full pass must read N*F bytes of codes plus N*16 bytes of g/h/inc/leaf id
// once, about 88 MB, i.e. about 26 us at 3.35 TB/s; the output is 2 MB. The
// design is memory-bound in principle but does not reach that bound: each
// block re-reads g/h/inc/leaf id for its feature (F times in all, mostly
// from L2) and reads its feature's code bytes at a stride of F. Its shared
// memory atomics and the flush of S*B bins per block are the other costs.
// Making it fast (TMA loads of row tiles, several features per block, a
// warp-private sub-histogram) is later work.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 64;
constexpr int kThreads = 1024;

// 1024 threads a block: __launch_bounds__ holds the kernel to 64 registers
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ codes,
            int num_features,
            const float* __restrict__ grad,
            const float* __restrict__ hess,
            const float* __restrict__ inc,
            const int32_t* __restrict__ leaf_id,
            const int32_t* __restrict__ slot_of_leaf,
            const int32_t* __restrict__ perm,
            const int32_t* __restrict__ slot_counts,
            const int32_t* __restrict__ slot_starts,
            long long n_work, long long rows_per_block,
            int num_slots, int num_bins,
            double scale_g, double scale_h,
            unsigned long long* __restrict__ acc_g,
            unsigned long long* __restrict__ acc_h,
            unsigned int* __restrict__ acc_c) {
  extern __shared__ unsigned long long smem[];
  const int SB = num_slots * num_bins;
  unsigned long long* sg = smem;
  unsigned long long* sh = smem + SB;
  unsigned int* sc = reinterpret_cast<unsigned int*>(smem + 2 * SB);
  __shared__ long long s_cum[kMaxSlots];
  __shared__ long long s_base[kMaxSlots];

  const int f = blockIdx.y;
  for (int i = threadIdx.x; i < SB; i += blockDim.x) {
    sg[i] = 0ull;
    sh[i] = 0ull;
    sc[i] = 0u;
  }
  if (perm != nullptr && threadIdx.x == 0) {
    long long cum = 0;
    for (int s = 0; s < num_slots; ++s) {
      const long long before = cum;
      cum += slot_counts[s];
      s_cum[s] = cum;
      s_base[s] = (slot_starts != nullptr ? slot_starts[s] : 0) - before;
    }
  }
  __syncthreads();

  const long long start = static_cast<long long>(blockIdx.x) * rows_per_block;
  long long end = start + rows_per_block;
  if (end > n_work) end = n_work;
  // set by malformed input; such a row is not added, and the thread fails
  // the assert after the loop (an assert inside it costs a stack frame)
  bool bad = false;
  for (long long p = start + threadIdx.x; p < end; p += blockDim.x) {
    long long row;
    int slot;
    if (perm != nullptr) {
      slot = 0;
      while (slot < num_slots - 1 && p >= s_cum[slot]) ++slot;
      if (p >= s_cum[num_slots - 1]) {  // n_active > sum(slot_counts)
        bad = true;
        continue;
      }
      row = perm[p + s_base[slot]];
    } else {
      row = p;
      slot = slot_of_leaf[leaf_id[row]];
      if (slot < 0) continue;
      if (slot >= num_slots) {
        bad = true;
        continue;
      }
    }
    const int code = codes[row * num_features + f];
    if (code >= num_bins) {
      bad = true;
      continue;
    }
    const int bin = slot * num_bins + code;
    const long long qg = __double2ll_rn(static_cast<double>(grad[row]) * scale_g);
    const long long qh = __double2ll_rn(static_cast<double>(hess[row]) * scale_h);
    atomicAdd(&sg[bin], static_cast<unsigned long long>(qg));
    atomicAdd(&sh[bin], static_cast<unsigned long long>(qh));
    if (inc[row] != 0.0f) atomicAdd(&sc[bin], 1u);
  }
  assert(!bad);
  __syncthreads();

  for (int i = threadIdx.x; i < SB; i += blockDim.x) {
    const int s = i / num_bins;
    const int b = i - s * num_bins;
    const long long o =
        (static_cast<long long>(s) * num_features + f) * num_bins + b;
    if (sg[i] != 0ull) atomicAdd(&acc_g[o], sg[i]);
    if (sh[i] != 0ull) atomicAdd(&acc_h[o], sh[i]);
    if (sc[i] != 0u) atomicAdd(&acc_c[o], sc[i]);
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ acc_g,
                                const unsigned long long* __restrict__ acc_h,
                                const unsigned int* __restrict__ acc_c,
                                long long n, double inv_g, double inv_h,
                                float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double g = static_cast<double>(static_cast<long long>(acc_g[i])) * inv_g;
  const double h = static_cast<double>(static_cast<long long>(acc_h[i])) * inv_h;
  out[3 * i + 0] = static_cast<float>(g);
  out[3 * i + 1] = static_cast<float>(h);
  out[3 * i + 2] = static_cast<float>(acc_c[i]);
}

}  // namespace

extern "C" {

// Shared memory bytes one block needs for S slots and B bins.
long long gbdt_hist_smem_bytes(int num_slots, int num_bins) {
  return static_cast<long long>(num_slots) * num_bins *
         (2 * sizeof(unsigned long long) + sizeof(unsigned int));
}

// Bytes of the scratch gbdt_hist_build takes: the [S, F, B] accumulators
// of g (u64), h (u64) and counts (u32), in that order.
long long gbdt_hist_scratch_bytes(int num_slots, int num_features,
                                  int num_bins) {
  return static_cast<long long>(num_features) *
         gbdt_hist_smem_bytes(num_slots, num_bins);
}

int gbdt_hist_max_slots() { return kMaxSlots; }

// Builds hist[S, F, B, 3] (f32) on `stream`: zeroes `scratch`
// (gbdt_hist_scratch_bytes), then launches hist_kernel and finalize_kernel.
// Returns cudaGetLastError() after the launches (0 = cudaSuccess).
int gbdt_hist_build(const uint8_t* codes, int num_features,
                    const float* grad, const float* hess, const float* inc,
                    const int32_t* leaf_id, const int32_t* slot_of_leaf,
                    const int32_t* perm, const int32_t* slot_counts,
                    const int32_t* slot_starts, long long n_work,
                    int num_slots, int num_bins, double scale_g,
                    double scale_h, void* scratch, float* out,
                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long smem = gbdt_hist_smem_bytes(num_slots, num_bins);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(num_slots) * num_features * num_bins;
  unsigned long long* acc_g = static_cast<unsigned long long*>(scratch);
  unsigned long long* acc_h = acc_g + n;
  unsigned int* acc_c = reinterpret_cast<unsigned int*>(acc_h + n);
  err = cudaMemsetAsync(scratch, 0,
                        gbdt_hist_scratch_bytes(num_slots, num_features,
                                                num_bins), stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // about two resident waves of blocks (one block per SM at this shared
  // memory size), with at least 4096 rows per block
  long long blocks_x = (2LL * sms + num_features - 1) / num_features;
  const long long by_rows = (n_work + 4095) / 4096;
  if (blocks_x > by_rows) blocks_x = by_rows;
  if (blocks_x < 1) blocks_x = 1;
  const long long rows_per_block = (n_work + blocks_x - 1) / blocks_x;

  if (n_work > 0) {
    dim3 grid(static_cast<unsigned int>(blocks_x),
              static_cast<unsigned int>(num_features));
    hist_kernel<<<grid, kThreads, smem, stream>>>(
        codes, num_features, grad, hess, inc, leaf_id, slot_of_leaf, perm,
        slot_counts, slot_starts, n_work, rows_per_block, num_slots,
        num_bins, scale_g, scale_h, acc_g, acc_h, acc_c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  finalize_kernel<<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
      acc_g, acc_h, acc_c, n, 1.0 / scale_g, 1.0 / scale_h, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
