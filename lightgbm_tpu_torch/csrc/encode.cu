// Rank encode of raw scoring rows for Hopper (sm_90a): the device half of
// Booster.predict's batch route in the PyTorch port.
//
// Replaces no TPU kernel. The JAX package rank-encodes on the host
// (lightgbm_tpu/ops/predict.py:StackedForest.encode_rows) and so did the
// port, one numpy searchsorted per feature per 65,536-row chunk: about
// three quarters of a 500,000-row call with a 500-tree forest while the
// card sat idle (PERF.md). This kernel writes what the host wrote, on the
// card, from the chunk's raw f64 rows.
//
// What it computes, for each element (r, f) of a raw [n, F] f64 chunk v
// and the forest's sorted threshold grid g_f of feature f (the per-feature
// grids concatenated, segment f at [offsets[f], offsets[f + 1])):
//   code    = #{t in g_f : t < v}   (numpy's searchsorted(side="left"),
//                                     compared in f64: ties, +-inf and
//                                     -0.0 behave as numpy's)
//           = len(g_f) where v is NaN (numpy sorts NaN last)
//           = 0 where g_f is empty
//   is_nan  = v is NaN
//   is_zero = is_nan | (|v| <= zero_range)  (kZeroAsMissingValueRange)
// The outputs are bit-equal to StackedForest._encode_loop's codes and to
// encode_rows' masks. The plain version (ops/cuda_encode.py:
// encode_rows_plain) runs the same lower-bound search as fixed halving
// steps over gathers.
//
// Bound: every element is read once (8 bytes) and written once (4 + 1 + 1
// bytes). At a 65,536-row chunk of 28 features that is 1,835,008 x 14 =
// 25.7 MB, 7.7 us at 3.35 TB/s. The search adds about log2(len(g_f))
// compares an element, far below any operation bound.
//
// Design:
//   1. One thread per (row, feature) element, neighbouring threads on
//      neighbouring elements of the row-major chunk, so the 8-byte reads
//      and the 4- and 1-byte writes of a warp coalesce. A grid-stride loop
//      over a grid the SMs hold at once.
//   2. Each thread runs a lower-bound binary search over its feature's
//      segment: while the remaining length is above 0, compare the middle
//      threshold with v and keep the half that holds the first threshold
//      not below v.
//   3. The grids live in shared memory where they fit a block (kShared):
//      each block copies the whole concatenation once, then searches it
//      for every element it takes. The higgs.score forest holds at most
//      28 x 999 quantile levels, about 220 KB of the 227 KB a block may
//      use, so one block of 1024 threads runs on each SM. Larger grids are
//      searched in device memory through the read-only path, where a few
//      hundred KB stay resident in the 50 MB L2.
//   4. No host read and no allocation: the wrapper allocates the three
//      outputs and counts the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
// the most dynamic shared memory a block may opt into on Hopper
constexpr long long kMaxSharedBytes = 232448;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const double* __restrict__ X, long long num_elems,
              int num_features, const double* __restrict__ grids,
              long long grid_total, const long long* __restrict__ offsets,
              double zero_range, int32_t* __restrict__ codes,
              uint8_t* __restrict__ is_nan, uint8_t* __restrict__ is_zero) {
  extern __shared__ double shared_grid[];
  if (kShared) {
    for (long long i = threadIdx.x; i < grid_total; i += blockDim.x)
      shared_grid[i] = __ldg(grids + i);
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < num_elems; e += stride) {
    const double v = X[e];
    const int f = static_cast<int>(e % num_features);
    const long long start = __ldg(offsets + f);
    int len = static_cast<int>(__ldg(offsets + f + 1) - start);
    const bool nan = isnan(v);
    int lo = 0;
    if (nan) {
      lo = len;
    } else {
      while (len > 0) {
        const int half = len >> 1;
        const long long at = start + lo + half;
        const double t = kShared ? shared_grid[at] : __ldg(grids + at);
        if (t < v) {
          lo += half + 1;
          len -= half + 1;
        } else {
          len = half;
        }
      }
    }
    codes[e] = lo;
    is_nan[e] = nan;
    is_zero[e] = nan || fabs(v) <= zero_range;
  }
}

template <bool kShared>
int launch(const double* X, long long num_elems, int num_features,
           const double* grids, long long grid_total,
           const long long* offsets, double zero_range, int32_t* codes,
           uint8_t* is_nan, uint8_t* is_zero, cudaStream_t stream) {
  const size_t smem = kShared ? grid_total * sizeof(double) : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(encode_kernel<kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, encode_kernel<kShared>, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long needed = (num_elems + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  encode_kernel<kShared><<<blocks, kThreads, smem, stream>>>(
      X, num_elems, num_features, grids, grid_total, offsets, zero_range,
      codes, is_nan, is_zero);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest concatenated grid, in bytes, that the kernel keeps in shared
// memory; larger grids are searched in device memory.
long long gbdt_encode_max_shared_bytes() { return kMaxSharedBytes; }

// Encodes the row-major [num_rows, num_features] f64 chunk X into codes
// (int32), is_nan and is_zero (one byte each, 0 or 1), all [num_rows,
// num_features] row-major, on `stream`. grids holds the grid_total
// thresholds of every feature, feature f's sorted at [offsets[f],
// offsets[f + 1]) (offsets: num_features + 1 int64); they are searched in
// shared memory where grid_total * 8 bytes fit
// gbdt_encode_max_shared_bytes(), else in device memory. Returns the CUDA
// error of the launch (0 on success); nothing is launched for an empty
// chunk.
int gbdt_encode_rows(const double* X, long long num_rows, int num_features,
                     const double* grids, long long grid_total,
                     const long long* offsets, double zero_range,
                     int32_t* codes, uint8_t* is_nan, uint8_t* is_zero,
                     void* stream_ptr) {
  if (num_rows < 0 || num_features < 1 || grid_total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long num_elems = num_rows * num_features;
  if (num_elems == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (grid_total * static_cast<long long>(sizeof(double)) <= kMaxSharedBytes)
    return launch<true>(X, num_elems, num_features, grids, grid_total,
                        offsets, zero_range, codes, is_nan, is_zero, stream);
  return launch<false>(X, num_elems, num_features, grids, grid_total,
                       offsets, zero_range, codes, is_nan, is_zero, stream);
}

}  // extern "C"
