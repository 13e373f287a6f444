// Forest walk of scoring rows for Hopper (sm_90a): the walk and the leaf
// sum of Booster.predict's batch route in the PyTorch port.
//
// Replaces no Pallas kernel. The JAX package leaves the walk to XLA (a
// while_loop over the stacked trees, lightgbm_tpu/ops/predict.py:300-346,
// then a gather and a sum over trees); the port walked all trees of a chunk
// together in torch ops (ops/predict.py:forest_walk_leaves, about 15 ops
// over [rows, trees] tensors a tree level, the forest's depth in fixed
// steps) and summed the gathered leaf values with torch.sum: 93% of a
// 500,000-row call of a 500-tree forest on the H100 (PERF.md). This kernel
// does both in one launch.
//
// What it computes, for each row r of a chunk, from the rank encode's
// outputs (csrc/encode.cu) codes (int32), is_nan and is_zero (one byte
// each), all [rows, F] row-major, and the forest's node tables:
//   out[r] = ((0 + v_0) + v_1) + ... + v_{T-1}      in f64, tree order,
//   v_t    = leaf_value[t, leaf_t(r)]
// where leaf_t(r) is found by walking tree t from its root (leaf 0 where
// the tree is a single leaf) until a child index below 0, leaf -child - 1.
// At a node of feature f, threshold rank thr, missing type mt and default
// side dl (NumericalDecision, tree.h:218-243, in rank space):
//   default  = is_zero[r, f]             where mt is 1 (zero)
//            = is_nan[r, f]              where mt is 2 (NaN)
//            = false                     otherwise
//   code     = zero_rank[f] where is_nan[r, f] and mt is not 2, else
//              codes[r, f]               (a NaN is 0.0 there)
//   go left  = dl where default, else code <= thr
// These are forest_walk_leaves' leaves: that walk runs the forest's depth
// in fixed steps and leaves a row at a leaf as it is. The plain version
// (ops/cuda_walk.py:forest_walk_sums_plain) is that walk and a torch.sum,
// which adds in its own order: it and this kernel differ by f64 rounding
// only, and this kernel is bit-equal to a tree-order sum of its leaves.
//
// Bound: at a 65,536-row chunk of 28 features and the higgs.score forest
// (500 trees, 255 leaves), the reads are 11 MB of codes and masks, 1 MB of
// packed records and 1 MB of leaf values, 13.6 MB with the output, about
// 4.1 us at 3.35 TB/s; the work is about 224M comparisons (6.8 a row and
// tree along the rows' own paths) and 33M adds, about 3.8 us at 67 TFLOP/s.
// The kernel is bound instead by the latency of each step's dependent
// loads (node, then the row's word for that node's feature) and by the
// instructions a step issues, not by device memory.
//
// Design:
//   1. One thread per row, 256 rows a block. A thread walks its row
//      through every tree and keeps the row's sum in a register, adding
//      each tree's leaf value as the walk of that tree ends: tree order, no
//      atomics, nothing across blocks, the same result at any launch shape.
//   2. Each tree is walked until the row reaches a leaf (a data-dependent
//      loop), not for the forest's depth.
//   3. The block first stages its rows in shared memory as one 32-bit word
//      per (row, feature): code << 2 | is_zero << 1 | is_nan, the code
//      already replaced by zero_rank for a NaN. Feature-major with the row
//      fastest, so the 32 lanes of a warp read 32 banks whatever features
//      they are at. A node's missing type becomes the mask of the word's
//      bit that sends the row to its default side (2 for zero, 1 for NaN,
//      0 for none), so a step is one node load, one word load, a test, a
//      compare and a select.
//   4. Node tables are packed on the host (ops/cuda_walk.py:pack_nodes)
//      into 8-byte records (feature 13 bits, mask 2, default side 1,
//      threshold rank 16; left and right child 16 bits each, signed) where
//      the forest's ranges allow, else 16-byte ones (feature 29 bits, mask,
//      default side; rank; left; right). The block stages a group of trees'
//      records and f64 leaf values in shared memory, walks them, and loops
//      over groups, so any number of trees works. The group is as large as
//      fits beside the rows in half an SM's shared memory: two blocks an
//      SM, so the 256 blocks of a 65,536-row chunk are all resident on the
//      132 SMs, and one block walks while the other stages (21 trees a
//      group at the higgs.score forest).
//   5. Where the rows and one tree do not fit that half (past about 110
//      features at 255 leaves, or very large trees), the kernel reads the
//      records, leaf values and codes in device memory through the
//      read-only path instead; the arithmetic is the same.
//   6. No host read and no allocation: the wrapper allocates the output
//      and counts the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the shared memory a block may take so that two blocks fit an SM (228 KB
// an SM, 1 KB of it reserved for each block)
constexpr long long kBlockShared = 115712;

struct Split {
  int feature;
  uint32_t mask;       // the row word's bit that takes the default side
  bool default_left;
  int thr;
  int left;
  int right;
};

__device__ __forceinline__ Split unpack(uint2 r) {
  Split s;
  s.feature = static_cast<int>(r.x & 0x1FFFu);
  s.mask = (r.x >> 13) & 3u;
  s.default_left = (r.x >> 15) & 1u;
  s.thr = static_cast<int>(r.x >> 16);
  s.left = static_cast<int16_t>(r.y & 0xFFFFu);
  s.right = static_cast<int16_t>(r.y >> 16);
  return s;
}

__device__ __forceinline__ Split unpack(int4 r) {
  const uint32_t x = static_cast<uint32_t>(r.x);
  Split s;
  s.feature = static_cast<int>(x & 0x1FFFFFFFu);
  s.mask = (x >> 29) & 3u;
  s.default_left = x >> 31;
  s.thr = r.y;
  s.left = r.z;
  s.right = r.w;
  return s;
}

// element e (row-major) of feature f as one word: code << 2 | is_zero << 1
// | is_nan, a NaN's code zero_rank[f]
__device__ __forceinline__ uint32_t row_word(
    const int32_t* __restrict__ codes, const uint8_t* __restrict__ is_nan,
    const uint8_t* __restrict__ is_zero, const int32_t* __restrict__ zero_rank,
    long long e, int f) {
  const uint32_t nan = __ldg(is_nan + e);
  const uint32_t code = static_cast<uint32_t>(
      nan ? __ldg(zero_rank + f) : __ldg(codes + e));
  return (code << 2) | (static_cast<uint32_t>(__ldg(is_zero + e)) << 1) | nan;
}

template <typename Node, bool kShared>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const int32_t* __restrict__ codes,
            const uint8_t* __restrict__ is_nan,
            const uint8_t* __restrict__ is_zero,
            const int32_t* __restrict__ zero_rank, long long num_rows,
            int num_features, const Node* __restrict__ nodes,
            const double* __restrict__ leaf_value,
            const uint8_t* __restrict__ root_is_leaf, int num_trees,
            int num_nodes, int num_leaves, int group,
            double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long left_rows = num_rows - row0;
  const int rows_here = static_cast<int>(
      left_rows < kThreads ? left_rows : kThreads);
  const int tid = threadIdx.x;
  const bool live = tid < rows_here;
  const long long row = row0 + tid;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  const size_t rows_bytes =
      static_cast<size_t>(num_features) * kThreads * sizeof(uint32_t);
  Node* group_nodes = reinterpret_cast<Node*>(smem + rows_bytes);
  double* group_leaves = reinterpret_cast<double*>(
      smem + rows_bytes +
      static_cast<size_t>(group) * num_nodes * sizeof(Node));

  if (kShared) {
    const long long base = row0 * num_features;
    const int count = rows_here * num_features;
    for (int i = tid; i < count; i += kThreads) {
      const int r = i / num_features;
      const int f = i - r * num_features;
      words[f * kThreads + r] =
          row_word(codes, is_nan, is_zero, zero_rank, base + i, f);
    }
  }

  double acc = 0.0;
  for (int t0 = 0; t0 < num_trees; t0 += group) {
    const int count = num_trees - t0 < group ? num_trees - t0 : group;
    if (kShared) {
      __syncthreads();   // the last group's walks (or the rows' staging)
      const long long node0 = static_cast<long long>(t0) * num_nodes;
      for (int i = tid; i < count * num_nodes; i += kThreads)
        group_nodes[i] = nodes[node0 + i];
      const long long leaf0 = static_cast<long long>(t0) * num_leaves;
      for (int i = tid; i < count * num_leaves; i += kThreads)
        group_leaves[i] = __ldg(leaf_value + leaf0 + i);
      __syncthreads();
    }
    if (!live) continue;
    for (int k = 0; k < count; ++k) {
      const int t = t0 + k;
      const Node* tree = kShared
          ? group_nodes + static_cast<long long>(k) * num_nodes
          : nodes + static_cast<long long>(t) * num_nodes;
      int node = __ldg(root_is_leaf + t) ? -1 : 0;
      while (node >= 0) {
        const Split s = unpack(kShared ? tree[node] : __ldg(tree + node));
        const uint32_t w = kShared
            ? words[s.feature * kThreads + tid]
            : row_word(codes, is_nan, is_zero, zero_rank,
                       row * num_features + s.feature, s.feature);
        const bool go_left = (w & s.mask)
            ? s.default_left : static_cast<int>(w >> 2) <= s.thr;
        node = go_left ? s.left : s.right;
      }
      acc += kShared
          ? group_leaves[static_cast<long long>(k) * num_leaves + ~node]
          : __ldg(leaf_value + static_cast<long long>(t) * num_leaves +
                  ~node);
    }
  }
  if (live) out[row] = acc;
}

// The trees a block stages at once and its shared bytes; group 0 where
// the rows and one tree do not fit a block (the device-memory kernel).
void plan(int num_features, int num_nodes, int num_leaves, int record_bytes,
          int num_trees, int* group, long long* smem) {
  const long long rows = static_cast<long long>(num_features) * kThreads * 4;
  const long long tree = static_cast<long long>(num_nodes) * record_bytes +
                         static_cast<long long>(num_leaves) * 8;
  if (rows + tree > kBlockShared) {
    *group = 0;
    *smem = 0;
    return;
  }
  long long g = (kBlockShared - rows) / tree;
  if (g > num_trees) g = num_trees;
  if (g < 1) g = 1;
  *group = static_cast<int>(g);
  *smem = rows + g * tree;
}

template <typename Node, bool kShared>
int launch(const int32_t* codes, const uint8_t* is_nan,
           const uint8_t* is_zero, const int32_t* zero_rank,
           long long num_rows, int num_features, const void* nodes,
           const double* leaf_value, const uint8_t* root_is_leaf,
           int num_trees, int num_nodes, int num_leaves, int group,
           long long smem, double* out, cudaStream_t stream) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(walk_kernel<Node, kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (num_rows + kThreads - 1) / kThreads;
  walk_kernel<Node, kShared><<<static_cast<unsigned>(blocks), kThreads,
                               static_cast<size_t>(smem), stream>>>(
      codes, is_nan, is_zero, zero_rank, num_rows, num_features,
      static_cast<const Node*>(nodes), leaf_value, root_is_leaf, num_trees,
      num_nodes, num_leaves, kShared ? group : num_trees, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The trees the kernel stages in a block's shared memory at once for a
// forest of num_trees trees of num_nodes internal nodes and num_leaves
// leaves (padded) in records of record_words 32-bit words, over rows of
// num_features features; 0 where it walks in device memory instead.
int gbdt_walk_group(int num_features, int num_nodes, int num_leaves,
                    int record_words, int num_trees) {
  int group = 0;
  long long smem = 0;
  plan(num_features, num_nodes, num_leaves, record_words * 4, num_trees,
       &group, &smem);
  return group;
}

// Walks every row of a chunk through every tree and writes its f64 sum of
// leaf values, in tree order, to out [num_rows], on `stream`. codes (int32),
// is_nan and is_zero (one byte each, 0 or 1) are [num_rows, num_features]
// row-major; zero_rank [num_features] int32; nodes [num_trees, num_nodes,
// record_words] int32 records (record_words 2 or 4, ops/cuda_walk.py:
// pack_nodes); leaf_value [num_trees, num_leaves] f64; root_is_leaf
// [num_trees] one byte each. The child indices must lie in [-num_leaves,
// num_nodes) and reach a leaf (the host checks both). Returns the CUDA
// error of the launch (0 on success); nothing is launched for no rows.
int gbdt_forest_walk(const int32_t* codes, const uint8_t* is_nan,
                     const uint8_t* is_zero, const int32_t* zero_rank,
                     long long num_rows, int num_features,
                     const int32_t* nodes, int record_words,
                     const double* leaf_value, const uint8_t* root_is_leaf,
                     int num_trees, int num_nodes, int num_leaves,
                     double* out, void* stream_ptr) {
  if (num_rows < 0 || num_features < 0 || num_trees < 0 || num_nodes < 1 ||
      num_leaves < 1 || (record_words != 2 && record_words != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int group = 0;
  long long smem = 0;
  plan(num_features, num_nodes, num_leaves, record_words * 4, num_trees,
       &group, &smem);
  if (record_words == 2) {
    if (group > 0)
      return launch<uint2, true>(codes, is_nan, is_zero, zero_rank,
                                 num_rows, num_features, nodes, leaf_value,
                                 root_is_leaf, num_trees, num_nodes,
                                 num_leaves, group, smem, out, stream);
    return launch<uint2, false>(codes, is_nan, is_zero, zero_rank, num_rows,
                                num_features, nodes, leaf_value,
                                root_is_leaf, num_trees, num_nodes,
                                num_leaves, group, 0, out, stream);
  }
  if (group > 0)
    return launch<int4, true>(codes, is_nan, is_zero, zero_rank, num_rows,
                              num_features, nodes, leaf_value, root_is_leaf,
                              num_trees, num_nodes, num_leaves, group, smem,
                              out, stream);
  return launch<int4, false>(codes, is_nan, is_zero, zero_rank, num_rows,
                             num_features, nodes, leaf_value, root_is_leaf,
                             num_trees, num_nodes, num_leaves, group, 0, out,
                             stream);
}

}  // extern "C"
