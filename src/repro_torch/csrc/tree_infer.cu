// Decision-tree policy inference: one thread per UE row walks the tree.
//
// Replaces: src/repro/kernels/tree_infer/tree_infer.py::tree_infer_2d (Pallas TPU
// kernel _tree_kernel), reached through ops.py::tree_infer from
// core/closed_loop.py::policy_infer.
//
// The TPU kernel rewrites the complete binary tree as dense algebra (X @ T one-hot
// gather, threshold compare, leaf-count matmuls) because pointer chasing starves its
// vector units.  On the H100 a walk is the natural form: each thread reads
// x[row, feature[node]] for `depth` levels straight from the level-order tables
// (children of n are 2n+1 / 2n+2, go right if x > threshold) and writes the leaf
// value.  It needs no packed operands, is exact, and cannot meet the TF32 hazard of
// a one-hot matmul (which would round KPMs to a 10-bit mantissa).  It follows the
// literal walk tree_infer_ref, the repository's oracle.  One difference from the
// dense TPU form: for an infinite feature the dense form's inf * 0 turns every
// projection into NaN and goes all-left; the walk compares the feature itself.
//
// What bounds it on the H100: launch latency.  Reading a (U, F) float32 matrix and
// writing U leaf values is a few kilobytes for the paper's 10 KPMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 128;

__global__ void __launch_bounds__(TPB)
tree_infer_kernel(const float* __restrict__ x, const int32_t* __restrict__ feature,
                  const float* __restrict__ threshold,
                  const float* __restrict__ leaf_values, float* __restrict__ out,
                  int rows, int n_features, int depth) {
  const int r = blockIdx.x * TPB + threadIdx.x;
  if (r >= rows) return;
  const float* xr = x + (size_t)r * n_features;
  int node = 0;
  for (int level = 0; level < depth; ++level) {
    const bool right = xr[feature[node]] > threshold[node];
    node = 2 * node + 1 + (right ? 1 : 0);
  }
  out[r] = leaf_values[node - ((1 << depth) - 1)];
}

}  // namespace

extern "C" int tree_infer_launch(const void* x, const void* feature,
                                 const void* threshold, const void* leaf_values,
                                 void* out, int rows, int n_features, int depth,
                                 void* stream) {
  const int blocks = (rows + TPB - 1) / TPB;
  tree_infer_kernel<<<blocks > 0 ? blocks : 1, TPB, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(feature),
      static_cast<const float*>(threshold), static_cast<const float*>(leaf_values),
      static_cast<float*>(out), rows, n_features, depth);
  return static_cast<int>(cudaGetLastError());
}
