// PER sum-tree descent (the replay buffer's stratified sample) for Hopper
// (sm_90a), float64.
//
// Replaces no TPU kernel: the reference samples on the host, one Python
// `SumTree.sample` walk per uniform (src/repro/core/replay.py, `sample`).
// Same function as that loop and as the plain version
// `repro_torch.kernels.sumtree_sample.sumtree_sample_plain`:
//   seg = tree[1] / n,  v = (j + u[j]) * seg,
//   walk from the root: go left while v <= tree[2i], else v -= tree[2i]
//   and go right, until a leaf (i >= cap);  idx[j] = min(i - cap, size - 1).
// Every step is one IEEE float64 operation in the host's order (the
// intrinsics below keep nvcc from contracting them into FMAs), so for the
// same uniforms the indices are the host's, at any capacity (leaves on two
// levels when cap is not a power of two).
//
// What bounds it on this card: each sample reads one node per level (17 at
// cap 100,000) from an 800 KB tree that stays in L2, so the bytes bound is
// a few nanoseconds; a launch and 17 dependent loads per thread are what it
// costs.  Design: one thread per sample, 128 threads per block; no shared
// state, so no barrier.  It replaces the torch-op descent that cost about
// ten small launches per level.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
sumtree_sample_kernel(const double* __restrict__ tree,
                      const double* __restrict__ u, long long* __restrict__ idx,
                      int n, long long cap, long long size) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const double seg = __ddiv_rn(tree[1], static_cast<double>(n));
  double v = __dmul_rn(__dadd_rn(static_cast<double>(j), u[j]), seg);
  long long i = 1;
  while (i < cap) {
    const double left = tree[2 * i];
    if (v <= left) {
      i = 2 * i;
    } else {
      v = __dsub_rn(v, left);
      i = 2 * i + 1;
    }
  }
  const long long leaf = i - cap;
  idx[j] = leaf < size - 1 ? leaf : size - 1;
}

}  // namespace

// Plain C entry point bound with ctypes.  tree: device float64 [2 * cap];
// u: device float64 [n] uniforms in [0, 1); idx: device int64 [n], written.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sumtree_sample(const double* tree, const double* u,
                              long long* idx, int n, long long cap,
                              long long size, void* stream) {
  if (n <= 0) return 0;
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  sumtree_sample_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      tree, u, idx, n, cap, size);
  return static_cast<int>(cudaGetLastError());
}
