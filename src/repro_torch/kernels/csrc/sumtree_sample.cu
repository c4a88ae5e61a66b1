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
// a few nanoseconds.  A walk that loads one node per level waits for 17
// dependent L2 round trips; that latency, and the launch, are its cost.
//
// Design: one warp per sample, 4 warps a block, and rounds of
// ROUND = 6 levels for one L2 round trip each.  Lane c (5 bits) takes the
// path whose first 5 decisions below node i are c's bits, top bit first:
// those bits fix the path's node on each of the 6 levels (on level r,
// i 2^r + (c >> (5 - r))), so the lane loads the 6 left children it may
// compare with at once, then walks them in registers with the host's
// compare and subtraction.  The lane whose bits are the decisions the walk
// takes (or the lowest of those that share them down to a leaf) holds the
// host's v and node; a ballot finds it and two shuffles hand them to the
// warp.  At cap 100,000 that is 3 dependent round trips (6 + 6 + 5 levels)
// for 17, and the first round's nodes (below the root, the same for every
// sample) are loaded together with the root and the uniform.  Where the
// leaves lie on two levels a round can reach a leaf before its last level:
// each level tests its node against cap first, as the host does, and stops
// there.  The walk has no branch: a level's subtraction runs beside its
// compare and a select keeps one (the host's value on the lane that holds
// the walk), and the leaf tests, on the lane's own nodes, stay off that
// chain.
// Nodes at or past 2 cap (subtrees cut by the leaves) are not read; the
// lane that holds the walk never reaches them.  No shared state, so no
// barrier.
#include <cuda_runtime.h>


namespace {

constexpr int BITS = 5;            // a lane's path bits: 32 paths
constexpr int ROUND = BITS + 1;    // levels walked per round trip
constexpr int WARPS = 4;           // samples (one a warp) per block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

// the left children on lane c's path through the ROUND levels below node
// i: on level r the node is i 2^r + (c >> (BITS - r)); 0 at or past 2 cap
__device__ __forceinline__ void gather(const double* __restrict__ tree,
                                       long long i, long long two_cap,
                                       int lane, double (&left)[ROUND]) {
#pragma unroll
  for (int r = 0; r < ROUND; ++r) {
    const long long node = 2 * ((i << r) + (lane >> (BITS - r)));
    left[r] = node < two_cap ? tree[node] : 0.0;
  }
}

__global__ void __launch_bounds__(THREADS)
sumtree_sample_kernel(const double* __restrict__ tree,
                      const double* __restrict__ u, long long* __restrict__ idx,
                      int n, long long cap, long long size) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= n) return;   // the whole warp: j is the warp's sample
  const long long two_cap = 2 * cap;
  double left[ROUND];
  gather(tree, 1, two_cap, lane, left);
  const double seg = __ddiv_rn(tree[1], static_cast<double>(n));
  double v = __dmul_rn(__dadd_rn(static_cast<double>(j), u[j]), seg);
  long long i = 1;
  while (i < cap) {
    // the walk along this lane's path, without branches: its nodes are
    // fixed by its bits, so the leaf tests stay off the chain of compares,
    // and each level's subtraction runs beside its compare
    double w = v;
    long long at = i;      // the node reached
    bool on_path = true;   // the decisions so far are this lane's bits
    bool inner = true;     // no leaf reached yet
#pragma unroll
    for (int r = 0; r < ROUND; ++r) {
      const long long node = (i << r) + (lane >> (BITS - r));
      inner = inner && node < cap;   // else a leaf of the shallower level
      const bool right = !(w <= left[r]);
      const double rest = __dsub_rn(w, left[r]);
      if (r < BITS)
        on_path = on_path &&
                  (!inner || right == ((lane >> (BITS - 1 - r)) & 1));
      w = inner && right ? rest : w;
      at = inner ? 2 * node + right : at;
    }
    const int src = __ffs(__ballot_sync(FULL, on_path)) - 1;
    v = __shfl_sync(FULL, w, src);
    i = __shfl_sync(FULL, at, src);
    if (i < cap) gather(tree, i, two_cap, lane, left);
  }
  if (lane == 0) {
    const long long leaf = i - cap;
    idx[j] = leaf < size - 1 ? leaf : size - 1;
  }
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
  sumtree_sample_kernel<<<(n + WARPS - 1) / WARPS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      tree, u, idx, n, cap, size);
  return static_cast<int>(cudaGetLastError());
}
