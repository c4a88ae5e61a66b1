// PER sum-tree multi-leaf set for Hopper (sm_90a), float64, in place.
//
// Replaces: src/repro/kernels/sumtree.py, `_set_many_kernel` (pallas_call in
// `sumtree_set_many_pallas`).  Same function as the host float64 oracle
// `SumTree.set_many` (repro_torch/core/replay.py) and the plain version
// `repro_torch.kernels.sumtree.sumtree_set_many_plain`:
//   tree[cap + idx[j]] = values[j]   (or the scalar), last write wins
//   tree[i] = tree[2i] + tree[2i+1]  for every ancestor i of a written leaf,
//                                     after both children are final.
// The tree is [2 * cap] doubles, root at 1, leaves at [cap, 2 * cap).  Each
// node is the float64 sum of its two final children, so the result is
// bitwise the host's.  Indices outside [0, cap) are skipped: the wrapper
// does not range-check a CUDA index tensor, which would synchronise.
//
// What bounds it on this card: the work is a few hundred leaves and their
// ~17 levels of ancestors, a few tens of KB touched in an 800 KB tree
// (cap 100,000), so the bytes bound is well under a microsecond; a launch
// and the dependent levels, each waiting for the one below, are what it
// costs.
//
// Design, and what it does about that: one block takes up to 1024 writes.
// (1) A write survives only if no later position holds the same index (a
// quadratic scan over the indices staged in shared memory), so duplicates
// are last-write-wins without a race.  (2) Each surviving leaf gets a key
// aligned to the deepest leaf level, leaf << (Lmax - level(leaf)): for a
// non-power-of-two capacity the leaves straddle two levels, and with this
// key the ancestor at level l of every leaf is key >> (Lmax - l), so after
// one bitonic sort of the keys in shared memory equal ancestors are
// neighbours at every level.  (3) Levels are rebuilt deepest first with a
// barrier between them; at each level the first thread of a run of equal
// ancestors recomputes that node, so every node is written once, by one
// thread, from children that are final.  Larger writes are split by the
// wrapper into launches of 1024 in order, which keeps last-write-wins.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int MAX_N = 1024;
constexpr long long SENTINEL = LLONG_MAX;

__device__ __forceinline__ int level_of(long long x) {  // x >= 1
  return 63 - __clzll(x);
}

__global__ void __launch_bounds__(MAX_N)
sumtree_set_many_kernel(double* tree, const long long* __restrict__ idx,
                        const double* __restrict__ values, double scalar,
                        int n, long long cap, int p, int lmax) {
  __shared__ long long s_idx[MAX_N];
  __shared__ long long s_key[MAX_N];
  const int t = threadIdx.x;
  for (int j = t; j < n; j += blockDim.x) s_idx[j] = idx[j];
  __syncthreads();

  // (1) leaves: last write wins
  for (int j = t; j < p; j += blockDim.x) {
    long long key = SENTINEL;
    if (j < n) {
      const long long v = s_idx[j];
      bool last = v >= 0 && v < cap;
      for (int k = j + 1; last && k < n; ++k) last = s_idx[k] != v;
      if (last) {
        const long long leaf = v + cap;
        tree[leaf] = values != nullptr ? values[j] : scalar;
        key = leaf << (lmax - level_of(leaf));
      }
    }
    s_key[j] = key;
  }
  __syncthreads();

  // (2) bitonic sort of the p (a power of two) keys, ascending
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < p; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const long long a = s_key[i], b = s_key[ixj];
          if (((i & k) == 0) ? (a > b) : (a < b)) {
            s_key[i] = b;
            s_key[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // (3) ancestors, deepest level first
  for (int l = lmax - 1; l >= 0; --l) {
    const int shift = lmax - l;
    for (int i = t; i < p; i += blockDim.x) {
      const long long key = s_key[i];
      if (key == SENTINEL) continue;
      const long long a = key >> shift;
      if (a >= cap) continue;  // a shallow leaf itself, not an inner node
      if (i > 0 && (s_key[i - 1] >> shift) == a) continue;
      tree[a] = tree[2 * a] + tree[2 * a + 1];
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point bound with ctypes.  tree: device float64 [2 * cap];
// idx: device int64 [n], 1 <= n <= 1024; values: device float64 [n], or
// null to write `scalar` to every leaf.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int sumtree_set_many(double* tree, const long long* idx,
                                const double* values, double scalar, int n,
                                long long cap, void* stream) {
  if (n <= 0) return 0;
  if (n > MAX_N || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  int p = 1;
  while (p < n) p <<= 1;
  int lmax = 0;
  for (long long x = 2 * cap - 1; x > 1; x >>= 1) ++lmax;
  const int threads = p < 32 ? 32 : p;
  sumtree_set_many_kernel<<<1, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      tree, idx, values, scalar, n, cap, p, lmax);
  return static_cast<int>(cudaGetLastError());
}
