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
// (cap 100,000), so the bytes bound is well under a microsecond.  What a
// launch costs is latency: serial steps, block barriers and global round
// trips that wait on one another.
//
// Design, one block of P threads (P a power of two, 32 <= P <= 1024, >= n):
// (1) Each write gets one key: its leaf aligned to the deepest leaf level,
// leaf << (Lmax - level(leaf)), shifted left by 10 and OR'd with the
// write's position; 32 bits wide where that fits below the sentinel (Lmax
// <= 20, a capacity up to 2^20), else 64.  For a non-power-of-two capacity
// the leaves straddle two levels; with the aligned key the ancestor at
// level l of every leaf is key >> (Lmax - l).  Out-of-range writes get the
// sentinel.
// (2) A bitonic sort of the P keys in registers, unrolled for each P:
// strides below 32 exchange with __shfl_xor_sync, only strides of 32 or
// more go through shared memory with one barrier each (10 of the 45 stages
// at P = 512).
// (3) After the sort, the last key of each run of equal leaves is the write
// that wins (the latest position); the winners are compacted in order (a
// ballot and a warp sum), so m distinct leaves sit at positions 0..m-1.
// (4) Ancestors, deepest level first.  The node of a run of positions at
// level l is owned by the run's first position f; f owns levels above
// L*(f), the deepest level whose ancestor f shares with f - 1, which is
// known from the two keys before the loop starts.  At each level an owner
// adds its child's value (in a register) to the sibling's: an untouched
// sibling never changes during the call, so every owner stages all of its
// untouched siblings into shared memory with cp.async before the loop, and
// their latency is paid once; a touched right sibling is the run that
// starts at e + 1 (e the end of the owner's run), whose owner stops owning
// at this level and leaves its value and end in shared memory.  So a level
// is one barrier and a few shared-memory reads, and nothing is read back
// from the tree.  Nodes 1..63 (cap >= 64) are finished by one warp with
// shuffles from level 5 up.  Each node is written once, by one thread, from
// final children; no atomics.  Larger writes are split by the wrapper into
// launches of 1024 in order, which keeps last-write-wins.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_N = 1024;
constexpr int POS_BITS = 10;           // log2(MAX_N): the position in a key
constexpr int TOP = 5;                 // one warp finishes levels < TOP
constexpr int WMAX = 12;               // levels of siblings staged in smem

__device__ __forceinline__ int bit_length(uint32_t x) { return 32 - __clz(x); }
__device__ __forceinline__ int bit_length(uint64_t x) {
  return 64 - __clzll(static_cast<long long>(x));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory, carved from the dynamic allocation (P threads, nwin
// staged levels): values [P], run values [P], top values [32], the top
// levels' old values [TOP + 1][32], one region used first for the sort's
// exchange [2][P] keys and then for the siblings [nwin][P]; then the keys
// [P], run ends [P], warp counts [32] and top flags [32].
size_t smem_bytes(int p, int nwin, size_t key_bytes) {
  const int big = 2 > nwin ? 2 : nwin;
  return 8 * (2 * static_cast<size_t>(p) + 32 + (TOP + 1) * 32 +
              static_cast<size_t>(big) * p) +
         key_bytes * p + 4 * (static_cast<size_t>(p) + 64);
}

template <typename K, int LOGP>
__global__ void __launch_bounds__(1 << LOGP)
sumtree_set_many_kernel(double* tree, const long long* __restrict__ idx,
                        const double* __restrict__ values, double scalar,
                        int n, long long cap, int lmax, int stop, int lo_w) {
  constexpr int P = 1 << LOGP;
  constexpr K SENTINEL = ~K(0);
  extern __shared__ __align__(16) double smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double* s_val = smem;
  double* s_runv = s_val + P;
  double* s_topv = s_runv + P;
  double* s_old = s_topv + 32;                  // [TOP + 1][32]
  double* s_big = s_old + (TOP + 1) * 32;
  const int nbig = lmax - lo_w > 2 ? lmax - lo_w : 2;
  K* s_key = reinterpret_cast<K*>(s_big + nbig * P);
  int* s_rune = reinterpret_cast<int*>(s_key + P);
  int* s_cnt = s_rune + P;
  int* s_topf = s_cnt + 32;
  K* s_xch = reinterpret_cast<K*>(s_big);      // [2][P], during the sort
  const K kcap = static_cast<K>(cap);

  // (1) keys; the values and, for the top warp, the old top nodes staged
  K key = SENTINEL;
  if (t < n) {
    const long long x = idx[t];
    if (x >= 0 && x < cap) {
      const K leaf = static_cast<K>(x) + kcap;
      key = ((leaf << (lmax + 1 - bit_length(leaf))) << POS_BITS) |
            static_cast<K>(t);
    }
    if (values != nullptr) s_val[t] = values[t];
  }
  if (stop == TOP && warp == 0) {
#pragma unroll
    for (int l = 0; l <= TOP; ++l)
      if (lane < (1 << l)) cp_async8(&s_old[l * 32 + lane],
                                     tree + (1 << l) + lane);
    s_topf[lane] = 0;
  }

  // (2) bitonic sort, ascending
  int buf = 0;
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      K other;
      if (j >= 32) {
        s_xch[buf * P + t] = key;
        __syncthreads();
        other = s_xch[buf * P + (t ^ j)];
        buf ^= 1;
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool take_min = ((t & k) == 0) == ((t & j) == 0);
      key = take_min ? (other < key ? other : key)
                     : (other > key ? other : key);
    }
  }

  // (3) the last of each run of equal leaves wins; compact the winners
  s_xch[buf * P + t] = key;
  __syncthreads();
  const K next = t + 1 < P ? s_xch[buf * P + t + 1] : SENTINEL;
  const K c0 = key >> POS_BITS;   // the aligned leaf key
  const bool win = key != SENTINEL && (next >> POS_BITS) != c0;
  const unsigned ballot = __ballot_sync(0xffffffffu, win);
  if (lane == 0) s_cnt[warp] = __popc(ballot);
  __syncthreads();
  const unsigned cw = lane < (P >> 5) ? s_cnt[lane] : 0u;
  const int m = static_cast<int>(__reduce_add_sync(0xffffffffu, cw));
  const int f = static_cast<int>(__reduce_add_sync(
                    0xffffffffu, lane < warp ? cw : 0u)) +
                __popc(ballot & ((1u << lane) - 1u));
  if (win) s_key[f] = c0;
  __syncthreads();

  // (4) the winner at f writes its leaf, finds L* and stages its siblings
  int lstar = -1, e = f;
  double v = 0.0;
  if (win) {
    if (f > 0) lstar = lmax - bit_length(static_cast<K>(s_key[f - 1] ^ c0));
    v = values != nullptr ? s_val[key & (MAX_N - 1)] : scalar;
    tree[c0 >= 2 * kcap ? c0 >> 1 : c0] = v;
    for (int l = (lo_w > lstar + 1 ? lo_w : lstar + 1); l < lmax; ++l) {
      const int sh = lmax - l;
      if ((c0 >> sh) >= kcap) continue;   // a shallow leaf, not a node
      cp_async8(&s_big[(l - lo_w) * P + f], tree + ((c0 >> (sh - 1)) ^ 1));
    }
  }
  cp_async_wait_all();

  for (int l = lmax - 1; l >= stop; --l) {
    if (win && l == lstar) {   // this run becomes the right child's
      s_runv[f] = v;
      s_rune[f] = e;
    }
    __syncthreads();
    if (win && l > lstar) {
      const int sh = lmax - l;
      const K a = c0 >> sh;
      if (a < kcap) {
        const K c = c0 >> (sh - 1);
        // the sibling, staged or (above the staged levels) loaded, and the
        // run that starts at e + 1, read together
        const int nx = e + 1 < P ? e + 1 : e;
        const double sib = l >= lo_w ? s_big[(l - lo_w) * P + f]
                                     : tree[c ^ 1];
        const K kn = s_key[nx];
        const double rv = s_runv[nx];
        const int re = s_rune[nx];
        if (c & 1) {
          v = sib + v;
        } else if (e + 1 < m && (kn >> sh) == a) {
          v = v + rv;
          e = re;
        } else {
          v = v + sib;
        }
        tree[a] = v;
      }
    }
  }

  // (5) nodes 1..31 from the 32 nodes of level TOP, by warp 0
  if (stop == TOP) {
    if (win && lstar < TOP) {
      const int a = static_cast<int>(c0 >> (lmax - TOP)) - 32;
      s_topv[a] = v;
      s_topf[a] = 1;
    }
    __syncthreads();
    if (warp == 0) {
      int touched = s_topf[lane];
      double x = touched ? s_topv[lane] : s_old[TOP * 32 + lane];
#pragma unroll
      for (int l = TOP - 1; l >= 0; --l) {
        const int lo = (2 * lane) & 31, hi = (2 * lane + 1) & 31;
        const double xl = __shfl_sync(0xffffffffu, x, lo);
        const double xr = __shfl_sync(0xffffffffu, x, hi);
        const int tl = __shfl_sync(0xffffffffu, touched, lo);
        const int tr = __shfl_sync(0xffffffffu, touched, hi);
        if (lane < (1 << l)) {
          touched = tl | tr;
          x = touched ? xl + xr : s_old[l * 32 + lane];
          if (touched) tree[(1 << l) + lane] = x;
        }
      }
    }
  }
}

template <typename K, int LOGP>
cudaError_t launch(double* tree, const long long* idx, const double* values,
                   double scalar, int n, long long cap, int lmax, int stop,
                   int lo_w, cudaStream_t st) {
  static bool attr = false;   // the largest launch's shared memory, once
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        sumtree_set_many_kernel<K, LOGP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(1 << LOGP, WMAX, sizeof(K))));
    if (err != cudaSuccess) return err;
    attr = true;
  }
  sumtree_set_many_kernel<K, LOGP>
      <<<1, 1 << LOGP, smem_bytes(1 << LOGP, lmax - lo_w, sizeof(K)), st>>>(
          tree, idx, values, scalar, n, cap, lmax, stop, lo_w);
  return cudaGetLastError();
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
  if (n > MAX_N || cap < 1 || cap > (1LL << 52))
    return static_cast<int>(cudaErrorInvalidValue);
  int lmax = 0;
  for (long long x = 2 * cap - 1; x > 1; x >>= 1) ++lmax;
  const int stop = cap >= 64 ? TOP : 0;
  const int lo_w = lmax - WMAX > stop ? lmax - WMAX : stop;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lmax + 1 + POS_BITS > 31)   // 64-bit keys (and no sentinel clash)
    return static_cast<int>(launch<uint64_t, 10>(tree, idx, values, scalar, n,
                                                 cap, lmax, stop, lo_w, st));
  int logp = 5;
  while ((1 << logp) < n) ++logp;
  cudaError_t err;
  switch (logp) {
#define SUMTREE_CASE(L)                                                     \
  case L:                                                                   \
    err = launch<uint32_t, L>(tree, idx, values, scalar, n, cap, lmax, stop, \
                              lo_w, st);                                    \
    break;
    SUMTREE_CASE(5) SUMTREE_CASE(6) SUMTREE_CASE(7) SUMTREE_CASE(8)
    SUMTREE_CASE(9) default : SUMTREE_CASE(10)
#undef SUMTREE_CASE
  }
  return static_cast<int>(err);
}
