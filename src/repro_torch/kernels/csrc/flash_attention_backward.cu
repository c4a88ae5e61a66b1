// The gradient of blocked online-softmax attention (GQA, causal, sliding
// window) for Hopper (sm_90a) on the tensor cores: dq, dk and dv of the
// forward kernel in flash_attention.cu, one design for fp16 and bf16
// (mma.sync.m16n8k16, `tc::`), the same for fp32 on 3xTF32
// (mma.sync.m16n8k8, `tf32::`), with the forward's device helpers
// (attention_mma.cuh).
//
// Replaces no TPU kernel: the JAX package differentiates its jnp attention
// with XLA (under jax.checkpoint).  This kernel computes the same gradients
// as autograd over the plain version
// `repro_torch.kernels.flash_attention.flash_attention_plain`, so that LM
// training on the card runs its attention layers through kernels both ways.
//
// The function.  With s = scale q.k over the visible (query, key) pairs,
// P = softmax(s) per query row (masked scores -1e30, so P is 0 there; keys
// at or past Sk take no part), o = P v, and the forward's base-2 log-sum-exp
// lse[i] = m_i + log2(l_i) (m the row's largest score times log2 e, l the
// sum of 2^(s log2 e - m)):
//   P_ij  = 2^(s_ij log2 e - lse_i)
//   D_i   = sum_c dO_ic o_ic
//   dV_j  = sum_i P_ij dO_i         dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i  = scale sum_j dS_ij k_j   dK_j  = scale sum_i dS_ij q_i
// summed over the query heads h of a KV head (h * Hk / H).  A query row
// whose keys are all masked (a window, and Sq > Sk + window - 1 for the
// row) averages every key at -1e30 in the forward; its lse loses the log2
// of the count (-1e30 + 10 is -1e30 in fp32), so this kernel knows such a
// row by its index: P = 1 / Sk on every key, dS = 0 (its scores are
// constants).
//
// Design: three launches and no atomics, so two identical calls give the
// same bits.
//   1. D = rowsum(dO o), one warp a row.
//   2. dK, dV: one block of 4 warps per (b, KV head, 64-key tile), the
//      heaviest causal tiles (the first) first.  K and V stay in shared
//      memory; each warp owns 16 keys and keeps their dK and dV rows in
//      fp32 accumulator fragments until the end.  The Q and dO tiles (64
//      rows) of every query head of the group, with their lse and D, stream
//      through a 2-stage cp.async ring (one barrier a tile, the next tile's
//      copy issued before the current one is computed); only the query
//      tiles that see the block's keys are visited.  With the keys as the
//      accumulator rows: S^T = K Q^T, P^T = 2^(S^T scale log2 e - lse),
//      dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q.
//      P^T and dS^T pass from the m16n8 C layout to the A layout in
//      registers, as the forward's P does; Q and dO come in by ldmatrix
//      (plain for the B operand of S^T and dP^T, .trans for dV and dK).
//   3. dQ: one block of 4 warps per (b, head, 64-row query tile), the
//      heaviest causal tiles (the last) first.  Q and dO stay in registers
//      as A fragments, lse and D of the warp's rows too; the K/V tiles (64
//      keys) the rows see stream through the ring.  S = Q K^T, P, dP =
//      dO V^T, dS, dQ += dS K (K by ldmatrix.trans).  S and dP are
//      computed again here (7 products a pair in all, not 5): the cheaper
//      way to stay free of atomics, as a dQ scratch per key tile would move
//      ~300 MB at SmolLM's shape.
// Rows of 128 queries or keys would hold more registers than a thread has
// (dK and dV are 16 x HDP each), so at HDP = 128 a warp takes a tile in
// chunks of 32 queries (or keys), else 64.  fp16/bf16: P and dS are rounded
// to the input type before their products, as the forward rounds P (and as
// PyTorch's fused attention does); lse, D and every accumulator are fp32;
// masks are built only on the chunks that cross the diagonal, the window
// edge, Sq or Sk.  Shared rows are padded by 16 bytes, so the 8 row
// addresses of each ldmatrix hit 8 different 4-bank groups.
//   fp32, 3xTF32: the same skeleton with fp32 in shared memory and every
// product as lo.hi + hi.lo + hi.hi on the TF32 tensor cores, hi = a
// rounded to TF32 and lo = a - hi rounded the same way (the forward
// truncates hi and lets the mma truncate lo: twice the error).  The tensor
// cores round toward zero when they add a product into a larger fp32 sum,
// so S and dP take each k-step's hi.hi in a fresh accumulator added with
// one rounding and their small products in accumulators of their own, and
// dV, dK and dQ take each chunk's products in fresh accumulators, a
// quarter of the columns at a time (registers), added to the running sums
// with one rounding (dK sums over G x Sq rows, 3,072 at SmolLM's shape).
// Both matter where dO follows o (a loss of sum(o^2)): dP and D are ~100
// and nearly cancel in dS = P (dP - D); the forward's split with one hi.hi
// accumulator missed rtol 1e-4 / atol 1e-5 there (PERF.md).  Inside
// each block of 8 the fragments take columns 2t and 2t + 1 as their k = t
// and t + 4: A fragments and the B fragments of S^T, dP^T, S and dP are
// float2 reads, and the C layout of P^T, dS^T and dS is the A fragment of
// the next product as it stands, whose B fragment reads rows 2t and
// 2t + 1.  Rows are hd + 8 floats (8 mod 32 words: the float2 reads hit
// every bank once; the row-pair reads of dO, Q and K, which serve both
// kinds, take two ways).  At HDP = 128 the chunks are 16 queries (dK/dV)
// and 32 keys (dQ), else 32 and 32.
// hd is zero-padded to HDP = 32, 64 or 128 (MLA's 96 runs at 128); the
// padded columns go through the mma like the others.  Sq and Sk may be
// ragged.  Loads are 16-byte cp.async when every base pointer and row
// stride is 16-byte aligned and hd fills whole 16-byte chunks (always on
// the LM path), element-wise into the same layout otherwise; dK, dV and dQ
// are staged in shared memory and stored the same way.
//
// What bounds it on this card: at SmolLM-135M's training shape (q
// [8,9,1024,64] bf16, k/v [8,3,1024,64], causal) the gradient needs 5
// products of 2 x hd flops a visible pair (S recomputed, dP, dV, dQ, dK),
// 10 x 64 x 72 heads x 525k pairs = 24.2 GFLOP (33.9 with the dQ kernel's
// S and dP): 24.5 us at the tensor cores' 989 TFLOP/s, against 50 MB (q,
// k, v, o, dO read, dq, dk, dv written): 15 us.  So operations.  mma.sync
// reaches part of that rate, and each warp issues its softmax, masks and
// fragment loads beside its products; wgmma with TMA loads and warp
// specialisation (producer warps feeding consumer warpgroups), which take
// the products and the copies off the issuing warps, are the next
// version's, for this kernel and the forward alike.  fp32 runs three TF32
// products for each: 147 us of bound at that shape.
#include "attention_mma.cuh"

namespace {

constexpr int HD_MAX = 128;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 16 * WARPS;   // keys (dK/dV) or queries (dQ) a block
constexpr int BT = 64;           // rows of a streamed tile
constexpr int STAGES = 2;        // the ring

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// element strides (b, h, s) of the eight tensors, in this order
enum { SQ = 0, SK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18,
       SDV = 21, N_STRIDES = 24 };

struct Params {
  const void *q, *k, *v, *o, *dout;
  const float* lse;     // [B, H, Sq], base 2, from the forward
  float* dsum;          // [B, H, Sq]: D, written by launch 1
  void *dq, *dk, *dv;
  long long st[N_STRIDES];
  int B, H, Hk, Sq, Sk, hd, causal, window;
  float scale;
  int vec;              // 16-byte copies and stores
};

__device__ __forceinline__ bool visible(int qi, int kj, int causal,
                                        int window) {
  return (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}

// a row that sees no key: the forward averages all Sk keys at -1e30
__device__ __forceinline__ bool all_masked(int qi, int Sk, int window) {
  return window > 0 && (long long)qi >= (long long)Sk + window - 1;
}

// the query tiles some row of which sees a key in [k0, k_last] (rows that
// see no key see all), [*q_begin, *q_end)
__device__ __forceinline__ void query_range(int k0, int k_last, int Sq,
                                            int Sk, int causal, int window,
                                            int bt, int* q_begin,
                                            int* q_end) {
  *q_begin = causal ? min(k0, Sq) / bt * bt : 0;
  *q_end = Sq;
  if (window > 0 && (long long)Sq - 1 < (long long)Sk + window - 1)
    *q_end = (int)min((long long)Sq, (long long)k_last + window);
}

// rows [row0, row0 + ROWS) of a [S, hd] matrix of E (fp32, or fp16/bf16
// bits; row stride `stride` elements) into shared memory [ROWS][LD], zero
// past S and past hd up to HDP.  `vec`: 16-byte cp.async (base and stride
// 16-byte aligned, hd a whole number of 16-byte chunks); else element-wise
// loads.
template <typename E, int ROWS, int HDP, int LD>
__device__ __forceinline__ void load_tile(E* dst, const E* src,
                                          long long stride, int row0, int S,
                                          int hd, bool vec) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(E);   // elements a 16-byte chunk
    constexpr int CPR = HDP / EPC;        // chunks a row
#pragma unroll
    for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * EPC;
      E* d = dst + r * LD + col;
      if (row0 + r < S && col < hd)
        cp_async16(smem_u32(d), src + (row0 + r) * stride + col);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HDP; i += THREADS) {
      const int r = i / HDP, col = i % HDP, row = row0 + r;
      dst[r * LD + col] = row < S && col < hd ? src[row * stride + col] : E(0);
    }
  }
}

// lse and D of rows [row0, row0 + BT) (0 past S) into ls[BT], dd[BT]
__device__ __forceinline__ void load_stats(float* ls, float* dd,
                                           const Params& p, long long off,
                                           int row0) {
  for (int i = threadIdx.x; i < 2 * BT; i += THREADS) {
    const int r = i % BT;
    float* d = (i < BT ? ls : dd) + r;
    if (row0 + r < p.Sq)
      cp_async4(smem_u32(d), (i < BT ? p.lse : p.dsum) + off + row0 + r);
    else
      *d = 0.0f;
  }
}

// how T is held in shared memory and passed: fp16/bf16 as their bits
template <typename T> struct Bits { using type = uint16_t; };
template <> struct Bits<float> { using type = float; };

// two fp32 values as two T at d
template <typename T>
__device__ __forceinline__ void put2(typename Bits<T>::type* d, float a,
                                     float b) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float2*>(d) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(d) = tc::pack2<T>(a, b);
}

// A warp's 16 x HDP block of fp32 fragments (rows g, g + 8; columns
// 8 i + 2t, + 1), times `mul`, as T to rows [row0, row0 + 16) of a [S, hd]
// matrix (row stride `stride`): staged in the warp's 16 rows of shared
// memory `sw` (row stride LD), then 16-byte stores when `vec`,
// element-wise otherwise
template <typename T, int HDP, int LD>
__device__ __forceinline__ void store_rows(typename Bits<T>::type* dst,
                                           long long stride, int row0, int S,
                                           int hd, bool vec,
                                           typename Bits<T>::type* sw,
                                           const float (&acc)[HDP / 8][4],
                                           float mul) {
  using E = typename Bits<T>::type;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < HDP / 8; ++i) {
    const int col = 8 * i + 2 * t;
    put2<T>(sw + g * LD + col, acc[i][0] * mul, acc[i][1] * mul);
    put2<T>(sw + (g + 8) * LD + col, acc[i][2] * mul, acc[i][3] * mul);
  }
  __syncwarp();
  if (vec) {
    constexpr int EPC = 16 / sizeof(E);
    const int cpr = hd / EPC;
    for (int c = lane; c < 16 * cpr; c += 32) {
      const int r = c / cpr, col = (c % cpr) * EPC, row = row0 + r;
      if (row < S)
        *reinterpret_cast<uint4*>(dst + row * stride + col) =
            *reinterpret_cast<const uint4*>(sw + r * LD + col);
    }
  } else {
    for (int i = lane; i < 16 * hd; i += 32) {
      const int r = i / hd, col = i % hd, row = row0 + r;
      if (row < S) dst[row * stride + col] = sw[r * LD + col];
    }
  }
}

// launch 1: D = rowsum(dO o), one warp a row (b, h, i)
template <typename T>
__global__ void __launch_bounds__(256) dsum_kernel(Params p) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.H * p.Sq) return;
  const int i = (int)(row % p.Sq);
  const int bh = (int)(row / p.Sq), b = bh / p.H, h = bh % p.H;
  const T* o = static_cast<const T*>(p.o) + b * p.st[SO] + h * p.st[SO + 1] +
               i * p.st[SO + 2];
  const T* g = static_cast<const T*>(p.dout) + b * p.st[SDO] +
               h * p.st[SDO + 1] + i * p.st[SDO + 2];
  float acc = 0.0f;
  for (int c = lane; c < p.hd; c += 32) acc += to_f<T>(o[c]) * to_f<T>(g[c]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(FULL, acc, m);
  if (lane == 0) p.dsum[row] = acc;
}

// P^T of a warp's chunk in the dK/dV kernels, in place of its scores:
// rows (keys) wk0 + g + 8 (e >> 1), columns (queries) qc0 + 8 n + 2 t +
// (e & 1); ls the chunk's lse from its first query.  The mask only where
// the chunk crosses the diagonal, the window edge, Sq or Sk.
template <int NC>
__device__ __forceinline__ void probs_t(float (&s)[NC][4], const Params& p,
                                        const float* ls, int wk0, int qc0,
                                        bool edge, float sl2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse = (e & 1) ? l2.y : l2.x;
      const float pv = exp2_approx(fmaf(s[n][e], sl2, -lse));
      if (edge) {
        const int kj = wk0 + g + 8 * (e >> 1);
        const int qi = qc0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = qi >= p.Sq || kj >= p.Sk ? 0.0f
                  : all_masked(qi, p.Sk, p.window) ? 1.0f / (float)p.Sk
                  : visible(qi, kj, p.causal, p.window) ? pv : 0.0f;
      } else {
        s[n][e] = pv;
      }
    }
  }
}

// dS^T = P^T (dP^T - D) in place of dP^T (0 on rows that see no key; P^T
// is 0 wherever else the score is masked)
template <int NC>
__device__ __forceinline__ void dscores_t(float (&dp)[NC][4],
                                          const float (&pt)[NC][4],
                                          const Params& p, const float* dd,
                                          int qc0, bool edge) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ds = pt[n][e] * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
      dp[n][e] = edge && all_masked(qc0 + 8 * n + 2 * t + (e & 1), p.Sk,
                                    p.window) ? 0.0f : ds;
    }
  }
}

// dS of a warp's chunk in the dQ kernels, in place of dP: rows (queries)
// wq0 + g + 8 (e >> 1), columns (keys) kc0 + 8 n + 2 t + (e & 1); s the
// scores, lse and D of rows g and g + 8.  Rows that see no key, rows past
// Sq, keys past Sk and masked pairs give 0.
template <int NC>
__device__ __forceinline__ void dscores(float (&dp)[NC][4],
                                        const float (&s)[NC][4],
                                        const Params& p,
                                        const float (&lse)[2],
                                        const float (&dd)[2], int wq0,
                                        int kc0, bool edge, float sl2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float pv = exp2_approx(fmaf(s[n][e], sl2, -lse[r]));
      if (edge) {
        const int qi = wq0 + g + 8 * r, kj = kc0 + 8 * n + 2 * t + (e & 1);
        if (qi >= p.Sq || kj >= p.Sk || all_masked(qi, p.Sk, p.window) ||
            !visible(qi, kj, p.causal, p.window))
          pv = 0.0f;
      }
      dp[n][e] = pv * (dp[n][e] - dd[r]);
    }
  }
}

// whether a warp's keys [wk0, wk0 + 15] and a chunk's queries [qc0,
// qc0 + ch) share no pair that adds to dK or dV
__device__ __forceinline__ bool skip_t(const Params& p, int wk0, int qc0,
                                       int ch) {
  const int qc_last = qc0 + ch - 1;
  if (wk0 >= p.Sk || qc0 >= p.Sq) return true;
  if (p.causal && wk0 > qc_last) return true;
  return p.window > 0 && wk0 + 15 <= qc0 - p.window &&
         (long long)qc_last < (long long)p.Sk + p.window - 1;
}

// whether a chunk of keys [kc0, kc0 + ch) x queries [rq0, rq0 + rows)
// needs the mask
__device__ __forceinline__ bool edge_of(const Params& p, int q0, int qrows,
                                        int k0, int krows) {
  return q0 + qrows > p.Sq || k0 + krows > p.Sk ||
         (p.causal && k0 + krows - 1 > q0) ||
         (p.window > 0 && k0 <= q0 + qrows - 1 - p.window);
}

// ------------------------------------------------ fp16/bf16, tensor cores
namespace tc {

constexpr int PAD = 8;   // elements (16 bytes) after each row

template <int HDP> struct Layout {
  static constexpr int LDS = HDP + PAD;
  static constexpr int TILE = BT * LDS;   // a streamed tile
  static constexpr int RES = BN * LDS;    // a resident tile
  // two resident tiles, then STAGES x two streamed ones, then STAGES x
  // (lse, D) of BT rows
  static constexpr size_t BYTES = sizeof(uint16_t) *
                                      (2 * RES + STAGES * 2 * TILE) +
                                  sizeof(float) * STAGES * 2 * BT;
};

// queries (dK/dV) or keys (dQ) a warp takes at a time
template <int HDP> __host__ __device__ constexpr int chunk() {
  return HDP == 128 ? 32 : 64;
}

// acc (16 x 8 NC) = A B^T: A as register fragments (16 x HDP), B the
// rows of `b` (8 NC x HDP) by ldmatrix; S = Q K^T and dP = dO V^T in the
// dQ kernel, S^T = K Q^T and dP^T = V dO^T in the dK/dV kernel
template <typename T, int HDP, int NC>
__device__ __forceinline__ void frag_product(float (&acc)[NC][4],
                                             const uint32_t (&af)[HDP / 16][4],
                                             const uint16_t* b) {
  constexpr int LDS = HDP + PAD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NC; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_u32(b + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                           ks * 16 + ((lane >> 3) & 1) * 8));
      mma<T>(acc[2 * np], af[ks], bf[0], bf[1]);
      mma<T>(acc[2 * np + 1], af[ks], bf[2], bf[3]);
    }
  }
}

// the A fragments of a warp's 16 rows of `a` ([16][LDS] in shared memory)
template <int HDP>
__device__ __forceinline__ void load_frags(uint32_t (&af)[HDP / 16][4],
                                           const uint16_t* a) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks)
    ldsm_x4(af[ks], smem_u32(a + (lane & 15) * (HDP + PAD) + ks * 16 +
                             (lane >> 4) * 8));
}

// acc (16 x HDP) += X M: X the chunk's fp32 C fragments (16 x 8 NC),
// rounded to T, as the A operand; M the rows m0 .. m0 + 8 NC of `m` (k
// along its rows) by ldmatrix.trans: dV += P^T dO, dK += dS^T Q,
// dQ += dS K
template <typename T, int HDP, int NC>
__device__ __forceinline__ void cols_product(float (&acc)[HDP / 8][4],
                                             const float (&x)[NC][4],
                                             const uint16_t* m) {
  constexpr int LDS = HDP + PAD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NC / 2; ++kk) {
    const uint32_t a[4] = {pack2<T>(x[2 * kk][0], x[2 * kk][1]),
                           pack2<T>(x[2 * kk][2], x[2 * kk][3]),
                           pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t mf[4];
      ldsm_x4_trans(mf, smem_u32(m + (kk * 16 + (lane & 15)) * LDS + dp * 16 +
                                 (lane >> 4) * 8));
      mma<T>(acc[2 * dp], a, mf[0], mf[1]);
      mma<T>(acc[2 * dp + 1], a, mf[2], mf[3]);
    }
  }
}

// launch 2: dK and dV of one (b, KV head, BN-key tile)
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Params p) {
  using Ly = Layout<HDP>;
  constexpr int LDS = Ly::LDS, DT = HDP / 8;
  constexpr int CH = chunk<HDP>(), NC = CH / 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;                      // K [BN][LDS]
  uint16_t* vs = ks + Ly::RES;              // V [BN][LDS]
  uint16_t* ring = vs + Ly::RES;            // stage: Q, dO [BT][LDS]
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * Ly::TILE);

  const int BHk = p.B * p.Hk;
  const int bk = (int)blockIdx.x % BHk;
  const int k0 = (int)blockIdx.x / BHk * BN, k_last = min(k0 + BN, p.Sk) - 1;
  const int b = bk / p.Hk, hk = bk % p.Hk, G = p.H / p.Hk;
  const int warp = threadIdx.x >> 5;
  const int wk0 = k0 + warp * 16;
  const float sl2 = p.scale * LOG2E;
  const uint16_t* qb = static_cast<const uint16_t*>(p.q) + b * p.st[SQ];
  const uint16_t* gb = static_cast<const uint16_t*>(p.dout) + b * p.st[SDO];

  int q_begin, q_end;
  query_range(k0, k_last, p.Sq, p.Sk, p.causal, p.window, BT, &q_begin,
              &q_end);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BT - 1) / BT : 0;
  const int n_tiles = G * n_qt;

  // tile i (head hk G + i / n_qt, rows q_begin + BT (i % n_qt)) into
  // stage i % STAGES, one commit group a tile (empty past the last)
  auto load_q = [&](int i) {
    if (i < n_tiles) {
      const int h = hk * G + i / n_qt, q0 = q_begin + (i % n_qt) * BT;
      uint16_t* st = ring + (i % STAGES) * 2 * Ly::TILE;
      load_tile<uint16_t, BT, HDP, LDS>(st, qb + h * p.st[SQ + 1],
                                        p.st[SQ + 2], q0, p.Sq, p.hd, p.vec);
      load_tile<uint16_t, BT, HDP, LDS>(st + Ly::TILE, gb + h * p.st[SDO + 1],
                                        p.st[SDO + 2], q0, p.Sq, p.hd, p.vec);
      float* ss = stats + (i % STAGES) * 2 * BT;
      load_stats(ss, ss + BT, p, ((long long)b * p.H + h) * p.Sq, q0);
    }
    cp_async_commit();
  };
  load_tile<uint16_t, BN, HDP, LDS>(
      ks, static_cast<const uint16_t*>(p.k) + b * p.st[SK] + hk * p.st[SK + 1],
      p.st[SK + 2], k0, p.Sk, p.hd, p.vec);
  load_tile<uint16_t, BN, HDP, LDS>(
      vs, static_cast<const uint16_t*>(p.v) + b * p.st[SV] + hk * p.st[SV + 1],
      p.st[SV + 2], k0, p.Sk, p.hd, p.vec);
  load_q(0);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;
  const uint16_t* kw = ks + warp * 16 * LDS;
  const uint16_t* vw = vs + warp * 16 * LDS;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();   // tile it (and at first K, V) has landed
    __syncthreads();      // ... for every thread, and tile it - 1 is read
    load_q(it + 1);       // into the stage tile it - 1 used
    const int q0 = q_begin + (it % n_qt) * BT;
    const uint16_t* qst = ring + (it % STAGES) * 2 * Ly::TILE;
    const uint16_t* gst = qst + Ly::TILE;
    const float* lst = stats + (it % STAGES) * 2 * BT;
#pragma unroll 1
    for (int c = 0; c < BT; c += CH) {
      const int qc0 = q0 + c;
      if (skip_t(p, wk0, qc0, CH)) continue;
      const bool edge = edge_of(p, qc0, CH, wk0, 16);
      float pt[NC][4], dpt[NC][4];
      uint32_t af[HDP / 16][4];
      load_frags<HDP>(af, kw);
      frag_product<T, HDP, NC>(pt, af, qst + c * LDS);          // S^T
      probs_t(pt, p, lst + c, wk0, qc0, edge, sl2);               // P^T
      cols_product<T, HDP, NC>(dv, pt, gst + c * LDS);          // dV
      load_frags<HDP>(af, vw);
      frag_product<T, HDP, NC>(dpt, af, gst + c * LDS);         // dP^T
      dscores_t(dpt, pt, p, lst + BT + c, qc0, edge);             // dS^T
      cols_product<T, HDP, NC>(dk, dpt, qst + c * LDS);         // dK
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every copy has landed before K, V's rows are reused
  const long long so = (long long)b * p.st[SDK] + hk * p.st[SDK + 1];
  const long long vo = (long long)b * p.st[SDV] + hk * p.st[SDV + 1];
  store_rows<T, HDP, LDS>(static_cast<uint16_t*>(p.dk) + so,
                                 p.st[SDK + 2], wk0, p.Sk, p.hd, p.vec,
                                 ks + warp * 16 * LDS, dk, p.scale);
  store_rows<T, HDP, LDS>(static_cast<uint16_t*>(p.dv) + vo,
                                 p.st[SDV + 2], wk0, p.Sk, p.hd, p.vec,
                                 vs + warp * 16 * LDS, dv, 1.0f);
}

// launch 3: dQ of one (b, head, BN-row query tile)
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  using Ly = Layout<HDP>;
  constexpr int LDS = Ly::LDS, KS = HDP / 16, DT = HDP / 8;
  constexpr int CH = chunk<HDP>(), NC = CH / 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sq = smem;                      // Q [BN][LDS]
  uint16_t* sg = sq + Ly::RES;              // dO [BN][LDS]
  uint16_t* ring = sg + Ly::RES;            // stage: K, V [BT][LDS]

  // the heaviest (last) causal query tiles first, every (b, h) of a q-tile
  // together
  const int BH = p.B * p.H;
  const int bh = (int)blockIdx.x % BH;
  const int q0 = ((int)gridDim.x / BH - 1 - (int)blockIdx.x / BH) * BN;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = (int)((long long)h * p.Hk / p.H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int wq0 = q0 + warp * 16;
  const float sl2 = p.scale * LOG2E;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + b * p.st[SK] +
                       hk * p.st[SK + 1];
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + b * p.st[SV] +
                       hk * p.st[SV + 1];

  int k_begin, k_end;
  key_range(q0, min(q0 + BN, p.Sq) - 1, p.Sk, p.causal, p.window, BT,
            &k_begin, &k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BT - 1) / BT : 0;

  auto load_kv = [&](int i) {
    if (i < n_tiles) {
      uint16_t* st = ring + (i % STAGES) * 2 * Ly::TILE;
      load_tile<uint16_t, BT, HDP, LDS>(st, kb, p.st[SK + 2],
                                        k_begin + i * BT, p.Sk, p.hd, p.vec);
      load_tile<uint16_t, BT, HDP, LDS>(st + Ly::TILE, vb, p.st[SV + 2],
                                        k_begin + i * BT, p.Sk, p.hd, p.vec);
    }
    cp_async_commit();
  };
  load_tile<uint16_t, BN, HDP, LDS>(
      sq, static_cast<const uint16_t*>(p.q) + b * p.st[SQ] + h * p.st[SQ + 1],
      p.st[SQ + 2], q0, p.Sq, p.hd, p.vec);
  load_tile<uint16_t, BN, HDP, LDS>(
      sg,
      static_cast<const uint16_t*>(p.dout) + b * p.st[SDO] + h * p.st[SDO + 1],
      p.st[SDO + 2], q0, p.Sq, p.hd, p.vec);
  load_kv(0);
  // lse and D of rows g and g + 8
  float lse[2], dd[2];
  const long long row_off = (long long)bh * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    lse[r] = qi < p.Sq ? p.lse[row_off + qi] : 0.0f;
    dd[r] = qi < p.Sq ? p.dsum[row_off + qi] : 0.0f;
  }
  cp_async_wait<0>();   // Q, dO and tile 0 have landed
  __syncthreads();
  uint32_t qf[KS][4], gf[KS][4];
  load_frags<HDP>(qf, sq + warp * 16 * LDS);
  load_frags<HDP>(gf, sg + warp * 16 * LDS);
  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it > 0) {
      cp_async_wait<0>();   // tile it has landed
      __syncthreads();      // ... for every thread, and tile it - 1 is read
    }
    load_kv(it + 1);        // into the stage tile it - 1 used
    const int kt = k_begin + it * BT;
    const uint16_t* kst = ring + (it % STAGES) * 2 * Ly::TILE;
    const uint16_t* vst = kst + Ly::TILE;
#pragma unroll 1
    for (int c = 0; c < BT; c += CH) {
      const int kc0 = kt + c;
      // keys wholly after the warp's rows, or past Sk; before the window
      // of every row (rows that see no key add nothing to dQ)
      if ((p.causal && kc0 > wq0 + 15) || kc0 >= p.Sk) break;
      if (p.window > 0 && kc0 + CH - 1 <= wq0 - p.window) continue;
      const bool edge = edge_of(p, wq0, 16, kc0, CH);
      float s[NC][4], dp[NC][4];
      frag_product<T, HDP, NC>(s, qf, kst + c * LDS);    // S
      frag_product<T, HDP, NC>(dp, gf, vst + c * LDS);   // dP
      dscores(dp, s, p, lse, dd, wq0, kc0, edge, sl2);   // dS
      cols_product<T, HDP, NC>(dq, dp, kst + c * LDS);   // dQ
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  store_rows<T, HDP, LDS>(
      static_cast<uint16_t*>(p.dq) + (long long)b * p.st[SDQ] +
          h * p.st[SDQ + 1],
      p.st[SDQ + 2], wq0, p.Sq, p.hd, p.vec, sq + warp * 16 * LDS, dq,
      p.scale);
}

}  // namespace tc

// ------------------------------------------------- fp32, 3xTF32 tensor cores
namespace tf32 {

template <int HDP> struct Layout {
  static constexpr int LD = HDP + 8;      // 8 mod 32 words
  static constexpr int TILE = BT * LD;
  static constexpr int RES = BN * LD;
  static constexpr size_t BYTES =
      sizeof(float) * (2 * RES + STAGES * 2 * TILE + STAGES * 2 * BT);
};

// queries (dK/dV) and keys (dQ) a warp takes at a time
template <int HDP> __host__ __device__ constexpr int chunk_t() {
  return HDP == 128 ? 16 : 32;
}
constexpr int CHQ = 32;
// columns of dV, dK or dQ whose chunk products share fresh accumulators
constexpr int GROUP_TILES = 4;

// a = hi + lo with hi = a rounded to TF32 (to nearest, ties away from
// zero) and lo = a - hi rounded the same way: half the error of the
// forward's split (truncated hi, lo truncated by the mma), which dP needs
// where dP and D are large and nearly cancel
__device__ __forceinline__ void split_rn(float a, uint32_t& hi,
                                         uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(a - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// the A fragment of rows g, g + 8 of a [16][LD] block at k-step ks, split
__device__ __forceinline__ void a_frag(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const float* a, int LD, int ks) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 top =
      *reinterpret_cast<const float2*>(a + g * LD + 8 * ks + 2 * t);
  const float2 bot =
      *reinterpret_cast<const float2*>(a + (g + 8) * LD + 8 * ks + 2 * t);
  split_rn(top.x, ah[0], al[0]);
  split_rn(bot.x, ah[1], al[1]);
  split_rn(top.y, ah[2], al[2]);
  split_rn(bot.y, ah[3], al[3]);
}

// acc (16 x 8 NC) = A B^T, A rows of `a` (16 x HDP), B rows of `b`
// (8 NC x HDP): each k-step's hi.hi into a fresh accumulator added to acc
// with one rounding (the tensor cores round toward zero when they add into
// a larger sum), the small products into accumulators of their own, added
// once at the end
template <int HDP, int NC>
__device__ __forceinline__ void rows_product(float (&acc)[NC][4],
                                             const float* a,
                                             const float* b) {
  constexpr int LD = HDP + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float sm[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = sm[n][e] = 0.0f;
  const float* bf = b + g * LD + 2 * t;
#pragma unroll
  for (int ks = 0; ks < HDP / 8; ++ks) {
    uint32_t ah[4], al[4];
    a_frag(ah, al, a, LD, ks);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float2 bb =
          *reinterpret_cast<const float2*>(bf + n * 8 * LD + 8 * ks);
      uint32_t bh0, bl0, bh1, bl1;
      split_rn(bb.x, bh0, bl0);
      split_rn(bb.y, bh1, bl1);
      mma(sm[n], al, bh0, bh1);
      mma(sm[n], ah, bl0, bl1);
      float hh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma(hh, ah, bh0, bh1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += hh[e];
    }
  }
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = sm[n][e] + acc[n][e];
}

// acc (16 x HDP) += X M: X the chunk's C fragments (16 x 8 NC) as the A
// operand (its keys 2t, 2t + 1 of each 8 are the fragment's k = t and
// t + 4), M rows m0 .. m0 + 8 NC of `m` (rows 2t and 2t + 1 of each 8 for
// the B fragment); GROUP_TILES 8-column tiles at a time into fresh
// accumulators, each added to acc with one rounding
template <int HDP, int NC>
__device__ __forceinline__ void cols_product(float (&acc)[HDP / 8][4],
                                             const float (&x)[NC][4],
                                             const float* m) {
  constexpr int LD = HDP + 8, DT = HDP / 8;
  constexpr int GT = DT < GROUP_TILES ? DT : GROUP_TILES;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* mf = m + 2 * t * LD + g;
#pragma unroll
  for (int grp = 0; grp < DT / GT; ++grp) {
    float tile[GT][4];
#pragma unroll
    for (int j = 0; j < GT; ++j)
      tile[j][0] = tile[j][1] = tile[j][2] = tile[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      uint32_t xh[4], xl[4];
      split_rn(x[kk][0], xh[0], xl[0]);
      split_rn(x[kk][2], xh[1], xl[1]);
      split_rn(x[kk][1], xh[2], xl[2]);
      split_rn(x[kk][3], xh[3], xl[3]);
      const float* mk = mf + 8 * kk * LD + 8 * GT * grp;
#pragma unroll
      for (int j = 0; j < GT; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split_rn(mk[8 * j], bh0, bl0);
        split_rn(mk[LD + 8 * j], bh1, bl1);
        mma3(tile[j], xh, xl, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int j = 0; j < GT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[GT * grp + j][e] += tile[j][e];
  }
}

// launch 2: dK and dV of one (b, KV head, BN-key tile)
template <int HDP>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Params p) {
  using Ly = Layout<HDP>;
  constexpr int LD = Ly::LD, DT = HDP / 8;
  constexpr int CH = chunk_t<HDP>(), NC = CH / 8;
  extern __shared__ __align__(16) float fsmem[];
  float* ks = fsmem;
  float* vs = ks + Ly::RES;
  float* ring = vs + Ly::RES;
  float* stats = ring + STAGES * 2 * Ly::TILE;

  const int BHk = p.B * p.Hk;
  const int bk = (int)blockIdx.x % BHk;
  const int k0 = (int)blockIdx.x / BHk * BN, k_last = min(k0 + BN, p.Sk) - 1;
  const int b = bk / p.Hk, hk = bk % p.Hk, G = p.H / p.Hk;
  const int warp = threadIdx.x >> 5;
  const int wk0 = k0 + warp * 16;
  const float sl2 = p.scale * LOG2E;
  const float* qb = static_cast<const float*>(p.q) + b * p.st[SQ];
  const float* gb = static_cast<const float*>(p.dout) + b * p.st[SDO];

  int q_begin, q_end;
  query_range(k0, k_last, p.Sq, p.Sk, p.causal, p.window, BT, &q_begin,
              &q_end);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BT - 1) / BT : 0;
  const int n_tiles = G * n_qt;

  auto load_q = [&](int i) {
    if (i < n_tiles) {
      const int h = hk * G + i / n_qt, q0 = q_begin + (i % n_qt) * BT;
      float* st = ring + (i % STAGES) * 2 * Ly::TILE;
      load_tile<float, BT, HDP, LD>(st, qb + h * p.st[SQ + 1], p.st[SQ + 2],
                                    q0, p.Sq, p.hd, p.vec);
      load_tile<float, BT, HDP, LD>(st + Ly::TILE, gb + h * p.st[SDO + 1],
                                    p.st[SDO + 2], q0, p.Sq, p.hd, p.vec);
      float* ss = stats + (i % STAGES) * 2 * BT;
      load_stats(ss, ss + BT, p, ((long long)b * p.H + h) * p.Sq, q0);
    }
    cp_async_commit();
  };
  load_tile<float, BN, HDP, LD>(
      ks, static_cast<const float*>(p.k) + b * p.st[SK] + hk * p.st[SK + 1],
      p.st[SK + 2], k0, p.Sk, p.hd, p.vec);
  load_tile<float, BN, HDP, LD>(
      vs, static_cast<const float*>(p.v) + b * p.st[SV] + hk * p.st[SV + 1],
      p.st[SV + 2], k0, p.Sk, p.hd, p.vec);
  load_q(0);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;
  const float* kw = ks + warp * 16 * LD;
  const float* vw = vs + warp * 16 * LD;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    load_q(it + 1);
    const int q0 = q_begin + (it % n_qt) * BT;
    const float* qst = ring + (it % STAGES) * 2 * Ly::TILE;
    const float* gst = qst + Ly::TILE;
    const float* lst = stats + (it % STAGES) * 2 * BT;
#pragma unroll 1
    for (int c = 0; c < BT; c += CH) {
      const int qc0 = q0 + c;
      if (skip_t(p, wk0, qc0, CH)) continue;
      const bool edge = edge_of(p, qc0, CH, wk0, 16);
      float pt[NC][4], dpt[NC][4];
      rows_product<HDP, NC>(pt, kw, qst + c * LD);          // S^T
      probs_t(pt, p, lst + c, wk0, qc0, edge, sl2);           // P^T
      cols_product<HDP, NC>(dv, pt, gst + c * LD);          // dV
      rows_product<HDP, NC>(dpt, vw, gst + c * LD);         // dP^T
      dscores_t(dpt, pt, p, lst + BT + c, qc0, edge);         // dS^T
      cols_product<HDP, NC>(dk, dpt, qst + c * LD);         // dK
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const long long so = (long long)b * p.st[SDK] + hk * p.st[SDK + 1];
  const long long vo = (long long)b * p.st[SDV] + hk * p.st[SDV + 1];
  store_rows<float, HDP, LD>(static_cast<float*>(p.dk) + so, p.st[SDK + 2],
                             wk0, p.Sk, p.hd, p.vec, ks + warp * 16 * LD, dk,
                             p.scale);
  store_rows<float, HDP, LD>(static_cast<float*>(p.dv) + vo, p.st[SDV + 2],
                             wk0, p.Sk, p.hd, p.vec, vs + warp * 16 * LD, dv,
                             1.0f);
}

// launch 3: dQ of one (b, head, BN-row query tile)
template <int HDP>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  using Ly = Layout<HDP>;
  constexpr int LD = Ly::LD, DT = HDP / 8;
  constexpr int CH = CHQ, NC = CH / 8;
  extern __shared__ __align__(16) float fsmem[];
  float* sq = fsmem;
  float* sg = sq + Ly::RES;
  float* ring = sg + Ly::RES;

  const int BH = p.B * p.H;
  const int bh = (int)blockIdx.x % BH;
  const int q0 = ((int)gridDim.x / BH - 1 - (int)blockIdx.x / BH) * BN;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = (int)((long long)h * p.Hk / p.H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int wq0 = q0 + warp * 16;
  const float sl2 = p.scale * LOG2E;
  const float* kb = static_cast<const float*>(p.k) + b * p.st[SK] +
                    hk * p.st[SK + 1];
  const float* vb = static_cast<const float*>(p.v) + b * p.st[SV] +
                    hk * p.st[SV + 1];

  int k_begin, k_end;
  key_range(q0, min(q0 + BN, p.Sq) - 1, p.Sk, p.causal, p.window, BT,
            &k_begin, &k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BT - 1) / BT : 0;

  auto load_kv = [&](int i) {
    if (i < n_tiles) {
      float* st = ring + (i % STAGES) * 2 * Ly::TILE;
      load_tile<float, BT, HDP, LD>(st, kb, p.st[SK + 2], k_begin + i * BT,
                                    p.Sk, p.hd, p.vec);
      load_tile<float, BT, HDP, LD>(st + Ly::TILE, vb, p.st[SV + 2],
                                    k_begin + i * BT, p.Sk, p.hd, p.vec);
    }
    cp_async_commit();
  };
  load_tile<float, BN, HDP, LD>(
      sq, static_cast<const float*>(p.q) + b * p.st[SQ] + h * p.st[SQ + 1],
      p.st[SQ + 2], q0, p.Sq, p.hd, p.vec);
  load_tile<float, BN, HDP, LD>(
      sg, static_cast<const float*>(p.dout) + b * p.st[SDO] + h * p.st[SDO + 1],
      p.st[SDO + 2], q0, p.Sq, p.hd, p.vec);
  load_kv(0);
  float lse[2], dd[2];
  const long long row_off = (long long)bh * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    lse[r] = qi < p.Sq ? p.lse[row_off + qi] : 0.0f;
    dd[r] = qi < p.Sq ? p.dsum[row_off + qi] : 0.0f;
  }
  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.0f;
  const float* qw = sq + warp * 16 * LD;
  const float* gw = sg + warp * 16 * LD;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();   // tile it (and at first Q, dO) has landed
    __syncthreads();
    load_kv(it + 1);
    const int kt = k_begin + it * BT;
    const float* kst = ring + (it % STAGES) * 2 * Ly::TILE;
    const float* vst = kst + Ly::TILE;
#pragma unroll 1
    for (int c = 0; c < BT; c += CH) {
      const int kc0 = kt + c;
      if ((p.causal && kc0 > wq0 + 15) || kc0 >= p.Sk) break;
      if (p.window > 0 && kc0 + CH - 1 <= wq0 - p.window) continue;
      const bool edge = edge_of(p, wq0, 16, kc0, CH);
      float s[NC][4], dp[NC][4];
      rows_product<HDP, NC>(s, qw, kst + c * LD);     // S
      rows_product<HDP, NC>(dp, gw, vst + c * LD);    // dP
      dscores(dp, s, p, lse, dd, wq0, kc0, edge, sl2);  // dS
      cols_product<HDP, NC>(dq, dp, kst + c * LD);    // dQ
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  store_rows<float, HDP, LD>(static_cast<float*>(p.dq) +
                                 (long long)b * p.st[SDQ] + h * p.st[SDQ + 1],
                             p.st[SDQ + 2], wq0, p.Sq, p.hd, p.vec,
                             sq + warp * 16 * LD, dq, p.scale);
}

}  // namespace tf32

template <typename T, int HDP>
int launch_hdp(const Params& p, cudaStream_t stream) {
  size_t smem;
  void (*dkdv)(Params);
  void (*dq)(Params);
  if constexpr (sizeof(T) == 4) {
    smem = tf32::Layout<HDP>::BYTES;
    dkdv = tf32::dkdv_kernel<HDP>;
    dq = tf32::dq_kernel<HDP>;
  } else {
    smem = tc::Layout<HDP>::BYTES;
    dkdv = tc::dkdv_kernel<T, HDP>;
    dq = tc::dq_kernel<T, HDP>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)p.B * p.H * p.Sq;
  const long long blocks1 = (rows + 7) / 8;
  const long long blocks2 = (long long)((p.Sk + BN - 1) / BN) * p.B * p.Hk;
  const long long blocks3 = (long long)((p.Sq + BN - 1) / BN) * p.B * p.H;
  if (blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL ||
      blocks3 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dsum_kernel<T><<<(unsigned)blocks1, 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<(unsigned)blocks2, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq<<<(unsigned)blocks3, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(Params& p, cudaStream_t stream) {
  // 16-byte copies and stores: every base 16-byte aligned, every stride
  // and hd a whole number of 16-byte chunks
  constexpr int EPC = 16 / sizeof(T);
  const auto al = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  long long any = p.hd;
  for (int i = 0; i < N_STRIDES; ++i) any |= p.st[i];
  p.vec = any % EPC == 0 && al(p.q) && al(p.k) && al(p.v) && al(p.dout) &&
          al(p.dq) && al(p.dk) && al(p.dv);
  return p.hd <= 32   ? launch_hdp<T, 32>(p, stream)
         : p.hd <= 64 ? launch_hdp<T, 64>(p, stream)
                      : launch_hdp<T, 128>(p, stream);
}

}  // namespace

// q [B,H,Sq,hd], k/v [B,Hk,Sk,hd], o and dout [B,H,Sq,hd] in one type
// (dtype 0 fp32, 1 fp16, 2 bf16); lse the forward's base-2 statistics and
// dsum scratch, both float32 [B,H,Sq] contiguous; dq/dk/dv outputs in the
// inputs' type.  `strides` points to 24 host int64: (b, h, s) element
// strides of q, k, v, o, dout, dq, dk, dv; the last dimension is
// contiguous.  Returns the CUDA error code of the launches (0 on success).
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dsum, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int Hk, int Sq, int Sk,
    int hd, int causal, int window, double scale, int dtype, void* stream) {
  if (hd < 1 || hd > HD_MAX || Hk < 1 || H % Hk != 0 || B < 1 || Sq < 1 ||
      Sk < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q, p.k = k, p.v = v, p.o = o, p.dout = dout, p.lse = lse;
  p.dsum = dsum, p.dq = dq, p.dk = dk, p.dv = dv;
  for (int i = 0; i < N_STRIDES; ++i) p.st[i] = strides[i];
  p.B = B, p.H = H, p.Hk = Hk, p.Sq = Sq, p.Sk = Sk, p.hd = hd;
  p.causal = causal, p.window = window, p.scale = (float)scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, s);
    case 1: return launch<__half>(p, s);
    case 2: return launch<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
