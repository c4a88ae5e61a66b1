// Blocked online-softmax attention (GQA, causal, sliding window) for
// Hopper (sm_90a) on the tensor cores: one kernel for fp16 and bf16, one
// for fp32 (3xTF32).
//
// Replaces: src/repro/kernels/flash_attention.py, `_flash_kernel`
// (pallas_call in `flash_attention_pallas`).  Same function as the plain
// version `repro_torch.kernels.flash_attention.flash_attention_plain` and
// the reference oracle `attention_reference`:
//   o[b,h,i] = softmax_j(q[b,h,i] . k[b,h*Hk/H,j] / sqrt(hd), masked) @ v
// q [B,H,Sq,hd], k/v [B,Hk,Sk,hd] in fp32, fp16 or bf16, o in q's type,
// hd <= 128.  Scores are fp32, from 0, scaled by 1/sqrt(hd).  Masked scores
// are -1e30 (not -inf), so a query row whose keys are all masked averages
// all Sk keys, as the Pallas kernel and the oracle do.  Keys at or past Sk
// (the ragged edge) take no part at all, and query rows at or past Sq are
// not written, so any Sq and Sk work (the Pallas kernel wants multiples of
// its block).  Strides are the caller's (the innermost dimension
// contiguous), so the model passes its [B,S,H,hd] projections transposed,
// without a copy.  Both kernels use no atomics and never split the keys:
// two calls give the same bits.
//
// What bounds it on this card: at Llama 3.1 8B's prefill (q [4,32,512,128]
// fp16, k/v [4,8,512,128], causal) a call needs 8.6 GFLOP and moves 42 MB:
// 8.7 us at the tensor cores' 989 TFLOP/s, 12.5 us at 3.35 TB/s, so bytes.
//
// fp16/bf16 (`tc::`), an FA2-style kernel on mma.sync tensor cores.  One
// block per (b, h, query tile of BQ = 16 x FLASH_TC_WARPS rows), the
// heaviest causal tiles first (the q-tile index runs backwards in
// blockIdx.x, with (b, h) fastest).  The Q tile is copied once with 16-byte
// cp.async and kept as ldmatrix A fragments in registers.  K/V tiles of 64
// keys go through a 2-stage cp.async ring in shared memory, in the input
// type, one barrier a tile: the next tile's copy is issued before the
// current one is computed.  Rows are padded by 16 bytes, so the 8 row
// addresses of each ldmatrix hit 8 different 4-bank groups.  Each warp owns
// 16 query rows: S = Q K^T by mma.m16n8k16 (fp16/bf16 in, fp32
// accumulators, K by ldmatrix), then the online softmax on the accumulator
// fragments (scores in base 2, pre-multiplied by log2(e); row max and sum
// by pairwise trees and two shuffles in each quad; exp2 on the SFU), the
// mask built from each element's (row, key) only on tiles that cross the
// diagonal, the window edge or Sk.  P is rounded to q's type in registers
// and used as the A operand of P V (the m16n8 C layout is the m16n8k16 A
// layout), V read by ldmatrix.trans; the sum l stays the fp32 sum of the
// unrounded P and the fp32 accumulator is 16 x HDP a warp.  hd is padded
// with zeros in shared memory to HDP = 32, 64 or 128 (6 instantiations);
// the padded columns go through the mma like the others, so that the
// unrolled loops hold no branch.  Loads are 16-byte cp.async when every
// base pointer and row stride is 16-byte aligned and hd % 8 == 0 (always
// on the LM path), element-wise into the same layout otherwise; the output
// is staged in shared memory and stored the same way.  On the card its
// time follows the instructions a warp issues per tile beside its 128 mma
// (copies, mask, softmax, rescaling) more than the mma themselves; wgmma
// and TMA, which take the products and the copies off the warps, are the
// next version's.
//
// fp32 (`tf32::`), 3xTF32 on the same tensor cores (mma.sync.m16n8k8):
// every fp32 operand is split as hi = a with the 13 bits TF32 drops
// cleared and lo = a - hi, and each product is taken as hi.hi + lo.hi +
// hi.lo, which keeps fp32's accuracy where a plain TF32 product keeps 11
// bits.  The tensor cores round toward zero when they add a product into a
// larger fp32 sum, and over thousands of keys that bias adds up, so S's
// small products go into accumulators of their own (summed with hi.hi once
// a tile), and each tile's P V goes into fresh accumulators that are added
// to the running output with one rounding (a quarter of the columns at a
// time, for registers).  Same skeleton as `tc::`: one block per (b, h,
// query tile of 128 rows: 8 warps), the heaviest causal tiles first, K/V
// tiles of 64 keys through a 2-stage cp.async ring (16-byte copies when
// aligned, element-wise otherwise, one barrier a tile), masks only on the
// tiles that cross the diagonal, the window edge or Sk, and the same online
// softmax in base 2 on the fragments (ex2.approx: its relative error,
// about 2^-22, is far inside the 2e-5 the kernel is held to).  The Q tile
// stays in shared memory in fp32 and is split per k-step (as hi/lo
// fragments in registers it would take 128 of them at hd = 128).  Inside
// each block of 8 columns the fragments take columns 2t and 2t + 1 as their
// k = t and t + 4, so A and B fragments of Q and K are float2 reads; the S
// accumulator (keys 2t, 2t + 1 of each 8) is then P's A fragment of P V as
// it stands, with V's B fragment reading rows 2t and 2t + 1: no shuffle.
// Rows are padded to hd + 8 floats (Q, K) and hd + 4 (V), which makes
// every fragment read free of bank conflicts; hd is zero-padded to HDP =
// 32, 64 or 128.  The output is written from the fragments (float2 stores
// when aligned).  At the LM prefill's shape a call needs 3 x 8.6 GFLOP of
// TF32 products: 52 us at the tensor cores' dense 494.7 TFLOP/s (a rate
// only wgmma reaches; this kernel runs mma.sync), against 25 us for its
// 84 MB.
#include "attention_mma.cuh"

#ifndef FLASH_TC_WARPS
#define FLASH_TC_WARPS 4   // warps of the fp16/bf16 kernel: BQ = 16 x this
#endif

namespace {

constexpr int HD_MAX = 128;
constexpr float MASKED = -1e30f;    // the Pallas kernel's NEG_INF

// A warp's S tile (rows wq0 + g and wq0 + g + 8, keys kt + 8 n + 2 t and
// + 1: the m16n8 accumulator layout) to scores in base 2: scaled by sl2 =
// scale * log2(e), masked ones -1e30, keys past Sk -inf (no weight at
// all); the mask is built only where the tile crosses the diagonal, the
// window edge or Sk.
template <int NT>
__device__ __forceinline__ void base2_scores(float (&s)[NT][4], int kt,
                                             int wq0, int Sk, int causal,
                                             int window, float sl2) {
  constexpr int BK = 8 * NT;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool edge = kt + BK > Sk || (causal && kt + BK - 1 > wq0) ||
                    (window > 0 && kt <= wq0 + 15 - window);
  if (edge) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kt + n * 8 + 2 * t + (e & 1);
        const int qi = wq0 + g + (e >> 1) * 8;
        const bool visible = (!causal || kj <= qi) &&
                             (window <= 0 || kj > qi - window);
        s[n][e] = kj >= Sk ? -INFINITY : visible ? s[n][e] * sl2 : MASKED;
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= sl2;
  }
}

// The online softmax of a base-2 score tile, on the fragments: per row (g,
// g + 8) the new max (pairwise trees, short dependency chains, then two
// shuffles in the quad), s overwritten by p = 2^(s - max) on the SFU, this
// thread's share of the row sum l, and the accumulator rescaled.
template <int NT, int DT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&acc)[DT][4]) {
  static_assert((NT & (NT - 1)) == 0, "NT a power of two");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float red[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) red[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
    for (int w = NT / 2; w > 0; w >>= 1)
#pragma unroll
      for (int i = 0; i < w; ++i) red[i] = fmaxf(red[i], red[i + w]);
    float mx = fmaxf(red[0], __shfl_xor_sync(FULL, red[0], 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float alpha = exp2_approx(m[r] - m_new);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][2 * r] = exp2_approx(s[n][2 * r] - m_new);
      s[n][2 * r + 1] = exp2_approx(s[n][2 * r + 1] - m_new);
      red[n] = s[n][2 * r] + s[n][2 * r + 1];
    }
#pragma unroll
    for (int w = NT / 2; w > 0; w >>= 1)
#pragma unroll
      for (int i = 0; i < w; ++i) red[i] += red[i + w];
    l[r] = l[r] * alpha + red[0];
    m[r] = m_new;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][2 * r] *= alpha;
      acc[i][2 * r + 1] *= alpha;
    }
  }
}

// ------------------------------------------------- fp32, 3xTF32 tensor cores
namespace tf32 {

// 8 warps and 64-key tiles (207 KB of shared memory at hd 128: one block
// an SM) beat 4 warps or 32-key tiles on the card (PERF.md)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16 * WARPS;      // query rows per block, 16 per warp
constexpr int BK = 64;              // keys per K/V tile
constexpr int NT = BK / 8;          // 8-key column tiles of S
constexpr int STAGES = 2;           // the K/V ring
constexpr int PV_GROUPS = 4;        // column groups of a tile's P V

// Row strides in floats: Q and K rows hd + 8 (8 mod 32 words, so that a
// fragment's float2 reads of 4 rows x 8 columns a half-warp hit every bank
// once), V rows hd + 4 (4 mod 32: the B fragment's reads of rows 2t and
// 2t + 1 x 8 columns hit every bank once).  One stage: its K tile, then
// its V tile; the Q tile after the stages.
template <int HDP> struct Layout {
  static constexpr int LQK = HDP + 8, LV = HDP + 4;
  static constexpr int KT = BK * LQK;
  static constexpr int ST = KT + BK * LV;
  static constexpr int FLOATS = STAGES * ST + BQ * LQK;
};

// rows [row0, row0 + ROWS) of a [S, hd] fp32 matrix (row stride `stride`
// floats) into shared memory [ROWS][LD], zero past S and past hd up to
// HDP.  `vec`: 16-byte cp.async (base and stride 16-byte aligned, hd % 4
// == 0); else element-wise loads.
template <int ROWS, int HDP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int row0, int S,
                                          int hd, bool vec) {
  if (vec) {
    constexpr int CPR = HDP / 4;   // 16-byte chunks a row
#pragma unroll
    for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * 4;
      float* d = dst + r * LD + col;
      if (row0 + r < S && col < hd)
        cp_async16(smem_u32(d), src + (row0 + r) * stride + col);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HDP; i += THREADS) {
      const int r = i / HDP, col = i % HDP, row = row0 + r;
      dst[r * LD + col] = row < S && col < hd ? src[row * stride + col] : 0.f;
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int BH, int H,
    int Hk, int Sq, int Sk, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int window, float scale,
    int vec) {
  using Ly = Layout<HDP>;
  constexpr int KS = HDP / 8;      // 8-column k-steps of S = Q K^T
  constexpr int DT = HDP / 8;      // 8-column tiles of the output
  constexpr int DG = DT / PV_GROUPS;   // of them in one group of P V
  static_assert(DT % PV_GROUPS == 0, "PV_GROUPS divides HDP / 8");
  extern __shared__ __align__(16) float f32_smem[];
  float* sq = f32_smem + STAGES * Ly::ST;   // [BQ][LQK]

  // the heaviest (last) causal query tiles first, every (b, h) of a q-tile
  // together
  const int bh = (int)blockIdx.x % BH;
  const int q0 = ((int)gridDim.x / BH - 1 - (int)blockIdx.x / BH) * BQ;
  const int b = bh / H, h = bh % H;
  const int hk = (int)((long long)h * Hk / H);
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  float* ob = o + b * osb + h * osh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // the fragment's row and column
  const int wq0 = q0 + warp * 16;          // the warp's first query row

  int k_begin, k_end;
  key_range(q0, min(q0 + BQ, Sq) - 1, Sk, causal, window, BK, &k_begin,
            &k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const float sl2 = scale * LOG2E;

  // tile i's K and V into stage i % STAGES, one commit group a tile (empty
  // past the last tile)
  auto load_kv = [&](int i) {
    if (i < n_tiles) {
      float* st = f32_smem + (i % STAGES) * Ly::ST;
      load_tile<BK, HDP, Ly::LQK>(st, kb, kss, k_begin + i * BK, Sk, hd, vec);
      load_tile<BK, HDP, Ly::LV>(st + Ly::KT, vb, vss, k_begin + i * BK, Sk,
                                 hd, vec);
    }
    cp_async_commit();
  };
  load_tile<BQ, HDP, Ly::LQK>(sq, qb, qss, q0, Sq, hd, vec);
  load_kv(0);

  float acc[DT][4];
  float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};   // rows g, g + 8
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  // this thread's A fragment of Q: rows g and g + 8, columns 2t and 2t + 1
  // of each 8-column step, which the fragment takes as its k = t and t + 4
  // (a sum order, not another function: K's B fragment reads the same
  // columns)
  const float* qf = sq + (warp * 16 + g) * Ly::LQK + 2 * t;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();   // tile it (and at first Q) has landed
    __syncthreads();      // ... for every thread, and tile it - 1 is read
    load_kv(it + 1);      // into the stage tile it - 1 used
    const int kt = k_begin + it * BK;
    // a tile wholly after the warp's last row is masked for all its rows,
    // each of which sees its own key elsewhere
    if (causal && kt > wq0 + 15) continue;
    const float* kst = f32_smem + (it % STAGES) * Ly::ST;
    const float* vst = kst + Ly::KT;

    // S = Q K^T, 3xTF32: K's B fragment for key 8n + g is one float2 read;
    // hi.hi and the small products in accumulators of their own, summed
    // once at the end
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    float sm[NT][4];   // the small products, apart from hi.hi
#pragma unroll
    for (int n = 0; n < NT; ++n)
      sm[n][0] = sm[n][1] = sm[n][2] = sm[n][3] = 0.0f;
    const float* kf = kst + g * Ly::LQK + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 top = *reinterpret_cast<const float2*>(qf + 8 * ks);
      const float2 bot =
          *reinterpret_cast<const float2*>(qf + 8 * Ly::LQK + 8 * ks);
      uint32_t ah[4], al[4];
      split(top.x, ah[0], al[0]);
      split(bot.x, ah[1], al[1]);
      split(top.y, ah[2], al[2]);
      split(bot.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 kk = *reinterpret_cast<const float2*>(
            kf + n * 8 * Ly::LQK + 8 * ks);
        uint32_t bh0, bl0, bh1, bl1;
        split(kk.x, bh0, bl0);
        split(kk.y, bh1, bl1);
        mma(sm[n], al, bh0, bh1);
        mma(sm[n], ah, bl0, bl1);
        mma(s[n], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = sm[n][e] + s[n][e];
    base2_scores(s, kt, wq0, Sk, causal, window, sl2);
    online_softmax(s, m, l, acc);

    // acc += P V, 8 keys a step.  P's accumulator layout (rows g, g + 8;
    // keys 2t, 2t + 1) is the A fragment {a0, a2, a1, a3} for k = t <->
    // key 2t and k = t + 4 <-> key 2t + 1, so V's B fragment reads rows 2t
    // and 2t + 1, column g of each 8-column tile: no shuffle.  The tile's
    // products go into fresh accumulators, PV_GROUPS groups of columns in
    // turn (registers), each then added to acc with one rounding
    const float* vf = vst + 2 * t * Ly::LV + g;
#pragma unroll
    for (int grp = 0; grp < PV_GROUPS; ++grp) {
      float tile[DG][4];
#pragma unroll
      for (int j = 0; j < DG; ++j)
        tile[j][0] = tile[j][1] = tile[j][2] = tile[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ph[4], pl[4];
        split(s[kk][0], ph[0], pl[0]);
        split(s[kk][2], ph[1], pl[1]);
        split(s[kk][1], ph[2], pl[2]);
        split(s[kk][3], ph[3], pl[3]);
        const float* vk = vf + 8 * kk * Ly::LV + 8 * DG * grp;
#pragma unroll
        for (int j = 0; j < DG; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split(vk[8 * j], bh0, bl0);
          split(vk[Ly::LV + 8 * j], bh1, bl1);
          mma3(tile[j], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int j = 0; j < DG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[DG * grp + j][e] += tile[j][e];
    }
  }
  cp_async_wait<0>();   // no copy in flight at exit

  // o = acc * (1 / max(l, 1e-30)), straight from the fragments (rows g,
  // g + 8; columns 2t, 2t + 1 of each 8-column tile)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
    const int qi = wq0 + g + 8 * r;
    if (lse != nullptr && t == 0 && qi < Sq)
      lse[(long long)bh * Sq + qi] = m[r] + log2f(fmaxf(l[r], 1e-30f));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    if (qi >= Sq) continue;
    float* orow = ob + qi * oss;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int col = i * 8 + 2 * t;
      const float o0 = acc[i][2 * r] * inv[r], o1 = acc[i][2 * r + 1] * inv[r];
      if (vec) {
        if (col < hd) *reinterpret_cast<float2*>(orow + col) = make_float2(o0, o1);
      } else {
        if (col < hd) orow[col] = o0;
        if (col + 1 < hd) orow[col + 1] = o1;
      }
    }
  }
}

template <int HDP>
int launch_hdp(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Hk, int Sq, int Sk, int hd,
               long long qsb, long long qsh, long long qss, long long ksb,
               long long ksh, long long kss, long long vsb, long long vsh,
               long long vss, long long osb, long long osh, long long oss,
               int causal, int window, float scale, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout<HDP>::FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<HDP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, B * H, H, Hk,
      Sq, Sk, hd, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
      causal, window, scale, vec);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int H, int Hk, int Sq, int Sk, int hd,
           long long qsb, long long qsh, long long qss, long long ksb,
           long long ksh, long long kss, long long vsb, long long vsh,
           long long vss, long long osb, long long osh, long long oss,
           int causal, int window, float scale, cudaStream_t stream) {
  // 16-byte copies: every base 16-byte aligned, every stride and hd a
  // multiple of 4 floats
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = hd % 4 == 0 && al(q) && al(k) && al(v) && al(o) &&
                   (qsb | qsh | qss | ksb | ksh | kss | vsb | vsh | vss |
                    osb | osh | oss) % 4 == 0;
  auto fn = hd <= 32   ? &launch_hdp<32>
            : hd <= 64 ? &launch_hdp<64>
                       : &launch_hdp<128>;
  return fn(q, k, v, o, lse, B, H, Hk, Sq, Sk, hd, qsb, qsh, qss, ksb, ksh,
            kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale, (int)vec,
            stream);
}

}  // namespace tf32

// ------------------------------------------------ fp16/bf16, tensor cores
namespace tc {

constexpr int WARPS = FLASH_TC_WARPS;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16 * WARPS;      // query rows per block, 16 per warp
constexpr int BK = 64;              // keys per K/V tile
constexpr int STAGES = 2;           // the K/V ring

constexpr int PAD = 8;              // elements (16 bytes) after each row

template <int HDP> size_t smem_bytes() {
  return sizeof(uint16_t) * (size_t)(2 * STAGES * BK + BQ) * (HDP + PAD);
}

// rows [row0, row0 + ROWS) of a [S, hd] matrix (row stride `stride`
// elements) into shared memory [ROWS][HDP + PAD], zero past S and past hd
// up to HDP.  `vec`: 16-byte cp.async (base and stride 16-byte aligned,
// hd % 8 == 0); else element-wise loads.
template <int ROWS, int HDP>
__device__ __forceinline__ void load_tile(uint16_t* dst,
                                          const uint16_t* src,
                                          long long stride, int row0, int S,
                                          int hd, bool vec) {
  constexpr int LDS = HDP + PAD;
  if (vec) {
    constexpr int CPR = HDP / 8;         // 16-byte chunks a row
    constexpr int RPP = THREADS / CPR;   // rows one pass of the block copies
    static_assert(THREADS % CPR == 0 && ROWS % RPP == 0, "tile shape");
    const int r = threadIdx.x / CPR, col = (threadIdx.x % CPR) * 8;
    const uint16_t* g = src + (row0 + r) * stride + col;
    uint16_t* d = dst + r * LDS + col;
#pragma unroll
    for (int j = 0; j < ROWS / RPP; ++j) {
      if (row0 + r + j * RPP < S && col < hd)
        cp_async16(smem_u32(d + j * RPP * LDS), g + j * RPP * stride);
      else
        *reinterpret_cast<uint4*>(d + j * RPP * LDS) = uint4{0, 0, 0, 0};
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HDP; i += THREADS) {
      const int r = i / HDP, col = i % HDP, row = row0 + r;
      dst[r * LDS + col] =
          row < S && col < hd ? src[row * stride + col] : (uint16_t)0;
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
    float* __restrict__ lse, int BH, int H,
    int Hk, int Sq, int Sk, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int window, float scale,
    int vec) {
  constexpr int LDS = HDP + PAD;
  constexpr int KS = HDP / 16;      // k-steps of S = Q K^T
  constexpr int NT = BK / 8;        // 8-key column tiles of S
  constexpr int DT = HDP / 8;       // 8-column tiles of the output
  constexpr int SST = 2 * BK * LDS; // one stage: its K tile, then its V tile
  extern __shared__ __align__(16) uint16_t tc_smem[];
  uint16_t* sq = tc_smem + STAGES * SST;       // [BQ][LDS]

  // the heaviest (last) causal query tiles first, every (b, h) of a q-tile
  // together
  const int bh = (int)blockIdx.x % BH;
  const int q0 = ((int)gridDim.x / BH - 1 - (int)blockIdx.x / BH) * BQ;
  const int b = bh / H, h = bh % H;
  const int hk = (int)((long long)h * Hk / H);
  const uint16_t* qb = q + b * qsb + h * qsh;
  const uint16_t* kb = k + b * ksb + hk * ksh;
  const uint16_t* vb = v + b * vsb + hk * vsh;
  uint16_t* ob = o + b * osb + h * osh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // the fragment's row and column
  const int wq0 = q0 + warp * 16;          // the warp's first query row

  int k_begin, k_end;
  key_range(q0, min(q0 + BQ, Sq) - 1, Sk, causal, window, BK, &k_begin,
            &k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const float sl2 = scale * LOG2E;

  // tile i's K and V into stage i % STAGES, one commit group a tile (empty
  // past the last tile, so that the wait below always counts the same)
  auto load_kv = [&](int i) {
    if (i < n_tiles) {
      uint16_t* st = tc_smem + (i % STAGES) * SST;
      load_tile<BK, HDP>(st, kb, kss, k_begin + i * BK, Sk, hd, vec);
      load_tile<BK, HDP>(st + BK * LDS, vb, vss, k_begin + i * BK, Sk, hd,
                         vec);
    }
    cp_async_commit();
  };
  load_tile<BQ, HDP>(sq, qb, qss, q0, Sq, hd, vec);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_kv(i);
  cp_async_wait<STAGES - 2>();   // Q and tile 0 have landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], smem_u32(sq + (warp * 16 + (lane & 15)) * LDS + ks * 16 +
                             (lane >> 4) * 8));

  float acc[DT][4];
  float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};   // rows g, g + 8
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it > 0) {
      cp_async_wait<STAGES - 2>();   // tile it has landed
      __syncthreads();   // ... for every thread, and tile it - 1 is read
    }
    load_kv(it + STAGES - 1);   // into the stage tile it - 1 used
    const int kt = k_begin + it * BK;
    // a tile wholly after the warp's last row is masked for all its rows,
    // each of which sees its own key elsewhere
    if (causal && kt > wq0 + 15) continue;
    const uint16_t* kst = tc_smem + (it % STAGES) * SST;
    const uint16_t* vst = kst + BK * LDS;
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_u32(kst + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                       LDS + ks * 16 + ((lane >> 3) & 1) * 8));
        mma<T>(s[2 * np], qf[ks], kf[0], kf[1]);
        mma<T>(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }
    base2_scores(s, kt, wq0, Sk, causal, window, sl2);
    online_softmax(s, m, l, acc);
    uint32_t pf[NT][2];   // P rounded to T: the A fragments of P V
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      pf[n][0] = pack2<T>(s[n][0], s[n][1]);
      pf[n][1] = pack2<T>(s[n][2], s[n][3]);
    }
    // acc += P V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                             pf[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, smem_u32(vst + (kk * 16 + (lane & 15)) * LDS +
                                   dp * 16 + (lane >> 4) * 8));
        mma<T>(acc[2 * dp], a, vf[0], vf[1]);
        mma<T>(acc[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
  }

  // o = acc / max(l, 1e-30) in T, staged in the warp's own 16 rows at the
  // start of shared memory once every warp is done with the tiles
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    const int qi = wq0 + g + 8 * r;
    if (lse != nullptr && t == 0 && qi < Sq)
      lse[(long long)bh * Sq + qi] = m[r] + log2f(l[r]);
  }
  cp_async_wait<0>();
  __syncthreads();
  uint16_t* sw = tc_smem + warp * 16 * LDS;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int col = i * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sw + g * LDS + col) =
        pack2<T>(acc[i][0] / l[0], acc[i][1] / l[0]);
    *reinterpret_cast<uint32_t*>(sw + (g + 8) * LDS + col) =
        pack2<T>(acc[i][2] / l[1], acc[i][3] / l[1]);
  }
  __syncwarp();
  if (vec) {
    const int cpr = hd / 8;
    for (int c = lane; c < 16 * cpr; c += 32) {
      const int r = c / cpr, col = (c % cpr) * 8, qi = wq0 + r;
      if (qi < Sq)
        *reinterpret_cast<uint4*>(ob + qi * oss + col) =
            *reinterpret_cast<const uint4*>(sw + r * LDS + col);
    }
  } else {
    for (int i = lane; i < 16 * hd; i += 32) {
      const int r = i / hd, col = i % hd, qi = wq0 + r;
      if (qi < Sq) ob[qi * oss + col] = sw[r * LDS + col];
    }
  }
}

template <typename T, int HDP>
int launch_hdp(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Hk, int Sq, int Sk, int hd,
               long long qsb, long long qsh, long long qss, long long ksb,
               long long ksh, long long kss, long long vsb, long long vsh,
               long long vss, long long osb, long long osh, long long oss,
               int causal, int window, float scale, int vec, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<T, HDP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), lse, B * H,
      H, Hk, Sq, Sk, hd, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb,
      osh, oss, causal, window, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int H, int Hk, int Sq, int Sk, int hd,
           long long qsb, long long qsh, long long qss, long long ksb,
           long long ksh, long long kss, long long vsb, long long vsh,
           long long vss, long long osb, long long osh, long long oss,
           int causal, int window, float scale, cudaStream_t stream) {
  // 16-byte copies: every base 16-byte aligned, every stride and hd a
  // multiple of 8 elements
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = hd % 8 == 0 && al(q) && al(k) && al(v) && al(o) &&
                   (qsb | qsh | qss | ksb | ksh | kss | vsb | vsh | vss |
                    osb | osh | oss) % 8 == 0;
  auto fn = hd <= 32   ? &launch_hdp<T, 32>
            : hd <= 64 ? &launch_hdp<T, 64>
                       : &launch_hdp<T, 128>;
  return fn(q, k, v, o, lse, B, H, Hk, Sq, Sk, hd, qsb, qsh, qss, ksb, ksh,
            kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale, (int)vec,
            stream);
}

}  // namespace tc

}  // namespace

// dtype: 0 fp32 (3xTF32 kernel), 1 fp16, 2 bf16 (fp16/bf16 kernel).
// Strides in elements; hd <= 128.  lse, when not null, is a contiguous
// float32 [B,H,Sq] that receives each row's base-2 log-sum-exp m + log2(l)
// (the scores pre-multiplied by scale * log2 e), which the backward kernel
// (flash_attention_backward.cu) reads; null writes nothing.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int H, int Hk, int Sq, int Sk, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int window, double scale,
    int dtype, void* stream) {
  if (hd < 1 || hd > HD_MAX || H % Hk != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = (float)scale;
  switch (dtype) {
    case 0:
      return tf32::launch(q, k, v, o, lse, B, H, Hk, Sq, Sk, hd, qsb, qsh, qss,
                          ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                          causal, window, sc, s);
    case 1:
      return tc::launch<__half>(q, k, v, o, lse, B, H, Hk, Sq, Sk, hd, qsb, qsh,
                                qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh,
                                oss, causal, window, sc, s);
    case 2:
      return tc::launch<__nv_bfloat16>(q, k, v, o, lse, B, H, Hk, Sq, Sk, hd,
                                       qsb,
                                       qsh, qss, ksb, ksh, kss, vsb, vsh,
                                       vss, osb, osh, oss, causal, window,
                                       sc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
