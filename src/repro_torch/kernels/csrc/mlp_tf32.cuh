// The 3-layer tanh-GELU MLP body on Hopper's tensor cores in 3xTF32,
// shared by `fused_mlp` (policy_mlp.cu: rows of x, a [B, d_out] store) and
// `screen_score` (screen_score.cu: rows [s[b] || cand[b, k]] gathered as
// they load, the score combined in the epilogue).  Each kernel gives the
// tile loop `mlp_tiles` a row source: `count()` rows; `copy()`, which
// starts the copies of one 16-row tile's x into shared memory (zeros past
// the rows and past d_in); `prologue()`, what the epilogue needs of that
// x tile, read while it is there; and `store()`, the epilogue of layer 3's
// fragments.
//
//   y = gelu(gelu(x @ W1 + b1) @ W2 + b2) @ W3 + b3
//
// A tile's 16 rows belong to one group of COLW warps, which split each
// layer's 8-column n-tiles (c, c + COLW, ...); G groups a CTA, each
// walking over its own tiles while the weights are shared.  First thing
// at entry, thread 0 starts two tensor copies (TMA, completion counted on
// an mbarrier each): W1 and W2 whole, each as one box whose rows are
// padded in shared memory to a stride of 4 mod 8 words and whose rows and
// columns past the tensor are zero-filled by the copy (K = 82 becomes 88).
// Each group's first x tile, then W3 and the biases, too small or too
// ragged for a tensor map (W3's rows are 12 bytes at d_out = 3), come by
// cp.async meanwhile, zero-padded the same way.  Layer 1 starts as soon
// as W1 has landed, while W2 streams in, and each group's next x tile
// streams into its second buffer while the current one runs.  Each layer is
// mma.sync.m16n8k8 on TF32 operands: every fp32 operand is split as hi =
// tf32(a) (rounded), lo = a - hi (truncated to TF32 by the mma), and hi.hi
// goes to one accumulator, hi.lo + lo.hi to another (summed small first at
// the end), which keeps fp32's accuracy (a plain TF32 product keeps 11
// bits); a bf16 x is exact in TF32, so layer 1 then skips lo.hi.
// Activations pass between layers through shared memory at strides of 8
// mod 32 words (the float2 A-fragment reads hit every bank once) under the
// group's named barrier.  Inside each block of 8 k the columns are taken
// in the order 2t, 2t + 1 for the fragment's t and t + 4, so that an A
// fragment is two float2 reads and a B fragment rows 2t and 2t + 1 (a sum
// order, not another function).  Every dot product starts from 0 and
// takes its bias last, as x @ W + b does; no atomics, so a kernel is
// deterministic and repeatable bit for bit.  tanhf (accurate) in the
// GELU.  Widths: d_in <= 256 (the box's rows), h1 and h2 multiples of 4
// (16-byte rows for the tensor maps), h1, h2, d_out <= 128; W1 and W2
// 16-byte aligned.
#pragma once

#include <cuda.h>   // CUtensorMap; its encoder is looked up at run time
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS = 16;                         // rows a tile (the mma's m)
constexpr int MAX_WIDTH = 128;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SMEM = 232448;                 // a block's limit, 227 KB

// n-tiles of 8 columns a warp holds at most, with COLW column warps
template <int COLW>
__host__ __device__ constexpr int ntw() {
  return MAX_WIDTH / 8 / COLW;
}

__host__ __device__ constexpr int up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory, in 4-byte words, from the widths and the groups G.
// Weights [k][s]: k rows (the layer's input width rounded up to 8), stride
// s = columns rounded up to 8, plus 4 (so rows 2t and 2t + 1 of a B
// fragment fall in distinct banks); then per group two x buffers in x's
// type (fp32 [16][s], s = 8 mod 32 words, for float2 A-fragment reads;
// bf16 [16][s] pairs, s = 4 mod 8 words) and h1, h2 [16][s], s = 8 mod 32.
// Regions 128-byte aligned.
struct Layout {
  int k1, s1, k2, s2, k3, s3, sx, sh1, sh2;
  int w1, w2, w3, b1, b2, b3, grp, xs, h1, h2, group_words, words;
  __host__ __device__ Layout(int din, int h1w, int h2w, int dout, bool bf16,
                             int groups) {
    k1 = up(din, 8);
    s1 = up(h1w, 8) + 4;
    k2 = up(h1w, 8);
    s2 = up(h2w, 8) + 4;
    k3 = up(h2w, 8);
    s3 = up(dout, 8) + 4;
    sx = bf16 ? up(k1 / 2, 8) + 4 : up(k1, 32) + 8;
    sh1 = up(k2, 32) + 8;
    sh2 = up(k3, 32) + 8;
    w1 = 0;
    w2 = w1 + up(k1 * s1, 32);
    w3 = w2 + up(k2 * s2, 32);
    b1 = w3 + up(k3 * s3, 32);
    b2 = b1 + up(k2, 32);
    b3 = b2 + up(k3, 32);
    grp = b3 + up(dout, 32);
    xs = 0;                                  // within a group's region
    h1 = xs + 2 * up(ROWS * sx, 32);
    h2 = h1 + up(ROWS * sh1, 32);
    group_words = h2 + up(ROWS * sh2, 32);
    words = grp + groups * group_words;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * words + 3 * sizeof(uint64_t);
  }
};

// the weights' device pointers (W1 and W2 are read through tensor maps)
struct Weights {
  const float *b1, *b2, *w3, *b3;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for phase 0 of `bar` (returns at once after it has completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)) : "memory");
}

// tensor copy (TMA) of the box at (0, 0) of `map` into shared memory,
// counted on `bar`
__device__ __forceinline__ void tensor_copy(float* dst, const CUtensorMap* map,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(0),
      "r"(smem_addr(bar)) : "memory");
}

// 4 bytes from global to shared memory, zeros where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the warps of group `grp` (named barrier 1 + grp; 0 is __syncthreads)
template <int GROUP>
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(GROUP) : "memory");
}

// a = hi + lo: hi = a rounded to TF32 (to nearest, ties away from zero:
// add half a TF32 ulp to the bits and clear the 13 bits TF32 drops, as
// cvt.rna.tf32.f32 does for finite a, in 2 instructions instead of the
// ~5 that instruction takes on this card), lo = a - hi (exact), passed as
// it is: the mma reads a TF32 operand's top 19 bits, so lo is truncated
// to TF32 there, an error of at most 2^-21 |a|
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of block kb (rows g, g + 8; the fragment's k = t and
// t + 4 are columns 8 kb + 2t and 8 kb + 2t + 1), split into TF32 hi and
// lo: from fp32 [16][sa] (two float2 reads), or from bf16 pairs [16][sa]
// (one word each, exact in TF32: lo = 0).
template <bool BF16>
__device__ __forceinline__ void a_frag(const float* a, int sa, int kb,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (BF16) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a);
    const uint32_t top = w[g * sa + 4 * kb + t];
    const uint32_t bot = w[(g + 8) * sa + 4 * kb + t];
    ah[0] = top << 16;
    ah[1] = bot << 16;
    ah[2] = top & 0xffff0000u;
    ah[3] = bot & 0xffff0000u;
    al[0] = al[1] = al[2] = al[3] = 0u;
  } else {
    const float2 top =
        *reinterpret_cast<const float2*>(a + g * sa + 8 * kb + 2 * t);
    const float2 bot =
        *reinterpret_cast<const float2*>(a + (g + 8) * sa + 8 * kb + 2 * t);
    split(top.x, ah[0], al[0]);
    split(bot.x, ah[1], al[1]);
    split(top.y, ah[2], al[2]);
    split(bot.y, ah[3], al[3]);
  }
}

// acc[j] = A [16][kblocks * 8] . W [kblocks * 8][n-tile c + COLW j] for
// this warp's NT n-tiles, W in shared memory at stride sw: per block the
// products hi.hi into one accumulator and hi.lo + lo.hi into another
// (lo.hi skipped for a bf16 A), summed small first at the end.  NT is a
// constant, so each block's fragment reads are issued together.
template <bool BF16, int NT, int COLW>
__device__ __forceinline__ void layer(const float* a, int sa, const float* w,
                                      int sw, int kblocks, int c,
                                      float (&acc)[ntw<COLW>()][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float big[NT][4], small[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) big[j][i] = small[j][i] = 0.0f;
  const float* wr = w + 2 * t * sw + g + 8 * c;
#pragma unroll 2
  for (int kb = 0; kb < kblocks; ++kb) {
    uint32_t ah[4], al[4];
    a_frag<BF16>(a, sa, kb, ah, al);
    const float* wk = wr + 8 * kb * sw;
    float b0[NT], b1[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b0[j] = wk[8 * COLW * j];
      b1[j] = wk[8 * COLW * j + sw];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split(b0[j], bh0, bl0);
      split(b1[j], bh1, bl1);
      if (!BF16) mma(small[j], al, bh0, bh1);
      mma(small[j], ah, bl0, bl1);
      mma(big[j], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = small[j][i] + big[j][i];
}

template <bool BF16, int COLW>
__device__ __forceinline__ void layer_n(const float* a, int sa, const float* w,
                                        int sw, int kblocks, int c,
                                        int ntiles,
                                        float (&acc)[ntw<COLW>()][4]) {
  static_assert(ntw<COLW>() <= 4, "one case per n-tile count");
  switch (ntiles) {
    case 4:
      if constexpr (ntw<COLW>() >= 4)
        layer<BF16, 4, COLW>(a, sa, w, sw, kblocks, c, acc);
      break;
    case 3:
      if constexpr (ntw<COLW>() >= 3)
        layer<BF16, 3, COLW>(a, sa, w, sw, kblocks, c, acc);
      break;
    case 2:
      if constexpr (ntw<COLW>() >= 2)
        layer<BF16, 2, COLW>(a, sa, w, sw, kblocks, c, acc);
      break;
    case 1: layer<BF16, 1, COLW>(a, sa, w, sw, kblocks, c, acc); break;
    default: break;
  }
}

// bias, GELU and the float2 stores of this warp's n-tiles into h [16][sh]
template <int COLW>
__device__ __forceinline__ void hidden_out(const float (&acc)[ntw<COLW>()][4],
                                           const float* bias, int c,
                                           int ntiles, float* h, int sh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < ntw<COLW>(); ++j) {
    if (j < ntiles) {
      const int col = 8 * (c + COLW * j) + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
      *reinterpret_cast<float2*>(h + g * sh + col) = make_float2(
          gelu_tanh(acc[j][0] + b0), gelu_tanh(acc[j][1] + b1));
      *reinterpret_cast<float2*>(h + (g + 8) * sh + col) = make_float2(
          gelu_tanh(acc[j][2] + b0), gelu_tanh(acc[j][3] + b1));
    }
  }
}

// whether SPLIT3 can run at these widths: layer 3 one n-tile (dout <= 8)
// and the partial sums, [P][2][32][4] words, within h1's buffer [16][sh1]
__host__ __device__ constexpr bool split3_fits(int h1, int h2, int dout,
                                               int colw) {
  return dout <= 8 && h1 <= MAX_WIDTH && h2 <= MAX_WIDTH &&
         (up(h2, 8) / 8 < colw ? up(h2, 8) / 8 : colw) * 2 * 32 * 4 <=
             ROWS * (up(up(h1, 8), 32) + 8);
}

// Layer 3 of one n-tile (d_out <= 8) with its k-blocks split over the
// group's warps: warp c < P = min(COLW, kblocks) takes blocks c, c + P, ...
// (at most ntw<COLW>() of them: h2 <= 128).  w3_frags reads that warp's B
// fragments of W3 [h2][dout] straight into registers (rows 8 kb + 2t and
// 8 kb + 2t + 1, column g; zeros past W3); layer3_split runs them into
// accumulators of the warp's own and stores them to `part` [P][2][32][4]
// (2,048 words at most while kblocks <= 8); after the group's barrier warp
// 0 adds them in the order of c, hi.hi and the small products apart, then
// small + big.
template <int COLW>
__device__ __forceinline__ void w3_frags(const float* __restrict__ w3, int h2,
                                         int dout, int c,
                                         float (&f)[ntw<COLW>()][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kblocks = up(h2, 8) / 8, parts = kblocks < COLW ? kblocks : COLW;
#pragma unroll
  for (int i = 0; i < ntw<COLW>(); ++i) {
    const int kb = c + parts * i, r = 8 * kb + 2 * t;
    const bool ok = c < parts && kb < kblocks && g < dout;
    f[i][0] = ok && r < h2 ? __ldg(w3 + r * dout + g) : 0.0f;
    f[i][1] = ok && r + 1 < h2 ? __ldg(w3 + (r + 1) * dout + g) : 0.0f;
  }
}

template <int COLW>
__device__ __forceinline__ void layer3_split(const float* a, int sa,
                                             const float (&f)[ntw<COLW>()][2],
                                             int kblocks, int c, int grp,
                                             float* part,
                                             float (&acc)[ntw<COLW>()][4]) {
  const int lane = threadIdx.x & 31;
  float big[4] = {0.0f, 0.0f, 0.0f, 0.0f}, small[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int parts = kblocks < COLW ? kblocks : COLW;
#pragma unroll
  for (int i = 0; i < ntw<COLW>(); ++i) {
    const int kb = c + parts * i;
    if (c < parts && kb < kblocks) {
      uint32_t ah[4], al[4];
      a_frag<false>(a, sa, kb, ah, al);
      uint32_t bh0, bl0, bh1, bl1;
      split(f[i][0], bh0, bl0);
      split(f[i][1], bh1, bl1);
      mma(small, al, bh0, bh1);
      mma(small, ah, bl0, bl1);
      mma(big, ah, bh0, bh1);
    }
  }
  float4* p = reinterpret_cast<float4*>(part);
  if (c < parts) {
    p[2 * 32 * c + lane] = make_float4(big[0], big[1], big[2], big[3]);
    p[2 * 32 * c + 32 + lane] =
        make_float4(small[0], small[1], small[2], small[3]);
  }
  group_sync<32 * COLW>(grp);
  if (c != 0) return;
  float4 bs = p[lane], ss = p[32 + lane];
  for (int v = 1; v < parts; ++v) {
    const float4 b = p[2 * 32 * v + lane], s = p[2 * 32 * v + 32 + lane];
    bs = make_float4(bs.x + b.x, bs.y + b.y, bs.z + b.z, bs.w + b.w);
    ss = make_float4(ss.x + s.x, ss.y + s.y, ss.z + s.z, ss.w + s.w);
  }
  acc[0][0] = ss.x + bs.x;
  acc[0][1] = ss.y + bs.y;
  acc[0][2] = ss.z + bs.z;
  acc[0][3] = ss.w + bs.w;
}

// The kernel body: G groups of COLW warps a CTA, each group walking over
// its own 16-row tiles of `rows` (Rows::BF16: x in bf16 pairs), W1 and W2
// through the tensor maps, the rest from `w`.  SPLIT3 (only where
// split3_fits: the caller asserts it at its widths): layer 3's k-blocks
// split over the warps, W3 read into registers at entry instead of shared
// memory.  The dynamic shared memory is Layout(din, h1, h2, dout,
// Rows::BF16, G).bytes().
template <class Rows, int G, int COLW, bool SPLIT3 = false>
__device__ __forceinline__ void mlp_tiles(const Rows& rows, const Weights& w,
                                          int din, int h1, int h2, int dout,
                                          const CUtensorMap* w1map,
                                          const CUtensorMap* w2map) {
  constexpr bool BF16 = Rows::BF16;
  constexpr int GROUP = 32 * COLW;
  extern __shared__ __align__(128) float sm[];
  const Layout L(din, h1, h2, dout, BF16, G);
  float* sw1 = sm + L.w1;
  float* sw2 = sm + L.w2;
  float* sw3 = sm + L.w3;
  float* sb1 = sm + L.b1;
  float* sb2 = sm + L.b2;
  float* sb3 = sm + L.b3;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.words);
  const int tid = threadIdx.x, grp = tid / GROUP, gt = tid % GROUP;
  const int c = gt >> 5;                       // this warp's column share
  float* xs = sm + L.grp + grp * L.group_words + L.xs;
  float* hs1 = sm + L.grp + grp * L.group_words + L.h1;
  float* hs2 = sm + L.grp + grp * L.group_words + L.h2;
  const int xbuf = up(ROWS * L.sx, 32);        // words between x buffers
  const int tiles = (rows.count() + ROWS - 1) / ROWS;
  const int stride = gridDim.x * G;
  int tile = blockIdx.x * G + grp;

  // 1. the weights: W1 and W2 by tensor copies (one mbarrier each), started
  // by thread 0 first of all; each group's first x tile; W3 (unless SPLIT3
  // reads its fragments into registers) and the biases by 4-byte copies
  // (zero-padded), each thread's arriving on a third mbarrier when they
  // land
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_init(bars + 2, GROUP * G);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bars, sizeof(float) * L.k1 * L.s1);
    tensor_copy(sw1, w1map, bars);
    mbar_expect_tx(bars + 1, sizeof(float) * L.k2 * L.s2);
    tensor_copy(sw2, w2map, bars + 1);
  }
  float w3f[ntw<COLW>()][2];   // SPLIT3: this warp's fragments of W3
  if constexpr (SPLIT3) w3_frags<COLW>(w.w3, h2, dout, c, w3f);
  if (tile < tiles) rows.template copy<GROUP>(xs, tile, L, gt);
  cp_async_commit();
  __syncthreads();   // the mbarriers are initialised before any arrival
  const int dout8 = up(dout, 8);
  for (int i = tid; i < (SPLIT3 ? 0 : L.k3 * L.s3); i += GROUP * G) {
    const int r = i / L.s3, col = i - r * L.s3;
    const bool ok = r < h2 && col < dout;
    cp_async4(sw3 + i, w.w3 + (ok ? r * dout + col : 0), ok);
  }
  for (int i = tid; i < L.k2; i += GROUP * G)
    cp_async4(sb1 + i, w.b1 + i, i < h1);
  for (int i = tid; i < L.k3; i += GROUP * G)
    cp_async4(sb2 + i, w.b2 + i, i < h2);
  for (int i = tid; i < dout8; i += GROUP * G)
    cp_async4(sb3 + i, w.b3 + i, i < dout);
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bars + 2)) : "memory");

  // this warp's n-tiles in each layer: c, c + COLW, ...
  const int nt1 = (L.k2 / 8 - c + COLW - 1) / COLW;
  const int nt2 = (L.k3 / 8 - c + COLW - 1) / COLW;
  const int nt3 = (dout8 / 8 - c + COLW - 1) / COLW;
  float acc[ntw<COLW>()][4];
  for (int buf = 0; tile < tiles; tile += stride, buf ^= 1) {
    // 2. the next tile's x streams into the other buffer (read by this
    // group's layer 1 of the previous tile, before two group barriers)
    if (tile + stride < tiles)
      rows.template copy<GROUP>(xs + (buf ^ 1) * xbuf, tile + stride, L, gt);
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    group_sync<GROUP>(grp);   // this tile's x has landed, h1 and h2 are free
    const auto pro = rows.template prologue<COLW>(xs + buf * xbuf, L.sx, c);
    // 3. layer 1 into hs1 (W1, then the biases and W3)
    mbar_wait(bars);
    layer_n<BF16, COLW>(xs + buf * xbuf, L.sx, sw1, L.s1, L.k1 / 8, c, nt1,
                        acc);
    mbar_wait(bars + 2);
    hidden_out<COLW>(acc, sb1, c, nt1, hs1, L.sh1);
    group_sync<GROUP>(grp);
    // 4. layer 2 into hs2
    mbar_wait(bars + 1);
    layer_n<false, COLW>(hs1, L.sh1, sw2, L.s2, L.k2 / 8, c, nt2, acc);
    hidden_out<COLW>(acc, sb2, c, nt2, hs2, L.sh2);
    group_sync<GROUP>(grp);
    // 5. layer 3 and the epilogue (rows g, g + 8; columns 2t, 2t + 1)
    if constexpr (SPLIT3)   // (hs1 is free: layer 2 has read it)
      layer3_split<COLW>(hs2, L.sh2, w3f, L.k3 / 8, c, grp, hs1, acc);
    else
      layer_n<false, COLW>(hs2, L.sh2, sw3, L.s3, L.k3 / 8, c, nt3, acc);
    rows.template store<COLW>(acc, tile, c, nt3, sb3, pro);
  }
  // a group without tiles still has copies of W3 and the biases in flight
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// cuTensorMapEncodeTiled's type (a CUDA library entry point, looked up
// through the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// w [rows][cols] as a tensor map of one box of box_rows x box_cols (past
// the tensor's rows and columns the box reads zeros)
cudaError_t weight_map(CUtensorMap* map, const float* w, int rows, int cols,
                       int box_rows, int box_cols) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {sizeof(float) * cols};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The current device and its SM count (read once a device).
cudaError_t device_sms(int* device, int* sms) {
  static int count[MAX_DEVICES];
  cudaError_t e = cudaGetDevice(device);
  if (e != cudaSuccess) return e;
  if (*device < 0 || *device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (count[*device] == 0) {
    e = cudaDeviceGetAttribute(&count[*device],
                               cudaDevAttrMultiProcessorCount, *device);
    if (e != cudaSuccess) return e;
  }
  *sms = count[*device];
  return cudaSuccess;
}

// Once a device and kernel: the shared-memory limit raised to MAX_SMEM and
// the carveout to shared memory; then W1's and W2's tensor maps (boxes of
// Layout L's padded rows).
template <class Kernel>
cudaError_t prepare(Kernel kernel, bool (&ready)[MAX_DEVICES], int device,
                    const Layout& L, const float* w1, const float* w2,
                    int din, int h1, int h2, CUtensorMap* m1,
                    CUtensorMap* m2) {
  if (!ready[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  if (L.bytes() > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  cudaError_t e = weight_map(m1, w1, din, h1, L.k1, L.s1);
  if (e == cudaSuccess) e = weight_map(m2, w2, h1, h2, L.k2, L.s2);
  return e;
}

}  // namespace
