// Fused 3-layer tanh-GELU MLP for Hopper (sm_90a), 3xTF32 on the tensor
// cores.
//
// Replaces: src/repro/kernels/policy_mlp.py, `_mlp_kernel` (pallas_call in
// `fused_mlp_pallas`).  Same function as the plain version
// `repro_torch.kernels.policy_mlp.fused_mlp_plain` and the reference oracle
// `fused_mlp_reference`:
//   y = gelu(gelu(x @ W1 + b1) @ W2 + b2) @ W3 + b3     [B, d_in] -> [B, d_out]
// x is fp32 or bf16, the arithmetic fp32, y in x's type.  The search runs
// it as the surrogate (82 -> 128 -> 64 -> 3: calibration every dispatch
// while a gate is closed, and the MPC reward) and as the world model minus
// its residual (82 -> 128 -> 64 -> 52: the MPC rollout step).
//
// What bounds it on this card: 44 KFLOP per row.  At the MPC's B = 4,096 to
// 28,672 rows that is 0.18 to 1.26 GFLOP, an fp32 bound of 3 to 19 us
// (67 TFLOP/s); at the calibration's B = 448 rows the weights (76 KB) and
// the three dependent layers make it a matter of latency.
//
// Design, and what it does about that: one CTA an SM at most, of G groups
// of 4 warps (G = 1, 2 or 4 by B), each group walking over its own 16-row
// tiles while the weights are shared.  At entry thread 0 starts two tensor
// copies (TMA, completion counted on an mbarrier each): W1 and W2 whole,
// each as one box whose rows are padded in shared memory to a stride of 4
// mod 8 words and whose rows and columns past the tensor are zero-filled
// by the copy (K = 82 becomes 88).  W3 and the biases, too small or too
// ragged for a tensor map (W3's rows are 12 bytes at d_out = 3), and each
// group's first x tile come by 4-byte cp.async meanwhile, zero-padded the
// same way; x stays in its own type (fp32, or bf16 pairs).  Layer 1 starts
// as soon as W1 has landed, while W2 streams in, and each group's next x
// tile streams into its second buffer while the current one runs.  Each
// layer is mma.sync.m16n8k8 on TF32 operands: every fp32 operand is split
// as hi = tf32(a) (rounded), lo = a - hi (truncated to TF32 by the mma),
// and hi.hi goes to one accumulator, hi.lo + lo.hi to another (summed
// small first at the end), which keeps fp32's accuracy (a plain TF32
// product keeps 11 bits); a bf16 x is exact in TF32, so layer 1 then skips
// lo.hi.  A tile's columns are split over
// its group's 4 warps (8-column n-tiles c, c + 4, ...), so each warp runs
// a quarter of each layer, and activations pass between layers through
// shared memory at strides of 8 mod 32 words (the float2 A-fragment reads
// hit every bank once) under the group's named barrier.  Inside each block
// of 8 k the columns are taken in the order 2t, 2t + 1 for the fragment's
// t and t + 4, so that an A fragment is two float2 reads and a B fragment
// rows 2t and 2t + 1 (a sum order, not another function).  Every dot
// product starts from 0 and takes its bias last, as x @ W + b does; no
// atomics, so the kernel is deterministic and repeatable bit for bit.
// tanhf (accurate) in the GELU.  Widths: d_in <= 256 (the box's rows), h1
// and h2 multiples of 4 (16-byte rows for the tensor maps), h1, h2, d_out
// <= 128; W1 and W2 16-byte aligned; a bf16 x 4-byte aligned with d_in
// even.  The launch attributes and the SM count are read once a device.
#include <cuda.h>   // CUtensorMap; its encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GROUP = 128;     // 4 warps on one 16-row tile
constexpr int ROWS = 16;
constexpr int COL_WARPS = GROUP / 32;
constexpr int MAX_WIDTH = 128;
constexpr int MAX_DIN = 256;
constexpr int NTW = MAX_WIDTH / 8 / COL_WARPS;   // n-tiles a warp, at most
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SMEM = 232448;                 // a block's limit, 227 KB

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

// the 4 warps of group `grp` (named barrier 1 + grp; 0 is __syncthreads)
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

// acc[j] = A [16][kblocks * 8] . W [kblocks * 8][n-tile c + 4 j] for this
// warp's NT n-tiles, W in shared memory at stride sw: per block the
// products hi.hi into one accumulator and hi.lo + lo.hi into another
// (lo.hi skipped for a bf16 A), summed small first at the end.  NT is a
// constant, so each block's fragment reads are issued together.
template <bool BF16, int NT>
__device__ __forceinline__ void layer(const float* a, int sa, const float* w,
                                      int sw, int kblocks, int c,
                                      float (&acc)[NTW][4]) {
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
      b0[j] = wk[32 * j];
      b1[j] = wk[32 * j + sw];
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

template <bool BF16>
__device__ __forceinline__ void layer_n(const float* a, int sa, const float* w,
                                        int sw, int kblocks, int c,
                                        int ntiles, float (&acc)[NTW][4]) {
  static_assert(NTW == 4, "one case per n-tile count");
  switch (ntiles) {
    case 4: layer<BF16, 4>(a, sa, w, sw, kblocks, c, acc); break;
    case 3: layer<BF16, 3>(a, sa, w, sw, kblocks, c, acc); break;
    case 2: layer<BF16, 2>(a, sa, w, sw, kblocks, c, acc); break;
    case 1: layer<BF16, 1>(a, sa, w, sw, kblocks, c, acc); break;
    default: break;
  }
}

// bias, GELU and the float2 stores of this warp's n-tiles into h [16][sh]
__device__ __forceinline__ void hidden_out(const float (&acc)[NTW][4],
                                           const float* bias, int c,
                                           int ntiles, float* h, int sh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (j < ntiles) {
      const int col = 8 * (c + 4 * j) + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
      *reinterpret_cast<float2*>(h + g * sh + col) = make_float2(
          gelu_tanh(acc[j][0] + b0), gelu_tanh(acc[j][1] + b1));
      *reinterpret_cast<float2*>(h + (g + 8) * sh + col) = make_float2(
          gelu_tanh(acc[j][2] + b0), gelu_tanh(acc[j][3] + b1));
    }
  }
}

__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// start the copies of tile `tile`'s x into `dst` [16][sx] by the group's
// 128 threads (gt): 4-byte pieces (one fp32, or a bf16 pair: d_in even),
// zeros past B and d_in (up to k1)
template <typename T>
__device__ __forceinline__ void copy_x(float* dst, const T* x, int tile,
                                       int B, int din, const Layout& L,
                                       int gt) {
  constexpr int PER = 4 / sizeof(T);            // elements a piece
  static_assert(GROUP == 8 * ROWS, "8 threads a row");
  const int pieces = L.k1 / PER, r = gt >> 3, row = tile * ROWS + r;
  const T* src = x + (size_t)(row < B ? row : 0) * din;
  for (int p = gt & 7; p < pieces; p += 8) {
    const bool ok = row < B && p * PER < din;
    cp_async4(dst + r * L.sx + p, src + (ok ? p * PER : 0), ok);
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(GROUP * G, 1)
fused_mlp_kernel(const T* __restrict__ x, const float* __restrict__ b1,
                 const float* __restrict__ b2, const float* __restrict__ w3,
                 const float* __restrict__ b3, T* __restrict__ y, int B,
                 int din, int h1, int h2, int dout,
                 const __grid_constant__ CUtensorMap w1map,
                 const __grid_constant__ CUtensorMap w2map) {
  constexpr bool BF16 = sizeof(T) == 2;
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
  const int tiles = (B + ROWS - 1) / ROWS;
  const int stride = gridDim.x * G;
  int tile = blockIdx.x * G + grp;

  // 1. each group's first x tile; the weights: W1 and W2 by tensor copies
  // (one mbarrier each), W3 and the biases by 4-byte copies (zero-padded),
  // each thread's arriving on a third mbarrier when they land
  if (tile < tiles) copy_x(xs, x, tile, B, din, L, gt);
  cp_async_commit();
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_init(bars + 2, GROUP * G);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bars, sizeof(float) * L.k1 * L.s1);
    tensor_copy(sw1, &w1map, bars);
    mbar_expect_tx(bars + 1, sizeof(float) * L.k2 * L.s2);
    tensor_copy(sw2, &w2map, bars + 1);
  }
  __syncthreads();   // the mbarriers are initialised before any arrival
  const int dout8 = up(dout, 8);
  for (int i = tid; i < L.k3 * L.s3; i += GROUP * G) {
    const int r = i / L.s3, col = i - r * L.s3;
    const bool ok = r < h2 && col < dout;
    cp_async4(sw3 + i, w3 + (ok ? r * dout + col : 0), ok);
  }
  for (int i = tid; i < L.k2; i += GROUP * G) cp_async4(sb1 + i, b1 + i, i < h1);
  for (int i = tid; i < L.k3; i += GROUP * G) cp_async4(sb2 + i, b2 + i, i < h2);
  for (int i = tid; i < dout8; i += GROUP * G)
    cp_async4(sb3 + i, b3 + i, i < dout);
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bars + 2)) : "memory");

  // this warp's n-tiles in each layer: c, c + 4, ...
  const int nt1 = (L.k2 / 8 - c + COL_WARPS - 1) / COL_WARPS;
  const int nt2 = (L.k3 / 8 - c + COL_WARPS - 1) / COL_WARPS;
  const int nt3 = (dout8 / 8 - c + COL_WARPS - 1) / COL_WARPS;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float acc[NTW][4];
  for (int buf = 0; tile < tiles; tile += stride, buf ^= 1) {
    // 2. the next tile's x streams into the other buffer (read by this
    // group's layer 1 of the previous tile, before two group barriers)
    if (tile + stride < tiles)
      copy_x(xs + (buf ^ 1) * xbuf, x, tile + stride, B, din, L, gt);
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    group_sync(grp);   // this tile's x has landed, h1 and h2 are free
    // 3. layer 1 into hs1 (W1, then the biases and W3)
    mbar_wait(bars);
    layer_n<BF16>(xs + buf * xbuf, L.sx, sw1, L.s1, L.k1 / 8, c, nt1, acc);
    mbar_wait(bars + 2);
    hidden_out(acc, sb1, c, nt1, hs1, L.sh1);
    group_sync(grp);
    // 4. layer 2 into hs2
    mbar_wait(bars + 1);
    layer_n<false>(hs1, L.sh1, sw2, L.s2, L.k2 / 8, c, nt2, acc);
    hidden_out(acc, sb2, c, nt2, hs2, L.sh2);
    group_sync(grp);
    // 5. layer 3 and the output (rows g, g + 8; columns 2t, 2t + 1)
    layer_n<false>(hs2, L.sh2, sw3, L.s3, L.k3 / 8, c, nt3, acc);
    const int row0 = tile * ROWS;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (j < nt3) {
        const int col = 8 * (c + 4 * j) + 2 * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + g + 8 * (i >> 1), cc = col + (i & 1);
          if (r < B && cc < dout)
            store_f(y, (size_t)r * dout + cc, acc[j][i] + sb3[cc]);
        }
      }
    }
  }
  // a group without tiles still has copies of W3 and the biases in flight
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// cuTensorMapEncodeTiled's type (the driver's, found through the runtime)
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

template <typename T, int G>
int launch(const void* x, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, void* y, int B,
           int din, int h1, int h2, int dout, int device, int sms,
           cudaStream_t stream) {
  static bool ready[MAX_DEVICES];   // the shared-memory limit and carveout
  auto kernel = fused_mlp_kernel<T, G>;
  if (!ready[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[device] = true;
  }
  const Layout L(din, h1, h2, dout, sizeof(T) == 2, G);
  if (L.bytes() > static_cast<size_t>(MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m1, m2;
  cudaError_t e = weight_map(&m1, w1, din, h1, L.k1, L.s1);
  if (e == cudaSuccess) e = weight_map(&m2, w2, h1, h2, L.k2, L.s2);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ctas = ((B + ROWS - 1) / ROWS + G - 1) / G;
  kernel<<<ctas < sms ? ctas : sms, GROUP * G, L.bytes(), stream>>>(
      static_cast<const T*>(x), b1, b2, w3, b3, static_cast<T*>(y), B, din,
      h1, h2, dout, m1, m2);
  return static_cast<int>(cudaGetLastError());
}

// Groups of 4 warps a CTA (one CTA an SM, each group its own 16-row
// tiles, the weights shared): 1 while the tiles fit on the SMs one to a
// CTA, then 2, then 4.  -DMLP_GROUPS=1, 2 or 4 forces one
// (scripts/search_kernels_ab.py times them).
template <typename T>
int dispatch(const void* x, const float* w1, const float* b1, const float* w2,
             const float* b2, const float* w3, const float* b3, void* y, int B,
             int din, int h1, int h2, int dout, cudaStream_t stream) {
  static int sms[MAX_DEVICES];      // the SM count, read once a device
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                               device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (B + ROWS - 1) / ROWS;
#ifdef MLP_GROUPS
  const int groups = MLP_GROUPS;
#else
  const int groups = tiles <= sms[device] ? 1 : tiles <= 2 * sms[device] ? 2
                                                                         : 4;
#endif
  auto run = groups == 1 ? launch<T, 1> : groups == 2 ? launch<T, 2>
                                                      : launch<T, 4>;
  return run(x, w1, b1, w2, b2, w3, b3, y, B, din, h1, h2, dout, device,
             sms[device], stream);
}

}  // namespace

// Plain C entry point bound with ctypes.  Device pointers of contiguous
// tensors: x [B, din] (float32, or bfloat16 if bf16 != 0), w1 [din, h1],
// b1 [h1], w2 [h1, h2], b2 [h2], w3 [h2, dout], b3 [dout] (float32; w1 and
// w2 16-byte aligned); out y [B, dout] in x's type.  din <= 256, h1 and h2
// multiples of 4, h1, h2, dout <= 128; a bf16 x 4-byte aligned, din even.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int fused_mlp_forward(const void* x, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* b2, const float* w3,
                                 const float* b3, void* y, int B, int din,
                                 int h1, int h2, int dout, int bf16,
                                 void* stream) {
  if (B <= 0) return 0;
  if (din < 1 || din > MAX_DIN || h1 < 4 || h2 < 4 || dout < 1 ||
      h1 > MAX_WIDTH || h2 > MAX_WIDTH || dout > MAX_WIDTH || h1 % 4 != 0 ||
      h2 % 4 != 0 || reinterpret_cast<uintptr_t>(w1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w2) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16 && (din % 2 != 0 || reinterpret_cast<uintptr_t>(x) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, y, B, din,
                                        h1, h2, dout, s)
              : dispatch<float>(x, w1, b1, w2, b2, w3, b3, y, B, din, h1, h2,
                                dout, s);
}
