// Surrogate K-candidate screening scores for Hopper (sm_90a), 3xTF32 on
// the tensor cores.
//
// Replaces: src/repro/kernels/screen_score.py, `_screen_kernel` (pallas_call
// in `screen_scores_pallas`).  Same function as the plain version
// `repro_torch.kernels.screen_score.screen_scores_plain`:
//   x[b,k]   = [s[b] || cand[b,k]]                          (82)
//   pred     = gelu(gelu(x @ W1 + b1) @ W2 + b2) @ W3 + b3   (82->128->64->3)
//   score    = w[b,1]*pred0 + w[b,2]*pred2 - w[b,0]*pred1    [B, K]
// The argmin and the per-env gate select stay in torch, as in the reference.
//
// What bounds it on this card: at the search's shape (B = 64 envs, K = 4)
// the work is 9.7 MFLOP on 122 KB of inputs and weights: 0.06 us as
// 3xTF32 on the tensor cores (0.14 us of fp32 FMA).  What it really costs
// is the latency of one launch, of the weights' copies at entry and of
// three dependent layers, whose mma.sync issue on one SM a tile sets the
// pace.
//
// Design, and what it does about that: the B.K candidate rows go through
// fused_mlp's body (mlp_tf32.cuh: 3xTF32 mma.sync.m16n8k8, W1 and W2 by
// tensor copies into shared memory, 16-row tiles), so B = 64, K = 4 is 16
// tiles on 16 SMs, one CTA of one group each (two groups a CTA once the
// tiles outnumber the SMs).  Two choices of that body that fused_mlp does
// not take: layer 3's 8 k-blocks are split over the 8 warps and summed by
// warp 0, with each warp's W3 fragment read into registers at entry
// instead of staging W3 (SPLIT3: a chain of 3 mma a warp instead of 24 in
// one; at fused_mlp's d_out = 52 layer 3 is 7 n-tiles, and at d_out = 3
// the split would change its sums); and 8 warps a tile instead of 4 (two
// a sub-core; 4 were slower, 16 no faster).  A tile's
// rows are gathered as they load: b = row / K per row, since a tile may
// hold an env's candidates in part (K does not divide 16), rows past B.K
// zero-filled and never stored; s[b] in 16-byte and cand[b, k] in 8-byte
// pieces where s and cand are 16- and 8-byte aligned (a row of s is 208
// bytes, of cand 120), else in 4-byte ones; the env's weight row lands in
// words 88-90 of the row, past the products' k, and the epilogue reads it
// from there: pred2 is shuffled to the lane that holds pred0 and pred1,
// which adds the bias and combines the score in the plain version's order
// (no contraction into FMA).  No atomics and a fixed order of sums: the
// kernel is repeatable bit for bit.
#include "mlp_tf32.cuh"

namespace {

constexpr int S = 52;          // SAC state dim
constexpr int C = 30;          // continuous action dim
constexpr int IN = S + C;      // 82
constexpr int K1 = 88;         // IN rounded up to 8: then the weight row
constexpr int H1 = 128;
constexpr int H2 = 64;
constexpr int NT = 3;          // (power, perf, area) heads
constexpr int KMAX = 8;        // candidates an env
constexpr int COLW = 8;        // warps a 16-row tile
constexpr int GROUP = 32 * COLW;

// 8 or 16 bytes from global to shared memory, zeros where !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// rows r = b K + k of [s[b] || cand[b, k]] in, score [B, K] out
struct ScreenRows {
  static constexpr bool BF16 = false;
  const float* s;
  const float* cand;
  const float* weights;
  float* score;
  int n, K;   // rows (B K), candidates an env
  bool wide;  // s 16-byte and cand 8-byte aligned: wider copies
  __device__ int count() const { return n; }
  // start the copies of tile `tile`'s rows into `dst` [16][sx] by the
  // group's threads (gt), GROUP / 16 a row, zeros past the rows and past 82
  // (up to k1 = 88), and of each row's env weights into words 88-90 (past
  // the products' k, read by the epilogue).  Wide: s[b] as 13 pieces of 16
  // bytes (a row of s is 208 bytes, so 16-byte aligned where s is),
  // cand[b, k] as 15 of 8 (a row is 120 bytes), 3 pieces of 8 zero bytes;
  // else 4-byte pieces.
  template <int GROUP_>
  __device__ __forceinline__ void copy(float* dst, int tile, const Layout& L,
                                       int gt) const {
    static_assert(K1 + 3 <= 104, "the weight row within x's row stride");
    constexpr int TPR = GROUP_ / ROWS;             // threads a row
    const int r = gt / TPR, row = tile * ROWS + r;
    const bool in = row < n;
    const float* srow = s + (size_t)(in ? row / K : 0) * S;
    const float* crow = cand + (size_t)(in ? row : 0) * C;
    const float* wrow = weights + (size_t)(in ? row / K : 0) * 3;
    float* d = dst + r * L.sx;
    if (wide) {
      for (int p = gt % TPR; p < 34; p += TPR) {
        if (p < 13)
          cp_async16(d + 4 * p, srow + 4 * p, in);
        else if (p < 28)
          cp_async8(d + S + 2 * (p - 13), crow + 2 * (p - 13), in);
        else if (p < 31)
          cp_async8(d + IN + 2 * (p - 28), s, false);
        else
          cp_async4(d + K1 + p - 31, wrow + p - 31, in);
      }
    } else {
      for (int p = gt % TPR; p < K1 + 3; p += TPR) {
        const bool ok = in && (p < IN || p >= K1);
        cp_async4(d + p, !ok ? s : p < S ? srow + p
                         : p < IN ? crow + (p - S) : wrow + (p - K1), ok);
      }
    }
  }
  // what the epilogue needs of this tile's x buffer, read while it is
  // there: the env weights of rows g and g + 8, in warp 0's lanes (g, 0)
  struct Pro {
    float w[2][3];
  };
  template <int COLW_>
  __device__ __forceinline__ Pro prologue(const float* x, int sx,
                                          int c) const {
    Pro pro{};
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    if (c == 0 && t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 3; ++i)
          pro.w[h][i] = x[(g + 8 * h) * sx + K1 + i];
    }
    return pro;
  }
  // layer 3's one n-tile is warp 0's (columns 0-7, 3-7 zero): lane (g, t)
  // holds columns 2t, 2t + 1 of rows g and g + 8, so pred0 and pred1 sit in
  // lane (g, 0) and pred2 in lane (g, 1)
  template <int COLW_>
  __device__ __forceinline__ void store(const float (&acc)[ntw<COLW_>()][4],
                                        int tile, int c, int nt3,
                                        const float* sb3,
                                        const Pro& pro) const {
    if (nt3 == 0) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float top2 = __shfl_down_sync(0xffffffffu, acc[0][0], 1);
    const float bot2 = __shfl_down_sync(0xffffffffu, acc[0][2], 1);
    if (t != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tile * ROWS + g + 8 * h;
      if (row < n) {
        const float* w = pro.w[h];             // (perf, power, area)
        const float p0 = acc[0][2 * h] + sb3[0];
        const float p1 = acc[0][2 * h + 1] + sb3[1];
        const float p2 = (h ? bot2 : top2) + sb3[2];
        score[row] = __fsub_rn(__fadd_rn(__fmul_rn(w[1], p0),
                                         __fmul_rn(w[2], p2)),
                               __fmul_rn(w[0], p1));
      }
    }
  }
};

static_assert(split3_fits(H1, H2, NT, COLW),
              "SPLIT3's partial sums fit in h1's buffer");

template <int G>
__global__ void __launch_bounds__(GROUP * G, 1)
screen_kernel(const ScreenRows rows, const Weights w,
              const __grid_constant__ CUtensorMap w1map,
              const __grid_constant__ CUtensorMap w2map) {
  mlp_tiles<ScreenRows, G, COLW, true>(rows, w, IN, H1, H2, NT, &w1map,
                                       &w2map);
}

template <int G>
int launch(const ScreenRows& rows, const float* w1, const float* w2,
           const Weights& w, int device, int sms, cudaStream_t stream) {
  static bool ready[MAX_DEVICES];   // the shared-memory limit and carveout
  auto kernel = screen_kernel<G>;
  const Layout L(IN, H1, H2, NT, false, G);
  CUtensorMap m1, m2;
  const cudaError_t e =
      prepare(kernel, ready, device, L, w1, w2, IN, H1, H2, &m1, &m2);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ctas = ((rows.n + ROWS - 1) / ROWS + G - 1) / G;
  kernel<<<ctas < sms ? ctas : sms, GROUP * G, L.bytes(), stream>>>(
      rows, w, m1, m2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point bound with ctypes.  Device pointers of contiguous
// float32 tensors: s [B,52], cand [B,K,30], weights [B,3], w1 [82,128],
// b1 [128], w2 [128,64], b2 [64], w3 [64,3], b3 [3] (w1 and w2 16-byte
// aligned); out score [B,K].  1 <= K <= 8.  One CTA a tile of 16 rows
// while the tiles fit on the SMs, then two groups a CTA.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int screen_score_forward(
    const float* s, const float* cand, const float* weights,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, const float* b3, float* score, int B, int K,
    void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > KMAX || reinterpret_cast<uintptr_t>(w1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w2) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  const cudaError_t e = device_sms(&device, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool wide = reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cand) % 8 == 0;
  const ScreenRows rows{s, cand, weights, score, B * K, K, wide};
  const Weights w{b1, b2, w3, b3};
  const int tiles = (rows.n + ROWS - 1) / ROWS;
  auto run = tiles <= sms ? launch<1> : launch<2>;
  return run(rows, w1, w2, w, device, sms, static_cast<cudaStream_t>(stream));
}
