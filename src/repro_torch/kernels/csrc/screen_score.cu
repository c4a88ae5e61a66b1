// Surrogate K-candidate screening scores for Hopper (sm_90a), fp32 FMA.
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
// the work is 9.7 MFLOP on 122 KB of inputs and weights, a 0.14 us fp32
// bound on the H100; a single launch of a few microseconds is what it
// really costs.
//
// Design, and what it does about that: one block per env scores that env's
// K candidate rows (B = 64 blocks), so every SM that has work runs one
// short dependent chain of three layers.  The 76 KB of weights are read
// through L2 (each block reads every weight once and uses it for all K rows
// held in registers), which avoids staging them in shared memory: a block
// never re-reads a weight, so a shared-memory copy would only add a pass.
// Sums run in a fixed order with no atomics, so the kernel is
// deterministic.  fp32 FMA only.
#include <cuda_runtime.h>

namespace {

constexpr int S = 52;          // SAC state dim
constexpr int C = 30;          // continuous action dim
constexpr int IN = S + C;      // 82
constexpr int H1 = 128;
constexpr int H2 = 64;
constexpr int NT = 3;          // (power, perf, area) heads
constexpr int KMAX = 8;        // candidates per env handled by one block
constexpr int THREADS = H1;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

__global__ void __launch_bounds__(THREADS)
screen_scores(const float* __restrict__ s, const float* __restrict__ cand,
              const float* __restrict__ weights,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ w3, const float* __restrict__ b3,
              float* __restrict__ score, int K) {
  __shared__ float x[KMAX][IN];
  __shared__ float h1[KMAX][H1];
  __shared__ float h2[KMAX][H2];
  const int b = blockIdx.x;
  const int t = threadIdx.x;

  for (int i = t; i < K * IN; i += THREADS) {
    const int kk = i / IN, c = i % IN;
    x[kk][c] = c < S ? s[b * S + c] : cand[((size_t)b * K + kk) * C + (c - S)];
  }
  __syncthreads();

  {  // layer 1: thread t owns hidden unit t for all K candidates
    float acc[KMAX];
    const float bias = b1[t];
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) acc[kk] = 0.0f;
#pragma unroll 2
    for (int i = 0; i < IN; ++i) {
      const float w = w1[i * H1 + t];
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk)
        if (kk < K) acc[kk] = fmaf(x[kk][i], w, acc[kk]);
    }
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk)
      if (kk < K) h1[kk][t] = gelu_tanh(acc[kk] + bias);
  }
  __syncthreads();

  if (t < H2) {  // layer 2
    float acc[KMAX];
    const float bias = b2[t];
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) acc[kk] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < H1; ++i) {
      const float w = w2[i * H2 + t];
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk)
        if (kk < K) acc[kk] = fmaf(h1[kk][i], w, acc[kk]);
    }
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk)
      if (kk < K) h2[kk][t] = gelu_tanh(acc[kk] + bias);
  }
  __syncthreads();

  if (t < K) {  // heads + score combine (the epilogue)
    float p[NT];
#pragma unroll
    for (int o = 0; o < NT; ++o) {
      float acc = 0.0f;
      for (int i = 0; i < H2; ++i) acc = fmaf(h2[t][i], w3[i * NT + o], acc);
      p[o] = acc + b3[o];
    }
    const float* w = weights + b * 3;  // (w_perf, w_power, w_area)
    score[b * K + t] = (w[1] * p[0] + w[2] * p[2]) - w[0] * p[1];
  }
}

}  // namespace

// Plain C entry point bound with ctypes.  Device pointers of contiguous
// float32 tensors: s [B,52], cand [B,K,30], weights [B,3], w1 [82,128],
// b1 [128], w2 [128,64], b2 [64], w3 [64,3], b3 [3]; out score [B,K].
// 1 <= K <= 8.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int screen_score_forward(
    const float* s, const float* cand, const float* weights,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, const float* b3, float* score, int B, int K,
    void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  screen_scores<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      s, cand, weights, w1, b1, w2, b2, w3, b3, score, K);
  return static_cast<int>(cudaGetLastError());
}
