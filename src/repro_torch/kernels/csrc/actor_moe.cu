// Fused 4-expert MoE SAC actor forward for Hopper (sm_90a), fp32 FMA.
//
// Replaces: src/repro/kernels/actor_moe.py, `_actor_kernel` (pallas_call in
// `actor_forward_pallas`).  Same function as the plain version
// `repro_torch.kernels.actor_moe.actor_forward_plain`:
//   g       = softmax(s @ Wg)                              [B, 4]
//   h1_k    = gelu_tanh(s @ W1[k] + b1[k])                 [B, 256]
//   h2_k    = gelu_tanh(h1_k @ W2[k] + b2[k])              [B, 256]
//   head    = sum_k g[:, k] * (h2_k @ Wh[k] + bh[k])       for disc/mu/log_std
//   outputs : disc [B,20], tanh(mu) [B,30], clip(log_std,-20,2) [B,30], g.
//
// What bounds it on this card: at the search's batch (B = 64, 192) the work
// is 0.8 MFLOP per row (51 MFLOP at B = 64) against 1.6 MB of weights, so
// the H100's fp32 rate (67 TFLOP/s) bounds it at under 3 us; in practice the
// small grid and the latency of the dependent layers bound it: 64 rows
// cannot fill 132 SMs.
//
// Design, and what it does about that: the TPU kernel loops over the
// experts inside one grid step with all weights in VMEM.  Here the
// (row tile x expert) pairs are spread over blocks so that B = 64 gives 32
// blocks instead of 4: `actor_experts` computes one expert's trunk and its
// three heads for an 8-row tile, with h1/h2 staged in shared memory (8 KB
// each) and the weights read straight from L2 (each 1.6 MB set stays
// resident there across launches).  Its 80 head outputs per row go to an
// [E, B, 80] scratch; `actor_blend` then computes the gate softmax and blends
// the experts in the fixed order k = 0..3.  Every sum runs in a fixed order
// with no atomics, so the kernel is deterministic run to run.  fp32 FMA only
// (no tensor cores, no TF32) to stay within 1e-4 of the fp32 reference.
// Each dot product starts from 0 and takes its bias last, as x @ W + b
// does: started from a large bias, every partial sum would round at the
// bias's magnitude.
#include <cuda_runtime.h>

namespace {

constexpr int S = 52;          // SAC state dim
constexpr int H = 256;         // expert hidden width
constexpr int E = 4;           // experts
constexpr int ND = 20;         // discrete logits (4 x 5)
constexpr int NC = 30;         // continuous dims
constexpr int NO = ND + 2 * NC;  // 80 head outputs per expert
constexpr int TB = 8;          // rows per block
constexpr int THREADS = 256;   // one thread per hidden unit

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

__global__ void __launch_bounds__(THREADS)
actor_experts(const float* __restrict__ s, const float* __restrict__ l1w,
              const float* __restrict__ l1b, const float* __restrict__ l2w,
              const float* __restrict__ l2b, const float* __restrict__ dw,
              const float* __restrict__ db, const float* __restrict__ mw,
              const float* __restrict__ mb, const float* __restrict__ lw,
              const float* __restrict__ lb, float* __restrict__ scratch,
              int B) {
  __shared__ float xs[TB][S];
  __shared__ float h1[TB][H];
  __shared__ float h2[TB][H];
  const int r0 = blockIdx.x * TB;
  const int k = blockIdx.y;
  const int j = threadIdx.x;

  for (int i = j; i < TB * S; i += THREADS) {
    const int r = i / S, c = i % S;
    xs[r][c] = (r0 + r < B) ? s[(r0 + r) * S + c] : 0.0f;
  }
  __syncthreads();

  // layer 1: thread j owns hidden unit j for all TB rows
  {
    const float* w = l1w + (size_t)k * S * H;
    float acc[TB];
    const float bias = l1b[k * H + j];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < S; ++i) {
      const float wij = w[i * H + j];
#pragma unroll
      for (int r = 0; r < TB; ++r) acc[r] = fmaf(xs[r][i], wij, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < TB; ++r) h1[r][j] = gelu_tanh(acc[r] + bias);
  }
  __syncthreads();

  // layer 2
  {
    const float* w = l2w + (size_t)k * H * H;
    float acc[TB];
    const float bias = l2b[k * H + j];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = 0.0f;
#pragma unroll 8
    for (int i = 0; i < H; ++i) {
      const float wij = w[i * H + j];
#pragma unroll
      for (int r = 0; r < TB; ++r) acc[r] = fmaf(h1[r][i], wij, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < TB; ++r) h2[r][j] = gelu_tanh(acc[r] + bias);
  }
  __syncthreads();

  // heads: TB x 80 outputs, consecutive threads on consecutive outputs
  for (int item = j; item < TB * NO; item += THREADS) {
    const int r = item / NO, o = item % NO;
    if (r0 + r >= B) continue;
    const float* w;
    int n, c;
    float bias;
    if (o < ND) {
      w = dw + (size_t)k * H * ND; n = ND; c = o; bias = db[k * ND + c];
    } else if (o < ND + NC) {
      w = mw + (size_t)k * H * NC; n = NC; c = o - ND; bias = mb[k * NC + c];
    } else {
      w = lw + (size_t)k * H * NC; n = NC; c = o - ND - NC;
      bias = lb[k * NC + c];
    }
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < H; ++i) acc = fmaf(h2[r][i], w[i * n + c], acc);
    scratch[((size_t)k * B + r0 + r) * NO + o] = acc + bias;
  }
}

__global__ void __launch_bounds__(THREADS)
actor_blend(const float* __restrict__ s, const float* __restrict__ gate_w,
            const float* __restrict__ scratch, float* __restrict__ disc,
            float* __restrict__ mu, float* __restrict__ log_std,
            float* __restrict__ gate, int B) {
  __shared__ float xs[TB][S];
  __shared__ float logit[TB][E];
  __shared__ float g[TB][E];
  const int r0 = blockIdx.x * TB;
  const int t = threadIdx.x;

  for (int i = t; i < TB * S; i += THREADS) {
    const int r = i / S, c = i % S;
    xs[r][c] = (r0 + r < B) ? s[(r0 + r) * S + c] : 0.0f;
  }
  __syncthreads();
  if (t < TB * E) {
    const int r = t / E, e = t % E;
    float acc = 0.0f;
    for (int i = 0; i < S; ++i) acc = fmaf(xs[r][i], gate_w[i * E + e], acc);
    logit[r][e] = acc;
  }
  __syncthreads();
  if (t < TB) {  // softmax over the 4 experts of row t (Eq. 54)
    float m = logit[t][0];
    for (int e = 1; e < E; ++e) m = fmaxf(m, logit[t][e]);
    float z[E], sum = 0.0f;
    for (int e = 0; e < E; ++e) { z[e] = expf(logit[t][e] - m); sum += z[e]; }
    for (int e = 0; e < E; ++e) g[t][e] = z[e] / sum;
  }
  __syncthreads();

  for (int item = t; item < TB * NO; item += THREADS) {
    const int r = item / NO, o = item % NO;
    const int row = r0 + r;
    if (row >= B) continue;
    float acc = 0.0f;
    for (int e = 0; e < E; ++e)
      acc = fmaf(g[r][e], scratch[((size_t)e * B + row) * NO + o], acc);
    if (o < ND) {
      disc[row * ND + o] = acc;
    } else if (o < ND + NC) {
      mu[row * NC + (o - ND)] = tanhf(acc);
    } else {
      log_std[row * NC + (o - ND - NC)] = fminf(fmaxf(acc, -20.0f), 2.0f);
    }
  }
  if (t < TB * E && r0 + t / E < B) gate[(r0 + t / E) * E + t % E] = g[t / E][t % E];
}

}  // namespace

// Plain C entry point bound with ctypes.  Pointers are device pointers of
// contiguous float32 tensors laid out as in the reference parameter pytree:
// gate_w [52,4]; l1w [4,52,256]; l1b [4,256]; l2w [4,256,256]; l2b [4,256];
// dw [4,256,20]; db [4,20]; mw/lw [4,256,30]; mb/lb [4,30];
// scratch [4,B,80]; outputs disc [B,20], mu/log_std [B,30], gate [B,4].
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int actor_moe_forward(
    const float* s, const float* gate_w, const float* l1w, const float* l1b,
    const float* l2w, const float* l2b, const float* dw, const float* db,
    const float* mw, const float* mb, const float* lw, const float* lb,
    float* scratch, float* disc, float* mu, float* log_std, float* gate,
    int B, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (B + TB - 1) / TB;
  actor_experts<<<dim3(tiles, E), THREADS, 0, st>>>(
      s, l1w, l1b, l2w, l2b, dw, db, mw, mb, lw, lb, scratch, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  actor_blend<<<tiles, THREADS, 0, st>>>(s, gate_w, scratch, disc, mu,
                                         log_std, gate, B);
  return static_cast<int>(cudaGetLastError());
}
