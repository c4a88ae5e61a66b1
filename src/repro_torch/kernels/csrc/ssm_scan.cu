// Mamba selective scan for Hopper (sm_90a), fp32.
//
// Replaces: src/repro/kernels/ssm_scan.py, `_ssm_kernel` (pallas_call in
// `ssm_scan_pallas`).  Computes the reference oracle's function
// (`ssm_scan_reference`, and the plain version
// `repro_torch.kernels.ssm_scan.ssm_scan_plain`), which the Mamba prefill
// needs whole: the outputs and the final state for the decode cache (the
// Pallas kernel returns the outputs only).  For every batch row b and
// channel d, over t = 0 .. S-1 in order:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      h: [N] per (b, d)
//   y_t = sum_n C_t[n] * h_t[n]
// dt/x [B,S,D], B/C [B,S,N], A [D,N], h0 [B,D,N] (or none: zeros), all
// float32; y [B,S,D] and h_final [B,D,N] float32.  Any S; N <= 16.
//
// What bounds it on this card: at Jamba v0.1's prefill ([4,512,8192],
// N = 16) a call moves 201 MB (dt, x and y), 60 us at 3.35 TB/s; its
// 268 M exponentials and 1.6 GFLOP take 24 us on the fp32 units (67
// TFLOP/s).  So bytes, as on the TPU.  But the scan is sequential in t and
// the card holds only B * D = 32,768 channels (8 warps an SM), so this first
// kernel is bound by the latency of each step's chain more than by either.
//
// Design: one thread per (b, d) channel, its N states and its row of A in
// registers; a block of 128 channels of one batch row.  The block stages 32
// time steps at a time in shared memory: dt and x for its channels (each
// step's 128 values are one coalesced 512-byte row) and that step's B and C
// (N values each, shared by all channels), loaded all together so that the
// loads overlap; then each thread runs the 32 steps from shared memory and
// writes y_t (coalesced across the block).  expf (not __expf), no fast-math
// flags.  No atomics: deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int TCH = 32;        // time steps staged per round
constexpr int N_MAX = 16;

__global__ void __launch_bounds__(THREADS) ssm_scan_kernel(
    const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ x,
    const float* __restrict__ a, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_out, int S, int D, int N) {
  __shared__ float dts[TCH][THREADS];
  __shared__ float xs[TCH][THREADS];
  __shared__ float bs[TCH][N_MAX];
  __shared__ float cs[TCH][N_MAX];

  const int b = blockIdx.y, d0 = blockIdx.x * THREADS, c = threadIdx.x;
  const int d = d0 + c;
  const bool live = d < D;
  const long long row0 = (long long)b * S;    // row of (b, t = 0)

  float h[N_MAX], av[N_MAX];
#pragma unroll
  for (int n = 0; n < N_MAX; ++n) {
    const bool on = live && n < N;
    av[n] = on ? a[(long long)d * N + n] : 0.0f;
    h[n] = (on && h0 != nullptr) ? h0[((long long)b * D + d) * N + n] : 0.0f;
  }

  for (int t0 = 0; t0 < S; t0 += TCH) {
    const int nt = min(TCH, S - t0);
    __syncthreads();   // the previous round's steps are done
    for (int tt = 0; tt < nt; ++tt) {
      const long long off = (row0 + t0 + tt) * D + d;
      dts[tt][c] = live ? dt[off] : 0.0f;
      xs[tt][c] = live ? x[off] : 0.0f;
    }
    for (int i = c; i < nt * N; i += THREADS) {
      const int tt = i / N, n = i - tt * N;
      const long long off = (row0 + t0 + tt) * N + n;
      bs[tt][n] = bm[off];
      cs[tt][n] = cm[off];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const float dv = dts[tt][c];
      const float u = dv * xs[tt][c];
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < N_MAX; ++n) {
        if (n < N) {
          h[n] = expf(dv * av[n]) * h[n] + u * bs[tt][n];
          acc = fmaf(h[n], cs[tt][n], acc);
        }
      }
      y[(row0 + t0 + tt) * D + d] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N_MAX; ++n)
      if (n < N) h_out[((long long)b * D + d) * N + n] = h[n];
  }
}

}  // namespace

// h0 may be null (a zero initial state).  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int ssm_scan_forward(const float* dt, const float* b_in,
                                const float* c_in, const float* x,
                                const float* a, const float* h0, float* y,
                                float* h_out, int B, int S, int D, int N,
                                void* stream) {
  if (N < 1 || N > N_MAX || B < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  ssm_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dt, b_in, c_in, x, a, h0, y, h_out, S, D, N);
  return (int)cudaGetLastError();
}
