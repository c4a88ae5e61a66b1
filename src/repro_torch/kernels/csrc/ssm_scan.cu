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
// N = 16) a call moves 201 MB (dt, x and y), 60 us at 3.35 TB/s, and
// takes 268 M exponentials, one special-function (MUFU) op each: at 16 an
// SM a clock, 132 SMs and 1.98 GHz that is 64 us, so the exponentials
// bound it, the bytes close behind.  The scan is sequential in t; the card
// must hold enough independent chains to keep the MUFU pipes busy.
//
// Design, and what it does about that: each (b, d) channel's N states are
// split over 2 neighbouring lanes (8 states a lane), so a block of 256
// threads runs 128 channels of one batch row, 2 blocks an SM (256 blocks
// fill the card in one wave at Jamba's shape; 4 lanes x 4 states gave
// more warps but spent more issue slots a state on the shuffles and the
// (dt, x) reads, and was slower).  Time steps come in stages of 16
// through a 2-stage cp.async ring in shared memory: dt and x rows of the
// block's channels and B and C of each step, in 16-byte pieces when D and
// N are multiples of 4 and the tensors 16-byte aligned, else in 4-byte
// pieces (any D, N and alignment), zero-filled past S, D and N; the next
// stage lands while the current one runs.  A lane's step: u = dt * x,
// then per state e = 2^(dt * A log2 e) by one ex2.approx.ftz (A
// pre-scaled by log2 e once, in registers), h = fma(e, h, u * B), and its
// part of y; the 2 parts are summed by one xor shuffle and the first lane
// stores y.  No atomics: deterministic and repeatable.  The card is full
// in one wave at Jamba's shape, so S is not split into chunks (the extra
// state traffic would buy no occupancy).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Lanes a channel: 2 (-DSSM_LANES=1 or 4 builds the variants that
// scripts/search_kernels_ab.py times beside it)
#ifndef SSM_LANES
#define SSM_LANES 2
#endif
constexpr int LANES = SSM_LANES;
constexpr int N_MAX = 16;
constexpr int SPL = N_MAX / LANES;   // states a lane
constexpr int THREADS = 256;
constexpr int CH = THREADS / LANES;  // channels a block
constexpr int TCH = 8 * LANES;       // time steps a stage: 16 KB of dt, x
constexpr int MIN_BLOCKS = LANES;    // blocks an SM (the grid: B D LANES / 256)
static_assert(LANES == 1 || LANES == 2 || LANES == 4, "SSM_LANES: 1, 2, 4");
constexpr float LOG2E = 1.4426950408889634f;
// steps between the states a forward that feeds a backward saves (the
// reference's MAMBA_CHUNK; ssm_scan_backward.cu's CHUNK)
constexpr int SAVE_EVERY = 128;
static_assert(SAVE_EVERY % TCH == 0, "a saved state starts a stage");

struct Stage {
  float dt[TCH][CH];                 // dt of each step and channel
  float x[TCH][CH];                  // x likewise
  float4 bc[TCH][2][N_MAX / 4];      // B then C of each step, 0 past N
};

// `bytes` (4 or 16) from global to shared memory, zeros where !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const float* gmem,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// copy steps [t0, t0 + TCH) of this block's channels into `st` (zeros
// past S, D and N), in pieces of 4 floats (V = 4: D and N multiples of 4,
// every tensor 16-byte aligned) or of one
template <int V>
__device__ __forceinline__ void stage_copy(
    Stage& st, const float* __restrict__ dt, const float* __restrict__ x,
    const float* __restrict__ bm, const float* __restrict__ cm,
    long long row0, int t0, int S, int D, int N, int d0) {
  constexpr int PR = CH / V;           // pieces a row of dt or x
#pragma unroll
  for (int i = threadIdx.x; i < TCH * PR; i += THREADS) {
    const int r = i / PR, cc = V * (i % PR), d = d0 + cc;
    const bool ok = t0 + r < S && d < D;
    const long long off = ok ? (row0 + t0 + r) * D + d : 0;
    cp_async<4 * V>(&st.dt[r][cc], dt + off, ok);
    cp_async<4 * V>(&st.x[r][cc], x + off, ok);
  }
  float* bc = reinterpret_cast<float*>(st.bc);
  constexpr int PS = 2 * N_MAX / V;    // pieces a step of B and C
#pragma unroll
  for (int i = threadIdx.x; i < TCH * PS; i += THREADS) {
    const int r = i / PS, which = i % PS / (N_MAX / V);
    const int n = V * (i % (N_MAX / V));
    const bool ok = t0 + r < S && n < N;
    const long long off = ok ? (row0 + t0 + r) * N + n : 0;
    cp_async<4 * V>(bc + V * i, (which ? cm : bm) + off, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int V>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ssm_scan_kernel(
    const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ x,
    const float* __restrict__ a, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_out,
    float* __restrict__ h_chunks, int S, int D, int N) {
  static_assert(CH % V == 0 && N_MAX % V == 0, "whole pieces");
  __shared__ __align__(16) Stage ring[2];

  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int ch = threadIdx.x / LANES, sub = threadIdx.x % LANES;
  const int d = d0 + ch;
  const bool live = d < D;
  const long long row0 = (long long)b * S;    // row of (b, t = 0)
  const int chunks = (S + TCH - 1) / TCH;

  stage_copy<V>(ring[0], dt, x, bm, cm, row0, 0, S, D, N, d0);

  // this lane's states n = SPL sub + i: A log2 e and h0 (0 past N)
  float h[SPL], a2[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int n = SPL * sub + i;
    const bool on = live && n < N;
    a2[i] = on ? a[(long long)d * N + n] * LOG2E : 0.0f;
    h[i] = (on && h0 != nullptr) ? h0[((long long)b * D + d) * N + n] : 0.0f;
  }

  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * TCH;
    if (c + 1 < chunks)
      stage_copy<V>(ring[(c + 1) % 2], dt, x, bm, cm, row0, t0 + TCH, S, D,
                    N, d0);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();   // every thread's copies of chunk c have landed
    const Stage& st = ring[c % 2];
    const int nt = min(TCH, S - t0);
    if (h_chunks != nullptr && t0 % SAVE_EVERY == 0 && live) {
      // the state before step t0: where the backward's recompute starts
      float* hc = h_chunks +
                  (((long long)b * ((S + SAVE_EVERY - 1) / SAVE_EVERY) +
                    t0 / SAVE_EVERY) * D + d) * N;
#pragma unroll
      for (int i = 0; i < SPL; ++i)
        if (SPL * sub + i < N) hc[SPL * sub + i] = h[i];
    }
    float* yp = y + (row0 + t0) * D + d;
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = st.dt[tt][ch];
      float bv[SPL], cv[SPL];
#pragma unroll
      for (int q = 0; q < SPL / 4; ++q) {
        const float4 bq = st.bc[tt][0][SPL / 4 * sub + q];
        const float4 cq = st.bc[tt][1][SPL / 4 * sub + q];
        bv[4 * q] = bq.x, bv[4 * q + 1] = bq.y, bv[4 * q + 2] = bq.z,
        bv[4 * q + 3] = bq.w;
        cv[4 * q] = cq.x, cv[4 * q + 1] = cq.y, cv[4 * q + 2] = cq.z,
        cv[4 * q + 3] = cq.w;
      }
      const float u = dtv * st.x[tt][ch];
#pragma unroll
      for (int i = 0; i < SPL; ++i)
        h[i] = fmaf(ex2(dtv * a2[i]), h[i], u * bv[i]);
      float acc = cv[0] * h[0];
#pragma unroll
      for (int i = 1; i < SPL; ++i) acc = fmaf(cv[i], h[i], acc);
#pragma unroll
      for (int m = 1; m < LANES; m <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (sub == 0 && live) yp[(long long)tt * D] = acc;
    }
    __syncthreads();   // this stage is read before chunk c + 2 lands in it
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");   // S = 0: stage 0
  if (live) {
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int n = SPL * sub + i;
      if (n < N) h_out[((long long)b * D + d) * N + n] = h[i];
    }
  }
}

bool aligned16(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// h0 may be null (a zero initial state).  h_chunks, when not null, is a
// float32 [B, ceil(S / 128), D, N] that receives the state before every
// 128th step (the backward kernel's starting points); null writes
// nothing.  Returns the CUDA error code of the launch (0 on success).
extern "C" int ssm_scan_forward(const float* dt, const float* b_in,
                                const float* c_in, const float* x,
                                const float* a, const float* h0, float* y,
                                float* h_out, float* h_chunks, int B, int S,
                                int D, int N, void* stream) {
  if (N < 1 || N > N_MAX || B < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && N % 4 == 0 && aligned16(dt) &&
                   aligned16(b_in) && aligned16(c_in) && aligned16(x);
  auto kernel = vec ? ssm_scan_kernel<4> : ssm_scan_kernel<1>;
  const dim3 grid((D + CH - 1) / CH, B);
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dt, b_in, c_in, x, a, h0, y, h_out, h_chunks, S, D, N);
  return (int)cudaGetLastError();
}
