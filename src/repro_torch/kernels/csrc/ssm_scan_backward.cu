// The gradient of the Mamba selective scan (ssm_scan.cu) for Hopper
// (sm_90a), fp32.
//
// Replaces no TPU kernel: the JAX package differentiates its remat-chunked
// jnp scan (src/repro/models/blocks.py, `_mamba_scan_chunk` under
// `jax.remat`) with XLA.  This kernel computes the same gradients as
// autograd over the plain version `repro_torch.kernels.ssm_scan
// .ssm_scan_plain`, with the reference's memory discipline: the forward
// that feeds it saves the state only before every CHUNK-th step, and the
// backward recomputes each chunk's states from there.
//
// The function.  Per batch row b and channel d, with e_t = exp(dt_t A),
// u_t = dt_t x_t, h_t = e_t h_{t-1} + u_t B_t and y_t = C_t . h_t, given dy
// and the gradient gh of h_final (or none), walking t = S-1 .. 0:
//   g_t     = C_t dy_t + e_{t+1} g_{t+1}      (g_S = gh)
//   dx_t    = dt_t (g_t . B_t)
//   d(dt)_t = x_t (g_t . B_t) + sum_n g_t A e_t h_{t-1}
//   dB_t   += u_t g_t        dC_t += dy_t h_t      (summed over d)
//   dA     += dt_t g_t e_t h_{t-1}                 (summed over b and t)
//   dh0     = e_0 g_0
// dt/x/dy [B,S,D], B/C [B,S,N], A [D,N], N <= 16, all float32.
//
// Design: one thread per (b, d) channel, its N states, g and dA in
// registers; 128 threads a block.  For each chunk, last first, the thread
// recomputes the chunk's states from the saved one into a global scratch
// ([B][CHUNK][N][D]: neighbouring threads, neighbouring addresses), then
// walks the chunk backwards.  dx and d(dt) are the thread's own.  dB and
// dC sum over channels without atomics: each step the warp's 32 lanes
// hold 16 dB and 16 dC terms each, and a reduce-scatter of 31 shuffles
// leaves lane l with the warp's sum of term l; the warp writes those 32
// partials, and a second launch sums the warps' partials (and dA's per-b
// partials) in a fixed order.  So two identical calls give the same bits.
//
// What bounds it on this card: at Jamba's training shape ([2,512,8192],
// N = 16) a call reads dt, x, dy and writes dx, d(dt) (168 MB with B, C,
// A and the saved states: 52 us at 3.35 TB/s); it needs 134 M
// exponentials (32 us at the special-function rate; this design takes
// them twice, in the recompute and on the way back) and about 20
// operations a state a step, 2.7 GFLOP, 40 us at the fp32 rate.  So
// bytes, by a little.  The scratch (134 MB written and read) and the
// shuffles come on top; the scan is sequential in t, and its 16,384
// threads are 4 warps an SM: ~4 ms on the card (PERF.md), latency-bound.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 128;     // steps between saved states (SAVE_EVERY)
constexpr int N_MAX = 16;
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU, as the forward computes its decays
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// v[0..31] of each lane -> v[0] = the warp's sum of term `lane`
__device__ __forceinline__ void reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const bool up = lane & w;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = up ? v[i] : v[i + w];
      const float keep = up ? v[i + w] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, w);
    }
  }
}

__global__ void __launch_bounds__(THREADS) ssm_scan_backward_kernel(
    const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ x,
    const float* __restrict__ a, const float* __restrict__ h_chunks,
    const float* __restrict__ dy, const float* __restrict__ gh,
    float* __restrict__ scratch, float* __restrict__ ddt,
    float* __restrict__ dx, float* __restrict__ part_bc,
    float* __restrict__ part_a, float* __restrict__ dh0, int S, int D,
    int N) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < D;
  const int lane = threadIdx.x & 31;
  const int W = (D + 31) / 32;                    // warps a batch row
  const int w = d / 32;                           // this lane's warp
  const int n_chunks = (S + CHUNK - 1) / CHUNK;

  float a1[N_MAX], a2[N_MAX], g[N_MAX], da[N_MAX];
#pragma unroll
  for (int n = 0; n < N_MAX; ++n) {
    const bool on = live && n < N;
    a1[n] = on ? a[(long long)d * N + n] : 0.0f;
    a2[n] = a1[n] * LOG2E;
    g[n] = (on && gh != nullptr) ? gh[((long long)b * D + d) * N + n] : 0.0f;
    da[n] = 0.0f;
  }
  // scratch [b][tt][n][d]
  float* sc = scratch + (long long)b * CHUNK * N_MAX * D + d;
  const long long sstep = (long long)N_MAX * D;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * CHUNK, tn = min(CHUNK, S - t0);
    const float* hs = h_chunks + (((long long)b * n_chunks + c) * D + d) * N;
    float h[N_MAX];
#pragma unroll
    for (int n = 0; n < N_MAX; ++n) h[n] = live && n < N ? hs[n] : 0.0f;
    // the chunk's states h_t, t = t0 .. t0 + tn - 1, into the scratch
    for (int tt = 0; tt < tn; ++tt) {
      const long long row = (long long)b * S + t0 + tt;
      const float dtv = live ? dt[row * D + d] : 0.0f;
      const float u = dtv * (live ? x[row * D + d] : 0.0f);
#pragma unroll
      for (int n = 0; n < N_MAX; ++n) {
        const float bv = n < N ? __ldg(bm + row * N + n) : 0.0f;
        h[n] = fmaf(ex2(dtv * a2[n]), h[n], u * bv);
        if (live) sc[tt * sstep + (long long)n * D] = h[n];
      }
    }
    // back through the chunk: h holds h_t, hp gets h_{t-1}
    for (int tt = tn - 1; tt >= 0; --tt) {
      const long long row = (long long)b * S + t0 + tt;
      const float dtv = live ? dt[row * D + d] : 0.0f;
      const float xv = live ? x[row * D + d] : 0.0f;
      const float dyv = live ? dy[row * D + d] : 0.0f;
      const float u = dtv * xv;
      float v[32];
      float gb = 0.0f, sdt = 0.0f;
#pragma unroll
      for (int n = 0; n < N_MAX; ++n) {
        const float bv = n < N ? __ldg(bm + row * N + n) : 0.0f;
        const float cv = n < N ? __ldg(cm + row * N + n) : 0.0f;
        const float hp = tt > 0 ? (live ? sc[(tt - 1) * sstep +
                                             (long long)n * D] : 0.0f)
                                : (live && n < N ? hs[n] : 0.0f);
        const float e = ex2(dtv * a2[n]);
        g[n] = fmaf(cv, dyv, g[n]);              // g_t
        gb = fmaf(g[n], bv, gb);
        const float geh = g[n] * e * hp;
        sdt = fmaf(a1[n], geh, sdt);
        da[n] = fmaf(dtv, geh, da[n]);
        v[n] = g[n] * u;                         // dB_t[n] term
        v[N_MAX + n] = dyv * h[n];               // dC_t[n] term
        g[n] *= e;                               // e_t g_t, for t - 1
        h[n] = hp;
      }
      if (live) {
        dx[row * D + d] = dtv * gb;
        ddt[row * D + d] = fmaf(xv, gb, sdt);
      }
      reduce_scatter32(v);
      if (w < W) part_bc[(row * W + w) * 32 + lane] = v[0];
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N_MAX; ++n) {
      if (n >= N) continue;
      part_a[((long long)b * D + d) * N + n] = da[n];
      if (dh0 != nullptr) dh0[((long long)b * D + d) * N + n] = g[n];
    }
  }
}

// dB, dC [B,S,N]: the warps' partials summed in order; dA [D,N]: the batch
// rows' partials summed in order
__global__ void ssm_scan_backward_reduce(const float* __restrict__ part_bc,
                                         const float* __restrict__ part_a,
                                         float* __restrict__ db,
                                         float* __restrict__ dc,
                                         float* __restrict__ da, int B, int S,
                                         int D, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_bc = (long long)B * S * N;
  const int W = (D + 31) / 32;
  if (i < n_bc) {
    const long long row = i / N;
    const int n = (int)(i % N);
    float sb = 0.0f, sc = 0.0f;
    for (int w = 0; w < W; ++w) {
      sb += part_bc[(row * W + w) * 32 + n];
      sc += part_bc[(row * W + w) * 32 + N_MAX + n];
    }
    db[i] = sb;
    dc[i] = sc;
  } else if (i - n_bc < (long long)D * N) {
    const long long j = i - n_bc;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += part_a[(long long)b * D * N + j];
    da[j] = s;
  }
}

}  // namespace

// Inputs as the forward's, h_chunks the forward's saved states [B,
// ceil(S / 128), D, N], dy [B,S,D], gh [B,D,N] or null.  Scratch (float32,
// contiguous): scratch [B, 128, 16, D], part_bc [B, S, ceil(D / 32), 32],
// part_a [B, D, N].  Outputs: ddt, dx [B,S,D], db, dc [B,S,N], da [D,N],
// dh0 [B,D,N] or null.  Returns the CUDA error code of the launches.
extern "C" int ssm_scan_backward(
    const float* dt, const float* b_in, const float* c_in, const float* x,
    const float* a, const float* h_chunks, const float* dy, const float* gh,
    float* scratch, float* part_bc, float* part_a, float* ddt, float* db,
    float* dc, float* dx, float* da, float* dh0, int B, int S, int D, int N,
    void* stream) {
  if (N < 1 || N > N_MAX || B < 1 || D < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  ssm_scan_backward_kernel<<<grid, THREADS, 0, s>>>(
      dt, b_in, c_in, x, a, h_chunks, dy, gh, scratch, ddt, dx, part_bc,
      part_a, dh0, S, D, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * S * N + (long long)D * N;
  ssm_scan_backward_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_bc, part_a, db, dc, da, B, S, D, N);
  return (int)cudaGetLastError();
}
