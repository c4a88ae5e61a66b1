// The gradient of the Mamba selective scan (ssm_scan.cu) for Hopper
// (sm_90a), fp32.
//
// Replaces no TPU kernel: the JAX package differentiates its remat-chunked
// jnp scan (src/repro/models/blocks.py, `_mamba_scan_chunk` under
// `jax.remat`) with XLA.  This kernel computes the same gradients as
// autograd over the plain version `repro_torch.kernels.ssm_scan
// .ssm_scan_plain`, with the reference's memory discipline: the forward
// that feeds it saves the state only before every 128th step, and the
// backward recomputes the states from there.
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
// What bounds it on this card: at Jamba's training shape ([2,512,8192],
// N = 16) a call reads dt, x, dy and writes dx, d(dt) (168 MB with B, C,
// A and the saved states: 52 us at 3.35 TB/s); it needs 134 M
// exponentials (32 us at the special-function rate) and about 20
// operations a state a step.  So bytes, by a little, on paper.  This
// design issues about 300 instructions a (channel, state, span of 256)
// unit (`cuobjdump -sass` of the built library), ~150 us at 4 an SM a
// clock, and takes nearly 3 times that (PERF.md).
//
// Design (the route of the public Mamba selective-scan backward, written
// for this card).  Time across a warp's lanes, states across warps: a
// block has one warp per state n (32 N threads) and walks `cpb`
// neighbouring channels of one batch row, one at a time, over spans of
// SPAN = 32 K steps, last span first; lane l of warp n takes steps l K ..
// l K + K - 1 of the span for state n.  Per channel and span each lane
// takes e_t = 2^(dt_t A log2 e) once per state and step, then
//   h: the lane's (product of e, h from 0) over its steps, lane 0 folding
//      in the forward's saved state at the span's start, an inclusive warp
//      scan of (a, b) pairs, (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2), by
//      shuffles up, and the lane's h_t again from where the lane before
//      ends;
//   g: the same in reverse by shuffles down, in the same rounds, with
//      e_{t+1} of a lane's last step from the next lane, lane 31 folding
//      in the carry (gh for the last span, else e g at the first step of
//      the span after, kept per channel and state in shared memory; after
//      the first span it is dh0); then g_t again with each step's terms.
// Against the limits of the first kernel (one thread a channel): the
// card now holds one warp a (channel, state), 16 warps an SM, each lane's
// steps independent but for the 5 rounds of the two scans; no state lives
// in device memory (the chunk's states, 134 MB each way through a global
// scratch at Jamba's shape, are gone); one exponential a state a step
// (not two); the tiles come ahead through a cp.async ring; and the
// per-step 31-shuffle reduce-scatter for dB/dC is gone (below).
//
// The sums, all in a fixed order (two identical calls give the same bits,
// no atomics):
//   - d(dt) and dx need sum_n g B and sum_n A g e h_{t-1}: each warp writes
//     its state's terms of a channel to one of two shared slots and
//     arrives on the slot's mbarrier; 4 warps (rotating, so that each
//     scheduler takes its turn) wait for it, sum the terms with n
//     ascending and free the slot, while the others go on to the next
//     channel (a warp waits only to write a slot not yet freed);
//   - dB and dC: each warp adds its channel's u g and dy h into registers
//     (fma, channels in order), writes the block's partial at the end of
//     each span, and a second launch sums the blocks' partials in order;
//   - dA: each lane's steps (descending), the warp's xor butterfly (16,
//     8, 4, 2, 1; run in the next unit's scan rounds), the spans (last
//     first) in shared memory, the batch rows in the second launch.
// Loads: a block's channels come in groups of G = 8 (a 32-byte sector a
// row): dt, x and dy of a group's span through a 2-stage cp.async ring
// (16-byte pieces when D is a multiple of 4 and the tensors 16-byte
// aligned, else 4-byte ones; zero past S and D; the next group's stage
// lands while this one runs), then laid out so that each lane reads its K
// steps as float4s without bank conflicts, with u = dt x, once a stage; B
// and C of the warp's state stay in registers for the span; dx and d(dt)
// go out through a shared tile, a step's row of the group a thread.  Past
// S the padding (dt = 0, so e = 1) passes h and g through unchanged.  The
// wrapper picks `cpb` so that the grid is about one block per SM (one
// block of 16 warps fills an SM: 128 registers a thread); the dB/dC
// partials are B ceil(D / cpb) 2 N S floats (8.4 MB at Jamba's shape,
// cpb = 128).  What is left: the units themselves, long chains of
// dependent shuffles, loads and fmas with 4 warps a scheduler, whose
// shuffles and shared-memory traffic share one pipe (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Steps a lane: 8 (4, spans of 128, takes twice the scan rounds a step
// and was slower at Jamba's shape; 16 needs more than 128 registers)
constexpr int K = 8;
constexpr int SPAN = 32 * K;         // steps a warp scans at once
constexpr int SAVE_EVERY = 128;      // steps between the forward's states
static_assert(SPAN % SAVE_EVERY == 0, "a span starts at a saved state");
constexpr int N_MAX = 16;
constexpr int G = 8;                 // channels a stage (32-byte rows)
// a stage as copied: dt, x, dy rows of G channels a step, 8 more floats
// after every 4 steps (so that a warp reading 4 steps of 8 channels down a
// column meets no bank twice), then the saved states [G][N_MAX]
constexpr int RAWT = SPAN * G + SPAN / 4 * G;
constexpr int RAW = 3 * RAWT + G * N_MAX;
// the stage laid out for the lanes: dt, x, dy, u, a row of SPAN steps a
// channel (step r at pos(r)), rows and tensors padded off the same banks
constexpr int ROW = SPAN + 4;
constexpr int ARR = G * ROW + 16;
constexpr int ROWA = SPAN + 16;      // one (state, kind) row of terms
constexpr int AREA = N_MAX * 2 * ROWA;       // a channel's terms
constexpr int OUT = 2 * ARR;         // dx, d(dt) of a group
// floats of shared memory before the cpb-sized arrays
constexpr int FIXED = 2 * RAW + 4 * ARR + 2 * AREA + OUT;
constexpr int SUM_THREADS = 2 * SPAN / 4;  // (float4 of steps, kind)
constexpr int CPB_MAX = 256;
// then A, the g carries and dA of cpb channels, and 4 mbarriers (8 floats)
constexpr int smem_floats(int cpb) { return FIXED + 3 * cpb * N_MAX + 8; }
static_assert(4 * smem_floats(CPB_MAX) <= 232448, "shared memory");
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// arrive on `bar` (release: this thread's shared-memory writes before it
// are seen by those that wait for the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// wait until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// 2^x on the SFU, as the forward computes its decays
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// `BYTES` (4 or 16) from global to shared memory, zeros where !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid) {
  const unsigned s = smem_addr(smem);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

// where step r of a span lies in a lanes' row: lane r / K's float4 number
// (r % K) / 4 at float4 32 ((r % K) / 4) + lane, so that a warp reads 32
// float4s in a row
__device__ __forceinline__ int pos(int r) {
  return (((r % K) >> 2) * 32 + r / K) * 4 + (r & 3);
}

// where step r of a span starts in a copied tensor
__device__ __forceinline__ int raw_row(int r) { return (r + (r >> 2)) * G; }

struct Ctx {
  const float *dt, *x, *dy, *h_chunks;
  float *ddt, *dx;
  int b, S, D, N, d0, nsp, ngrp;
};

// start the copies of stage s (span nsp - 1 - s / ngrp, group s % ngrp):
// dt, x, dy of the group's channels, in pieces of V floats (V = 4: D a
// multiple of 4 and the tensors 16-byte aligned), and the saved states at
// the span's start
template <int V>
__device__ __forceinline__ void issue_stage(float* raw, const Ctx& c, int s) {
  const int t0 = (c.nsp - 1 - s / c.ngrp) * SPAN;
  const int dg = c.d0 + (s % c.ngrp) * G;
  for (int e = threadIdx.x; e < SPAN * (G / V); e += blockDim.x) {
    const int r = e / (G / V), jj = V * (e % (G / V));
    const int t = t0 + r, d = dg + jj;
    const bool ok = t < c.S && d < c.D;
    const long long off = ok ? ((long long)c.b * c.S + t) * c.D + d : 0;
    float* p = raw + raw_row(r) + jj;
    cp_async<4 * V>(p, c.dt + off, ok);
    cp_async<4 * V>(p + RAWT, c.x + off, ok);
    cp_async<4 * V>(p + 2 * RAWT, c.dy + off, ok);
  }
  const int n_saved = (c.S + SAVE_EVERY - 1) / SAVE_EVERY;
  for (int e = threadIdx.x; e < G * c.N; e += blockDim.x) {
    const int jj = e / c.N, n = e % c.N, d = dg + jj;
    const bool ok = d < c.D;
    const long long off =
        ok ? (((long long)c.b * n_saved + t0 / SAVE_EVERY) * c.D + d) * c.N +
                 n
           : 0;
    cp_async<4>(raw + 3 * RAWT + jj * N_MAX + n, c.h_chunks + off, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the landed stage into the lanes' layout, with u = dt x: a thread takes
// 4 steps of one channel
__device__ __forceinline__ void lay_out(float* st, const float* raw) {
  for (int e = threadIdx.x; e < SPAN / 4 * G; e += blockDim.x) {
    const int jj = e % G, r = 4 * (e / G);
    float4 v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* src = raw + k * RAWT + jj;
      v[k] = make_float4(src[raw_row(r)], src[raw_row(r + 1)],
                         src[raw_row(r + 2)], src[raw_row(r + 3)]);
      reinterpret_cast<float4*>(st + k * ARR + jj * ROW + pos(r))[0] = v[k];
    }
    reinterpret_cast<float4*>(st + 3 * ARR + jj * ROW + pos(r))[0] =
        make_float4(v[0].x * v[1].x, v[0].y * v[1].y, v[0].z * v[1].z,
                    v[0].w * v[1].w);
  }
}

// write stage s's dx and d(dt) from the tile: a thread takes one step's
// row of the group (two float4 stores when V = 4)
template <int V>
__device__ __forceinline__ void flush_out(const float* out, const Ctx& c,
                                          int s) {
  const int t0 = (c.nsp - 1 - s / c.ngrp) * SPAN;
  const int dg = c.d0 + (s % c.ngrp) * G;
  for (int e = threadIdx.x; e < 2 * SPAN; e += blockDim.x) {
    const int kind = e / SPAN, r = e % SPAN, t = t0 + r;
    if (t >= c.S) continue;
    float v[G];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) v[jj] = out[kind * ARR + jj * ROW + pos(r)];
    float* row = (kind ? c.ddt : c.dx) + ((long long)c.b * c.S + t) * c.D + dg;
    if (V == 4) {
#pragma unroll
      for (int h = 0; h < G; h += 4)
        if (dg + h < c.D)
          reinterpret_cast<float4*>(row + h)[0] =
              make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
    } else {
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
        if (dg + jj < c.D) row[jj] = v[jj];
    }
  }
}

template <int V>
__global__ void __launch_bounds__(32 * N_MAX, 1) ssm_scan_backward_kernel(
    const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ x,
    const float* __restrict__ a, const float* __restrict__ h_chunks,
    const float* __restrict__ dy, const float* __restrict__ gh,
    float* __restrict__ ddt, float* __restrict__ dx,
    float* __restrict__ part_bc, float* __restrict__ part_a,
    float* __restrict__ dh0, int S, int D, int N, int cpb) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem + 2 * RAW;            // the stage in the lanes' layout
  float* area = st + 4 * ARR;
  float* out = area + 2 * AREA;
  float* s_a = out + OUT;                // [cpb][N_MAX]: A
  float* s_q = s_a + cpb * N_MAX;        // the g carry, then dh0
  float* s_da = s_q + cpb * N_MAX;       // dA of this batch row
  // a terms slot's mbarriers: full (every thread has written its state's
  // terms) and free (the channel's summing threads have read them)
  uint64_t* full = reinterpret_cast<uint64_t*>(s_da + cpb * N_MAX);
  uint64_t* freed = full + 2;

  const int n = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthr = blockDim.x;
  Ctx c;
  c.dt = dt, c.x = x, c.dy = dy, c.h_chunks = h_chunks, c.ddt = ddt,
  c.dx = dx, c.b = blockIdx.y, c.S = S, c.D = D, c.N = N;
  c.d0 = blockIdx.x * cpb;
  const int nch = min(cpb, D - c.d0);
  c.ngrp = (nch + G - 1) / G;
  c.nsp = (S + SPAN - 1) / SPAN;
  const int n_stages = c.nsp * c.ngrp;
  const long long bdn = (long long)c.b * D * N;

  for (int e = threadIdx.x; e < nch * N; e += nthr) {
    const int j = e / N, m = e % N;
    const long long i = (long long)(c.d0 + j) * N + m;
    s_a[j * N_MAX + m] = a[i];
    s_q[j * N_MAX + m] = gh != nullptr ? gh[bdn + i] : 0.0f;
    s_da[j * N_MAX + m] = 0.0f;
  }
  issue_stage<V>(smem, c, 0);

  float bv[K], cv[K], acc_b[K], acc_c[K];
  float dal = 0.0f;   // a lane's part of dA of the last unit, at da_at
  int da_at = -1;
  // the warps that sum a channel: cw of them, from warp `rot` on (mod
  // the warps), rotating so that each scheduler takes its turn
  const int nw = nthr / 32, cw = min(SUM_THREADS / 32, nw);
  int rot = 0;
  int walked = 0;   // channels this block has walked, all spans
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(full + k, nthr);
      mbar_init(freed + k, 32 * cw);
    }
  }
  for (int s = 0; s < n_stages; ++s) {
    const int g = s % c.ngrp;
    const int t0 = (c.nsp - 1 - s / c.ngrp) * SPAN;
    const float* raw = smem + (s & 1) * RAW;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // stage s landed; stage s - 1 and its sums are done
    if (s > 0) flush_out<V>(out, c, s - 1);
    if (s + 1 < n_stages) issue_stage<V>(smem + ((s + 1) & 1) * RAW, c, s + 1);
    lay_out(st, raw);
    if (g == 0) {   // a new span: this state's B and C, the partials
      const long long row = (long long)c.b * S + t0 + lane * K;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const bool ok = t0 + lane * K + i < S;
        bv[i] = ok ? __ldg(bm + (row + i) * N + n) : 0.0f;
        cv[i] = ok ? __ldg(cm + (row + i) * N + n) : 0.0f;
        acc_b[i] = acc_c[i] = 0.0f;
      }
    }
    __syncthreads();   // the stage is laid out
    const int ng = min(G, nch - g * G);
    for (int jj = 0; jj < ng; ++jj, ++walked) {
      const int j = g * G + jj, slot = walked & 1;
      float* ar = area + slot * AREA;
      // the slot's terms of two channels ago have been summed
      if (walked >= 2) mbar_wait(freed + slot, ((walked >> 1) - 1) & 1);
      // ---- the unit: channel j, state n ----
      const float a1 = s_a[j * N_MAX + n];
      const float a2 = a1 * LOG2E;
      const float hstart = raw[3 * RAWT + jj * N_MAX + n];
      const float qin = s_q[j * N_MAX + n];
      float dtv[K], uv[K], dyv[K];
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 d4 =
            reinterpret_cast<const float4*>(st + jj * ROW)[q * 32 + lane];
        const float4 u4 = reinterpret_cast<const float4*>(
            st + 3 * ARR + jj * ROW)[q * 32 + lane];
        const float4 y4 = reinterpret_cast<const float4*>(
            st + 2 * ARR + jj * ROW)[q * 32 + lane];
        dtv[4 * q] = d4.x, dtv[4 * q + 1] = d4.y, dtv[4 * q + 2] = d4.z,
        dtv[4 * q + 3] = d4.w;
        uv[4 * q] = u4.x, uv[4 * q + 1] = u4.y, uv[4 * q + 2] = u4.z,
        uv[4 * q + 3] = u4.w;
        dyv[4 * q] = y4.x, dyv[4 * q + 1] = y4.y, dyv[4 * q + 2] = y4.z,
        dyv[4 * q + 3] = y4.w;
      }
      float e[K], v[K], cd[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        e[i] = ex2(dtv[i] * a2);
        v[i] = uv[i] * bv[i];
        cd[i] = cv[i] * dyv[i];
      }
      float en[K];   // e_{t+1} of each step: the next lane's first for the
      en[K - 1] = __shfl_down_sync(FULL, e[0], 1);   // last, 1 in lane 31
      if (lane == 31) en[K - 1] = 1.0f;
#pragma unroll
      for (int i = 0; i < K - 1; ++i) en[i] = e[i + 1];
      // the lane's pairs: h from its first step, g from its last; the
      // saved state in lane 0, the carry in lane 31
      float L = v[0], P = e[0], Lg = cd[K - 1], Pg = en[K - 1];
#pragma unroll
      for (int i = 1; i < K; ++i) {
        L = fmaf(e[i], L, v[i]);
        P *= e[i];
        Lg = fmaf(en[K - 1 - i], Lg, cd[K - 1 - i]);
        Pg *= en[K - 1 - i];
      }
      if (lane == 0) L = fmaf(P, hstart, L);
      if (lane == 31) Lg = fmaf(Pg, qin, Lg);
      // both scans (up for h, down for g) and the last unit's dA
      // butterfly (xor 16, 8, 4, 2, 1), round by round
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float lp = __shfl_up_sync(FULL, L, o);
        const float pp = __shfl_up_sync(FULL, P, o);
        const float ln = __shfl_down_sync(FULL, Lg, o);
        const float pn = __shfl_down_sync(FULL, Pg, o);
        dal += __shfl_xor_sync(FULL, dal, 16 / o);
        // a lane whose pair already reaches the span's first (last) step
        // takes nothing more in; its P (Pg) is not read again
        L = fmaf(lane >= o ? P : 0.0f, lp, L);
        P *= pp;
        Lg = fmaf(lane + o < 32 ? Pg : 0.0f, ln, Lg);
        Pg *= pn;
      }
      if (lane == 0 && da_at >= 0) s_da[da_at] += dal;
      float hin = __shfl_up_sync(FULL, L, 1);
      float gv = __shfl_down_sync(FULL, Lg, 1);
      if (lane == 0) hin = hstart;
      if (lane == 31) gv = qin;
      __syncwarp();   // every lane has read the carry
      if (lane == 0) s_q[j * N_MAX + n] = e[0] * Lg;
      // h_t and g_t again, with each step's terms
      float h[K];
      {
        float hp = hin;
#pragma unroll
        for (int i = 0; i < K; ++i) hp = h[i] = fmaf(e[i], hp, v[i]);
      }
      float gbt[K], sdtt[K];
      dal = 0.0f;
#pragma unroll
      for (int i = K - 1; i >= 0; --i) {
        gv = fmaf(en[i], gv, cd[i]);
        const float hp = i ? h[i - 1] : hin;
        const float geh = gv * e[i] * hp;
        gbt[i] = gv * bv[i];
        sdtt[i] = a1 * geh;
        dal = fmaf(dtv[i], geh, dal);
        acc_b[i] = fmaf(uv[i], gv, acc_b[i]);
        acc_c[i] = fmaf(dyv[i], h[i], acc_c[i]);
      }
      da_at = j * N_MAX + n;   // its butterfly runs in the next unit
      float* arn = ar + n * 2 * ROWA;
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        reinterpret_cast<float4*>(arn)[q * 32 + lane] =
            make_float4(gbt[4 * q], gbt[4 * q + 1], gbt[4 * q + 2],
                        gbt[4 * q + 3]);
        reinterpret_cast<float4*>(arn + ROWA)[q * 32 + lane] =
            make_float4(sdtt[4 * q], sdtt[4 * q + 1], sdtt[4 * q + 2],
                        sdtt[4 * q + 3]);
      }
      mbar_arrive(full + slot);
      // ---- the sums over n (ascending) and dx, d(dt) of channel j, by
      // the summing warps once every state's terms are in; the others go
      // on to the next channel ----
      const int rel = n >= rot ? n - rot : n - rot + nw;
      rot = rot + cw < nw ? rot + cw : rot + cw - nw;
      if (rel >= cw) continue;
      mbar_wait(full + slot, (walked >> 1) & 1);
      for (int vt = 32 * rel + lane; vt < SUM_THREADS; vt += 32 * cw) {
        const int kind = vt & 1, p = vt >> 1;
        const float4* src = reinterpret_cast<const float4*>(ar + kind * ROWA)
                            + p;
        float4 s4 = src[0];
        for (int m = 1; m < N; ++m) {
          const float4 t4 = src[m * (2 * ROWA / 4)];
          s4.x += t4.x, s4.y += t4.y, s4.z += t4.z, s4.w += t4.w;
        }
        float4 o4;   // the other kind's sums, from the neighbouring lane
        o4.x = __shfl_xor_sync(FULL, s4.x, 1);
        o4.y = __shfl_xor_sync(FULL, s4.y, 1);
        o4.z = __shfl_xor_sync(FULL, s4.z, 1);
        o4.w = __shfl_xor_sync(FULL, s4.w, 1);
        // kind 0: dx = dt gb; kind 1: d(dt) = x gb + sum A g e h
        const float4 w4 =
            reinterpret_cast<const float4*>(st + kind * ARR + jj * ROW)[p];
        float4 r4;
        if (kind == 0) {
          r4 = make_float4(w4.x * s4.x, w4.y * s4.y, w4.z * s4.z,
                           w4.w * s4.w);
        } else {
          r4 = make_float4(fmaf(w4.x, o4.x, s4.x), fmaf(w4.y, o4.y, s4.y),
                           fmaf(w4.z, o4.z, s4.z), fmaf(w4.w, o4.w, s4.w));
        }
        reinterpret_cast<float4*>(out + kind * ARR + jj * ROW)[p] = r4;
      }
      mbar_arrive(freed + slot);
    }
    if (g == c.ngrp - 1) {   // the span's dB, dC partials of this block
      const long long base =
          (((long long)c.b * gridDim.x + blockIdx.x) * 2 * N + n) * S;
      const long long other = (long long)N * S;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int t = t0 + lane * K + i;
        if (t < S) {
          part_bc[base + t] = acc_b[i];
          part_bc[base + other + t] = acc_c[i];
        }
      }
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) dal += __shfl_xor_sync(FULL, dal, m);
  if (lane == 0) s_da[da_at] += dal;
  __syncthreads();
  flush_out<V>(out, c, n_stages - 1);
  for (int e = threadIdx.x; e < nch * N; e += nthr) {
    const int j = e / N, m = e % N;
    const long long i = bdn + (long long)(c.d0 + j) * N + m;
    part_a[i] = s_da[j * N_MAX + m];
    if (dh0 != nullptr) dh0[i] = s_q[j * N_MAX + m];
  }
}

// dB, dC [B,S,N]: the blocks' partials summed in order; dA [D,N]: the
// batch rows' partials summed in order
__global__ void ssm_scan_backward_reduce(const float* __restrict__ part_bc,
                                         const float* __restrict__ part_a,
                                         float* __restrict__ db,
                                         float* __restrict__ dc,
                                         float* __restrict__ da, int B, int S,
                                         int D, int N, int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_bc = (long long)B * N * S;
  if (i < n_bc) {   // i = (b N + n) S + t: neighbouring threads, steps
    const int t = (int)(i % S), n = (int)(i / S % N), b = (int)(i / S / N);
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < nblk; ++k) {
      const long long p = (((long long)b * nblk + k) * 2 * N + n) * S + t;
      sb += part_bc[p];
      sc += part_bc[p + (long long)N * S];
    }
    db[((long long)b * S + t) * N + n] = sb;
    dc[((long long)b * S + t) * N + n] = sc;
  } else if (i - n_bc < (long long)D * N) {
    const long long j = i - n_bc;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += part_a[(long long)b * D * N + j];
    da[j] = s;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Inputs as the forward's, h_chunks the forward's saved states [B,
// ceil(S / 128), D, N], dy [B,S,D], gh [B,D,N] or null.  cpb: channels a
// block, a multiple of 8 from 8 to 256.  Partials (float32, contiguous):
// part_bc [B, ceil(D / cpb), 2, N, S], part_a [B, D, N].  Outputs: ddt, dx
// [B,S,D], db, dc [B,S,N], da [D,N], dh0 [B,D,N] or null.  Returns the
// CUDA error code of the launches.
extern "C" int ssm_scan_backward(
    const float* dt, const float* b_in, const float* c_in, const float* x,
    const float* a, const float* h_chunks, const float* dy, const float* gh,
    float* part_bc, float* part_a, float* ddt, float* db, float* dc,
    float* dx, float* da, float* dh0, int B, int S, int D, int N, int cpb,
    void* stream) {
  if (N < 1 || N > N_MAX || B < 1 || D < 1 || S < 1 || cpb < G ||
      cpb > CPB_MAX || cpb % G != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && aligned16(dt) && aligned16(x) &&
                   aligned16(dy) && aligned16(ddt) && aligned16(dx);
  auto kernel = vec ? ssm_scan_backward_kernel<4> : ssm_scan_backward_kernel<1>;
  static bool attr[2] = {false, false};   // the largest cpb's, once each
  if (!attr[vec]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * smem_floats(CPB_MAX)));
    if (err != cudaSuccess) return (int)err;
    attr[vec] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (D + cpb - 1) / cpb;
  const size_t smem = sizeof(float) * smem_floats(cpb);
  kernel<<<dim3(nblk, B), 32 * N, smem, s>>>(
      dt, b_in, c_in, x, a, h_chunks, dy, gh, ddt, dx, part_bc, part_a, dh0,
      S, D, N, cpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * S * N + (long long)D * N;
  ssm_scan_backward_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_bc, part_a, db, dc, da, B, S, D, N, nblk);
  return (int)cudaGetLastError();
}
