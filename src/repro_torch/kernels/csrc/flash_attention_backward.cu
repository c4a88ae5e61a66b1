// The gradient of blocked online-softmax attention (GQA, causal, sliding
// window) for Hopper (sm_90a): dq, dk and dv of the forward kernel in
// flash_attention.cu, for fp32, fp16 and bf16 inputs, float32 arithmetic.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp attention
// with XLA (under jax.checkpoint).  This kernel computes the same gradients
// as autograd over the plain version
// `repro_torch.kernels.flash_attention.flash_attention_plain`, so that LM
// training on the card runs its attention layers through kernels both ways.
//
// The function.  With s = scale q.k over the visible (query, key) pairs,
// P = softmax(s) per query row (masked scores -1e30, so P is 0 there; keys
// at or past Sk take no part), o = P v, and the forward's base-2 log-sum-exp
// lse[i] = m_i + log2(l_i) (m the row's largest score times log2 e, l the
// sum of 2^(s log2 e - m)):
//   P_ij  = 2^(s_ij log2 e - lse_i)
//   D_i   = sum_c dO_ic o_ic
//   dV_j  = sum_i P_ij dO_i         dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i  = scale sum_j dS_ij k_j   dK_j  = scale sum_i dS_ij q_i
// summed over the query heads h of a KV head (h * Hk / H).  A query row
// whose keys are all masked (a window, and Sq > Sk + window - 1 for the
// row) averages every key at -1e30 in the forward; its lse loses the log2
// of the count (-1e30 + 10 is -1e30 in fp32), so this kernel knows such a
// row by its index: P = 1 / Sk on every key, dS = 0 (its scores are
// constants).
//
// Design (a simple one that is right; ROADMAP queue B holds its redesign):
// three launches, float32 in shared memory, SIMT FMAs, no atomics, so two
// identical calls give the same bits.
//   1. D = rowsum(dO o), one warp a row.
//   2. dK, dV: one block per (b, KV head, 64-key tile) keeps its K and V
//      tile in shared memory and its dK, dV rows in registers (16 x 16
//      threads: 4 keys x HDP/16 columns each) and loops over the group's
//      query heads and the 64-row query tiles that see its keys: S = Q K^T
//      and dP = dO V^T as 4 x 4 register tiles, P through shared memory
//      for dV += P^T dO, then dS through the same buffer for dK += dS^T Q.
//   3. dQ: one block per (b, head, 64-row query tile) keeps Q, dO, lse and
//      D and loops over the key tiles its rows see.
// hd is zero-padded to HDP = 32, 64 or 128; shared rows are HDP + 1 floats
// wide, so a warp's 16 distinct rows of a column fall in 16 banks.
//
// What bounds it on this card: at SmolLM-135M's training shape (q
// [8,9,1024,64] bf16, k/v [8,3,1024,64], causal) the gradient needs 5
// products of 2 x hd flops a visible pair (S recomputed, dP, dV, dQ, dK),
// 10 x 64 x 72 heads x 525k pairs = 24.2 GFLOP: 24.5 us at the tensor
// cores' 989 TFLOP/s, 0.36 ms at the fp32 rate this kernel runs at,
// against 50 MB (q, k, v, o, dO read, dq, dk, dv written): 15 us.  So
// operations; this design does 7 of the 10 products' FMAs a pair (S and
// dP twice) from shared memory and takes ~2.2 ms there (PERF.md): the
// tensor cores (mma.sync or wgmma, as the forward) are the next version's.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD_MAX = 128;
constexpr int BQ = 64;            // query rows a tile
constexpr int BK = 64;            // keys a tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int LP = BK + 1;        // row stride of the P / dS buffer
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// element strides (b, h, s) of the ten tensors, in this order
enum { SQ = 0, SK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18,
       SDV = 21, N_STRIDES = 24 };

struct Params {
  const void *q, *k, *v, *o, *dout;
  const float* lse;     // [B, H, Sq], base 2, from the forward
  float* dsum;          // [B, H, Sq]: D, written by launch 1
  void *dq, *dk, *dv;
  long long st[N_STRIDES];
  int B, H, Hk, Sq, Sk, hd, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int qi, int kj, int causal,
                                        int window) {
  return (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}

// a row that sees no key: the forward averages all Sk keys at -1e30
__device__ __forceinline__ bool all_masked(int qi, int Sk, int window) {
  return window > 0 && (long long)qi >= (long long)Sk + window - 1;
}

// rows [row0, row0 + 64) of a [S, hd] matrix (row stride `stride`) into
// shared memory [64][HDP + 1] as float, zero past S and past hd
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int row0, int S,
                                          int hd) {
  constexpr int LD = HDP + 1;
  for (int i = threadIdx.x; i < 64 * HDP; i += THREADS) {
    const int r = i / HDP, c = i % HDP, row = row0 + r;
    dst[r * LD + c] =
        row < S && c < hd ? to_f<T>(src[(long long)row * stride + c]) : 0.0f;
  }
}

// launch 1: D = rowsum(dO o), one warp a row (b, h, i)
template <typename T>
__global__ void __launch_bounds__(THREADS) dsum_kernel(Params p) {
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.H * p.Sq) return;
  const int i = (int)(row % p.Sq);
  const int bh = (int)(row / p.Sq), b = bh / p.H, h = bh % p.H;
  const T* o = static_cast<const T*>(p.o) + b * p.st[SO] + h * p.st[SO + 1] +
               i * p.st[SO + 2];
  const T* g = static_cast<const T*>(p.dout) + b * p.st[SDO] +
               h * p.st[SDO + 1] + i * p.st[SDO + 2];
  float acc = 0.0f;
  for (int c = lane; c < p.hd; c += 32) acc += to_f<T>(o[c]) * to_f<T>(g[c]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) p.dsum[row] = acc;
}

template <int HDP> constexpr size_t smem_floats() {
  return 2 * (size_t)BK * (HDP + 1) + 2 * (size_t)BQ * (HDP + 1) +
         (size_t)BQ * LP + 2 * BQ;
}

// P (or 0) of this thread's 4 x 4 pairs from the scores s: rows
// q0 + ty + 16 a, keys k0 + tx + 16 c
__device__ __forceinline__ void probs(float (&s)[4][4], const Params& p,
                                      const float* ls, int q0, int k0,
                                      int ty, int tx) {
  const float sl2 = p.scale * LOG2E;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kj = k0 + tx + 16 * c;
      float pv = 0.0f;
      if (qi < p.Sq && kj < p.Sk) {
        if (all_masked(qi, p.Sk, p.window))
          pv = 1.0f / (float)p.Sk;
        else if (visible(qi, kj, p.causal, p.window))
          pv = exp2f(s[a][c] * sl2 - ls[ty + 16 * a]);
      }
      s[a][c] = pv;
    }
  }
}

// dS = P (dP - D) where the score depends on q and k, else 0
__device__ __forceinline__ float dscore(float pv, float dp, float d,
                                        const Params& p, int qi, int kj) {
  if (qi >= p.Sq || kj >= p.Sk || all_masked(qi, p.Sk, p.window) ||
      !visible(qi, kj, p.causal, p.window))
    return 0.0f;
  return pv * (dp - d);
}

// out[a][c] = sum_d x[ty + 16 a][d] y[tx + 16 c][d] over shared [64][HDP+1]
template <int HDP>
__device__ __forceinline__ void tile_product(float (&out)[4][4],
                                             const float* x, const float* y,
                                             int ty, int tx) {
  constexpr int LD = HDP + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[a][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xv[a] = x[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) yv[c] = y[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[a][c] = fmaf(xv[a], yv[c], out[a][c]);
  }
}

// launch 2: dK and dV of one (b, KV head, key tile)
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Params p) {
  constexpr int LD = HDP + 1, NE = HDP / 16;
  extern __shared__ float smem[];
  float* ks = smem;               // [BK][LD]
  float* vs = ks + BK * LD;       // [BK][LD]
  float* qs = vs + BK * LD;       // [BQ][LD]
  float* gs = qs + BQ * LD;       // dO [BQ][LD]
  float* ps = gs + BQ * LD;       // [BQ][LP]: P, then dS
  float* ls = ps + BQ * LP;       // lse [BQ]
  float* dd = ls + BQ;            // D [BQ]

  const int n_kt = (p.Sk + BK - 1) / BK;
  const int kt = (int)blockIdx.x % n_kt, bk = (int)blockIdx.x / n_kt;
  const int b = bk / p.Hk, hk = bk % p.Hk;
  const int k0 = kt * BK, k_last = min(k0 + BK, p.Sk) - 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int G = p.H / p.Hk;
  load_rows<T, HDP>(ks,
                    static_cast<const T*>(p.k) + b * p.st[SK] +
                        hk * p.st[SK + 1],
                    p.st[SK + 2], k0, p.Sk, p.hd);
  load_rows<T, HDP>(vs,
                    static_cast<const T*>(p.v) + b * p.st[SV] +
                        hk * p.st[SV + 1],
                    p.st[SV + 2], k0, p.Sk, p.hd);
  float dk[4][NE], dv[4][NE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < NE; ++e) dk[a][e] = dv[a][e] = 0.0f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const long long row_off = ((long long)b * p.H + h) * p.Sq;
    for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
      const int q_last = min(q0 + BQ, p.Sq) - 1;
      // tiles none of whose rows see these keys (all-masked rows see all)
      if (p.causal && q_last < k0) continue;
      if (p.window > 0 && q0 - p.window + 1 > k_last &&
          (long long)q_last < (long long)p.Sk + p.window - 1)
        continue;
      __syncthreads();   // the last tile's reads are done (and K/V landed)
      load_rows<T, HDP>(qs,
                        static_cast<const T*>(p.q) + b * p.st[SQ] +
                            h * p.st[SQ + 1],
                        p.st[SQ + 2], q0, p.Sq, p.hd);
      load_rows<T, HDP>(gs,
                        static_cast<const T*>(p.dout) + b * p.st[SDO] +
                            h * p.st[SDO + 1],
                        p.st[SDO + 2], q0, p.Sq, p.hd);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool in = q0 + i < p.Sq;
        ls[i] = in ? p.lse[row_off + q0 + i] : 0.0f;
        dd[i] = in ? p.dsum[row_off + q0 + i] : 0.0f;
      }
      __syncthreads();
      float pr[4][4];
      tile_product<HDP>(pr, qs, ks, ty, tx);
      probs(pr, p, ls, q0, k0, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) ps[(ty + 16 * a) * LP + tx + 16 * c] = pr[a][c];
      __syncthreads();
      // dV[key ty + 16 a][col tx + 16 e] += sum_i P[i][key] dO[i][col]
      for (int i = 0; i < BQ; ++i) {
        float pv[4], gv[NE];
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[a] = ps[i * LP + ty + 16 * a];
#pragma unroll
        for (int e = 0; e < NE; ++e) gv[e] = gs[i * LD + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < NE; ++e) dv[a][e] = fmaf(pv[a], gv[e], dv[a][e]);
      }
      float dp[4][4];
      tile_product<HDP>(dp, gs, vs, ty, tx);
      __syncthreads();   // every thread has read P
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ps[(ty + 16 * a) * LP + tx + 16 * c] =
              dscore(pr[a][c], dp[a][c], dd[ty + 16 * a], p,
                     q0 + ty + 16 * a, k0 + tx + 16 * c);
      __syncthreads();
      // dK[key][col] += sum_i dS[i][key] Q[i][col]
      for (int i = 0; i < BQ; ++i) {
        float sv[4], qv[NE];
#pragma unroll
        for (int a = 0; a < 4; ++a) sv[a] = ps[i * LP + ty + 16 * a];
#pragma unroll
        for (int e = 0; e < NE; ++e) qv[e] = qs[i * LD + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < NE; ++e) dk[a][e] = fmaf(sv[a], qv[e], dk[a][e]);
      }
    }
  }
  T* dkb = static_cast<T*>(p.dk) + b * p.st[SDK] + hk * p.st[SDK + 1];
  T* dvb = static_cast<T*>(p.dv) + b * p.st[SDV] + hk * p.st[SDV + 1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int c = tx + 16 * e;
      if (c < p.hd) {
        dkb[kj * p.st[SDK + 2] + c] = from_f<T>(dk[a][e] * p.scale);
        dvb[kj * p.st[SDV + 2] + c] = from_f<T>(dv[a][e]);
      }
    }
  }
}

// launch 3: dQ of one (b, head, query tile)
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  constexpr int LD = HDP + 1, NE = HDP / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* gs = qs + BQ * LD;
  float* ps = gs + BQ * LD;       // dS
  float* ls = ps + BQ * LP;
  float* dd = ls + BQ;

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt = (int)blockIdx.x % n_qt, bh = (int)blockIdx.x / n_qt;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = (int)((long long)h * p.Hk / p.H);
  const int q0 = qt * BQ, q_last = min(q0 + BQ, p.Sq) - 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row_off = ((long long)b * p.H + h) * p.Sq;
  load_rows<T, HDP>(qs,
                    static_cast<const T*>(p.q) + b * p.st[SQ] +
                        h * p.st[SQ + 1],
                    p.st[SQ + 2], q0, p.Sq, p.hd);
  load_rows<T, HDP>(gs,
                    static_cast<const T*>(p.dout) + b * p.st[SDO] +
                        h * p.st[SDO + 1],
                    p.st[SDO + 2], q0, p.Sq, p.hd);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const bool in = q0 + i < p.Sq;
    ls[i] = in ? p.lse[row_off + q0 + i] : 0.0f;
    dd[i] = in ? p.dsum[row_off + q0 + i] : 0.0f;
  }
  // the keys some row of the tile sees (all-masked rows add nothing to dQ)
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
  const T* kb = static_cast<const T*>(p.k) + b * p.st[SK] + hk * p.st[SK + 1];
  const T* vb = static_cast<const T*>(p.v) + b * p.st[SV] + hk * p.st[SV + 1];
  float dq[4][NE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < NE; ++e) dq[a][e] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the last tile's reads are done
    load_rows<T, HDP>(ks, kb, p.st[SK + 2], k0, p.Sk, p.hd);
    load_rows<T, HDP>(vs, vb, p.st[SV + 2], k0, p.Sk, p.hd);
    __syncthreads();
    float pr[4][4], dp[4][4];
    tile_product<HDP>(pr, qs, ks, ty, tx);
    probs(pr, p, ls, q0, k0, ty, tx);
    tile_product<HDP>(dp, gs, vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ps[(ty + 16 * a) * LP + tx + 16 * c] =
            dscore(pr[a][c], dp[a][c], dd[ty + 16 * a], p, q0 + ty + 16 * a,
                   k0 + tx + 16 * c);
    __syncthreads();
    // dQ[row ty + 16 a][col tx + 16 e] += sum_j dS[row][j] K[j][col]
    for (int j = 0; j < BK; ++j) {
      float sv[4], kv[NE];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = ps[(ty + 16 * a) * LP + j];
#pragma unroll
      for (int e = 0; e < NE; ++e) kv[e] = ks[j * LD + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < NE; ++e) dq[a][e] = fmaf(sv[a], kv[e], dq[a][e]);
    }
  }
  T* dqb = static_cast<T*>(p.dq) + b * p.st[SDQ] + h * p.st[SDQ + 1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int c = tx + 16 * e;
      if (c < p.hd) dqb[qi * p.st[SDQ + 2] + c] = from_f<T>(dq[a][e] * p.scale);
    }
  }
}

template <typename T, int HDP>
int launch_hdp(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)p.B * p.H * p.Sq;
  const long long blocks1 = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const long long blocks2 = (long long)((p.Sk + BK - 1) / BK) * p.B * p.Hk;
  const long long blocks3 = (long long)((p.Sq + BQ - 1) / BQ) * p.B * p.H;
  if (blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL ||
      blocks3 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dsum_kernel<T><<<(unsigned)blocks1, THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, HDP><<<(unsigned)blocks2, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, HDP><<<(unsigned)blocks3, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  return p.hd <= 32   ? launch_hdp<T, 32>(p, stream)
         : p.hd <= 64 ? launch_hdp<T, 64>(p, stream)
                      : launch_hdp<T, 128>(p, stream);
}

}  // namespace

// q [B,H,Sq,hd], k/v [B,Hk,Sk,hd], o and dout [B,H,Sq,hd] in one type
// (dtype 0 fp32, 1 fp16, 2 bf16); lse the forward's base-2 statistics and
// dsum scratch, both float32 [B,H,Sq] contiguous; dq/dk/dv outputs in the
// inputs' type.  `strides` points to 24 host int64: (b, h, s) element
// strides of q, k, v, o, dout, dq, dk, dv; the last dimension is
// contiguous.  Returns the CUDA error code of the launches (0 on success).
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dsum, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int Hk, int Sq, int Sk,
    int hd, int causal, int window, double scale, int dtype, void* stream) {
  if (hd < 1 || hd > HD_MAX || Hk < 1 || H % Hk != 0 || B < 1 || Sq < 1 ||
      Sk < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q, p.k = k, p.v = v, p.o = o, p.dout = dout, p.lse = lse;
  p.dsum = dsum, p.dq = dq, p.dk = dk, p.dv = dv;
  for (int i = 0; i < N_STRIDES; ++i) p.st[i] = strides[i];
  p.B = B, p.H = H, p.Hk = Hk, p.Sq = Sq, p.Sk = Sk, p.hd = hd;
  p.causal = causal, p.window = window, p.scale = (float)scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, s);
    case 1: return launch<__half>(p, s);
    case 2: return launch<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
