// Blocked online-softmax attention (GQA, causal, sliding window) for
// Hopper (sm_90a), fp32 arithmetic.
//
// Replaces: src/repro/kernels/flash_attention.py, `_flash_kernel`
// (pallas_call in `flash_attention_pallas`).  Same function as the plain
// version `repro_torch.kernels.flash_attention.flash_attention_plain` and
// the reference oracle `attention_reference`:
//   o[b,h,i] = softmax_j(q[b,h,i] . k[b,h*Hk/H,j] / sqrt(hd), masked) @ v
// q [B,H,Sq,hd], k/v [B,Hk,Sk,hd] in fp32, fp16 or bf16, o in q's type.
// Masked scores are -1e30 (not -inf), so a query row whose keys are all
// masked averages all Sk keys, as the Pallas kernel and the oracle do.  Keys
// at or past Sk (the ragged edge) take no part at all, and query rows at or
// past Sq are not written, so any Sq and Sk work (the Pallas kernel wants
// multiples of its block).  Strides are the caller's (the innermost
// dimension contiguous), so the model passes its [B,S,H,hd] projections
// transposed, without a copy.
//
// What bounds it on this card: at Llama 3.1 8B's prefill (q [4,32,512,128]
// fp16, k/v [4,8,512,128], causal) a call needs 8.6 GFLOP and moves 42 MB:
// 8.7 us at the tensor cores' 989 TFLOP/s, 12.5 us at 3.35 TB/s, so bytes.
// This first kernel runs on the fp32 FMA units (67 TFLOP/s, 128 us for the
// same work) and is bound by its shared-memory loads and FMAs.
//
// Design: one block per (b, h, 32-row query tile), 8 warps of 4 query rows
// each.  The block walks the key tiles its rows can see (causal: none past
// its last row; window: none before its first row's window) in 32-key
// tiles, staged in shared memory as fp32 (the K rows padded to hd + 1
// floats, so that lane j reading row j hits bank j).  Scores: lane j owns
// key j of the tile and runs the hd-long dot product for the warp's 4 rows
// (q rows read from shared memory as broadcasts), starting from 0 and
// scaled afterwards.  Softmax: per row a warp max and a warp sum by
// shuffles, the running max m and sum l kept in fp32 as in the Pallas
// kernel (m starts at -1e30).  P @ V: for each key j its probability is
// shuffled to the warp and lane l accumulates the output columns l, l + 32,
// l + 64, l + 96 (hd <= 128) from V's row j (consecutive lanes, consecutive
// banks).  The output is acc / max(l, 1e-30).  No tensor cores, no atomics:
// deterministic.  Tensor cores (wgmma), TMA and a pipelined K/V ring are the
// next version's.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RW = 4;               // query rows per warp
constexpr int BQ = WARPS * RW;      // query rows per block
constexpr int BK = 32;              // keys per tile: one per lane
constexpr int HD_MAX = 128;
constexpr int DPL = HD_MAX / 32;    // output columns per lane
constexpr float MASKED = -1e30f;    // the Pallas kernel's NEG_INF
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t)(BQ * hd + BK * (hd + 1) + BK * hd);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int Hk, int Sq,
    int Sk, int hd, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh,
    long long oss, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][hd]
  float* ks = qs + BQ * hd;          // [BK][hd + 1]
  float* vs = ks + BK * (hd + 1);    // [BK][hd]
  const int hdp = hd + 1;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = (int)((long long)h * Hk / H);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  T* ob = o + b * osb + h * osh;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * RW;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd, qi = q0 + r;
    qs[i] = qi < Sq ? to_f(qb[qi * qss + d]) : 0.0f;
  }

  // the key tiles some row of the block can see; a row whose keys are all
  // masked (only with a window and Sq > Sk) sees every key, at -1e30
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = 0;
  if (window > 0 && q_last < Sk + window - 1)
    k_begin = max(0, q0 - window + 1) / BK * BK;

  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = MASKED;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();   // the q tile is in; the previous K/V tile is used
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int j = i / hd, d = i - j * hd, kj = kt + j;
      float kv = 0.0f, vv = 0.0f;
      if (kj < Sk) {
        kv = to_f(kb[kj * kss + d]);
        vv = to_f(vb[kj * vss + d]);
      }
      ks[j * hdp + d] = kv;
      vs[j * hd + d] = vv;
    }
    __syncthreads();

    // scores of key kt + lane against the warp's rows
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.0f;
    const float* krow = ks + lane * hdp;
    const float* qrow = qs + r0 * hd;
    for (int d = 0; d < hd; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = fmaf(qrow[r * hd + d], kd, s[r]);
    }
    const int kj = kt + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int qi = q0 + r0 + r;
      float sr = s[r] * scale;
      bool visible = true;
      if (causal) visible = visible && kj <= qi;
      if (window > 0) visible = visible && kj > qi - window;
      sr = visible ? sr : MASKED;
      if (kj >= Sk) sr = -INFINITY;   // past the keys: no weight at all
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sr - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
      s[r] = p;
    }

    // acc += P @ V
    const int n_keys = min(BK, Sk - kt);
    for (int j = 0; j < n_keys; ++j) {
      float pj[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) pj[r] = __shfl_sync(FULL, s[r], j);
      const float* vrow = vs + j * hd;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          const float vd = vrow[d];
#pragma unroll
          for (int r = 0; r < RW; ++r) acc[r][i] = fmaf(pj[r], vd, acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) ob[qi * oss + d] = from_f<T>(acc[r][i] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hk, int Sq, int Sk, int hd, long long qsb,
           long long qsh, long long qss, long long ksb, long long ksh,
           long long kss, long long vsb, long long vsh, long long vss,
           long long osb, long long osh, long long oss, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hk, Sq, Sk, hd, qsb,
      qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 fp16, 2 bf16.  Strides in elements; hd <= 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hk, int Sq, int Sk, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int window, double scale,
    int dtype, void* stream) {
  if (hd < 1 || hd > HD_MAX || H % Hk != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = (float)scale;
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, B, H, Hk, Sq, Sk, hd, qsb, qsh, qss,
                           ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                           causal, window, sc, s);
    case 1:
      return launch<__half>(q, k, v, o, B, H, Hk, Sq, Sk, hd, qsb, qsh, qss,
                            ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                            causal, window, sc, s);
    case 2:
      return launch<__nv_bfloat16>(q, k, v, o, B, H, Hk, Sq, Sk, hd, qsb,
                                   qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
                                   osb, osh, oss, causal, window, sc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
