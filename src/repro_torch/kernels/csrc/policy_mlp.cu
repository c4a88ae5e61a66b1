// Fused 3-layer tanh-GELU MLP for Hopper (sm_90a), fp32 FMA.
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
// (67 TFLOP/s); at the calibration's B = 64 to 448 rows the 88 KB of
// weights dominate the bytes and the bound is under a microsecond.
//
// Design, and what it does about that: a persistent grid of at most two
// blocks per SM (256 threads each) walks over 16-row tiles.  Each block
// first copies all weights and biases into shared memory, once for all its
// tiles (87 KB at the world model's widths, 76 KB at the surrogate's;
// dynamic shared memory above 48 KB); the tile's input and both hidden
// layers stay in shared memory beside them (110 KB a block at most, so two
// blocks fit an SM).  In each layer warp w owns rows 2w and 2w + 1 of the
// tile and lane l the columns l, l + 32, l + 64 and l + 96: per step of k
// a lane reads its two inputs (the same address across the warp, one
// broadcast) and up to four weights (consecutive across the warp, no bank
// conflict) and does up to eight FMAs, all from shared memory.  Every dot
// product starts from 0, runs over k in order and takes its bias last, as
// x @ W + b does; no atomics, so the kernel is deterministic.  fp32 FMA
// only (no tensor cores, no TF32).  Layer widths (h1, h2, d_out) are at
// most 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16;             // rows per tile
constexpr int TR = ROWS / WARPS;     // rows per warp
constexpr int TC = 4;                // columns per lane: widths <= 128
constexpr int BLOCKS_PER_SM = 2;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

// out[r][c] = act(sum_k in[r][k] * w[k][c] + b[c]) for the tile's rows;
// in, w, b and out all in shared memory, dout <= 32 * TC.
template <bool GELU>
__device__ __forceinline__ void dense(const float* in, int din,
                                      const float* w, const float* b,
                                      int dout, float* out) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * TR;
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < din; ++k) {
    float xv[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) xv[i] = in[(r0 + i) * din + k];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = lane + 32 * j;
      if (c < dout) {
        const float wk = w[k * dout + c];
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][j] = fmaf(xv[i], wk, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int c = lane + 32 * j;
    if (c < dout) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float v = acc[i][j] + b[c];
        out[(r0 + i) * dout + c] = GELU ? gelu_tanh(v) : v;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ float load_f(const T* p, size_t i);
template <>
__device__ __forceinline__ float load_f<float>(const float* p, size_t i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(
    const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ void copy_to_shared(float* dst,
                                               const float* __restrict__ src,
                                               int n) {
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ w3,
                 const float* __restrict__ b3, T* __restrict__ y, int B,
                 int din, int h1, int h2, int dout) {
  extern __shared__ float smem[];
  float* sw1 = smem;                // [din][h1]
  float* sb1 = sw1 + din * h1;      // [h1]
  float* sw2 = sb1 + h1;            // [h1][h2]
  float* sb2 = sw2 + h1 * h2;       // [h2]
  float* sw3 = sb2 + h2;            // [h2][dout]
  float* sb3 = sw3 + h2 * dout;     // [dout]
  float* xs = sb3 + dout;           // [ROWS][din]
  float* hs1 = xs + ROWS * din;     // [ROWS][h1]
  float* hs2 = hs1 + ROWS * h1;     // [ROWS][h2]
  float* ys = hs2 + ROWS * h2;      // [ROWS][dout]

  copy_to_shared(sw1, w1, din * h1);
  copy_to_shared(sb1, b1, h1);
  copy_to_shared(sw2, w2, h1 * h2);
  copy_to_shared(sb2, b2, h2);
  copy_to_shared(sw3, w3, h2 * dout);
  copy_to_shared(sb3, b3, dout);
  const int tiles = (B + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    __syncthreads();  // the previous tile's output is stored
    for (int i = threadIdx.x; i < ROWS * din; i += blockDim.x) {
      const int r = i / din, c = i % din;
      xs[i] = row0 + r < B ? load_f(x, (size_t)(row0 + r) * din + c) : 0.0f;
    }
    __syncthreads();
    dense<true>(xs, din, sw1, sb1, h1, hs1);
    __syncthreads();
    dense<true>(hs1, h1, sw2, sb2, h2, hs2);
    __syncthreads();
    dense<false>(hs2, h2, sw3, sb3, dout, ys);
    __syncthreads();
    for (int i = threadIdx.x; i < ROWS * dout; i += blockDim.x) {
      const int r = i / dout, c = i % dout;
      if (row0 + r < B) store_f(y, (size_t)(row0 + r) * dout + c, ys[i]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, void* y, int B,
           int din, int h1, int h2, int dout, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)din * h1 + h1 + (size_t)h1 * h2 + h2 +
                       (size_t)h2 * dout + dout +
                       (size_t)ROWS * (din + h1 + h2 + dout));
  auto kernel = fused_mlp_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (B + ROWS - 1) / ROWS;
  const int blocks = tiles < BLOCKS_PER_SM * sms ? tiles : BLOCKS_PER_SM * sms;
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), w1, b1, w2, b2, w3, b3, static_cast<T*>(y),
      B, din, h1, h2, dout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point bound with ctypes.  Device pointers of contiguous
// tensors: x [B, din] (float32, or bfloat16 if bf16 != 0), w1 [din, h1],
// b1 [h1], w2 [h1, h2], b2 [h2], w3 [h2, dout], b3 [dout] (float32); out y
// [B, dout] in x's type.  h1, h2, dout <= 128, and the weights and a
// 16-row tile must fit in a block's 227 KB of shared memory.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fused_mlp_forward(const void* x, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* b2, const float* w3,
                                 const float* b3, void* y, int B, int din,
                                 int h1, int h2, int dout, int bf16,
                                 void* stream) {
  if (B <= 0) return 0;
  if (din < 1 || h1 < 1 || h2 < 1 || dout < 1 || h1 > 32 * TC ||
      h2 > 32 * TC || dout > 32 * TC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, y, B, din,
                                      h1, h2, dout, s)
              : launch<float>(x, w1, b1, w2, b2, w3, b3, y, B, din, h1, h2,
                              dout, s);
}
