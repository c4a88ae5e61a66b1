// Fused 3-layer tanh-GELU MLP for Hopper (sm_90a), 3xTF32 on the tensor
// cores.
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
// (67 TFLOP/s); at the calibration's B = 448 rows the weights (76 KB) and
// the three dependent layers make it a matter of latency.
//
// Design, and what it does about that: the body in mlp_tf32.cuh (3xTF32
// mma.sync.m16n8k8, W1 and W2 by tensor copies, 16-row tiles) with x's
// rows as they are: one CTA an SM at most, of G groups of 4 warps (G = 1,
// 2 or 4 by B), each group walking over its own 16-row tiles while the
// weights are shared; the next x tile streams into a second buffer while
// the current one runs.  x stays in its own type (fp32, or bf16 pairs,
// exact in TF32, so layer 1 then skips lo.hi); a bf16 x 4-byte aligned
// with d_in even.  The launch attributes and the SM count are read once a
// device.
#include "mlp_tf32.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int COL_WARPS = 4;                     // warps a 16-row tile
constexpr int GROUP = 32 * COL_WARPS;
constexpr int MAX_DIN = 256;                     // rows of W1's box

__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// rows of x [B, din] in and of y [B, dout] out, both in type T
template <typename T>
struct XRows {
  static constexpr bool BF16 = sizeof(T) == 2;
  const T* x;
  T* y;
  int B, din, dout;
  __device__ int count() const { return B; }
  // start the copies of tile `tile`'s x into `dst` [16][sx] by the group's
  // 128 threads (gt): 4-byte pieces (one fp32, or a bf16 pair: d_in even),
  // zeros past B and d_in (up to k1)
  template <int GROUP_>
  __device__ __forceinline__ void copy(float* dst, int tile, const Layout& L,
                                       int gt) const {
    constexpr int PER = 4 / sizeof(T);            // elements a piece
    static_assert(GROUP_ == 8 * ROWS, "8 threads a row");
    const int pieces = L.k1 / PER, r = gt >> 3, row = tile * ROWS + r;
    const T* src = x + (size_t)(row < B ? row : 0) * din;
    for (int p = gt & 7; p < pieces; p += 8) {
      const bool ok = row < B && p * PER < din;
      cp_async4(dst + r * L.sx + p, src + (ok ? p * PER : 0), ok);
    }
  }
  // nothing of the x tile is needed after layer 1
  struct Pro {};
  template <int COLW>
  __device__ __forceinline__ Pro prologue(const float*, int, int) const {
    return {};
  }
  // layer 3's n-tiles of this warp plus the bias into y (rows g, g + 8;
  // columns 2t, 2t + 1)
  template <int COLW>
  __device__ __forceinline__ void store(const float (&acc)[ntw<COLW>()][4],
                                        int tile, int c, int nt3,
                                        const float* sb3, Pro) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row0 = tile * ROWS;
#pragma unroll
    for (int j = 0; j < ntw<COLW>(); ++j) {
      if (j < nt3) {
        const int col = 8 * (c + COLW * j) + 2 * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + g + 8 * (i >> 1), cc = col + (i & 1);
          if (r < B && cc < dout)
            store_f(y, (size_t)r * dout + cc, acc[j][i] + sb3[cc]);
        }
      }
    }
  }
};

template <typename T, int G>
__global__ void __launch_bounds__(GROUP * G, 1)
fused_mlp_kernel(const T* __restrict__ x, const float* __restrict__ b1,
                 const float* __restrict__ b2, const float* __restrict__ w3,
                 const float* __restrict__ b3, T* __restrict__ y, int B,
                 int din, int h1, int h2, int dout,
                 const __grid_constant__ CUtensorMap w1map,
                 const __grid_constant__ CUtensorMap w2map) {
  mlp_tiles<XRows<T>, G, COL_WARPS>(XRows<T>{x, y, B, din, dout},
                                    Weights{b1, b2, w3, b3}, din, h1, h2,
                                    dout, &w1map, &w2map);
}

template <typename T, int G>
int launch(const void* x, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, void* y, int B,
           int din, int h1, int h2, int dout, int device, int sms,
           cudaStream_t stream) {
  static bool ready[MAX_DEVICES];   // the shared-memory limit and carveout
  auto kernel = fused_mlp_kernel<T, G>;
  const Layout L(din, h1, h2, dout, sizeof(T) == 2, G);
  CUtensorMap m1, m2;
  const cudaError_t e =
      prepare(kernel, ready, device, L, w1, w2, din, h1, h2, &m1, &m2);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ctas = ((B + ROWS - 1) / ROWS + G - 1) / G;
  kernel<<<ctas < sms ? ctas : sms, GROUP * G, L.bytes(), stream>>>(
      static_cast<const T*>(x), b1, b2, w3, b3, static_cast<T*>(y), B, din,
      h1, h2, dout, m1, m2);
  return static_cast<int>(cudaGetLastError());
}

// Groups of 4 warps a CTA (one CTA an SM, each group its own 16-row
// tiles, the weights shared): 1 while the tiles fit on the SMs one to a
// CTA, then 2, then 4.  -DMLP_GROUPS=1, 2 or 4 forces one
// (scripts/search_kernels_ab.py times them).
template <typename T>
int dispatch(const void* x, const float* w1, const float* b1, const float* w2,
             const float* b2, const float* w3, const float* b3, void* y, int B,
             int din, int h1, int h2, int dout, cudaStream_t stream) {
  int device = 0, sms = 0;
  const cudaError_t e = device_sms(&device, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (B + ROWS - 1) / ROWS;
#ifdef MLP_GROUPS
  const int groups = MLP_GROUPS;
#else
  const int groups = tiles <= sms ? 1 : tiles <= 2 * sms ? 2 : 4;
#endif
  auto run = groups == 1 ? launch<T, 1> : groups == 2 ? launch<T, 2>
                                                      : launch<T, 4>;
  return run(x, w1, b1, w2, b2, w3, b3, y, B, din, h1, h2, dout, device, sms,
             stream);
}

}  // namespace

// Plain C entry point bound with ctypes.  Device pointers of contiguous
// tensors: x [B, din] (float32, or bfloat16 if bf16 != 0), w1 [din, h1],
// b1 [h1], w2 [h1, h2], b2 [h2], w3 [h2, dout], b3 [dout] (float32; w1 and
// w2 16-byte aligned); out y [B, dout] in x's type.  din <= 256, h1 and h2
// multiples of 4, h1, h2, dout <= 128; a bf16 x 4-byte aligned, din even.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int fused_mlp_forward(const void* x, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* b2, const float* w3,
                                 const float* b3, void* y, int B, int din,
                                 int h1, int h2, int dout, int bf16,
                                 void* stream) {
  if (B <= 0) return 0;
  if (din < 1 || din > MAX_DIN || h1 < 4 || h2 < 4 || dout < 1 ||
      h1 > MAX_WIDTH || h2 > MAX_WIDTH || dout > MAX_WIDTH || h1 % 4 != 0 ||
      h2 % 4 != 0 || reinterpret_cast<uintptr_t>(w1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w2) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16 && (din % 2 != 0 || reinterpret_cast<uintptr_t>(x) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, y, B, din,
                                        h1, h2, dout, s)
              : dispatch<float>(x, w1, b1, w2, b2, w3, b3, y, B, din, h1, h2,
                                dout, s);
}
