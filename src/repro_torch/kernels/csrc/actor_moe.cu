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
// the H100's fp32 rate (67 TFLOP/s) bounds it at under 1 us.  A few row
// tiles cannot fill 132 SMs, so what a call costs is latency: the weights'
// trip from L2 and the dependent layers.
//
// Design, and what it does about that: one launch of thread-block clusters
// of 8 CTAs, one cluster per tile of TB rows: CTA (k, h) of the cluster runs
// expert k on hidden units [128h, 128h + 128).  At B = 64 and TB = 8 that is
// 64 CTAs.  Every weight a CTA needs streams in by bulk copies (TMA, one
// instruction per contiguous piece or per box of a tensor map, completion
// counted on an mbarrier), all started before any arithmetic: W1 whole and
// the state tile, then W2's columns of this half as 8 boxes of 32 rows, one
// mbarrier per warp's box.  So the copies run behind the arithmetic and L2's
// latency is paid about once.  Layer 1 is computed whole (256 units, 4 a
// thread over TB / 4 rows), so no exchange is needed before layer 2; once
// it is done, the heads' rows of this half stream into W1's place.  Layer
// 2: warp w multiplies rows [32w, 32w + 32) of W2 into TB x 4 register
// accumulators per lane (float4 reads of W2, broadcast reads of h1), leaves
// its partial sums in the rows it consumed, and the 8 partials are summed
// in warp order.  The heads: partial products over this CTA's 128 rows of
// h2 in three parts (the spare threads compute the gate softmax meanwhile),
// summed in order; warp q stores rows q, q + 8, ... into CTA q's shared
// memory (distributed shared memory) and arrives on CTA q's mbarrier, so no
// cluster-wide barrier waits for the slowest CTA twice.  Each CTA then
// blends its rows from its own shared memory, the experts in the fixed
// order k = 0..3.  Each output is written once; no scratch tensor, no
// second kernel.  Every sum runs in a fixed order with no atomics, so the
// kernel is deterministic run to run.  fp32 FMA only (no tensor cores, no
// TF32) to stay within 1e-4 of the fp32 reference.  Each dot product starts
// from 0 and takes its bias last, as x @ W + b does: started from a large
// bias, every partial sum would round at the bias's magnitude.
#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap; its encoder is looked up at run time
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int S = 52;            // SAC state dim
constexpr int H = 256;           // expert hidden width
constexpr int HH = H / 2;        // hidden units per CTA
constexpr int E = 4;             // experts
constexpr int ND = 20;           // discrete logits (4 x 5)
constexpr int NC = 30;           // continuous dims
constexpr int NO = ND + 2 * NC;  // 80 head outputs per expert
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KS = H / WARPS;    // 32 rows of W2 per warp
constexpr int CLUSTER = 2 * E;   // CTAs per row tile
constexpr int HEAD_PART = 44;    // the heads' rows in parts of 44, 44, 40
// mbarriers: the state tile and W1, W2 per warp, the heads' rows, the
// heads pushed to this CTA by the cluster's 8 x 32 pushing threads
constexpr int BAR_IN = 0, BAR_W2 = 1, BAR_WH = 1 + WARPS, BAR_RECV = 2 + WARPS,
              NBARS = 3 + WARPS;

// Shared memory of one CTA, in floats; every part a multiple of 4 floats.
// W1 [52][256] shares its place with the heads' rows [128][20 | 30 | 30],
// which are copied in once layer 1 is done, and W2 with the heads' partial
// products once layer 2 is done.
template <int TB>
struct Smem {
  static constexpr int MR = TB / CLUSTER;       // rows this CTA blends
  static constexpr int w2 = H * HH;             // W2 [256][128], 128 KB
  static constexpr int w1 = S * H;              // 52 KB >= the heads' 40 KB
  static constexpr int h1 = TB * H;
  static constexpr int xs = TB * S;
  static constexpr int h2 = TB * HH;
  static constexpr int recv = 2 * E * MR * NO;  // heads pushed here to blend
  static constexpr int g = ((MR * E + 3) / 4) * 4;
  static constexpr int floats = w2 + w1 + h1 + xs + h2 + recv + g;
  static constexpr size_t bytes = sizeof(float) * floats + 8 * NBARS;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// arrive on CTA `rank`'s copy of `bar`, ordering this thread's earlier
// stores (to any CTA of the cluster) before the arrival
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   unsigned rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(rank) : "memory");
}

// wait for phase 0 of `bar`; acquire at cluster scope, so that what other
// CTAs stored before arriving is visible
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], 0;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)) : "memory");
}

// tensor copy (TMA) of the box at (c0, c1, c2) of `map` into this CTA's
// shared memory (128-byte aligned), counted on `bar`
__device__ __forceinline__ void tensor_copy(float* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar)) : "memory");
}

// bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to this CTA's shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

template <int TB>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
__launch_bounds__(THREADS, 1)
actor_moe_kernel(const float* __restrict__ s, const float* __restrict__ gate_w,
                 const float* __restrict__ l1w, const float* __restrict__ l1b,
                 const float* __restrict__ l2b,
                 const float* __restrict__ dw, const float* __restrict__ db,
                 const float* __restrict__ mw, const float* __restrict__ mb,
                 const float* __restrict__ lw, const float* __restrict__ lb,
                 float* __restrict__ disc, float* __restrict__ mu,
                 float* __restrict__ log_std, float* __restrict__ gate,
                 int B, const __grid_constant__ CUtensorMap w2map) {
  using L = Smem<TB>;
  static_assert(TB % CLUSTER == 0, "a CTA blends TB / 8 rows");
  constexpr int MR = L::MR;
  extern __shared__ __align__(128) float sm[];
  float* w2s = sm;
  float* w1s = w2s + L::w2;
  float* whs = w1s;              // the heads' rows, after layer 1
  float* h1 = w1s + L::w1;
  float* xs = h1 + L::h1;
  float* h2 = xs + L::xs;
  float* recv = h2 + L::h2;
  float* gs = recv + L::recv;
  float* hp = w2s;               // [3][TB][NO], after layer 2
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::floats);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int k = rank >> 1, half = rank & 1;
  const int r0 = (blockIdx.x / CLUSTER) * TB;
  const int rows = B - r0 < TB ? B - r0 : TB;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t == 0) {
    for (int i = 0; i < NBARS; ++i)
      mbar_init(bars + i, i == BAR_RECV ? THREADS : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = rows * S + t; i < TB * S; i += THREADS) xs[i] = 0.0f;
  __syncthreads();
  // the other CTAs' mbarriers are initialised before anyone arrives on
  // them: arrive here, wait before the first remote access
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 1. start every copy: the state tile and W1, then W2's columns of this
  // half, rows [32w, 32w + 32) by one tensor copy of warp w
  if (t == 0) {
    mbar_expect_tx(bars + BAR_IN, sizeof(float) * (rows * S + S * H));
    bulk_copy(xs, s + static_cast<size_t>(r0) * S, sizeof(float) * rows * S,
              bars + BAR_IN);
    bulk_copy(w1s, l1w + static_cast<size_t>(k) * S * H,
              sizeof(float) * S * H, bars + BAR_IN);
  }
  if (lane == 0) {
    mbar_expect_tx(bars + BAR_W2 + warp, sizeof(float) * KS * HH);
    tensor_copy(w2s + warp * KS * HH, &w2map, half * HH, warp * KS, k,
                bars + BAR_W2 + warp);
  }

  // 2. layer 1: units 4 (t % 64) .. + 3 of rows t / 64 + 4 r (float4 reads
  // of W1, broadcast reads of the state), each from 0, bias last
  mbar_wait(bars + BAR_IN);
  {
    constexpr int RQ = TB / 4;
    const int c4 = 4 * (t % (H / 4)), g0 = t / (H / 4);
    float acc[RQ][4];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < S; i += 4) {
      float4 w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = *reinterpret_cast<const float4*>(w1s + (i + q) * H + c4);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 x =
            *reinterpret_cast<const float4*>(xs + (g0 + 4 * r) * S + i);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] = fmaf(xv[q], w[q].x, acc[r][0]);
          acc[r][1] = fmaf(xv[q], w[q].y, acc[r][1]);
          acc[r][2] = fmaf(xv[q], w[q].z, acc[r][2]);
          acc[r][3] = fmaf(xv[q], w[q].w, acc[r][3]);
        }
      }
    }
    const float4 b = *reinterpret_cast<const float4*>(l1b + k * H + c4);
#pragma unroll
    for (int r = 0; r < RQ; ++r)
      *reinterpret_cast<float4*>(h1 + (g0 + 4 * r) * H + c4) = make_float4(
          gelu_tanh(acc[r][0] + b.x), gelu_tanh(acc[r][1] + b.y),
          gelu_tanh(acc[r][2] + b.z), gelu_tanh(acc[r][3] + b.w));
  }
  __syncthreads();
  // W1 is consumed: the heads' rows of this half take its place
  if (t == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const size_t row0 = static_cast<size_t>(k) * H + half * HH;
    mbar_expect_tx(bars + BAR_WH, sizeof(float) * HH * NO);
    bulk_copy(whs, dw + row0 * ND, sizeof(float) * HH * ND, bars + BAR_WH);
    bulk_copy(whs + HH * ND, mw + row0 * NC, sizeof(float) * HH * NC,
              bars + BAR_WH);
    bulk_copy(whs + HH * (ND + NC), lw + row0 * NC, sizeof(float) * HH * NC,
              bars + BAR_WH);
  }

  // 3. layer 2: warp w's 32 rows of W2 into TB x 4 accumulators per lane
  // (columns 4 lane .. 4 lane + 3 of this half)
  mbar_wait(bars + BAR_W2 + warp);
  {
    float* rows_w = w2s + warp * KS * HH;
    float acc[TB][4];
#pragma unroll
    for (int r = 0; r < TB; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < KS; kk += 4) {
      float4 w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = *reinterpret_cast<const float4*>(rows_w + (kk + q) * HH +
                                                4 * lane);
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const float4 x =
            *reinterpret_cast<const float4*>(h1 + r * H + warp * KS + kk);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] = fmaf(xv[q], w[q].x, acc[r][0]);
          acc[r][1] = fmaf(xv[q], w[q].y, acc[r][1]);
          acc[r][2] = fmaf(xv[q], w[q].z, acc[r][2]);
          acc[r][3] = fmaf(xv[q], w[q].w, acc[r][3]);
        }
      }
    }
    __syncwarp();   // the rows are consumed: their partial sums go there
#pragma unroll
    for (int r = 0; r < TB; ++r)
      *reinterpret_cast<float4*>(rows_w + r * HH + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  {
    const int col = t % HH;
    const float b = l2b[k * H + half * HH + col];
    for (int r = t / HH; r < TB; r += THREADS / HH) {
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc += w2s[(w * KS + r) * HH + col];
      h2[r * HH + col] = gelu_tanh(acc + b);
    }
  }
  __syncthreads();

  // 4. heads: partial products over rows [44 p, 44 p + 44) of this half's
  // 128 (240 threads); the other 16 compute the gate softmax of the rows
  // this CTA blends
  if (t < 3 * NO) {
    mbar_wait(bars + BAR_WH);
    const int o = t % NO, part = t / NO;
    const float* w;
    int ld;
    if (o < ND) {
      w = whs + o;
      ld = ND;
    } else if (o < ND + NC) {
      w = whs + HH * ND + (o - ND);
      ld = NC;
    } else {
      w = whs + HH * (ND + NC) + (o - ND - NC);
      ld = NC;
    }
    float acc[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = 0.0f;
    const int i1 = part == 2 ? HH : (part + 1) * HEAD_PART;
#pragma unroll 2
    for (int i = part * HEAD_PART; i < i1; i += 4) {
      const float wv[4] = {w[i * ld], w[(i + 1) * ld], w[(i + 2) * ld],
                           w[(i + 3) * ld]};
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(h2 + r * HH + i);
        acc[r] = fmaf(x.x, wv[0], acc[r]);
        acc[r] = fmaf(x.y, wv[1], acc[r]);
        acc[r] = fmaf(x.z, wv[2], acc[r]);
        acc[r] = fmaf(x.w, wv[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < TB; ++r) hp[(part * TB + r) * NO + o] = acc[r];
  } else if (t - 3 * NO < MR * E) {
    // row rank + 8 * (u / 4), expert u % 4: the logit, then the softmax
    // over the 4 consecutive threads of the row (Eq. 54)
    const int u = t - 3 * NO, r = rank + (u / E) * CLUSTER;
    float acc = 0.0f;
    for (int i = 0; i < S; ++i)
      acc = fmaf(xs[r * S + i], gate_w[i * E + u % E], acc);
    const unsigned grp = 0xfu << (lane & ~3);
    const float a1 = __shfl_xor_sync(grp, acc, 1);
    const float a2 = __shfl_xor_sync(grp, acc, 2);
    const float a3 = __shfl_xor_sync(grp, a1, 2);
    const float m = fmaxf(fmaxf(acc, a1), fmaxf(a2, a3));
    const float z = expf(acc - m);
    const float z1 = __shfl_xor_sync(grp, z, 1);
    const float z2 = __shfl_xor_sync(grp, z, 2);
    const float z3 = __shfl_xor_sync(grp, z1, 2);
    float zs[E];
    zs[u % E] = z;
    zs[(u % E) ^ 1] = z1;
    zs[(u % E) ^ 2] = z2;
    zs[(u % E) ^ 3] = z3;
    gs[u] = z / (((zs[0] + zs[1]) + zs[2]) + zs[3]);
  }
  // the biases of this thread's blend outputs, while the heads finish
  const int o = t % NO, rr = t / NO;
  float bias[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    bias[e] = o < ND ? db[e * ND + o]
                     : o < ND + NC ? mb[e * NC + o - ND]
                                   : lb[e * NC + o - ND - NC];
  __syncthreads();
  // this half's heads, the three parts summed in order: warp q stores rows
  // q, q + 8, ... into CTA q's recv[(2 k + h) * MR + r / 8][o], then arrives
  {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    float* dst = cluster.map_shared_rank(recv, warp) + (2 * k + half) * MR * NO;
    for (int item = lane; item < MR * NO; item += 32) {
      const int r = warp + (item / NO) * CLUSTER, oo = item % NO;
      dst[item] = (hp[r * NO + oo] + hp[(TB + r) * NO + oo]) +
                  hp[(2 * TB + r) * NO + oo];
    }
    mbar_arrive_remote(bars + BAR_RECV, warp);
  }

  // 5. blend rows rank, rank + 8, ... of the tile: the experts in the fixed
  // order k = 0..3, each head the sum of its two halves plus its bias
  mbar_wait(bars + BAR_RECV);
  const int row = r0 + rank + rr * CLUSTER;
  if (rr < MR && row < B) {
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float head = (recv[((2 * e) * MR + rr) * NO + o] +
                          recv[((2 * e + 1) * MR + rr) * NO + o]) +
                         bias[e];
      acc = fmaf(gs[rr * E + e], head, acc);
    }
    if (o < ND)
      disc[row * ND + o] = acc;
    else if (o < ND + NC)
      mu[row * NC + (o - ND)] = tanhf(acc);
    else
      log_std[row * NC + (o - ND - NC)] = fminf(fmaxf(acc, -20.0f), 2.0f);
  }
  if (t < MR * E) {
    const int grow = r0 + rank + (t / E) * CLUSTER;
    if (grow < B) gate[grow * E + t % E] = gs[t];
  }
}

// cuTensorMapEncodeTiled's type (the driver's, found through the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// W2 [4][256][256] as a tensor map of boxes of 32 rows x 128 columns
cudaError_t w2_tensor_map(CUtensorMap* map, const float* l2w) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {H, H, E};
  const cuuint64_t strides[2] = {H * sizeof(float), H * H * sizeof(float)};
  const cuuint32_t box[3] = {HH, KS, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(l2w), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int TB>
int launch(const float* s, const float* gate_w, const float* l1w,
           const float* l1b, const float* l2w, const float* l2b,
           const float* dw, const float* db, const float* mw, const float* mb,
           const float* lw, const float* lb, float* disc, float* mu,
           float* log_std, float* gate, int B, cudaStream_t st) {
  static bool attr = false;   // above 48 KB of shared memory, set once
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        actor_moe_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<TB>::bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  CUtensorMap w2map;
  const cudaError_t err = w2_tensor_map(&w2map, l2w);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B + TB - 1) / TB;
  actor_moe_kernel<TB>
      <<<tiles * CLUSTER, THREADS, Smem<TB>::bytes, st>>>(
          s, gate_w, l1w, l1b, l2b, dw, db, mw, mb, lw, lb, disc, mu,
          log_std, gate, B, w2map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Row tile: TB = 8 up to 128 rows (enough clusters to fill the card), 16
// above (half the weight traffic per row); -DACTOR_TB=8 or 16 forces one
// (scripts/search_kernels_ab.py times both).
constexpr int TB8_MAX_B = 128;

// Plain C entry point bound with ctypes.  Pointers are device pointers of
// contiguous, 16-byte aligned float32 tensors laid out as in the reference
// parameter pytree: gate_w [52,4]; l1w [4,52,256]; l1b [4,256];
// l2w [4,256,256]; l2b [4,256]; dw [4,256,20]; db [4,20]; mw/lw [4,256,30];
// mb/lb [4,30]; outputs disc [B,20], mu/log_std [B,30], gate [B,4].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int actor_moe_forward(
    const float* s, const float* gate_w, const float* l1w, const float* l1b,
    const float* l2w, const float* l2b, const float* dw, const float* db,
    const float* mw, const float* mb, const float* lw, const float* lb,
    float* disc, float* mu, float* log_std, float* gate, int B,
    void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef ACTOR_TB
  const bool small = ACTOR_TB == 8;
#else
  const bool small = B <= TB8_MAX_B;
#endif
  return small ? launch<8>(s, gate_w, l1w, l1b, l2w, l2b, dw, db, mw, mb, lw,
                           lb, disc, mu, log_std, gate, B, st)
               : launch<16>(s, gate_w, l1w, l1b, l2w, l2b, dw, db, mw, mb,
                            lw, lb, disc, mu, log_std, gate, B, st);
}
