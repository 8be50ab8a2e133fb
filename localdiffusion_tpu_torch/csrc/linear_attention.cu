// Streaming linear attention for Hopper (sm_90a): the two passes over x.
//
// Replaces the TPU kernels localdiffusion_tpu/ops/pallas_linear_attention.py
// ::_kv_kernel (pass 1) and ::_q_kernel (pass 2).  The module computed is
// the denoiser's LinearAttention (RMSNorm in -> 1x1 qkv -> q softmax over
// the head dimension * scale, k softmax over all tokens -> context -> 1x1 out
// + bias -> RMSNorm out) on x of shape [B, N, C] (NHWC rows, C in 32/64/128),
// bfloat16, with 4 heads of 32 (hidden = 128).  Neither pass writes q, k or v
// to device memory:
//
//   pass 1, kv_kernel: per token xn = RMSNorm(x) (rounded to bf16), k = xn Wk
//     (rounded to bf16, as the reference's einsum output is), and per column
//     d of k the row's max m[d], the sum l[d] = sum_n exp(k[n,d] - m[d]) and
//     the Gram G[c,d] = sum_n xn[n,c] * bf16(exp(k[n,d] - m[d])), one merged
//     (m, l, G) per row, as the TPU kernel returns it.  The v projection is
//     linear, so it is applied to G afterwards (ctx^T = Wv^T G), on [C, 128]
//     numbers instead of on every token.
//   the fold (PyTorch, between the launches): ctx^T / l, the cross-head
//     mask, and the output projection folded in: W~ = ctxn^T Wout, [128, C]
//     per row.
//   pass 2, q_kernel: per token xn, q = xn Wq (bf16), a softmax over each
//     head's 32 values, qs = bf16(bf16(softmax) * bf16(scale)), out = qs W~ +
//     b rounded to bf16, then the output RMSNorm; the residual is added by
//     the caller.
//
// The Pallas kernels fold 128/C tokens into the 128 TPU lanes and use
// block-diagonal weights and 0/1 mask matmuls to keep Mosaic's layouts; none
// of that is needed here.  What does not carry over is the TPU grid's order:
// pass 1 reduces over all N tokens of a row (65,536 at 256px), and one block
// per row would give only B blocks.
//
// Bound: at [8, 65536, 32] each pass reads x once (33.5 MB, 10 us) and pass
// 2 writes the output once; the products are ~8.6 GFLOP a pass (8.7 us at
// the bf16 peak), and each pass takes one exponential per (token, column
// of k or q): 67 M, 16 us on the special-function units (16 a clock on each
// of 132 SMs at 1.98 GHz).  So pass 1 is bound by its exponentials and pass
// 2 by bytes and exponentials alike.  The design:
//
//   * Tiles of 64 tokens (the M of a wgmma) stream through a ring of
//     Stages<C> tiles in shared memory, filled by cp.async 16-byte copies
//     issued tiles ahead of the math (each thread's copy offsets computed
//     once).  A tile is stored as core matrices of 8 tokens x 8 channels,
//     which is at once a K-major A and an MN-major B operand of a wgmma,
//     and which the threads read without bank conflicts.
//   * The weights (Wk, Wq, and in pass 2 the row's W~) are staged once per
//     block by 16-byte copies, each [K][N] matrix as an MN-major B operand
//     in its natural row-major order: no transposes.
//   * pass 1: a block is two warpgroups; warpgroup h owns columns d of k in
//     [64 h, 64 h + 64).  All 256 threads RMS-normalise a tile once (four
//     lanes a token, two xor shuffles) into xn, which is both operands'
//     source: k = xn Wk (m64n64, A = xn from shared memory), and the Gram.
//     Each warpgroup rounds k to bf16, takes each column's max over the
//     tile (bf16x2 maxima, xor shuffles over the warp's rows, one exchange
//     across the warps; then one thread a column updates the running max
//     and its rescale exp(m_old - m_new)), and writes E = bf16(exp(k - m))
//     to shared memory as an MN-major A; l is kept per thread in float32.
//     The Gram is accumulated transposed, G^T += E^T xn (M = 64 columns d,
//     N = C, K = 64 tokens; A and B from shared memory), so C = 32 still
//     fills a wgmma, and the online rescale is a per-row scale of the
//     accumulator, as in flash attention.  A tile costs one barrier of the
//     warpgroup and two of the block; the next tile's RMSNorm runs before
//     the second, and the Gram product during the next tile's k.
//   * pass 2: two warpgroups walk tiles independently (each its own ring).
//     RMSNorm runs in the register-A fragment layout (the four lanes of a
//     token reduce with two xor shuffles) and feeds q = xn Wq (m64n128, A
//     from registers); the softmax of each head runs in the accumulator's
//     layout (a head's 32 columns are 4 lanes x 8 values: bf16x2 maxima and
//     two xor shuffles for the max, two for the sum); qs = bf16(bf16(p) *
//     scale) (one bf16x2 multiply, which rounds the exact product once)
//     packs straight into the register-A fragments of out = qs W~ (m64 x C
//     x k128); then + b, the bf16 round, the output RMSNorm by shuffles, and
//     16-byte stores through a per-warp staging tile.  The grid is
//     persistent (as many blocks as fit on the card), which a pass without
//     a reduction across tokens may be: a token's output does not depend on
//     which block computes it.
//   * Exponentials are ex2.approx on the special-function units with the
//     log2(e) scale and the max folded into one FMA; the RMSNorm's
//     1 / max(|x|, 1e-12) and the softmax's 1 / sum are rsqrt.approx and
//     rcp.approx (2 ulp), where the IEEE forms branch to slow paths.  The
//     rounding points are the reference's: xn, k and q in bf16, l from the
//     float32 exponentials, E and qs in bf16, out + b in bf16.
//
// The merge of pass 1.  A row's tokens are split into nb blocks (a multiple
// of 8, from N alone, never from the batch: a block rounds exp(k - m)
// against its own running max, so a split that followed the batch would
// make a row's output depend on the rows beside it) by tiles.  Each block
// writes its partial (m, l, G) to a scratch buffer and adds one to the
// row's counter; the cluster of kCluster blocks that holds the row's last
// arrival then merges all nb partials by the log-sum-exp rule, in block
// order (so the result is the same whichever block came last), each of its
// blocks taking C / kCluster rows of G.  The cluster is 2 blocks: with 8,
// only 30 clusters (240 blocks) fit on the card at once, and the 256 blocks
// of the 256px chain's largest site ran in two waves.  The last arrival
// resets the counter, so the next launch (and a CUDA graph's replay) finds
// it at 0.
//
// The attribution variant (kLin = true, `linear_attention_kv_linexp` and
// `linear_attention_q_linexp`): every exponential, the online rescale and
// the merge's weights included, becomes the linear map a * 0.5 + 1 of the
// same natural-log argument a, as scripts/bench_linatt_attrib.py replaces
// exp by v * 0.5 + 1 in its kv_kernel and q_kernel; in pass 2 a is q less
// the token's max over its 128 columns, the JAX q_kernel's shift (the
// softmax of the main path subtracts each head's max, which it does not
// see).  It times each pass without its special-function work; the main
// path's instantiation (kLin = false) is the code above.
//
// Launch contract: the caller passes the current stream; the kernels
// allocate nothing (the scratch and the zeroed counters are the caller's)
// and each function returns cudaGetLastError().  Every pointer to bf16 data
// is 16-byte aligned (the copies and stores are 16 bytes wide).

#include <math_constants.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTok = 64;       // tokens per tile: the M of a wgmma
constexpr int kHid = 128;      // heads * dim_head
constexpr int kDh = 32;        // dim_head
constexpr int kCluster = 2;    // pass 1: blocks that merge a row together
constexpr int kBlockStep = 8;   // pass 1: blocks per row, a multiple of this (of the
                                // cluster, and of the merge's four partials a step)
constexpr int kMaxBlocks = 64;  // pass 1: blocks per row at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kNegInf2 = 0xff80ff80u;  // two bf16 -inf

// 2^x on the special-function unit (denormal results flush to 0; they weigh
// nothing beside the column's largest term, 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 of a packed pair as floats (exact).
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Two bf16 products, each rounded once from the exact product.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 1 / x on the special-function unit
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / max(sqrt(ss), 1e-12), the RMSNorm's scale, on the special-function
// unit (rsqrt.approx, 2 ulp): the IEEE square root and division cost a
// branch to their slow paths each
__device__ __forceinline__ float inv_norm(float ss) {
  return rsqrtf(fmaxf(ss, 1e-24f));
}

__device__ __forceinline__ uint32_t ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st_u32(unsigned char* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// Byte offset of (row r, 16-byte piece p) in a [rows][W] bf16 matrix stored
// as core matrices of 8 rows x 8 elements: the W / 8 pieces of a group of 8
// rows lie 128 bytes apart, row groups 16 W bytes apart.  As a wgmma operand
// whose K runs along the rows it is MN-major with LBO 16 W and SBO 128.
template <int W>
__device__ __forceinline__ int cm_offset(int r, int p) {
  return (r >> 3) * (16 * W) + p * 128 + (r & 7) * 16;
}

// A [ROWS][W] bf16 matrix (row-major in device memory) copied into shared
// memory in the layout above by NT threads, 16 bytes a cp.async: this
// thread's (tid < NT) byte offsets in shared memory and element offsets in
// the rows, computed once.  Eight consecutive threads take one piece of
// eight consecutive rows, 128 contiguous bytes of shared memory (no bank
// conflicts), and a warp reads 8 whole rows.
template <int W, int ROWS, int NT>
struct TileCopy {
  static constexpr int K = ROWS * W / 8 / NT;
  static_assert(K * NT * 8 == ROWS * W, "whole pieces a thread");
  int dst[K], src[K];
  __device__ __forceinline__ explicit TileCopy(int tid) {
    constexpr int P = W / 8;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * NT;
      const int r = (i & 7) + 8 * (i / (8 * P)), p = (i >> 3) % P;
      dst[k] = cm_offset<W>(r, p);
      src[k] = r * W + 8 * p;
    }
  }
  // rows from `valid` on are zero-filled
  __device__ __forceinline__ void operator()(unsigned char* stage, const bf16* tile,
                                             int valid) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool in = src[k] < valid * W;
      cp_async16(stage + dst[k], in ? tile + src[k] : tile, in);
    }
  }
};

// Tiles in a ring: 4 (16 to 64 KB of x a block); 3 for q from C = 64, so
// that two q blocks share an SM at C = 64 and one fits at C = 128.
template <int C>
struct Stages {
  static constexpr int kv = 4;
  static constexpr int q = C == 32 ? 4 : 3;  // per warpgroup
};

// The warp's 16 tokens of a tile (warp w of its warpgroup: tokens 16 w ..),
// RMS-normalised, x / max(|x|, 1e-12) * gs[c] with gs = g * sqrt(C), rounded
// to bf16, as register-A fragments: xa[kk] holds channels 16 kk .. 16 kk + 15
// of tokens g and g + 8 (g = lane / 4; lanes 4 g .. 4 g + 3 share a token).
template <int C>
__device__ __forceinline__ void rms_fragments(const unsigned char* tile, const float* gs, int w,
                                              uint32_t (&xa)[C / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float2 v[C / 16][4];
  float s0 = 0.f, s1 = 0.f;  // tokens g and g + 8
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const unsigned char* p = tile + cm_offset<C>(16 * w + g, 2 * kk) + 4 * t;
    v[kk][0] = unpack_bf16(ld_u32(p));                 // token g, channels 16 kk + 2 t ..
    v[kk][1] = unpack_bf16(ld_u32(p + 16 * C));        // token g + 8
    v[kk][2] = unpack_bf16(ld_u32(p + 128));           // token g, channels + 8
    v[kk][3] = unpack_bf16(ld_u32(p + 16 * C + 128));  // token g + 8, channels + 8
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      s0 = fmaf(v[kk][i].x, v[kk][i].x, s0);
      s0 = fmaf(v[kk][i].y, v[kk][i].y, s0);
      s1 = fmaf(v[kk][i + 1].x, v[kk][i + 1].x, s1);
      s1 = fmaf(v[kk][i + 1].y, v[kk][i + 1].y, s1);
    }
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  const float inv0 = inv_norm(s0), inv1 = inv_norm(s1);
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const float2 ga = *reinterpret_cast<const float2*>(gs + 16 * kk + 2 * t);
    const float2 gb = *reinterpret_cast<const float2*>(gs + 16 * kk + 8 + 2 * t);
    xa[kk][0] = pack_bf16(v[kk][0].x * inv0 * ga.x, v[kk][0].y * inv0 * ga.y);
    xa[kk][1] = pack_bf16(v[kk][1].x * inv1 * ga.x, v[kk][1].y * inv1 * ga.y);
    xa[kk][2] = pack_bf16(v[kk][2].x * inv0 * gb.x, v[kk][2].y * inv0 * gb.y);
    xa[kk][3] = pack_bf16(v[kk][3].x * inv1 * gb.x, v[kk][3].y * inv1 * gb.y);
  }
}

// RMSNorm of a tile's 64 tokens by all 256 threads of a block, from `tile`
// into `xn` (both in the core-matrix layout, which is then the K-major A and
// the MN-major B of a wgmma): warp w takes tokens 8 w .. 8 w + 7, lane l
// token 8 w + l % 8 and the 16-byte pieces l / 8, l / 8 + 4, ...; the four
// lanes of a token sum its squares with two xor shuffles.
template <int C>
__device__ __forceinline__ void rms_tile(const unsigned char* tile, const float* gs,
                                         unsigned char* xn) {
  constexpr int kPer = C / 32;  // pieces a thread
  const int lane = threadIdx.x & 31, tok = 8 * (threadIdx.x >> 5) + (lane & 7);
  uint4 u[kPer];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    u[k] = *reinterpret_cast<const uint4*>(tile + cm_offset<C>(tok, (lane >> 3) + 4 * k));
    const uint32_t w[4] = {u[k].x, u[k].y, u[k].z, u[k].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = unpack_bf16(w[e]);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
    }
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 8);
  ss += __shfl_xor_sync(0xffffffffu, ss, 16);
  const float inv = inv_norm(ss);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = (lane >> 3) + 4 * k;
    const float4 ga = *reinterpret_cast<const float4*>(gs + 8 * p);
    const float4 gb = *reinterpret_cast<const float4*>(gs + 8 * p + 4);
    const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    const uint32_t w[4] = {u[k].x, u[k].y, u[k].z, u[k].w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = unpack_bf16(w[e]);
      o[e] = pack_bf16(v.x * inv * gv[2 * e], v.y * inv * gv[2 * e + 1]);
    }
    *reinterpret_cast<uint4*>(xn + cm_offset<C>(tok, p)) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Shared-memory plan of pass 1, byte offsets.
template <int C>
struct KvSmem {
  static constexpr int kStages = Stages<C>::kv;
  static constexpr int kTileBytes = kTok * C * 2;
  static constexpr int kW = 0;                                 // Wk [C][128]
  static constexpr int kRing = kW + C * kHid * 2;              // kStages x [64][C]
  static constexpr int kXn = kRing + kStages * kTileBytes;     // 2 x [64][C], xn
  static constexpr int kE = kXn + 2 * kTileBytes;              // 2 warpgroups x [64][64], E
  static constexpr int kGs = kE + 2 * kTok * 64 * 2;           // [C] float, g sqrt(C)
  static constexpr int kRed = kGs + C * 4;                     // [8 warps][32] bf16x2 maxima
  static constexpr int kMf = kRed + 8 * 32 * 4;                // [128] float2 (m log2 e, rescale)
  static constexpr int kLred = kMf + kHid * 8;                 // [8 warps][64] float, l
  static constexpr int kTicket = kLred + 8 * 64 * 4;           // int
  static constexpr int kBytes = kTicket + 16;
  static constexpr int kMergeBytes = kGs - kRing;              // the merge reuses ring .. E
};

template <int C>
struct KvOccupancy {  // two blocks an SM where the registers allow
  static constexpr int value = C <= 64 ? 2 : 1;
};

// exp(a - b) for b >= a, a = -inf giving 0 (an empty block, or none yet);
// with kLin, (a - b) * 0.5 + 1
template <bool kLin>
__device__ __forceinline__ float weight(float a, float b) {
  if (a == -CUDART_INF_F) return 0.f;
  if constexpr (kLin) {
    return fmaf(a - b, 0.5f, 1.f);
  } else {
    return ex2((a - b) * kLog2e);
  }
}

// exp(k - m) of a k rounded to bf16, given ms = m log2 e (ms = m with
// kLin, which gives (k - m) * 0.5 + 1); a token past n (k = -inf) gives 0
template <bool kLin>
__device__ __forceinline__ float exp_shifted(float k, float ms) {
  if constexpr (kLin) {
    return k == -CUDART_INF_F ? 0.f : fmaf(k - ms, 0.5f, 1.f);
  } else {
    return ex2(fmaf(k, kLog2e, -ms));
  }
}

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// Pass 1.  Grid (nb, B), nb a multiple of kBlockStep: block p of row b takes
// tiles [p T / nb, (p + 1) T / nb) of the row's T = ceil(n / 64).  scratch:
// [B][nb][C + 2][128] float32 (m, l, G of each block); counter: [B] int,
// zero.  Writes m, l [B][128] and gram [B][C][128] (float32), l and G
// relative to m.
template <int C, bool kLin>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, KvOccupancy<C>::value)
kv_kernel(const bf16* __restrict__ x, const float* __restrict__ g_in,
          const bf16* __restrict__ wk, float* __restrict__ scratch, int* __restrict__ counter,
          float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ gram_out,
          int n) {
  using L = KvSmem<C>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wk_s = smem + L::kW;
  float* gs = reinterpret_cast<float*>(smem + L::kGs);
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + L::kRed);

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row = blockIdx.y, nb = gridDim.x, blk = blockIdx.x;
  const int ntiles = (n + kTok - 1) / kTok;
  const int tile0 = static_cast<int>(static_cast<long long>(blk) * ntiles / nb);
  const int count = static_cast<int>(static_cast<long long>(blk + 1) * ntiles / nb) - tile0;
  const bf16* xr = x + static_cast<long long>(row) * n * C;
  unsigned char* e_s = smem + L::kE + wg * (kTok * 64 * 2);
  float2* mf = reinterpret_cast<float2*>(smem + L::kMf);
  // shared addresses and descriptor strides of the products' operands
  const uint32_t xn0 = smem_addr(smem + L::kXn), e_a = smem_addr(e_s);
  const uint32_t wk_a = smem_addr(wk_s) + wg * 1024;
  constexpr uint64_t kXnA = smem_desc_strides(128, 16 * C);  // xn as k's K-major A
  constexpr uint64_t kXnB = smem_desc_strides(16 * C, 128);  // xn as the Gram's MN-major B
  constexpr uint64_t kWkB = smem_desc_strides(2048, 128);    // Wk, MN-major B
  constexpr uint64_t kEA = smem_desc_strides(1024, 128);     // E, the Gram's MN-major A
  auto xn_buf = [&](int i) { return smem + L::kXn + (i & 1) * L::kTileBytes; };
  auto stage = [&](int i) { return smem + L::kRing + (i % S) * L::kTileBytes; };

  // Wk as the MN-major B operand of k = xn Wk (K = C, N = 128), one group
  for (int i = tid; i < C * (kHid / 8); i += kThreads) {
    const int c = i / (kHid / 8), p = i % (kHid / 8);
    cp_async16(wk_s + cm_offset<kHid>(c, p), wk + c * kHid + 8 * p, true);
  }
  cp_async_commit();
  for (int i = tid; i < C; i += kThreads) gs[i] = g_in[i] * sqrtf(static_cast<float>(C));

  const TileCopy<C, kTok, kThreads> copy(tid);
  auto load_tile = [&](int i) {  // the block's tile i into stage i % S, as one group
    if (i < count) {
      const int tok0 = (tile0 + i) * kTok;
      copy(stage(i), xr + static_cast<long long>(tok0) * C, n - tok0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < S; ++s) load_tile(s);
  cp_async_wait<S - 1>();  // Wk and tile 0
  __syncthreads();
  if (count > 0) rms_tile<C>(stage(0), gs, xn_buf(0));
  fence_proxy_async();  // Wk and xn are read by wgmma
  __syncthreads();
  load_tile(S);  // into tile 0's stage

  // G^T of this warpgroup's 64 columns d: rows d = 64 wg + 16 warp + g (+ 8),
  // columns c = 8 j + 2 t (+ 1)
  float gacc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) gacc[i] = 0.f;  // a block without tokens writes 0
  float lpart[16];  // l of columns 64 wg + 8 j + 2 t (+ 1), this thread's tokens
#pragma unroll
  for (int i = 0; i < 16; ++i) lpart[i] = 0.f;
  float m_run = -CUDART_INF_F;  // the running max of column 64 wg + wtid (wtid < 64)
  const int d0 = 16 * warp + g;

  for (int i = 0; i < count; ++i) {
    const int valid = min(kTok, n - (tile0 + i) * kTok);

    // k = xn Wk for this warpgroup's 64 columns (A: xn, K-major)
    float k[32];
    const uint32_t xn_a = xn0 + (i & 1) * L::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      wgmma_ss<0, 1>(k, smem_desc_at(xn_a + kk * 256, kXnA), smem_desc_at(wk_a + kk * 4096, kWkB),
                     kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // also retires the previous tile's Gram product, which read E
    reg_fence(k);
    reg_fence(gacc);

    // k in bf16 (tokens past n: -inf), and each column's max over the tile:
    // this thread's two tokens, the warp's (xor 4, 8, 16), then the four warps
    const bool ok0 = d0 < valid, ok1 = d0 + 8 < valid;
    uint32_t kb[16];  // kb[2 j]: token g, columns 8 j + 2 t, + 1; kb[2 j + 1]: token g + 8
    uint32_t mx[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      kb[2 * j] = ok0 ? pack_bf16(k[4 * j], k[4 * j + 1]) : kNegInf2;
      kb[2 * j + 1] = ok1 ? pack_bf16(k[4 * j + 2], k[4 * j + 3]) : kNegInf2;
      mx[j] = max_bf16x2(kb[2 * j], kb[2 * j + 1]);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) mx[j] = max_bf16x2(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(4 * wg + warp) * 32 + 4 * j + t] = mx[j];
    }
    cp_async_wait<S - 1>();  // tile i + 1 (this thread's copies)
    __syncthreads();         // the maxima and tile i + 1 visible
    if (wtid < 64) {  // one thread a column: the running max and the rescale
      float tmx = -CUDART_INF_F;
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4) {
        const float2 p = unpack_bf16(red[(4 * wg + w4) * 32 + (wtid >> 1)]);
        tmx = fmaxf(tmx, (wtid & 1) ? p.y : p.x);
      }
      const float m_new = fmaxf(m_run, tmx);  // finite: a tile holds a token
      const float f = weight<kLin>(m_run, m_new);  // 0 on the block's first tile
      m_run = m_new;
      mf[64 * wg + wtid] = make_float2(kLin ? m_new : m_new * kLog2e, f);
    }
    bar_sync(1 + wg, 128);

    // E = exp(k - m): into l in float32, into the Gram's A operand in bf16
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(mf + 64 * wg + 8 * j + 2 * t);
      const float2 k0 = unpack_bf16(kb[2 * j]), k1 = unpack_bf16(kb[2 * j + 1]);
      const float e00 = exp_shifted<kLin>(k0.x, q.x), e01 = exp_shifted<kLin>(k0.y, q.z);
      const float e10 = exp_shifted<kLin>(k1.x, q.x), e11 = exp_shifted<kLin>(k1.y, q.z);
      lpart[2 * j] = fmaf(lpart[2 * j], q.y, e00 + e10);
      lpart[2 * j + 1] = fmaf(lpart[2 * j + 1], q.w, e01 + e11);
      unsigned char* p = e_s + cm_offset<64>(d0, j) + 4 * t;
      st_u32(p, pack_bf16(e00, e01));
      st_u32(p + 1024, pack_bf16(e10, e11));  // token g + 8: the next row group
    }
    {  // G^T rows rescaled to the new maxima
      const float f0 = mf[64 * wg + d0].y, f1 = mf[64 * wg + d0 + 8].y;
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        gacc[4 * j] *= f0;
        gacc[4 * j + 1] *= f0;
        gacc[4 * j + 2] *= f1;
        gacc[4 * j + 3] *= f1;
      }
    }
    // the next tile's RMSNorm, into the other xn buffer (its last reader,
    // the previous tile's Gram product, has retired)
    if (i + 1 < count) rms_tile<C>(stage(i + 1), gs, xn_buf(i + 1));
    fence_proxy_async();  // E and xn are read by wgmma
    __syncthreads();      // E, the next xn visible; tile i + 1's stage free
    load_tile(i + 1 + S);
    // G^T += E^T xn over the tile's tokens; it runs with the next tile's k
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTok / 16; ++kk) {
      wgmma_ss<1, 1>(gacc, smem_desc_at(e_a + kk * 2048, kEA),
                     smem_desc_at(xn_a + kk * 32 * C, kXnB), 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(gacc);
  cp_async_wait<0>();

  // l: the thread's sums over its tokens, then over the warp's (xor 4, 8,
  // 16), then the warpgroup's four warps in order
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) lpart[i] += __shfl_xor_sync(0xffffffffu, lpart[i], off);
  }
  float* lred = reinterpret_cast<float*>(smem + L::kLred);
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lred[(4 * wg + warp) * 64 + 8 * j + 2 * t] = lpart[2 * j];
      lred[(4 * wg + warp) * 64 + 8 * j + 2 * t + 1] = lpart[2 * j + 1];
    }
  }
  bar_sync(1 + wg, 128);

  // this block's partial: m, l [128] and G [C][128]
  constexpr int P = (C + 2) * kHid;  // floats per partial
  float* part = scratch + (static_cast<long long>(row) * nb + blk) * P;
  if (wtid < 64) {
    const float* lr = lred + 4 * wg * 64 + wtid;
    part[64 * wg + wtid] = m_run;  // -inf for a block without tokens
    part[kHid + 64 * wg + wtid] = ((lr[0] + lr[64]) + lr[128]) + lr[192];
  }
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1), d = 64 * wg + d0 + 8 * (e >> 1);
      part[2 * kHid + c * kHid + d] = gacc[4 * j + e];
    }
  }

  // the row's counter: the block that brings it to nb arrived last
  int* ticket = reinterpret_cast<int*>(smem + L::kTicket);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *ticket = atomicAdd(counter + row, 1);
    __threadfence();
    if (*ticket == nb - 1) counter[row] = 0;  // every block of the row has counted
  }
  cluster_sync();
  bool last = false;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    last = last || static_cast<int>(ld_shared_cluster(ticket, r)) == nb - 1;
  }
  cluster_sync();  // no block leaves while another reads its ticket
  if (!last) return;
  __threadfence();

  // the last cluster merges the row's nb partials in block order.  First
  // each column's max over the blocks and the blocks' weights exp(m_p - m)
  // (a table in shared memory, and l in block 0 of the cluster); then
  // block `rank` sums rows c in [rank C / kCluster, (rank + 1) C / kCluster)
  // of G, four columns at a time, with every load of a group of four
  // partials in flight at once
  const int rank = static_cast<int>(cluster_ctarank());
  const float* rowp = scratch + static_cast<long long>(row) * nb * P;
  float* wt = reinterpret_cast<float*>(smem + L::kRing);  // [nb][128]
  if (tid < kHid) {
    float m = -CUDART_INF_F;
#pragma unroll 8
    for (int p = 0; p < nb; ++p) m = fmaxf(m, __ldcg(rowp + p * P + tid));
    float l = 0.f;
#pragma unroll 8
    for (int p = 0; p < nb; ++p) {
      const float w = weight<kLin>(__ldcg(rowp + p * P + tid), m);
      wt[p * kHid + tid] = w;
      l = fmaf(w, __ldcg(rowp + p * P + kHid + tid), l);
    }
    if (rank == 0) {
      m_out[row * kHid + tid] = m;
      l_out[row * kHid + tid] = l;
    }
  }
  __syncthreads();
  constexpr int kRows = C / kCluster, kPer = kRows * (kHid / 4) / kThreads;
  static_assert(kPer >= 1 && kRows * (kHid / 4) % kThreads == 0, "merge positions");
  constexpr int kRowStep = kThreads / (kHid / 4);  // rows between a thread's positions
  const int d = (tid % (kHid / 4)) * 4;  // the same columns at every position of the thread
  const int c0 = rank * kRows + tid / (kHid / 4);
  const float* g0 = rowp + 2 * kHid + c0 * kHid + d;
  float4 acc[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = 0; p0 < nb; p0 += 4) {  // nb is a multiple of 4
    float4 v[4][kPer];
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) v[pp][u] = ldcg4(g0 + (p0 + pp) * P + u * kRowStep * kHid);
    }
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const float4 w = *reinterpret_cast<const float4*>(wt + (p0 + pp) * kHid + d);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        acc[u].x = fmaf(w.x, v[pp][u].x, acc[u].x);
        acc[u].y = fmaf(w.y, v[pp][u].y, acc[u].y);
        acc[u].z = fmaf(w.z, v[pp][u].z, acc[u].z);
        acc[u].w = fmaf(w.w, v[pp][u].w, acc[u].w);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int c = c0 + u * kRowStep;
    *reinterpret_cast<float4*>(gram_out + (static_cast<long long>(row) * C + c) * kHid + d) =
        acc[u];
  }
}

// Shared-memory plan of pass 2, byte offsets.
template <int C>
struct QSmem {
  static constexpr int kStages = Stages<C>::q;
  static constexpr int kTileBytes = kTok * C * 2;
  static constexpr int kOutStride = C + 8;                     // bf16 per staged output row
  static constexpr int kWq = 0;                                // Wq [C][128]
  static constexpr int kWt = kWq + C * kHid * 2;               // W~ [128][C]
  static constexpr int kRing = kWt + kHid * C * 2;             // 2 warpgroups x kStages x [64][C]
  static constexpr int kOut = kRing + 2 * kStages * kTileBytes;  // 8 warps x [16][C + 8]
  static constexpr int kPar = kOut + 8 * 16 * kOutStride * 2;  // gs, gos, bos: 3 x [C] float
  static constexpr int kBytes = kPar + 3 * C * 4;
};

// Pass 2.  Grid (blocks per row, B); each warpgroup takes every
// (2 gridDim.x)-th tile of its row.  wtil: [B, 128, C] bf16.
template <int C, bool kLin>
__global__ void __launch_bounds__(kThreads, 1)
q_kernel(const bf16* __restrict__ x, const float* __restrict__ g_in,
         const bf16* __restrict__ wq, const bf16* __restrict__ wtil,
         const float* __restrict__ b_out, const float* __restrict__ g_out,
         bf16* __restrict__ out, int n, float scale) {
  using L = QSmem<C>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wq_s = smem + L::kWq;
  unsigned char* wt_s = smem + L::kWt;
  float* gs = reinterpret_cast<float*>(smem + L::kPar);
  float* gos = gs + C;
  float* bos = gos + C;

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row = blockIdx.y;
  const bf16* xr = x + static_cast<long long>(row) * n * C;
  bf16* outr = out + static_cast<long long>(row) * n * C;

  // Wq (K = C, N = 128) and the row's W~ (K = 128, N = C) as MN-major B
  // operands, one group
  for (int i = tid; i < C * (kHid / 8); i += kThreads) {
    const int c = i / (kHid / 8), p = i % (kHid / 8);
    cp_async16(wq_s + cm_offset<kHid>(c, p), wq + c * kHid + 8 * p, true);
  }
  const TileCopy<C, kHid, kThreads> copy_wt(tid);
  copy_wt(wt_s, wtil + static_cast<long long>(row) * kHid * C, kHid);
  cp_async_commit();
  const float root_c = sqrtf(static_cast<float>(C));
  for (int i = tid; i < C; i += kThreads) {
    gs[i] = g_in[i] * root_c;
    gos[i] = g_out[i] * root_c;
    bos[i] = b_out[i];
  }

  const uint32_t scale2 = pack_bf16(scale, scale);  // exact: scale is a bf16 value
  const int ntiles = (n + kTok - 1) / kTok;
  const int units = 2 * gridDim.x, u = 2 * blockIdx.x + wg;
  const int count = u < ntiles ? (ntiles - 1 - u) / units + 1 : 0;
  unsigned char* ring = smem + L::kRing + wg * kStages * L::kTileBytes;
  const TileCopy<C, kTok, 128> copy(wtid);
  auto load_tile = [&](int i) {  // this warpgroup's tile i into stage i % kStages
    if (i < count) {
      const int tok0 = (u + i * units) * kTok;
      copy(ring + (i % kStages) * L::kTileBytes, xr + static_cast<long long>(tok0) * C,
           n - tok0);
    }
    cp_async_commit();
  };
  const uint32_t wq_a = smem_addr(wq_s), wt_a = smem_addr(wt_s);
  constexpr uint64_t kWqB = smem_desc_strides(2048, 128);    // Wq, MN-major B
  constexpr uint64_t kWtB = smem_desc_strides(16 * C, 128);  // W~, MN-major B
#pragma unroll
  for (int s = 0; s < kStages; ++s) load_tile(s);
  cp_async_wait<kStages - 1>();  // the weights and tile 0 (this thread's copies)
  fence_proxy_async();
  __syncthreads();

  bf16* stage = reinterpret_cast<bf16*>(smem + L::kOut) + (4 * wg + warp) * 16 * L::kOutStride;
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 2>();
    bar_sync(1 + wg, 128);  // tile i has landed; the warpgroup has read tile i - 1
    if (i > 0) load_tile(i - 1 + kStages);  // into tile i - 1's stage
    const unsigned char* tile = ring + (i % kStages) * L::kTileBytes;
    const int tok0 = (u + i * units) * kTok;
    const int valid = min(kTok, n - tok0);

    uint32_t xa[C / 16][4];
    rms_fragments<C>(tile, gs, warp, xa);
    float q[64];  // q = xn Wq: tokens g, g + 8 of the warp, all 128 columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      wgmma_m64n128k16<1>(q, xa[kk], smem_desc_at(wq_a + kk * 4096, kWqB), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(q);

    // softmax over each head's 32 columns (j = 4 hd .. 4 hd + 3; four lanes
    // of a token hold 8 each), times the scale, as the A operand of qs W~.
    // The attribution variant subtracts the token's max over all 128
    // columns, as the JAX script's q_kernel does (a softmax does not see
    // the shift; the linear map does): each head's max taken as the main
    // path takes it, then their max, so the variant does the main path's
    // work but the exponentials and three maxima
    float tok_mx[2] = {0.f, 0.f};
    if constexpr (kLin) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = -CUDART_INF_F;
#pragma unroll
        for (int hd = 0; hd < kHid / kDh; ++hd) {
          uint32_t w[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            w[jj] = pack_bf16(q[4 * (4 * hd + jj) + 2 * r], q[4 * (4 * hd + jj) + 2 * r + 1]);
          }
          const float2 m2 =
              unpack_bf16(max_bf16x2(max_bf16x2(w[0], w[1]), max_bf16x2(w[2], w[3])));
          float mx = fmaxf(m2.x, m2.y);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          m = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2)));
        }
        tok_mx[r] = m;
      }
    }
    uint32_t qa[kHid / 16][4];
#pragma unroll
    for (int hd = 0; hd < kHid / kDh; ++hd) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // token g, then g + 8
        uint32_t w[4];  // q rounded to bf16, pairs of columns 8 j + 2 t
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          w[jj] = pack_bf16(q[4 * (4 * hd + jj) + 2 * r], q[4 * (4 * hd + jj) + 2 * r + 1]);
        }
        float ml = tok_mx[r];
        if constexpr (!kLin) {
          const float2 m2 =
              unpack_bf16(max_bf16x2(max_bf16x2(w[0], w[1]), max_bf16x2(w[2], w[3])));
          float mx = fmaxf(m2.x, m2.y);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          ml = mx * kLog2e;
        }
        float e[8], den = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float2 v = unpack_bf16(w[jj]);
          e[2 * jj] = exp_shifted<kLin>(v.x, ml);
          e[2 * jj + 1] = exp_shifted<kLin>(v.y, ml);
          den += e[2 * jj] + e[2 * jj + 1];
        }
        den += __shfl_xor_sync(0xffffffffu, den, 1);
        den += __shfl_xor_sync(0xffffffffu, den, 2);
        const float inv = rcp_approx(den);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {  // bf16(bf16(p) * scale): one rounding each
          const int j = 4 * hd + jj;
          qa[j >> 1][(j & 1) * 2 + r] = mul_bf16x2(pack_bf16(e[2 * jj] * inv, e[2 * jj + 1] * inv),
                                                   scale2);
        }
      }
    }

    float o[C / 2];  // out = qs W~: tokens g, g + 8, columns 8 j + 2 t (+ 1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHid / 16; ++kk) {
      wgmma_rs<1>(o, qa[kk], smem_desc_at(wt_a + kk * 32 * C, kWtB), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);

    // + b, rounded to bf16, then the output RMSNorm over the token's C
    // values (the four lanes of a token)
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bos + 8 * j + 2 * t);
      o[4 * j] = bf16_round(o[4 * j] + b.x);
      o[4 * j + 1] = bf16_round(o[4 * j + 1] + b.y);
      o[4 * j + 2] = bf16_round(o[4 * j + 2] + b.x);
      o[4 * j + 3] = bf16_round(o[4 * j + 3] + b.y);
      s0 = fmaf(o[4 * j], o[4 * j], s0);
      s0 = fmaf(o[4 * j + 1], o[4 * j + 1], s0);
      s1 = fmaf(o[4 * j + 2], o[4 * j + 2], s1);
      s1 = fmaf(o[4 * j + 3], o[4 * j + 3], s1);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const float inv0 = inv_norm(s0), inv1 = inv_norm(s1);
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 go = *reinterpret_cast<const float2*>(gos + c);
      *reinterpret_cast<uint32_t*>(stage + g * L::kOutStride + c) =
          pack_bf16(o[4 * j] * inv0 * go.x, o[4 * j + 1] * inv0 * go.y);
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * L::kOutStride + c) =
          pack_bf16(o[4 * j + 2] * inv1 * go.x, o[4 * j + 3] * inv1 * go.y);
    }
    __syncwarp();
    for (int p = lane; p < 16 * (C / 8); p += 32) {  // the warp's 16 tokens, 16 bytes a lane
      const int r = p / (C / 8), c8 = (p % (C / 8)) * 8;
      if (16 * warp + r < valid) {
        *reinterpret_cast<uint4*>(outr + static_cast<long long>(tok0 + 16 * warp + r) * C + c8) =
            *reinterpret_cast<const uint4*>(stage + r * L::kOutStride + c8);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

// Set before every launch: the attribute belongs to the device that is
// current at the call, so a once-per-process setting misses a second card.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int C, bool kLin>
cudaError_t launch_kv(const void* x, const void* g_in, const void* wk, void* scratch,
                      void* counter, void* m, void* l, void* gram, int batch, int n, int nb,
                      cudaStream_t s) {
  using L = KvSmem<C>;
  static_assert(kMaxBlocks * kHid * 4 <= L::kMergeBytes, "merge weights");
  const cudaError_t attr = allow_smem(kv_kernel<C, kLin>, L::kBytes);
  if (attr != cudaSuccess) return attr;
  kv_kernel<C, kLin><<<dim3(nb, batch), kThreads, L::kBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g_in),
      static_cast<const bf16*>(wk), static_cast<float*>(scratch), static_cast<int*>(counter),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(gram), n);
  return cudaGetLastError();
}

template <int C, bool kLin>
cudaError_t launch_q(const void* x, const void* g_in, const void* wq, const void* wtil,
                     const void* b_out, const void* g_out, void* out, int batch, int n,
                     float scale, cudaStream_t s) {
  using L = QSmem<C>;
  cudaError_t err = allow_smem(q_kernel<C, kLin>, L::kBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, q_kernel<C, kLin>, kThreads,
                                                      L::kBytes);
  if (err != cudaSuccess) return err;
  // as many blocks as fit on the card at once, spread over the rows (a
  // token's output does not depend on the block that computes it)
  const int ntiles = (n + kTok - 1) / kTok;
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int per_row = std::max(1, std::min((ntiles + 1) / 2, (slots + batch - 1) / batch));
  q_kernel<C, kLin><<<dim3(per_row, batch), kThreads, L::kBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g_in),
      static_cast<const bf16*>(wq), static_cast<const bf16*>(wtil),
      static_cast<const float*>(b_out), static_cast<const float*>(g_out),
      static_cast<bf16*>(out), n, scale);
  return cudaGetLastError();
}

template <bool kLin>
int kv_entry(const void* x, const void* g_in, const void* wk, void* scratch, void* counter,
             void* m, void* l, void* gram, int batch, int n, int c, int nb, void* stream) {
  if (nb < kBlockStep || nb % kBlockStep || nb > kMaxBlocks || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 32:
      err = launch_kv<32, kLin>(x, g_in, wk, scratch, counter, m, l, gram, batch, n, nb, s);
      break;
    case 64:
      err = launch_kv<64, kLin>(x, g_in, wk, scratch, counter, m, l, gram, batch, n, nb, s);
      break;
    case 128:
      err = launch_kv<128, kLin>(x, g_in, wk, scratch, counter, m, l, gram, batch, n, nb, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <bool kLin>
int q_entry(const void* x, const void* g_in, const void* wq, const void* wtil,
            const void* b_out, const void* g_out, void* out, int batch, int n, int c,
            float scale, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 32:
      err = launch_q<32, kLin>(x, g_in, wq, wtil, b_out, g_out, out, batch, n, scale, s);
      break;
    case 64:
      err = launch_q<64, kLin>(x, g_in, wq, wtil, b_out, g_out, out, batch, n, scale, s);
      break;
    case 128:
      err = launch_q<128, kLin>(x, g_in, wq, wtil, b_out, g_out, out, batch, n, scale, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// x: [batch, n, c] bf16; g_in: [c] f32; wk: [c, 128] bf16; scratch:
// [batch, nb, c + 2, 128] f32; counter: [batch] int32, zero (left zero).
// Writes m, l [batch, 128] and gram [batch, c, 128], float32.  nb (blocks
// per row) is a multiple of kBlockStep, at most kMaxBlocks; the kernel
// splits each row's ceil(n / 64) tiles among them.
extern "C" int linear_attention_kv(const void* x, const void* g_in, const void* wk,
                                   void* scratch, void* counter, void* m, void* l, void* gram,
                                   int batch, int n, int c, int nb, void* stream) {
  return kv_entry<false>(x, g_in, wk, scratch, counter, m, l, gram, batch, n, c, nb, stream);
}

// x: [batch, n, c] bf16; g_in, b_out, g_out: [c] f32; wq: [c, 128] bf16;
// wtil: [batch, 128, c] bf16; out: [batch, n, c] bf16.  scale is the bf16
// value of dim_head^-1/2.
extern "C" int linear_attention_q(const void* x, const void* g_in, const void* wq,
                                  const void* wtil, const void* b_out, const void* g_out,
                                  void* out, int batch, int n, int c, float scale,
                                  void* stream) {
  return q_entry<false>(x, g_in, wq, wtil, b_out, g_out, out, batch, n, c, scale, stream);
}

// The attribution variants (kLin): the same arguments and outputs, every
// exponential replaced by a * 0.5 + 1.
extern "C" int linear_attention_kv_linexp(const void* x, const void* g_in, const void* wk,
                                          void* scratch, void* counter, void* m, void* l,
                                          void* gram, int batch, int n, int c, int nb,
                                          void* stream) {
  return kv_entry<true>(x, g_in, wk, scratch, counter, m, l, gram, batch, n, c, nb, stream);
}

extern "C" int linear_attention_q_linexp(const void* x, const void* g_in, const void* wq,
                                         const void* wtil, const void* b_out,
                                         const void* g_out, void* out, int batch, int n, int c,
                                         float scale, void* stream) {
  return q_entry<true>(x, g_in, wq, wtil, b_out, g_out, out, batch, n, c, scale, stream);
}
