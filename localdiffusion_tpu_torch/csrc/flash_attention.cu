// Full softmax attention for Hopper (sm_90a), one pass over K/V.
//
// Replaces the TPU kernel localdiffusion_tpu/ops/pallas_attention.py::_attn_kernel:
//   out = softmax(Q K^T * scale) V      per (batch, head), scores in float32
// for q, k, v laid out [B, N, H, D] with any batch/token/head strides and a
// unit stride along D (the views the UNet's Attention cuts from its qkv
// projection, read without a copy).  The output is a contiguous [B, N, H, D]
// of the input type (float or bfloat16).
//
// The Pallas kernel keeps a whole (batch*head)'s K and V in VMEM and scores
// a 512-row Q block against all of it.  A Hopper block has no such memory,
// so this kernel computes the same function the flash way: one block per
// (batch*head, tile of query rows), K/V tiles streamed through a ring in
// shared memory, and an online softmax (per tile the row's running max m
// and sum l are updated and the accumulator rescaled by exp2(m_old -
// m_new)), so the [N, N] score matrix never exists.
//
// Bound: at the 256px chain's [8, 1024, 4, 32] the work is ~4.3 GFLOP on
// the tensor cores (4.3 us at the bf16 peak) and 33.5 M exponentials, which
// at 16 a clock per SM on the special-function units take ~8 us: at
// head_dim 32 the exponentials, not the products, are the floor.  The two
// routes:
//   * bfloat16 (the chain's type): a block is two warpgroups of 64 query
//     rows each (two blocks share an SM).  S = Q K^T (m64n128k16) and
//     O += P V (m64n32k16) run on wgmma with Q and P as register operands
//     and K, V read from shared memory through descriptors: V serves as an
//     MN-major operand as it arrives, with no transpose.  K/V tiles of 128
//     keys are double-buffered with cp.async, the next tile loading while
//     this one is multiplied.  The softmax takes the
//     row max of the raw scores and folds the scale into one FMA before
//     ex2.approx; only the ragged last tile is masked.  P is rounded to
//     bf16 for the second product (the plain version rounds the normalised
//     probabilities to bf16 too).
//   * float32: the CUDA cores' FMAs, so the result keeps float32 accuracy
//     (tensor cores would round the inputs to TF32).  Eight threads share a
//     query row, each taking every eighth key of a tile with its own
//     running (m, l, acc); a fixed butterfly of shuffles merges the eight at
//     the end.  32 rows per block gives [8, 256, 4, 32] 256 blocks of eight
//     warps, and K/V tiles are double-buffered with cp.async.
// cp.async (not TMA): the loads must also serve q, k, v whose rows are not
// 16-byte aligned (then each 16-byte piece is read element by element), and
// the ring is short enough that the copies' issue cost does not show.
//
// Launch contract: the caller passes the current stream; the kernels
// allocate nothing and the function returns cudaGetLastError().

#include <math_constants.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kHeadDim = 32;  // the one instantiation: the configs' attn_dim_head

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 32;                       // query rows per block
constexpr int kF32Parts = 8;                       // threads per query row
constexpr int kF32Threads = kF32Rows * kF32Parts;  // 256
constexpr int kF32Keys = 64;                       // keys per shared-memory tile
constexpr int kF32Stride = kHeadDim + 4;  // floats per K/V row: the eight keys
                                          // a warp reads at once hit distinct banks

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int n, int heads,
                     long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
                     long long ksh, long long vsb, long long vsn, long long vsh,
                     float scale_log2, bool vec) {
  __shared__ __align__(16) float ks[2][kF32Keys * kF32Stride];
  __shared__ __align__(16) float vs[2][kF32Keys * kF32Stride];

  const int part = threadIdx.x % kF32Parts;  // lanes 8 r .. 8 r + 7 share row r
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int row = blockIdx.x * kF32Rows + threadIdx.x / kF32Parts;
  const bool live = row < n;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? qb[row * qsn + d] * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  // one tile of K and V rows into buffer `buf`, zeros past n; committed as
  // one cp.async group
  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * kF32Keys;
    for (int i = threadIdx.x; i < kF32Keys * D / 4; i += kF32Threads) {
      const int j = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool in = k0 + j < n;
      const int key = in ? k0 + j : 0;
      float* kd = &ks[buf][j * kF32Stride + c];
      float* vd = &vs[buf][j * kF32Stride + c];
      if (vec) {
        cp_async16(kd, kb + key * ksn + c, in);
        cp_async16(vd, vb + key * vsn + c, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kd[e] = in ? kb[key * ksn + c + e] : 0.f;
          vd[e] = in ? vb[key * vsn + c + e] : 0.f;
        }
      }
    }
    cp_async_commit();
  };

  const int ntiles = (n + kF32Keys - 1) / kF32Keys;
  load_tile(0, 0);
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      load_tile(tile + 1, (tile + 1) & 1);  // its buffer was released at the end of tile - 1
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks[tile & 1];
    const float* vt = vs[tile & 1];
    const int k0 = tile * kF32Keys;

    float s[kF32Keys / kF32Parts];
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < kF32Keys / kF32Parts; ++jj) {
      const int j = part + kF32Parts * jj;
      float acc_s = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&kt[j * kF32Stride + d]);
        acc_s = fmaf(qr[d], kk.x, acc_s);
        acc_s = fmaf(qr[d + 1], kk.y, acc_s);
        acc_s = fmaf(qr[d + 2], kk.z, acc_s);
        acc_s = fmaf(qr[d + 3], kk.w, acc_s);
      }
      s[jj] = k0 + j < n ? acc_s : -CUDART_INF_F;
      mt = fmaxf(mt, s[jj]);
    }
    const float m_new = fmaxf(m, mt);
    if (m_new != -CUDART_INF_F) {  // else no key of this thread's share yet
      const float corr = exp2f(m - m_new);  // 0 while m = -inf
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kF32Keys / kF32Parts; ++jj) {
        const int j = part + kF32Parts * jj;
        const float p = exp2f(s[jj] - m_new);  // 0 for a masked key
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vt[j * kF32Stride + d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
    __syncthreads();  // every thread has read this buffer before it is refilled
  }
  cp_async_wait<0>();

  // merge the eight shares of the row: a butterfly over lanes xor 1, 2, 4,
  // the same order in every run
#pragma unroll
  for (int off = 1; off < kF32Parts; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float ca = m == -CUDART_INF_F ? 0.f : exp2f(m - mn);
    const float cb = mo == -CUDART_INF_F ? 0.f : exp2f(mo - mn);
    l = l * ca + lo * cb;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * ca + ao * cb;
    }
    m = mn;
  }

  if (live) {  // lane `part` stores columns part * CP .. (part + 1) * CP - 1
    constexpr int CP = D / kF32Parts;
    const float inv = 1.f / l;
    float* o = out + ((static_cast<long long>(b) * n + row) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kF32Parts; ++c) {
      if (part == c) {
#pragma unroll
        for (int e = 0; e < CP; e += 4) {
          *reinterpret_cast<float4*>(o + c * CP + e) =
              make_float4(acc[c * CP + e] * inv, acc[c * CP + e + 1] * inv,
                          acc[c * CP + e + 2] * inv, acc[c * CP + e + 3] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kWgs = 2;                    // warpgroups per block
constexpr int kMmaThreads = 128 * kWgs;
constexpr int kMmaRows = 64 * kWgs;        // query rows per block, 64 per warpgroup
constexpr int kMmaKeys = 128;              // keys per K/V tile
constexpr int kStages = 2;                 // K/V tiles in the ring

// 2^x on the special-function unit (flushes denormal results to 0: they
// weigh nothing beside the row's largest term, which is 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of (key j, 16-byte piece c) in a K or V tile: core matrices
// of 8 keys x 8 channels, the 4 pieces of a key group 128 bytes apart and
// key groups 512 apart.  As K (K-major B of S = Q K^T) it has LBO 128 and
// SBO 512; as V (MN-major B of O = P V) LBO 512 and SBO 128.
__device__ __forceinline__ int kv_offset(int j, int c) {
  return (j >> 3) * 512 + c * 128 + (j & 7) * 16;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight consecutive bf16 of a row, by one 16-byte load when `vec` (every
// address a multiple of 16 bytes) or by eight loads; zeros past the end.
__device__ __forceinline__ uint4 load8(const bf16* src, bool in, bool vec) {
  uint4 u = make_uint4(0, 0, 0, 0);
  if (in && vec) {
    u = *reinterpret_cast<const uint4*>(src);
  } else if (in) {
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = src[i];
  }
  return u;
}

template <int D>
constexpr int wgmma_smem_bytes() {
  return kStages * 2 * kMmaKeys * D * 2 + kMmaRows * (D + 8) * 2;
}

// POS: scale > 0, so the row max of the scaled scores is the scaled max of
// the raw ones and exp2(s scale - m) is one fused multiply-add; otherwise
// the scores are scaled first.
template <int D, bool POS>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int n, int heads,
                       long long qsb, long long qsn, long long qsh, long long ksb,
                       long long ksn, long long ksh, long long vsb, long long vsn,
                       long long vsh, float scale_log2, bool vec) {
  static_assert(D == 32, "the K/V tile layout is written for head_dim 32");
  constexpr int QS = D + 8;  // row stride of the Q tile (bank spread)
  constexpr int kTileBytes = kMmaKeys * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* kv = smem;  // [kStages][K, V][kTileBytes]
  bf16* qs = reinterpret_cast<bf16*>(smem + kStages * 2 * kTileBytes);  // [kMmaRows][QS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kMmaRows;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  // K and V of one tile into ring stage `st`, zeros past n, as one group
  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * kMmaKeys;
    for (int i = threadIdx.x; i < 2 * kMmaKeys * (D / 8); i += kMmaThreads) {
      const int which = i / (kMmaKeys * (D / 8)), r = i % (kMmaKeys * (D / 8));
      const int j = r / (D / 8), c = r % (D / 8);
      const bool in = k0 + j < n;
      const int key = in ? k0 + j : 0;
      const bf16* src = which ? vb + key * vsn + 8 * c : kb + key * ksn + 8 * c;
      unsigned char* dst = kv + (st * 2 + which) * kTileBytes + kv_offset(j, c);
      if (vec) {
        cp_async16(dst, src, in);
      } else {
        *reinterpret_cast<uint4*>(dst) = load8(src, in, false);
      }
    }
    cp_async_commit();
  };

  const int ntiles = (n + kMmaKeys - 1) / kMmaKeys;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) {
      load_kv(s, s);
    } else {
      cp_async_commit();
    }
  }

  for (int i = threadIdx.x; i < kMmaRows * D / 8; i += kMmaThreads) {
    const int r = i / (D / 8), d = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(qs + r * QS + d) = load8(qb + (q0 + r) * qsn + d, q0 + r < n, vec);
  }
  __syncthreads();
  const int r0 = warp * 16;  // warp w of warpgroup wg: rows 64 wg + 16 (w % 4) ..
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p = qs + (r0 + g) * QS + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * QS);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * QS + 8);
  }

  float o[D / 2];  // m64nD accumulator: rows g, g + 8 of the warp; D / 8 column tiles
  float s[kMmaKeys / 2];  // S = Q K^T, the warp's 16 rows x kMmaKeys keys
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kMmaKeys / 2; ++i) s[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows g and g + 8, scaled
  float l0 = 0.f, l1 = 0.f;                      // this thread's share of the sums

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();  // the copies are read by wgmma (the async proxy)
    __syncthreads();  // the tile has landed; every warp is done with tile - 1
    {
      const int next = tile + kStages - 1;  // into the stage tile - 1 used
      if (next < ntiles) {
        load_kv(next, next % kStages);
      } else {
        cp_async_commit();
      }
    }
    const unsigned char* kt = kv + (tile % kStages) * 2 * kTileBytes;
    const unsigned char* vt = kt + kTileBytes;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_m64n128k16<0>(s, qa[kk], smem_desc(kt + kk * 256, 128, 512), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    const int k0 = tile * kMmaKeys;
    if (!POS) {
#pragma unroll
      for (int i = 0; i < kMmaKeys / 2; ++i) s[i] *= scale_log2;
    }
    if (k0 + kMmaKeys > n) {  // the ragged last tile: keys past n never win the max
#pragma unroll
      for (int i = 0; i < kMmaKeys / 2; ++i) {
        if (k0 + (i / 4) * 8 + 2 * t + (i & 1) >= n) s[i] = -CUDART_INF_F;
      }
    }
    float mx0 = s[0], mx1 = s[2];
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (POS) {
      mx0 *= scale_log2;
      mx1 *= scale_log2;
    }
    // key 0 lies in tile 0, so the maxima are finite from the first tile on
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
    const float sc = POS ? scale_log2 : 1.f;

    uint32_t pa[kMmaKeys / 16][4];  // P as the A operand of P V
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j) {
      const float p0 = ex2(fmaf(s[4 * j], sc, -m0)), p1 = ex2(fmaf(s[4 * j + 1], sc, -m0));
      const float p2 = ex2(fmaf(s[4 * j + 2], sc, -m1)), p3 = ex2(fmaf(s[4 * j + 3], sc, -m1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      wgmma_m64n32k16<1>(o, pa[kk], smem_desc(vt + kk * 1024, 512, 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row = q0 + r0 + g;
  const long long row_stride = static_cast<long long>(heads) * D;
  bf16* o0 = out + (static_cast<long long>(b) * n * heads + h) * D + row * row_stride;
  bf16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (row < n) {
      *reinterpret_cast<uint32_t*>(o0 + d) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (row + 8 < n) {
      *reinterpret_cast<uint32_t*>(o1 + d) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// 16-byte pieces need every row start on a 16-byte boundary: strides a
// multiple of `per16` elements and the three base pointers aligned.
bool aligned16(const void* q, const void* k, const void* v, const long long* st, int per16) {
  bool vec = true;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % per16 == 0;
  for (const void* p : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return vec;
}

template <int D, bool POS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int batch,
                         int n, int heads, const long long* st, float scale_log2,
                         cudaStream_t stream) {
  constexpr int smem = wgmma_smem_bytes<D>();
  auto kern = flash_fwd_wgmma_kernel<D, POS>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, batch * heads);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), n, heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale_log2, aligned16(q, k, v, st, 8));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int batch,
                       int n, int heads, const long long* st, float scale_log2,
                       cudaStream_t stream) {
  const dim3 grid((n + kF32Rows - 1) / kF32Rows, batch * heads);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, heads, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale_log2, aligned16(q, k, v, st, 4));
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements: (batch, token, head) for q, then k, then v.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  head_dim must be
// kHeadDim, the denoiser's attn_dim_head.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int batch, int n, int heads, int head_dim,
                               long long qsb, long long qsn, long long qsh,
                               long long ksb, long long ksn, long long ksh,
                               long long vsb, long long vsn, long long vsh,
                               float scale, int dtype, void* stream) {
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != kHeadDim || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32<kHeadDim>(q, k, v, out, batch, n, heads, st, scale_log2, s);
  } else if (dtype == 1) {
    err = scale_log2 > 0.f
              ? launch_wgmma<kHeadDim, true>(q, k, v, out, batch, n, heads, st, scale_log2, s)
              : launch_wgmma<kHeadDim, false>(q, k, v, out, batch, n, heads, st, scale_log2, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
