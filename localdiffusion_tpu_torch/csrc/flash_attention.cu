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
// (batch*head, tile of query rows), K/V tiles streamed through shared
// memory, and an online softmax (per tile the row's running max m and sum l
// are updated and the accumulator rescaled by exp2(m_old - m_new)), so the
// [N, N] score matrix never exists.
//
// Bound: at the 256px chain's [8, 1024, 4, 32] the work is ~4.3 GFLOP
// against ~8.4 MB of traffic in bf16, so the bound is the arithmetic, and
// the two routes differ in where they do it:
//   * bfloat16 (the chain's type): the tensor cores, through mma.sync
//     m16n8k16 (bf16 in, float32 accumulate).  Four warps, 16 query rows
//     each; S = Q K^T and O += P V are warp-level products on fragments held
//     in registers; P is rounded to bf16 for the second product (the plain
//     version rounds the normalised probabilities to bf16 too).  wgmma and
//     TMA are the next step.
//   * float32: the CUDA cores' FMAs, one query row per thread, reading K/V
//     rows from shared memory as broadcasts, so the result keeps float32
//     accuracy (tensor cores would round the inputs).
//
// Launch contract: the caller passes the current stream; the kernels
// allocate nothing and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kHeadDim = 32;  // the one instantiation: the configs' attn_dim_head

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // query rows per block = threads per block

template <int D>
__global__ void __launch_bounds__(kRows)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int n, int heads,
                 long long qsb, long long qsn, long long qsh,
                 long long ksb, long long ksn, long long ksh,
                 long long vsb, long long vsn, long long vsh, float scale_log2) {
  constexpr int kKeys = 64;  // keys per shared-memory tile
  __shared__ __align__(16) float ks[kKeys][D];
  __shared__ __align__(16) float vs[kKeys][D];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int row = blockIdx.x * kRows + threadIdx.x;
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

  for (int k0 = 0; k0 < n; k0 += kKeys) {
    for (int i = threadIdx.x; i < kKeys * D; i += kRows) {
      const int j = i / D, d = i % D;
      const int key = k0 + j;
      const bool in = key < n;
      ks[j][d] = in ? kb[key * ksn + d] : 0.f;
      vs[j][d] = in ? vb[key * vsn + d] : 0.f;
    }
    __syncthreads();
    const int nk = min(kKeys, n - k0);

    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        s[j] = fmaf(qr[d], kk.x, s[j]);
        s[j] = fmaf(qr[d + 1], kk.y, s[j]);
        s[j] = fmaf(qr[d + 2], kk.z, s[j]);
        s[j] = fmaf(qr[d + 3], kk.w, s[j]);
      }
    }
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (j < nk) mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = exp2f(m - m_new);  // 0 on the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = j < nk ? exp2f(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
    __syncthreads();  // the tile is read by every thread before it is replaced
  }

  if (live) {
    const float inv = 1.f / l;
    float* o = out + ((static_cast<long long>(b) * n + row) * heads + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block, 16 per warp
constexpr int kMmaKeys = 64;              // keys per shared-memory tile

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b for one 16x8x16 tile: a row-major 16x16, b col-major 16x8 (bf16),
// c 16x8 float.  Fragment layout (lane = 4 g + t): a = {(g, 2t..), (g+8,
// 2t..), (g, 2t+8..), (g+8, 2t+8..)}, b = {(k 2t.., n g), (k 2t+8.., n g)},
// c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight consecutive bf16 of a row, by one 16-byte load when `vec` (every
// address a multiple of 16 bytes) or by eight loads; zeros past the end.
__device__ __forceinline__ void load8(const __nv_bfloat16* src, bool in, bool vec,
                                      __nv_bfloat16* dst) {
  if (!in) {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __float2bfloat16(0.f);
  } else if (vec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = src[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     int n, int heads, long long qsb, long long qsn, long long qsh,
                     long long ksb, long long ksn, long long ksh, long long vsb,
                     long long vsn, long long vsh, float scale_log2, bool vec) {
  constexpr int QS = D + 8;         // row stride of the Q and K tiles (bank spread)
  constexpr int VS = kMmaKeys + 8;  // row stride of the transposed V tile
  constexpr int KD = D / 16;        // k-steps over the head dimension
  constexpr int ND = D / 8;         // output column tiles
  __shared__ __align__(16) __nv_bfloat16 qs[kMmaRows * QS];
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaKeys * QS];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kMmaRows;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  for (int i = threadIdx.x; i < kMmaRows * D / 8; i += kMmaWarps * 32) {
    const int r = i / (D / 8), d = (i % (D / 8)) * 8;
    load8(qb + (q0 + r) * qsn + d, q0 + r < n, vec, qs + r * QS + d);
  }
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const __nv_bfloat16* p = qs + (r0 + g) * QS + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * QS);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * QS + 8);
  }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;                      // this thread's share of the sums

  for (int k0 = 0; k0 < n; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile has been read
    for (int i = threadIdx.x; i < kMmaKeys * D / 8; i += kMmaWarps * 32) {
      const int j = i / (D / 8), d = (i % (D / 8)) * 8;
      const bool in = k0 + j < n;
      load8(kb + (k0 + j) * ksn + d, in, vec, ks + j * QS + d);
      __align__(16) __nv_bfloat16 tmp[8];
      load8(vb + (k0 + j) * vsn + d, in, vec, tmp);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(d + e) * VS + j] = tmp[e];
    }
    __syncthreads();

    float s[kMmaKeys / 8][4];  // S = Q K^T, 16 rows x 64 keys per warp
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* p = ks + (j * 8 + g) * QS + kk * 16 + 2 * t;
        mma16816(s[j], qa[kk], ld32(p), ld32(p + 8));
      }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = k0 + j * 8 + 2 * t + (e & 1) < n;
        s[j][e] = in ? s[j][e] * scale_log2 : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }

    uint32_t pa[kMmaKeys / 16][4];  // P as the A operand of P V
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j) {
      const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
      const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const __nv_bfloat16* p = vt + (j * 8 + g) * VS + kk * 16 + 2 * t;
        mma16816(o[j], pa[kk], ld32(p), ld32(p + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row = q0 + r0 + g;
  const long long row_stride = static_cast<long long>(heads) * D;
  __nv_bfloat16* o0 = out + (static_cast<long long>(b) * n * heads + h) * D + row * row_stride;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = j * 8 + 2 * t;
    if (row < n) {
      *reinterpret_cast<uint32_t*>(o0 + d) = pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    }
    if (row + 8 < n) {
      *reinterpret_cast<uint32_t*>(o1 + d) = pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int batch,
                       int n, int heads, const long long* st, float scale_log2,
                       cudaStream_t stream) {
  // 16-byte loads need every row start on a 16-byte boundary
  bool vec = true;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  for (const void* p : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, batch * heads);
  flash_fwd_mma_kernel<D><<<grid, kMmaWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), n, heads,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale_log2, vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int batch,
                       int n, int heads, const long long* st, float scale_log2,
                       cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, batch * heads);
  flash_fwd_f32_kernel<D><<<grid, kRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, heads, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale_log2);
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
  if (head_dim != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32<kHeadDim>(q, k, v, out, batch, n, heads, st, scale_log2, s);
  } else if (dtype == 1) {
    err = launch_mma<kHeadDim>(q, k, v, out, batch, n, heads, st, scale_log2, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
