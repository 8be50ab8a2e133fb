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
//     d of k the running max m[d], the sum l[d] = sum_n exp(k[n,d] - m[d])
//     and the Gram G[c,d] = sum_n xn[n,c] * exp(k[n,d] - m[d]).  The v
//     projection is linear, so it is applied to G afterwards (ctx^T = Wv^T G),
//     on [C, 128] numbers instead of on every token.
//   the fold (PyTorch, between the launches): the partials of all blocks
//     merged by the log-sum-exp rule, ctx^T / l, the cross-head mask, and
//     the output projection folded in: W~ = ctxn^T Wout, [128, C] per row.
//   pass 2, q_kernel: per token xn, q = xn Wq (bf16), a softmax over each
//     head's 32 values, qs = bf16(bf16(softmax) * bf16(scale)), out = qs W~ +
//     b rounded to bf16, then the output RMSNorm; the residual is added by
//     the caller.
//
// The Pallas kernels fold 128/C tokens into the 128 TPU lanes and use
// block-diagonal weights and 0/1 mask matmuls to keep Mosaic's layouts; none
// of that is needed here.  What does not carry over is the TPU grid's order:
// pass 1 reduces over all N tokens of a row (65,536 at 256px), and one block
// per row would give only B blocks.  So each block takes `per_block`
// consecutive tokens of one row and writes its own partial (m, l, G); the
// fold merges them (rescaling each by exp(m_i - m)).  No atomics: the
// result does not depend on the order blocks run in.
//
// Bound: at [8, 65536, 32] each pass reads x once (33.5 MB) and pass 2
// writes the output once; the products are ~8.6 GFLOP per pass, so both
// passes are bound by device memory on this card.  The three products
// (xn Wk or xn Wq; xn^T exp(k); qs W~) run on the tensor cores through
// mma.sync m16n8k16 (bf16 operands, float32 accumulation), eight warps per
// block; the norms, maxima and exponentials stay float32 on the CUDA cores.
// Inside a block, tokens go through shared memory in sub-tiles of kTok =
// 64, and the weights stay in shared memory for the whole block.  Operand
// tiles are stored with the contracted axis contiguous and rows padded by 8
// elements, so every fragment load is one 32-bit word and the 32 lanes of a
// warp hit 32 different banks.
//
// Launch contract: the caller passes the current stream; the kernels
// allocate nothing and each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kTok = 64;       // tokens per sub-tile
constexpr int kHid = 128;      // heads * dim_head
constexpr int kDh = 32;        // dim_head
constexpr int kTokS = kTok + 8;  // row stride of the token-contiguous tiles
constexpr int kHidS = kHid + 8;  // row stride of the hidden-contiguous tiles

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// c += a b for one 16x8x16 tile (bf16 in, float32 accumulate).  Fragments
// (lane = 4 g + t): a = {(g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}
// of a row-major 16x16 tile, b = {(k 2t.., n g), (k 2t+8.., n g)} of a 16x8
// tile, c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows r0.., columns k0.. of a row-major bf16 matrix with
// row stride S.
template <int S>
__device__ __forceinline__ void load_a(const bf16* m, int r0, int k0, uint32_t* a) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const bf16* p = m + (r0 + g) * S + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * S);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * S + 8);
}

// The B fragment of columns n0.., contracted rows k0.., of a matrix stored
// transposed (row n holds column n, contracted axis contiguous, stride S).
template <int S>
__device__ __forceinline__ void load_b(const bf16* mt, int n0, int k0, uint32_t& b0,
                                       uint32_t& b1) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const bf16* p = mt + (n0 + g) * S + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// Tokens [t0, t0 + kTok) of one row (zero from `end` on), RMS-normalised,
// x / max(|x|, 1e-12) * gs[c] with gs = g * sqrt(C), rounded to bf16, into
// xb [kTok][C + 8] and, when given, xt [C][kTok + 8] (transposed).  Four
// threads per token, each with C / 4 channels in registers.
template <int C>
__device__ void load_rms(const bf16* __restrict__ xr, int t0, int end, const float* gs,
                         bf16* xb, bf16* xt) {
  constexpr int kPer = C / 4;
  const int tok = threadIdx.x / 4, part = threadIdx.x % 4;
  const int c0 = part * kPer;
  float v[kPer];
  if (t0 + tok < end) {
    const uint4* src = reinterpret_cast<const uint4*>(xr + static_cast<long long>(t0 + tok) * C + c0);
#pragma unroll
    for (int i = 0; i < kPer / 8; ++i) {
      const uint4 u = src[i];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        v[8 * i + 2 * j] = f.x;
        v[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = 0.f;
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) ss = fmaf(v[i], v[i], ss);
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  const float inv = 1.f / fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
  for (int i = 0; i < kPer; i += 2) {
    const float a = v[i] * inv * gs[c0 + i], b = v[i + 1] * inv * gs[c0 + i + 1];
    st_pair(xb + tok * (C + 8) + c0 + i, a, b);
    if (xt != nullptr) {
      xt[(c0 + i) * kTokS + tok] = __float2bfloat16(a);
      xt[(c0 + i + 1) * kTokS + tok] = __float2bfloat16(b);
    }
  }
}

// ps[tok][col] = bf16(sum_c xb[tok][c] wt[col][c]) for the sub-tile's
// [64, 128] block: warp w takes rows 16 (w % 4).. and columns 64 (w / 4)..
template <int C>
__device__ void project(const bf16* xb, const bf16* wt, bf16* ps) {
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const int r0 = 16 * (warp % 4), n0 = 64 * (warp / 4);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C; kk += 16) {
    uint32_t a[4];
    load_a<C + 8>(xb, r0, kk, a);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b0, b1;
      load_b<C + 8>(wt, n0 + 8 * j, kk, b0, b1);
      mma16816(acc[j], a, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    st_pair(ps + (r0 + g) * kHidS + col, acc[j][0], acc[j][1]);
    st_pair(ps + (r0 + g + 8) * kHidS + col, acc[j][2], acc[j][3]);
  }
}

// A [C][128] weight (row-major, global) into shared memory transposed,
// wt[col][c] with row stride C + 8.
template <int C>
__device__ void stage_transposed(const bf16* __restrict__ w, bf16* wt) {
  for (int i = threadIdx.x; i < C * kHid; i += kThreads) {
    const int c = i / kHid, col = i % kHid;
    wt[col * (C + 8) + c] = w[i];
  }
}

template <int C>
constexpr int kv_smem_bytes() {
  return 2 * (kHid * (C + 8) + kTok * (C + 8) + C * kTokS + kTok * kHidS + kHid * kTokS) +
         4 * (C + 5 * kHid);
}

template <int C>
constexpr int q_smem_bytes() {
  return 2 * (kHid * (C + 8) + C * kHidS + kTok * (C + 8) + kTok * kHidS + kTok * (C + 8)) +
         4 * 3 * C;
}

// Pass 1.  Grid (blocks per row, B).  Writes m, l [B, nb, 128] and
// G [B, nb, C, 128] (float32), each relative to the block's own max.
template <int C>
__global__ void __launch_bounds__(kThreads)
kv_kernel(const bf16* __restrict__ x, const float* __restrict__ g_in,
          const bf16* __restrict__ wk, float* __restrict__ m_out,
          float* __restrict__ l_out, float* __restrict__ gram_out, int n,
          int per_block) {
  constexpr int TPW = C / 8;  // Gram tiles (16x8) per warp: C / 16 x 16 over 8 warps
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wt = reinterpret_cast<bf16*>(smem);  // [128][C + 8]
  bf16* xb = wt + kHid * (C + 8);            // [64][C + 8]
  bf16* xt = xb + kTok * (C + 8);            // [C][72]
  bf16* ks = xt + C * kTokS;                 // [64][136], k
  bf16* et = ks + kTok * kHidS;              // [128][72], exp(k - m) transposed
  float* gs = reinterpret_cast<float*>(et + kHid * kTokS);
  float* m_run = gs + C;
  float* l_run = m_run + kHid;
  float* fct = l_run + kHid;
  float* red = fct + kHid;  // [2, 128]

  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
  const int row = blockIdx.y;
  const int t_begin = blockIdx.x * per_block;
  const int t_end = min(n, t_begin + per_block);
  const bf16* xr = x + static_cast<long long>(row) * n * C;

  stage_transposed<C>(wk, wt);
  for (int i = tid; i < C; i += kThreads) gs[i] = g_in[i] * sqrtf(static_cast<float>(C));
  if (tid < kHid) {
    m_run[tid] = -CUDART_INF_F;
    l_run[tid] = 0.f;
  }
  // this warp's Gram tiles: rows 16 mt.., columns 8 (nt0 + i)..
  const int mt = (warp * TPW) / 16, nt0 = (warp * TPW) % 16;
  float acc[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  __syncthreads();

  const int col = tid % kHid, half = tid / kHid;  // column pass: 2 threads a column
  for (int t0 = t_begin; t0 < t_end; t0 += kTok) {
    load_rms<C>(xr, t0, t_end, gs, xb, xt);
    __syncthreads();
    project<C>(xb, wt, ks);
    __syncthreads();
    const int valid = min(kTok, t_end - t0);

    float mx = -CUDART_INF_F;
    for (int i = 0; i < kTok / 2; ++i) {
      const int tok = half * (kTok / 2) + i;
      if (tok < valid) mx = fmaxf(mx, __bfloat162float(ks[tok * kHidS + col]));
    }
    red[half * kHid + col] = mx;
    __syncthreads();
    if (tid < kHid) {
      const float m_new = fmaxf(m_run[tid], fmaxf(red[tid], red[kHid + tid]));
      fct[tid] = expf(m_run[tid] - m_new);  // 0 on the first sub-tile
      m_run[tid] = m_new;
    }
    __syncthreads();

    // exp(k - m): float32 into l, rounded to bf16 for the Gram (as the
    // Pallas kernel feeds its matmul)
    const float mc = m_run[col];
    float sum = 0.f;
    for (int i = 0; i < kTok / 2; i += 2) {
      const int tok = half * (kTok / 2) + i;
      const float e0 = tok < valid ? expf(__bfloat162float(ks[tok * kHidS + col]) - mc) : 0.f;
      const float e1 =
          tok + 1 < valid ? expf(__bfloat162float(ks[(tok + 1) * kHidS + col]) - mc) : 0.f;
      sum += e0 + e1;
      st_pair(et + col * kTokS + tok, e0, e1);
    }
    red[half * kHid + col] = sum;
    __syncthreads();
    if (tid < kHid) l_run[tid] = l_run[tid] * fct[tid] + red[tid] + red[kHid + tid];

    // G = G * fct + xn^T exp(k - m) over the sub-tile's 64 tokens
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int c2 = 8 * (nt0 + i) + 2 * t;
      acc[i][0] *= fct[c2];
      acc[i][1] *= fct[c2 + 1];
      acc[i][2] *= fct[c2];
      acc[i][3] *= fct[c2 + 1];
    }
#pragma unroll
    for (int kk = 0; kk < kTok; kk += 16) {
      uint32_t a[4];
      load_a<kTokS>(xt, 16 * mt, kk, a);
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        uint32_t b0, b1;
        load_b<kTokS>(et, 8 * (nt0 + i), kk, b0, b1);
        mma16816(acc[i], a, b0, b1);
      }
    }
    __syncthreads();  // the tiles are refilled by the next sub-tile
  }

  const long long p = static_cast<long long>(row) * gridDim.x + blockIdx.x;
  if (tid < kHid) {
    m_out[p * kHid + tid] = m_run[tid];
    l_out[p * kHid + tid] = l_run[tid];
  }
  float* gp = gram_out + p * C * kHid;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int c2 = 8 * (nt0 + i) + 2 * t;
    const int r = 16 * mt + g;
    *reinterpret_cast<float2*>(gp + r * kHid + c2) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(gp + (r + 8) * kHid + c2) = make_float2(acc[i][2], acc[i][3]);
  }
}

// Pass 2.  Grid (blocks per row, B).  wtil: [B, 128, C] bf16.
template <int C>
__global__ void __launch_bounds__(kThreads)
q_kernel(const bf16* __restrict__ x, const float* __restrict__ g_in,
         const bf16* __restrict__ wq, const bf16* __restrict__ wtil,
         const float* __restrict__ b_out, const float* __restrict__ g_out,
         bf16* __restrict__ out, int n, int per_block, float scale) {
  constexpr int NPW = C / 16;  // output column tiles (x8) per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wt = reinterpret_cast<bf16*>(smem);  // [128][C + 8], Wq transposed
  bf16* vt = wt + kHid * (C + 8);            // [C][136], W~ transposed
  bf16* xb = vt + C * kHidS;                 // [64][C + 8]
  bf16* qs = xb + kTok * (C + 8);            // [64][136], q, then softmax(q)
  bf16* ob = qs + kTok * kHidS;              // [64][C + 8], the output before its norm
  float* gs = reinterpret_cast<float*>(ob + kTok * (C + 8));
  float* gos = gs + C;
  float* bos = gos + C;

  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
  const int row = blockIdx.y;
  const int t_begin = blockIdx.x * per_block;
  const int t_end = min(n, t_begin + per_block);
  const bf16* xr = x + static_cast<long long>(row) * n * C;
  bf16* outr = out + static_cast<long long>(row) * n * C;
  const bf16* wtr = wtil + static_cast<long long>(row) * kHid * C;

  stage_transposed<C>(wq, wt);
  for (int i = tid; i < kHid * C; i += kThreads) {  // W~[d][c] -> vt[c][d]
    const int d = i / C, c = i % C;
    vt[c * kHidS + d] = wtr[i];
  }
  const float root_c = sqrtf(static_cast<float>(C));
  for (int i = tid; i < C; i += kThreads) {
    gs[i] = g_in[i] * root_c;
    gos[i] = g_out[i] * root_c;
    bos[i] = b_out[i];
  }
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += kTok) {
    load_rms<C>(xr, t0, t_end, gs, xb, nullptr);
    __syncthreads();
    project<C>(xb, wt, qs);  // q, rounded to bf16
    __syncthreads();

    {  // softmax over each head's 32 values: one thread per (token, head)
      const int tok = tid / 4, hd = tid % 4;
      bf16* qh = qs + tok * kHidS + hd * kDh;
      float e[kDh];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kDh; i += 2) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qh + i));
        e[i] = f.x;
        e[i + 1] = f.y;
        mx = fmaxf(mx, fmaxf(f.x, f.y));
      }
      float den = 0.f;
#pragma unroll
      for (int i = 0; i < kDh; ++i) {
        e[i] = expf(e[i] - mx);
        den += e[i];
      }
#pragma unroll
      for (int i = 0; i < kDh; i += 2) {
        st_pair(qh + i, bf16_round(e[i] / den) * scale, bf16_round(e[i + 1] / den) * scale);
      }
    }
    __syncthreads();

    {  // out = qs W~ + b, rounded to bf16: warp w takes rows 16 (w % 4)..,
       // columns 8 NPW (w / 4)..
      const int r0 = 16 * (warp % 4), n0 = 8 * NPW * (warp / 4);
      float acc[NPW][4];
#pragma unroll
      for (int j = 0; j < NPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHid; kk += 16) {
        uint32_t a[4];
        load_a<kHidS>(qs, r0, kk, a);
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          uint32_t b0, b1;
          load_b<kHidS>(vt, n0 + 8 * j, kk, b0, b1);
          mma16816(acc[j], a, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int c2 = n0 + 8 * j + 2 * t;
        st_pair(ob + (r0 + g) * (C + 8) + c2, acc[j][0] + bos[c2], acc[j][1] + bos[c2 + 1]);
        st_pair(ob + (r0 + g + 8) * (C + 8) + c2, acc[j][2] + bos[c2], acc[j][3] + bos[c2 + 1]);
      }
    }
    __syncthreads();

    {  // output RMSNorm, four threads per token, and the store
      constexpr int kPer = C / 4;
      const int tok = tid / 4, part = tid % 4;
      const bf16* ot = ob + tok * (C + 8) + part * kPer;
      float v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = __bfloat162float(ot[i]);
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) ss = fmaf(v[i], v[i], ss);
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      const float inv = 1.f / fmaxf(sqrtf(ss), 1e-12f);
      if (t0 + tok < t_end) {
        bf16* dst = outr + static_cast<long long>(t0 + tok) * C + part * kPer;
#pragma unroll
        for (int i = 0; i < kPer; i += 8) {
          __align__(16) bf16 w[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            w[j] = __float2bfloat16(v[i + j] * inv * gos[part * kPer + i + j]);
          *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(w);
        }
      }
    }
    __syncthreads();  // the tiles are refilled by the next sub-tile
  }
}

// Set before every launch: the attribute belongs to the device that is
// current at the call, so a once-per-process setting misses a second card.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int C>
cudaError_t launch_kv(const void* x, const void* g_in, const void* wk, void* m, void* l,
                      void* gram, int batch, int n, int per_block, cudaStream_t s) {
  constexpr int bytes = kv_smem_bytes<C>();
  const cudaError_t attr = allow_smem(kv_kernel<C>, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + per_block - 1) / per_block, batch);
  kv_kernel<C><<<grid, kThreads, bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g_in),
      static_cast<const bf16*>(wk), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(gram), n, per_block);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_q(const void* x, const void* g_in, const void* wq, const void* wtil,
                     const void* b_out, const void* g_out, void* out, int batch, int n,
                     int per_block, float scale, cudaStream_t s) {
  constexpr int bytes = q_smem_bytes<C>();
  const cudaError_t attr = allow_smem(q_kernel<C>, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + per_block - 1) / per_block, batch);
  q_kernel<C><<<grid, kThreads, bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g_in),
      static_cast<const bf16*>(wq), static_cast<const bf16*>(wtil),
      static_cast<const float*>(b_out), static_cast<const float*>(g_out),
      static_cast<bf16*>(out), n, per_block, scale);
  return cudaGetLastError();
}

}  // namespace

// x: [batch, n, c] bf16; g_in: [c] f32; wk: [c, 128] bf16.  Writes, for the
// ceil(n / per_block) blocks of each row, m and l [batch, nb, 128] and
// gram [batch, nb, c, 128], float32.  per_block is a multiple of 64.
extern "C" int linear_attention_kv(const void* x, const void* g_in, const void* wk,
                                   void* m, void* l, void* gram, int batch, int n, int c,
                                   int per_block, void* stream) {
  if (per_block <= 0 || per_block % kTok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 32: err = launch_kv<32>(x, g_in, wk, m, l, gram, batch, n, per_block, s); break;
    case 64: err = launch_kv<64>(x, g_in, wk, m, l, gram, batch, n, per_block, s); break;
    case 128: err = launch_kv<128>(x, g_in, wk, m, l, gram, batch, n, per_block, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// x: [batch, n, c] bf16; g_in, b_out, g_out: [c] f32; wq: [c, 128] bf16;
// wtil: [batch, 128, c] bf16; out: [batch, n, c] bf16.  scale is the bf16
// value of dim_head^-1/2.
extern "C" int linear_attention_q(const void* x, const void* g_in, const void* wq,
                                  const void* wtil, const void* b_out, const void* g_out,
                                  void* out, int batch, int n, int c, int per_block,
                                  float scale, void* stream) {
  if (per_block <= 0 || per_block % kTok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 32:
      err = launch_q<32>(x, g_in, wq, wtil, b_out, g_out, out, batch, n, per_block, scale, s);
      break;
    case 64:
      err = launch_q<64>(x, g_in, wq, wtil, b_out, g_out, out, batch, n, per_block, scale, s);
      break;
    case 128:
      err = launch_q<128>(x, g_in, wq, wtil, b_out, g_out, out, batch, n, per_block, scale, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
