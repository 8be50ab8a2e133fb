// Fused ResnetBlock for Hopper (sm_90a): the 3x3 convolution with its
// GroupNorm statistics, and the epilogue.
//
// Replaces the TPU kernels localdiffusion_tpu/ops/pallas_resnet_block.py
// ::_conv_stats_kernel (passes 1 and 2) and ::_epilogue_kernel (pass 3) of
// the normal-layout fused block.  On NHWC bfloat16 rows:
//
//   conv3x3_stats: h = bf16(conv3x3(in) + bias) with pad 1, float32 sums of
//     bf16 products and the float32 bias added before the rounding; and, per
//     tile of pixels and per channel, the float32 sum and sum of squares of
//     the rounded h.  With the prologue (pass 2), in = bf16(silu(x * a + b))
//     with a per-(row, channel) affine, applied to the input tile in shared
//     memory.  The conv's zero padding lies outside the image and stays zero
//     after the activation (silu(b) is not 0), as the TPU kernel zeroes its
//     halo.
//   epilogue: out = bf16(bf16(silu(h * a + b)) + res), res = x (identity) or
//     bf16(x Wres + bres), the 1x1 res_conv on the tensor cores with its
//     float32 bias, as the TPU kernel computes it in its own body.  The
//     residual reads x, the block's input.
//
// The GroupNorm folds between the passes (the tiles' partials summed, group
// statistics, FiLM) run in PyTorch on [B, C] numbers, as the JAX package
// runs them in XLA.  The TPU kernel folds r = 128 / Cout adjacent pixels
// into its 128 lanes (the W-fold) and sums its statistics across a
// sequential grid; neither carries over.  Here a tile is kTileH x kTileW =
// 8 x 16 pixels of one row, and its partial sums are written by whoever
// computes it: no atomics, and the tile grid depends on H and W alone, so a
// row's result does not depend on the batch it is in.
//
// Bound: at the 256px chain's sites (batch 8) most passes do fewer flops
// per byte than the card's ~295 for bf16, so device memory bounds them
// (256x256, 32 -> 32 channels: 33.5 MB in, 33.5 MB out, 9.7 GFLOP); the
// 64x64 and 128x128 passes with 96 to 192 input channels are bound by
// operations.  conv3x3_stats is an implicit GEMM on wgmma:
//   * M = a tile's 128 pixels, two warpgroups of 64 (warpgroup wg takes
//     pixels 8 wg .. 8 wg + 7 of each of the 8 tile rows); N = NB output
//     channels per block, 64 where Cout >= 64 and the block's weights fit
//     in shared memory, else 32 (Cout 64 and 128 are split over blocks);
//     K = 9 taps x Cin.  Both operands come from shared memory through
//     descriptors: the input halo chunk is kept as four planes of 8
//     channels, [plane][10 x 18 pixels][8], so a tap's A operand, a one-pixel
//     shift of the halo, is a canonical K-major operand (core matrices of 8
//     pixels x 16 bytes, tile rows one halo row apart) at a shifted start
//     address; B, the weights, sits in the canonical layout of 8 output x 8
//     input channels;
//   * persistent blocks each walk a run of consecutive (row, tile) items, a
//     step per (item, 32-channel chunk).  The block's weights for all of
//     Cin are loaded once where they fit beside the ring: at NB = 64 within
//     one SM's shared memory; at NB = 32 within it too in pass 1, and
//     within half of it in pass 2, whose two blocks an SM overlap each
//     other's prologue and products.  Otherwise each ring stage carries its
//     chunk's weights;
//   * the input comes in through a ring of kStages = 3 stages of cp.async
//     with zero fill, which gives the padding and the Cin tail; the next
//     stage's copies are issued while the products run.  Pass 2's prologue
//     runs on the next stage in shared memory while this stage's products
//     run, on in-image pixels only;
//   * the epilogue adds the bias and rounds h to bf16 in registers as soon
//     as an item's products are done; during the next step's products it
//     stages h in shared memory and stores it 16 bytes a thread, and sums
//     the statistics of the rounded values (each thread its two pixels,
//     warp shuffles over the eight pixel groups, then the eight warps in a
//     fixed order).
// cp.async rather than TMA: the prologue needs a per-pixel in-image test
// anyway, and one code path serves the resident and the streamed weights.
// The epilogue kernel uses mma.sync m16n8k16 for its 1x1 res_conv.
//
// Launch contract: the caller passes the current stream; the kernels
// allocate nothing and each function returns cudaGetLastError().  The
// dynamic shared-memory attribute is set before every launch: it belongs to
// the device that is current at the call.

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kThreads = 256;  // eight warps (conv3x3_stats: two warpgroups)
constexpr int kTileH = 8;      // conv3x3_stats' tile: rows
constexpr int kTileW = 16;     // and columns (a warpgroup takes 8 of them)
constexpr int kHaloH = kTileH + 2, kHaloW = kTileW + 2, kHaloPix = kHaloH * kHaloW;
constexpr int kKC = 32;        // input channels per chunk
constexpr int kCS = kKC + 8;   // epilogue: elements per row of a shared chunk (bank spread)
constexpr int kStages = 3;     // conv3x3_stats' input ring
constexpr int kEpiPix = 128;   // pixels per epilogue block: 16 per warp

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }
constexpr int kPlane = kHaloPix * 16;                         // 8 channels of the halo
constexpr int kInBytes = align128(4 * kPlane);                // one halo chunk: 4 planes

// conv3x3_stats' shared memory at NB output channels a block: the weights
// in core matrices of 8 output x 8 input channels, 128 bytes apart along
// the output channels (SBO) and kWLbo along the input channels (LBO)
template <int NB>
struct ConvSmem {
  static constexpr int kWLbo = (NB / 8) * 128;
  static constexpr int kWChunk = 9 * 4 * kWLbo;  // one chunk's weights, 9 taps
  static constexpr int kStaging = align128(kTileH * kTileW * (NB + 8) * 2);
  __host__ __device__ static constexpr int stage(bool res) { return kInBytes + (res ? 0 : kWChunk); }
  // besides resident weights: the ring, the staged h tile, the warps' sums
  __host__ __device__ static constexpr int fixed(bool res) {
    return kStages * stage(res) + kStaging + 8 * 2 * NB * 4;
  }
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// y = x a + b, and silu(y) = y * (1 / (1 + exp(-y))), each operation
// rounded on its own (no fused multiply-add), as the plain PyTorch version
// computes them: a one-ulp difference here can round the bf16 result a step
// apart, and pass 2 feeds that result into the next convolution.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

__device__ __forceinline__ float silu(float y) {
  return __fmul_rn(y, __frcp_rn(__fadd_rn(1.f, expf(-y))));  // __frcp_rn(d) = __fdiv_rn(1, d)
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

// acc[j] += [16 pixels from `a`, row stride kCS] x the chunk's weights `wt`
// [COUT][kCS] (output channel n in row n), over the chunk's 32 channels.
template <int COUT>
__device__ __forceinline__ void mma_chunk(float (*acc)[4], const bf16* a, const bf16* wt) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < kKC; k += 16) {
    uint32_t fa[4];
    const bf16* p = a + g * kCS + k + 2 * t;
    fa[0] = ld32(p);
    fa[1] = ld32(p + 8 * kCS);
    fa[2] = ld32(p + 8);
    fa[3] = ld32(p + 8 * kCS + 8);
#pragma unroll
    for (int j = 0; j < COUT / 8; ++j) {
      const bf16* q = wt + (8 * j + g) * kCS + k + 2 * t;
      mma16816(acc[j], fa, ld32(q), ld32(q + 8));
    }
  }
}

// Rows [0, nrows) of a row-major [*, cin] bf16 matrix, channels [c0, c0 + 32)
// (zero past cin), into dst [nrows][kCS].
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, int nrows, int cin,
                                           int c0, bf16* dst) {
  for (int i = threadIdx.x; i < nrows * 4; i += kThreads) {
    const int r = i >> 2, ch = c0 + (i & 3) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (ch < cin) u = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * cin + ch);
    *reinterpret_cast<uint4*>(dst + r * kCS + (i & 3) * 8) = u;
  }
}

struct ConvArgs {
  const bf16* x;       // [rows, H, W, cin]
  const bf16* w;       // [9, cout, cin]
  const float* bias;   // [cout]
  const float* pa;     // [rows, cin] or null (no prologue)
  const float* pb;
  bf16* h;             // [rows, H, W, cout]
  float* part;         // [rows, ntiles, 2, cout]
  int H, W, cin, cout;
  int tiles_x, tiles_y, ntiles;  // the tile grid: columns, rows, tiles per image
  int items;            // rows * ntiles
  int nchunks;          // ceil(cin / kKC)
};

// Byte offset of weight (tap, chunk channel k, block channel n) in a
// chunk's weights (see ConvSmem).
template <int NB>
__device__ __forceinline__ int w_offset(int tap, int k8, int n) {
  return (tap * 4 + k8) * ConvSmem<NB>::kWLbo + (n >> 3) * 128 + (n & 7) * 16;
}

// An item's finished tile, out of the accumulator: h rounded to bf16 and
// packed in pairs, and this thread's two-pixel sums before the reduction.
template <int NB>
struct Finished {
  uint32_t h[NB / 8][2];  // (pixel a, columns 8 j + 2 t, + 1), then pixel b
  float s[NB / 8][4];     // sum and sum of squares of those columns
  int row, tile, y0, x0;
};

// Accumulator rows 16 w + g, + 8 of warp w in warpgroup wg are the tile
// pixels a = (2 w, 8 wg + g) and b = (2 w + 1, 8 wg + g).
__device__ __forceinline__ void tile_pixels(int& ya, int& xa, int& yb, int& xb) {
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
  ya = 2 * (warp % 4);
  xa = 8 * (warp / 4) + g;
  yb = ya + 1;
  xb = xa;
}

// bias, round to bf16 (zeros outside the image), and the thread's sums: no
// shared memory and no barrier, so it may run before the next products
// are issued, and the accumulator is free for them.
template <int NB>
__device__ __forceinline__ void conv_finish(const ConvArgs& p, const float (&acc)[NB / 2],
                                            const float (&bias)[NB / 4], Finished<NB>& f) {
  int ya, xa, yb, xb;
  tile_pixels(ya, xa, yb, xb);
  const bool in0 = f.y0 + ya < p.H && f.x0 + xa < p.W, in1 = f.y0 + yb < p.H && f.x0 + xb < p.W;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const float v0 = in0 ? bf16_round(acc[4 * j] + bias[2 * j]) : 0.f;
    const float v1 = in0 ? bf16_round(acc[4 * j + 1] + bias[2 * j + 1]) : 0.f;
    const float v2 = in1 ? bf16_round(acc[4 * j + 2] + bias[2 * j]) : 0.f;
    const float v3 = in1 ? bf16_round(acc[4 * j + 3] + bias[2 * j + 1]) : 0.f;
    const __nv_bfloat162 pa = __floats2bfloat162_rn(v0, v1), pb = __floats2bfloat162_rn(v2, v3);
    f.h[j][0] = *reinterpret_cast<const uint32_t*>(&pa);
    f.h[j][1] = *reinterpret_cast<const uint32_t*>(&pb);
    f.s[j][0] = v0 + v2;
    f.s[j][1] = v1 + v3;
    f.s[j][2] = v0 * v0 + v2 * v2;
    f.s[j][3] = v1 * v1 + v3 * v3;
  }
}

// Stage h through shared memory and store it 16 bytes a thread; reduce the
// sums over the tile (warp shuffles over the eight pixel groups, then the
// eight warps in a fixed order) and write the tile's partials.  stg and red
// are free again after the caller's next barrier.
template <int NB>
__device__ __forceinline__ void conv_store(const ConvArgs& p, Finished<NB>& f, bf16* stg,
                                           float* red, int n0) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  int ya, xa, yb, xb;
  tile_pixels(ya, xa, yb, xb);
  bf16* s0 = stg + (ya * kTileW + xa) * (NB + 8);
  bf16* s1 = stg + (yb * kTileW + xb) * (NB + 8);
  float* rw = red + warp * 2 * NB;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(s0 + col) = f.h[j][0];
    *reinterpret_cast<uint32_t*>(s1 + col) = f.h[j][1];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f.s[j][e] += __shfl_xor_sync(0xffffffffu, f.s[j][e], off);
    }
    if (g == 0) {
      rw[col] = f.s[j][0];
      rw[col + 1] = f.s[j][1];
      rw[NB + col] = f.s[j][2];
      rw[NB + col + 1] = f.s[j][3];
    }
  }
  __syncthreads();
  bf16* hrow = p.h + static_cast<long long>(f.row) * p.H * p.W * p.cout + n0;
  for (int i = tid; i < kTileH * kTileW * (NB / 8); i += kThreads) {
    const int px = i / (NB / 8), q8 = i % (NB / 8);
    const int yy = f.y0 + px / kTileW, xx = f.x0 + px % kTileW;
    if (yy < p.H && xx < p.W) {
      *reinterpret_cast<uint4*>(hrow + (static_cast<long long>(yy) * p.W + xx) * p.cout + q8 * 8) =
          *reinterpret_cast<const uint4*>(stg + px * (NB + 8) + q8 * 8);
    }
  }
  float* out = p.part + (static_cast<long long>(f.row) * p.ntiles + f.tile) * 2 * p.cout + n0;
  for (int i = tid; i < 2 * NB; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += red[k * 2 * NB + i];
    out[(i / NB) * p.cout + i % NB] = sum;
  }
}

// Where a block is in its run of (item, chunk) steps: the chunk, the row,
// and the tile's column and row in the tile grid, advanced one step at a
// time (no divisions in the loop).
struct Cursor {
  int c, row, tx, ty;
  __device__ __forceinline__ void start(const ConvArgs& p, int item) {
    c = 0;
    row = item / p.ntiles;
    ty = (item % p.ntiles) / p.tiles_x;
    tx = (item % p.ntiles) % p.tiles_x;
  }
  __device__ __forceinline__ void next(const ConvArgs& p) {
    if (++c < p.nchunks) return;
    c = 0;
    if (++tx < p.tiles_x) return;
    tx = 0;
    if (++ty < p.tiles_y) return;
    ty = 0;
    ++row;
  }
};

// NB output channels a block (the wgmma's N).  PRO: pass 2's prologue.
// RES: the block's weights for all of cin are resident in shared memory,
// else each ring stage carries its chunk's.  Block (bx, n) takes the items
// [bx per, (bx + 1) per) for output channels n NB ..
template <int NB, bool PRO, bool RES>
__global__ void __launch_bounds__(kThreads, NB == 32 ? 2 : 1)
conv3x3_stats_kernel(const ConvArgs p, int per) {
  using SM = ConvSmem<NB>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SB = SM::stage(RES);
  constexpr int kPieces = (kHaloPix * 4 + kThreads - 1) / kThreads;  // a thread's halo pieces
  unsigned char* ring = smem;
  bf16* stg = reinterpret_cast<bf16*>(smem + kStages * SB);  // [128 pixels][NB + 8]
  float* red = reinterpret_cast<float*>(smem + kStages * SB + SM::kStaging);  // [8][2][NB]
  unsigned char* wres = smem + SM::fixed(RES);  // RES: [nchunks][SM::kWChunk]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int n0 = blockIdx.y * NB;
  const int first = blockIdx.x * per;
  const int total = (min(p.items, first + per) - first) * p.nchunks;  // (item, chunk) steps
  if (total <= 0) return;

  // this thread's halo pieces i = tid + 256 k (pixel i / 4, channels
  // 8 (i % 4) ..), the same in every step: halo row and column, offset in
  // the input from the halo's corner, byte offset in a stage
  int pdy[kPieces], pdx[kPieces], pq[kPieces], pgo[kPieces], poff[kPieces];
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const int i = tid + k * kThreads, pix = i >> 2;
    pdy[k] = i < kHaloPix * 4 ? pix / kHaloW : -(1 << 20);  // out of range: never loaded
    pdx[k] = pix % kHaloW;
    pq[k] = (i & 3) * 8;
    pgo[k] = pdy[k] >= 0 ? (pdy[k] * p.W + pdx[k]) * p.cin + pq[k] : 0;
    poff[k] = (i & 3) * kPlane + pix * 16;
  }
  float bias[NB / 4];  // columns 8 j + 2 t, + 1
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    bias[2 * j] = p.bias[n0 + 8 * j + 2 * t];
    bias[2 * j + 1] = p.bias[n0 + 8 * j + 2 * t + 1];
  }

  // chunk `chunk` of the block's weights, all nine taps, zeros past cin
  auto load_weights = [&](int chunk, unsigned char* dst) {
    for (int i = tid; i < 9 * NB * 4; i += kThreads) {
      const int tap = i / (NB * 4), n = (i / 4) % NB, k8 = i % 4;
      const int ch = chunk * kKC + k8 * 8;
      const bool in = ch < p.cin;
      const bf16* src =
          p.w + (static_cast<long long>(tap * p.cout + n0 + n) * p.cin + (in ? ch : 0));
      cp_async16(dst + w_offset<NB>(tap, k8, n), src, in);
    }
  };
  // the input chunk of the step at cursor `at` with its halo (zeros outside
  // the image and past cin) into stage `st`, and without RES its weights
  auto issue = [&](const Cursor& at, unsigned char* st) {
    const int gy0 = at.ty * kTileH - 1, gx0 = at.tx * kTileW - 1, c0 = at.c * kKC;
    const bf16* corner =
        p.x + (static_cast<long long>(at.row * p.H + gy0) * p.W + gx0) * p.cin + c0;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int gy = gy0 + pdy[k], gx = gx0 + pdx[k];
      if (pdy[k] >= 0) {
        const bool in = c0 + pq[k] < p.cin && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
        cp_async16(st + poff[k], in ? corner + pgo[k] : p.x, in);
      }
    }
    if (!RES) load_weights(at.c, st + kInBytes);
  };

  // pass 2's prologue on the step at cursor `at`, in stage `st`: bf16(silu(
  // x a + b)) on this thread's pieces where they lie in the image (the
  // padding stays 0).  A thread only waits for its own copies.
  auto activate = [&](const Cursor& at, unsigned char* st) {
    const int gy0 = at.ty * kTileH - 1, gx0 = at.tx * kTileW - 1, ch = at.c * kKC + pq[0];
    if (ch >= p.cin) return;  // past cin: the zeros stay
    // all of a thread's pieces hold the same 8 channels (tid % 4)
    const long long at_ch = static_cast<long long>(at.row) * p.cin + ch;
    const float4* a4 = reinterpret_cast<const float4*>(p.pa + at_ch);
    const float4* b4 = reinterpret_cast<const float4*>(p.pb + at_ch);
    float a[8], b[8];
    *reinterpret_cast<float4*>(a) = a4[0];
    *reinterpret_cast<float4*>(a + 4) = a4[1];
    *reinterpret_cast<float4*>(b) = b4[0];
    *reinterpret_cast<float4*>(b + 4) = b4[1];
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int gy = gy0 + pdy[k], gx = gx0 + pdx[k];
      if (pdy[k] >= 0 && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
        uint4* q = reinterpret_cast<uint4*>(st + poff[k]);
        uint4 u = *q;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 f = __bfloat1622float2(e[m]);
          e[m] = __floats2bfloat162_rn(silu(affine(f.x, a[2 * m], b[2 * m])),
                                       silu(affine(f.y, a[2 * m + 1], b[2 * m + 1])));
        }
        *q = u;
      }
    }
  };

  if (RES) {
    for (int c = 0; c < p.nchunks; ++c) load_weights(c, wres + c * SM::kWChunk);
  }
  Cursor ahead, cur;  // the next step to load, the step to multiply
  ahead.start(p, first);
  cur = ahead;
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {  // the weights join the first group
    if (s < total) {
      issue(ahead, ring + s * SB);
      ahead.next(p);
    }
    cp_async_commit();
  }
  if (PRO) {
    cp_async_wait<kStages - 2>();
    activate(cur, ring);
  }

  // descriptors at stage 0 / chunk 0: A, warpgroup wg's 64 rows are its
  // 8 x 8 pixels (8 wg .. 8 wg + 7 of each tile row), 8 rows a core matrix
  // 16 bytes apart, tile rows a halo row (288 bytes) apart, the channel
  // planes kPlane apart; B, the weights (see w_offset)
  const uint64_t a_desc0 = smem_desc(ring + 8 * (warp / 4) * 16, kPlane, kHaloW * 16);
  const uint64_t b_desc0 = smem_desc(RES ? wres : ring + kInBytes, SM::kWLbo, 128);
  float acc[NB / 2];  // each item's first product overwrites it
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;

  Finished<NB> done;  // the last finished item, stored during the next step
  bool pending = false;
  int stage = 0;
#pragma unroll 1
  for (int s = 0; s < total; ++s) {
    // this thread's pieces of step s (with the prologue: and of s + 1) have landed
    cp_async_wait<PRO ? kStages - 3 : kStages - 2>();
    fence_proxy_async();  // cp.async and prologue writes are read by wgmma
    __syncthreads();      // step s is visible; every warp is done with step s - 1

    // nine taps x two k16 steps, A the shifted halo, B the weights
    const uint64_t a_desc = a_desc0 + ((stage * SB) >> 4);
    const uint64_t b_desc = b_desc0 + ((RES ? cur.c * SM::kWChunk : stage * SB) >> 4);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        wgmma_ss<0, 0>(
            acc, a_desc + ((2 * ks * kPlane + ((tap / 3) * kHaloW + tap % 3) * 16) >> 4),
            b_desc + (w_offset<NB>(tap, 2 * ks, 0) >> 4),
            tap + ks > 0 || cur.c > 0);  // an item's first product starts the sum
      }
    }
    wgmma_commit();
    if (s + kStages - 1 < total) {  // into step s - 1's stage, while the products run
      issue(ahead, ring + (stage == 0 ? kStages - 1 : stage - 1) * SB);
      ahead.next(p);
    }
    cp_async_commit();
    if (PRO && s + 1 < total) {  // the next step's prologue, while the products run
      Cursor nx = cur;
      nx.next(p);
      activate(nx, ring + (stage == kStages - 1 ? 0 : stage + 1) * SB);
    }
    if (pending) {  // the previous item's stores, while the products run
      conv_store(p, done, stg, red, n0);
      pending = false;
    }
    wgmma_wait<0>();
    reg_fence(acc);
    if (cur.c == p.nchunks - 1) {
      done.row = cur.row;
      done.tile = cur.ty * p.tiles_x + cur.tx;
      done.y0 = cur.ty * kTileH;
      done.x0 = cur.tx * kTileW;
      conv_finish(p, acc, bias, done);
      pending = true;
    }
    cur.next(p);
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }
  __syncthreads();  // the previous stores' reads of stg and red are done
  conv_store(p, done, stg, red, n0);
  cp_async_wait<0>();
}

template <int C, bool RES>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const bf16* __restrict__ h, const bf16* __restrict__ x,
                const float* __restrict__ pa, const float* __restrict__ pb,
                const bf16* __restrict__ wres, const float* __restrict__ bres,
                bf16* __restrict__ out, int hw, int cin) {
  const int row = blockIdx.y, p0 = blockIdx.x * kEpiPix;
  const int npix = min(kEpiPix, hw - p0);
  const float* ar = pa + static_cast<long long>(row) * C;
  const float* br = pb + static_cast<long long>(row) * C;
  const long long base = static_cast<long long>(row) * hw + p0;  // first pixel

  if (!RES) {  // identity: cin == C, eight channels per thread, 16-byte accesses
    const bf16* hb = h + base * C;
    const bf16* xb = x + base * C;
    bf16* ob = out + base * C;
    for (int i = threadIdx.x; i < npix * C / 8; i += kThreads) {
      const int c = (i * 8) % C;
      uint4 hu = *reinterpret_cast<const uint4*>(hb + i * 8);
      const uint4 xu = *reinterpret_cast<const uint4*>(xb + i * 8);
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&hu);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xu);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(hv[j]);
        const float2 r = __bfloat1622float2(xv[j]);
        const float y0 = bf16_round(silu(affine(f.x, ar[c + 2 * j], br[c + 2 * j])));
        const float y1 = bf16_round(silu(affine(f.y, ar[c + 2 * j + 1], br[c + 2 * j + 1])));
        hv[j] = __floats2bfloat162_rn(y0 + r.x, y1 + r.y);
      }
      *reinterpret_cast<uint4*>(ob + i * 8) = hu;
    }
    return;
  }

  // res_conv: [128 pixels, Cin] x [Cin, C] on the tensor cores, by chunks of
  // 32 input channels; warp w takes pixels 16 w ..
  __shared__ __align__(16) bf16 xs[kEpiPix * kCS];
  __shared__ __align__(16) bf16 ws[C * kCS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  float acc[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bf16* xb = x + base * cin;
  for (int c0 = 0; c0 < cin; c0 += kKC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kEpiPix * 4; i += kThreads) {
      const int r = i >> 2, ch = c0 + (i & 3) * 8;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (ch < cin && r < npix)
        u = *reinterpret_cast<const uint4*>(xb + static_cast<long long>(r) * cin + ch);
      *reinterpret_cast<uint4*>(xs + r * kCS + (i & 3) * 8) = u;
    }
    stage_rows(wres, C, cin, c0, ws);
    __syncthreads();
    mma_chunk<C>(acc, xs + 16 * warp * kCS, ws);
  }
  const int q0 = 16 * warp + g;  // this thread's two pixels: q0, q0 + 8
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + 8 * half;
      if (q >= npix) continue;
      const long long idx = (base + q) * C + col;
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + idx));
      const float y0 = bf16_round(silu(affine(f.x, ar[col], br[col])));
      const float y1 = bf16_round(silu(affine(f.y, ar[col + 1], br[col + 1])));
      const float r0 = bf16_round(acc[j][2 * half] + bres[col]);
      const float r1 = bf16_round(acc[j][2 * half + 1] + bres[col + 1]);
      st_pair(out + idx, y0 + r0, y1 + r1);
    }
  }
}

template <int NB, bool PRO, bool RES>
int launch_conv(const ConvArgs& a, int smem, int sms, cudaStream_t st) {
  auto kern = conv3x3_stats_kernel<NB, PRO, RES>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = a.cout / NB;
  // persistent: one wave of blocks, each a run of `per` consecutive items
  const int blocks = std::min(a.items, std::max(1, sms * std::max(per_sm, 1) / groups));
  const int per = (a.items + blocks - 1) / blocks;
  kern<<<dim3((a.items + per - 1) / per, groups), kThreads, smem, st>>>(a, per);
  return static_cast<int>(cudaGetLastError());
}

// Weights resident where they fit beside the ring, else streamed with the
// input; `budget` is the shared memory a block may take.
template <int NB, bool PRO>
int pick_plan(const ConvArgs& a, int budget, int sms, cudaStream_t st) {
  const int res = ConvSmem<NB>::fixed(true) + a.nchunks * ConvSmem<NB>::kWChunk;
  if (res <= budget) return launch_conv<NB, PRO, true>(a, res, sms, st);
  return launch_conv<NB, PRO, false>(a, ConvSmem<NB>::fixed(false), sms, st);
}

// Cout >= 64: 64 channels a block, the weights resident at one block an SM
// (fewer, larger products); where they do not fit, and at Cout 32, 32
// channels a block.  Pass 1 then keeps the weights resident up to one block
// an SM; pass 2 keeps two blocks an SM, whose prologues overlap each
// other's products, and streams the weights beyond that.
template <bool PRO>
int pick_conv(const ConvArgs& a, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int res64 = ConvSmem<64>::fixed(true) + a.nchunks * ConvSmem<64>::kWChunk;
  if (a.cout >= 64 && res64 <= per_sm - reserved) {
    return launch_conv<64, PRO, true>(a, res64, sms, st);
  }
  return pick_plan<32, PRO>(a, per_sm / (PRO ? 2 : 1) - reserved, sms, st);
}

template <int C>
int launch_epilogue(const bf16* h, const bf16* x, const float* a, const float* b,
                    const bf16* wres, const float* bres, bf16* out, int rows, int hw,
                    int cin, cudaStream_t st) {
  const dim3 grid((hw + kEpiPix - 1) / kEpiPix, rows);
  if (wres != nullptr)
    epilogue_kernel<C, true><<<grid, kThreads, 0, st>>>(h, x, a, b, wres, bres, out, hw, cin);
  else
    epilogue_kernel<C, false><<<grid, kThreads, 0, st>>>(h, x, a, b, wres, bres, out, hw, cin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, H, W, cin] bf16; w [9, cout, cin] bf16 (tap ky * 3 + kx, then the
// output channel, cin contiguous); bias [cout] float; a, b [rows, cin] float
// (both given: pass 2 with the prologue) or both null.  Writes h [rows, H,
// W, cout] bf16 and part [rows, tiles, 2, cout] float (sum, then sum of
// squares), tiles = ceil(H / 8) * ceil(W / 16) in row-major order.  cout in
// {32, 64, 128}, cin a multiple of 8, x and w 16-byte aligned.
extern "C" int conv3x3_stats(const void* x, const void* w, const void* bias, const void* a,
                             const void* b, void* h, void* part, int rows, int H, int W,
                             int cin, int cout, void* stream) {
  if (cin <= 0 || cin % 8 != 0 || (a == nullptr) != (b == nullptr) ||
      (cout != 32 && cout != 64 && cout != 128) || rows < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs args;
  args.x = static_cast<const bf16*>(x);
  args.w = static_cast<const bf16*>(w);
  args.bias = static_cast<const float*>(bias);
  args.pa = static_cast<const float*>(a);
  args.pb = static_cast<const float*>(b);
  args.h = static_cast<bf16*>(h);
  args.part = static_cast<float*>(part);
  args.H = H;
  args.W = W;
  args.cin = cin;
  args.cout = cout;
  args.tiles_x = (W + kTileW - 1) / kTileW;
  args.tiles_y = (H + kTileH - 1) / kTileH;
  args.ntiles = args.tiles_x * args.tiles_y;
  args.items = rows * args.ntiles;
  args.nchunks = (cin + kKC - 1) / kKC;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a != nullptr ? pick_conv<true>(args, st) : pick_conv<false>(args, st);
}

// h [rows, hw, c] bf16, x [rows, hw, cin] bf16, a, b [rows, c] float;
// wres [c, cin] bf16 and bres [c] float for the 1x1 res_conv, or both null
// for the identity (cin == c).  Writes out [rows, hw, c] bf16.  c in
// {32, 64, 128}, cin a multiple of 8.
extern "C" int epilogue(const void* h, const void* x, const void* a, const void* b,
                        const void* wres, const void* bres, void* out, int rows, int hw,
                        int cin, int c, void* stream) {
  if (cin <= 0 || cin % 8 != 0 || (wres == nullptr) != (bres == nullptr) ||
      (wres == nullptr && cin != c))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* hp = static_cast<const bf16*>(h);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  const bf16* wp = static_cast<const bf16*>(wres);
  const float* rp = static_cast<const float*>(bres);
  bf16* op = static_cast<bf16*>(out);
  switch (c) {
    case 32: return launch_epilogue<32>(hp, xp, ap, bp, wp, rp, op, rows, hw, cin, st);
    case 64: return launch_epilogue<64>(hp, xp, ap, bp, wp, rp, op, rows, hw, cin, st);
    case 128: return launch_epilogue<128>(hp, xp, ap, bp, wp, rp, op, rows, hw, cin, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
