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
//
// The epilogue is bound by device memory at every 256px site: it reads h
// and x and writes out once (the 1x1 res_conv, at most 192 -> 128 channels,
// does ~1.5 flops a byte), and its exact SiLU costs ~25 instructions an
// output.  What limits it is how many bytes each SM keeps in flight while
// its warps do that arithmetic.  A ring of cp.async stages through shared
// memory (block-wide with a barrier an item, or per thread) was built and
// measured slower on the card than loads straight into registers, so both
// kernels load into registers, 16 bytes a thread, and overlap one warp's
// loads with another's arithmetic:
//   * the res_conv kernel (epilogue_res_kernel, below) runs the product on
//     wgmma with A from registers: it permutes K and N so that the wgmma
//     fragments of x and of the accumulator are contiguous quarters of a
//     pixel's channels, which each thread loads and stores 16 bytes at a
//     time; the weights sit in shared memory in that permuted order, once
//     per block of a persistent grid;
//   * the identity kernel is a grid-stride walk over 16-byte pieces, at
//     most two a thread;
//   * the output is rounded as the plain version rounds it, with
//     bf16_round(acc + bres), bf16_round(silu(affine(h, a, b))) and their
//     bf16 sum.
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
constexpr int kStages = 3;     // conv3x3_stats' input ring

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

// The epilogue with the 1x1 res_conv.  Items of 64 pixels of one row (the
// last of a row ragged), one warpgroup's M.  A block's two warpgroups take
// two items, or at C = 128 the two halves of one item's output channels
// (SPLIT = 2: half the accumulator and of h a thread, so two blocks fit an
// SM); the blocks of the persistent grid walk the items b, b + G, ..., so
// that neighbouring blocks read neighbouring pixels at once.  Per item:
//   * x, h: 16-byte loads into registers, issued together.  Thread (g, t)
//     of warp w takes the item's pixels 16 w + g and 16 w + g + 8, and of
//     each a contiguous quarter of the channels: x channels [t KP / 4,
//     (t + 1) KP / 4) (KP = cin rounded up to 32, zeros past cin), h and out
//     channels [t NW / 4, (t + 1) NW / 4) of its warpgroup's NW = C / SPLIT;
//   * the product on wgmma, m64 nNW k16, A from those registers, B the
//     weights in shared memory (resident for the block).  The contraction
//     runs over a permuted K and writes a permuted N, so that the m16n8k16
//     fragments of A and of the accumulator are exactly the thread's
//     contiguous quarters: K index 16 s + 8 u + 2 t + e is x channel
//     t KP / 4 + 4 s + 2 u + e, accumulator column 8 j + 2 t + e is output
//     channel t NW / 4 + 2 j + e of the half.  The weights are laid out that
//     way once per block, in the canonical K-major B layout (core matrices
//     of 8 columns x 8 K indices, 128 bytes apart along N, kWLbo along K),
//     one B per half;
//   * the thread's outputs, bf16(bf16(silu(h a + b)) + bf16(acc + bres)),
//     go out 16 bytes at a time.
// No shared memory holds x, h or out, so no barrier orders the items; the
// SM overlaps one warpgroup's loads with another's arithmetic.
struct EpiArgs {
  const bf16* h;       // [rows, hw, C]
  const bf16* x;       // [rows, hw, cin]
  const float* pa;     // [rows, C]
  const float* pb;
  const bf16* wres;    // [C, cin] or null (identity)
  const float* bres;   // [C] or null
  bf16* out;           // [rows, hw, C]
  int rows, hw, cin;
  int tiles;           // res_conv items a row: ceil(hw / 64)
  int items;           // rows * tiles
};

constexpr int kEpiRows = 64;  // pixels of a res_conv item

// blocks an SM the res_conv kernel is built for (its registers allow them)
// at NW output channels a warpgroup and NK = KP / 32; mirrored by
// ops/resnet_block.py::epilogue_res_blocks
__host__ __device__ constexpr int epi_res_blocks(int nw, int nk) {
  return nw == 32 && nk <= 2 ? 3 : (nk <= 6 ? 2 : 1);
}

// bf16(bf16(silu(h a + b)) + r) for two channels packed in a word
__device__ __forceinline__ uint32_t epi_pair(uint32_t hw2, float a0, float a1, float b0, float b1,
                                             float r0, float r1) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hw2));
  const float y0 = bf16_round(silu(affine(f.x, a0, b0)));
  const float y1 = bf16_round(silu(affine(f.y, a1, b1)));
  const __nv_bfloat162 o = __floats2bfloat162_rn(y0 + r0, y1 + r1);
  return *reinterpret_cast<const uint32_t*>(&o);
}

// NK = KP / 32: 16-byte pieces of x a thread loads for each of its pixels.
template <int C, int NK, int SPLIT>
__global__ void __launch_bounds__(kThreads, epi_res_blocks(C / SPLIT, NK))
epilogue_res_kernel(const EpiArgs p) {
  constexpr int KP = 32 * NK, NW = C / SPLIT;
  constexpr int QX = KP / 4, QC = NW / 4;  // channels of x, of h and out, a thread holds
  constexpr int NH = QC / 8;               // 16-byte pieces of h a pixel
  constexpr int kWLbo = (NW / 8) * 128, kHalf = KP * NW * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int wg = warp / 4;

  // the weights, permuted (see above), from 16-byte pieces W[o][ci .. ci + 7]:
  // x channel ci + 2 q is K index 16 s + 8 u + 2 t'' with ci + 2 q = t'' QX +
  // 4 s + 2 u; output channel o = hf NW + t' QC + 2 j + e is column
  // 8 j + 2 t' + e of half hf
  for (int i = tid; i < C * (KP / 8); i += kThreads) {
    const int o = i / (KP / 8), ci = (i % (KP / 8)) * 8;
    const bf16* src = p.wres + static_cast<long long>(o) * p.cin + ci;
    const uint4 v =
        ci < p.cin ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
    const int hf = o / NW, oo = o % NW;
    const int n = 8 * ((oo % QC) / 2) + 2 * (oo / QC) + (oo & 1);
    unsigned char* col = smem + hf * kHalf + (n >> 3) * 128 + (n & 7) * 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rem = ci % QX + 2 * q;
      const int k = 16 * (rem / 4) + 8 * ((rem / 2) & 1) + 2 * (ci / QX);
      *reinterpret_cast<uint32_t*>(col + (k >> 3) * kWLbo + (k & 7) * 2) = w4[q];
    }
  }
  fence_proxy_async();
  __syncthreads();
  const int hf = SPLIT == 2 ? wg : 0;
  const uint64_t b_desc = smem_desc(smem + hf * kHalf, kWLbo, 128);
  const int c0 = hf * NW + t * QC;  // this thread's first output channel

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  const int per_block = SPLIT == 2 ? 1 : 2;  // items a block takes at a time
  const int G = gridDim.x * per_block;
  const int q0 = 16 * (warp % 4) + g;  // this thread's pixels in an item: q0, q0 + 8
#pragma unroll 1
  for (int it = blockIdx.x * per_block + (SPLIT == 2 ? 0 : wg); it < p.items; it += G) {
    const int row = it / p.tiles, p0 = (it - row * p.tiles) * kEpiRows;
    const int npix = min(kEpiRows, p.hw - p0);
    const long long pix = static_cast<long long>(row) * p.hw + p0 + q0;
    const bool in0 = q0 < npix, in1 = q0 + 8 < npix;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4 xa[NK], xb[NK], ha[NH], hb[NH];
#pragma unroll
    for (int m = 0; m < NK; ++m) {
      const int ci = t * QX + 8 * m;
      const bool ok = ci < p.cin;
      const bf16* src = p.x + pix * p.cin + ci;
      xa[m] = in0 && ok ? __ldg(reinterpret_cast<const uint4*>(src)) : zero;
      xb[m] = in1 && ok ? __ldg(reinterpret_cast<const uint4*>(src + 8 * p.cin)) : zero;
    }
#pragma unroll
    for (int m = 0; m < NH; ++m) {
      ha[m] = in0 ? __ldg(reinterpret_cast<const uint4*>(p.h + pix * C + c0 + 8 * m)) : zero;
      hb[m] = in1 ? __ldg(reinterpret_cast<const uint4*>(p.h + (pix + 8) * C + c0 + 8 * m)) : zero;
    }
    const uint32_t* wa = reinterpret_cast<const uint32_t*>(xa);
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(xb);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KP / 16; ++s) {
      const uint32_t frag[4] = {wa[2 * s], wb[2 * s], wa[2 * s + 1], wb[2 * s + 1]};
      wgmma_rs<0>(acc, frag, b_desc + ((2 * s * kWLbo) >> 4), s > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    const uint32_t* hwa = reinterpret_cast<const uint32_t*>(ha);
    const uint32_t* hwb = reinterpret_cast<const uint32_t*>(hb);
    uint4 oa[NH], ob[NH];
    uint32_t* owa = reinterpret_cast<uint32_t*>(oa);
    uint32_t* owb = reinterpret_cast<uint32_t*>(ob);
    const float* ar = p.pa + static_cast<long long>(row) * C + c0;
    const float* br = p.pb + static_cast<long long>(row) * C + c0;
#pragma unroll
    for (int q = 0; q < QC; q += 4) {  // channels c0 + q .. c0 + q + 3: words q / 2, q / 2 + 1
      const float4 av = __ldg(reinterpret_cast<const float4*>(ar + q));
      const float4 bv = __ldg(reinterpret_cast<const float4*>(br + q));
      const float4 rv = __ldg(reinterpret_cast<const float4*>(p.bres + c0 + q));
      const int j = q / 2;
      owa[j] = epi_pair(hwa[j], av.x, av.y, bv.x, bv.y, bf16_round(acc[4 * j] + rv.x),
                        bf16_round(acc[4 * j + 1] + rv.y));
      owb[j] = epi_pair(hwb[j], av.x, av.y, bv.x, bv.y, bf16_round(acc[4 * j + 2] + rv.x),
                        bf16_round(acc[4 * j + 3] + rv.y));
      owa[j + 1] = epi_pair(hwa[j + 1], av.z, av.w, bv.z, bv.w,
                            bf16_round(acc[4 * j + 4] + rv.z), bf16_round(acc[4 * j + 5] + rv.w));
      owb[j + 1] = epi_pair(hwb[j + 1], av.z, av.w, bv.z, bv.w,
                            bf16_round(acc[4 * j + 6] + rv.z), bf16_round(acc[4 * j + 7] + rv.w));
    }
#pragma unroll
    for (int m = 0; m < NH; ++m) {
      if (in0) *reinterpret_cast<uint4*>(p.out + pix * C + c0 + 8 * m) = oa[m];
      if (in1) *reinterpret_cast<uint4*>(p.out + (pix + 8) * C + c0 + 8 * m) = ob[m];
    }
  }
}

// The identity epilogue: a grid-stride walk over the 16-byte pieces of the
// [rows, hw, C] tensors, eight channels each, with a and b from the L1
// cache (they are [rows, C]).
template <int C>
__global__ void __launch_bounds__(kThreads, 5)
epilogue_identity_kernel(const EpiArgs p) {
  const int n = p.rows * p.hw * (C / 8), per_row = p.hw * (C / 8);
  const uint4* h4 = reinterpret_cast<const uint4*>(p.h);
  const uint4* x4 = reinterpret_cast<const uint4*>(p.x);
#pragma unroll 1
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const uint4 hu = __ldg(h4 + i), xu = __ldg(x4 + i);
    const int c = (i % (C / 8)) * 8;
    const float4* a4 = reinterpret_cast<const float4*>(p.pa + (i / per_row) * C + c);
    const float4* b4 = reinterpret_cast<const float4*>(p.pb + (i / per_row) * C + c);
    const float4 a0 = __ldg(a4), a1 = __ldg(a4 + 1), b0 = __ldg(b4), b1 = __ldg(b4 + 1);
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xu);
    const uint32_t* hv = reinterpret_cast<const uint32_t*>(&hu);
    const float2 r0 = __bfloat1622float2(xv[0]), r1 = __bfloat1622float2(xv[1]);
    const float2 r2 = __bfloat1622float2(xv[2]), r3 = __bfloat1622float2(xv[3]);
    uint4 o;
    o.x = epi_pair(hv[0], a0.x, a0.y, b0.x, b0.y, r0.x, r0.y);
    o.y = epi_pair(hv[1], a0.z, a0.w, b0.z, b0.w, r1.x, r1.y);
    o.z = epi_pair(hv[2], a1.x, a1.y, b1.x, b1.y, r2.x, r2.y);
    o.w = epi_pair(hv[3], a1.z, a1.w, b1.z, b1.w, r3.x, r3.y);
    reinterpret_cast<uint4*>(p.out)[i] = o;
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

template <int C, int NK>
int launch_epilogue_res(const EpiArgs& a, int blocks, cudaStream_t st) {
  constexpr int SPLIT = C == 128 ? 2 : 1;
  auto kern = epilogue_res_kernel<C, NK, SPLIT>;
  const int smem = 32 * NK * C * 2;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int pick_epilogue(const EpiArgs& a, int blocks, cudaStream_t st) {
  if (a.wres == nullptr) {
    epilogue_identity_kernel<C><<<blocks, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  switch ((a.cin + 31) / 32) {
    case 1: return launch_epilogue_res<C, 1>(a, blocks, st);
    case 2: return launch_epilogue_res<C, 2>(a, blocks, st);
    case 3: return launch_epilogue_res<C, 3>(a, blocks, st);
    case 4: return launch_epilogue_res<C, 4>(a, blocks, st);
    case 5: return launch_epilogue_res<C, 5>(a, blocks, st);
    case 6: return launch_epilogue_res<C, 6>(a, blocks, st);
    case 7: return launch_epilogue_res<C, 7>(a, blocks, st);
    case 8: return launch_epilogue_res<C, 8>(a, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// {32, 64, 128}; cin a multiple of 8, at most 256 with the res_conv; every
// pointer 16-byte aligned.  `blocks`: the persistent grid (the wrapper's
// `epilogue_plan`).
extern "C" int epilogue(const void* h, const void* x, const void* a, const void* b,
                        const void* wres, const void* bres, void* out, int rows, int hw,
                        int cin, int c, int blocks, void* stream) {
  if (cin <= 0 || cin % 8 != 0 || (wres == nullptr) != (bres == nullptr) ||
      (wres == nullptr && cin != c) || (wres != nullptr && cin > 256) || rows < 1 || hw < 1 ||
      blocks < 1 ||
      static_cast<long long>(rows) * hw * c / 8 >= (1LL << 31) - 1LL * blocks * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  EpiArgs args;
  args.h = static_cast<const bf16*>(h);
  args.x = static_cast<const bf16*>(x);
  args.pa = static_cast<const float*>(a);
  args.pb = static_cast<const float*>(b);
  args.wres = static_cast<const bf16*>(wres);
  args.bres = static_cast<const float*>(bres);
  args.out = static_cast<bf16*>(out);
  args.rows = rows;
  args.hw = hw;
  args.cin = cin;
  args.tiles = (hw + kEpiRows - 1) / kEpiRows;
  args.items = rows * args.tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 32: return pick_epilogue<32>(args, blocks, st);
    case 64: return pick_epilogue<64>(args, blocks, st);
    case 128: return pick_epilogue<128>(args, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
