// Tiled GroupNorm + FiLM + SiLU for large spatial blocks, Hopper (sm_90a).
//
// Replaces the TPU pair localdiffusion_tpu/ops/pallas_groupnorm.py::_stats_kernel
// + _apply_kernel (reached through _gn_tiled_impl), with the group fold that
// the JAX package computes between them moved into the apply pass:
//   stats:  per (row, tile of P pixels), the per-channel sum and sum of
//           squares of x in float32                        -> partials [B, nt, 2, C]
//   apply:  the row's partials folded to each group's mean and 1/std in
//           float64, then y = (x - mean) * rstd * gamma + beta,
//           y = y * (scale + 1) + shift (FiLM, optional), out = y * sigmoid(y)
// on NHWC activations [B, HW, C], x and out float or bfloat16, the rest float.
//
// Bound: device memory.  The op reads x twice and writes out once, at ~15
// flops per element, far below the H100's ~20 flops/byte ridge for fp32 CUDA
// cores.  Design:
//   * the TPU kernel accumulates a row's sums across a sequential grid; blocks
//     here run in no order, so each (row, tile) block writes its own tile's
//     partials, with no atomics and no scratch beyond the partials;
//   * the tile (P pixels, all C channels) comes from H*W and C alone, never
//     from the batch, so a row's result does not depend on the rows beside it,
//     and P*C is ~8192 elements, so a [8, 32x32, 256] input still gives 256
//     blocks (a block per row would give 8);
//   * each apply block re-reads its row's nt x 2 x C partials (from L2: they
//     are 8/P of x) and folds them in float64 in a fixed order: over tiles per
//     channel, then over the group's channels, var = E[x^2] - mean^2 clamped
//     at 0, then 1/sqrt(var + eps).  So the op is two launches and no host
//     work between them;
//   * thread (r, c) of a block owns channel c (and c + 256k when C > 256) and
//     pixels r, r + R, ...: neighbouring threads read neighbouring channels of
//     one pixel, and each thread keeps its channel's constants in registers.
// Rounding: x is widened to float, every product and sum of the apply is
// rounded separately (__fmul_rn / __fadd_rn: no contraction into an FMA),
// as the plain PyTorch version computes it, and the output is rounded once.
//
// Launch contract: the caller passes the current stream; the kernels allocate
// nothing and each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 64;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Threads per channel row of the block: R rows of min(C, kThreads) channels.
__device__ __forceinline__ int lanes_c(int c) { return c < kThreads ? c : kThreads; }

// grid (nt, B): block (j, b) sums pixels [j*P, min((j+1)*P, hw)) of row b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials, int hw, int c,
                int tile) {
  const int j = blockIdx.x, nt = gridDim.x, b = blockIdx.y;
  const int lc = lanes_c(c), rows = kThreads / lc;
  const int r = threadIdx.x / lc, cl = threadIdx.x % lc;
  const int p0 = j * tile, p1 = min(p0 + tile, hw);
  const T* xr = x + static_cast<long>(b) * hw * c;
  float* out = partials + (static_cast<long>(b) * nt + j) * 2 * c;
  __shared__ float sh_s[kThreads], sh_ss[kThreads];

  for (int c0 = 0; c0 < c; c0 += lc) {
    const int ch = c0 + cl;
    float s = 0.f, ss = 0.f;
    if (r < rows && ch < c) {
#pragma unroll 4
      for (int p = p0 + r; p < p1; p += rows) {
        const float v = to_float(xr[static_cast<long>(p) * c + ch]);
        s += v;
        ss += v * v;
      }
    }
    sh_s[threadIdx.x] = s;
    sh_ss[threadIdx.x] = ss;
    __syncthreads();
    if (threadIdx.x < lc && ch < c) {  // r == 0: add the rows in order
      for (int k = 1; k < rows; ++k) {
        s += sh_s[k * lc + cl];
        ss += sh_ss[k * lc + cl];
      }
      out[ch] = s;
      out[c + ch] = ss;
    }
    __syncthreads();
  }
}

// grid (nt, B): block (j, b) folds row b's partials, then normalises tile j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partials,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ scale, const float* __restrict__ shift,
                T* __restrict__ out, int hw, int c, int groups, int tile, float eps) {
  const int j = blockIdx.x, nt = gridDim.x, b = blockIdx.y;
  const int lc = lanes_c(c), rows = kThreads / lc;
  const int r = threadIdx.x / lc, cl = threadIdx.x % lc;
  const int cg = c / groups;
  const float* pr = partials + static_cast<long>(b) * nt * 2 * c;
  __shared__ double sh_s[kThreads], sh_ss[kThreads];
  __shared__ double sh_gs[kMaxGroups], sh_gss[kMaxGroups];
  __shared__ float sh_mean[kMaxGroups], sh_rstd[kMaxGroups];

  // fold 1: per channel, over tiles (thread row r takes tiles r, r + R, ...),
  // then over the group's channels, all in float64 and in a fixed order
  for (int g = threadIdx.x; g < groups; g += kThreads) sh_gs[g] = sh_gss[g] = 0.0;
  __syncthreads();
  for (int c0 = 0; c0 < c; c0 += lc) {
    const int ch = c0 + cl;
    double s = 0.0, ss = 0.0;
    if (r < rows && ch < c) {
      for (int t = r; t < nt; t += rows) {
        s += static_cast<double>(pr[static_cast<long>(t) * 2 * c + ch]);
        ss += static_cast<double>(pr[static_cast<long>(t) * 2 * c + c + ch]);
      }
    }
    sh_s[threadIdx.x] = s;
    sh_ss[threadIdx.x] = ss;
    __syncthreads();
    if (threadIdx.x < lc && ch < c) {
      for (int k = 1; k < rows; ++k) {
        s += sh_s[k * lc + cl];
        ss += sh_ss[k * lc + cl];
      }
      sh_s[cl] = s;
      sh_ss[cl] = ss;
    }
    __syncthreads();
    // fold 2: thread g adds this chunk's channels of group g, in channel order
    for (int g = threadIdx.x; g < groups; g += kThreads) {
      const int lo = max(g * cg, c0), hi = min((g + 1) * cg, min(c0 + lc, c));
      for (int k = lo; k < hi; ++k) {
        sh_gs[g] += sh_s[k - c0];
        sh_gss[g] += sh_ss[k - c0];
      }
    }
    __syncthreads();
  }
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const double n = static_cast<double>(hw) * cg;
    const double mean = sh_gs[g] / n;
    const double var = fmax(sh_gss[g] / n - mean * mean, 0.0);
    sh_mean[g] = static_cast<float>(mean);
    sh_rstd[g] = static_cast<float>(1.0 / sqrt(var + static_cast<double>(eps)));
  }
  __syncthreads();

  const int p0 = j * tile, p1 = min(p0 + tile, hw);
  const long row_base = static_cast<long>(b) * hw * c;
  const T* xr = x + row_base;
  T* outr = out + row_base;
  if (r >= rows) return;
  for (int c0 = 0; c0 < c; c0 += lc) {
    const int ch = c0 + cl;
    if (ch >= c) break;
    const float mean = sh_mean[ch / cg], rstd = sh_rstd[ch / cg];
    const float gm = gamma[ch], bt = beta[ch];
    const bool film = scale != nullptr;
    const float sc = film ? __fadd_rn(scale[static_cast<long>(b) * c + ch], 1.f) : 1.f;
    const float sf = film ? shift[static_cast<long>(b) * c + ch] : 0.f;
#pragma unroll 4
    for (int p = p0 + r; p < p1; p += rows) {
      const long idx = static_cast<long>(p) * c + ch;
      const float normed = __fmul_rn(__fsub_rn(to_float(xr[idx]), mean), rstd);
      float y = __fadd_rn(__fmul_rn(normed, gm), bt);
      if (film) y = __fadd_rn(__fmul_rn(y, sc), sf);
      store(outr + idx, __fmul_rn(y, __frcp_rn(__fadd_rn(1.f, expf(-y)))));
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x).  partials: [rows, nt, 2, c] float32,
// nt = ceil(hw / tile).
extern "C" int gn_tiled_stats(const void* x, void* partials, int rows, int hw, int c,
                              int tile, int dtype, void* stream) {
  if (rows <= 0 || hw <= 0 || c <= 0 || tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((hw + tile - 1) / tile, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partials);
  if (dtype == 0) {
    gn_stats_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), pt, hw,
                                                      c, tile);
  } else if (dtype == 1) {
    gn_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), pt, hw, c, tile);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// scale and shift are both null (no FiLM) or both [rows, c] float32;
// groups <= 64 and divides c.
extern "C" int gn_tiled_apply(const void* x, const void* partials, const void* gamma,
                              const void* beta, const void* scale, const void* shift,
                              void* out, int rows, int hw, int c, int groups, int tile,
                              float eps, int dtype, void* stream) {
  if (rows <= 0 || hw <= 0 || c <= 0 || tile <= 0 || groups <= 0 || groups > kMaxGroups ||
      c % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((hw + tile - 1) / tile, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pt = static_cast<const float*>(partials);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* sc = static_cast<const float*>(scale);
  const float* sf = static_cast<const float*>(shift);
  if (dtype == 0) {
    gn_apply_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), pt, gm, bt, sc, sf, static_cast<float*>(out), hw, c,
        groups, tile, eps);
  } else if (dtype == 1) {
    gn_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), pt, gm, bt, sc, sf,
        static_cast<__nv_bfloat16*>(out), hw, c, groups, tile, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
