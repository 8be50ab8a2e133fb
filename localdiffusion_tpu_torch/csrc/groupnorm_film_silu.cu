// Fused GroupNorm + FiLM + SiLU for Hopper (sm_90a).
//
// Replaces the TPU kernel localdiffusion_tpu/ops/pallas_groupnorm.py::_gn_kernel:
//   y = GroupNorm(x; groups, eps) * gamma + beta
//   y = y * (scale + 1) + shift          (FiLM, optional, per batch row)
//   out = y * sigmoid(y)                 (SiLU)
// on NHWC activations, x of type float or bfloat16, everything else float.
//
// Bound: device memory.  The op reads x once and writes out once (2 bytes of
// traffic per element byte) and does ~15 flops per element, far below the
// H100's ~20 flops/byte ridge for fp32 CUDA cores.  Design:
//   * one thread block per (batch row, group): no cross-block reduction, so a
//     single launch with no atomics and no scratch memory;
//   * stats pass: each thread accumulates a shifted sum and sum of squares
//     (shift = the group's first element, which removes most of the
//     cancellation of E[x^2] - E[x]^2) in float32; a two-level tree (warp
//     shuffles, then one shared-memory round across warps) combines them;
//   * apply pass: the block reads its group again -- mostly from L2, since a
//     group of the flagship's tensors is at most ~100 KB -- and writes.
// The group's elements are strided by C in NHWC: element i of a group is
// pixel i / cg, channel g * cg + i % cg.  Neighbouring threads therefore read
// neighbouring channels of one pixel, then the next pixel.
//
// Launch contract: the caller passes the current stream; the kernel
// allocates nothing and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_film_silu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ scale,
                    const float* __restrict__ shift, T* __restrict__ out,
                    int hw, int c, int groups, float eps) {
  const int row = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const int cg = c / groups;
  const long n = static_cast<long>(hw) * cg;
  const long row_base = static_cast<long>(row) * hw * c;
  const int c0 = g * cg;
  const T* xr = x + row_base;
  T* outr = out + row_base;

  const float k = to_float(xr[c0]);  // shift for the moments
  float s = 0.f, ss = 0.f;
  for (long i = threadIdx.x; i < n; i += kThreads) {
    const long p = i / cg;
    const int ch = c0 + static_cast<int>(i - p * cg);
    const float d = to_float(xr[p * c + ch]) - k;
    s += d;
    ss += d * d;
  }

  // level 1: within each warp
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  // level 2: across the block's warps
  __shared__ float sh_s[kThreads / 32];
  __shared__ float sh_ss[kThreads / 32];
  __shared__ float sh_mean, sh_rstd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh_s[warp] = s;
    sh_ss[warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tss = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      ts += sh_s[w];
      tss += sh_ss[w];
    }
    const float inv_n = 1.f / static_cast<float>(n);
    const float dm = ts * inv_n;
    const float var = fmaxf(tss * inv_n - dm * dm, 0.f);
    sh_mean = k + dm;
    sh_rstd = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = sh_mean, rstd = sh_rstd;

  const float* sc = scale ? scale + static_cast<long>(row) * c : nullptr;
  const float* sh = shift ? shift + static_cast<long>(row) * c : nullptr;
  for (long i = threadIdx.x; i < n; i += kThreads) {
    const long p = i / cg;
    const int ch = c0 + static_cast<int>(i - p * cg);
    const long idx = p * c + ch;
    float y = (to_float(xr[idx]) - mean) * rstd * gamma[ch] + beta[ch];
    if (sc) y = y * (sc[ch] + 1.f) + sh[ch];
    store(outr + idx, y / (1.f + expf(-y)));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (for x and out).  scale and shift are
// both null (no FiLM) or both [rows, c] float32.
extern "C" int gn_film_silu(const void* x, const void* gamma, const void* beta,
                            const void* scale, const void* shift, void* out,
                            int rows, int hw, int c, int groups, float eps,
                            int dtype, void* stream) {
  const dim3 grid(rows * groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* sc = static_cast<const float*>(scale);
  const float* sf = static_cast<const float*>(shift);
  if (dtype == 0) {
    gn_film_silu_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), gm, bt, sc, sf, static_cast<float*>(out),
        hw, c, groups, eps);
  } else if (dtype == 1) {
    gn_film_silu_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), gm, bt, sc, sf,
        static_cast<__nv_bfloat16*>(out), hw, c, groups, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
