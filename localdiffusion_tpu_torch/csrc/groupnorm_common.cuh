// What both GroupNorm sources share (groupnorm_film_silu.cu, the single
// pass, and groupnorm_tiled.cu, the stats/apply pair): 16-byte chunks of a
// pixel's channels (Vec, unpack, pack), a reciprocal without a slow path
// for the SiLU, and the launch of a kernel as thread-block clusters of k
// blocks.
// Header only.

#pragma once

#include "hopper.cuh"

namespace gn {

using bf16 = __nv_bfloat16;

// values of T in 16 bytes
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<bf16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// 1/z rounded to nearest, as __frcp_rn(z), for z in [1, 2^126): the
// approximation and one Newton step on the FMA.  Equal to __frcp_rn bit for
// bit on every float of that range (tests/test_torch_kernels_cuda.py checks
// all of them on the card); above it 1/z is subnormal, where it is not.
// __frcp_rn itself branches to a slow path for every value, which keeps the
// compiler from interleaving the values of a chunk.
__device__ __forceinline__ float rcp_rn_fast(float z) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return __fmaf_rn(r, __fmaf_rn(-z, r, 1.f), r);
}

constexpr int kMaxCluster = 16;  // non-portable above 8

// Launch kern(args) as `blocks` blocks of `threads`, in clusters of k
// consecutive blocks (1 .. kMaxCluster), with `smem` bytes of dynamic
// shared memory.  The attributes are set before every launch: they belong
// to the device that is current at the call.  A lone block is a cluster of
// one without the attribute, and launches sooner.  Returns the launch's
// error.
template <typename Args>
int launch_clusters(void (*kern)(Args), const Args& args, int blocks, int threads, int k,
                    int smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && k > 8)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = k > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gn
