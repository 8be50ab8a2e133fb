// A bare copy of a row-tiled tensor for Hopper (sm_90a): the per-launch and
// per-program floor of the linear-attention attribution.
//
// Replaces the TPU kernel scripts/bench_linatt_attrib.py::_copy_kernel, the
// trivial pallas_call `o_ref[0] = x_ref[0]` over [B, N, C] in row tiles of
// T tokens (grid (B, N / T)), which the JAX script times at T = 2048, 16384
// and 256 (64, 8 and 512 programs over [8, 16384, 128] bf16, 33.5 MB) to
// tell the cost of a pallas_call and of each of its programs from the
// work.  Here a program is a block: block p copies bytes [p S, (p + 1) S)
// of the flat tensor, S = total / programs, so the programs and the bytes
// per program are the JAX grid's.
//
// Bound: the bytes, read once and written once (67 MB, 20 us at 3.35 TB/s),
// where the programs can fill the card.  With 8 programs the launch is
// bound by what 8 SMs can stream; with 512 the card is full.  The design:
// 512 threads a block, each moving four 16-byte pieces a step with all
// four loads in flight before the stores (streaming loads and stores:
// nothing is read again).
//
// Launch contract: the caller passes the current stream and the output
// (allocating nothing here); both pointers are 16-byte aligned and the
// bytes of a program are a multiple of 16.  Returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long per_program) {
  const long long base = static_cast<long long>(blockIdx.x) * per_program;
  const uint4* src = x + base;
  uint4* dst = out + base;
  constexpr long long kStep = static_cast<long long>(kThreads) * kUnroll;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < per_program; i += kStep) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(src + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) __stcs(dst + i + u * kThreads, v[u]);
  }
  for (; i < per_program; i += kThreads) __stcs(dst + i, __ldcs(src + i));
}

}  // namespace

// x, out: `nbytes` bytes each; `programs` blocks, each copying nbytes /
// programs contiguous bytes (a multiple of 16).
extern "C" int copy_probe(const void* x, void* out, long long nbytes, int programs,
                          void* stream) {
  if (programs < 1 || nbytes % programs || (nbytes / programs) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  copy_kernel<<<programs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), nbytes / programs / 16);
  return static_cast<int>(cudaGetLastError());
}
