// Tiled GroupNorm + FiLM + SiLU for large spatial blocks, Hopper (sm_90a).
//
// Replaces the TPU pair localdiffusion_tpu/ops/pallas_groupnorm.py::_stats_kernel
// + _apply_kernel (reached through _gn_tiled_impl), with the group fold that
// XLA computes between them moved into the apply pass:
//   stats:  per row, the per-channel sum and sum of squares of x, summed
//           in float64 and rounded once to float32       -> sums [B, 2, C]
//   apply:  each group's mean and 1/std from the row's sums, in float64,
//           then y = (x - mean) * rstd * gamma + beta,
//           y = y * (scale + 1) + shift (FiLM, optional), out = y * sigmoid(y)
// on NHWC activations [B, HW, C], x and out float or bfloat16, the rest float.
//
// Bound: device memory, and at the main paths' sizes (4 to 16 MiB of x a
// launch, 8 rows) as much by latency: the op reads x twice and writes out
// once at ~25 instructions an element, below the card's ridge, so a launch
// is as fast as the bytes it keeps in flight and the round trips on its
// critical path.  Design:
//   * stats: the TPU kernel accumulates a row's sums across a sequential
//     grid into one [2, C] block.  Here one thread-block cluster of k blocks
//     takes a row (k and the pixels a block from the wrapper's
//     `gn_tiled_plan`, from h, w, C and the dtype alone, never the batch),
//     each block a contiguous slice of it.  A thread always holds the same
//     16-byte chunk of a pixel's channels (thread t the chunks t, t + A, ...
//     of the slice, A a multiple of the chunks a pixel) and keeps 2 x 8
//     chunks in flight (two register buffers, one loading while the other
//     is summed).  It sums x and x^2 in float64 (a float's square is
//     exact there), and these sums go to shared memory; the threads
//     holding the same channels are added in a fixed order, and each of
//     the block's 2C partials is stored into the shared memory of the block
//     that folds that value (block r the r-th k-th of the 2C), through
//     distributed shared memory.  One cluster barrier later each block adds
//     its values' k partials in rank order, in float64, from its own shared
//     memory, and rounds the row's sums once to float32.  So a row's sums
//     are folded once, on chip, in an order the batch does not change, with
//     one cluster barrier on the critical path (the one that says every
//     block has started is passed while the loads land) and no remote load.
//     Why float64 from the first add: a row's float64 sums are within
//     ~1e-12 of the exact ones, so rounded once they are the exact sums
//     rounded to float32 in any order, and the same as the plain version's.
//     Float32 sums in another order differ from it by an ulp in about one
//     sum in four, which moves the mean by an ulp and an output near 0 by
//     more than one of its own bf16 steps.  The cost is one conversion (16
//     a clock an SM) and two float64 operations an element;
//   * apply: a grid of (tiles of `gn_tiled_plan`'s apply pixels, rows).  A
//     block issues its first loads of x, then folds its row's 2 x C sums to
//     the group statistics in float64 (a warp a group, lanes over the
//     group's channels in a fixed order, a shuffle tree: mean = S / n,
//     var = max(SS / n - mean^2, 0), rstd = 1 / sqrt(var + eps)) while they
//     land, and streams its tile 16 bytes a thread, the next chunks loading
//     while the current ones are computed, with its channels' mean, rstd,
//     gamma, beta, scale + 1 and shift in registers;
//   * the pair: the dispatcher launches the apply pass as a programmatic
//     dependent of the stats pass (`after_stats`), which lets it go as soon
//     as every stats block has started: its blocks load their first chunks
//     of x and their parameters while the stats pass runs, and wait for its
//     sums (griddepcontrol.wait) only before the fold.
// Rounding: x is widened to float, every product and sum of the apply is
// rounded separately (__fmul_rn / __fadd_rn: no contraction into an FMA),
// the SiLU is y * (1 / (1 + e^-y)) with the reciprocal rounded to nearest
// (rcp_rn_fast, __frcp_rn's value), as the plain PyTorch version computes
// it, and the output is rounded once.
//
// Launch contract: the caller passes the current stream; the kernels allocate
// nothing and each function returns the launch's error.  The stats pass's
// cluster attributes are set before every launch, for the current device.

#include "groupnorm_common.cuh"

namespace {

using namespace gn;
using namespace hopper;

constexpr int kThreads = 256;
constexpr int kMaxGroups = 64;
constexpr int kStatsLoads = 8;  // 16-byte loads a thread, per buffer
constexpr int kApplyLoads = 4;

struct StatsArgs {
  const void* x;  // [rows, hw, c]
  float* sums;    // [rows, 2, c]
  int hw, c;
  int k;          // blocks a row (the cluster)
  int pixels;     // pixels a block (the last blocks' slices may be shorter or empty)
};

struct ApplyArgs {
  const void* x;       // [rows, hw, c]
  const float* sums;   // [rows, 2, c]
  const float* gamma;  // [c]
  const float* beta;
  const float* scale;  // [rows, c] or null (no FiLM)
  const float* shift;
  void* out;           // [rows, hw, c], x's type
  int hw, c, groups;
  int pixels;          // pixels a block (the last tile of a row may be shorter)
  float eps;
};

// The thread's chunks i0, i0 + step, ... (N of them) into buf; zeros past n.
template <int N>
__device__ __forceinline__ void load_chunks(uint4 (&buf)[N], const uint4* src, int i0, int step,
                                            int n) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int i = i0 + u * step;
    buf[u] = i < n ? __ldg(src + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int V, int N>
__device__ __forceinline__ void add_chunks(const uint4 (&buf)[N], double (&s)[V],
                                           double (&ss)[V]) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float f[V];
    unpack(buf[u], f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const double d = static_cast<double>(f[v]);
      s[v] += d;
      ss[v] = __fma_rn(d, d, ss[v]);
    }
  }
}

// f = f * (1 / (1 + e^-f)), the reciprocal rounded to nearest: rcp_rn_fast
// for a chunk whose 1 + e^-f are all below 2^126 (f above ~ -87.3), else
// __frcp_rn, so that the common case has no branch an element.
template <int V>
__device__ __forceinline__ void silu(float (&f)[V]) {
  float z[V];
  bool slow = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    z[v] = __fadd_rn(1.f, expf(-f[v]));
    slow |= !(z[v] < 0x1p126f);
  }
  if (!slow) {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = __fmul_rn(f[v], rcp_rn_fast(z[v]));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = __fmul_rn(f[v], __frcp_rn(z[v]));
  }
}

// Dynamic shared memory of a stats block: the threads' sums [nrep][2][c]
// and the cluster's partials of the block's values [k][per], in float64.
int stats_smem(int c, int esize, int k) {
  const int nrep = kThreads / (c * esize / 16);
  const int per = (2 * c + k - 1) / k;
  return (nrep * 2 * c + k * per) * static_cast<int>(sizeof(double));
}

// One cluster of k blocks a row (blockIdx.x / k); block rank r sums the
// pixels [r * pixels, (r + 1) * pixels) of it and folds the values
// [r * per, (r + 1) * per) of the row's 2c, per = ceil(2c / k).
template <typename E>
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(const StatsArgs p) {
  constexpr int V = Vec<E>::n;
  extern __shared__ __align__(16) double smem[];
  griddep_launch_dependents();
  cluster_arrive_relaxed();  // this block has started
  const int tid = threadIdx.x;
  const int cpp = p.c / V;  // 16-byte chunks a pixel
  const int active = kThreads / cpp * cpp;
  const int nrep = active / cpp;  // threads holding the same channels
  const int per = (2 * p.c + p.k - 1) / p.k;
  double* red = smem;                  // [nrep][2][c]
  double* recv = smem + nrep * 2 * p.c;  // [k][per]
  const int ch0 = (tid % cpp) * V;
  const int rank = static_cast<int>(cluster_ctarank());
  const int row = blockIdx.x / p.k;
  const int p0 = rank * p.pixels;
  const int nchunks = max(0, min(p.pixels, p.hw - p0)) * cpp;
  const uint4* xg = reinterpret_cast<const uint4*>(p.x) +
                    (static_cast<long long>(row) * p.hw + p0) * cpp;

  double s[V], ss[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = ss[v] = 0.0;
  if (tid < active) {
    constexpr int kN = kStatsLoads;
    const int step = kN * active;
    uint4 a[kN], b[kN];
    load_chunks(a, xg, tid, active, nchunks);
    for (int i0 = tid; i0 < nchunks; i0 += 2 * step) {
      load_chunks(b, xg, i0 + step, active, nchunks);
      add_chunks(a, s, ss);
      if (i0 + step >= nchunks) break;
      load_chunks(a, xg, i0 + 2 * step, active, nchunks);
      add_chunks(b, s, ss);
    }
    double* r = red + (tid / cpp) * 2 * p.c + ch0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      r[v] = s[v];
      r[p.c + v] = ss[v];
    }
  }
  __syncthreads();
  // the block's partial of each of the 2c values (its threads in order), to
  // the shared memory of the block that folds it
  cluster_wait();  // every block of the cluster has started
  for (int o = tid; o < 2 * p.c; o += kThreads) {
    double acc = red[o];
    for (int j = 1; j < nrep; ++j) acc += red[j * 2 * p.c + o];
    const int owner = o / per;
    st_shared_cluster(recv + rank * per + (o - owner * per), owner, acc);
  }
  cluster_sync();  // every partial is in its folder's shared memory
  // this block's values of the row: the k partials in rank order, float64,
  // rounded once
  float* out = p.sums + static_cast<long long>(row) * 2 * p.c + rank * per;
  const int mine = min(per, 2 * p.c - rank * per);
  for (int j = tid; j < mine; j += kThreads) {
    double acc = 0.0;
    for (int r = 0; r < p.k; ++r) acc += recv[r * per + j];
    out[j] = static_cast<float>(acc);
  }
}

// grid (tiles, rows): block (j, row) normalises pixels [j * pixels, ...) of row.
template <typename E>
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(const ApplyArgs p) {
  constexpr int V = Vec<E>::n;
  constexpr int kN = kApplyLoads;
  __shared__ float stat[2 * kMaxGroups];  // mean, then 1/std, of each group
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cpp = p.c / V;
  const int active = kThreads / cpp * cpp;
  const bool owner = tid < active;
  const int ch0 = (tid % cpp) * V;
  const int row = blockIdx.y;
  const int p0 = blockIdx.x * p.pixels;
  const int nchunks = owner ? min(p.pixels, p.hw - p0) * cpp : 0;
  const long long base = (static_cast<long long>(row) * p.hw + p0) * cpp;  // in chunks
  const uint4* xg = reinterpret_cast<const uint4*>(p.x) + base;
  uint4* og = reinterpret_cast<uint4*>(p.out) + base;

  // the first chunks of x and the parameters load while the stats pass
  // ends and the statistics are folded
  uint4 buf[kN];
  load_chunks(buf, xg, tid, active, nchunks);
  const bool film = p.scale != nullptr;
  float gm[V], bt[V], sc[V], sh[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    gm[v] = p.gamma[ch0 + v];
    bt[v] = p.beta[ch0 + v];
    sc[v] = film ? __fadd_rn(p.scale[static_cast<long long>(row) * p.c + ch0 + v], 1.f) : 1.f;
    sh[v] = film ? p.shift[static_cast<long long>(row) * p.c + ch0 + v] : 0.f;
  }
  griddep_wait();  // the stats pass's sums are complete and visible
  const float* sr = p.sums + static_cast<long long>(row) * 2 * p.c;
  const int cg = p.c / p.groups;
  for (int g = warp; g < p.groups; g += kThreads / 32) {
    double s = 0.0, ss = 0.0;
    for (int t = lane; t < cg; t += 32) {
      s += static_cast<double>(sr[g * cg + t]);
      ss += static_cast<double>(sr[p.c + g * cg + t]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane == 0) {
      const double n = static_cast<double>(p.hw) * cg;
      const double mean = s / n;
      const double var = fmax(ss / n - mean * mean, 0.0);
      stat[g] = static_cast<float>(mean);
      stat[p.groups + g] = static_cast<float>(1.0 / sqrt(var + static_cast<double>(p.eps)));
    }
  }
  __syncthreads();
  float mean[V], rstd[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mean[v] = stat[(ch0 + v) / cg];
    rstd[v] = stat[p.groups + (ch0 + v) / cg];
  }

  for (int i0 = tid; i0 < nchunks; i0 += kN * active) {
    uint4 next[kN];
    load_chunks(next, xg, i0 + kN * active, active, nchunks);
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      const int i = i0 + u * active;
      if (i >= nchunks) break;
      float f[V];
      unpack(buf[u], f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float normed = __fmul_rn(__fsub_rn(f[v], mean[v]), rstd[v]);
        f[v] = __fadd_rn(__fmul_rn(normed, gm[v]), bt[v]);
        if (film) f[v] = __fadd_rn(__fmul_rn(f[v], sc[v]), sh[v]);
      }
      silu(f);
      og[i] = pack(f);
    }
#pragma unroll
    for (int u = 0; u < kN; ++u) buf[u] = next[u];
  }
}

bool chunks_ok(int c, int dtype) {
  const int esize = dtype == 0 ? 4 : 2;
  return (dtype == 0 || dtype == 1) && c > 0 && (c * esize) % 16 == 0 &&
         c * esize / 16 <= kThreads;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x).  sums: [rows, 2, c] float32.  The
// plan: k blocks a row (1 .. 16, a cluster), `pixels` pixels a block
// (k * pixels >= hw).  c * sizeof(x) a multiple of 16, at most 4096
// bytes; x 16-byte aligned.
extern "C" int gn_tiled_stats(const void* x, void* sums, int rows, int hw, int c, int k,
                              int pixels, int dtype, void* stream) {
  if (!chunks_ok(c, dtype) || rows < 1 || hw < 1 || k < 1 || k > kMaxCluster || pixels < 1 ||
      static_cast<long long>(k) * pixels < hw)
    return static_cast<int>(cudaErrorInvalidValue);
  StatsArgs a;
  a.x = x;
  a.sums = static_cast<float*>(sums);
  a.hw = hw;
  a.c = c;
  a.k = k;
  a.pixels = pixels;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = stats_smem(c, dtype == 0 ? 4 : 2, k);
  if (dtype == 0)
    return launch_clusters(gn_stats_kernel<float>, a, rows * k, kThreads, k, smem, st);
  return launch_clusters(gn_stats_kernel<bf16>, a, rows * k, kThreads, k, smem, st);
}

// sums from gn_tiled_stats on the same x; scale and shift both null (no
// FiLM) or both [rows, c] float32; groups <= 64 and divides c; `pixels`
// pixels a block, a grid of ceil(hw / pixels) x rows blocks.  after_stats:
// the launch right after gn_tiled_stats on the same stream, made its
// programmatic dependent (x, gamma, beta, scale and shift must then not be
// written by that launch; the sums are read after it completes).
extern "C" int gn_tiled_apply(const void* x, const void* sums, const void* gamma,
                              const void* beta, const void* scale, const void* shift,
                              void* out, int rows, int hw, int c, int groups, int pixels,
                              float eps, int dtype, int after_stats, void* stream) {
  if (!chunks_ok(c, dtype) || rows < 1 || rows > 65535 || hw < 1 || pixels < 1 ||
      groups < 1 || groups > kMaxGroups || c % groups || (scale == nullptr) != (shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ApplyArgs a;
  a.x = x;
  a.sums = static_cast<const float*>(sums);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.out = out;
  a.hw = hw;
  a.c = c;
  a.groups = groups;
  a.pixels = pixels;
  a.eps = eps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((hw + pixels - 1) / pixels, rows);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after_stats ? 1 : 0;
  const cudaError_t e = dtype == 0 ? cudaLaunchKernelEx(&cfg, gn_apply_kernel<float>, a)
                                   : cudaLaunchKernelEx(&cfg, gn_apply_kernel<bf16>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
