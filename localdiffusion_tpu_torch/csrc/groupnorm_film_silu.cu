// Fused GroupNorm + FiLM + SiLU for Hopper (sm_90a), single pass.
//
// Replaces the TPU kernel localdiffusion_tpu/ops/pallas_groupnorm.py::_gn_kernel:
//   y = GroupNorm(x; groups, eps) * gamma + beta
//   y = y * (scale + 1) + shift          (FiLM, optional, per batch row)
//   out = y * sigmoid(y)                 (SiLU)
// on NHWC activations, x of type float or bfloat16, everything else float.
// The statistics are the plain version's: the mean, then the mean of the
// centred squares (two passes over the row), in float32.
//
// Bound: device memory.  The op reads x once and writes out once and does
// ~15 flops an element, far below the card's ridge; at the sizes the main
// paths give it (2 to 13 MB of x a launch) it is bound as much by latency:
// a launch must put enough bytes in flight at once, and every round trip
// between the statistics and the output costs the whole card.  The TPU
// kernel keeps one row in VMEM; here one row is held in the shared memory
// of a thread-block cluster:
//   * one cluster of k blocks per batch row, each block a slice of
//     ceil(h*w / k) pixels [slice, C], contiguous in NHWC.  k, the slice and
//     whether the slice is resident come from h, w, C, the groups and the
//     dtype alone (the wrapper's `gn_plan`), never from the batch: they fix
//     the order of every sum, so a row's result does not depend on the rows
//     beside it.  Rows of 128 KiB and more (8 a launch at the 256px and
//     stem sites) take k = 8, past 512 KiB 16; the flagship's smaller rows
//     (128 a launch) 1 or 2: on the card more or larger clusters cost more
//     than they spread, and k = 1 launches without a cluster;
//   * the block copies its slice into shared memory once, 16 bytes a
//     thread with cp.async, neighbouring threads on neighbouring bytes.
//     Thread t owns the 16-byte chunks t, t + A, ... of the slice (A, the
//     active threads, a multiple of the chunks per pixel), so it always
//     holds the same channels: their gamma, beta, scale and shift sit in
//     its registers, and it reads only what it copied itself (no barrier
//     before the first pass);
//   * per-channel float32 sums per thread, then per group over the block's
//     threads (a warp per group, lanes in a fixed order, a shuffle tree),
//     then over the cluster's blocks through distributed shared memory (a
//     lane per block, the same tree): the mean; the same three levels over
//     (x - mean)^2, from shared memory again: the variance.  Three cluster
//     barriers, the last split so that the output pass overlaps it;
//   * the output pass normalises, applies gamma/beta, FiLM and SiLU, and
//     writes 16 bytes a thread.
// A slice over `gn_plan`'s resident limit (only rows far past the JAX row
// gate, which the dispatcher sends to the tiled pair) is not kept: the
// same kernel streams it from device memory for each of the three passes.
//
// Launch contract: the caller passes the current stream and the plan (k,
// pixels a block, resident, shared memory); the kernel allocates nothing
// and the function returns the launch's error.  The dynamic shared-memory
// and cluster-size attributes are set before every launch: they belong to
// the device that is current at the call.

#include "groupnorm_common.cuh"

namespace {

using namespace gn;
using namespace hopper;

constexpr int kThreads = 256;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

struct GnArgs {
  const void* x;       // [rows, hw, c]
  const float* gamma;  // [c]
  const float* beta;
  const float* scale;  // [rows, c] or null (no FiLM)
  const float* shift;
  void* out;           // [rows, hw, c], x's type
  int hw, c, groups;
  int k;               // blocks a row (the cluster)
  int pixels;          // pixels a block (the last block's slice may be shorter)
  float eps;
};

// Shared memory besides the resident slice: the threads' per-channel sums
// [nrep][c] (nrep = kThreads / cpp), the block's group partials [2][groups]
// (sums, then centred squares; read by the cluster), the group statistics
// [2][groups] (mean, 1/std).  Mirrored by ops/groupnorm.py::gn_smem.
__host__ __device__ constexpr int gn_work_bytes(int c, int groups, int cpp) {
  return 4 * ((kThreads / cpp) * c + 4 * groups);
}

// The block's partial of each group (per-thread channel sums s of this
// thread's V channels, ch0 ..) into part[g]: the threads' sums go to
// red[j][c] (j = tid / cpp), then warp w folds the groups w, w + 8, ...: lane
// l sums the terms l, l + 32, ... of the group, in that order, and a shuffle
// tree adds the lanes.  The result is the same for every launch and grid.
template <int V>
__device__ __forceinline__ void group_partials(const float (&s)[V], float* red, float* part,
                                               const GnArgs& p, int cpp, int nrep, bool owner,
                                               int ch0) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (owner) {
    float* r = red + (tid / cpp) * p.c + ch0;
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = s[v];
  }
  __syncthreads();
  const int cg = p.c / p.groups, terms = nrep * cg;
  for (int g = warp; g < p.groups; g += kThreads / 32) {
    float acc = 0.f;
    for (int t = lane; t < terms; t += 32) {
      const int j = t / cg;
      acc += red[j * p.c + g * cg + (t - j * cg)];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) part[g] = acc;
  }
}

// The row's total of each group: lane r reads block r's partial through
// distributed shared memory (0 past the cluster), and the same shuffle tree
// adds them; f(total) goes to stat[g].  Call after a cluster barrier.
template <typename F>
__device__ __forceinline__ void cluster_fold(const float* part, float* stat, const GnArgs& p,
                                             F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < p.groups; g += kThreads / 32) {
    float v = lane < p.k ? __uint_as_float(ld_shared_cluster(part + g, lane)) : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) stat[g] = f(v);
  }
}

// One cluster of k blocks per row (blockIdx.x / k), block rank r taking the
// pixels [r * pixels, (r + 1) * pixels) of it.  RES: the slice is resident
// in shared memory, else it is read from device memory in each pass.
template <typename E, bool RES>
__global__ void __launch_bounds__(kThreads)
gn_film_silu_kernel(const GnArgs p) {
  constexpr int V = Vec<E>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int cpp = p.c / V;                // 16-byte chunks a pixel
  const int active = kThreads / cpp * cpp;
  const int nrep = active / cpp;          // threads holding the same channels
  const bool owner = tid < active;
  const int ch0 = (tid % cpp) * V;        // this thread's channels ch0 .. ch0 + V - 1
  const int rank = static_cast<int>(cluster_ctarank());
  const int row = blockIdx.x / p.k;
  const int p0 = rank * p.pixels;
  const int nchunks = max(0, min(p.pixels, p.hw - p0)) * cpp;
  const long long base = (static_cast<long long>(row) * p.hw + p0) * cpp;  // in chunks
  const uint4* xg = reinterpret_cast<const uint4*>(p.x) + base;
  uint4* og = reinterpret_cast<uint4*>(p.out) + base;
  uint4* slice = reinterpret_cast<uint4*>(smem);
  float* red = reinterpret_cast<float*>(smem + (RES ? align128(p.pixels * cpp * 16) : 0));
  float* part = red + nrep * p.c;
  float* stat = part + 2 * p.groups;

  if (RES && owner) {
    for (int i = tid; i < nchunks; i += active) cp_async16(slice + i, xg + i, true);
  }
  cp_async_commit();
  // this thread's channels' parameters, while the copies land
  const bool film = p.scale != nullptr;
  float gm[V], bt[V], sc[V], sh[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    gm[v] = p.gamma[ch0 + v];
    bt[v] = p.beta[ch0 + v];
    sc[v] = film ? p.scale[static_cast<long long>(row) * p.c + ch0 + v] + 1.f : 1.f;
    sh[v] = film ? p.shift[static_cast<long long>(row) * p.c + ch0 + v] : 0.f;
  }
  cp_async_wait<0>();  // a thread reads only the chunks it copied
  auto chunk = [&](int i) -> uint4 { return RES ? slice[i] : __ldg(xg + i); };

  // pass 1: the mean
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  if (owner) {
    for (int i = tid; i < nchunks; i += active) {
      float f[V];
      unpack(chunk(i), f);
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] += f[v];
    }
  }
  group_partials(s, red, part, p, cpp, nrep, owner, ch0);
  const float n = static_cast<float>(p.hw) * static_cast<float>(p.c / p.groups);
  cluster_sync();
  cluster_fold(part, stat, p, [&](float total) { return total / n; });
  __syncthreads();
  const int cg = p.c / p.groups;
  float mean[V];
#pragma unroll
  for (int v = 0; v < V; ++v) mean[v] = stat[(ch0 + v) / cg];

  // pass 2: the variance, from the centred values
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  if (owner) {
    for (int i = tid; i < nchunks; i += active) {
      float f[V];
      unpack(chunk(i), f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = f[v] - mean[v];
        s[v] += d * d;
      }
    }
  }
  group_partials(s, red, part + p.groups, p, cpp, nrep, owner, ch0);
  cluster_sync();
  cluster_fold(part + p.groups, stat + p.groups, p,
               [&](float total) { return rsqrtf(total / n + p.eps); });
  cluster_arrive();  // done with the cluster's partials
  __syncthreads();
  float rstd[V];
#pragma unroll
  for (int v = 0; v < V; ++v) rstd[v] = stat[p.groups + (ch0 + v) / cg];

  // pass 3: normalise, gamma/beta, FiLM, SiLU; 16 bytes a thread
  if (owner) {
    for (int i = tid; i < nchunks; i += active) {
      float f[V];
      unpack(chunk(i), f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float y = (f[v] - mean[v]) * rstd[v] * gm[v] + bt[v];
        if (film) y = y * sc[v] + sh[v];
        f[v] = y / (1.f + expf(-y));
      }
      og[i] = pack(f);
    }
  }
  cluster_wait();  // no block leaves while another may still read its partials
}

template <typename E, bool RES>
int launch(const GnArgs& a, int rows, int smem, cudaStream_t st) {
  return launch_clusters(gn_film_silu_kernel<E, RES>, a, rows * a.k, kThreads, a.k, smem, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (for x and out).  scale and shift are
// both null (no FiLM) or both [rows, c] float32.  The plan: k blocks a row
// (1 .. 16), `pixels` pixels a block (k * pixels >= hw), resident or
// streamed slices, and `smem` the dynamic shared memory a block takes,
// which must be what this layout needs.  c * sizeof(x) a multiple of 16,
// at most 4096 bytes; x and out 16-byte aligned.
extern "C" int gn_film_silu(const void* x, const void* gamma, const void* beta,
                            const void* scale, const void* shift, void* out, int rows, int hw,
                            int c, int groups, float eps, int dtype, int k, int pixels,
                            int resident, int smem, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const int cpp = c * esize / 16;
  if ((dtype != 0 && dtype != 1) || rows < 1 || hw < 1 || groups < 1 || c % groups != 0 ||
      (c * esize) % 16 != 0 || cpp < 1 || cpp > kThreads || k < 1 || k > kMaxCluster ||
      pixels < 1 || static_cast<long long>(k) * pixels < hw ||
      (scale == nullptr) != (shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int want =
      (resident ? align128(pixels * cpp * 16) : 0) + gn_work_bytes(c, groups, cpp);
  if (smem != want) return static_cast<int>(cudaErrorInvalidValue);
  GnArgs a;
  a.x = x;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.out = out;
  a.hw = hw;
  a.c = c;
  a.groups = groups;
  a.k = k;
  a.pixels = pixels;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return resident ? launch<float, true>(a, rows, smem, st)
                    : launch<float, false>(a, rows, smem, st);
  return resident ? launch<bf16, true>(a, rows, smem, st) : launch<bf16, false>(a, rows, smem, st);
}
