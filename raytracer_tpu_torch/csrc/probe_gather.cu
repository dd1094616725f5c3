// Per-lane texel gather probe for Hopper (sm_90a).
//
// Replaces the TPU probe scripts/probe_vmem_gather.py (`run`, pallas_call
// :92), which found that a Pallas kernel cannot fetch table[idx] per lane
// at all, so the textured path was split into record + replay.  The plain
// PyTorch version is in probes/gather.py.
//
// Each ray fetches 6 texels, table[(idx + b * 977) mod T] for b = 0..5, and
// sums them as floats in the order b = 0..5 (the script's kernel_take); the
// baseline sums the indices without fetching (kernel_baseline).  "mod" is
// the floored remainder (jnp.remainder, torch.remainder: 0 <= j < T) of
// the int32 sum, which wraps past 2^31 - 1 as the script's and the plain
// version's int32 adds do.  Three kernels:
// - ldg (kernel_take): the table from device memory through the read-only
//   path; no shared memory, so the SM's L1 is as large as it gets (carveout
//   0) and holds more of the 420 KB table of the script (T = 327 * 321);
// - smem (kernel_take): the table in shared memory, cut to what one block's
//   opt-in dynamic shared memory holds beside its barrier (T is then that
//   cut).  Blocks run in clusters of GATHER_CLUSTER on neighbouring SMs:
//   each block's first thread issues TMA bulk copies of its share of the
//   table, multicast to every block of the cluster, and every block waits
//   on its mbarrier for the whole table, so one L2 read fills the cluster;
// - base (kernel_baseline): the same index arithmetic without the fetch.
//
// All three walk the rays four a thread (one int4 index load, one float4
// store, the ragged tail masked), grid-stride over a grid that
// probe_gather_init plans from the card's resident blocks.  A ray takes
// one remainder: floored_mod below, a multiply-high by the launch's
// reciprocal of T (Granlund and Montgomery's round-up method, exact for
// every 32-bit dividend).  Each later index is the last plus 977 mod T and
// one conditional subtract, which needs no wrap of idx + 5 * 977; the rays
// within 4,885 of 2^31 - 1 take one remainder a fetch instead (rare; no
// test on the host).  Then the 24 fetches of a thread's four rays issue
// back to back.
//
// What bounds them (PERF.md; probes/gather.py `work`): the least
// work is ~12 FP32 slots a fetch at P1's costs (an add, a compare, a
// select, an int -> float convert, a float add and the load; a remainder
// a ray) against 8 bytes a ray of index in and sum out, so the bound is
// the bytes.  base runs near it.  ldg is held by the L1 / L2 request rate
// of its random 4-byte reads, which the bound does not count (the table is
// larger than an SM's L1); smem by the copy of the table into every SM
// before its first fetch, where the TMA's fill was measured slower than
// the block's own 16-byte loads (PERF.md; ROADMAP.md names the load fill as
// its replacement).  Every entry returns cudaGetLastError()
// after its launch.

#include <climits>
#include <cuda_runtime.h>

// Dynamic shared memory and the kernel launch; the CPU stand-in of the
// CUDA runtime (csrc/emu/cuda_runtime.h) defines CUDA_EMU and both macros
// its own way.
#ifndef CUDA_EMU
#define EXTERN_SHARED extern __shared__
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace {

// blocks in a thread-block cluster of the smem kernel: on an H100 80GB HBM3
// at 700 W, 2 fill its 132 SMs and took 11.6 us at the script's shape, 4
// filled 120 (the occupancy query's 30 clusters) and took 12.7 us (PERF.md)
constexpr int GATHER_CLUSTER = 2;

constexpr int FETCHES = 6;
constexpr int STRIDE = 977;
constexpr int RAYS = 4;                      // rays a thread
constexpr int GATHER_BLOCK = 256;            // ldg, base
constexpr int SMEM_BLOCK = 1024;             // smem: one block an SM
constexpr int BARRIER_BYTES = 16;            // smem: the mbarrier, before the table
constexpr int CHUNK_QUADS = 2048;            // smem: 16-byte units a bulk copy (32 KB)
constexpr int WAIT_TRIES = 1 << 24;          // smem: mbarrier waits before a trap
constexpr int NO_WRAP = INT_MAX - (FETCHES - 1) * STRIDE;

// The modulus of a launch: T and what floored_mod and the index steps need.
struct Mod {
  unsigned t;       // the modulus, 1 <= T <= 2^31 - 1
  unsigned magic;   // Granlund-Montgomery multiplier of T
  unsigned sh1;     // min(l, 1), l = ceil(log2 T)
  unsigned sh2;     // max(l - 1, 0)
  unsigned off;     // 2^31 mod T
  unsigned step;    // 977 mod T
};

Mod make_mod(int t) {
  const unsigned long long d = (unsigned)t;
  unsigned l = 0;
  while ((1ull << l) < d) ++l;
  Mod m;
  m.t = (unsigned)d;
  m.magic = (unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  m.sh1 = l < 1 ? l : 1;
  m.sh2 = l > 0 ? l - 1 : 0;
  m.off = (unsigned)((1ull << 31) % d);
  m.step = (unsigned)(STRIDE % d);
  return m;
}

// x mod T, floored (0 <= result < T), for every int32 x: u = x + 2^31 as an
// unsigned, u mod T by the multiply-high, less 2^31 mod T.
__device__ __forceinline__ unsigned floored_mod(int x, const Mod& m) {
  const unsigned u = (unsigned)x ^ 0x80000000u;
  const unsigned hi = __umulhi(u, m.magic);
  const unsigned q = (hi + ((u - hi) >> m.sh1)) >> m.sh2;
  const unsigned a = u - q * m.t;
  return a >= m.off ? a - m.off : a + (m.t - m.off);
}

// the six table indices of a ray with index k
__device__ __forceinline__ void ray_indices(int k, const Mod& m, unsigned (&j)[FETCHES]) {
  if (k <= NO_WRAP) {
    unsigned r = floored_mod(k, m);
#pragma unroll
    for (int b = 0; b < FETCHES; ++b) {
      j[b] = r;
      r += m.step;
      r = r >= m.t ? r - m.t : r;
    }
  } else {
#pragma unroll
    for (int b = 0; b < FETCHES; ++b)
      j[b] = floored_mod((int)((unsigned)k + (unsigned)(b * STRIDE)), m);
  }
}

struct LdgFetch {
  const int* table;
  __device__ __forceinline__ int operator()(unsigned j) const { return __ldg(table + j); }
};
struct SmemFetch {
  const int* table;
  __device__ __forceinline__ int operator()(unsigned j) const { return table[j]; }
};
struct IndexFetch {
  __device__ __forceinline__ int operator()(unsigned j) const { return (int)j; }
};

// Every ray of idx[0, n): four a thread, grid-stride; the float sum of its
// six fetches into out.  idx and out are 16-byte aligned.
template <class Fetch>
__device__ __forceinline__ void walk(const int* idx, float* out, int n, const Mod& m,
                                     Fetch fetch) {
  const int quads = n / RAYS + (n % RAYS != 0);
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += gridDim.x * blockDim.x) {
    const int i0 = q * RAYS;
    const bool full = n - i0 >= RAYS;
    int k[RAYS];
    if (full) {
      const int4 v = *reinterpret_cast<const int4*>(idx + i0);
      k[0] = v.x, k[1] = v.y, k[2] = v.z, k[3] = v.w;
    } else {
#pragma unroll
      for (int r = 0; r < RAYS; ++r) k[r] = i0 + r < n ? idx[i0 + r] : 0;
    }
    unsigned j[RAYS][FETCHES];
#pragma unroll
    for (int r = 0; r < RAYS; ++r) ray_indices(k[r], m, j[r]);
    int v[RAYS][FETCHES];
#pragma unroll
    for (int r = 0; r < RAYS; ++r)
#pragma unroll
      for (int b = 0; b < FETCHES; ++b) v[r][b] = fetch(j[r][b]);
    float acc[RAYS];
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      acc[r] = 0.0f;
#pragma unroll
      for (int b = 0; b < FETCHES; ++b) acc[r] = acc[r] + (float)v[r][b];
    }
    if (full) {
      *reinterpret_cast<float4*>(out + i0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int r = 0; r < RAYS; ++r)
        if (i0 + r < n) out[i0 + r] = acc[r];
    }
  }
}

// the 16-byte units [q0, q1) of the table's first `quads` that the block
// of cluster rank `rank` copies
__device__ __forceinline__ void rank_slice(unsigned rank, int quads, int& q0, int& q1) {
  q0 = (int)((long long)quads * rank / GATHER_CLUSTER);
  q1 = (int)((long long)quads * (rank + 1) / GATHER_CLUSTER);
}

// Fill s[0, T) with table[0, T) in every block of the cluster.  The
// table's first T / 4 16-byte units come by TMA bulk copies: each block's
// first thread issues its rank's slice of them, multicast to the whole
// cluster, and waits on its own mbarrier (at bar) for all of them; the
// block's threads load the last T % 4 entries.  Ends with this block's
// arrival at the cluster barrier that cluster_exit waits on.  The CPU
// stand-in runs one block at a time and has no cluster: there every block
// copies every rank's slice with plain loads.
__device__ __forceinline__ void fill_table(int* s, unsigned long long* bar,
                                           const int* table, int t) {
  const int quads = t / 4;
#ifdef CUDA_EMU
  (void)bar;
  for (unsigned rank = 0; rank < GATHER_CLUSTER; ++rank) {
    int q0, q1;
    rank_slice(rank, quads, q0, q1);
    for (int e = 4 * q0 + (int)threadIdx.x; e < 4 * q1; e += (int)blockDim.x) s[e] = table[e];
  }
#else
  const unsigned s_addr = (unsigned)__cvta_generic_to_shared(s);
  const unsigned b_addr = (unsigned)__cvta_generic_to_shared(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every block's barrier is set before any copy lands in it
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b_addr), "r"(16 * quads) : "memory");
    unsigned rank;
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
    int q0, q1;
    rank_slice(rank, quads, q0, q1);
    const unsigned short all = (unsigned short)((1u << GATHER_CLUSTER) - 1);
    for (int q = q0; q < q1; q += CHUNK_QUADS) {
      const int nq = q1 - q < CHUNK_QUADS ? q1 - q : CHUNK_QUADS;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".multicast::cluster [%0], [%1], %2, [%3], %4;"
          :: "r"(s_addr + 16u * q), "l"(table + 4 * q), "r"(16 * nq), "r"(b_addr),
             "h"(all) : "memory");
    }
  }
#endif
  for (int e = 4 * quads + (int)threadIdx.x; e < t; e += (int)blockDim.x) s[e] = table[e];
#ifndef CUDA_EMU
  // every thread sees the copies land; a copy that never lands is a fault,
  // not a hang
  unsigned done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries == WAIT_TRIES) __trap();
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(b_addr), "r"(0u)
                 : "memory");
  }
#endif
  __syncthreads();
#ifndef CUDA_EMU
  // this block's table is whole, so every copy into it has landed
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
#endif
}

// A block leaves only once every block of its cluster has its table: no
// block exits while a copy it multicast may still be in flight.
__device__ __forceinline__ void cluster_exit() {
#ifndef CUDA_EMU
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
#endif
}

__global__ void __launch_bounds__(GATHER_BLOCK)
gather_ldg_kernel(const int* table, const int* idx, float* out, int n, Mod m) {
  walk(idx, out, n, m, LdgFetch{table});
}

__global__ void __cluster_dims__(GATHER_CLUSTER, 1, 1) __launch_bounds__(SMEM_BLOCK, 1)
gather_smem_kernel(const int* table, const int* idx, float* out, int n, Mod m) {
  EXTERN_SHARED float smem[];
  auto* bar = reinterpret_cast<unsigned long long*>(smem);
  int* s_table = reinterpret_cast<int*>(smem) + BARRIER_BYTES / (int)sizeof(int);
  fill_table(s_table, bar, table, (int)m.t);
  walk(idx, out, n, m, SmemFetch{s_table});
  cluster_exit();
}

__global__ void __launch_bounds__(GATHER_BLOCK)
gather_base_kernel(const int* idx, float* out, int n, Mod m) {
  walk(idx, out, n, m, IndexFetch{});
}

}  // namespace

// The launch plan of this card, queried once: info = (SMs, resident blocks
// of ldg, of smem (whole clusters), of base, the cluster size, the table
// entries the smem kernel holds).  Sets ldg's carveout to 0 (the largest L1)
// and lets smem take a block's opt-in shared memory, so that a launch makes
// no query and no setting.
extern "C" int probe_gather_init(int* info) {
  int dev = 0, sms = 0, optin = 0, ldg = 0, base = 0, clusters = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gather_ldg_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gather_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ldg, gather_ldg_kernel,
                                                        GATHER_BLOCK, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&base, gather_base_kernel,
                                                        GATHER_BLOCK, 0);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim.x = GATHER_CLUSTER;
    cfg.blockDim.x = SMEM_BLOCK;
    cfg.dynamicSmemBytes = (size_t)optin;
    err = cudaOccupancyMaxActiveClusters(&clusters, gather_smem_kernel, &cfg);
  }
  if (err != cudaSuccess) return (int)err;
  if (ldg < 1 || base < 1 || clusters < 1) return (int)cudaErrorInvalidValue;
  info[0] = sms;
  info[1] = sms * ldg;
  info[2] = clusters * GATHER_CLUSTER;
  info[3] = sms * base;
  info[4] = GATHER_CLUSTER;
  info[5] = (optin - BARRIER_BYTES) / (int)sizeof(int);
  return 0;
}

// mode 0: ldg, 1: smem (T at most info[5] of probe_gather_init), 2: base.
// table: at least T ints (16-byte aligned for smem); idx, out: n, 16-byte
// aligned; blocks: the mode's resident blocks from probe_gather_init, the
// most the grid takes.
extern "C" int probe_gather_launch(int mode, const int* table, const int* idx,
                                   float* out, int t, int n, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t < 1 || n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const Mod m = make_mod(t);
  const int quads = n / RAYS + (n % RAYS != 0);
  if (mode == 0 || mode == 2) {
    const int need = (quads + GATHER_BLOCK - 1) / GATHER_BLOCK;
    const int grid = need < blocks ? need : blocks;
    if (mode == 0)
      LAUNCH(gather_ldg_kernel, grid, GATHER_BLOCK, 0, st, table, idx, out, n, m);
    else
      LAUNCH(gather_base_kernel, grid, GATHER_BLOCK, 0, st, idx, out, n, m);
  } else if (mode == 1) {
    const int need = (quads + SMEM_BLOCK - 1) / SMEM_BLOCK;
    const int clusters = (need + GATHER_CLUSTER - 1) / GATHER_CLUSTER;
    const int grid = (clusters < blocks / GATHER_CLUSTER ? clusters : blocks / GATHER_CLUSTER)
                     * GATHER_CLUSTER;
    const size_t smem = BARRIER_BYTES + sizeof(int) * (size_t)t;
    LAUNCH(gather_smem_kernel, grid, SMEM_BLOCK, smem, st, table, idx, out, n, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
