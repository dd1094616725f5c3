// W2: the clustered sweep's pair search for Hopper (sm_90a).
//
// Replaces what the TPU runs of raytracer_tpu/geometry/intersect.py
// `_clustered_nearest` (:317) and `_clustered_occluded` (:370) before
// their triangle tests, jnp code that XLA fuses: each tile's (records,
// rays) box entries (`_cluster_entry` :263, `_safe_inv` :278), the
// tile's front-to-back visit order (the stable argsort of each record's
// least entry, :335) and the per (tile, record) branch (`lax.cond`,
// :359, :405).  The port's form of that selection is the list of
// (record, ray) pairs whose box the ray enters before its limit, with
// each tile's visit ranks; W1 (mesh_sweep.cu) sweeps the pairs.  The
// plain PyTorch version is geometry/intersect.py `_pair_search`; the
// wrapper is ops/mesh_pairs.py.  W2's integers equal the plain version's
// element for element:
//
// - rays, recs (K,) int64: the pairs in `torch.nonzero(keep)`'s order,
//   record rows ascending (rows are the records sorted stably by their
//   first physical row, so a physical cluster's pairs stay together),
//   rays ascending inside a row; recs = rec_of_row[row]; a pair is kept
//   where entry < limit;
// - rank (tiles * C,) int64 at tile * C + record: the record's place in
//   the stable ascending order of its least entry over the tile's rays,
//   ties by record index;
// - K and the number of physical clusters that have pairs.
//
// The entry is `_cluster_entry`'s arithmetic in its order: (lo - o) *
// inv and (hi - o) * inv per axis, min / max folded from axis 0 with
// torch's NaN rule, live = tmax >= 0 & tmin <= tmax, max(tmin, 0) or
// +inf; inv = 1 / d with |d| < 1e-12 replaced by 1e-12, an IEEE
// division (the library is built with --fmad=false and no fast math).
// An entry is +0.0 (never -0.0), positive or +inf, so its bits order as
// its value does: a least entry is a __reduce_min_sync and an atomicMin
// on the bits, which no block order changes.
//
// Launches, all on the caller's stream, before the one host sync:
// 1. count: a thread a ray, a block 256 rays of one tile; the boxes of a
//    chunk of PAIRS_CHUNK records staged in shared memory (24 B each).
//    For each record: the warp's __ballot_sync of keep, written out, and
//    its least entry; per (record, block) the kept count, and per (tile,
//    record) the least entry by atomicMin;
// 2-4. scan: the exclusive prefix sum of the counts in (record row,
//    block) order, in segments of SCAN_SEG (segment sums, a one-block
//    scan of those that also writes K, the segments' scans): each (row,
//    block) gets its first slot;
// 5. rank: a thread a (tile, record) counts the records before it; the
//    first C threads also count the rows that open a physical cluster
//    with pairs.
// The wrapper copies (K, clusters) to the host, allocates the pairs and
// launches
// 6. write: a thread a ray; the block stages its warps' ballots of 32
//    record rows at a time in shared memory; a kept pair goes to its
//    (row, block) slot + the kept pairs of the block's earlier warps + the
//    popcount of the lower lanes' ballot bits: nonzero's order by
//    construction, with no atomic cursor.
//
// What bounds W2 on the card: instruction issue, C * rays box tests of
// ~55 slots (the count loop's SASS; chip_smoke.py reads it with
// probes/common.py `loop_issue`).  Its bytes are the rays (28 B each),
// the pairs (16 B each) and the ranks; the ballots (C * rays / 8 B),
// written once and read once, spare the write launch the box tests.
// The plain version writes ~20 (records, rays) planes and a (records,
// rays) bool mask, argsorts, and syncs twice.
//
// Every entry returns cudaGetLastError() after its launches and reports
// the kernels it launched.

#include <cuda_runtime.h>

#ifndef CUDA_EMU
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

// records whose boxes a block stages in shared memory at once (the tests
// build the CPU stand-in with a small one)
#ifndef PAIRS_CHUNK
#define PAIRS_CHUNK 256
#endif

namespace {

constexpr int PAIRS_BLOCK = 256;            // rays (threads) a block
constexpr int PAIRS_WARPS = PAIRS_BLOCK / 32;
constexpr int WRITE_ROWS = PAIRS_BLOCK / PAIRS_WARPS;   // rows a write stage
constexpr int SCAN_BLOCK = 256;             // threads of a scan block
constexpr int SCAN_ITEMS = 16;              // counts a scan thread takes
constexpr int SCAN_SEG = SCAN_BLOCK * SCAN_ITEMS;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INF_BITS = 0x7f800000u;

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// intersect.py `_safe_inv`
__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

struct PairRay {
  float ox, oy, oz, ix, iy, iz, lim;
};

__device__ __forceinline__ PairRay load_ray(const float* Op, const float* Dp,
                                            const float* lim, long long npad,
                                            long long i) {
  return {Op[i], Op[npad + i], Op[2 * npad + i], safe_inv(Dp[i]),
          safe_inv(Dp[npad + i]), safe_inv(Dp[2 * npad + i]), lim[i]};
}

// `_cluster_entry` of one ray into one box (lo xyz, hi xyz): +0.0, a
// positive distance, or +inf where the ray misses
__device__ __forceinline__ float box_entry(const float* box, const PairRay& r) {
  float t0 = (box[0] - r.ox) * r.ix, t1 = (box[3] - r.ox) * r.ix;
  float tn = nan_min(t0, t1), tf = nan_max(t0, t1);
  t0 = (box[1] - r.oy) * r.iy;
  t1 = (box[4] - r.oy) * r.iy;
  tn = nan_max(tn, nan_min(t0, t1));
  tf = nan_min(tf, nan_max(t0, t1));
  t0 = (box[2] - r.oz) * r.iz;
  t1 = (box[5] - r.oz) * r.iz;
  tn = nan_max(tn, nan_min(t0, t1));
  tf = nan_min(tf, nan_max(t0, t1));
  const bool live = (tf >= 0.0f) & (tn <= tf);
  return live ? (tn > 0.0f ? tn : 0.0f) : __uint_as_float(INF_BITS);
}

// stage the boxes of records [c0, c0 + nc) into sbox
__device__ __forceinline__ void stage_boxes(float* sbox, const float* boxes,
                                            int c0, int nc) {
  for (int k = threadIdx.x; k < 6 * nc; k += PAIRS_BLOCK)
    sbox[k] = boxes[6ll * c0 + k];
}

__global__ void __launch_bounds__(PAIRS_BLOCK)
pair_count_kernel(const float* boxes, const int* rec_of_row, int C,
                  const float* Op, const float* Dp, const float* lim,
                  long long npad, int R, int* counts, unsigned* minent,
                  unsigned* ballots) {
  // a row of PAIRS_CHUNK + 1 words a warp: the epilogue's reads by
  // record and by warp both miss bank conflicts
  __shared__ float sbox[6 * PAIRS_CHUNK];
  __shared__ unsigned sbal[PAIRS_WARPS][PAIRS_CHUNK + 1];
  __shared__ unsigned smin[PAIRS_WARPS][PAIRS_CHUNK + 1];
  const long long nb = gridDim.x, nw = npad / 32;
  const long long i = (long long)blockIdx.x * PAIRS_BLOCK + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const PairRay r = load_ray(Op, Dp, lim, npad, i);
  unsigned* tile_min = minent + (i / R) * C;     // a block lies in one tile
  for (int c0 = 0; c0 < C; c0 += PAIRS_CHUNK) {
    const int nc = C - c0 < PAIRS_CHUNK ? C - c0 : PAIRS_CHUNK;
    __syncthreads();
    stage_boxes(sbox, boxes, c0, nc);
    __syncthreads();
    for (int j = 0; j < nc; ++j) {
      const float e = box_entry(sbox + 6 * j, r);
      const unsigned keep = __ballot_sync(FULL, e < r.lim);
      const unsigned least = __reduce_min_sync(FULL, __float_as_uint(e));
      if (lane == 0) {
        sbal[warp][j] = keep;
        smin[warp][j] = least;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nc; j += PAIRS_BLOCK) {
      int n = 0;
      unsigned least = smin[0][j];
      for (int w = 0; w < PAIRS_WARPS; ++w) {
        n += __popc(sbal[w][j]);
        least = smin[w][j] < least ? smin[w][j] : least;
      }
      counts[(c0 + j) * nb + blockIdx.x] = n;
      atomicMin(tile_min + rec_of_row[c0 + j], least);
    }
    // the block's ballots of each record row: 8 adjacent words a row
    for (int k = threadIdx.x; k < nc * PAIRS_WARPS; k += PAIRS_BLOCK) {
      const int j = k / PAIRS_WARPS, w = k % PAIRS_WARPS;
      ballots[(c0 + j) * nw + blockIdx.x * PAIRS_WARPS + w] = sbal[w][j];
    }
  }
}

// The exclusive scan of a[0, n) (n <= SCAN_SEG) in place, plus carry;
// every thread of the block calls it.  Returns the sum of a[0, n).
__device__ int block_scan(int* a, int n, int carry) {
  __shared__ int part[SCAN_BLOCK];
  const int lo = threadIdx.x * SCAN_ITEMS;
  int own = 0;
  for (int k = lo; k < lo + SCAN_ITEMS && k < n; ++k) own += a[k];
  part[threadIdx.x] = own;
  __syncthreads();
  for (int off = 1; off < SCAN_BLOCK; off *= 2) {   // inclusive, in place
    const int add = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  int run = carry + part[threadIdx.x] - own;
  for (int k = lo; k < lo + SCAN_ITEMS && k < n; ++k) {
    const int v = a[k];
    a[k] = run;
    run += v;
  }
  const int total = part[SCAN_BLOCK - 1];
  __syncthreads();
  return total;
}

// the sum of each segment of SCAN_SEG counts
__global__ void __launch_bounds__(SCAN_BLOCK)
scan_reduce_kernel(const int* counts, long long n, int* sums) {
  __shared__ int part[SCAN_BLOCK];
  const long long base = (long long)blockIdx.x * SCAN_SEG;
  int own = 0;
  for (int k = threadIdx.x; k < SCAN_SEG; k += SCAN_BLOCK)
    if (base + k < n) own += counts[base + k];
  part[threadIdx.x] = own;
  __syncthreads();
  for (int half = SCAN_BLOCK / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = part[0];
}

// the segments' first slots, and K in stats[0]
__global__ void __launch_bounds__(SCAN_BLOCK)
scan_top_kernel(int* sums, int n_seg, int* stats) {
  const int total = block_scan(sums, n_seg, 0);
  if (threadIdx.x == 0) stats[0] = total;
}

// each (row, block) count replaced by its first slot
__global__ void __launch_bounds__(SCAN_BLOCK)
scan_apply_kernel(int* counts, long long n, const int* sums) {
  const long long base = (long long)blockIdx.x * SCAN_SEG;
  const int m = n - base < SCAN_SEG ? (int)(n - base) : SCAN_SEG;
  block_scan(counts + base, m, sums[blockIdx.x]);
}

// rank of each (tile, record); threads below C also count row i when it
// is the first row of its physical cluster (equal first rows are
// adjacent) to have pairs
__global__ void __launch_bounds__(PAIRS_BLOCK)
pair_rank_kernel(const unsigned* minent, int C, long long n_rank,
                 const int* first, long long nb, const int* start_of_row,
                 long long* rank, int* stats) {
  const long long i = (long long)blockIdx.x * PAIRS_BLOCK + threadIdx.x;
  if (i < n_rank) {
    const int c = (int)(i % C);
    const unsigned* m = minent + (i - c);
    const unsigned mine = m[c];
    long long before = 0;
    for (int k = 0; k < C; ++k) {
      const unsigned o = m[k];
      before += (o < mine) | ((o == mine) & (k < c));
    }
    rank[i] = before;
  }
  if (i < C) {
    const int row = (int)i;
    const int a = first[row * nb];
    const int b = row + 1 < C ? first[(row + 1) * nb] : stats[0];
    int k = row;
    while (k > 0 && start_of_row[k - 1] == start_of_row[row]) --k;
    // rows k..row-1 of the same cluster have no pairs, row has some
    if (b > a && first[k * nb] == a) atomicAdd(stats + 1, 1);
  }
}

// each kept pair's ray and record at its slot, from the count launch's
// ballots and each (row, block)'s first slot, staged WRITE_ROWS rows at a
// time: one ballot a thread
__global__ void __launch_bounds__(PAIRS_BLOCK)
pair_write_kernel(const unsigned* ballots, const int* rec_of_row, int C,
                  long long npad, const int* first, long long* rays,
                  long long* recs) {
  __shared__ unsigned sbal[WRITE_ROWS][PAIRS_WARPS];
  __shared__ int sfirst[WRITE_ROWS], srec[WRITE_ROWS];
  const long long nb = gridDim.x, nw = npad / 32;
  const long long i = (long long)blockIdx.x * PAIRS_BLOCK + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lower = (1u << lane) - 1u;
  for (int r0 = 0; r0 < C; r0 += WRITE_ROWS) {
    const int nr = C - r0 < WRITE_ROWS ? C - r0 : WRITE_ROWS;
    __syncthreads();
    const int sr = threadIdx.x / PAIRS_WARPS, sw = threadIdx.x % PAIRS_WARPS;
    if (sr < nr)
      sbal[sr][sw] = ballots[(r0 + sr) * nw + blockIdx.x * PAIRS_WARPS + sw];
    if (threadIdx.x < nr) {
      sfirst[threadIdx.x] = first[(r0 + threadIdx.x) * nb + blockIdx.x];
      srec[threadIdx.x] = rec_of_row[r0 + threadIdx.x];
    }
    __syncthreads();
    for (int row = 0; row < nr; ++row) {
      const unsigned keep = sbal[row][warp];
      if (!((keep >> lane) & 1u)) continue;
      int slot = sfirst[row] + __popc(keep & lower);
      for (int w = 0; w < warp; ++w) slot += __popc(sbal[row][w]);
      rays[slot] = i;
      recs[slot] = srec[row];
    }
  }
}

int blocks_for(long long n, int per) { return (int)((n + per - 1) / per); }

}  // namespace

// boxes: (C, 6) float32, each record row's (lo, hi) in row order;
// rec_of_row, start_of_row: (C,) int32; Op, Dp: (3, npad) float32; lim:
// (npad,) float32 (0 past the rays); npad a multiple of 256 and of R, R
// a multiple of 256, C * npad <= 2^30; counts: (C * npad / 256,) int32
// scratch, left holding each (row, block)'s first slot; sums: (segments,)
// int32 scratch; minent: (npad / R * C,) uint32 scratch; ballots: (C *
// npad / 32,) uint32, left holding each (row, warp)'s kept lanes; rank:
// (npad / R * C,) int64; stats: (2,) int32, set to (K, physical clusters
// with pairs).  *launched counts the kernels launched.
extern "C" int mesh_pairs_search(const float* boxes, const int* rec_of_row,
                                 const int* start_of_row, int C,
                                 const float* Op, const float* Dp,
                                 const float* lim, long long npad, int R,
                                 int* counts, int* sums, unsigned* minent,
                                 unsigned* ballots, long long* rank,
                                 int* stats, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (C < 1 || R < PAIRS_BLOCK || R % PAIRS_BLOCK || npad < R || npad % R
      || (long long)C * npad > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  const long long nb = npad / PAIRS_BLOCK, n_counts = C * nb;
  const long long n_rank = npad / R * C;
  const int n_seg = blocks_for(n_counts, SCAN_SEG);
  if (n_seg > SCAN_SEG) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(minent, 0xff, sizeof(*minent) * n_rank, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(stats, 0, 2 * sizeof(*stats), st);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(pair_count_kernel, (int)nb, PAIRS_BLOCK, 0, st, boxes, rec_of_row, C,
         Op, Dp, lim, npad, R, counts, minent, ballots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched += 1;
  LAUNCH(scan_reduce_kernel, n_seg, SCAN_BLOCK, 0, st, counts, n_counts, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched += 1;
  LAUNCH(scan_top_kernel, 1, SCAN_BLOCK, 0, st, sums, n_seg, stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched += 1;
  LAUNCH(scan_apply_kernel, n_seg, SCAN_BLOCK, 0, st, counts, n_counts, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched += 1;
  LAUNCH(pair_rank_kernel, blocks_for(n_rank > C ? n_rank : C, PAIRS_BLOCK),
         PAIRS_BLOCK, 0, st, minent, C, n_rank, counts, nb, start_of_row, rank,
         stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched += 1;
  return 0;
}

// After mesh_pairs_search, with ballots and counts as it left them:
// rays, recs (K,) int64, K > 0.
extern "C" int mesh_pairs_write(const unsigned* ballots, const int* rec_of_row,
                                int C, long long npad, const int* counts,
                                long long* rays, long long* recs, void* stream,
                                int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (C < 1 || npad < PAIRS_BLOCK || npad % PAIRS_BLOCK)
    return (int)cudaErrorInvalidValue;
  LAUNCH(pair_write_kernel, (int)(npad / PAIRS_BLOCK), PAIRS_BLOCK, 0, st,
         ballots, rec_of_row, C, npad, counts, rays, recs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
