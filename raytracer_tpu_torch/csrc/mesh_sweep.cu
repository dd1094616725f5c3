// W1: the wavefront's triangle sweep for Hopper (sm_90a).
//
// Replaces the jnp sweep that XLA fuses on the TPU:
// raytracer_tpu/geometry/intersect.py `_clustered_nearest` (:317),
// `_clustered_occluded` (:370) and `_blocked_tri_scan` (:421) as
// `nearest_hit` / `occluded` use it.  The plain PyTorch versions are
// geometry/intersect.py `_clustered_nearest`, `_clustered_occluded`,
// `_flat_nearest` and `_flat_occluded`; the wrappers are in
// ops/mesh_sweep.py.  Arithmetic is `intersect_triangles`' in its order
// (and `_inst_rays`' for an instance), and the library is built with
// --fmad=false, so kernel and plain version agree bit for bit.  The
// per-triangle constants n . centroid and the three edge constants come
// in as a table that the wrapper computes with the plain version's own
// torch expressions.
//
// What bounds W1 on the card: instruction issue.  A row is 64 bytes read
// as 4 float4 broadcasts, and its test, compiled for sm_90a, issues 83.5
// instructions on the path of a row that is no hit in the clustered
// nearest's loop (167 a pass of two tests: one IEEE division's fast path,
// the dot products, the edge tests, the running best), each one issue
// slot of a warp scheduler; chip_smoke.py reads this count off the SASS
// of each entry's loop (probes/common.py `loop_issue`).  The design keeps
// every intermediate in registers: where the plain version writes ~60
// (256, pairs) planes a block of pairs, W1 writes one key and one code a
// pair.  On an H100 at the mesh examples' pairs it runs ~360 G tests/s,
// about nine tenths of that issue bound (PERF.md).
//
// - Clustered (nearest and occluded): one thread a (cluster record, ray)
//   pair of `_cluster_pairs`, which lists the pairs grouped by physical
//   cluster, so the threads of a warp mostly read the same 256 rows and
//   each row load is one broadcast from L1.  The thread pulls its ray
//   into the record's object space and tests the 256 rows from the
//   record's first physical row.
// - Flat: one thread a ray over all T rows (T < TRI_CLUSTER_THRESHOLD on
//   the render path), every load a broadcast.
//
// The tie rules, each the plain fold's:
// - clustered nearest: per pair, the least t over its rows and, among
//   rows at that t, the last (the plain max-code reduce); per ray the
//   least (t, visit rank) over its pairs with t < FARAWAY, taken as the
//   64-bit key (bits of t) << 32 | rank by atomicMin (t >= 0 and never
//   NaN, so the key orders as (t, rank) does; a ray meets a record once,
//   so ranks do not tie).  A second launch writes t from the key and
//   lets the unique pair whose key won write its code and record: the
//   result does not depend on the order in which blocks finish;
// - flat nearest: the least t over all rows and, among rows at that t,
//   the last row of the first block of B rows that holds it (the strict
//   `<` across blocks, the max-code reduce inside one);
// - occluded: any row nearer than the ray's max_dist whose mask bit is
//   set; order-free, so a thread stops at its first.
//
// Every entry returns cudaGetLastError() after its launches and reports
// the kernels it launched.

#include <cuda_runtime.h>

// Dynamic shared memory and the kernel launch; the CPU stand-in of the
// CUDA runtime (csrc/emu/cuda_runtime.h) defines CUDA_EMU and both macros
// its own way.
#ifndef CUDA_EMU
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace {

constexpr int SWEEP_BLOCK = 128;      // threads a block
constexpr int CLUSTER = 256;          // rows a cluster record tests
const float FARAWAY = 1.0e30f;
constexpr unsigned long long NO_HIT = ~0ull;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// A row: (normal, n . centroid), (n31, n31 . p1), (n12, n12 . p2),
// (n23, n23 . p3).  Returns t, or FARAWAY on a miss; back = (orient < 0),
// orient being UPWARDS (+1) where n . D < 0 (intersect.py `_orient`).
__device__ __forceinline__ float tri_test(const float4* row, const Ray& r,
                                          bool& back) {
  const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2),
               d = __ldg(row + 3);
  const float n_dot_o = a.x * r.ox + a.y * r.oy + a.z * r.oz;
  const float n_dot_d = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const float ndd = n_dot_d == 0.0f ? n_dot_d + 0.0001f : n_dot_d;
  const float ndco = a.w - n_dot_o;
  const float t = ndco / ndd;
  // each edge test (n . O - n . p) + t (n . D) >= 0, as edge_ok
  const bool inside =
      (((b.x * r.ox + b.y * r.oy + b.z * r.oz) - b.w)
       + t * (b.x * r.dx + b.y * r.dy + b.z * r.dz) >= 0.0f)
      & (((c.x * r.ox + c.y * r.oy + c.z * r.oz) - c.w)
         + t * (c.x * r.dx + c.y * r.dy + c.z * r.dz) >= 0.0f)
      & (((d.x * r.ox + d.y * r.oy + d.z * r.oz) - d.w)
         + t * (d.x * r.dx + d.y * r.dy + d.z * r.dz) >= 0.0f)
      & (ndco * ndd > 0.0f);
  back = !(ndd < 0.0f);
  return inside ? fabsf(t) : FARAWAY;
}

// Ray r of the (3, npad) planes, pulled into the object space of the
// record's instance when the scene has instances (intersect.py
// `_inst_rays`: ((O - trans) @ R) * (1 / s), (D @ R) * (1 / s)).
__device__ __forceinline__ Ray pair_ray(const float* Op, const float* Dp,
                                        long long npad, long long r,
                                        int inst, const float* rot,
                                        const float* trans,
                                        const float* inv_scale) {
  Ray w = {Op[r], Op[npad + r], Op[2 * npad + r],
           Dp[r], Dp[npad + r], Dp[2 * npad + r]};
  if (inst < 0) return w;
  const float* R = rot + 9 * inst;
  const float si = inv_scale[inst];
  const float o0 = w.ox - trans[3 * inst], o1 = w.oy - trans[3 * inst + 1],
              o2 = w.oz - trans[3 * inst + 2];
  Ray o;
  o.ox = (o0 * R[0] + o1 * R[3] + o2 * R[6]) * si;
  o.oy = (o0 * R[1] + o1 * R[4] + o2 * R[7]) * si;
  o.oz = (o0 * R[2] + o1 * R[5] + o2 * R[8]) * si;
  o.dx = (w.dx * R[0] + w.dy * R[3] + w.dz * R[6]) * si;
  o.dy = (w.dx * R[1] + w.dy * R[4] + w.dz * R[7]) * si;
  o.dz = (w.dx * R[2] + w.dy * R[5] + w.dz * R[8]) * si;
  return o;
}

// The cluster records' tables and the pairs, as `_cluster_pairs` gives
// them.
struct Pairs {
  const long long* ray;     // (K,) ray of each pair
  const long long* rec;     // (K,) cluster record of each pair
  int n;                    // K
  const int* cl_start;      // (C,) first physical row of each record
  const int* cl_virt;       // (C,) first virtual id of each record
  const int* cl_inst;       // (C,) instance of each record, or null
  const float* rot;         // (I, 3, 3)
  const float* trans;       // (I, 3)
  const float* inv_scale;   // (I,)
  const float* Op;          // (3, npad) origins
  const float* Dp;          // (3, npad) directions
  long long npad;
};

__device__ __forceinline__ Ray load_pair(const Pairs& P, long long r, int rec) {
  return pair_ray(P.Op, P.Dp, P.npad, r, P.cl_inst ? P.cl_inst[rec] : -1,
                  P.rot, P.trans, P.inv_scale);
}

__global__ void __launch_bounds__(SWEEP_BLOCK)
cluster_nearest_kernel(const float4* rows, Pairs P, const long long* rank,
                       int C, int R, unsigned long long* ray_key,
                       unsigned long long* pair_key, long long* pair_code) {
  const int p = blockIdx.x * SWEEP_BLOCK + threadIdx.x;
  if (p >= P.n) return;
  const long long r = P.ray[p];
  const int rec = (int)P.rec[p];
  const Ray ray = load_pair(P, r, rec);
  const float4* row = rows + 4ll * P.cl_start[rec];
  float best = FARAWAY;
  int jb = -1;
  bool bb = false;
#pragma unroll 2
  for (int j = 0; j < CLUSTER; ++j) {
    bool back;
    const float t = tri_test(row + 4 * j, ray, back);
    if (t < best || (t == best && jb >= 0)) {
      best = t;
      jb = j;
      bb = back;
    }
  }
  unsigned long long key = NO_HIT;
  long long code = -1;
  if (jb >= 0) {
    key = (unsigned long long)__float_as_uint(best) << 32
          | (unsigned)rank[(r / R) * C + rec];
    code = 2ll * P.cl_virt[rec] + 2 * jb + (bb ? 1 : 0);
    atomicMin(ray_key + r, key);
  }
  pair_key[p] = key;
  pair_code[p] = code;
}

// t of each ray from its key (FARAWAY, code -1, record -1 where no pair
// hit); the pair whose key won writes the ray's code and record.
__global__ void __launch_bounds__(SWEEP_BLOCK)
cluster_finish_kernel(const unsigned long long* ray_key, long long npad,
                      const long long* pair_ray, const long long* pair_rec,
                      const unsigned long long* pair_key,
                      const long long* pair_code, int n_pairs, float* t,
                      long long* code, long long* rec) {
  const long long i = (long long)blockIdx.x * SWEEP_BLOCK + threadIdx.x;
  if (i < npad) {
    const unsigned long long k = ray_key[i];
    t[i] = k == NO_HIT ? FARAWAY : __uint_as_float((unsigned)(k >> 32));
    if (k == NO_HIT) code[i] = rec[i] = -1;
  }
  if (i < n_pairs) {
    const unsigned long long k = pair_key[i];
    const long long r = pair_ray[i];
    if (k != NO_HIT && k == ray_key[r]) {
      code[r] = pair_code[i];
      rec[r] = pair_rec[i];
    }
  }
}

__global__ void __launch_bounds__(SWEEP_BLOCK)
cluster_occluded_kernel(const float4* rows, Pairs P, const float* max_dist,
                        const unsigned char* mask, long long n_virt,
                        int* hits) {
  const int p = blockIdx.x * SWEEP_BLOCK + threadIdx.x;
  if (p >= P.n) return;
  const long long r = P.ray[p];
  const int rec = (int)P.rec[p];
  const Ray ray = load_pair(P, r, rec);
  const float4* row = rows + 4ll * P.cl_start[rec];
  const long long virt = P.cl_virt[rec];
  const float md = max_dist[r];
  for (int j = 0; j < CLUSTER; ++j) {
    bool back;
    const float t = tri_test(row + 4 * j, ray, back);
    if (t < md && virt + j < n_virt && mask[virt + j]) {
      atomicAdd(hits + r, 1);
      return;
    }
  }
}

__device__ __forceinline__ Ray flat_ray(const float* O, const float* D,
                                        long long i) {
  return {O[3 * i], O[3 * i + 1], O[3 * i + 2],
          D[3 * i], D[3 * i + 1], D[3 * i + 2]};
}

__global__ void __launch_bounds__(SWEEP_BLOCK)
flat_nearest_kernel(const float4* rows, int T, int B, const float* O,
                    const float* D, long long n, float* t_out,
                    long long* code) {
  const long long i = (long long)blockIdx.x * SWEEP_BLOCK + threadIdx.x;
  if (i >= n) return;
  const Ray ray = flat_ray(O, D, i);
  float best = FARAWAY;
  int jb = -1, block_end = 0;
  bool bb = false;
#pragma unroll 2
  for (int j = 0; j < T; ++j) {
    bool back;
    const float t = tri_test(rows + 4ll * j, ray, back);
    if (t < best) {
      best = t;
      jb = j;
      bb = back;
      block_end = (j / B + 1) * B;
    } else if (t == best && jb >= 0 && j < block_end) {
      jb = j;
      bb = back;
    }
  }
  t_out[i] = best;
  code[i] = jb < 0 ? -1 : 2ll * jb + (bb ? 1 : 0);
}

__global__ void __launch_bounds__(SWEEP_BLOCK)
flat_occluded_kernel(const float4* rows, int T, const float* O, const float* D,
                     long long n, const float* max_dist,
                     const unsigned char* mask, unsigned char* occ) {
  const long long i = (long long)blockIdx.x * SWEEP_BLOCK + threadIdx.x;
  if (i >= n) return;
  const Ray ray = flat_ray(O, D, i);
  const float md = max_dist[i];
  unsigned char hit = 0;
  for (int j = 0; j < T; ++j) {
    bool back;
    const float t = tri_test(rows + 4ll * j, ray, back);
    if (t < md && mask[j]) {
      hit = 1;
      break;
    }
  }
  occ[i] = hit;
}

int blocks_for(long long n) { return (int)((n + SWEEP_BLOCK - 1) / SWEEP_BLOCK); }

}  // namespace

// rows: (T + 256, 16) float32, 16-byte aligned (the row tables padded with
// degenerate rows); pair_ray, pair_rec: (K,) int64; cl_start, cl_virt,
// cl_inst: (C,) int32 (cl_inst null without instances); rot, trans,
// inv_scale: the instance tables; Op, Dp: (3, npad); rank: (tiles * C,)
// int64; ray_key: (npad,) scratch; pair_key, pair_code: (K,) scratch;
// t: (npad,) float32; code, rec: (npad,) int64.  Sets ray_key to NO_HIT,
// launches the sweep (unless K = 0), then the finish; *launched counts
// the kernels launched.
extern "C" int mesh_cluster_nearest(
    const float* rows, const long long* pair_ray, const long long* pair_rec,
    int n_pairs, const int* cl_start, const int* cl_virt, const int* cl_inst,
    const float* rot, const float* trans, const float* inv_scale,
    const float* Op, const float* Dp, long long npad, const long long* rank,
    int C, int R, unsigned long long* ray_key, unsigned long long* pair_key,
    long long* pair_code, float* t, long long* code, long long* rec,
    void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (npad < 1 || n_pairs < 0 || C < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(ray_key, 0xff, sizeof(*ray_key) * npad, st);
  if (err != cudaSuccess) return (int)err;
  const Pairs P = {pair_ray, pair_rec, n_pairs, cl_start, cl_virt, cl_inst,
                   rot, trans, inv_scale, Op, Dp, npad};
  if (n_pairs > 0) {
    LAUNCH(cluster_nearest_kernel, blocks_for(n_pairs), SWEEP_BLOCK, 0, st,
           reinterpret_cast<const float4*>(rows), P, rank, C, R, ray_key,
           pair_key, pair_code);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    *launched += 1;
  }
  LAUNCH(cluster_finish_kernel, blocks_for(npad > n_pairs ? npad : n_pairs),
         SWEEP_BLOCK, 0, st, ray_key, npad, pair_ray, pair_rec, pair_key,
         pair_code, n_pairs, t, code, rec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched += 1;
  return 0;
}

// As mesh_cluster_nearest, with max_dist: (npad,) float32, mask: (n_virt,)
// bool by virtual id, hits: (npad,) int32, set to 0 here and counting the
// pairs of each ray that found an occluder.  No launch when K = 0.
extern "C" int mesh_cluster_occluded(
    const float* rows, const long long* pair_ray, const long long* pair_rec,
    int n_pairs, const int* cl_start, const int* cl_virt, const int* cl_inst,
    const float* rot, const float* trans, const float* inv_scale,
    const float* Op, const float* Dp, long long npad, const float* max_dist,
    const unsigned char* mask, long long n_virt, int* hits, void* stream,
    int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (npad < 1 || n_pairs < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(hits, 0, sizeof(*hits) * npad, st);
  if (err != cudaSuccess || n_pairs == 0) return (int)err;
  const Pairs P = {pair_ray, pair_rec, n_pairs, cl_start, cl_virt, cl_inst,
                   rot, trans, inv_scale, Op, Dp, npad};
  LAUNCH(cluster_occluded_kernel, blocks_for(n_pairs), SWEEP_BLOCK, 0, st,
         reinterpret_cast<const float4*>(rows), P, max_dist, mask, n_virt, hits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// rows: (T, 16) float32, 16-byte aligned; O, D: (n, 3) float32; B: rows a
// block of the plain sweep (its tie rule); t: (n,) float32; code: (n,)
// int64.
extern "C" int mesh_flat_nearest(const float* rows, int T, int B,
                                 const float* O, const float* D, long long n,
                                 float* t, long long* code, void* stream,
                                 int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (n < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  LAUNCH(flat_nearest_kernel, blocks_for(n), SWEEP_BLOCK, 0, st,
         reinterpret_cast<const float4*>(rows), T, B, O, D, n, t, code);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// As mesh_flat_nearest, with max_dist: (n,) float32, mask: (T,) bool by
// row, occ: (n,) bool.
extern "C" int mesh_flat_occluded(const float* rows, int T, const float* O,
                                  const float* D, long long n,
                                  const float* max_dist,
                                  const unsigned char* mask, unsigned char* occ,
                                  void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (n < 1 || T < 1) return (int)cudaErrorInvalidValue;
  LAUNCH(flat_occluded_kernel, blocks_for(n), SWEEP_BLOCK, 0, st,
         reinterpret_cast<const float4*>(rows), T, O, D, n, max_dist, mask, occ);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
