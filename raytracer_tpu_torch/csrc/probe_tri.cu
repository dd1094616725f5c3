// Ray x triangle nearest-hit probes for Hopper (sm_90a).
//
// Replaces the TPU probes scripts/probe_pairwise.py (`run`, pallas_call
// :130), scripts/probe_pairwise2.py (`run`, pallas_call :120) and
// scripts/probe_mesh_sweep.py (`run`, pallas_call :87).  The plain
// PyTorch versions are in probes/tri_sweep.py.  Arithmetic is the
// scripts', in their order, and the library is built with --fmad=false, so
// kernel and plain version agree bit for bit.
//
// - tri_thread (P3 on Hopper): one thread per ray; the (24, 128) parameter
//   blocks of 128 triangles are staged through shared memory, every thread
//   reading each triangle's parameters as a broadcast.  The first triangle
//   that reaches the least t wins (a strict < over triangles in order), as
//   the script's block min + first-winner select + strict cross-block
//   update does.
// - tri_warp (pairwise2's triangles-in-lanes layout): one warp per 32
//   rays; for each ray the 32 lanes test 32 triangles at a time and a
//   __shfl_xor butterfly takes the (t, id) minimum, so the lowest id wins
//   ties; the ray's own lane keeps its running best.
// - sweep (P4): rays against T rows of 15 floats (plane of each triangle
//   only), the rows in shared memory and read as broadcasts, a 6-value
//   carry; a run-time loop against a fully unrolled one.
//
// What bounds them on the card: FP32 issue (one IEEE division and ~35
// other operations per ray-triangle test); bytes are a few MB.  Every
// entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 128;               // triangles per parameter block
constexpr int NP = 24;                // parameters per triangle
constexpr int TRI_BLOCK = 128;        // threads per block
const float FARAWAY = 1.0e30f;

// the scripts' test of one ray against one triangle, parameters at stride
// `s`: [p1 p2 p3 n cen n31 n12 n23]; returns t or FARAWAY
__device__ __forceinline__ float tri_t(const float* q, int s, float ox,
                                       float oy, float oz, float dx, float dy,
                                       float dz) {
  float ndd = q[9 * s] * dx + q[10 * s] * dy + q[11 * s] * dz;
  if (ndd == 0.0f) ndd = ndd + 1e-4f;
  const float ndco = q[9 * s] * (q[12 * s] - ox) + q[10 * s] * (q[13 * s] - oy)
                     + q[11 * s] * (q[14 * s] - oz);
  const float tt = ndco / ndd;
  const float mx = ox + dx * tt, my = oy + dy * tt, mz = oz + dz * tt;
  const bool inside =
      (q[15 * s] * (mx - q[0]) + q[16 * s] * (my - q[1 * s])
       + q[17 * s] * (mz - q[2 * s]) >= 0.0f)
      & (q[18 * s] * (mx - q[3 * s]) + q[19 * s] * (my - q[4 * s])
         + q[20 * s] * (mz - q[5 * s]) >= 0.0f)
      & (q[21 * s] * (mx - q[6 * s]) + q[22 * s] * (my - q[7 * s])
         + q[23 * s] * (mz - q[8 * s]) >= 0.0f)
      & (ndco * ndd > 0.0f);
  return inside ? fabsf(tt) : FARAWAY;
}

__device__ __forceinline__ void stage(float* s, const float* mesh, int b) {
  const float* src = mesh + (size_t)b * NP * TB;
  for (int k = threadIdx.x; k < NP * TB; k += TRI_BLOCK) s[k] = src[k];
}

// the winner's normal (parameters 9-11), zeros when nothing is hit
__device__ __forceinline__ void write_hit(const float* mesh, int n_rays, int i,
                                          float t, int id, float* t_out,
                                          float* id_out, float* n_out) {
  t_out[i] = t;
  id_out[i] = (float)id;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    n_out[(size_t)c * n_rays + i] =
        id < 0 ? 0.0f : mesh[((size_t)(id / TB) * NP + 9 + c) * TB + id % TB];
}

__global__ void __launch_bounds__(TRI_BLOCK)
tri_thread_kernel(const float* mesh, int n_blocks, const float* o,
                  const float* d, int n_rays, float* t_out, float* id_out,
                  float* n_out) {
  __shared__ float s[NP * TB];
  const int i = blockIdx.x * TRI_BLOCK + threadIdx.x;
  const bool live = i < n_rays;
  const int r = live ? i : 0;
  const float ox = o[r], oy = o[n_rays + r], oz = o[2 * n_rays + r];
  const float dx = d[r], dy = d[n_rays + r], dz = d[2 * n_rays + r];
  float best = FARAWAY;
  int best_id = -1;
  for (int b = 0; b < n_blocks; ++b) {
    __syncthreads();
    stage(s, mesh, b);
    __syncthreads();
    for (int j = 0; j < TB; ++j) {
      const float t = tri_t(s + j, TB, ox, oy, oz, dx, dy, dz);
      if (t < best) { best = t; best_id = b * TB + j; }
    }
  }
  if (live) write_hit(mesh, n_rays, i, best, best_id, t_out, id_out, n_out);
}

__global__ void __launch_bounds__(TRI_BLOCK)
tri_warp_kernel(const float* mesh, int n_blocks, const float* o,
                const float* d, int n_rays, float* t_out, float* id_out,
                float* n_out) {
  __shared__ float s[NP * TB];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * TRI_BLOCK + threadIdx.x;   // this lane's ray
  const bool live = i < n_rays;
  const int r = live ? i : 0;
  const float my[6] = {o[r], o[n_rays + r], o[2 * n_rays + r],
                       d[r], d[n_rays + r], d[2 * n_rays + r]};
  float best = FARAWAY;
  int best_id = -1;
  for (int b = 0; b < n_blocks; ++b) {
    __syncthreads();
    stage(s, mesh, b);
    __syncthreads();
    for (int rr = 0; rr < 32; ++rr) {
      float ray[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) ray[c] = __shfl_sync(0xffffffffu, my[c], rr);
      float t = FARAWAY;
      int id = 0x7fffffff;
#pragma unroll
      for (int k = 0; k < TB / 32; ++k) {
        const int j = lane + 32 * k;
        const float tj = tri_t(s + j, TB, ray[0], ray[1], ray[2], ray[3],
                               ray[4], ray[5]);
        if (tj < t) { t = tj; id = b * TB + j; }
      }
      // (t, id) minimum over the warp: the least t, then the least id
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, t, off);
        const int oid = __shfl_xor_sync(0xffffffffu, id, off);
        if (ot < t || (ot == t && oid < id)) { t = ot; id = oid; }
      }
      if (lane == rr && t < best) { best = t; best_id = id; }
    }
  }
  if (live) write_hit(mesh, n_rays, i, best, best_id, t_out, id_out, n_out);
}

// ---- P4: the plane-of-triangle sweep over T rows of 15 floats ----
constexpr int SWEEP_BLOCK = 256;
constexpr int ROW = 15;

struct Best {
  float t, o, nx, ny, nz;
  int id;
};

__device__ __forceinline__ void sweep_row(const float* g, int i, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, Best& b) {
  float ndd = g[9] * dx + g[10] * dy + g[11] * dz;
  if (ndd == 0.0f) ndd = ndd + 1e-4f;
  const float ndco = g[9] * (g[12] - ox) + g[10] * (g[13] - oy)
                     + g[11] * (g[14] - oz);
  const float tt = ndco / ndd;
  const float t = ndco * ndd > 0.0f ? fabsf(tt) : FARAWAY;
  const float oi = ndd < 0.0f ? 1.0f : -1.0f;
  if (t < b.t) { b.t = t; b.o = oi; b.id = i; b.nx = g[9]; b.ny = g[10]; b.nz = g[11]; }
}

template <int T>   // T > 0: unrolled over T rows; T == 0: run-time loop
__device__ __forceinline__ void sweep_body(const float* mesh, int n_rows,
                                           const float* o, const float* d,
                                           int tile, int n, float* out) {
  extern __shared__ float rows[];
  for (int k = threadIdx.x; k < n_rows * ROW; k += SWEEP_BLOCK) rows[k] = mesh[k];
  __syncthreads();
  const int i = blockIdx.x * SWEEP_BLOCK + threadIdx.x;
  if (i >= n) return;
  const int g = i / tile, lane = i - g * tile;
  const float ox = o[lane], oy = o[tile + lane], oz = o[2 * tile + lane];
  const float dx = d[lane], dy = d[tile + lane], dz = d[2 * tile + lane];
  Best b = {FARAWAY, 1.0f, 0.0f, 0.0f, 0.0f, -1};
  if (T > 0) {
#pragma unroll
    for (int r = 0; r < T; ++r) sweep_row(rows + r * ROW, r, ox, oy, oz, dx, dy, dz, b);
  } else {
#pragma unroll 1
    for (int r = 0; r < n_rows; ++r) sweep_row(rows + r * ROW, r, ox, oy, oz, dx, dy, dz, b);
  }
  float* dst = out + (size_t)g * 3 * tile + lane;
  dst[0] = b.t + b.o;
  dst[tile] = b.nx + b.ny + b.nz;
  dst[2 * tile] = (float)b.id;
}

__global__ void __launch_bounds__(SWEEP_BLOCK)
sweep_loop_kernel(const float* mesh, int n_rows, const float* o, const float* d,
                  int tile, int n, float* out) {
  sweep_body<0>(mesh, n_rows, o, d, tile, n, out);
}

template <int T>
__global__ void __launch_bounds__(SWEEP_BLOCK)
sweep_unrolled_kernel(const float* mesh, int n_rows, const float* o,
                      const float* d, int tile, int n, float* out) {
  sweep_body<T>(mesh, n_rows, o, d, tile, n, out);
}

}  // namespace

// mesh: (n_blocks, 24, 128); o, d: (3, n_rays); t, id: (n_rays,);
// n: (3, n_rays).  warp != 0 takes the triangles-in-lanes kernel.
extern "C" int probe_tri_launch(int warp, const float* mesh, int n_blocks,
                                const float* o, const float* d, int n_rays,
                                float* t, float* id, float* n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n_rays + TRI_BLOCK - 1) / TRI_BLOCK;
  if (warp)
    tri_warp_kernel<<<grid, TRI_BLOCK, 0, st>>>(mesh, n_blocks, o, d, n_rays, t, id, n);
  else
    tri_thread_kernel<<<grid, TRI_BLOCK, 0, st>>>(mesh, n_blocks, o, d, n_rays, t, id, n);
  return (int)cudaGetLastError();
}

// mesh: (n_rows, 15); o, d: (3, tile); out: (grid, 3, tile).  unrolled
// takes the kernel compiled for exactly n_rows rows (64 or 512).
extern "C" int probe_sweep_launch(int unrolled, const float* mesh, int n_rows,
                                  const float* o, const float* d, int tile,
                                  int grid, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)n_rows * ROW;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int n = grid * tile;
  const int blocks = (n + SWEEP_BLOCK - 1) / SWEEP_BLOCK;
  if (!unrolled)
    sweep_loop_kernel<<<blocks, SWEEP_BLOCK, smem, st>>>(mesh, n_rows, o, d, tile, n, out);
  else if (n_rows == 512)
    sweep_unrolled_kernel<512><<<blocks, SWEEP_BLOCK, smem, st>>>(mesh, n_rows, o, d, tile, n, out);
  else if (n_rows == 64)
    sweep_unrolled_kernel<64><<<blocks, SWEEP_BLOCK, smem, st>>>(mesh, n_rows, o, d, tile, n, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
