// Ray x triangle nearest-hit probes for Hopper (sm_90a).
//
// Replaces the TPU probes scripts/probe_pairwise.py (`run`, pallas_call
// :130: tri_thread), scripts/probe_pairwise2.py (`run`, pallas_call :120:
// tri_warp) and scripts/probe_mesh_sweep.py (`run`, pallas_call :87: the
// sweeps).  The plain PyTorch versions are in probes/tri_sweep.py.
// Arithmetic is the scripts', in their order, and the library is built
// with --fmad=false, so kernel and plain version agree bit for bit.
//
// What bounds P3 on the card: FP32 issue.  A test is ~58 single-slot
// operations and one IEEE division (tri_t); bytes are a few MB.  At the
// scripts' 16,384 rays a thread per ray is 4 warps an SM, too few to hide
// the division's and the loads' latency, so both kernels split the
// triangles into slices across blocks as well as the rays, and merge:
//
// - tri_thread (rays stationary): a block of 128 threads holds 4 rays a
//   thread (512 rays) in registers and walks its slice of the mesh, one
//   block of 128 triangles at a time, staged in shared memory as 6 float4
//   a triangle: one broadcast 16-byte load feeds 4 tests.  The grid is
//   ray tiles x slices, enough slices to fill the card's resident blocks.
// - tri_warp (triangles stationary): each warp holds one block of 128
//   triangles in registers, 4 a lane (lane l: triangles 4l .. 4l + 3, so
//   lane order is id order); a block's four warps take four consecutive
//   mesh blocks (a slice) and its share of the rays passes through shared
//   memory as broadcasts.  Per ray a lane keeps its least t (first
//   triangle on ties), then two warp reductions (__reduce_min_sync) take
//   the least t and the least id among the lanes that hold it.  The grid
//   is ray groups x slices, as many groups as fill the resident blocks.
//
// The merge and its tie rule: per ray the result is the least (t, id),
// taken lexicographically over the triangles with t < FARAWAY, else
// (FARAWAY, -1): what the scripts' first-index block minimum and strict
// cross-block < compute.  t >= 0 and is never NaN, so the key
// (bits of t) << 32 | id orders as (t, id) does.  Each slice writes one
// key a ray (NO_HIT where no triangle of it has t < FARAWAY; a t of
// FARAWAY or +inf never wins); tri_finish takes the least key over the
// slices, in any order, and reads the winner's normal.  Two launches a
// call: the sweep and tri_finish; probe_tri_launch plans the grid and
// reports the plan and the launches it made.
//
// - sweep (P4): rays against T rows of 15 floats (plane of each triangle
//   only), the rows in shared memory and read as broadcasts, a 6-value
//   carry; a run-time loop against a fully unrolled one.
//
// Every entry returns cudaGetLastError() after its launches.

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

constexpr int TB = 128;               // triangles per parameter block
constexpr int NP = 24;                // parameters per triangle
constexpr int TRI_BLOCK = 128;        // threads per block
constexpr int RAYS = 4;               // tri_thread: rays a thread
constexpr int RAY_TILE = RAYS * TRI_BLOCK;   // tri_thread: rays a block
constexpr int WARPS = TRI_BLOCK / 32; // tri_warp: mesh blocks a slice
constexpr int LANE_TRIS = TB / 32;    // tri_warp: triangles a lane
const float FARAWAY = 1.0e30f;
constexpr unsigned long long NO_HIT = ~0ull;

// the scripts' test of one ray against one triangle, parameters
// [p1 p2 p3 n cen n31 n12 n23]; returns t or FARAWAY
__device__ __forceinline__ float tri_t(const float* q, float ox, float oy,
                                       float oz, float dx, float dy, float dz) {
  float ndd = q[9] * dx + q[10] * dy + q[11] * dz;
  if (ndd == 0.0f) ndd = ndd + 1e-4f;
  const float ndco = q[9] * (q[12] - ox) + q[10] * (q[13] - oy)
                     + q[11] * (q[14] - oz);
  const float tt = ndco / ndd;
  const float mx = ox + dx * tt, my = oy + dy * tt, mz = oz + dz * tt;
  const bool inside =
      (q[15] * (mx - q[0]) + q[16] * (my - q[1]) + q[17] * (mz - q[2]) >= 0.0f)
      & (q[18] * (mx - q[3]) + q[19] * (my - q[4]) + q[20] * (mz - q[5]) >= 0.0f)
      & (q[21] * (mx - q[6]) + q[22] * (my - q[7]) + q[23] * (mz - q[8]) >= 0.0f)
      & (ndco * ndd > 0.0f);
  return inside ? fabsf(tt) : FARAWAY;
}

__device__ __forceinline__ unsigned long long hit_key(float t, int id) {
  return (unsigned long long)__float_as_uint(t) << 32 | (unsigned)id;
}

__global__ void __launch_bounds__(TRI_BLOCK)
tri_thread_kernel(const float* mesh, int n_blocks, int per_slice,
                  const float* o, const float* d, int n_rays, int tiles,
                  unsigned long long* keys) {
  // one mesh block, triangle-major: triangle j's parameters are s4[6j .. 6j + 5]
  __shared__ float4 s4[TB * NP / 4];
  float* s = reinterpret_cast<float*>(s4);
  const int tile = blockIdx.x % tiles, slice = blockIdx.x / tiles;
  float ray[RAYS][6], best[RAYS];
  int best_id[RAYS];
#pragma unroll
  for (int r = 0; r < RAYS; ++r) {
    const int i = tile * RAY_TILE + r * TRI_BLOCK + threadIdx.x;
    const int ri = i < n_rays ? i : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ray[r][c] = o[c * n_rays + ri];
      ray[r][3 + c] = d[c * n_rays + ri];
    }
    best[r] = FARAWAY;
    best_id[r] = -1;
  }
  const int b0 = slice * per_slice, b1 = min(n_blocks, b0 + per_slice);
  for (int b = b0; b < b1; ++b) {
    const float* src = mesh + (size_t)b * NP * TB;
    __syncthreads();
    for (int k = threadIdx.x; k < NP * TB; k += TRI_BLOCK)
      s[(k % TB) * NP + k / TB] = src[k];
    __syncthreads();
    for (int j = 0; j < TB; ++j) {
      float q[NP];
#pragma unroll
      for (int c = 0; c < NP / 4; ++c) {
        const float4 v = s4[j * (NP / 4) + c];
        q[4 * c] = v.x, q[4 * c + 1] = v.y, q[4 * c + 2] = v.z, q[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < RAYS; ++r) {
        const float t = tri_t(q, ray[r][0], ray[r][1], ray[r][2], ray[r][3],
                              ray[r][4], ray[r][5]);
        if (t < best[r]) { best[r] = t; best_id[r] = b * TB + j; }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RAYS; ++r) {
    const int i = tile * RAY_TILE + r * TRI_BLOCK + threadIdx.x;
    if (i < n_rays)
      keys[(size_t)slice * n_rays + i] =
          best_id[r] < 0 ? NO_HIT : hit_key(best[r], best_id[r]);
  }
}

__global__ void __launch_bounds__(TRI_BLOCK)
tri_warp_kernel(const float* mesh, int n_blocks, const float* o,
                const float* d, int n_rays, int groups,
                unsigned long long* keys) {
  __shared__ float4 rays[TRI_BLOCK][2];                // (o, dx), (dy, dz, -, -)
  __shared__ unsigned long long found[WARPS][TRI_BLOCK];
  const int g = blockIdx.x % groups, slice = blockIdx.x / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mb = slice * WARPS + warp;
  const bool holds = mb < n_blocks;   // the slice's last warps may hold none
  float q[LANE_TRIS][NP];
  if (holds) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float4 v =
          reinterpret_cast<const float4*>(mesh + ((size_t)mb * NP + p) * TB)[lane];
      q[0][p] = v.x, q[1][p] = v.y, q[2][p] = v.z, q[3][p] = v.w;
    }
  }
  const int id0 = mb * TB + LANE_TRIS * lane;
  const int begin = (int)((long long)n_rays * g / groups);
  const int end = (int)((long long)n_rays * (g + 1) / groups);
  for (int base = begin; base < end; base += TRI_BLOCK) {
    const int count = min(TRI_BLOCK, end - base);
    __syncthreads();
    if (threadIdx.x < count) {
      const int i = base + threadIdx.x;
      rays[threadIdx.x][0] = make_float4(o[i], o[n_rays + i], o[2 * n_rays + i], d[i]);
      rays[threadIdx.x][1] = make_float4(d[n_rays + i], d[2 * n_rays + i], 0.0f, 0.0f);
    }
    __syncthreads();
    if (holds) {
      for (int r = 0; r < count; ++r) {
        const float4 a = rays[r][0], b = rays[r][1];
        float t = FARAWAY;
        int id = -1;
#pragma unroll
        for (int k = 0; k < LANE_TRIS; ++k) {
          const float tk = tri_t(q[k], a.x, a.y, a.z, a.w, b.x, b.y);
          if (tk < t) { t = tk; id = id0 + k; }
        }
        // the warp's least t, then the least id among the lanes holding it
        const unsigned tb = __float_as_uint(t);
        const unsigned tmin = __reduce_min_sync(0xffffffffu, tb);
        const unsigned imin =
            __reduce_min_sync(0xffffffffu, tb == tmin ? (unsigned)id : ~0u);
        if (lane == 0)
          found[warp][r] = __uint_as_float(tmin) < FARAWAY
                               ? hit_key(__uint_as_float(tmin), (int)imin) : NO_HIT;
      }
    }
    __syncthreads();
    if (threadIdx.x < count) {
      unsigned long long key = NO_HIT;
      for (int w = 0; w < WARPS && slice * WARPS + w < n_blocks; ++w) {
        const unsigned long long k = found[w][threadIdx.x];
        key = k < key ? k : key;
      }
      keys[(size_t)slice * n_rays + base + threadIdx.x] = key;
    }
  }
}

// the least key of each ray over the slices; its t, id (as float) and the
// winner's normal (parameters 9-11), or (FARAWAY, -1, zeros)
__global__ void __launch_bounds__(TRI_BLOCK)
tri_finish_kernel(const float* mesh, const unsigned long long* keys, int slices,
                  int n_rays, float* t_out, float* id_out, float* n_out) {
  const int i = blockIdx.x * TRI_BLOCK + threadIdx.x;
  if (i >= n_rays) return;
  unsigned long long key = NO_HIT;
  for (int s = 0; s < slices; ++s) {
    const unsigned long long k = keys[(size_t)s * n_rays + i];
    key = k < key ? k : key;
  }
  const int id = key == NO_HIT ? -1 : (int)(unsigned)key;
  t_out[i] = id < 0 ? FARAWAY : __uint_as_float((unsigned)(key >> 32));
  id_out[i] = (float)id;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    n_out[(size_t)c * n_rays + i] =
        id < 0 ? 0.0f : mesh[((size_t)(id / TB) * NP + 9 + c) * TB + id % TB];
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
  EXTERN_SHARED float smem[];
  float* rows = smem;
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

// The grid of a P3 call, (ray groups, slices, mesh blocks a slice).
// tri_thread: a group is a tile of 512 rays, and the mesh blocks are cut
// into as few slices as make groups x slices fill the card's resident
// blocks, the last slice taking what is left.  tri_warp: a slice is 4
// mesh blocks, and the rays are cut into as many groups as fill the
// resident blocks with groups x slices.
cudaError_t tri_plan(int warp, int n_blocks, int n_rays, int* plan) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = warp ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tri_warp_kernel,
                                                               TRI_BLOCK, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tri_thread_kernel,
                                                               TRI_BLOCK, 0);
  if (err != cudaSuccess) return err;
  const int resident = sms * per_sm > 1 ? sms * per_sm : 1;
  int groups, per;
  if (warp) {
    per = WARPS;
    const int slices = (n_blocks + per - 1) / per;
    groups = min(resident / slices > 1 ? resident / slices : 1, n_rays);
  } else {
    groups = (n_rays + RAY_TILE - 1) / RAY_TILE;
    const int slices = min(n_blocks, (resident + groups - 1) / groups);
    per = (n_blocks + slices - 1) / slices;
  }
  plan[0] = groups;
  plan[1] = (n_blocks + per - 1) / per;
  plan[2] = per;
  return cudaSuccess;
}

}  // namespace

// mesh: (n_blocks, 24, 128), 16-byte aligned; o, d: (3, n_rays); keys:
// (n_blocks, n_rays) scratch (a call's slices never outnumber its mesh
// blocks); t, id: (n_rays,); n: (3, n_rays).  warp != 0 takes the
// triangles-in-lanes kernel.  Plans the grid (tri_plan), launches the
// sweep, then tri_finish; info: (ray groups, slices, mesh blocks a slice,
// kernels launched).
extern "C" int probe_tri_launch(int warp, const float* mesh, int n_blocks,
                                const float* o, const float* d, int n_rays,
                                unsigned long long* keys, float* t, float* id,
                                float* n, void* stream, int* info) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  info[3] = 0;
  if (n_blocks < 1 || n_rays < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = tri_plan(warp, n_blocks, n_rays, info);
  if (err != cudaSuccess) return (int)err;
  const int groups = info[0], slices = info[1], per = info[2];
  if (warp)
    LAUNCH(tri_warp_kernel, groups * slices, TRI_BLOCK, 0, st, mesh, n_blocks, o, d,
           n_rays, groups, keys);
  else
    LAUNCH(tri_thread_kernel, groups * slices, TRI_BLOCK, 0, st, mesh, n_blocks, per, o,
           d, n_rays, groups, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  info[3] = 1;
  LAUNCH(tri_finish_kernel, (n_rays + TRI_BLOCK - 1) / TRI_BLOCK, TRI_BLOCK, 0, st,
         mesh, keys, slices, n_rays, t, id, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  info[3] = 2;
  return 0;
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
    LAUNCH(sweep_loop_kernel, blocks, SWEEP_BLOCK, smem, st, mesh, n_rows, o, d, tile, n, out);
  else if (n_rows == 512)
    LAUNCH(sweep_unrolled_kernel<512>, blocks, SWEEP_BLOCK, smem, st, mesh, n_rows, o, d,
           tile, n, out);
  else if (n_rows == 64)
    LAUNCH(sweep_unrolled_kernel<64>, blocks, SWEEP_BLOCK, smem, st, mesh, n_rows, o, d,
           tile, n, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
