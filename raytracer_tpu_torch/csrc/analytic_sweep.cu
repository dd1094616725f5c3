// W3: the wavefront's analytic sweep for Hopper (sm_90a).
//
// Replaces the analytic part of the JAX package's nearest_hit and
// occluded (raytracer_tpu/geometry/intersect.py:480, :493-506, and :546,
// :553-558): spheres, planes, boxes, discs and cylinders against every
// ray, the nearest hit with its orientation and object id, or whether a
// shadow-casting object lies nearer than the ray's max_dist.  That part
// has no Pallas kernel: it is jnp, which XLA fuses into one pass on the
// TPU.  Eager torch cannot fuse it, so the port's plain version
// (geometry/intersect.py `_analytic_nearest`, `_analytic_occluded`) writes
// eight or more (objects, rays) planes a block of objects to device
// memory: on the 98-object grid it took nine tenths of a frame's device
// time (PERF.md).  This kernel keeps every intermediate in registers and
// reads each ray once.  The wrappers are in ops/analytic_sweep.py.
//
// Arithmetic is the plain intersectors' (geometry/intersect.py
// intersect_spheres, intersect_planes, intersect_boxes, intersect_discs,
// intersect_cylinders), operation by operation in their order: dot
// products summed x + y + z, safemath.safe_sqrt's masked root, torch's
// NaN-carrying minimum and maximum and its sign, ndd + 0.0001 in
// float32; the library is built with --fmad=false and IEEE division and
// square root, so kernel and plain version agree bit for bit.  These are
// not K1's device intersectors (csrc/trace_common.cuh), which restate the
// Pallas kernel and round otherwise (fminf's NaN rule, the plane's signed
// t, the sphere's clamped root).  The per-object constants (r * r, the
// cylinder's axis . center) come in a table that the wrapper computes with
// the plain version's own torch expressions.
//
// What bounds the nearest entry on the card: instruction issue.  A ray
// reads 24 bytes and writes 16, and each of its tests issues tens of
// instructions (a sphere's test, compiled for sm_90a, 71 on its path that
// is no hit: the IEEE square root's refinement and the running best are
// much of it); on the grid (97 spheres and a plane against 4.08 M rays:
// 0.4 G tests) the issue slots take ~17 times as long as the bytes.
// chip_smoke.py reads each kind's instructions a test off the SASS of its
// loop (probes/common.py `kind_loops`).  The design spends the issue slots
// on the tests alone: one thread a ray (grid-stride over a grid sized from
// the card's resident blocks), the objects staged in shared memory in
// chunks of ANALYTIC_CHUNK rows (every thread of a warp reads the same
// row: a broadcast), one loop per kind in object-id order with the kind's
// test inlined (no switch per object; not unrolled, so that each kind's
// loop is one loop of the SASS), a running best in registers.
//
// What bounds the occluded entry depends on the scene.  Its main callers
// (materials/shade.py's light terms, core/aov.py) pass one direction and
// one max_dist for every ray (a directional light: the expand of one row),
// and most scenes past the kernels' gates hold few casting analytic
// objects: the mesh examples a floor plane, beside a sky sphere that casts
// no shadow.  There a ray's own traffic is its origin (12 bytes) and its
// answer (1), against one plane test (65 issue slots): bytes bound it (the
// icosphere's 1.92 M shadow rays: 25 MB, ~7.5 us, against ~3.7 us of
// issue).  Where every object casts and the tests are cylinders (the
// primitives' 0.64 M shadow rays, ~460 slots a ray), issue does.  So:
// - the direction and max_dist come with a row step of 0 or 1: a uniform
//   one (step 0) is staged once a block in shared memory, never copied to
//   every ray;
// - the table holds the casting objects alone (the wrapper's
//   `casting_tables`, made once a geometry and mask), in object-id order:
//   no object that cannot occlude is tested, and no mask is read;
// - the chunk loop is outside the ray loop: a thread computes each kind's
//   range of a chunk once and sweeps its rays through it (a ray already
//   occluded by an earlier chunk, its answer read back, is skipped), so a
//   ray pays its loads, its tests and its store, and little else;
// - a thread stops at its first occluder, the order being free.
// Measured on the card and not kept: loading a thread's next ray before
// testing this one, a grid spread evenly over full passes, and launch
// bounds that trade registers for resident blocks (spills) were each
// slower at both held inputs (PERF.md).
// The tests are the nearest entry's, so chip_smoke.py counts the issue
// slots of the tests a ray makes up to its first casting occluder.
//
// The tie rules, each the plain loop's:
// - nearest: the plain loop takes each kind in blocks of B objects
//   (object_block(N)), the block's first minimum (torch.min), and keeps
//   it where strictly below the running best.  So, per ray, a strict `<`
//   in object-id order, except that a block whose t holds a NaN (a box
//   test of a ray that starts on a slab plane it runs parallel to: 0 *
//   inf) has a NaN minimum, never `<`, and none of its objects wins:
//   the kernel keeps each block's candidate apart and drops it on a NaN.
//   The winner's orientation is the one at its first minimum;
// - occluded: any object nearer than max_dist whose mask bit is set; a
//   NaN never occludes; order-free, so a thread stops at its first and
//   the casting objects may be swept apart from the rest.
//
// Every entry returns cudaGetLastError() after its launch and reports the
// kernels it launched.

#include <cuda_runtime.h>

// Dynamic shared memory and the kernel launch; the CPU stand-in of the
// CUDA runtime (csrc/emu/cuda_runtime.h) defines CUDA_EMU and the launch
// its own way.
#ifndef CUDA_EMU
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

// objects staged in shared memory at a time (64 bytes each: 16 KB)
#ifndef ANALYTIC_CHUNK
#define ANALYTIC_CHUNK 256
#endif

namespace {

constexpr int SWEEP_BLOCK = 128;      // threads a block
constexpr int CHUNK = ANALYTIC_CHUNK;
constexpr int KINDS = 5;              // spheres, planes, boxes, discs, cylinders
const float FARAWAY = 1.0e30f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// first object id of each kind, and the object count at [KINDS]
struct Kinds {
  int start[KINDS + 1];
};

// torch.minimum / torch.maximum as ATen's CUDA kernels compute them: a NaN
// operand is the result
__device__ __forceinline__ float t_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// core/safemath.py safe_sqrt: where(x > 0, sqrt(clamp_min(x, 1e-30)), 0)
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(fmaxf(x, 1e-30f)) : 0.0f;
}
// torch.sign: 0 for a zero or a NaN
__device__ __forceinline__ float t_sign(float x) {
  return (float)((0.0f < x) - (x < 0.0f));
}

// Each test: t (FARAWAY on a miss) of ray r against the object whose row
// starts at o; up = (orient == UPWARDS).

// intersect_spheres; o[0] = (center, radius * radius)
__device__ __forceinline__ float isect_sphere(const float4* o, const Ray& r,
                                              bool& up) {
  const float4 a = o[0];
  const float ocx = r.ox - a.x, ocy = r.oy - a.y, ocz = r.oz - a.z;
  const float tca = -(r.dx * ocx + r.dy * ocy + r.dz * ocz);
  const float px = ocx + tca * r.dx, py = ocy + tca * r.dy,
              pz = ocz + tca * r.dz;
  const float d2 = px * px + py * py + pz * pz;
  const float disc = a.w - d2;
  const float sq = safe_sqrt(disc);
  const float h0 = tca - sq, h1 = tca + sq;
  const float h = (h0 > 0.0f && h0 < h1) ? h0 : h1;
  const float ndd = ((r.ox + r.dx * h) - a.x) * r.dx
                    + ((r.oy + r.dy * h) - a.y) * r.dy
                    + ((r.oz + r.dz * h) - a.z) * r.dz;
  up = ndd < 0.0f;
  return (disc > 0.0f && h > 0.0f && ndd != 0.0f) ? h : FARAWAY;
}

// intersect_planes; (center, half_w), (normal, half_h), (u_axis, 0),
// (v_axis, 0)
__device__ __forceinline__ float isect_plane(const float4* o, const Ray& r,
                                             bool& up) {
  const float4 a = o[0], b = o[1], c = o[2], d = o[3];
  float ndd = b.x * r.dx + b.y * r.dy + b.z * r.dz;
  ndd = ndd == 0.0f ? ndd + 0.0001f : ndd;
  const float cx = a.x - r.ox, cy = a.y - r.oy, cz = a.z - r.oz;
  const float ndco = b.x * cx + b.y * cy + b.z * cz;
  const float t = ndco / ndd;
  const float mx = (r.ox + r.dx * t) - a.x, my = (r.oy + r.dy * t) - a.y,
              mz = (r.oz + r.dz * t) - a.z;
  const float u = c.x * mx + c.y * my + c.z * mz;
  const float v = d.x * mx + d.y * my + d.z * mz;
  up = ndd < 0.0f;
  return (fabsf(u) <= a.w && fabsf(v) <= b.w && ndco * ndd > 0.0f) ? fabsf(t)
                                                                   : FARAWAY;
}

// intersect_boxes: the slab test in the box's basis; (basis row i,
// lb_local[i]) for i = 0, 1, 2, then (rt_local, 0)
__device__ __forceinline__ float isect_box(const float4* o, const Ray& r,
                                           bool& up) {
  const float4 d = o[3];
  const float rt[3] = {d.x, d.y, d.z};
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 row = o[i];
    const float o_l = row.x * r.ox + row.y * r.oy + row.z * r.oz;
    const float d_l = row.x * r.dx + row.y * r.dy + row.z * r.dz;
    const float frac = 1.0f / d_l;
    const float t_lo = (row.w - o_l) * frac;
    const float t_hi = (rt[i] - o_l) * frac;
    const float lo = t_min(t_lo, t_hi), hi = t_max(t_lo, t_hi);
    tmin = i == 0 ? lo : t_max(tmin, lo);
    tmax = i == 0 ? hi : t_min(tmax, hi);
  }
  const bool miss = tmax < 0.0f || tmin > tmax;
  const bool inside = tmin < 0.0f;
  up = !inside;
  return miss ? FARAWAY : (inside ? tmax : tmin);
}

// intersect_discs; (center, r_out * r_out), (normal, r_in * r_in)
__device__ __forceinline__ float isect_disc(const float4* o, const Ray& r,
                                            bool& up) {
  const float4 a = o[0], b = o[1];
  float ndd = b.x * r.dx + b.y * r.dy + b.z * r.dz;
  ndd = ndd == 0.0f ? ndd + 0.0001f : ndd;
  const float cx = a.x - r.ox, cy = a.y - r.oy, cz = a.z - r.oz;
  const float ndco = b.x * cx + b.y * cy + b.z * cz;
  const float t = ndco / ndd;
  const float mx = (r.ox + r.dx * t) - a.x, my = (r.oy + r.dy * t) - a.y,
              mz = (r.oz + r.dz * t) - a.z;
  const float rho2 = mx * mx + my * my + mz * mz;
  up = ndd < 0.0f;
  return (rho2 <= a.w && rho2 >= b.w && ndco * ndd > 0.0f) ? fabsf(t)
                                                          : FARAWAY;
}

// intersect_cylinders, in the cylinder's frame (x along u_axis, y along
// the axis, z along v_axis); (u_axis, off(u_axis)), (axis, off(axis)),
// (v_axis, off(v_axis)), (radius * radius, half_h, capped, 0)
__device__ __forceinline__ float isect_cylinder(const float4* o, const Ray& r,
                                                bool& up) {
  const float4 a = o[0], b = o[1], c = o[2], d = o[3];
  const float ox = (a.x * r.ox + a.y * r.oy + a.z * r.oz) - a.w;
  const float oy = (b.x * r.ox + b.y * r.oy + b.z * r.oz) - b.w;
  const float oz = (c.x * r.ox + c.y * r.oy + c.z * r.oz) - c.w;
  const float dx = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const float dy = b.x * r.dx + b.y * r.dy + b.z * r.dz;
  const float dz = c.x * r.dx + c.y * r.dy + c.z * r.dz;
  const float r2 = d.x, hh = d.y;
  const bool cap_on = d.z > 0.5f;

  const float aa = dx * dx + dz * dz;
  const float a_s = aa < 1e-12f ? 1e-12f : aa;
  const float hb = ox * dx + oz * dz;
  const float cc = (ox * ox + oz * oz) - r2;
  const float disc = hb * hb - a_s * cc;
  const float sq = safe_sqrt(disc);
  const float t0 = (-hb - sq) / a_s;
  const float t1 = (-hb + sq) / a_s;
  const bool side_ok = disc > 0.0f;
  const bool v0 = side_ok && t0 > 0.0f && fabsf(oy + dy * t0) <= hh;
  const bool v1 = side_ok && t1 > 0.0f && fabsf(oy + dy * t1) <= hh;
  const float dy_s = fabsf(dy) < 1e-12f ? 1e-12f : dy;
  const float t_top = (hh - oy) / dy_s;
  const float xt = ox + dx * t_top, zt = oz + dz * t_top;
  const bool v_top = cap_on && t_top > 0.0f && xt * xt + zt * zt <= r2;
  const float t_bot = (-hh - oy) / dy_s;
  const float xb = ox + dx * t_bot, zb = oz + dz * t_bot;
  const bool v_bot = cap_on && t_bot > 0.0f && xb * xb + zb * zb <= r2;
  float t = v0 ? t0 : FARAWAY;
  t = t_min(t, v1 ? t1 : FARAWAY);
  t = t_min(t, v_top ? t_top : FARAWAY);
  t = t_min(t, v_bot ? t_bot : FARAWAY);

  const float x = ox + dx * t, y = oy + dy * t, z = oz + dz * t;
  const float rho_hat = safe_sqrt((x * x + z * z) / r2);
  const bool is_cap = cap_on && fabsf(y) / hh >= rho_hat;
  const float nd = is_cap ? t_sign(y) * dy : x * dx + z * dz;
  up = nd < 0.0f;
  return t;
}

template <int KIND>
__device__ __forceinline__ float isect(const float4* o, const Ray& r, bool& up) {
  if constexpr (KIND == 0) return isect_sphere(o, r, up);
  else if constexpr (KIND == 1) return isect_plane(o, r, up);
  else if constexpr (KIND == 2) return isect_box(o, r, up);
  else if constexpr (KIND == 3) return isect_disc(o, r, up);
  else return isect_cylinder(o, r, up);
}

// A ray's running best, and the candidate of the plain loop's block of
// objects that it is in: the block's first minimum below FARAWAY (a block
// with none cannot win), whether a NaN was met, and the block's end.
struct Nearest {
  float t;
  bool up;
  int id;
  float blk_t;
  bool blk_up, blk_nan;
  int blk_id, blk_end;
};

// The objects [j0, j1) of kind KIND (first object id ks, end ke, B
// objects a block), from the staged rows of the chunk that starts at c0.
template <int KIND>
__device__ __forceinline__ void nearest_kind(const float4* rows, int c0, int j0,
                                             int j1, int ks, int ke, int B,
                                             const Ray& r, Nearest& s) {
  if (j0 == ks && j0 < j1) s.blk_end = min(ks + B, ke);   // the kind's start
#pragma unroll 1
  for (int j = j0; j < j1; ++j) {
    bool up;
    const float t = isect<KIND>(rows + 4 * (j - c0), r, up);
    if (t != t) {
      s.blk_nan = true;
    } else if (t < s.blk_t) {
      s.blk_t = t;
      s.blk_up = up;
      s.blk_id = j;
    }
    if (j + 1 == s.blk_end) {           // the block's last object
      if (!s.blk_nan && s.blk_t < s.t) {
        s.t = s.blk_t;
        s.up = s.blk_up;
        s.id = s.blk_id;
      }
      s.blk_t = FARAWAY;
      s.blk_nan = false;
      s.blk_end = min(s.blk_end + B, ke);
    }
  }
}

// Whether an object of [j0, j1) of kind KIND lies nearer than md (the
// table holds the casting objects alone).
template <int KIND>
__device__ __forceinline__ bool occluded_kind(const float4* rows, int c0,
                                              int j0, int j1, const Ray& r,
                                              float md) {
#pragma unroll 1
  for (int j = j0; j < j1; ++j) {
    bool up;
    if (isect<KIND>(rows + 4 * (j - c0), r, up) < md) return true;
  }
  return false;
}

// rows [c0, c1) of the object table into shared memory, by the block
__device__ __forceinline__ void stage(float4* rows, const float4* objs, int c0,
                                      int c1) {
  for (int k = threadIdx.x; k < 4 * (c1 - c0); k += SWEEP_BLOCK)
    rows[k] = objs[4 * c0 + k];
}

__device__ __forceinline__ Ray load_ray(const float* O, const float* D,
                                        long long i) {
  return {O[3 * i], O[3 * i + 1], O[3 * i + 2],
          D[3 * i], D[3 * i + 1], D[3 * i + 2]};
}

// The part of kind k in the chunk [c0, c1): [j0, j1), empty if j0 >= j1.
#define KIND_RANGE(k)                                          \
  const int j0_##k = K.start[k] > c0 ? K.start[k] : c0;        \
  const int j1_##k = K.start[k + 1] < c1 ? K.start[k + 1] : c1

__global__ void __launch_bounds__(SWEEP_BLOCK)
analytic_nearest_kernel(const float4* objs, Kinds K, int B, const float* O,
                        const float* D, long long n, float* t_out,
                        float* orient, long long* id_out) {
  __shared__ float4 rows[4 * CHUNK];
  const int n_obj = K.start[KINDS];
  const bool resident = n_obj <= CHUNK;     // one chunk, staged once
  if (resident) {
    stage(rows, objs, 0, n_obj);
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * SWEEP_BLOCK;
  for (long long base = (long long)blockIdx.x * SWEEP_BLOCK; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool live = i < n;
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (live) r = load_ray(O, D, i);
    Nearest s = {FARAWAY, true, 0, FARAWAY, true, false, 0, 0};
    for (int c0 = 0; c0 < n_obj; c0 += CHUNK) {
      const int c1 = min(c0 + CHUNK, n_obj);
      if (!resident) {
        __syncthreads();                    // the last chunk is read
        stage(rows, objs, c0, c1);
        __syncthreads();
      }
      if (!live) continue;
      KIND_RANGE(0);
      KIND_RANGE(1);
      KIND_RANGE(2);
      KIND_RANGE(3);
      KIND_RANGE(4);
      nearest_kind<0>(rows, c0, j0_0, j1_0, K.start[0], K.start[1], B, r, s);
      nearest_kind<1>(rows, c0, j0_1, j1_1, K.start[1], K.start[2], B, r, s);
      nearest_kind<2>(rows, c0, j0_2, j1_2, K.start[2], K.start[3], B, r, s);
      nearest_kind<3>(rows, c0, j0_3, j1_3, K.start[3], K.start[4], B, r, s);
      nearest_kind<4>(rows, c0, j0_4, j1_4, K.start[4], K.start[5], B, r, s);
    }
    if (live) {
      t_out[i] = s.t;
      orient[i] = s.up ? 1.0f : -1.0f;
      id_out[i] = s.id;
    }
  }
}

// The shadow ray i: its origin, and its direction and max_dist, or the
// one direction (d_step 0) and max_dist (md_step 0) that every ray shares,
// from `uni` (shared memory).
struct Shadow {
  Ray r;
  float md;
};

__device__ __forceinline__ Shadow load_shadow(const float* O, const float* D,
                                              int d_step, const float* max_dist,
                                              int md_step, const float* uni,
                                              long long i) {
  Shadow s;
  s.r.ox = O[3 * i];
  s.r.oy = O[3 * i + 1];
  s.r.oz = O[3 * i + 2];
  if (d_step) {
    s.r.dx = D[3 * i];
    s.r.dy = D[3 * i + 1];
    s.r.dz = D[3 * i + 2];
  } else {
    s.r.dx = uni[0];
    s.r.dy = uni[1];
    s.r.dz = uni[2];
  }
  s.md = md_step ? max_dist[i] : uni[3];
  return s;
}

__global__ void __launch_bounds__(SWEEP_BLOCK)
analytic_occluded_kernel(const float4* objs, Kinds K, const float* O,
                         const float* D, int d_step, long long n,
                         const float* max_dist, int md_step,
                         unsigned char* occ) {
  __shared__ float4 rows[4 * CHUNK];
  __shared__ float uni[4];              // the uniform direction and max_dist
  const int n_obj = K.start[KINDS];
  if (threadIdx.x < 3) uni[threadIdx.x] = D[threadIdx.x];
  if (threadIdx.x == 3) uni[3] = max_dist[0];
  const long long first = (long long)blockIdx.x * SWEEP_BLOCK + threadIdx.x;
  const long long stride = (long long)gridDim.x * SWEEP_BLOCK;
  for (int c0 = 0; c0 < n_obj; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, n_obj);
    if (c0 > 0) __syncthreads();        // the last chunk is read
    stage(rows, objs, c0, c1);
    __syncthreads();
    KIND_RANGE(0);
    KIND_RANGE(1);
    KIND_RANGE(2);
    KIND_RANGE(3);
    KIND_RANGE(4);
    for (long long i = first; i < n; i += stride) {
      if (c0 > 0 && occ[i]) continue;   // occluded by an earlier chunk
      const Shadow s = load_shadow(O, D, d_step, max_dist, md_step, uni, i);
      occ[i] = occluded_kind<0>(rows, c0, j0_0, j1_0, s.r, s.md)
               || occluded_kind<1>(rows, c0, j0_1, j1_1, s.r, s.md)
               || occluded_kind<2>(rows, c0, j0_2, j1_2, s.r, s.md)
               || occluded_kind<3>(rows, c0, j0_3, j1_3, s.r, s.md)
               || occluded_kind<4>(rows, c0, j0_4, j1_4, s.r, s.md);
    }
  }
}

#undef KIND_RANGE

Kinds kinds_of(int n_sph, int n_pla, int n_box, int n_dsc, int n_cyl) {
  const int counts[KINDS] = {n_sph, n_pla, n_box, n_dsc, n_cyl};
  Kinds K;
  K.start[0] = 0;
  for (int k = 0; k < KINDS; ++k) K.start[k + 1] = K.start[k] + counts[k];
  return K;
}

bool counts_ok(int n_sph, int n_pla, int n_box, int n_dsc, int n_cyl) {
  return n_sph >= 0 && n_pla >= 0 && n_box >= 0 && n_dsc >= 0 && n_cyl >= 0
         && n_sph + n_pla + n_box + n_dsc + n_cyl > 0;
}

// A grid of at most the card's resident blocks (the threads loop over the
// rays), at least one block, no more than the rays need.
template <class F>
cudaError_t grid_for(F kernel, long long n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        SWEEP_BLOCK, 0);
  if (err != cudaSuccess) return err;
  const long long need = (n + SWEEP_BLOCK - 1) / SWEEP_BLOCK;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(need < most ? need : most);
  return cudaSuccess;
}

}  // namespace

// objs: (objects, 16) float32, 16-byte aligned, in object-id order (the
// wrapper's object_table); n_sph ... n_cyl: the objects of each kind; B:
// objects a block of the plain loop (its tie and NaN rule); O, D: (n, 3)
// float32; t, orient: (n,) float32; id: (n,) int64.
extern "C" int analytic_nearest(const float* objs, int n_sph, int n_pla,
                                int n_box, int n_dsc, int n_cyl, int B,
                                const float* O, const float* D, long long n,
                                float* t, float* orient, long long* id,
                                void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (n < 1 || B < 1 || !counts_ok(n_sph, n_pla, n_box, n_dsc, n_cyl))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_for(analytic_nearest_kernel, n, &grid);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(analytic_nearest_kernel, grid, SWEEP_BLOCK, 0, st,
         reinterpret_cast<const float4*>(objs),
         kinds_of(n_sph, n_pla, n_box, n_dsc, n_cyl), B, O, D, n, t, orient,
         id);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// As analytic_nearest, over the casting objects alone (objs and the counts
// of each kind: the wrapper's casting_tables), with D: (n, 3) float32 by
// ray (d_step 1) or one row for every ray (d_step 0), max_dist: (n,)
// float32 likewise (md_step), occ: (n,) bool.
extern "C" int analytic_occluded(const float* objs, int n_sph, int n_pla,
                                 int n_box, int n_dsc, int n_cyl,
                                 const float* O, const float* D, int d_step,
                                 long long n, const float* max_dist,
                                 int md_step, unsigned char* occ,
                                 void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (n < 1 || !counts_ok(n_sph, n_pla, n_box, n_dsc, n_cyl)
      || (d_step != 0 && d_step != 1) || (md_step != 0 && md_step != 1))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_for(analytic_occluded_kernel, n, &grid);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(analytic_occluded_kernel, grid, SWEEP_BLOCK, 0, st,
         reinterpret_cast<const float4*>(objs),
         kinds_of(n_sph, n_pla, n_box, n_dsc, n_cyl), O, D, d_step, n,
         max_dist, md_step, occ);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
