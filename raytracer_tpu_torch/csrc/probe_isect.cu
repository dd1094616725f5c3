// Intersection-test cost probe for Hopper (sm_90a): the nearest-hit loop
// of the render kernels (trace_common.cuh `nearest_hit`, the same code the
// solid and record kernels inline) over a table of objects of one kind,
// one thread per ray, the table staged in shared memory once per block as
// those kernels stage it.
//
// probes/isect_cost.py times it over a table and over no objects; the
// difference, per test, is what one test of that kind costs as the render
// kernels run it, and is held against the hand count of probes/roofline.py
// (SLOTS isect_<kind> + nearest_select).  The plain version is
// ops/solid_trace.py `nearest_hit`; kernel and plain version agree bit for
// bit (IEEE division and sqrt, --fmad=false, as the render kernels).
//
// The render kernels take axis-aligned planes through the generic plane
// formula.  The component-selection form they took before (the plain
// version's `_isect_plane(..., aa=...)`, the same bits) is kept here as
// `isect_plane_select`, run when the launch asks for it, so that the two
// forms' costs can be compared in one run.
//
// What bounds it on the card: instruction issue; each thread reads six
// floats and writes three words.  Every entry returns cudaGetLastError()
// after its launch.

#include "trace_common.cuh"

// (GEOM_COLS + OBJ_COLS) * 4 bytes an object: 256 objects fit the 48 KB
// of shared memory a block gets without opting in
constexpr int MAX_OBJ = 256;

namespace {

// a plane with an axis-aligned frame by component selection: the register
// arrays o, d and c indexed by the frame's run-time axes
__device__ __forceinline__ void isect_plane_select(const float* g, const int* rec,
                                                   const float o[3], const float d[3],
                                                   float& t, float& orient) {
  const float c[3] = {g[0], g[1], g[2]};
  const int nax = rec[OBJ_AA_N], uax = rec[OBJ_AA_U], vax = rec[OBJ_AA_V];
  const bool pos = rec[OBJ_AA_NSIGN] > 0;
  float ndd = pos ? d[nax] : -d[nax];
  if (ndd == 0.0f) ndd = ndd + F(1e-4);
  const float ndco = pos ? (c[nax] - o[nax]) : (o[nax] - c[nax]);
  const float tt = ndco / ndd;
  const float uu = o[uax] + d[uax] * tt - c[uax];
  const float vv = o[vax] + d[vax] * tt - c[vax];
  const bool inside = fabsf(uu) <= g[12] && fabsf(vv) <= g[13] && ndco * ndd > 0.0f;
  t = inside ? tt : FARAWAY;
  orient = ndd < 0.0f ? 1.0f : -1.0f;
}

template <bool SELECT>
__device__ __forceinline__ void isect_rays(
    const float* geom, const int* obj, int n_obj, const float* rays,
    float* t_out, float* orient_out, int* id_out, long long n) {
  extern __shared__ float smem[];
  float* s_geom = smem;
  int* s_obj = reinterpret_cast<int*>(s_geom + n_obj * GEOM_COLS);
  for (int i = threadIdx.x; i < n_obj * GEOM_COLS; i += BLOCK) s_geom[i] = geom[i];
  for (int i = threadIdx.x; i < n_obj * OBJ_COLS; i += BLOCK) s_obj[i] = obj[i];
  __syncthreads();
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  // rays: (6, n), origin then direction
  const float o[3] = {rays[i], rays[n + i], rays[2 * n + i]};
  const float d[3] = {rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
  float t, orient;
  int hit_id;
  if (SELECT) {
    // nearest_hit with the selection form for axis-aligned planes
    t = FARAWAY;
    orient = 1.0f;
    hit_id = -1;
    for (int j = 0; j < n_obj; ++j) {
      const float* g = s_geom + j * GEOM_COLS;
      const int* rec = s_obj + j * OBJ_COLS;
      float t_j, o_j;
      if (rec[OBJ_KIND] == KIND_PLANE && rec[OBJ_AA_N] >= 0)
        isect_plane_select(g, rec, o, d, t_j, o_j);
      else
        isect_object(g, rec, o, d, t_j, o_j);
      if (t_j < t) { t = t_j; orient = o_j; hit_id = j; }
    }
  } else {
    nearest_hit(s_geom, s_obj, n_obj, o, d, t, orient, hit_id);
  }
  t_out[i] = t;
  orient_out[i] = orient;
  id_out[i] = hit_id;
}

}  // namespace

extern "C" __global__ void __launch_bounds__(BLOCK) probe_isect_kernel(
    const float* geom, const int* obj, int n_obj, const float* rays,
    float* t_out, float* orient_out, int* id_out, long long n) {
  isect_rays<false>(geom, obj, n_obj, rays, t_out, orient_out, id_out, n);
}

extern "C" __global__ void __launch_bounds__(BLOCK) probe_isect_select_kernel(
    const float* geom, const int* obj, int n_obj, const float* rays,
    float* t_out, float* orient_out, int* id_out, long long n) {
  isect_rays<true>(geom, obj, n_obj, rays, t_out, orient_out, id_out, n);
}

// geom: (n_obj, GEOM_COLS) f32, obj: (n_obj, OBJ_COLS) i32, rays: (6, n)
// f32; t, orient: (n,) f32, id: (n,) i32, all device pointers; select:
// 1 for the selection form of axis-aligned planes
extern "C" int probe_isect_launch(const float* geom, const int* obj, int n_obj,
                                  const float* rays, float* t, float* orient,
                                  int* id, long long n, int select, void* stream) {
  if (n_obj < 0 || n_obj > MAX_OBJ || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_obj * (GEOM_COLS + OBJ_COLS) * sizeof(float);
  const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (select)
    probe_isect_select_kernel<<<grid, BLOCK, smem, st>>>(geom, obj, n_obj, rays, t,
                                                         orient, id, n);
  else
    probe_isect_kernel<<<grid, BLOCK, smem, st>>>(geom, obj, n_obj, rays, t, orient,
                                                  id, n);
  return (int)cudaGetLastError();
}
