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
// What bounds it on the card: instruction issue; each thread reads six
// floats and writes three words.  Every entry returns cudaGetLastError()
// after its launch.

#include "trace_common.cuh"

// (GEOM_COLS + OBJ_COLS) * 4 bytes an object: 256 objects fit the 48 KB
// of shared memory a block gets without opting in
constexpr int MAX_OBJ = 256;

extern "C" __global__ void __launch_bounds__(BLOCK) probe_isect_kernel(
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
  nearest_hit(s_geom, s_obj, n_obj, o, d, t, orient, hit_id);
  t_out[i] = t;
  orient_out[i] = orient;
  id_out[i] = hit_id;
}

// geom: (n_obj, GEOM_COLS) f32, obj: (n_obj, OBJ_COLS) i32, rays: (6, n)
// f32; t, orient: (n,) f32, id: (n,) i32, all device pointers
extern "C" int probe_isect_launch(const float* geom, const int* obj, int n_obj,
                                  const float* rays, float* t, float* orient,
                                  int* id, long long n, void* stream) {
  if (n_obj < 0 || n_obj > MAX_OBJ || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_obj * (GEOM_COLS + OBJ_COLS) * sizeof(float);
  const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  probe_isect_kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      geom, obj, n_obj, rays, t, orient, id, n);
  return (int)cudaGetLastError();
}
