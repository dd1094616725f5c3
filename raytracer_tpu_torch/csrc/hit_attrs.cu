// W5: the wavefront's hit attributes for Hopper (sm_90a).
//
// Replaces the attribute stage of the JAX package's wavefront
// (raytracer_tpu/core/integrator.py:221-236: raytracer_tpu/geometry/
// attrs.py:245 `hit_attributes`, the orientation, the packed material
// word's decode and the scale-aware nudge; the normal maps,
// raytracer_tpu/core/integrator.py:120 `_apply_normal_maps`, with the
// tangents of raytracer_tpu/core/compile.py:1403-1420).  That stage has
// no Pallas kernel: it is jnp, which XLA fuses into one pass on the TPU.
// Eager torch cannot fuse it, so the port's plain version
// (ops/hit_attrs.py `plain_attributes`) runs every present kind's formula
// over the whole wavefront on clamped ids and merges the kinds by
// torch.where: some 100 launches a bounce, each a pass over device memory,
// and some 165 more where the scene maps normals.  On Cornell rendered
// on the wavefront it took nearly half a frame's device time (PERF.md).
// Here one thread computes one ray's attributes, for its own object's
// kind only, in registers.  The wrapper is in ops/hit_attrs.py.
//
// Each ray reads its origin, direction, hit distance, orientation and
// object id (0 on a miss: a miss takes object 0's attributes at
// P = O + D t, as the plain stage gives it) and writes P, the shading
// normal (the geometric one, normal-mapped where the scene maps its
// object, times the orientation), uv (zero unless the scene samples it or
// the caller asks), miss, the packed word and its four fields, and the
// nudge offset.  The scene comes as data: the analytic objects as one
// (objects, 16) float table in object-id order, made once per geometry by
// the wrapper (`attr_table`), the triangle, corner, instance and packed
// tables by pointer, and the normal maps as a row a ref (`map_tables`):
// its object, basis kind and local id, its texture's descriptor in
// csrc/texture_fetch.cuh's `Textures` form, a plane's or a box's basis;
// the triangles' tangents, their signs and map slots by pointer.  One
// build serves every scene; scenes with maps take the kernel's MAPS
// instance, the others keep the instance without the map code.  The
// first-hit pass (core/ray.py `_first_hit_impl`) takes the same kernel
// with P, N and uv zero on a miss and the geometric normal, unmapped and
// unoriented.
//
// The maps: the plain stage computes every ref's mapped normal Nm over
// every ray and keeps it by torch.where where the ref's mask holds, so the
// last ref whose mask holds wins.  Here a ray looks for that ref from the
// last back (the mask: its object is the ref's, or, for a mesh ref, a
// triangle whose map slot is the ref's), computes that ref's Nm alone from
// the geometric normal, and then orients it.  The texel comes through
// texture_fetch.cuh `fetch_texture`, W4's and W6's fetch (a miss on a
// mapped object 0 fetches at its far uv, with the card's saturating
// float -> int32 conversion, as torch's).
//
// Arithmetic is the plain stage's, operation by operation in its order,
// as torch computes each op on the card (the library is built with
// --fmad=false and IEEE division and square root), so the two agree bit
// for bit:
// - a product or a sum is one rounding; the plain dot products (`_dot`)
//   are summed x + y + z; `safemath.div` / `rdiv` and every division of
//   the stage are true divisions;
// - torch.sum over a last dimension of 3 (safe_norm's, for smooth
//   triangle normals) adds ((0 + x0) + (0 + x2)) + (0 + x1), ATen's
//   reduction order for k = 3 (csrc/wavefront_shade.cu, `tsum3`);
// - torch.clamp / clamp_min return a NaN operand and otherwise fmaxf /
//   fminf; torch.amax carries a NaN; torch.sign is (0 < x) - (x < 0), +0
//   for -0 and for NaN; comparisons against a Python number compare
//   against its float;
// - torch.atan2 and torch.asin are libdevice's atan2f and asinf
//   (scripts/torch_op_rounding.py holds them against torch on the card,
//   asin on all 2^32 floats; chip_smoke.py holds this file's own);
// - the maps' (N, 3) @ (3, 3) product (a plane's or a box's basis) is
//   cuBLAS on the card and MKL on the CPU; both sum each row as
//   fma(a2, b2, fma(a1, b1, fma(a0, b0, 0))) (`mm3`;
//   scripts/torch_op_rounding.py --only matmul3: from 17 rows on the card,
//   from 11 on the CPU; fewer rows take other kernels, and no render's
//   wavefront is that small), the one fused op of this file;
// - x ** 2 is x * x;
// - every constant is the float of the plain stage's Python double.
// Built by the CPU tests with W5_TORCH_CPU (tests/test_torch_hit_attrs_
// emu.py), the source restates torch's CPU ops instead: its sum of three
// in order, atan2 and asin through float64, as the tests run the plain
// stage (the 3 x 3 product needs no variant).
//
// What bounds it: memory.  A ray reads 40 bytes and writes 54; its
// arithmetic (a few tens of issue slots, a few hundred for a sphere's or
// a cylinder's uv or a mapped normal) is a fraction of that at 3.35 TB/s
// against 33.5 T slots/s.  The tables, the maps' texels among them, are
// small beside the rays and stay in cache.
//
// The backward (`hit_attrs_bwd`, below): the gradients of the rays' O, D
// and t from those of P, N, uv and eps, for a scene without normal maps
// (or the first-hit pass) whose tables take no gradient, as the JAX
// package's jax.grad takes the stage's VJP (raytracer_tpu/diff.py) and
// XLA fuses it.  One thread a ray runs every present kind's backward, as
// the plain VJP does (the other kinds with +0 gradients), and adds the
// contributions in autograd's order.  Memory bounds it too: a ray reads
// its 44 bytes of O, D, t, object and orientation and up to 32 of output
// gradients and writes 28; the kinds' formulas are a few hundred issue
// slots at most.
//
// Every entry returns cudaGetLastError() after its launch and reports the
// kernels it launched.

#include <cuda_runtime.h>

#include <math.h>

#include "texture_fetch.cuh"

#ifndef CUDA_EMU
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace w5 {

constexpr int ATTR_BLOCK = 256;       // threads a block
constexpr int ROW = 16;               // floats a row of the analytic table
constexpr int KINDS = 6;              // sphere, plane, box, disc, cylinder, triangle
constexpr int SLOT_SHIFT = 3, DEPTH_SHIFT = 13, MC_SHIFT = 23;

// the maps' basis kinds (ops/hit_attrs.py MAP_KINDS)
constexpr int MAP_SPHERE = 0, MAP_PLANE = 1, MAP_BOX = 2, MAP_TRI = 3;

// the float of each Python double the plain stage uses
#define F32(x) ((float)(x))
#define PI_F F32(3.141592653589793)             // math.pi
#define TWO_PI_F F32(6.283185307179586)           // 2.0 * math.pi
#define HALF_PI_F F32(1.5707963267948966)         // math.pi / 2.0

// ---------------------------------------------------------------------------
// torch's ops, as the card (or, under W5_TORCH_CPU, the CPU) computes them
// ---------------------------------------------------------------------------
#ifdef W5_TORCH_CPU
__device__ __forceinline__ float t_atan2(float y, float x) {
  return (float)atan2((double)y, (double)x);
}
__device__ __forceinline__ float t_asin(float x) { return (float)asin((double)x); }
#else
__device__ __forceinline__ float t_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ float t_asin(float x) { return asinf(x); }
#endif

// torch.sum(x, dim=-1) over a last dimension of 3
__device__ __forceinline__ float tsum3(float x0, float x1, float x2) {
#ifdef W5_TORCH_CPU
  return ((0.0f + x0) + x1) + x2;
#else
  return ((0.0f + x0) + (0.0f + x2)) + (0.0f + x1);
#endif
}

__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float t_clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
// torch.amax of three: the largest, or NaN where one is NaN
__device__ __forceinline__ float t_max3(float a, float b, float c) {
  if (a != a || b != b || c != c) return a + b + c;
  return fmaxf(fmaxf(a, b), c);
}
__device__ __forceinline__ float t_sign(float x) {
  return (float)((0.0f < x) - (x < 0.0f));
}

// geometry/attrs.py _dot: a0 * b0 + a1 * b1 + a2 * b2, left to right
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// core/safemath.py safe_norm(v, dim=-1): safe_sqrt(torch.sum(v * v, -1))
__device__ __forceinline__ float safe_norm3(const float* v) {
  const float s = tsum3(v[0] * v[0], v[1] * v[1], v[2] * v[2]);
  return s > 0.0f ? sqrtf(t_clamp_min(s, F32(1e-30))) : 0.0f;
}

__device__ __forceinline__ void load3(const float* p, long long i, float* v) {
  v[0] = __ldg(p + 3 * i);
  v[1] = __ldg(p + 3 * i + 1);
  v[2] = __ldg(p + 3 * i + 2);
}

// ---------------------------------------------------------------------------
// the scene and the rays
// ---------------------------------------------------------------------------

// The scene as W5 reads it (ops/hit_attrs.py builds it).  rows: the
// analytic objects, (sum of counts[0..4], 16) float32 in object-id order
// (`attr_table`):
// - sphere: (center, radius);
// - plane: (center, half_w), (normal, half_h), (u_axis, uv_shift[0]),
//   (v_axis, uv_shift[1]);
// - box: (basis row i, whl[i]) for i = 0, 1, 2, (center, 0);
// - disc: (center, r_out), (normal, 0), (u_axis, 0), (v_axis, 0);
// - cylinder: (center, radius), (axis, half_h), (u_axis, capped),
//   (v_axis, 0).
// counts: object ids of each kind (KINDS order; triangles virtual under
// instances).  The triangle rows: (T, 3) p1, p2, p3 and the face normal;
// corner normals and uvs (T, 3) / (T, 2), or null; virt_row / virt_inst
// (V,) int32 mapping a virtual id to its row and instance, or null; the
// instances' (I, 3, 3) rotation, (I, 3) translation and (I,) inverse
// scale.  packed: (n_obj,) int32 material words.  The normal maps
// (n_maps 0 without), a row a ref in SceneStatic.normal_maps order:
// map_i (n_maps, 4) int32 (object id, -1 for a mesh ref; basis kind
// MAP_*; local id, a mesh ref's map slot; 0); map_basis (n_maps, 9) float32,
// a plane's or a box's M, row-major, with Nm = (2 m) M (a plane's rows its
// u axis, v axis and normal; a box's its basis); map_tex the refs'
// textures, descriptor row r ref r's; tri_tan (tan_rows, 3), tri_tan_sign
// (tan_rows,) float32, tri_nm_slot (tan_rows,) int32, or null without a
// mesh ref.
struct Scene {
  const float* rows;
  long long counts[KINDS];
  const float *tri_p1, *tri_p2, *tri_p3, *tri_normal;
  const float *vn1, *vn2, *vn3, *uv1, *uv2, *uv3;
  const int *virt_row, *virt_inst;
  const float *inst_rot, *inst_trans, *inst_inv_scale;
  const int* packed;
  long long n_obj;
  long long n_maps;
  const int* map_i;
  const float* map_basis;
  texture_fetch::Textures map_tex;
  const float *tri_tan, *tri_tan_sign;
  const int* tri_nm_slot;
  long long tan_rows;
};

// The rays: O, D (n, 3), t, orient (n,) float32 (orient read unless
// first_hit), obj (n,) int64; the outputs, each contiguous: P, N (n, 3),
// uv (n, 2), eps (n,) float32, miss, mc (n,) bool, packed, mat_type,
// mat_slot, max_depth (n,) int32.  need_uv: write uv (else zeros);
// first_hit: the first-hit pass, the geometric normal (no map, no
// orientation) and P, N and uv zero on a miss; else N mapped and times
// orient; nudge: settings.nudge_eps; miss_at: MISS_THRESHOLD's float.
struct Rays {
  const float *O, *D, *t, *orient;
  const long long* obj;
  long long n;
  int need_uv, first_hit;
  float nudge, miss_at;
  float *P, *N, *uv, *eps;
  unsigned char *miss, *mc;
  int *packed, *mat_type, *mat_slot, *max_depth;
};

// ---------------------------------------------------------------------------
// each kind's formula (geometry/attrs.py), at the hit P of object `row`
// ---------------------------------------------------------------------------

// the four float4 words of analytic row r
__device__ __forceinline__ void row_words(const float* rows, long long r, float* w) {
  const float4* p = reinterpret_cast<const float4*>(rows + r * ROW);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 q = __ldg(p + k);
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
}

// attrs.py sphere_attrs: (P - c) / r; uv from atan2 and asin
__device__ __forceinline__ void sphere(const float* w, const float* P, bool need_uv,
                                       float* N, float* uv) {
  for (int c = 0; c < 3; ++c) N[c] = (P[c] - w[c]) / w[3];
  if (!need_uv) return;
  const float phi = t_atan2(N[2], N[0]);
  const float theta = t_asin(t_clamp(N[1], -1.0f, 1.0f));
  uv[0] = (phi + PI_F) / TWO_PI_F;
  uv[1] = (theta + HALF_PI_F) / PI_F;
}

// attrs.py plane_attrs: the normal; planar uv with uv_shift
__device__ __forceinline__ void plane(const float* w, const float* P, bool need_uv,
                                      float* N, float* uv) {
  for (int c = 0; c < 3; ++c) N[c] = w[4 + c];
  if (!need_uv) return;
  float M[3];
  for (int c = 0; c < 3; ++c) M[c] = P[c] - w[c];
  uv[0] = (dot3(w + 8, M) / w[3] + 1.0f) / 2.0f + w[11];
  uv[1] = (dot3(w + 12, M) / w[7] + 1.0f) / 2.0f + w[15];
}

// attrs.py box_attrs: the face by the largest scaled local coordinate
// (every face where they tie), and the 4 x 3 cube-cross uv
__device__ __forceinline__ void box(const float* w, const float* P, bool need_uv,
                                    float* N, float* uv) {
  float M[3], Pl[3], a[3], Nl[3];
  for (int c = 0; c < 3; ++c) M[c] = P[c] - w[12 + c];
  for (int i = 0; i < 3; ++i) Pl[i] = dot3(w + 4 * i, M);
  for (int i = 0; i < 3; ++i) a[i] = fabsf(Pl[i]) / w[4 * i + 3];
  const float Pmax = t_max3(a[0], a[1], a[2]);
  for (int i = 0; i < 3; ++i) Nl[i] = Pmax == a[i] ? t_sign(Pl[i]) : 0.0f;
  for (int c = 0; c < 3; ++c)
    N[c] = (w[c] * Nl[0] + w[4 + c] * Nl[1]) + w[8 + c] * Nl[2];
  if (!need_uv) return;
  const float s = F32(2.0 * 0.985) / w[3];
  auto half = [&](float x) { return (x * s + 1.0f) / 2.0f; };
  const float wd = Pl[0], hd = Pl[1], ld = Pl[2];
  float u = 0.0f, v = 0.0f;
  // jnp.select: the first face whose condition holds
  if (Nl[1] == -1.0f) {
    u = half(wd) + 1.0f;
    v = half(-ld) + 0.0f;
  } else if (Nl[1] == 1.0f) {
    u = half(wd) + 1.0f;
    v = half(ld) + 2.0f;
  } else if (Nl[0] == 1.0f) {
    u = half(ld) + 2.0f;
    v = half(hd) + 1.0f;
  } else if (Nl[0] == -1.0f) {
    u = half(-ld) + 0.0f;
    v = half(hd) + 1.0f;
  } else if (Nl[2] == 1.0f) {
    u = half(-wd) + 3.0f;
    v = half(hd) + 1.0f;
  } else if (Nl[2] == -1.0f) {
    u = half(wd) + 1.0f;
    v = half(hd) + 1.0f;
  }
  uv[0] = u / 4.0f;
  uv[1] = v / 3.0f;
}

// attrs.py disc_attrs: the normal; planar uv over the bounding square
__device__ __forceinline__ void disc(const float* w, const float* P, bool need_uv,
                                     float* N, float* uv) {
  for (int c = 0; c < 3; ++c) N[c] = w[4 + c];
  if (!need_uv) return;
  float M[3];
  for (int c = 0; c < 3; ++c) M[c] = P[c] - w[c];
  uv[0] = (dot3(w + 8, M) / w[3] + 1.0f) / 2.0f;
  uv[1] = (dot3(w + 12, M) / w[3] + 1.0f) / 2.0f;
}

// attrs.py cylinder_attrs: the side's radial normal or a cap's axial one,
// the cap where |y| / half_h >= rho / r; uv (azimuth, height) or planar
__device__ __forceinline__ void cylinder(const float* w, const float* P, bool need_uv,
                                         float* N, float* uv) {
  float M[3];
  for (int c = 0; c < 3; ++c) M[c] = P[c] - w[c];
  const float* ax = w + 4;
  const float* ua = w + 8;
  const float* va = w + 12;
  const float r = w[3], hh = w[7];
  const float x = dot3(ua, M), y = dot3(ax, M), z = dot3(va, M);
  const float rho = sqrtf(t_clamp_min(x * x + z * z, F32(1e-20)));
  const bool is_cap = w[11] > 0.5f && fabsf(y) / hh >= rho / r;
  if (is_cap) {
    const float sy = t_sign(y);
    for (int c = 0; c < 3; ++c) N[c] = sy * ax[c];
  } else {
    for (int c = 0; c < 3; ++c) N[c] = (x * ua[c] + z * va[c]) / rho;
  }
  if (!need_uv) return;
  if (is_cap) {
    uv[0] = (x / r + 1.0f) / 2.0f;
    uv[1] = (z / r + 1.0f) / 2.0f;
  } else {
    uv[0] = (t_atan2(z, x) + PI_F) / TWO_PI_F;
    uv[1] = (y / hh + 1.0f) / 2.0f;
  }
}

// attrs.py triangle_attrs: the face normal, or the corners' blend,
// normalised; (u, v) the barycentric weights of p2, p3, or the corners'
// blend; under instances the hit pulled into the instance's object space
// for the solve and the normal rotated back
__device__ __forceinline__ void triangle(const Scene& S, long long local, const float* Pw,
                                         bool need_uv, float* N, float* uv) {
  long long row = local;
  float R[9], P[3];
  const bool inst = S.virt_row != nullptr;
  for (int c = 0; c < 3; ++c) P[c] = Pw[c];
  if (inst) {
    row = __ldg(S.virt_row + local);
    const long long k = __ldg(S.virt_inst + local);
    for (int j = 0; j < 9; ++j) R[j] = __ldg(S.inst_rot + 9 * k + j);
    float Pt[3], col[3];
    for (int c = 0; c < 3; ++c) Pt[c] = Pw[c] - __ldg(S.inst_trans + 3 * k + c);
    const float inv_s = __ldg(S.inst_inv_scale + k);
    for (int j = 0; j < 3; ++j) {
      for (int i = 0; i < 3; ++i) col[i] = R[3 * i + j];
      P[j] = dot3(col, Pt) * inv_s;
    }
  }
  float n[3];
  load3(S.tri_normal, row, n);
  const bool interp = S.vn1 != nullptr;
  if (need_uv || interp) {
    float p1[3], p2[3], p3[3], e1[3], e2[3], d[3];
    load3(S.tri_p1, row, p1);
    load3(S.tri_p2, row, p2);
    load3(S.tri_p3, row, p3);
    for (int c = 0; c < 3; ++c) {
      e1[c] = p2[c] - p1[c];
      e2[c] = p3[c] - p1[c];
      d[c] = P[c] - p1[c];
    }
    const float d11 = dot3(e1, e1), d12 = dot3(e1, e2), d22 = dot3(e2, e2);
    const float dp1 = dot3(d, e1), dp2 = dot3(d, e2);
    const float det = t_clamp_min(d11 * d22 - d12 * d12, F32(1e-20));
    const float u = (d22 * dp1 - d12 * dp2) / det;
    const float v = (d11 * dp2 - d12 * dp1) / det;
    if (!interp) {
      uv[0] = u;
      uv[1] = v;
    } else {
      const float w1 = (1.0f - u) - v, w2 = u, w3 = v;
      float a[3], b[3], c3[3], Ns[3];
      load3(S.vn1, row, a);
      load3(S.vn2, row, b);
      load3(S.vn3, row, c3);
      for (int c = 0; c < 3; ++c) Ns[c] = (w1 * a[c] + w2 * b[c]) + w3 * c3[c];
      const float len = safe_norm3(Ns);
      for (int c = 0; c < 3; ++c) n[c] = Ns[c] / len;
      if (need_uv) {
        for (int c = 0; c < 2; ++c)
          uv[c] = (w1 * __ldg(S.uv1 + 2 * row + c) + w2 * __ldg(S.uv2 + 2 * row + c))
                  + w3 * __ldg(S.uv3 + 2 * row + c);
      }
    }
  }
  if (inst) {
    for (int j = 0; j < 3; ++j) N[j] = dot3(R + 3 * j, n);
  } else {
    for (int c = 0; c < 3; ++c) N[c] = n[c];
  }
}

// ---------------------------------------------------------------------------
// the normal maps (ops/hit_attrs.py _apply_normal_maps)
// ---------------------------------------------------------------------------

// row x of a table of `rows` rows, clamped into it (jnp.take mode=clip)
__device__ __forceinline__ long long clip_row(long long x, long long rows) {
  const long long hi = rows > 0 ? rows - 1 : 0;
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// the port's _cross(a, b): each component two products and a difference
__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// _unit: v / clamp_min(safe_norm(v), 1e-20)
__device__ __forceinline__ void unit3(float* v) {
  const float d = t_clamp_min(safe_norm3(v), F32(1e-20));
  for (int c = 0; c < 3; ++c) v[c] = v[c] / d;
}

// r = a @ M, M (3, 3) row-major, as cuBLAS and MKL sum a row of an
// (N, 3) @ (3, 3) float32 product (see the header)
__device__ __forceinline__ void mm3(const float* a, const float* M, float* r) {
  for (int c = 0; c < 3; ++c)
    r[c] = fmaf(a[2], M[6 + c], fmaf(a[1], M[3 + c], fmaf(a[0], M[c], 0.0f)));
}

// The mesh rows a ray's object id o names (row o - tri_off, clamped; under
// instances its virtual id's row and instance), as the plain mesh ref
// takes them.
struct MeshRow {
  long long row, inst;
};
__device__ __forceinline__ MeshRow mesh_row(const Scene& S, long long o,
                                            long long tri_off) {
  MeshRow m{o - tri_off, -1};
  if (S.virt_row != nullptr) {
    const long long v = clip_row(m.row, S.counts[KINDS - 1]);
    m.row = __ldg(S.virt_row + v);
    m.inst = __ldg(S.virt_inst + v);
  } else {
    m.row = clip_row(m.row, S.tan_rows);
  }
  return m;
}

// Whether ref r's mask holds for object o: a sphere, plane or box ref where
// o is its object; a mesh ref where o is a triangle (o >= tri_off) whose
// map slot (`slot`, that of o's clamped row) is the ref's (never without
// the tangent tables); a ref of no known kind never.
__device__ __forceinline__ bool map_holds(const Scene& S, int r, long long o,
                                          long long tri_off, int slot) {
  const int* mi = S.map_i + 4 * r;
  if (mi[1] == MAP_TRI)
    return o >= tri_off && S.tri_nm_slot != nullptr && slot == mi[2];
  return mi[1] >= MAP_SPHERE && mi[1] <= MAP_BOX && o == (long long)mi[0];
}

// the map slot of o's mesh row (0 where o is no triangle or no ref is a mesh's)
__device__ __forceinline__ int map_slot(const Scene& S, long long o, long long tri_off) {
  return o >= tri_off && S.tri_nm_slot != nullptr
      ? __ldg(S.tri_nm_slot + clip_row(mesh_row(S, o, tri_off).row, S.tan_rows))
      : 0;
}

// N <- ref r's mapped normal at uv, from the geometric normal N (the plain
// ref's Nm): the map's texel decoded to [-1, 1] / 2, then the ref's frame
__device__ __forceinline__ void map_normal(const Scene& S, int r, long long o,
                                           long long tri_off, const float* uv, float* N) {
  float m[3], v[3];
  texture_fetch::fetch_texture(S.map_tex, r, uv[0], uv[1], m);
  for (int k = 0; k < 3; ++k) m[k] = m[k] - 0.5f;
  const int kind = S.map_i[4 * r + 1];
  if (kind == MAP_PLANE || kind == MAP_BOX) {
    float a[3];
    for (int k = 0; k < 3; ++k) a[k] = m[k] * 2.0f;
    mm3(a, S.map_basis + 9 * r, v);
  } else {
    float T[3], B[3];
    if (kind == MAP_SPHERE) {
      // T = dP/du (longitude), B = T x N
      const float s = sqrtf(t_clamp_min(N[0] * N[0] + N[2] * N[2], F32(1e-12)));
      T[0] = -N[2] / s;
      T[1] = 0.0f;
      T[2] = N[0] / s;
      cross3(T, N, B);
    } else {
      // the face's uv tangent (rotated into world under instances), made
      // orthonormal against N; B = sign N x T
      const MeshRow mr = mesh_row(S, o, tri_off);
      load3(S.tri_tan, clip_row(mr.row, S.tan_rows), T);
      if (mr.inst >= 0) {
        const float* R = S.inst_rot + 9 * mr.inst;
        float Tr[3];
        for (int j = 0; j < 3; ++j)
          Tr[j] = tsum3(__ldg(R + 3 * j) * T[0], __ldg(R + 3 * j + 1) * T[1],
                        __ldg(R + 3 * j + 2) * T[2]);
        for (int j = 0; j < 3; ++j) T[j] = Tr[j];
      }
      const float d = tsum3(T[0] * N[0], T[1] * N[1], T[2] * N[2]);
      for (int c = 0; c < 3; ++c) T[c] = T[c] - N[c] * d;
      unit3(T);
      const float sg = __ldg(S.tri_tan_sign + clip_row(mr.row, S.tan_rows));
      cross3(N, T, B);
      for (int c = 0; c < 3; ++c) B[c] = sg * B[c];
    }
    for (int c = 0; c < 3; ++c) v[c] = 2.0f * ((m[0] * T[c] + m[1] * B[c]) + m[2] * N[c]);
  }
  unit3(v);
  for (int c = 0; c < 3; ++c) N[c] = v[c];
}

// One ray, i: the plain stage's arithmetic, in its order; MAPS: the
// scene maps normals (and this is no first-hit pass).
template <bool MAPS>
__device__ __forceinline__ void attrs_ray(const Scene& S, const Rays& R, long long i) {
  const float t = __ldg(R.t + i);
  const bool miss = t >= R.miss_at;
  float O[3], D[3], P[3];
  load3(R.O, i, O);
  load3(R.D, i, D);
  for (int c = 0; c < 3; ++c) P[c] = O[c] + D[c] * t;
  const bool zeroed = R.first_hit && miss;
  if (zeroed)
    for (int c = 0; c < 3; ++c) P[c] = 0.0f;
  const long long o = __ldg(R.obj + i);
  float N[3] = {0.0f, 0.0f, 0.0f}, uv[2] = {0.0f, 0.0f};
  const bool need_uv = R.need_uv != 0;
  long long off = 0;
  // a miss of the first-hit pass keeps N and uv zero: past every kind
  int kind = zeroed ? KINDS : 0;
  for (; kind < KINDS; ++kind) {
    if (o >= off && o < off + S.counts[kind]) break;
    off += S.counts[kind];
  }
  if (kind < KINDS - 1) {
    float w[ROW];
    row_words(S.rows, o, w);
    switch (kind) {
      case 0: sphere(w, P, need_uv, N, uv); break;
      case 1: plane(w, P, need_uv, N, uv); break;
      case 2: box(w, P, need_uv, N, uv); break;
      case 3: disc(w, P, need_uv, N, uv); break;
      default: cylinder(w, P, need_uv, N, uv); break;
    }
  } else if (kind == KINDS - 1) {
    triangle(S, o - off, P, need_uv, N, uv);
  }
  if constexpr (MAPS) {
    const long long tri_off = S.counts[0] + S.counts[1] + S.counts[2] + S.counts[3]
                              + S.counts[4];
    const int slot = map_slot(S, o, tri_off);
    // the last ref whose mask holds wins, as the plain stage's torch.wheres
    int r = (int)S.n_maps - 1;
    while (r >= 0 && !map_holds(S, r, o, tri_off, slot)) --r;
    if (r >= 0) map_normal(S, r, o, tri_off, uv, N);
  }
  if (!R.first_hit) {
    const float s = __ldg(R.orient + i);
    for (int c = 0; c < 3; ++c) N[c] = N[c] * s;
  }
  const long long oc = o < 0 ? 0 : (o > S.n_obj - 1 ? S.n_obj - 1 : o);
  const int word = __ldg(S.packed + oc);
  const float m = t_clamp_min(t_max3(fabsf(P[0]), fabsf(P[1]), fabsf(P[2])), 1.0f);
  for (int c = 0; c < 3; ++c) {
    R.P[3 * i + c] = P[c];
    R.N[3 * i + c] = N[c];
  }
  R.uv[2 * i] = uv[0];
  R.uv[2 * i + 1] = uv[1];
  R.eps[i] = R.nudge * m;
  R.miss[i] = miss;
  R.packed[i] = word;
  R.mat_type[i] = word & 0x7;
  R.mat_slot[i] = (word >> SLOT_SHIFT) & 0x3FF;
  R.max_depth[i] = (word >> DEPTH_SHIFT) & 0x3FF;
  R.mc[i] = ((word >> MC_SHIFT) & 1) != 0;
}

template <bool MAPS>
__global__ void __launch_bounds__(ATTR_BLOCK)
hit_attrs_kernel(Scene S, Rays R) {
  const long long stride = (long long)gridDim.x * ATTR_BLOCK;
  for (long long i = (long long)blockIdx.x * ATTR_BLOCK + threadIdx.x; i < R.n;
       i += stride)
    attrs_ray<MAPS>(S, R, i);
}

// ---------------------------------------------------------------------------
// the backward pass: the vector-Jacobian product of the plain stage
// ---------------------------------------------------------------------------
//
// `hit_attrs_bwd` restates what autograd computes for `_plain_core` without
// normal maps (ops/plain_grad.py `plain_vjp`; the geometry's tables take
// no gradient here), op by op with ATen's derivative formulas, as
// csrc/bounce_tail.cu's backward passes do: a where() hands its gradient
// to the branch it took and +0 to the other; a product a * b gives g * b
// to a; a division a / b gives g / b to a and -g ((a / b) / b) to b;
// torch.sum of a broadcast factor's products its gradient; a select
// x[..., k] hands its tensor a full row, the gradient at k and +0
// elsewhere; torch.sign and torch.floor give zeros; amax splits its
// gradient evenly among tied maxima, (g / count) * mask; abs gives
// g * sign(x); clamp passes g where min <= x <= max, else 0; atan2(y, x)
// gives (g x) r to y and (g (-y)) r to x with r = 1 / (y y + x x); asin
// gives g * rsqrt(-x x + 1); sqrt g / (2 sqrt(x)).  A tensor's gradient
// sums its contributions in the order autograd's engine adds them: the
// ready node created last runs first, the first contribution stored as it
// is (an `Acc`).  P = O + D t feeds every present kind's formula (each
// over every ray, on its clamped id; a ray's own kind takes the output
// gradients, every other kind +0, which still adds its zeros, or a NaN,
// to P's) and the nudge's amax |P|: P's gradient is the output gradient,
// then the nudge's, then each present kind's, the last kind first.  Then
// O takes P's gradient, D P's times t, t torch.sum(P's times D).

// a tensor's gradient buffer: its contributions summed in arrival order
struct Acc {
  float v;
  bool has;
};
__device__ __forceinline__ void acc_add(Acc& a, float x) {
  a.v = a.has ? a.v + x : x;
  a.has = true;
}
__device__ __forceinline__ float acc_val(const Acc& a) { return a.has ? a.v : 0.0f; }

// a select x[..., k] of a 3-vector hands x a full row: x at k, +0 elsewhere
__device__ __forceinline__ void add_row3(Acc* b, int k, float x) {
  for (int c = 0; c < 3; ++c) acc_add(b[c], c == k ? x : 0.0f);
}

// _dot(a, b)'s backward of g into b (a takes none): its three products'
// selects hand b their rows, the last product's first
__device__ __forceinline__ void dot_bwd(Acc* b, float g, const float* a) {
  for (int k = 2; k >= 0; --k) add_row3(b, k, g * a[k]);
}

// torch.sum over a last dimension of 2
__device__ __forceinline__ float tsum2(float x0, float x1) {
#ifdef W5_TORCH_CPU
  return (0.0f + x0) + x1;
#else
  return (0.0f + x0) + (0.0f + x1);
#endif
}

// The backward formulas of torch.atan2 (gy, gx), torch.asin and
// torch.sqrt (r its result), as the card computes them; under
// W5_TORCH_CPU in float64, rounded once, as the CPU tests run the plain
// stage's atan2, asin and sqrt through float64 (the backward of a
// float64 op between two casts).
__device__ __forceinline__ void atan2_bwd(float g, float y, float x, float* gy,
                                          float* gx) {
#ifdef W5_TORCH_CPU
  const double r = 1.0 / ((double)y * (double)y + (double)x * (double)x);
  *gy = (float)(((double)g * (double)x) * r);
  *gx = (float)(((double)g * -(double)y) * r);
#else
  const float r = 1.0f / (y * y + x * x);
  *gy = (g * x) * r;
  *gx = (g * -y) * r;
#endif
}
__device__ __forceinline__ float asin_bwd(float g, float x) {
#ifdef W5_TORCH_CPU
  return (float)((double)g * (1.0 / sqrt(-(double)x * (double)x + 1.0)));
#else
  return g * rsqrtf(-x * x + 1.0f);
#endif
}
__device__ __forceinline__ float sqrt_bwd(float g, float x) {
#ifdef W5_TORCH_CPU
  return (float)((double)g / (2.0 * sqrt((double)x)));
#else
  return g / (2.0f * sqrtf(x));
#endif
}

// The output gradients a kind's formula takes at a ray: its own kind's
// (the N and uv gradients), another kind's +0; n / uv: the stage's N / uv
// output takes a gradient (null pointers, not zeros, where it takes none:
// then no op of that branch runs).
struct Up {
  bool n, uv;
  float gN[3], guv[2];
};

// attrs.py sphere_attrs' backward into P - c
__device__ __forceinline__ void sphere_bwd(const float* w, const float* P, const Up& U,
                                           float* g) {
  float N[3];
  for (int c = 0; c < 3; ++c) N[c] = (P[c] - w[c]) / w[3];
  Acc b[3] = {};
  if (U.n)
    for (int c = 0; c < 3; ++c) acc_add(b[c], U.gN[c]);
  if (U.uv) {
    // u = div(atan2(N2, N0) + pi, 2 pi), v = div(asin(clamp(N1)) + pi / 2, pi):
    // v's ops run first (asin's select of N1), then u's (N0's, then N2's)
    const float gphi = U.guv[0] / TWO_PI_F, gtheta = U.guv[1] / PI_F;
    const float x = t_clamp(N[1], -1.0f, 1.0f);
    const float gx = asin_bwd(gtheta, x);
    add_row3(b, 1, N[1] >= -1.0f && N[1] <= 1.0f ? gx : 0.0f);
    float gy2, gx0;
    atan2_bwd(gphi, N[2], N[0], &gy2, &gx0);
    add_row3(b, 0, gx0);
    add_row3(b, 2, gy2);
  }
  for (int c = 0; c < 3; ++c) g[c] = acc_val(b[c]) / w[3];
}

// attrs.py plane_attrs / disc_attrs' backward into P - c (the uv only: the
// normal is the table's): u = div(_dot(ua, M) / su + 1, 2) (+ shift), v
// likewise; v's dot runs first
__device__ __forceinline__ void planar_bwd(const float* w, float su, float sv,
                                           const Up& U, float* g) {
  Acc b[3] = {};
  dot_bwd(b, (U.guv[1] / 2.0f) / sv, w + 12);
  dot_bwd(b, (U.guv[0] / 2.0f) / su, w + 8);
  for (int c = 0; c < 3; ++c) g[c] = acc_val(b[c]);
}

// attrs.py box_attrs' backward into P - c.  The normal's branch gives P_l
// torch.sign's zeros; the uv's hands each of w_d, h_d, l_d (P_l's
// selects) its faces' terms, the selected face's (the first whose
// condition holds) the gradient, the others +0 (one nonzero term a select,
// so their order is moot); then P_l's three dots, the last first.
__device__ __forceinline__ void box_bwd(const float* w, const float* P, const Up& U,
                                        float* g) {
  float M[3], Pl[3], a[3], Nl[3];
  for (int c = 0; c < 3; ++c) M[c] = P[c] - w[12 + c];
  for (int i = 0; i < 3; ++i) Pl[i] = dot3(w + 4 * i, M);
  for (int i = 0; i < 3; ++i) a[i] = fabsf(Pl[i]) / w[4 * i + 3];
  const float Pmax = t_max3(a[0], a[1], a[2]);
  for (int i = 0; i < 3; ++i) Nl[i] = Pmax == a[i] ? t_sign(Pl[i]) : 0.0f;
  Acc pl[3] = {};
  if (U.uv) {
    const float s = F32(2.0 * 0.985) / w[3];
    const int face = Nl[1] == -1.0f ? 0 : Nl[1] == 1.0f ? 1 : Nl[0] == 1.0f ? 2
                   : Nl[0] == -1.0f ? 3 : Nl[2] == 1.0f ? 4 : Nl[2] == -1.0f ? 5 : -1;
    const float gu = U.guv[0] / 4.0f, gv = U.guv[1] / 3.0f;
    // half(x) = div(x s + 1, 2) hands x (g / 2) s; half(-x) its negation
    auto term = [&](float gf, int f, bool neg) {
      const float t = ((f == face ? gf : 0.0f) / 2.0f) * s;
      return neg ? -t : t;
    };
    Acc wd = {}, hd = {}, ld = {};
    acc_add(wd, term(gu, 0, false));
    acc_add(wd, term(gu, 1, false));
    acc_add(ld, term(gu, 2, false));
    acc_add(ld, term(gu, 3, true));
    acc_add(wd, term(gu, 4, true));
    acc_add(wd, term(gu, 5, false));
    acc_add(ld, term(gv, 0, true));
    acc_add(ld, term(gv, 1, false));
    for (int f = 2; f < 6; ++f) acc_add(hd, term(gv, f, false));
    add_row3(pl, 2, ld.v);
    add_row3(pl, 1, hd.v);
    add_row3(pl, 0, wd.v);
  }
  if (U.n)
    for (int c = 0; c < 3; ++c) acc_add(pl[c], 0.0f);
  Acc b[3] = {};
  for (int i = 2; i >= 0; --i) dot_bwd(b, acc_val(pl[i]), w + 4 * i);
  for (int c = 0; c < 3; ++c) g[c] = acc_val(b[c]);
}

// attrs.py cylinder_attrs' backward into P - c.  x, y, z (the dots of M
// with the u axis, the axis and the v axis) take, in the engine's order:
// with uv, the cap's z / r and x / r, the side's y / hh, atan2(z, x);
// with the normal, the cap's torch.sign(y) zeros, the side's
// (x ua + z va) / rho (z's, then x's), then rho = sqrt(clamp_min(x x +
// z z)) (z's two, then x's two); then the three dots, z's first.
__device__ __forceinline__ void cylinder_bwd(const float* w, const float* P, const Up& U,
                                             float* g) {
  float M[3];
  for (int c = 0; c < 3; ++c) M[c] = P[c] - w[c];
  const float* ax = w + 4;
  const float* ua = w + 8;
  const float* va = w + 12;
  const float r = w[3], hh = w[7];
  const float x = dot3(ua, M), y = dot3(ax, M), z = dot3(va, M);
  const float q = x * x + z * z;
  const float rho = sqrtf(t_clamp_min(q, F32(1e-20)));
  const bool cap = w[11] > 0.5f && rho / r <= fabsf(y) / hh;
  Acc X = {}, Y = {}, Z = {};
  if (U.uv) {
    const float gu = U.guv[0], gv = U.guv[1];
    acc_add(Z, ((cap ? gv : 0.0f) / 2.0f) / r);
    acc_add(X, ((cap ? gu : 0.0f) / 2.0f) / r);
    acc_add(Y, ((cap ? 0.0f : gv) / 2.0f) / hh);
    float gz, gx;
    atan2_bwd((cap ? 0.0f : gu) / TWO_PI_F, z, x, &gz, &gx);
    acc_add(X, gx);
    acc_add(Z, gz);
  }
  if (U.n) {
    acc_add(Y, 0.0f);
    float gS[3], t[3], S[3];
    for (int c = 0; c < 3; ++c) {
      const float gs = cap ? 0.0f : U.gN[c];
      S[c] = x * ua[c] + z * va[c];
      gS[c] = gs / rho;
      t[c] = -gs * ((S[c] / rho) / rho);
    }
    const float grho = tsum3(t[0], t[1], t[2]);
    acc_add(Z, tsum3(gS[0] * va[0], gS[1] * va[1], gS[2] * va[2]));
    acc_add(X, tsum3(gS[0] * ua[0], gS[1] * ua[1], gS[2] * ua[2]));
    const float qc = t_clamp_min(q, F32(1e-20));
    const float gq = q >= F32(1e-20) ? sqrt_bwd(grho, qc) : 0.0f;
    acc_add(Z, gq * z);
    acc_add(Z, gq * z);
    acc_add(X, gq * x);
    acc_add(X, gq * x);
  }
  Acc b[3] = {};
  dot_bwd(b, acc_val(Z), va);
  dot_bwd(b, acc_val(Y), ax);
  dot_bwd(b, acc_val(X), ua);
  for (int c = 0; c < 3; ++c) g[c] = acc_val(b[c]);
}

// attrs.py triangle_attrs' backward into P (under instances, through
// ((P - trans) @ R) * inv_s).  The blend's weights w1 = (1 - u) - v, w2 = u,
// w3 = v take the uv blend's sums first (w3's, w2's, w1's), then the
// normal's (through N = Ns / safe_norm(Ns), under instances after the
// rotation back's three dots, the last first); then u and v (v takes w3
// and -w1, u w2 and -w1), the barycentric solve (v's products first) and
// its two dots, dp2's first.
__device__ __forceinline__ void triangle_bwd(const Scene& S, long long local,
                                             const float* Pw, const Up& U, float* g) {
  long long row = local;
  float R[9], P[3], Pt[3], inv_s = 1.0f;
  const bool inst = S.virt_row != nullptr;
  for (int c = 0; c < 3; ++c) P[c] = Pw[c];
  if (inst) {
    row = __ldg(S.virt_row + local);
    const long long k = __ldg(S.virt_inst + local);
    for (int j = 0; j < 9; ++j) R[j] = __ldg(S.inst_rot + 9 * k + j);
    float col[3];
    for (int c = 0; c < 3; ++c) Pt[c] = Pw[c] - __ldg(S.inst_trans + 3 * k + c);
    inv_s = __ldg(S.inst_inv_scale + k);
    for (int j = 0; j < 3; ++j) {
      for (int i = 0; i < 3; ++i) col[i] = R[3 * i + j];
      P[j] = dot3(col, Pt) * inv_s;
    }
  }
  const bool interp = S.vn1 != nullptr;
  float p1[3], p2[3], p3[3], e1[3], e2[3], d[3];
  load3(S.tri_p1, row, p1);
  load3(S.tri_p2, row, p2);
  load3(S.tri_p3, row, p3);
  for (int c = 0; c < 3; ++c) {
    e1[c] = p2[c] - p1[c];
    e2[c] = p3[c] - p1[c];
    d[c] = P[c] - p1[c];
  }
  const float d11 = dot3(e1, e1), d12 = dot3(e1, e2), d22 = dot3(e2, e2);
  const float dp1 = dot3(d, e1), dp2 = dot3(d, e2);
  const float det = t_clamp_min(d11 * d22 - d12 * d12, F32(1e-20));
  const float u = (d22 * dp1 - d12 * dp2) / det;
  const float v = (d11 * dp2 - d12 * dp1) / det;
  Acc gu = {}, gv = {};
  if (!interp) {
    gu = Acc{U.guv[0], true};
    gv = Acc{U.guv[1], true};
  } else {
    const float w1 = (1.0f - u) - v, w2 = u, w3 = v;
    Acc W1 = {}, W2 = {}, W3 = {};
    if (U.uv) {
      float t1[2], t2[2], t3[2];
      for (int c = 0; c < 2; ++c) {
        t1[c] = U.guv[c] * __ldg(S.uv1 + 2 * row + c);
        t2[c] = U.guv[c] * __ldg(S.uv2 + 2 * row + c);
        t3[c] = U.guv[c] * __ldg(S.uv3 + 2 * row + c);
      }
      acc_add(W3, tsum2(t3[0], t3[1]));
      acc_add(W2, tsum2(t2[0], t2[1]));
      acc_add(W1, tsum2(t1[0], t1[1]));
    }
    if (U.n) {
      float a[3], b[3], c3[3], Ns[3];
      load3(S.vn1, row, a);
      load3(S.vn2, row, b);
      load3(S.vn3, row, c3);
      for (int c = 0; c < 3; ++c) Ns[c] = (w1 * a[c] + w2 * b[c]) + w3 * c3[c];
      const float s = tsum3(Ns[0] * Ns[0], Ns[1] * Ns[1], Ns[2] * Ns[2]);
      const float sc = t_clamp_min(s, F32(1e-30));
      const float len = s > 0.0f ? sqrtf(sc) : 0.0f;
      float Nb[3];
      if (inst) {
        Acc nb[3] = {};
        for (int j = 2; j >= 0; --j) dot_bwd(nb, U.gN[j], R + 3 * j);
        for (int c = 0; c < 3; ++c) Nb[c] = acc_val(nb[c]);
      } else {
        for (int c = 0; c < 3; ++c) Nb[c] = U.gN[c];
      }
      float t[3], gNs[3];
      for (int c = 0; c < 3; ++c) {
        gNs[c] = Nb[c] / len;
        t[c] = -Nb[c] * ((Ns[c] / len) / len);
      }
      const float glen = tsum3(t[0], t[1], t[2]);
      const float gr = s > 0.0f ? glen : 0.0f;
      const float gs = s >= F32(1e-30) ? sqrt_bwd(gr, sc) : 0.0f;
      for (int c = 0; c < 3; ++c) {
        const float q = gs * Ns[c];
        gNs[c] = (gNs[c] + q) + q;
      }
      acc_add(W3, tsum3(gNs[0] * c3[0], gNs[1] * c3[1], gNs[2] * c3[2]));
      acc_add(W2, tsum3(gNs[0] * b[0], gNs[1] * b[1], gNs[2] * b[2]));
      acc_add(W1, tsum3(gNs[0] * a[0], gNs[1] * a[1], gNs[2] * a[2]));
    }
    acc_add(gv, W3.v);
    acc_add(gu, W2.v);
    acc_add(gv, -W1.v);
    acc_add(gu, -W1.v);
  }
  const float gsv = gv.v / det, gsu = gu.v / det;
  const float g1 = -gsv * d12 + gsu * d22;
  const float g2 = gsv * d11 + -gsu * d12;
  Acc b[3] = {};
  dot_bwd(b, g2, e2);
  dot_bwd(b, g1, e1);
  if (!inst) {
    for (int c = 0; c < 3; ++c) g[c] = acc_val(b[c]);
    return;
  }
  Acc pt[3] = {};
  for (int j = 2; j >= 0; --j) {
    const float col[3] = {R[j], R[3 + j], R[6 + j]};
    dot_bwd(pt, acc_val(b[j]) * inv_s, col);
  }
  for (int c = 0; c < 3; ++c) g[c] = acc_val(pt[c]);
}

// The rays' inputs as the forward's (`Rays`), the stage's output
// gradients (gP, gN (n, 3), guv (n, 2), geps (n,); null where the output
// takes none: gN where no present kind's normal depends on P, guv without
// uv) and the gradients of O, D (n, 3) and t (n,) (null where not wanted).
struct RaysBwd {
  const float *O, *D, *t, *orient;
  const long long* obj;
  long long n;
  int need_uv, first_hit;
  float nudge, miss_at;
  const float *gP, *gN, *guv, *geps;
  float *dO, *dD, *dt;
};

// whether a kind's formula has an op on P that the output gradients reach
__device__ __forceinline__ bool kind_reached(const Scene& S, int kind, const Up& U) {
  if (kind == 1 || kind == 3) return U.uv;
  if (kind == KINDS - 1) return U.uv || (U.n && S.vn1 != nullptr);
  return U.n || U.uv;
}

__device__ __forceinline__ void attrs_bwd_ray(const Scene& S, const RaysBwd& B,
                                              long long i) {
  const float t = __ldg(B.t + i);
  const bool miss = t >= B.miss_at;
  float O[3], D[3], P[3];
  load3(B.O, i, O);
  load3(B.D, i, D);
  for (int c = 0; c < 3; ++c) P[c] = O[c] + D[c] * t;
  const bool zeroed = B.first_hit && miss;
  if (zeroed)
    for (int c = 0; c < 3; ++c) P[c] = 0.0f;
  const long long o = __ldg(B.obj + i);
  // the output gradients the ray's own kind takes: the first-hit pass's
  // where(miss, 0, .) hands them +0 on a miss; else N = N_geo * orient
  Up own = {B.gN != nullptr, B.guv != nullptr, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f}};
  if (own.n) {
    const float s = B.first_hit ? 0.0f : __ldg(B.orient + i);
    for (int c = 0; c < 3; ++c) {
      const float gn = __ldg(B.gN + 3 * i + c);
      own.gN[c] = B.first_hit ? (miss ? 0.0f : gn) : gn * s;
    }
  }
  if (own.uv)
    for (int c = 0; c < 2; ++c) {
      const float gu = __ldg(B.guv + 2 * i + c);
      own.guv[c] = B.first_hit && miss ? 0.0f : gu;
    }
  Up other = {own.n, own.uv, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f}};
  Acc gp[3] = {};
  if (B.gP)
    for (int c = 0; c < 3; ++c) acc_add(gp[c], __ldg(B.gP + 3 * i + c));
  if (B.geps) {
    // eps = nudge * clamp_min(amax(|P|), 1)
    float a[3];
    for (int c = 0; c < 3; ++c) a[c] = fabsf(P[c]);
    const float m = t_max3(a[0], a[1], a[2]);
    const float gc = m >= 1.0f ? __ldg(B.geps + i) * B.nudge : 0.0f;
    const float cnt = (float)((m == a[0]) + (m == a[1]) + (m == a[2]));
    const float ga = gc / cnt;
    for (int c = 0; c < 3; ++c)
      acc_add(gp[c], (ga * (m == a[c] ? 1.0f : 0.0f)) * t_sign(P[c]));
  }
  long long offs[KINDS];
  long long off = 0;
  for (int k = 0; k < KINDS; ++k) {
    offs[k] = off;
    off += S.counts[k];
  }
  for (int kind = KINDS - 1; kind >= 0; --kind) {
    const long long count = S.counts[kind];
    if (!count) continue;
    const bool mine = o >= offs[kind] && o < offs[kind] + count;
    const Up& U = mine ? own : other;
    if (!kind_reached(S, kind, U)) continue;
    const long long local = clip_row(o - offs[kind], count);
    float g[3];
    if (kind == KINDS - 1) {
      triangle_bwd(S, local, P, U, g);
    } else {
      float w[ROW];
      row_words(S.rows, offs[kind] + local, w);
      switch (kind) {
        case 0: sphere_bwd(w, P, U, g); break;
        case 1: planar_bwd(w, w[3], w[7], U, g); break;
        case 2: box_bwd(w, P, U, g); break;
        case 3: planar_bwd(w, w[3], w[3], U, g); break;
        default: cylinder_bwd(w, P, U, g); break;
      }
    }
    for (int c = 0; c < 3; ++c) acc_add(gp[c], g[c]);
  }
  float G[3];
  for (int c = 0; c < 3; ++c) G[c] = zeroed ? 0.0f : acc_val(gp[c]);
  for (int c = 0; c < 3; ++c) {
    if (B.dO) B.dO[3 * i + c] = G[c];
    if (B.dD) B.dD[3 * i + c] = G[c] * t;
  }
  if (B.dt) B.dt[i] = tsum3(G[0] * D[0], G[1] * D[1], G[2] * D[2]);
}

__global__ void __launch_bounds__(ATTR_BLOCK)
hit_attrs_bwd_kernel(Scene S, RaysBwd B) {
  const long long stride = (long long)gridDim.x * ATTR_BLOCK;
  for (long long i = (long long)blockIdx.x * ATTR_BLOCK + threadIdx.x; i < B.n;
       i += stride)
    attrs_bwd_ray(S, B, i);
}

// W5's atan2 (op 0: atan2(x, y)), asin (op 1: asin(x)) of n floats, its
// 3 x 3 product (op 2: row i of out = row i of x @ y, x (n, 3), y (3, 3)),
// or its backward's rsqrt (op 3: rsqrtf(x)), as the kernels compute them:
// for the holds against torch.
__global__ void __launch_bounds__(ATTR_BLOCK)
math_kernel(int op, const float* x, const float* y, long long n, float* out) {
  const long long stride = (long long)gridDim.x * ATTR_BLOCK;
  for (long long i = (long long)blockIdx.x * ATTR_BLOCK + threadIdx.x; i < n;
       i += stride) {
    if (op == 2)
      mm3(x + 3 * i, y, out + 3 * i);
    else if (op == 3)
      out[i] = rsqrtf(x[i]);
    else
      out[i] = op == 0 ? t_atan2(x[i], y[i]) : t_asin(x[i]);
  }
}

// The card's SMs and the kernel's resident blocks an SM.
template <class F>
cudaError_t residency(F kernel, int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, ATTR_BLOCK, 0);
  return err;
}

// A grid of at most the card's resident blocks (the threads loop over the
// rays), at least one block, no more than the rays need.
template <class F>
cudaError_t grid_for(F kernel, long long n, int* grid) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = residency(kernel, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const long long need = (n + ATTR_BLOCK - 1) / ATTR_BLOCK;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(need < most ? need : most);
  return cudaSuccess;
}

bool scene_ok(const Scene& S) {
  long long total = 0;
  for (int k = 0; k < KINDS; ++k) {
    if (S.counts[k] < 0) return false;
    total += S.counts[k];
  }
  const bool tris = S.counts[KINDS - 1] > 0;
  return S.n_obj >= 1 && S.packed && (total == S.counts[KINDS - 1] || S.rows)
         && (!tris || (S.tri_p1 && S.tri_p2 && S.tri_p3 && S.tri_normal))
         && (!S.vn1 || (S.vn2 && S.vn3 && S.uv1 && S.uv2 && S.uv3))
         && (!S.virt_row || (S.virt_inst && S.inst_rot && S.inst_trans
                             && S.inst_inv_scale))
         && S.n_maps >= 0
         && (!S.n_maps || (S.map_i && S.map_basis && S.map_tex.texels
                           && S.map_tex.desc_i && S.map_tex.desc_f))
         && (!S.tri_nm_slot || (S.tri_tan && S.tri_tan_sign && S.tan_rows >= 1));
}

bool rays_ok(const Rays& R) {
  return R.n >= 1 && R.O && R.D && R.t && R.obj && (R.first_hit || R.orient)
         && R.P && R.N && R.uv && R.eps && R.miss && R.mc && R.packed
         && R.mat_type && R.mat_slot && R.max_depth;
}

bool bwd_ok(const RaysBwd& B) {
  return B.n >= 1 && B.O && B.D && B.t && B.obj && (B.first_hit || !B.gN || B.orient)
         && (!B.guv || B.need_uv) && (B.gP || B.gN || B.guv || B.geps)
         && (B.dO || B.dD || B.dt);
}

}  // namespace w5

using namespace w5;

template <bool MAPS>
cudaError_t launch_attrs(const Scene& S, const Rays& R, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = grid_for(hit_attrs_kernel<MAPS>, R.n, &grid);
  if (err != cudaSuccess) return err;
  LAUNCH(hit_attrs_kernel<MAPS>, grid, ATTR_BLOCK, 0, stream, S, R);
  return cudaGetLastError();
}

// What a kernel was built to: out[0] registers a thread, out[1] local
// memory a thread (bytes: spills and stack), out[2] resident blocks an SM,
// out[3] the SMs, out[4] ATTR_BLOCK.
template <class F>
cudaError_t kernel_info(F kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = residency(kernel, &out[3], &out[2]);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[4] = ATTR_BLOCK;
  return cudaSuccess;
}

// The attributes of every ray of R against the scene S (ops/hit_attrs.py
// builds both), one launch: the MAPS instance where the scene maps normals
// and this is no first-hit pass.  Returns 0 or a CUDA error, and sets
// *launched to the kernels launched.  It runs on the host and reads
// nothing the structs point to: the tables lie on the device.
extern "C" int hit_attrs(const Scene* S, const Rays* R, void* stream, int* launched) {
  *launched = 0;
  if (!scene_ok(*S) || !rays_ok(*R)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = S->n_maps > 0 && !R->first_hit ? launch_attrs<true>(*S, *R, st)
                                                          : launch_attrs<false>(*S, *R, st);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// The gradients of the rays' O, D and t from those of the attributes (B)
// against the scene S, which maps no normal (ops/hit_attrs.py builds
// both), one launch.  Returns 0 or a CUDA error, and sets *launched to the
// kernels launched.
extern "C" int hit_attrs_bwd(const Scene* S, const RaysBwd* B, void* stream,
                             int* launched) {
  *launched = 0;
  if (!scene_ok(*S) || !bwd_ok(*B) || (S->n_maps > 0 && !B->first_hit))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_for(hit_attrs_bwd_kernel, B->n, &grid);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(hit_attrs_bwd_kernel, grid, ATTR_BLOCK, 0, static_cast<cudaStream_t>(stream),
         *S, *B);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// What a kernel was built to (which: 0 the kernel's instance without maps,
// 1 its MAPS instance, 2 the backward; see kernel_info).
extern "C" int hit_attrs_info(int which, int* out) {
  if (which == 2) return (int)kernel_info(hit_attrs_bwd_kernel, out);
  return (int)(which ? kernel_info(hit_attrs_kernel<true>, out)
                     : kernel_info(hit_attrs_kernel<false>, out));
}

// out[i] = W5's atan2(x[i], y[i]) (op 0), asin(x[i]) (op 1) or rsqrt(x[i])
// (op 3), n floats; or (op 2) out's row i = x's row i @ y, n rows.  For chip_smoke.py and the
// card tests, which hold them against torch.
extern "C" int hit_attrs_math(int op, const float* x, const float* y, long long n,
                              float* out, void* stream, int* launched) {
  *launched = 0;
  if (op < 0 || op > 3 || !x || ((op == 0 || op == 2) && !y) || !out || n < 1)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_for(math_kernel, n, &grid);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(math_kernel, grid, ATTR_BLOCK, 0, static_cast<cudaStream_t>(stream), op, x,
         y, n, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
