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
// and t from those of P, N, uv and eps, as the JAX package's jax.grad
// takes the stage's VJP (raytracer_tpu/diff.py) and XLA fuses it; its
// TABLES instance also writes the geometry tables' per-ray rows, and its
// MAPS instance (the normal-mapped scenes outside the first-hit pass)
// takes the gradient back through every ref's mapped normal, writing the
// maps' texture taps' rows.  One thread a ray runs every present kind's
// backward (and every ref's), as the plain VJP does (the others with +0
// gradients), and adds the contributions in autograd's order.  Memory
// bounds the lean instance: a ray reads its 44 bytes of O, D, t, object
// and orientation and up to 32 of output gradients and writes 28; the
// kinds' formulas are a few hundred issue slots at most.
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

// The geometric normal and uv of object o at P: its kind's formula
__device__ __forceinline__ void geometric(const Scene& S, const float* P, long long o,
                                          bool need_uv, float* N, float* uv) {
  long long off = 0;
  int kind = 0;
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
  // a miss of the first-hit pass keeps N and uv zero
  if (!zeroed) geometric(S, P, o, R.need_uv != 0, N, uv);
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
// `hit_attrs_bwd` restates what autograd computes for `_plain_core`
// (ops/plain_grad.py `plain_vjp`; the tables' rows and the maps below),
// op by op with ATen's derivative formulas, as
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

// _dot(a, b)'s backward of g into b (a takes none; into a likewise, with
// b's values): its three products' selects hand b their rows, the last
// product's first
__device__ __forceinline__ void dot_bwd(Acc* b, float g, const float* a) {
  for (int k = 2; k >= 0; --k) add_row3(b, k, g * a[k]);
}

// tsum3 as a functor (the maps' bilinear fetch's backward)
struct Sum3 {
  __device__ __forceinline__ float operator()(float x0, float x1, float x2) const {
    return tsum3(x0, x1, x2);
  }
};

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

// ---------------------------------------------------------------------------
// the geometry tables' rows (the backward's TABLES instance)
// ---------------------------------------------------------------------------
//
// Where a geometry table requires grad, the plain stage's gather of it
// (geometry/attrs.py `_gather`, core/safemath.py `take`) takes one
// gradient row a ray, since each present kind's formula runs over every
// ray on its clamped id: the ray's own kind's from the output gradients,
// every other kind's from +0 ones (which still give +0, -0 or NaN).  The
// kinds' backward below writes those rows in its TABLES instance; the
// wrapper reduces each table's with `take_backward` (ops/hit_attrs.py
// `attrs_vjp`).  A gathered value's buffer adds its contributions in the
// engine's order (an `Acc`): a product's node made after a dot's runs
// before it, a dot's selects hand full rows, the last component's first,
// and a select x[:, j, :] or x[:, :, j] of a 3 x 3 value hands it a full
// 3 x 3 of +0 around its row or column.  torch.sign gives zeros,
// clamp_min passes the gradient where its input is at least its bound,
// else +0; a division a / b gives b -g ((a / b) / b), summed over a
// broadcast.

// the tables (ops/hit_attrs.py TABLES)
enum Table {
  T_SPH_C, T_SPH_R,
  T_PL_N, T_PL_C, T_PL_W, T_PL_H, T_PL_SHIFT, T_PL_U, T_PL_V,
  T_BOX_B, T_BOX_WHL, T_BOX_C,
  T_DISC_N, T_DISC_C, T_DISC_R, T_DISC_U, T_DISC_V,
  T_CYL_AX, T_CYL_U, T_CYL_V, T_CYL_R, T_CYL_H, T_CYL_C,
  T_TRI_N, T_TRI_P1, T_TRI_P2, T_TRI_P3, T_VN1, T_VN2, T_VN3, T_UV1, T_UV2, T_UV3,
  T_ROT, T_TRANS, T_INVS,
  N_TABLES
};

// a 3-vector's buffer
__device__ __forceinline__ void acc_row3(Acc* b, const float* x) {
  for (int c = 0; c < 3; ++c) acc_add(b[c], x[c]);
}

// _dot(e, e)'s backward into e: each product's two selects, the second
// operand's first
__device__ __forceinline__ void dot_self_bwd(Acc* e, float g, const float* x) {
  for (int k = 2; k >= 0; --k) {
    add_row3(e, k, g * x[k]);
    add_row3(e, k, g * x[k]);
  }
}

// row i of table t (width floats), where wanted
__device__ __forceinline__ void put_row(float* const* tab, int t, long long i, int width,
                                        const float* v) {
  float* r = tab[t];
  if (r)
    for (int c = 0; c < width; ++c) r[(long long)width * i + c] = v[c];
}
__device__ __forceinline__ void put_acc(float* const* tab, int t, long long i, int width,
                                        const Acc* v, bool neg = false) {
  float x[9];
  for (int c = 0; c < width; ++c) x[c] = neg ? -acc_val(v[c]) : acc_val(v[c]);
  put_row(tab, t, i, width, x);
}

// a / b's gradient into b: -g ((a / b) / b)
__device__ __forceinline__ float div_other(float g, float a, float b) {
  return -g * ((a / b) / b);
}

// Each kind's backward below gives g, the gradient of its formula's P (of
// P - c for the analytic kinds), and, in the TABLES instance, its tables'
// rows of ray i (`tab`, null where not wanted).

// attrs.py sphere_attrs' backward into N = (P - c) / r: N's buffer b
__device__ __forceinline__ void sphere_nb(const float* w, const float* P, const Up& U,
                                          Acc* b) {
  float N[3];
  for (int c = 0; c < 3; ++c) N[c] = (P[c] - w[c]) / w[3];
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
}

// attrs.py sphere_attrs' backward into P - c; c takes -(it), r the sum
// over the three of -b ((X / r) / r), X = P - c
template <bool TABLES>
__device__ __forceinline__ void sphere_bwd(const float* w, const float* P, const Up& U,
                                           float* g, float* const* tab, long long i) {
  Acc b[3] = {};
  sphere_nb(w, P, U, b);
  for (int c = 0; c < 3; ++c) g[c] = acc_val(b[c]) / w[3];
  if (!TABLES) return;
  float gc[3], t[3];
  for (int c = 0; c < 3; ++c) {
    gc[c] = -g[c];
    t[c] = div_other(acc_val(b[c]), P[c] - w[c], w[3]);
  }
  const float gr = tsum3(t[0], t[1], t[2]);
  put_row(tab, T_SPH_C, i, 3, gc);
  put_row(tab, T_SPH_R, i, 1, &gr);
}

// attrs.py plane_attrs / disc_attrs' backward into P - c (the uv only: the
// normal is the table's): u = div(_dot(ua, M) / su + 1, 2) (+ shift), v
// likewise; v's dot runs first.  The normal takes its gradient; with uv,
// each axis its dot's, the divisors theirs, v's first where one is both
// (a disc's r_out), the centre -(M's), a plane's uv_shift its two
// selects' rows, v's first.
template <bool TABLES>
__device__ __forceinline__ void planar_bwd(const float* w, const float* P, const Up& U,
                                           bool disc, float* g, float* const* tab,
                                           long long i) {
  const float su = w[3], sv = disc ? w[3] : w[7];
  Acc b[3] = {};
  dot_bwd(b, (U.guv[1] / 2.0f) / sv, w + 12);
  dot_bwd(b, (U.guv[0] / 2.0f) / su, w + 8);
  for (int c = 0; c < 3; ++c) g[c] = acc_val(b[c]);
  if (!TABLES) return;
  put_row(tab, disc ? T_DISC_N : T_PL_N, i, 3, U.gN);
  if (!U.uv) return;
  float M[3];
  for (int c = 0; c < 3; ++c) M[c] = P[c] - w[c];
  const float gu2 = U.guv[0] / 2.0f, gv2 = U.guv[1] / 2.0f;
  Acc au[3] = {}, av[3] = {};
  dot_bwd(av, gv2 / sv, M);
  dot_bwd(au, gu2 / su, M);
  put_acc(tab, disc ? T_DISC_U : T_PL_U, i, 3, au);
  put_acc(tab, disc ? T_DISC_V : T_PL_V, i, 3, av);
  put_acc(tab, disc ? T_DISC_C : T_PL_C, i, 3, b, true);
  const float gh = div_other(gv2, dot3(w + 12, M), sv);
  const float gw = div_other(gu2, dot3(w + 8, M), su);
  if (disc) {
    const float gr = gh + gw;
    put_row(tab, T_DISC_R, i, 1, &gr);
    return;
  }
  put_row(tab, T_PL_H, i, 1, &gh);
  put_row(tab, T_PL_W, i, 1, &gw);
  const float sh[2] = {0.0f + U.guv[0], U.guv[1] + 0.0f};
  put_row(tab, T_PL_SHIFT, i, 2, sh);
}

// attrs.py box_attrs' backward into P - c.  The normal's branch gives P_l
// torch.sign's zeros; the uv's hands each of w_d, h_d, l_d (P_l's
// selects) its faces' terms, the selected face's (the first whose
// condition holds) the gradient, the others +0 (one nonzero term a select,
// so their order is moot); then P_l's three dots, the last first.  The
// basis takes the normal's three products (the last first) and then P_l's
// three dots (the last first), each a full 3 x 3 of +0 around its row;
// whl its first entry's from s = 1.97 / whl[..., 0] (s's twelve products,
// v's faces last first, then u's); the centre -(M's).
template <bool TABLES>
__device__ __forceinline__ void box_bwd(const float* w, const float* P, const Up& U,
                                        float* g, float* const* tab, long long i) {
  float M[3], Pl[3], a[3], Nl[3];
  for (int c = 0; c < 3; ++c) M[c] = P[c] - w[12 + c];
  for (int k = 0; k < 3; ++k) Pl[k] = dot3(w + 4 * k, M);
  for (int k = 0; k < 3; ++k) a[k] = fabsf(Pl[k]) / w[4 * k + 3];
  const float Pmax = t_max3(a[0], a[1], a[2]);
  for (int k = 0; k < 3; ++k) Nl[k] = Pmax == a[k] ? t_sign(Pl[k]) : 0.0f;
  Acc pl[3] = {};
  float whl[3] = {0.0f, 0.0f, 0.0f};
  if (U.uv) {
    const float s = F32(2.0 * 0.985) / w[3];
    const int face = Nl[1] == -1.0f ? 0 : Nl[1] == 1.0f ? 1 : Nl[0] == 1.0f ? 2
                   : Nl[0] == -1.0f ? 3 : Nl[2] == 1.0f ? 4 : Nl[2] == -1.0f ? 5 : -1;
    const float gu = U.guv[0] / 4.0f, gv = U.guv[1] / 3.0f;
    // half(x) = div(x s + 1, 2) hands x (g / 2) s; half(-x) its negation
    auto half_g = [&](float gf, int f) { return (f == face ? gf : 0.0f) / 2.0f; };
    auto term = [&](float gf, int f, bool neg) {
      const float t = half_g(gf, f) * s;
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
    if (TABLES) {
      // s's products x * s hand s (g / 2) x
      const float xv[6] = {-Pl[2], Pl[2], Pl[1], Pl[1], Pl[1], Pl[1]};
      const float xu[6] = {Pl[0], Pl[0], Pl[2], -Pl[2], -Pl[0], Pl[0]};
      Acc gs = {};
      for (int f = 5; f >= 0; --f) acc_add(gs, half_g(gv, f) * xv[f]);
      for (int f = 5; f >= 0; --f) acc_add(gs, half_g(gu, f) * xu[f]);
      whl[0] = div_other(acc_val(gs), F32(2.0 * 0.985), w[3]);
    }
  }
  if (U.n)
    for (int c = 0; c < 3; ++c) acc_add(pl[c], 0.0f);
  Acc b[3] = {}, basis[9] = {};
  if (TABLES && U.n)
    for (int j = 2; j >= 0; --j)
      for (int e = 0; e < 9; ++e) acc_add(basis[e], e / 3 == j ? U.gN[e % 3] * Nl[j] : 0.0f);
  for (int k = 2; k >= 0; --k) {
    dot_bwd(b, acc_val(pl[k]), w + 4 * k);
    if (TABLES) {
      Acc r[3] = {};
      dot_bwd(r, acc_val(pl[k]), M);
      for (int e = 0; e < 9; ++e) acc_add(basis[e], e / 3 == k ? acc_val(r[e % 3]) : 0.0f);
    }
  }
  for (int c = 0; c < 3; ++c) g[c] = acc_val(b[c]);
  if (!TABLES) return;
  put_row(tab, T_BOX_WHL, i, 3, whl);
  put_acc(tab, T_BOX_B, i, 9, basis);
  put_acc(tab, T_BOX_C, i, 3, b, true);
}

// attrs.py cylinder_attrs' backward into P - c.  x, y, z (the dots of M
// with the u axis, the axis and the v axis) take, in the engine's order:
// with uv, the cap's z / r and x / r, the side's y / hh, atan2(z, x);
// with the normal, the cap's torch.sign(y) zeros, the side's
// (x ua + z va) / rho (z's, then x's), then rho = sqrt(clamp_min(x x +
// z z)) (z's two, then x's two); then the three dots, z's first.  The u
// and v axes take N_side's products (x ua, z va) and then their dots; the
// axis N_cap's sign(y) ax and then its dot; the radius the caps' z / r,
// then x / r; half_h y / hh; the centre -(M's).
template <bool TABLES>
__device__ __forceinline__ void cylinder_bwd(const float* w, const float* P, const Up& U,
                                             float* g, float* const* tab, long long i) {
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
  Acc X = {}, Y = {}, Z = {}, A[3] = {}, V[3] = {}, Ax[3] = {};
  float gr = 0.0f, gh = 0.0f;
  if (U.uv) {
    const float gu = U.guv[0], gv = U.guv[1];
    const float gzr = (cap ? gv : 0.0f) / 2.0f, gxr = (cap ? gu : 0.0f) / 2.0f;
    const float gyh = (cap ? 0.0f : gv) / 2.0f;
    acc_add(Z, gzr / r);
    acc_add(X, gxr / r);
    acc_add(Y, gyh / hh);
    if (TABLES) {
      gr = div_other(gzr, z, r) + div_other(gxr, x, r);
      gh = div_other(gyh, y, hh);
    }
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
    if (TABLES) {
      for (int c = 0; c < 3; ++c) t[c] = gS[c] * z;
      acc_row3(V, t);
      for (int c = 0; c < 3; ++c) t[c] = gS[c] * x;
      acc_row3(A, t);
      const float sy = t_sign(y);
      for (int c = 0; c < 3; ++c) t[c] = (cap ? U.gN[c] : 0.0f) * sy;
      acc_row3(Ax, t);
    }
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
  if (!TABLES) return;
  dot_bwd(V, acc_val(Z), M);
  dot_bwd(Ax, acc_val(Y), M);
  dot_bwd(A, acc_val(X), M);
  put_acc(tab, T_CYL_U, i, 3, A);
  put_acc(tab, T_CYL_V, i, 3, V);
  put_acc(tab, T_CYL_AX, i, 3, Ax);
  put_acc(tab, T_CYL_C, i, 3, b, true);
  put_row(tab, T_CYL_R, i, 1, &gr);
  put_row(tab, T_CYL_H, i, 1, &gh);
}

// The corners' blended normal N = Ns / safe_norm(Ns), Ns = (w1 vn1 +
// w2 vn2) + w3 vn3, at a triangle row, and its backward from N's
// gradient Nb: Ns's gradient gNs (the division's, then safe_norm's two
// products), the corners' normals a, b, c, Ns and its norm len.
struct Smooth {
  float a[3], b[3], c[3], Ns[3], len, gNs[3];
};
__device__ __forceinline__ void smooth_bwd(const Scene& S, long long row, float w1,
                                           float w2, float w3, const float* Nb, Smooth& m) {
  load3(S.vn1, row, m.a);
  load3(S.vn2, row, m.b);
  load3(S.vn3, row, m.c);
  for (int c = 0; c < 3; ++c) m.Ns[c] = (w1 * m.a[c] + w2 * m.b[c]) + w3 * m.c[c];
  const float s = tsum3(m.Ns[0] * m.Ns[0], m.Ns[1] * m.Ns[1], m.Ns[2] * m.Ns[2]);
  const float sc = t_clamp_min(s, F32(1e-30));
  m.len = s > 0.0f ? sqrtf(sc) : 0.0f;
  float t[3];
  for (int c = 0; c < 3; ++c) {
    m.gNs[c] = Nb[c] / m.len;
    t[c] = -Nb[c] * ((m.Ns[c] / m.len) / m.len);
  }
  const float glen = tsum3(t[0], t[1], t[2]);
  const float gr = s > 0.0f ? glen : 0.0f;
  const float gs = s >= F32(1e-30) ? sqrt_bwd(gr, sc) : 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float q = gs * m.Ns[c];
    m.gNs[c] = (m.gNs[c] + q) + q;
  }
}

// the blend's weights' gradients from Ns's: w3's, w2's, w1's
__device__ __forceinline__ void smooth_weights(const Smooth& m, Acc& W1, Acc& W2, Acc& W3) {
  acc_add(W3, tsum3(m.gNs[0] * m.c[0], m.gNs[1] * m.c[1], m.gNs[2] * m.c[2]));
  acc_add(W2, tsum3(m.gNs[0] * m.b[0], m.gNs[1] * m.b[1], m.gNs[2] * m.b[2]));
  acc_add(W1, tsum3(m.gNs[0] * m.a[0], m.gNs[1] * m.a[1], m.gNs[2] * m.a[2]));
}

// attrs.py triangle_attrs' backward into P (under instances, through
// ((P - trans) @ R) * inv_s).  The blend's weights w1 = (1 - u) - v, w2 = u,
// w3 = v take the uv blend's sums first (w3's, w2's, w1's), then the
// normal's (through N = Ns / safe_norm(Ns), under instances after the
// rotation back's three dots, the last first); then u and v (v takes w3
// and -w1, u w2 and -w1), the barycentric solve (v's products first) and
// its two dots, dp2's first.  The tables: the corners' normals and uvs
// their blends' products; the solve's dots (dp2, dp1, d22, d12, d11, after
// the numerators' products, v's first, and det's) into e1, e2 and d; p2
// and p3 take e1's and e2's, p1 -(d's), -(e2's), -(e1's); under instances
// the rotation the normal's three rows (the last first) and then the
// hit's three columns, the translation -(Pt's), the inverse scale its
// product's sum over the three; the face normal, unblended, its own.
// Without uv or corners (the normal the face's alone) P takes none.
template <bool TABLES>
__device__ __forceinline__ void triangle_bwd(const Scene& S, long long local,
                                             const float* Pw, const Up& U, bool need_uv,
                                             float* g, float* const* tab, long long i) {
  long long row = local;
  float R[9], P[3], Pt[3], Q[3], inv_s = 1.0f;
  const bool inst = S.virt_row != nullptr;
  for (int c = 0; c < 3; ++c) P[c] = Pw[c];
  if (inst) {
    row = __ldg(S.virt_row + local);
    const long long k = __ldg(S.virt_inst + local);
    for (int j = 0; j < 9; ++j) R[j] = __ldg(S.inst_rot + 9 * k + j);
    for (int c = 0; c < 3; ++c) Pt[c] = Pw[c] - __ldg(S.inst_trans + 3 * k + c);
    inv_s = __ldg(S.inst_inv_scale + k);
    for (int j = 0; j < 3; ++j) {
      const float col[3] = {R[j], R[3 + j], R[6 + j]};
      Q[j] = dot3(col, Pt);
      P[j] = Q[j] * inv_s;
    }
  }
  const bool interp = S.vn1 != nullptr;
  Acc rot[9] = {};
  float Nobj[3];              // the normal to_world rotates, object space
  float Nb[3];                // its gradient
  if (U.n) {
    if (inst) {
      Acc nb[3] = {};
      for (int j = 2; j >= 0; --j) dot_bwd(nb, U.gN[j], R + 3 * j);
      for (int c = 0; c < 3; ++c) Nb[c] = acc_val(nb[c]);
    } else {
      for (int c = 0; c < 3; ++c) Nb[c] = U.gN[c];
    }
    if (TABLES && !interp) put_row(tab, T_TRI_N, i, 3, Nb);
  }
  // to_world's rows of the rotation, the last first
  auto rot_rows = [&]() {
    if (TABLES && inst && U.n)
      for (int j = 2; j >= 0; --j) {
        Acc r[3] = {};
        dot_bwd(r, U.gN[j], Nobj);
        for (int e = 0; e < 9; ++e) acc_add(rot[e], e / 3 == j ? acc_val(r[e % 3]) : 0.0f);
      }
  };
  if (TABLES) load3(S.tri_normal, row, Nobj);
  if (!(need_uv || interp)) {
    for (int c = 0; c < 3; ++c) g[c] = 0.0f;
    rot_rows();
    if (TABLES && inst && U.n) put_acc(tab, T_ROT, i, 9, rot);
    return;
  }
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
  const float C = d11 * d22 - d12 * d12;
  const float det = t_clamp_min(C, F32(1e-20));
  const float un = d22 * dp1 - d12 * dp2, vn = d11 * dp2 - d12 * dp1;
  const float u = un / det, v = vn / det;
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
      if (TABLES) {
        float r1[2], r2[2], r3[2];
        for (int c = 0; c < 2; ++c) {
          r1[c] = U.guv[c] * w1;
          r2[c] = U.guv[c] * w2;
          r3[c] = U.guv[c] * w3;
        }
        put_row(tab, T_UV1, i, 2, r1);
        put_row(tab, T_UV2, i, 2, r2);
        put_row(tab, T_UV3, i, 2, r3);
      }
    }
    if (U.n) {
      Smooth m;
      smooth_bwd(S, row, w1, w2, w3, Nb, m);
      if (TABLES) {
        float r1[3], r2[3], r3[3];
        for (int c = 0; c < 3; ++c) {
          Nobj[c] = m.Ns[c] / m.len;
          r1[c] = m.gNs[c] * w1;
          r2[c] = m.gNs[c] * w2;
          r3[c] = m.gNs[c] * w3;
        }
        put_row(tab, T_VN1, i, 3, r1);
        put_row(tab, T_VN2, i, 3, r2);
        put_row(tab, T_VN3, i, 3, r3);
      }
      smooth_weights(m, W1, W2, W3);
    }
    acc_add(gv, W3.v);
    acc_add(gu, W2.v);
    acc_add(gv, -W1.v);
    acc_add(gu, -W1.v);
  }
  const float gsv = gv.v / det, gsu = gu.v / det;
  const float g1 = -gsv * d12 + gsu * d22;
  const float g2 = gsv * d11 + -gsu * d12;
  Acc bd[3] = {};
  dot_bwd(bd, g2, e2);
  dot_bwd(bd, g1, e1);
  if (TABLES) {
    // u = un / det, v = vn / det (v's node first), det = clamp_min(C);
    // the numerators' products (v's, then u's), then det's C = A - B,
    // A = d11 d22, B = d12 d12
    Acc gdet = {};
    acc_add(gdet, div_other(gv.v, vn, det));
    acc_add(gdet, div_other(gu.v, un, det));
    const float gC = C >= F32(1e-20) ? acc_val(gdet) : 0.0f;
    Acc g11 = {}, g12 = {}, g22 = {};
    acc_add(g12, -gsv * dp1);
    acc_add(g11, gsv * dp2);
    acc_add(g12, -gsu * dp2);
    acc_add(g22, gsu * dp1);
    acc_add(g12, -gC * d12);
    acc_add(g12, -gC * d12);
    acc_add(g11, gC * d22);
    acc_add(g22, gC * d11);
    // the dots, dp2's chain first: e1 and e2 take their rows in the
    // chains' order
    Acc be1[3] = {}, be2[3] = {};
    dot_bwd(be2, g2, d);
    dot_bwd(be1, g1, d);
    dot_self_bwd(be2, acc_val(g22), e2);
    dot_bwd(be2, acc_val(g12), e1);
    dot_bwd(be1, acc_val(g12), e2);
    dot_self_bwd(be1, acc_val(g11), e1);
    Acc gp1[3] = {};
    float t[3];
    for (int c = 0; c < 3; ++c) t[c] = -acc_val(bd[c]);
    acc_row3(gp1, t);
    for (int c = 0; c < 3; ++c) t[c] = -acc_val(be2[c]);
    acc_row3(gp1, t);
    for (int c = 0; c < 3; ++c) t[c] = -acc_val(be1[c]);
    acc_row3(gp1, t);
    put_acc(tab, T_TRI_P1, i, 3, gp1);
    put_acc(tab, T_TRI_P2, i, 3, be1);
    put_acc(tab, T_TRI_P3, i, 3, be2);
  }
  if (!inst) {
    for (int c = 0; c < 3; ++c) g[c] = acc_val(bd[c]);
    return;
  }
  // the hit's object space ((P - trans) @ R) * inv_s: d's gradient is its
  float gQ[3];
  for (int c = 0; c < 3; ++c) gQ[c] = acc_val(bd[c]) * inv_s;
  rot_rows();
  Acc pt[3] = {};
  for (int j = 2; j >= 0; --j) {
    const float col[3] = {R[j], R[3 + j], R[6 + j]};
    if (TABLES) {
      Acc cc[3] = {};
      dot_bwd(cc, gQ[j], Pt);
      for (int e = 0; e < 9; ++e) acc_add(rot[e], e % 3 == j ? acc_val(cc[e / 3]) : 0.0f);
    }
    dot_bwd(pt, gQ[j], col);
  }
  for (int c = 0; c < 3; ++c) g[c] = acc_val(pt[c]);
  if (!TABLES) return;
  float gPo[3];
  for (int c = 0; c < 3; ++c) gPo[c] = acc_val(bd[c]);
  const float gis = tsum3(gPo[0] * Q[0], gPo[1] * Q[1], gPo[2] * Q[2]);
  put_row(tab, T_INVS, i, 1, &gis);
  put_acc(tab, T_ROT, i, 9, rot);
  put_acc(tab, T_TRANS, i, 3, pt, true);
}

// ---------------------------------------------------------------------------
// the normal maps' backward (the MAPS instance)
// ---------------------------------------------------------------------------
//
// ops/hit_attrs.py `_apply_normal_maps` computes every ref's mapped normal
// Nm over every ray and keeps it by torch.where where the ref's mask
// holds, the last ref's where applied last.  Its VJP, in the engine's
// order: the refs last first, ref r's Nm taking where(mask, g, 0) and its
// whole graph running before the earlier ref's where; the first ref's
// where hands the geometric normal N_geo its remainder before that ref's
// own graph runs.  Each ref's graph hands the map's decoded texel m its
// gradient (then its texture's taps and, bilinear, uv), and a sphere's or
// a mesh's hands N_geo its share (the orders read off the plain stage's
// graph, node by node); a plane's or a box's is a 3 x 3 product.  N_geo's
// and uv's buffers then take the kinds' backward in place of the output
// gradients.

// _unit(v) = v / clamp_min(safe_norm(v), 1e-20): v's gradient from the
// unit vector's g (the division's, then safe_norm's two products)
__device__ __forceinline__ void unit_bwd(const float* v, const float* g, float* gv) {
  const float x = tsum3(v[0] * v[0], v[1] * v[1], v[2] * v[2]);
  const float xc = t_clamp_min(x, F32(1e-30));
  const float r = x > 0.0f ? sqrtf(xc) : 0.0f;
  const float c = t_clamp_min(r, F32(1e-20));
  float t[3];
  for (int k = 0; k < 3; ++k) t[k] = -g[k] * ((v[k] / c) / c);
  const float gc = tsum3(t[0], t[1], t[2]);
  const float gr = r >= F32(1e-20) && x > 0.0f ? gc : 0.0f;
  const float gx = x >= F32(1e-30) ? sqrt_bwd(gr, xc) : 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float q = gx * v[k];
    gv[k] = (g[k] / c + q) + q;
  }
}

// _cross(a, b)'s backward of g into a's buffer ga and b's gb: the
// components last first, each difference's second product first, each
// product's b select before its a select
__device__ __forceinline__ void cross_bwd(const float* a, const float* b, const float* g,
                                          Acc* ga, Acc* gb) {
  for (int k = 2; k >= 0; --k) {
    const int i = (k + 1) % 3, j = (k + 2) % 3;
    const float gm = -g[k];
    add_row3(gb, i, gm * a[j]);
    add_row3(ga, j, gm * b[i]);
    add_row3(gb, j, g[k] * a[i]);
    add_row3(ga, i, g[k] * b[j]);
  }
}

// Nm = _unit(2 ((m0 T + m1 B) + m2 N)) of a sphere's or a mesh's frame:
// from Nm's gradient g, the sum's gradient gS (the unit's, times 2), N's
// share of C = m2 N into ng, B's gradient gB, T's buffer Tb (m0 T's
// share first) and m's (its three slices, m2's first)
__device__ __forceinline__ void frame_bwd(const float* T, const float* B, const float* N,
                                          const float* m, const float* g, Acc* ng,
                                          float* gB, Acc* Tb, float* gm) {
  float v[3], gv[3], gS[3], t[3];
  for (int c = 0; c < 3; ++c) v[c] = 2.0f * ((m[0] * T[c] + m[1] * B[c]) + m[2] * N[c]);
  unit_bwd(v, g, gv);
  for (int c = 0; c < 3; ++c) {
    gS[c] = gv[c] * 2.0f;
    t[c] = gS[c] * m[2];
  }
  acc_row3(ng, t);
  const float gm2 = tsum3(gS[0] * N[0], gS[1] * N[1], gS[2] * N[2]);
  for (int c = 0; c < 3; ++c) gB[c] = gS[c] * m[1];
  const float gm1 = tsum3(gS[0] * B[0], gS[1] * B[1], gS[2] * B[2]);
  for (int c = 0; c < 3; ++c) t[c] = gS[c] * m[0];
  acc_row3(Tb, t);
  const float gm0 = tsum3(gS[0] * T[0], gS[1] * T[1], gS[2] * T[2]);
  Acc mb[3] = {};
  add_row3(mb, 2, gm2);
  add_row3(mb, 1, gm1);
  add_row3(mb, 0, gm0);
  for (int c = 0; c < 3; ++c) gm[c] = acc_val(mb[c]);
}

// a sphere ref: s = sqrt(clamp_min(N0^2 + N2^2, 1e-12)), T = (-N2 / s, 0,
// N0 / s), B = T x N
__device__ __forceinline__ void sphere_map_bwd(const float* N, const float* m,
                                               const float* g, Acc* ng, float* gm) {
  const float q = N[0] * N[0] + N[2] * N[2];
  const float qc = t_clamp_min(q, F32(1e-12));
  const float s = sqrtf(qc);
  const float nN2 = -N[2];
  const float T[3] = {nN2 / s, 0.0f, N[0] / s};
  float B[3], gB[3];
  cross3(T, N, B);
  Acc Tb[3] = {};
  frame_bwd(T, B, N, m, g, ng, gB, Tb, gm);
  cross_bwd(T, N, gB, Tb, ng);
  // T's stack: N0 / s's node first, then (-N2) / s's
  const float gT0 = acc_val(Tb[0]), gT2 = acc_val(Tb[2]);
  Acc gs = {};
  add_row3(ng, 0, gT2 / s);
  acc_add(gs, -gT2 * ((N[0] / s) / s));
  add_row3(ng, 2, -(gT0 / s));
  acc_add(gs, -gT0 * ((nN2 / s) / s));
  const float gq = q >= F32(1e-12) ? sqrt_bwd(acc_val(gs), qc) : 0.0f;
  // the squares, N2's first
  add_row3(ng, 2, gq * (2.0f * N[2]));
  add_row3(ng, 0, gq * (2.0f * N[0]));
}

// a mesh ref: T = _unit(T0 - N (T0 . N)), T0 the face's tangent (rotated
// under instances), B = sign (N x T); gt: T0's gradient (the difference's,
// then T0 N's) and the sign's
__device__ __forceinline__ void tri_map_bwd(const float* N, const float* T0, float sg,
                                            const float* m, const float* g, Acc* ng,
                                            float* gm, float* gt) {
  const float d = tsum3(T0[0] * N[0], T0[1] * N[1], T0[2] * N[2]);
  float T1[3], T[3], X[3], B[3], gB[3], gX[3], gT[3], gT1[3], t[3];
  for (int c = 0; c < 3; ++c) T1[c] = T0[c] - N[c] * d;
  for (int c = 0; c < 3; ++c) T[c] = T1[c];
  unit3(T);
  cross3(N, T, X);
  for (int c = 0; c < 3; ++c) B[c] = sg * X[c];
  Acc Tb[3] = {};
  frame_bwd(T, B, N, m, g, ng, gB, Tb, gm);
  for (int c = 0; c < 3; ++c) gX[c] = gB[c] * sg;
  gt[3] = tsum3(gB[0] * X[0], gB[1] * X[1], gB[2] * X[2]);
  cross_bwd(N, T, gX, ng, Tb);
  for (int c = 0; c < 3; ++c) gT[c] = acc_val(Tb[c]);
  unit_bwd(T1, gT, gT1);
  // T1 = T0 - N d: N d's node, then T0 N's
  for (int c = 0; c < 3; ++c) t[c] = -gT1[c] * d;
  acc_row3(ng, t);
  const float gd = tsum3(-gT1[0] * N[0], -gT1[1] * N[1], -gT1[2] * N[2]);
  for (int c = 0; c < 3; ++c) t[c] = gd * T0[c];
  acc_row3(ng, t);
  for (int c = 0; c < 3; ++c) gt[c] = gT1[c] + gd * N[c];
}

// r = a @ M^T of a (3) and M (3, 3) row-major: the 3 x 3 product's
// backward into its left factor (`mm3`'s order, M's rows)
__device__ __forceinline__ void mm3t(const float* a, const float* M, float* r) {
  for (int k = 0; k < 3; ++k)
    r[k] = fmaf(a[2], M[3 * k + 2], fmaf(a[1], M[3 * k + 1], fmaf(a[0], M[3 * k], 0.0f)));
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
  // the geometry tables' per-ray rows (TABLE order; null where not
  // wanted), written by the TABLES instance
  float* tab[N_TABLES];
  // where a map's texture takes a gradient, every ref's taps' rows
  // (texture_fetch.cuh `tap_rows`, refs in order; the MAPS instance)
  texture_fetch::TapRows map_taps;
  // where a table the maps read takes a gradient, (maps, n, 6) rows a ref:
  // a plane's or a box's product's left factor (m 2) and its gradient, a
  // mesh's tangent's gradient and its sign's (the MAPS instance)
  float* map_rows;
};

// The maps' backward at ray i (see above): from the oriented normal's
// gradient gNo, the gradients of the ray's geometric normal (ng) and uv
// (ub, holding uv's output gradient where it takes one); the maps' taps'
// rows.  N_geo, uv: the ray's own kind's.
__device__ __forceinline__ void maps_bwd(const Scene& S, const RaysBwd& B, long long i,
                                         long long o, const float* N, const float* uv,
                                         const float* gNo, Acc* ng, Acc* ub) {
  const long long tri_off = S.counts[0] + S.counts[1] + S.counts[2] + S.counts[3]
                            + S.counts[4];
  const int slot = map_slot(S, o, tri_off);
  const bool taps = B.map_taps.rows != nullptr;
  int plane = taps ? texture_fetch::tap_planes_total(S.map_tex, (int)S.n_maps) : 0;
  float cur[3] = {gNo[0], gNo[1], gNo[2]};
  for (int r = (int)S.n_maps - 1; r >= 0; --r) {
    const bool holds = map_holds(S, r, o, tri_off, slot);
    float g[3], m[3], gm[3];
    for (int c = 0; c < 3; ++c) {
      g[c] = holds ? cur[c] : 0.0f;
      cur[c] = holds ? 0.0f : cur[c];
    }
    // the first ref's where hands N_geo its remainder before its graph
    if (r == 0) acc_row3(ng, cur);
    texture_fetch::fetch_texture(S.map_tex, r, uv[0], uv[1], m);
    for (int k = 0; k < 3; ++k) m[k] = m[k] - 0.5f;
    const int kind = S.map_i[4 * r + 1];
    float* rows = B.map_rows ? B.map_rows + 6 * ((long long)r * B.n + i) : nullptr;
    if (kind == MAP_PLANE || kind == MAP_BOX) {
      float a[3], v[3], gv[3], ga[3];
      for (int k = 0; k < 3; ++k) a[k] = m[k] * 2.0f;
      mm3(a, S.map_basis + 9 * r, v);
      unit_bwd(v, g, gv);
      mm3t(gv, S.map_basis + 9 * r, ga);
      for (int k = 0; k < 3; ++k) gm[k] = ga[k] * 2.0f;
      if (rows)
        for (int k = 0; k < 3; ++k) {
          rows[k] = a[k];
          rows[3 + k] = gv[k];
        }
    } else if (kind == MAP_SPHERE) {
      sphere_map_bwd(N, m, g, ng, gm);
    } else {
      const MeshRow mr = mesh_row(S, o, tri_off);
      const long long row = clip_row(mr.row, S.tan_rows);
      float T0[3];
      load3(S.tri_tan, row, T0);
      if (mr.inst >= 0) {
        const float* R = S.inst_rot + 9 * mr.inst;
        float Tr[3];
        for (int j = 0; j < 3; ++j)
          Tr[j] = tsum3(__ldg(R + 3 * j) * T0[0], __ldg(R + 3 * j + 1) * T0[1],
                        __ldg(R + 3 * j + 2) * T0[2]);
        for (int j = 0; j < 3; ++j) T0[j] = Tr[j];
      }
      float gt[4];
      tri_map_bwd(N, T0, __ldg(S.tri_tan_sign + row), m, g, ng, gm, gt);
      if (rows)
        for (int k = 0; k < 4; ++k) rows[k] = gt[k];
    }
    // m = fetch - 0.5: the fetch's taps and, bilinear, uv's two selects
    if (taps) {
      plane -= texture_fetch::tap_planes(S.map_tex, r);
      texture_fetch::tap_rows(S.map_tex, r, uv[0], uv[1], gm, B.map_taps, plane, B.n, i);
    }
    if (ub != nullptr && (S.map_tex.desc_i[4 * r + 3] & 2)) {
      float gu, gv;
      texture_fetch::bilinear_bwd(S.map_tex, r, uv[0], uv[1], gm, &gu, &gv, Sum3());
      acc_add(ub[0], 0.0f);
      acc_add(ub[1], gv);
      acc_add(ub[0], gu);
      acc_add(ub[1], 0.0f);
    }
  }
}

// whether a kind's formula has an op on P that the output gradients reach
__device__ __forceinline__ bool kind_reached(const Scene& S, int kind, const Up& U) {
  if (kind == 1 || kind == 3) return U.uv;
  if (kind == KINDS - 1) return U.uv || (U.n && S.vn1 != nullptr);
  return U.n || U.uv;
}

// whether a table of the kind is wanted
__device__ __forceinline__ bool kind_tables(const RaysBwd& B, int kind) {
  const int first[KINDS + 1] = {T_SPH_C, T_PL_N, T_BOX_B, T_DISC_N, T_CYL_AX, T_TRI_N,
                                N_TABLES};
  for (int t = first[kind]; t < first[kind + 1]; ++t)
    if (B.tab[t]) return true;
  return false;
}

template <bool MAPS, bool TABLES>
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
  if (MAPS && own.n) {
    // the geometric normal and uv take the maps' backward (uv its output
    // gradient first)
    float Ng[3] = {0.0f, 0.0f, 0.0f}, uvg[2] = {0.0f, 0.0f};
    geometric(S, P, o, B.need_uv != 0, Ng, uvg);
    Acc ng[3] = {}, ub[2] = {};
    if (own.uv)
      for (int c = 0; c < 2; ++c) acc_add(ub[c], own.guv[c]);
    maps_bwd(S, B, i, o, Ng, uvg, own.gN, ng, B.need_uv ? ub : nullptr);
    for (int c = 0; c < 3; ++c) own.gN[c] = acc_val(ng[c]);
    if (ub[0].has) {
      own.uv = true;
      for (int c = 0; c < 2; ++c) own.guv[c] = acc_val(ub[c]);
    }
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
    // a kind whose formula takes no gradient into P adds nothing to it; in
    // the TABLES instance it still writes its wanted tables' rows
    const bool reached = kind_reached(S, kind, U);
    if (!reached && !(TABLES && kind_tables(B, kind))) continue;
    const long long local = clip_row(o - offs[kind], count);
    float g[3];
    if (kind == KINDS - 1) {
      triangle_bwd<TABLES>(S, local, P, U, B.need_uv != 0, g, B.tab, i);
    } else {
      float w[ROW];
      row_words(S.rows, offs[kind] + local, w);
      switch (kind) {
        case 0: sphere_bwd<TABLES>(w, P, U, g, B.tab, i); break;
        case 1: planar_bwd<TABLES>(w, P, U, false, g, B.tab, i); break;
        case 2: box_bwd<TABLES>(w, P, U, g, B.tab, i); break;
        case 3: planar_bwd<TABLES>(w, P, U, true, g, B.tab, i); break;
        default: cylinder_bwd<TABLES>(w, P, U, g, B.tab, i); break;
      }
    }
    if (reached)
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

// The backward's instances: BWD_LEAN, BWD_TABLES (that also writes the
// geometry tables' rows) and BWD_MAPS (the normal-mapped scenes' outside
// the first-hit pass, the tables' rows too)
constexpr int BWD_LEAN = 0, BWD_TABLES = 1, BWD_MAPS = 2;

template <int MODE>
__global__ void __launch_bounds__(ATTR_BLOCK)
hit_attrs_bwd_kernel(Scene S, RaysBwd B) {
  const long long stride = (long long)gridDim.x * ATTR_BLOCK;
  for (long long i = (long long)blockIdx.x * ATTR_BLOCK + threadIdx.x; i < B.n;
       i += stride)
    attrs_bwd_ray<MODE == BWD_MAPS, MODE != BWD_LEAN>(S, B, i);
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
    else if (op == 4)
      mm3t(x + 3 * i, y, out + 3 * i);
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

bool any_table(const RaysBwd& B) {
  for (int t = 0; t < N_TABLES; ++t)
    if (B.tab[t]) return true;
  return false;
}

bool bwd_ok(const RaysBwd& B) {
  return B.n >= 1 && B.O && B.D && B.t && B.obj && (B.first_hit || !B.gN || B.orient)
         && (!B.guv || B.need_uv) && (B.gP || B.gN || B.guv || B.geps)
         && (B.dO || B.dD || B.dt || any_table(B) || B.map_taps.rows || B.map_rows)
         && (!B.map_rows || B.gN)
         && (!B.map_taps.rows || (B.map_taps.idx && B.gN));
}

}  // namespace w5

using namespace w5;

template <int MODE>
cudaError_t launch_bwd(const Scene& S, const RaysBwd& B, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = grid_for(hit_attrs_bwd_kernel<MODE>, B.n, &grid);
  if (err != cudaSuccess) return err;
  LAUNCH(hit_attrs_bwd_kernel<MODE>, grid, ATTR_BLOCK, 0, stream, S, B);
  return cudaGetLastError();
}

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

// The gradients of the rays' O, D and t, the wanted geometry tables'
// per-ray rows (the TABLES instance) and the maps' texture taps' rows,
// from those of the attributes (B) against the scene S (ops/hit_attrs.py
// builds both), one launch: the MAPS instance where the scene maps
// normals and this is no first-hit pass.  Returns 0 or a CUDA error, and sets *launched to the
// kernels launched.
extern "C" int hit_attrs_bwd(const Scene* S, const RaysBwd* B, void* stream,
                             int* launched) {
  *launched = 0;
  const bool maps = S->n_maps > 0 && !B->first_hit;
  if (!scene_ok(*S) || !bwd_ok(*B) || (!maps && (B->map_taps.rows || B->map_rows)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = maps ? launch_bwd<BWD_MAPS>(*S, *B, st)
                          : any_table(*B) ? launch_bwd<BWD_TABLES>(*S, *B, st)
                                          : launch_bwd<BWD_LEAN>(*S, *B, st);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// What a kernel was built to (which: 0 the kernel's instance without maps,
// 1 its MAPS instance, 2 the backward, 3 its TABLES instance, 4 its MAPS
// instance; see kernel_info).
extern "C" int hit_attrs_info(int which, int* out) {
  if (which == 2) return (int)kernel_info(hit_attrs_bwd_kernel<BWD_LEAN>, out);
  if (which == 3) return (int)kernel_info(hit_attrs_bwd_kernel<BWD_TABLES>, out);
  if (which == 4) return (int)kernel_info(hit_attrs_bwd_kernel<BWD_MAPS>, out);
  return (int)(which ? kernel_info(hit_attrs_kernel<true>, out)
                     : kernel_info(hit_attrs_kernel<false>, out));
}

// out[i] = W5's atan2(x[i], y[i]) (op 0), asin(x[i]) (op 1) or rsqrt(x[i])
// (op 3), n floats; or (op 2) out's row i = x's row i @ y, (op 4) x's row
// i @ y^T (the product's backward into its left factor), n rows.  For
// chip_smoke.py and the card tests, which hold them against torch.
extern "C" int hit_attrs_math(int op, const float* x, const float* y, long long n,
                              float* out, void* stream, int* launched) {
  *launched = 0;
  if (op < 0 || op > 4 || !x || ((op == 0 || op == 2 || op == 4) && !y) || !out || n < 1)
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
