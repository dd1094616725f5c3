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
// The entry returns cudaGetLastError() after its launch and reports the
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

// W5's atan2 (op 0: atan2(x, y)), asin (op 1: asin(x)) of n floats, or its
// 3 x 3 product (op 2: row i of out = row i of x @ y, x (n, 3), y (3, 3)),
// as the kernel computes them: for the holds against torch.
__global__ void __launch_bounds__(ATTR_BLOCK)
math_kernel(int op, const float* x, const float* y, long long n, float* out) {
  const long long stride = (long long)gridDim.x * ATTR_BLOCK;
  for (long long i = (long long)blockIdx.x * ATTR_BLOCK + threadIdx.x; i < n;
       i += stride) {
    if (op == 2)
      mm3(x + 3 * i, y, out + 3 * i);
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

// What the kernel's instance MAPS was built to: out[0] registers a
// thread, out[1] local memory a thread (bytes: spills and stack), out[2]
// resident blocks an SM, out[3] the SMs, out[4] ATTR_BLOCK.
template <bool MAPS>
cudaError_t attrs_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, hit_attrs_kernel<MAPS>);
  if (err == cudaSuccess) err = residency(hit_attrs_kernel<MAPS>, &out[3], &out[2]);
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

// What the kernel was built to (maps: its MAPS instance; see attrs_info).
extern "C" int hit_attrs_info(int maps, int* out) {
  return (int)(maps ? attrs_info<true>(out) : attrs_info<false>(out));
}

// out[i] = W5's atan2(x[i], y[i]) (op 0) or asin(x[i]) (op 1), n floats; or
// (op 2) out's row i = x's row i @ y, n rows.  For chip_smoke.py and the
// card tests, which hold them against torch.
extern "C" int hit_attrs_math(int op, const float* x, const float* y, long long n,
                              float* out, void* stream, int* launched) {
  *launched = 0;
  if (op < 0 || op > 2 || !x || (op != 1 && !y) || !out || n < 1)
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
