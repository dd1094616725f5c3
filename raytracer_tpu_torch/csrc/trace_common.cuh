// Device functions shared by the solid kernel (solid_trace.cu) and the
// record kernel (record_trace.cu): the scene-table layout, the random
// draws (the R2 lattice bits of core/lds.py and the murmur3 hash of the
// Pallas kernels' _TileRng), camera ray generation for every projection,
// the sphere / plane / box / triangle / disc / cylinder intersectors and
// normals, the polynomial atan2, and complex helpers.  Each is the formula
// of raytracer_tpu/ops/pallas_trace.py:68-500, in the same operation
// order, so that with --fmad=false the kernels round as their plain
// PyTorch versions do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Dynamic shared memory and the kernel launch.  The CPU stand-in of the
// CUDA runtime (csrc/emu/cuda_runtime.h, with which the tests compile
// these sources by g++) defines CUDA_EMU and both macros its own way.
#ifndef CUDA_EMU
#define EXTERN_SHARED extern __shared__
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace {

// Dynamic shared memory a block gets without opting in.  Past it a kernel
// must be opted in (smem_opt_in), up to the card's
// cudaDevAttrMaxSharedMemoryPerBlockOptin (227 KB on the H100).
constexpr size_t SMEM_DEFAULT = 48 * 1024;

// Let `kernel` take `smem` bytes of dynamic shared memory on device `dev`:
// at SMEM_DEFAULT or less nothing is set, so such launches are what they
// were; past it the kernel's cudaFuncAttributeMaxDynamicSharedMemorySize
// is raised to `smem`, and past the card's opt-in maximum this returns
// cudaErrorInvalidValue.  Call it before an occupancy query or a launch at
// that size.
template <class K>
cudaError_t smem_opt_in(K kernel, size_t smem, int dev) {
  if (smem <= SMEM_DEFAULT) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

constexpr int BLOCK = 128;
constexpr int GEOM_COLS = 24;
constexpr int OBJ_COLS = 16;
// object-table columns (core/compile.py); OBJ_HU1 / OBJ_HU2 number the
// dispersive groups of the solid / record kernel, -1 elsewhere
constexpr int OBJ_KIND = 0, OBJ_MAT_TYPE = 1, OBJ_MAT_SLOT = 2,
              OBJ_MAX_DEPTH = 3, OBJ_MC = 4, OBJ_SHADOW = 5, OBJ_DISP = 6,
              OBJ_AA_N = 7, OBJ_AA_NSIGN = 8, OBJ_AA_U = 9, OBJ_AA_V = 10,
              OBJ_GID = 11, OBJ_UV = 12, OBJ_IMG = 13, OBJ_HU1 = 14,
              OBJ_HU2 = 15;
constexpr int KIND_SPHERE = 0, KIND_PLANE = 1, KIND_BOX = 2, KIND_TRI = 3,
              KIND_DISC = 4, KIND_CYL = 5;
constexpr int MAT_EMISSIVE = 1, MAT_GLOSSY = 2, MAT_DIFFUSE = 3,
              MAT_REFRACTIVE = 4, MAT_THINFILM = 5, MAT_ENV = 6;
// camera projections (ops/solid_trace.py PROJECTIONS)
constexpr int PROJ_PINHOLE = 0, PROJ_FISHEYE = 1, PROJ_EQUIRECT = 2,
              PROJ_ORTHOGRAPHIC = 3;

// Constants are written as double literals cast to float: the JAX and
// torch versions round python floats (doubles) to float32 the same way.
#define F(x) ((float)(x))
constexpr double PI = 3.14159265358979323846;
const float FARAWAY = F(1.0e30);
const float MISS_THRESHOLD = F(1.0e29);
const float SKYBOX_DISTANCE = F(1.0e6);
const float INV_2_24 = F(1.0 / (1 << 24));

// R2 generators and rotation salts (core/lds.py ALPHA, DIM_SALT)
__constant__ uint32_t R2_ALPHA[8] = {
    0xc13fa9a9u, 0x91e10da5u, 0xd1b54a32u, 0xabc98388u,
    0xdb4f0b91u, 0xbbe05633u, 0xa0f2ec75u, 0x8cb92ba7u};
__constant__ uint32_t R2_SALT[8] = {
    0x3c6ef372u, 0x9e3779b9u, 0x85ebca77u, 0xc2b2ae3du,
    0x27220a95u, 0x6180339bu, 0xb5297a4du, 0x68e31da5u};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return (float)(int)(b >> 8) * INV_2_24;
}

// _TileRng.uniform with its counter value
__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed,
                                              uint32_t counter) {
  uint32_t x = idx * 0x9E3779B1u;
  x ^= seed + counter * 0x85EBCA6Bu;
  return bits_to_unit(mix32(x));
}

__device__ __forceinline__ float r2_unit(uint32_t pix, uint32_t s,
                                         uint32_t seed, int dim) {
  uint32_t rot = mix32((pix * 0x9E3779B1u) ^ (seed + R2_SALT[dim]));
  return bits_to_unit(rot + s * R2_ALPHA[dim]);
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, F(1e-30)));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// (sin, cos) of 2*pi*u: the reference's quarter-wave polynomials
__device__ __forceinline__ void sincos_2pi(float u, float& sin_v, float& cos_v) {
  float t = u - floorf(u);
  float x4 = t * 4.0f;
  float q = floorf(x4);
  float r = x4 - q;
  float r2 = r * r;
  float s = r * (F(1.57079632) + r2 * (F(-0.64596375) + r2 * (F(0.07968996)
                 + r2 * (F(-0.00467430) + r2 * F(0.00015179)))));
  float c = F(0.99999996) + r2 * (F(-1.23369862) + r2 * (F(0.25365306)
            + r2 * (F(-0.02081478) + r2 * F(0.00086048))));
  if (q == 1.0f) { sin_v = c; cos_v = -s; }
  else if (q == 2.0f) { sin_v = -s; cos_v = -c; }
  else if (q == 3.0f) { sin_v = -c; cos_v = s; }
  else { sin_v = s; cos_v = c; }
}

// (u, v) orthonormal to n (pallas_trace.py _orthobasis)
__device__ __forceinline__ void orthobasis(float nx, float ny, float nz,
                                           float u[3], float v[3]) {
  bool big = fabsf(nx) > F(0.9);
  float ax = big ? 0.0f : 1.0f;
  float ay = big ? 1.0f : 0.0f;
  float vx = ny * 0.0f - nz * ay;
  float vy = nz * ax - nx * 0.0f;
  float vz = nx * ay - ny * ax;
  normalize3(vx, vy, vz);
  u[0] = ny * vz - nz * vy;
  u[1] = nz * vx - nx * vz;
  u[2] = nx * vy - ny * vx;
  v[0] = vx; v[1] = vy; v[2] = vz;
}

// the reference's polynomial atan2 and asin (pallas_trace.py:121-135)
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float a = fminf(ax, ay) / fmaxf(fmaxf(ax, ay), F(1e-30));
  const float s = a * a;
  float r = a * (F(0.9998660) + s * (F(-0.3302995) + s * (F(0.1801410)
                 + s * (F(-0.0851330) + s * F(0.0208351)))));
  if (ay > ax) r = F(PI / 2) - r;
  if (x < 0.0f) r = F(PI) - r;
  return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float asin_poly(float x) {
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  return atan2_poly(x, sqrtf(fmaxf(1.0f - x * x, 0.0f)));
}

// x ** 5 as lax.integer_pow computes it: x * ((x * x) * (x * x))
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// the mirror direction d - 2 (d.n) n, normalised
__device__ __forceinline__ void reflect(const float d[3], const float n[3],
                                        float r[3]) {
  const float ddn = dot3(d, n);
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = d[k] - n[k] * 2.0f * ddn;
  normalize3(r[0], r[1], r[2]);
}

// camera ray of every projection (pallas_trace.py:162-236); cam is the
// (17,) camera vector of core/camera.py.  The fisheye and equirect
// projections map the jittered pixel to a direction from the origin
// (sinf / cosf, as torch's sin / cos on the card); the orthographic one
// shoots parallel rays along fwd; all three ignore the thin lens.
__device__ __forceinline__ void raygen(const float* cam, int px_i, int py_i,
                                       int width, int height, float u1,
                                       float u2, float u3, float u4,
                                       int projection, float o[3],
                                       float d[3]) {
  const float cw = cam[12], ch = cam[13], lens_r = cam[14], focal = cam[15];
  if (projection == PROJ_FISHEYE || projection == PROJ_EQUIRECT) {
    const float col = (float)px_i, grw = (float)py_i;
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = cam[k];
    if (projection == PROJ_FISHEYE) {
      // circular equidistant
      const float m = (float)min(width, height);
      const float xn = (2.0f * (col + u1) - (float)width) / m;
      const float yn = ((float)height - 2.0f * (grw + u2)) / m;
      const float theta = sqrtf(xn * xn + yn * yn) * cam[16];
      const float phi = atan2_poly(yn, xn);
      const float sin_t = sinf(theta), cos_t = cosf(theta);
      const float cp = cosf(phi), sp = sinf(phi);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        d[k] = cos_t * cam[3 + k] + sin_t * cp * cam[6 + k]
               + sin_t * sp * cam[9 + k];
    } else {
      // 360x180: column -> azimuth around the view heading, row ->
      // elevation, directions in world axes
      const float u_img = (col + u1) / (float)width;
      const float el = F(PI) * (0.5f - (grw + u2) / (float)height);
      const float phi = atan2_poly(cam[5], cam[3]) + F(2.0 * PI) * (u_img - 0.5f);
      const float rho = cosf(el);
      d[0] = rho * cosf(phi);
      d[1] = sinf(el);
      d[2] = rho * sinf(phi);
    }
    return;
  }
  float x = ((float)px_i / (float)(width - 1) - 0.5f) * cw
            + (u1 - 0.5f) * (cw / (float)width);
  float y = (0.5f - (float)py_i / (float)(height - 1)) * ch
            + (u2 - 0.5f) * (ch / (float)height);
  if (projection == PROJ_ORTHOGRAPHIC) {
    // parallel rays along fwd over the pinhole's focal-plane footprint
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = cam[k] + cam[6 + k] * (x * focal) + cam[9 + k] * (y * focal);
      d[k] = cam[3 + k];
    }
    return;
  }
  float r_d = sqrtf(u3);
  float sp_d, cp_d;
  sincos_2pi(u4, sp_d, cp_d);
  float rx = r_d * cp_d * lens_r;
  float ry = r_d * sp_d * lens_r;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    o[k] = cam[k] + cam[6 + k] * rx + cam[9 + k] * ry;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    d[k] = cam[k] + cam[9 + k] * (y * focal) + cam[6 + k] * (x * focal)
           + cam[3 + k] * focal - o[k];
  normalize3(d[0], d[1], d[2]);
}

// the camera draws (pallas_trace.py:548-566) and the camera ray of ray
// idx = sample * n_pix + pixel; seed is the (3,) seed vector.  Under "r2"
// sb receives the first diffuse bounce's lattice draws (mix, phi, r2).
// Returns the hash counter of the last raygen draw: 4 under "iid", 0
// under "r2".
__device__ __forceinline__ uint32_t camera_ray(const float* cam,
                                               const int* seed, int idx,
                                               int width, int height, int iid,
                                               int projection, float o[3],
                                               float d[3], float sb[3]) {
  const int n_pix = width * height;
  const int pix = idx % n_pix;
  const int py_i = pix / width;
  const int px_i = pix - py_i * width;
  float u1, u2, u3, u4;
  uint32_t counter0;
  sb[0] = sb[1] = sb[2] = 0.0f;
  if (!iid) {
    const uint32_t su = (uint32_t)(idx / n_pix + seed[2]);
    const uint32_t pu = (uint32_t)pix, rs = (uint32_t)seed[1];
    u1 = r2_unit(pu, su, rs, 0);
    u2 = r2_unit(pu, su, rs, 1);
    u3 = r2_unit(pu, su, rs, 2);
    u4 = r2_unit(pu, su, rs, 3);
    sb[0] = r2_unit(pu, su, rs, 6);
    sb[1] = r2_unit(pu, su, rs, 4);
    sb[2] = r2_unit(pu, su, rs, 5);
    counter0 = 0;
  } else {
    const uint32_t seed0 = (uint32_t)seed[0];
    u1 = hash_uniform(idx, seed0, 1);
    u2 = hash_uniform(idx, seed0, 2);
    u3 = hash_uniform(idx, seed0, 3);
    u4 = hash_uniform(idx, seed0, 4);
    counter0 = 4;
  }
  raygen(cam, px_i, py_i, width, height, u1, u2, u3, u4, projection, o, d);
  return counter0;
}

__device__ __forceinline__ void isect_sphere(const float* g, const float o[3],
                                             const float d[3], float& t,
                                             float& orient) {
  float cx = g[0], cy = g[1], cz = g[2], r = g[3];
  float ocx = o[0] - cx, ocy = o[1] - cy, ocz = o[2] - cz;
  float tca = -(d[0] * ocx + d[1] * ocy + d[2] * ocz);
  float px = ocx + tca * d[0], py = ocy + tca * d[1], pz = ocz + tca * d[2];
  float d2 = px * px + py * py + pz * pz;
  float disc = r * r - d2;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float h0 = tca - sq, h1 = tca + sq;
  float h = (h0 > 0.0f && h0 < h1) ? h0 : h1;
  float ndd = ((o[0] + d[0] * h) - cx) * d[0] + ((o[1] + d[1] * h) - cy) * d[1]
              + ((o[2] + d[2] * h) - cz) * d[2];
  bool valid = disc > 0.0f && h > 0.0f && ndd != 0.0f;
  t = valid ? h : FARAWAY;
  orient = ndd < 0.0f ? 1.0f : -1.0f;
}

// a plane, axis-aligned or not, by the generic formula.  For a plane with
// an axis-aligned frame (OBJ_AA_N >= 0) it gives the bits of the plain
// version's component-selection form (ops/solid_trace.py _isect_plane):
// the extra terms are exact +-0 products, negation is exact, and where tt
// overflows both forms fail the |uu| <= w2 test.  Timed alone on the H100
// (probes/isect_cost.py) it costs about 70 issue slots a test where the
// selection form, with its run-time register indices, costs 254; in the
// solid kernel it saves about 6% of a Cornell chunk (PERF.md).
__device__ __forceinline__ void isect_plane(const float* g, const float o[3],
                                            const float d[3], float& t,
                                            float& orient) {
  const float cx = g[0], cy = g[1], cz = g[2];
  const float w2 = g[12], h2 = g[13];
  const float nx = g[9], ny = g[10], nz = g[11];
  float ndd = nx * d[0] + ny * d[1] + nz * d[2];
  if (ndd == 0.0f) ndd = ndd + F(1e-4);
  const float ndco = nx * (cx - o[0]) + ny * (cy - o[1]) + nz * (cz - o[2]);
  const float tt = ndco / ndd;
  const float mx = o[0] + d[0] * tt - cx;
  const float my = o[1] + d[1] * tt - cy;
  const float mz = o[2] + d[2] * tt - cz;
  const float uu = g[3] * mx + g[4] * my + g[5] * mz;
  const float vv = g[6] * mx + g[7] * my + g[8] * mz;
  bool inside = fabsf(uu) <= w2 && fabsf(vv) <= h2 && ndco * ndd > 0.0f;
  t = inside ? tt : FARAWAY;
  orient = ndd < 0.0f ? 1.0f : -1.0f;
}

__device__ __forceinline__ void isect_box(const float* g, const float o[3],
                                          const float d[3], float& t,
                                          float& orient) {
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float ol = g[3 * i] * o[0] + g[3 * i + 1] * o[1] + g[3 * i + 2] * o[2];
    float dl = g[3 * i] * d[0] + g[3 * i + 1] * d[1] + g[3 * i + 2] * d[2];
    float inv = 1.0f / dl;
    float t1 = (g[9 + i] - ol) * inv;
    float t2 = (g[12 + i] - ol) * inv;
    float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
    tmin = i == 0 ? lo : fmaxf(tmin, lo);
    tmax = i == 0 ? hi : fminf(tmax, hi);
  }
  bool miss = tmax < 0.0f || tmin > tmax;
  bool inside = tmin < 0.0f;
  t = miss ? FARAWAY : (inside ? tmax : tmin);
  orient = inside ? -1.0f : 1.0f;
}

// triangle: row [p1, p2, p3, unit normal, n31, n12, n23]
// (pallas_trace.py:342)
__device__ __forceinline__ void isect_tri(const float* g, const float o[3],
                                          const float d[3], float& t,
                                          float& orient) {
  const float cx = (g[0] + g[3] + g[6]) / 3.0f;
  const float cy = (g[1] + g[4] + g[7]) / 3.0f;
  const float cz = (g[2] + g[5] + g[8]) / 3.0f;
  float ndd = g[9] * d[0] + g[10] * d[1] + g[11] * d[2];
  if (ndd == 0.0f) ndd = ndd + F(1e-4);
  const float ndco = g[9] * (cx - o[0]) + g[10] * (cy - o[1]) + g[11] * (cz - o[2]);
  const float tt = ndco / ndd;
  const float mx = o[0] + d[0] * tt, my = o[1] + d[1] * tt, mz = o[2] + d[2] * tt;
  bool inside = ndco * ndd > 0.0f;
  // n31 at p1, n12 at p2, n23 at p3
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* ne = g + 12 + 3 * e;
    const float* pe = g + 3 * e;
    inside = inside && (ne[0] * (mx - pe[0]) + ne[1] * (my - pe[1])
                        + ne[2] * (mz - pe[2]) >= 0.0f);
  }
  t = inside ? tt : FARAWAY;
  orient = ndd < 0.0f ? 1.0f : -1.0f;
}

// disc / annulus: row [center, normal, u, v, r_out, r_in]
// (pallas_trace.py:369)
__device__ __forceinline__ void isect_disc(const float* g, const float o[3],
                                           const float d[3], float& t,
                                           float& orient) {
  float ndd = g[3] * d[0] + g[4] * d[1] + g[5] * d[2];
  if (ndd == 0.0f) ndd = ndd + F(1e-4);
  const float ndco = g[3] * (g[0] - o[0]) + g[4] * (g[1] - o[1])
                     + g[5] * (g[2] - o[2]);
  const float tt = ndco / ndd;
  const float mx = o[0] + d[0] * tt - g[0];
  const float my = o[1] + d[1] * tt - g[1];
  const float mz = o[2] + d[2] * tt - g[2];
  const float rho2 = mx * mx + my * my + mz * mz;
  const bool hit = rho2 <= g[12] * g[12] && rho2 >= g[13] * g[13]
                   && ndco * ndd > 0.0f;
  t = hit ? tt : FARAWAY;
  orient = ndd < 0.0f ? 1.0f : -1.0f;
}

// a point in the cylinder's frame: (radial u, axial, radial v)
// (pallas_trace.py:388); row [center, axis, u, v, radius, half height,
// capped]
__device__ __forceinline__ void cyl_local(const float* g, float px, float py,
                                          float pz, float& x, float& y,
                                          float& z) {
  const float mx = px - g[0], my = py - g[1], mz = pz - g[2];
  x = g[6] * mx + g[7] * my + g[8] * mz;
  y = g[3] * mx + g[4] * my + g[5] * mz;
  z = g[9] * mx + g[10] * my + g[11] * mz;
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// finite, optionally capped cylinder (pallas_trace.py:398)
__device__ __forceinline__ void isect_cyl(const float* g, const float o[3],
                                          const float d[3], float& t,
                                          float& orient) {
  const float r = g[12], hh = g[13];
  const bool cap_on = g[14] > 0.5f;
  float lox, loy, loz;
  cyl_local(g, o[0], o[1], o[2], lox, loy, loz);
  const float ldx = g[6] * d[0] + g[7] * d[1] + g[8] * d[2];
  const float ldy = g[3] * d[0] + g[4] * d[1] + g[5] * d[2];
  const float ldz = g[9] * d[0] + g[10] * d[1] + g[11] * d[2];
  const float r2 = r * r;
  const float a_s = fmaxf(ldx * ldx + ldz * ldz, F(1e-12));
  const float hb = lox * ldx + loz * ldz;
  const float c = lox * lox + loz * loz - r2;
  const float disc = hb * hb - a_s * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const bool side_ok = disc > 0.0f;
  const float ldy_s = fabsf(ldy) < F(1e-12) ? F(1e-12) : ldy;
  const float ts[2] = {(-hb - sq) / a_s, (-hb + sq) / a_s};
  t = FARAWAY;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = side_ok && ts[i] > 0.0f && fabsf(loy + ldy * ts[i]) <= hh;
    t = fminf(t, ok ? ts[i] : FARAWAY);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tc = ((i == 0 ? hh : -hh) - loy) / ldy_s;
    const float xc = lox + ldx * tc, zc = loz + ldz * tc;
    const bool ok = cap_on && tc > 0.0f && xc * xc + zc * zc <= r2;
    t = fminf(t, ok ? tc : FARAWAY);
  }
  const float x = lox + ldx * t, y = loy + ldy * t, z = loz + ldz * t;
  const float rho_hat = sqrtf(fmaxf((x * x + z * z) / r2, 0.0f));
  const bool is_cap = cap_on && fabsf(y) / hh >= rho_hat;
  const float nd = is_cap ? signf(y) * ldy : x * ldx + z * ldz;
  orient = nd < 0.0f ? 1.0f : -1.0f;
}

// the raw geometric normal at a hit point (pallas_trace.py:463)
__device__ __forceinline__ void normal_of(int kind, const float* g, float px,
                                          float py, float pz, float n[3]) {
  if (kind == KIND_SPHERE) {
    float inv_r = 1.0f / g[3];
    n[0] = (px - g[0]) * inv_r;
    n[1] = (py - g[1]) * inv_r;
    n[2] = (pz - g[2]) * inv_r;
  } else if (kind == KIND_PLANE || kind == KIND_TRI) {
    n[0] = g[9]; n[1] = g[10]; n[2] = g[11];
  } else if (kind == KIND_DISC) {
    n[0] = g[3]; n[1] = g[4]; n[2] = g[5];
  } else if (kind == KIND_CYL) {
    // side radial, cap axial, classified by the intersector's rule
    float x, y, z;
    cyl_local(g, px, py, pz, x, y, z);
    const float rho = sqrtf(fmaxf(x * x + z * z, F(1e-20)));
    const bool is_cap = g[14] > 0.5f && fabsf(y) / g[13] >= rho / g[12];
    const float sy = signf(y);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      n[k] = is_cap ? sy * g[3 + k] : (x * g[6 + k] + z * g[9 + k]) / rho;
  } else {
    // box: the max-|axis| face normal in the local frame
    float mx = px - g[15], my = py - g[16], mz = pz - g[17];
    float pl[3], ap[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pl[i] = g[3 * i] * mx + g[3 * i + 1] * my + g[3 * i + 2] * mz;
      ap[i] = fabsf(pl[i]) / g[18 + i];
    }
    float pmax = fmaxf(fmaxf(ap[0], ap[1]), ap[2]);
    float nl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) nl[i] = pmax == ap[i] ? signf(pl[i]) : 0.0f;
    n[0] = g[0] * nl[0] + g[3] * nl[1] + g[6] * nl[2];
    n[1] = g[1] * nl[0] + g[4] * nl[1] + g[7] * nl[2];
    n[2] = g[2] * nl[0] + g[5] * nl[1] + g[8] * nl[2];
  }
}

// the intersection test of object rec with geometry row g
__device__ __forceinline__ void isect_object(const float* g, const int* rec,
                                             const float o[3], const float d[3],
                                             float& t, float& orient) {
  const int kind = rec[OBJ_KIND];
  if (kind == KIND_SPHERE) isect_sphere(g, o, d, t, orient);
  else if (kind == KIND_PLANE) isect_plane(g, o, d, t, orient);
  else if (kind == KIND_BOX) isect_box(g, o, d, t, orient);
  else if (kind == KIND_TRI) isect_tri(g, o, d, t, orient);
  else if (kind == KIND_DISC) isect_disc(g, o, d, t, orient);
  else isect_cyl(g, o, d, t, orient);
}

// the nearest hit over all objects (pallas_trace.py:594-604); hit_id is
// -1 when nothing is hit
__device__ __forceinline__ void nearest_hit(const float* s_geom,
                                            const int* s_obj, int n_obj,
                                            const float o[3], const float d[3],
                                            float& t, float& orient,
                                            int& hit_id) {
  t = FARAWAY;
  orient = 1.0f;
  hit_id = -1;
  for (int i = 0; i < n_obj; ++i) {
    float t_i, o_i;
    isect_object(s_geom + i * GEOM_COLS, s_obj + i * OBJ_COLS, o, d, t_i, o_i);
    if (t_i < t) { t = t_i; orient = o_i; hit_id = i; }
  }
}

// one light's terms at a glossy hit p (pallas_trace.py:957-1015): lv, the
// light's colour times its falloff; see, 0 when a shadow-casting object
// lies between the offset point nu and the light, else 1; p5, Schlick's
// (1 - cos_vh)^5; sw, the Blinn-Phong weight (0 where roughness is 0).
// L is the light's (11,) row; n the oriented normal, v the view vector.
__device__ __forceinline__ void light_terms(
    const float* L, bool is_point, bool is_spot, const float p[3],
    const float nu[3], const float n[3], const float v[3], float rough,
    float a_ph, float spec_c, const float* s_geom, const int* s_obj,
    int n_obj, float lv[3], float& see, float& p5, float& sw) {
  float l[3], dist;
  if (is_point) {
    const float wx = L[0] - p[0], wy = L[1] - p[1], wz = L[2] - p[2];
    dist = sqrtf(fmaxf(wx * wx + wy * wy + wz * wz, F(1e-20)));
    l[0] = wx / dist; l[1] = wy / dist; l[2] = wz / dist;
  } else {
    l[0] = L[0]; l[1] = L[1]; l[2] = L[2];
    dist = SKYBOX_DISTANCE;
  }
  const float ndl = fmaxf(n[0] * l[0] + n[1] * l[1] + n[2] * l[2], 0.0f);
  if (is_point) {
    float fall = ndl / (dist * dist) * 100.0f;
    if (is_spot) {
      // point falloff times the smooth cone factor
      const float cos_t = -(l[0] * L[6] + l[1] * L[7] + l[2] * L[8]);
      const float tt = clip01((cos_t - L[10]) / fmaxf(L[9] - L[10], F(1e-6)));
      fall = fall * (tt * tt * (3.0f - 2.0f * tt));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) lv[k] = L[3 + k] * fall;
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) lv[k] = L[3 + k] * ndl;
  }
  bool occ = false;
  for (int si = 0; si < n_obj && !occ; ++si) {
    const int* srec = s_obj + si * OBJ_COLS;
    if (!srec[OBJ_SHADOW]) continue;
    float t_s, o_s;
    isect_object(s_geom + si * GEOM_COLS, srec, nu, l, t_s, o_s);
    occ = t_s < dist;
  }
  see = occ ? 0.0f : 1.0f;
  float h[3] = {l[0] + v[0], l[1] + v[1], l[2] + v[2]};
  normalize3(h[0], h[1], h[2]);
  p5 = pow5(1.0f - clip01(dot3(v, h)));
  const float dph = powf(clip01(dot3(n, h)), a_ph) * (a_ph + 2.0f) / F(2.0 * PI);
  const float denom = 4.0f * fminf(fmaxf(dot3(n, v) * ndl, F(0.001)), 1.0f);
  sw = rough != 0.0f ? dph / denom * see * spec_c : 0.0f;
}

// one importance-sampled target's cap as seen from nu: unit direction w
// and cos of the cap's half-angle
__device__ __forceinline__ void cap_of(const float* tab, const float nu[3],
                                       float w[3], float& cm) {
  float wx = tab[0] - nu[0], wy = tab[1] - nu[1], wz = tab[2] - nu[2];
  float dist = sqrtf(fmaxf(wx * wx + wy * wy + wz * wz, F(1e-20)));
  w[0] = wx / dist; w[1] = wy / dist; w[2] = wz / dist;
  float sin_m = clip01(tab[3] / dist);
  cm = sqrtf(fmaxf(1.0f - sin_m * sin_m, 0.0f));
}

__device__ __forceinline__ void csqrt(float ar, float ai, float& re, float& im) {
  float mag = sqrtf(ar * ar + ai * ai);
  re = sqrtf(fmaxf((mag + ar) * 0.5f, 0.0f));
  float m = sqrtf(fmaxf((mag - ar) * 0.5f, 0.0f));
  im = ai < 0.0f ? -m : m;
}

}  // namespace
