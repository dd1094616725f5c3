// Solid path-tracing kernel for Hopper (sm_90a).
//
// Replaces raytracer_tpu/ops/pallas_trace.py:_make_kernel, the TPU mega-
// kernel behind pallas_trace_chunk.  One thread traces one ray, index
// idx = sample * n_pix + pixel, through camera ray generation and every
// bounce: nearest hit over all objects, normal, and shading by the hit
// object's material (emissive / diffuse with light-cap importance sampling
// / refractive).  The plain version beside it, in ops/solid_trace.py
// (solid_trace_chunk_reference), is the same function on tensors.
//
// What bounds it on the card: FP32 work and warp divergence, not bytes.
// Per ray it writes one 12-byte radiance and reads nothing but a few
// hundred bytes of scene tables, which every block copies into shared
// memory once.  Rays of one warp take different materials and die at
// different bounces, so lanes idle; the design keeps that cheap rather
// than avoiding it: the scene is data (run-time loops over objects,
// bounces and importance-sampled targets, one compiled kernel for every
// scene), shading branches on the hit object's material and reads its
// slot's row, and a ray leaves the bounce loop as soon as it dies.  The
// Pallas kernel instead unrolls everything in Python and evaluates every
// shading group on every lane with masks, because Mosaic cannot lower a
// large loop carry.
//
// The random draws are integer math shared with the JAX package: the R2
// lattice bits of core/lds.py and the murmur3 hash of _TileRng, keyed by
// (ray index, draw counter, seed).  The counter numbering follows the
// Pallas kernel exactly: 4 raygen draws under "iid" (none under "r2"),
// then 6 per bounce except the last, which takes none.  Compiled without
// fast math and without FMA contraction, the float math rounds as the
// plain version's does on the card, so the two agree ray by ray.
//
// Built by ops/solid_trace.py with nvcc into a shared library; the host
// entry solid_trace_launch takes device pointers and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int GEOM_COLS = 24;
constexpr int OBJ_COLS = 12;
// object-table columns (core/compile.py)
constexpr int OBJ_KIND = 0, OBJ_MAT_TYPE = 1, OBJ_MAT_SLOT = 2,
              OBJ_MAX_DEPTH = 3, OBJ_AA_N = 7, OBJ_AA_NSIGN = 8,
              OBJ_AA_U = 9, OBJ_AA_V = 10;
constexpr int KIND_SPHERE = 0, KIND_PLANE = 1;   // else box
constexpr int MAT_EMISSIVE = 1, MAT_DIFFUSE = 3, MAT_REFRACTIVE = 4;

// Constants are written as double literals cast to float: the JAX and
// torch versions round python floats (doubles) to float32 the same way.
#define F(x) ((float)(x))
constexpr double PI = 3.14159265358979323846;
const float FARAWAY = F(1.0e30);
const float MISS_THRESHOLD = F(1.0e29);
const float INV_2_24 = F(1.0 / (1 << 24));

// R2 generators and rotation salts (core/lds.py ALPHA, DIM_SALT)
__constant__ uint32_t R2_ALPHA[8] = {
    0xc13fa9a9u, 0x91e10da5u, 0xd1b54a32u, 0xabc98388u,
    0xdb4f0b91u, 0xbbe05633u, 0xa0f2ec75u, 0x8cb92ba7u};
__constant__ uint32_t R2_SALT[8] = {
    0x3c6ef372u, 0x9e3779b9u, 0x85ebca77u, 0xc2b2ae3du,
    0x27220a95u, 0x6180339bu, 0xb5297a4du, 0x68e31da5u};

struct Params {
  const int* seed;       // (3,) chunk seed, R2 rotation seed, first sample
  const float* cam;      // (17,)
  const float* geom;     // (n_obj, 24)
  const int* obj;        // (n_obj, 12)
  const float* dif;      // (n_dif, 4)
  const float* refr;     // (n_refr, 6)
  const float* emi;      // (n_emi, 3)
  const float* is_tab;   // (n_is, 4)
  const float* consts;   // (16,)
  int n_obj, n_dif, n_refr, n_emi, n_is;
  int width, height, n_pix, n;
  int max_bounces, iid;
  float* L;                      // (n, 3)
  unsigned long long* count;     // rays traced
};

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

__device__ __forceinline__ void isect_plane(const float* g, const int* rec,
                                            const float o[3], const float d[3],
                                            float& t, float& orient) {
  const float c[3] = {g[0], g[1], g[2]};
  float w2 = g[12], h2 = g[13];
  float ndd, ndco, uu, vv, tt;
  int nax = rec[OBJ_AA_N];
  if (nax >= 0) {
    // axis-aligned frame: component selection, bit-identical to the
    // generic formula (the dropped terms are exact *0 / +0)
    int uax = rec[OBJ_AA_U], vax = rec[OBJ_AA_V];
    bool pos = rec[OBJ_AA_NSIGN] > 0;
    ndd = pos ? d[nax] : -d[nax];
    if (ndd == 0.0f) ndd = ndd + F(1e-4);
    ndco = pos ? (c[nax] - o[nax]) : (o[nax] - c[nax]);
    tt = ndco / ndd;
    uu = o[uax] + d[uax] * tt - c[uax];
    vv = o[vax] + d[vax] * tt - c[vax];
  } else {
    float nx = g[9], ny = g[10], nz = g[11];
    ndd = nx * d[0] + ny * d[1] + nz * d[2];
    if (ndd == 0.0f) ndd = ndd + F(1e-4);
    ndco = nx * (c[0] - o[0]) + ny * (c[1] - o[1]) + nz * (c[2] - o[2]);
    tt = ndco / ndd;
    float mx = o[0] + d[0] * tt - c[0];
    float my = o[1] + d[1] * tt - c[1];
    float mz = o[2] + d[2] * tt - c[2];
    uu = g[3] * mx + g[4] * my + g[5] * mz;
    vv = g[6] * mx + g[7] * my + g[8] * mz;
  }
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

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ void normal_of(int kind, const float* g, float px,
                                          float py, float pz, float n[3]) {
  if (kind == KIND_SPHERE) {
    float inv_r = 1.0f / g[3];
    n[0] = (px - g[0]) * inv_r;
    n[1] = (py - g[1]) * inv_r;
    n[2] = (pz - g[2]) * inv_r;
  } else if (kind == KIND_PLANE) {
    n[0] = g[9]; n[1] = g[10]; n[2] = g[11];
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

__global__ void __launch_bounds__(BLOCK) solid_trace_kernel(Params p) {
  extern __shared__ float smem[];
  // ---- scene tables -> shared memory, once per block ----
  float* s_geom = smem;
  float* s_dif = s_geom + p.n_obj * GEOM_COLS;
  float* s_refr = s_dif + p.n_dif * 4;
  float* s_emi = s_refr + p.n_refr * 6;
  float* s_is = s_emi + p.n_emi * 3;
  float* s_consts = s_is + (p.n_is > 0 ? p.n_is : 1) * 4;
  float* s_cam = s_consts + 16;
  int* s_obj = reinterpret_cast<int*>(s_cam + 17);
  int* s_seed = s_obj + p.n_obj * OBJ_COLS;
  __shared__ unsigned int s_count;
  for (int i = threadIdx.x; i < p.n_obj * GEOM_COLS; i += BLOCK) s_geom[i] = p.geom[i];
  for (int i = threadIdx.x; i < p.n_dif * 4; i += BLOCK) s_dif[i] = p.dif[i];
  for (int i = threadIdx.x; i < p.n_refr * 6; i += BLOCK) s_refr[i] = p.refr[i];
  for (int i = threadIdx.x; i < p.n_emi * 3; i += BLOCK) s_emi[i] = p.emi[i];
  for (int i = threadIdx.x; i < p.n_is * 4; i += BLOCK) s_is[i] = p.is_tab[i];
  for (int i = threadIdx.x; i < 16; i += BLOCK) s_consts[i] = p.consts[i];
  for (int i = threadIdx.x; i < 17; i += BLOCK) s_cam[i] = p.cam[i];
  for (int i = threadIdx.x; i < p.n_obj * OBJ_COLS; i += BLOCK) s_obj[i] = p.obj[i];
  if (threadIdx.x < 3) s_seed[threadIdx.x] = p.seed[threadIdx.x];
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  const int idx = blockIdx.x * BLOCK + threadIdx.x;
  unsigned int my_count = 0;
  if (idx < p.n) {
    const uint32_t seed0 = (uint32_t)s_seed[0];
    const int pix = idx % p.n_pix;
    const int py_i = pix / p.width;
    const int px_i = pix - py_i * p.width;

    // ---- camera draws (pallas_trace.py:548-566) ----
    float u1, u2, u3, u4, sb_mix = 0.0f, sb_phi = 0.0f, sb_r2 = 0.0f;
    uint32_t counter0;        // counter of the last raygen draw
    if (!p.iid) {
      const uint32_t su = (uint32_t)(idx / p.n_pix + s_seed[2]);
      const uint32_t pu = (uint32_t)pix, rs = (uint32_t)s_seed[1];
      u1 = r2_unit(pu, su, rs, 0);
      u2 = r2_unit(pu, su, rs, 1);
      u3 = r2_unit(pu, su, rs, 2);
      u4 = r2_unit(pu, su, rs, 3);
      sb_mix = r2_unit(pu, su, rs, 6);
      sb_phi = r2_unit(pu, su, rs, 4);
      sb_r2 = r2_unit(pu, su, rs, 5);
      counter0 = 0;
    } else {
      u1 = hash_uniform(idx, seed0, 1);
      u2 = hash_uniform(idx, seed0, 2);
      u3 = hash_uniform(idx, seed0, 3);
      u4 = hash_uniform(idx, seed0, 4);
      counter0 = 4;
    }

    // ---- pinhole + thin lens (pallas_trace.py:210-236) ----
    const float* cam = s_cam;
    const float cw = cam[12], ch = cam[13], lens_r = cam[14], focal = cam[15];
    float x = ((float)px_i / (float)(p.width - 1) - 0.5f) * cw
              + (u1 - 0.5f) * (cw / (float)p.width);
    float y = (0.5f - (float)py_i / (float)(p.height - 1)) * ch
              + (u2 - 0.5f) * (ch / (float)p.height);
    float r_d = sqrtf(u3);
    float sp_d, cp_d;
    sincos_2pi(u4, sp_d, cp_d);
    float rx = r_d * cp_d * lens_r;
    float ry = r_d * sp_d * lens_r;
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      o[k] = cam[k] + cam[6 + k] * rx + cam[9 + k] * ry;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d[k] = cam[k] + cam[9 + k] * (y * focal) + cam[6 + k] * (x * focal)
             + cam[3 + k] * focal - o[k];
    normalize3(d[0], d[1], d[2]);

    float Lr[3] = {0.0f, 0.0f, 0.0f};
    float beta[3] = {1.0f, 1.0f, 1.0f};
    float nre[3], nim[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) { nre[k] = s_consts[3 + k]; nim[k] = s_consts[6 + k]; }
    int dcnt = 0;
    const int K = p.n_is;

    for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
      // the ray is alive at the start of this bounce
      ++my_count;
      const bool last = bounce == p.max_bounces - 1;

      // ---- nearest hit (pallas_trace.py:594-604) ----
      float t = FARAWAY, orient = 1.0f;
      int hit_id = -1;
      for (int i = 0; i < p.n_obj; ++i) {
        const float* g = s_geom + i * GEOM_COLS;
        const int* rec = s_obj + i * OBJ_COLS;
        float t_i, o_i;
        const int kind = rec[OBJ_KIND];
        if (kind == KIND_SPHERE) isect_sphere(g, o, d, t_i, o_i);
        else if (kind == KIND_PLANE) isect_plane(g, rec, o, d, t_i, o_i);
        else isect_box(g, o, d, t_i, o_i);
        if (t_i < t) { t = t_i; orient = o_i; hit_id = i; }
      }
      if (t >= MISS_THRESHOLD) break;          // a miss ends the path

      const float* g = s_geom + hit_id * GEOM_COLS;
      const int* rec = s_obj + hit_id * OBJ_COLS;
      const int mt = rec[OBJ_MAT_TYPE], slot = rec[OBJ_MAT_SLOT];
      const float px = o[0] + d[0] * t, py = o[1] + d[1] * t, pz = o[2] + d[2] * t;

      if (mt == MAT_EMISSIVE) {                // terminal
        const float* col = s_emi + slot * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) Lr[k] = Lr[k] + beta[k] * col[k];
        break;
      }
      // non-emissive hits add zero radiance (kept for NaN/inf parity)
#pragma unroll
      for (int k = 0; k < 3; ++k) Lr[k] = Lr[k] + beta[k] * 0.0f;
      // the last bounce's continuation is dead, and it takes no draws
      if (last) break;
      const uint32_t cb = counter0 + 6u * (uint32_t)bounce;  // ru[j]: cb+j+1

      float n[3];
      normal_of(rec[OBJ_KIND], g, px, py, pz, n);
#pragma unroll
      for (int k = 0; k < 3; ++k) n[k] = n[k] * orient;
      const float eps = F(1e-6) * fmaxf(
          fmaxf(fabsf(px), fmaxf(fabsf(py), fabsf(pz))), 1.0f);

      if (mt == MAT_DIFFUSE) {
        // ---- diffuse + cap importance sampling (pallas_trace.py:706-807) ----
        if (dcnt >= 2) break;                  // diffuse depth reached
        const float* prm = s_dif + slot * 4;
        const float aw = prm[3];
        const float nu[3] = {px + n[0] * eps, py + n[1] * eps, pz + n[2] * eps};
        float ax_u[3], ax_v[3];
        orthobasis(n[0], n[1], n[2], ax_u, ax_v);
        float u_phi1, u_r21, u_phi2 = 0.0f, u_r22 = 0.0f, u_mixv = 0.0f;
        const bool first = !p.iid && dcnt == 0;   // R2 draws replace the hash
        u_phi1 = first ? sb_phi : hash_uniform(idx, seed0, cb + 1);
        u_r21 = first ? sb_r2 : hash_uniform(idx, seed0, cb + 2);
        const float r2 = u_r21;
        const float zc = sqrtf(fmaxf(1.0f - r2, 0.0f));
        const float sr2 = sqrtf(r2);
        float sphi, cphi;
        sincos_2pi(u_phi1, sphi, cphi);
        const float xc = cphi * sr2, yc = sphi * sr2;
        float sd[3], ndl, pdf;
#pragma unroll
        for (int k = 0; k < 3; ++k) sd[k] = ax_u[k] * xc + ax_v[k] * yc + n[k] * zc;
        if (K > 0) {
          u_phi2 = first ? sb_phi : hash_uniform(idx, seed0, cb + 4);
          u_r22 = first ? sb_r2 : hash_uniform(idx, seed0, cb + 5);
          u_mixv = first ? sb_mix : hash_uniform(idx, seed0, cb + 6);
          const float ru2 = hash_uniform(idx, seed0, cb + 3);
          const int pick = min((int)(ru2 * (float)K), K - 1);
          float sw[3], scm;
          cap_of(s_is + pick * 4, nu, sw, scm);
          float cu[3], cv[3];
          orthobasis(sw[0], sw[1], sw[2], cu, cv);
          const float zq = 1.0f + u_r22 * (scm - 1.0f);
          const float sq = sqrtf(fmaxf(1.0f - zq * zq, 0.0f));
          float sphi2, cphi2;
          sincos_2pi(u_phi2, sphi2, cphi2);
          const float cps = cphi2 * sq, sps = sphi2 * sq;
          if (!(u_mixv < aw)) {
#pragma unroll
            for (int k = 0; k < 3; ++k) sd[k] = cu[k] * cps + cv[k] * sps + sw[k] * zq;
          }
          ndl = clip01(sd[0] * n[0] + sd[1] * n[1] + sd[2] * n[2]);
          const float pdf_cos = ndl / F(PI);
          float pdf_cap = 0.0f;
          for (int kk = 0; kk < K; ++kk) {
            float w[3], cm;
            cap_of(s_is + kk * 4, nu, w, cm);
            const float cosk = sd[0] * w[0] + sd[1] * w[1] + sd[2] * w[2];
            pdf_cap = pdf_cap + (cosk > cm ? 1.0f / ((1.0f - cm) * 2.0f * F(PI))
                                           : 0.0f);
          }
          pdf_cap = pdf_cap / (float)K;
          pdf = aw * pdf_cos + (1.0f - aw) * pdf_cap;
        } else {
          ndl = clip01(sd[0] * n[0] + sd[1] * n[1] + sd[2] * n[2]);
          pdf = ndl / F(PI);
        }
        const float w = ndl / fmaxf(pdf, F(1e-9)) / F(PI);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          beta[k] = beta[k] * (prm[k] * w);
          o[k] = nu[k];
          d[k] = sd[k];
        }
        ++dcnt;
      } else if (mt == MAT_REFRACTIVE && bounce < rec[OBJ_MAX_DEPTH]) {
        // ---- refractive (pallas_trace.py:809-942); alive rays at bounce b
        // have made b transitions, so the depth cap tests the bounce ----
        const float* prm = s_refr + slot * 6;
        const float cos_i = -(d[0] * n[0] + d[1] * n[1] + d[2] * n[2]);
        const bool entering = orient > 0.0f;
        float Fr[3], n2r[3], n2i[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float n1r = nre[k], n1i = nim[k];
          n2r[k] = entering ? prm[k] : s_consts[3 + k];
          n2i[k] = entering ? prm[3 + k] : s_consts[6 + k];
          const float dd = fmaxf(n2r[k] * n2r[k] + n2i[k] * n2i[k], F(1e-30));
          const float rr = (n1r * n2r[k] + n1i * n2i[k]) / dd;
          const float ri = (n1i * n2r[k] - n1r * n2i[k]) / dd;
          const float r2r = rr * rr - ri * ri, r2i = rr * ri + ri * rr;
          const float s2 = 1.0f - cos_i * cos_i;
          float ctr, cti;
          csqrt(1.0f - r2r * s2, -r2i * s2, ctr, cti);
          const float ar = n1r * cos_i, ai = n1i * cos_i;
          const float btr = n2r[k] * ctr - n2i[k] * cti;
          const float bti = n2r[k] * cti + n2i[k] * ctr;
          const float atr = n1r * ctr - n1i * cti, ati = n1r * cti + n1i * ctr;
          const float bbr = n2r[k] * cos_i, bbi = n2i[k] * cos_i;
          const float pr = ar - btr, pi = ai - bti, qr = ar + btr, qi = ai + bti;
          const float F_per = (pr * pr + pi * pi) / fmaxf(qr * qr + qi * qi, F(1e-30));
          const float sr = bbr - atr, si = bbi - ati, tr = atr + bbr, ti = ati + bbi;
          const float F_par = (sr * sr + si * si) / fmaxf(tr * tr + ti * ti, F(1e-30));
          Fr[k] = (F_per + F_par) * 0.5f;
        }
        const float T0 = 1.0f - Fr[0], T1 = 1.0f - Fr[1], T2 = 1.0f - Fr[2];
        const float ratio_avg = (nre[0] / fmaxf(n2r[0], F(1e-9))
                                 + nre[1] / fmaxf(n2r[1], F(1e-9))
                                 + nre[2] / fmaxf(n2r[2], F(1e-9))) / 3.0f;
        const float sin2t = ratio_avg * ratio_avg * (1.0f - cos_i * cos_i);
        const bool non_tir = sin2t <= 1.0f;
        const float croot = sqrtf(1.0f - clip01(sin2t));
        const float T_avg = (T0 + T1 + T2) / 3.0f;
        const float p_refr = non_tir ? clip01(T_avg) : 0.0f;
        const float ru0 = hash_uniform(idx, seed0, cb + 1);
        const bool take = ru0 < p_refr && non_tir;
        float nd[3];
        if (take) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            nd[k] = d[k] * ratio_avg + n[k] * (ratio_avg * cos_i - croot);
        } else {
          const float ddn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
#pragma unroll
          for (int k = 0; k < 3; ++k) nd[k] = d[k] - n[k] * (2.0f * ddn);
        }
        normalize3(nd[0], nd[1], nd[2]);
        const float T[3] = {T0, T1, T2};
        const float sgn = take ? -1.0f : 1.0f;
        // -4 pi / lambda * 1e9 per channel (utils/constants.py WAVELENGTHS_NM)
        const float absorb_c[3] = {F((-4.0 * PI / 630.0) * 1e9),
                                   F((-4.0 * PI / 550.0) * 1e9),
                                   F((-4.0 * PI / 475.0) * 1e9)};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float absorb = expf(nim[k] * (absorb_c[k] * t));
          const float wgt = take ? T[k] / fmaxf(p_refr, F(1e-9))
                                 : Fr[k] / fmaxf(1.0f - p_refr, F(1e-9));
          beta[k] = beta[k] * (absorb * wgt);
        }
        if (take) {
#pragma unroll
          for (int k = 0; k < 3; ++k) { nre[k] = n2r[k]; nim[k] = n2i[k]; }
        }
        o[0] = px + n[0] * eps * sgn;
        o[1] = py + n[1] * eps * sgn;
        o[2] = pz + n[2] * eps * sgn;
#pragma unroll
        for (int k = 0; k < 3; ++k) d[k] = nd[k];
      } else {
        break;       // refractive past its depth cap: the path ends
      }
    }
    p.L[3 * (long long)idx + 0] = Lr[0];
    p.L[3 * (long long)idx + 1] = Lr[1];
    p.L[3 * (long long)idx + 2] = Lr[2];
  }

  // ---- rays traced: warp sums, one shared add per warp, one global add ----
  for (int off = 16; off > 0; off >>= 1)
    my_count += __shfl_down_sync(0xffffffffu, my_count, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_count, my_count);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p.count, (unsigned long long)s_count);
}

}  // namespace

extern "C" int solid_trace_launch(
    const int* seed, const float* cam, const float* geom, const int* obj,
    int n_obj, const float* dif, int n_dif, const float* refr, int n_refr,
    const float* emi, int n_emi, const float* is_tab, int n_is,
    const float* consts, int width, int height, int spp, int max_bounces,
    int iid, float* L, long long* count, void* stream) {
  Params p;
  p.seed = seed; p.cam = cam; p.geom = geom; p.obj = obj;
  p.dif = dif; p.refr = refr; p.emi = emi; p.is_tab = is_tab; p.consts = consts;
  p.n_obj = n_obj; p.n_dif = n_dif; p.n_refr = n_refr; p.n_emi = n_emi;
  p.n_is = n_is;
  p.width = width; p.height = height; p.n_pix = width * height;
  p.n = spp * p.n_pix;
  p.max_bounces = max_bounces; p.iid = iid;
  p.L = L;
  p.count = reinterpret_cast<unsigned long long*>(count);
  const size_t smem = sizeof(float) * (
      (size_t)n_obj * (GEOM_COLS + OBJ_COLS) + (size_t)n_dif * 4
      + (size_t)n_refr * 6 + (size_t)n_emi * 3 + (size_t)(n_is > 0 ? n_is : 1) * 4
      + 16 + 17 + 3);
  const int grid = (p.n + BLOCK - 1) / BLOCK;
  solid_trace_kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
