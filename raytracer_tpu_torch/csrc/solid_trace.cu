// Solid path-tracing kernel for Hopper (sm_90a).
//
// Replaces raytracer_tpu/ops/pallas_trace.py:_make_kernel, the TPU mega-
// kernel behind pallas_trace_chunk.  A ray, index idx = sample * n_pix +
// pixel, goes through camera ray generation and every bounce: nearest hit
// over all objects (spheres, planes, boxes, discs, cylinders, triangles),
// normal, and shading by the hit object's material: emissive; diffuse with
// light-cap importance sampling; refractive with the deterministic Fresnel
// split and hero-wavelength dispersion; glossy with the lights, shadow rays
// and the Fresnel mirror continuation.  Every camera projection (pinhole +
// thin lens, fisheye, equirect, orthographic) is generated in the kernel.
// The plain version beside it, in ops/solid_trace.py
// (solid_trace_chunk_reference), is the same function on tensors.
//
// What bounds it on the card: not bytes.  Per ray it writes one 12-byte
// radiance and reads nothing but a few hundred bytes of scene tables,
// which every block copies into shared memory once.  Its time goes to
// long dependent chains (shared-memory loads, IEEE division and sqrt) that
// too few warps hide, and to warps whose lanes wait on each other: rays of
// one warp die at different bounces (a warp pays full price for its dead
// lanes, PERF.md P5) and take different materials.  The design:
// - the grid is persistent (the SM count times the blocks per SM that
//   fit), every lane keeps one ray's whole state in registers, and a lane
//   whose ray has ended writes its radiance and takes the next ray index.
//   A warp takes indices with one atomic add for all its free lanes once
//   K1_REFILL_MIN of them are free, so the new lanes get consecutive
//   pixels; it leaves when the work counter is spent and no lane has a
//   ray (Aila & Laine, HPG 2009; Laine, Karras & Aila, HPG 2013).  Ray
//   state never goes to device memory between bounces;
// - each pass of the warp loop takes the nearest hit of every ray whose
//   last hit is shaded, then shades the hits; refractive hits wait until
//   K1_REFR_MIN of them can share the refractive block;
// - __launch_bounds__ trades registers for resident warps (K1_MIN_BLOCKS);
// - axis-aligned planes go through the generic plane formula
//   (trace_common.cuh isect_plane), which gives the same bits as the
//   component-selection form and runs faster in this kernel.
// Shading branches on the hit object's material and reads its slot's
// row, with run-time loops
// over objects, bounces, lights and importance-sampled targets (one
// compiled kernel for every scene).  The Pallas kernel instead unrolls
// everything in Python and evaluates every shading group on every lane
// with masks, because Mosaic cannot lower a large loop carry.
//
// The random draws are integer math shared with the JAX package
// (trace_common.cuh): the R2 lattice bits of core/lds.py and the murmur3
// hash of _TileRng, keyed by (ray index, draw counter, seed), so a ray's
// draws do not depend on which lane traces it.  The counter numbering
// follows the Pallas kernel exactly: 4 raygen draws under "iid" (none
// under "r2"), then 6 per bounce except the last, which takes none, each
// followed by one hero-wavelength draw per merged dispersive group still
// under its depth cap.  Compiled without fast math and without FMA
// contraction, the float math rounds as the plain version's does on the
// card, so the two agree ray by ray.
//
// Built by ops/cuda_build.py with nvcc into the port's shared library;
// the host entry solid_trace_launch takes device pointers and returns the
// first CUDA error of the grid sizing or the launch.

#include "trace_common.cuh"

// K1's launch shape and scheduling constants, chosen by timing on the H100
// (PERF.md; scripts/torch_k1_tune.py builds other values with -D and
// compares them):
// - K1_BLOCK threads a block, and K1_MIN_BLOCKS resident blocks an SM for
//   __launch_bounds__: 8 x 128 threads caps the kernel at 64 registers and
//   spills some state to local memory (L1), but doubles the warps an SM
//   holds; the kernel is bound by latency more than by issue, so that
//   pays;
// - K1_REFILL_MIN: the free lanes a warp waits for before it takes new
//   rays.  New rays come in batches of consecutive pixels that stay
//   coherent for a few bounces; refilling each lane as it frees gives
//   more busy lanes but mixes the warp's paths;
// - K1_REFR_MIN: the refractive hits a warp gathers before it runs their
//   shading (the largest material block) for all of them in one pass;
//   fewer wait, unless nothing else is left to trace or shade.
#ifndef K1_BLOCK
#define K1_BLOCK 128
#endif
#ifndef K1_MIN_BLOCKS
#define K1_MIN_BLOCKS 8
#endif
#ifndef K1_REFILL_MIN
#define K1_REFILL_MIN 20
#endif
#ifndef K1_REFR_MIN
#define K1_REFR_MIN 8
#endif

namespace {

static_assert(K1_BLOCK % 32 == 0, "K1_BLOCK must be whole warps");
static_assert(K1_REFILL_MIN >= 1 && K1_REFILL_MIN <= 32, "K1_REFILL_MIN in [1, 32]");
static_assert(K1_REFR_MIN >= 1 && K1_REFR_MIN <= 32, "K1_REFR_MIN in [1, 32]");

constexpr unsigned FULL_MASK = 0xffffffffu;
// most merged dispersive groups a scene may have (ops/solid_trace.py
// MAX_HU_GROUPS): one per distinct (depth cap, mc) of its dispersive
// refractive objects, at most one per object
constexpr int MAX_HU = 48;

struct Params {
  const int* seed;       // (3,) chunk seed, R2 rotation seed, first sample
  const float* cam;      // (17,)
  const float* geom;     // (n_obj, 24)
  const int* obj;        // (n_obj, OBJ_COLS)
  const float* dif;      // (n_dif, 4)
  const float* glo;      // (n_glo, 12)
  const float* refr;     // (n_refr, 6)
  const float* emi;      // (n_emi, 3)
  const float* lights;   // (n_lrow, 11): directional, then point, then spot
  const float* is_tab;   // (n_is, 4)
  const float* consts;   // (16,)
  int n_obj, n_dif, n_glo, n_refr, n_emi, n_lrow, n_is;
  int n_dir, n_point, n_spot;
  int width, height, n_pix, n;
  int max_bounces, iid, split_k, projection;
  // depth caps of the merged dispersive groups, in group order
  int n_hu, hu_maxd[MAX_HU];
  float* L;                         // (n, 3)
  unsigned long long* count;        // rays traced
  unsigned long long* next;         // work counter: the next ray index, 0 at launch
  unsigned long long* lane_stats;   // null, or (2,): lane-iterations with a
                                    // ray, all lane-iterations
};

// the scene tables in shared memory
struct Tables {
  const float *geom, *dif, *glo, *refr, *emi, *light, *is, *consts, *cam;
  const int *obj, *seed;
};

// one ray's state between bounces, kept in its lane's registers
struct Ray {
  float o[3], d[3], beta[3], Lr[3], nre[3], nim[3];
  float sb_mix, sb_phi, sb_r2;      // first diffuse bounce's R2 draws
  uint32_t cb;                      // hash counter of the last draw taken
  int idx, bounce, dcnt, scnt;
  float t, orient;                  // this bounce's nearest hit ...
  int hit;                          // ... and its object, until it is shaded
};

// |n1 - n2|^2 / |n1 + n2|^2, the normal-incidence Fresnel term
__device__ __forceinline__ float fresnel_f0(float n1r, float n1i, float n2r,
                                            float n2i) {
  const float dr = n1r - n2r, di = n1i - n2i;
  const float sr = n1r + n2r, si = n1i + n2i;
  return (dr * dr + di * di) / fmaxf(sr * sr + si * si, F(1e-20));
}

// ray idx's camera ray and its state before the first bounce
__device__ __forceinline__ void start_ray(Ray& r, int idx, const Tables& s,
                                          const Params& p) {
  float sb[3];
  r.cb = camera_ray(s.cam, s.seed, idx, p.width, p.height, p.iid,
                    p.projection, r.o, r.d, sb);
  r.sb_mix = sb[0];
  r.sb_phi = sb[1];
  r.sb_r2 = sb[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.Lr[k] = 0.0f;
    r.beta[k] = 1.0f;
    r.nre[k] = s.consts[3 + k];
    r.nim[k] = s.consts[6 + k];
  }
  r.idx = idx;
  r.bounce = r.dcnt = r.scnt = 0;
}

// the shading of this bounce's hit (r.t, r.orient, r.hit); false when the
// path ends here
__device__ __forceinline__ bool shade_hit(Ray& r, const Tables& s,
                                          const Params& p) {
  const bool last = r.bounce == p.max_bounces - 1;
  const uint32_t seed0 = (uint32_t)s.seed[0];
  const float* amb = s.consts;
  const float* scene_nre = s.consts + 3;
  const float* scene_nim = s.consts + 6;
  const int K = p.n_is;
  float* o = r.o;
  float* d = r.d;
  float* beta = r.beta;
  const float t = r.t, orient = r.orient;
  const int hit_id = r.hit;

  const float* g = s.geom + hit_id * GEOM_COLS;
  const int* rec = s.obj + hit_id * OBJ_COLS;
  const int mt = rec[OBJ_MAT_TYPE], slot = rec[OBJ_MAT_SLOT];
  const float px = o[0] + d[0] * t, py = o[1] + d[1] * t, pz = o[2] + d[2] * t;

  if (mt == MAT_EMISSIVE) {                   // terminal
    const float* col = s.emi + slot * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) r.Lr[k] = r.Lr[k] + beta[k] * col[k];
    return false;
  }
  if (mt != MAT_GLOSSY) {
    // diffuse and refractive hits add zero radiance (kept for NaN/inf
    // parity); on the last bounce their continuation is dead
#pragma unroll
    for (int k = 0; k < 3; ++k) r.Lr[k] = r.Lr[k] + beta[k] * 0.0f;
    if (last) return false;
  }
  // this bounce's draws: ru[j] at cb_b + j + 1, then one hero-wavelength
  // draw per merged dispersive group still under its depth cap, in group
  // order; the last bounce takes none (pallas_trace.py:658, 859)
  const uint32_t cb_b = r.cb;
  int n_active = 0;
  for (int j = 0; j < p.n_hu; ++j) n_active += r.bounce < p.hu_maxd[j];
  r.cb += 6u + (uint32_t)n_active;

  float n[3];
  normal_of(rec[OBJ_KIND], g, px, py, pz, n);
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = n[k] * orient;
  const float eps = F(1e-6) * fmaxf(
      fmaxf(fabsf(px), fmaxf(fabsf(py), fabsf(pz))), 1.0f);
  const float nu[3] = {px + n[0] * eps, py + n[1] * eps, pz + n[2] * eps};

  if (mt == MAT_GLOSSY) {
    // ---- glossy: ambient + Lambert + Blinn-Phong over the lights with
    // shadow rays on every bounce, the last included; the Fresnel mirror
    // continuation below the depth cap (pallas_trace.py:944-1042)
    const float* prm = s.glo + slot * 12;
    const float rough = prm[9], spec_c = prm[10], diff_c = prm[11];
    const float v[3] = {-d[0], -d[1], -d[2]};
    const float pp[3] = {px, py, pz};
    float dc[3], acc[3], F0[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dc[k] = prm[k] * diff_c;
      acc[k] = amb[k] * dc[k];
      F0[k] = fresnel_f0(r.nre[k], r.nim[k], prm[3 + k], prm[6 + k]);
    }
    const float rm = fmaxf(rough, F(1e-6));
    const float a_ph = 2.0f / (rm * rm) - 2.0f;
    for (int li = 0; li < p.n_lrow; ++li) {
      float lv[3], see, p5, sw;
      light_terms(s.light + li * 11, li >= p.n_dir, li >= p.n_dir + p.n_point,
                  pp, nu, n, v, rough, a_ph, spec_c, s.geom, s.obj, p.n_obj,
                  lv, see, p5, sw);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        acc[k] = acc[k] + dc[k] * lv[k] * see;
        acc[k] = acc[k] + (F0[k] + (1.0f - F0[k]) * p5) * sw * lv[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) r.Lr[k] = r.Lr[k] + beta[k] * acc[k];
    if (last || r.bounce >= rec[OBJ_MAX_DEPTH]) return false;
    const float p5r = pow5(1.0f - clip01(dot3(v, n)));
    float rl[3];
    reflect(d, n, rl);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float F0s = fresnel_f0(scene_nre[k], scene_nim[k], prm[3 + k], prm[6 + k]);
      beta[k] = beta[k] * (F0s + (1.0f - F0s) * p5r);
      o[k] = nu[k];
      d[k] = rl[k];
    }
  } else if (mt == MAT_DIFFUSE) {
    // ---- diffuse + cap importance sampling (pallas_trace.py:706-807) ----
    if (r.dcnt >= 2) return false;            // diffuse depth reached
    const float* prm = s.dif + slot * 4;
    const float aw = prm[3];
    const int idx = r.idx;
    float ax_u[3], ax_v[3];
    orthobasis(n[0], n[1], n[2], ax_u, ax_v);
    float u_phi1, u_r21, u_phi2 = 0.0f, u_r22 = 0.0f, u_mixv = 0.0f;
    const bool first = !p.iid && r.dcnt == 0;   // R2 draws replace the hash
    u_phi1 = first ? r.sb_phi : hash_uniform(idx, seed0, cb_b + 1);
    u_r21 = first ? r.sb_r2 : hash_uniform(idx, seed0, cb_b + 2);
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
      u_phi2 = first ? r.sb_phi : hash_uniform(idx, seed0, cb_b + 4);
      u_r22 = first ? r.sb_r2 : hash_uniform(idx, seed0, cb_b + 5);
      u_mixv = first ? r.sb_mix : hash_uniform(idx, seed0, cb_b + 6);
      const float ru2 = hash_uniform(idx, seed0, cb_b + 3);
      const int pick = min((int)(ru2 * (float)K), K - 1);
      float sw[3], scm;
      cap_of(s.is + pick * 4, nu, sw, scm);
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
        cap_of(s.is + kk * 4, nu, w, cm);
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
    ++r.dcnt;
  } else if (mt == MAT_REFRACTIVE && r.bounce < rec[OBJ_MAX_DEPTH]) {
    // ---- refractive (pallas_trace.py:809-942); alive rays at bounce b
    // have made b transitions, so the depth cap tests the bounce ----
    const float* prm = s.refr + slot * 6;
    const float cos_i = -(d[0] * n[0] + d[1] * n[1] + d[2] * n[2]);
    const bool entering = orient > 0.0f;
    float Fr[3], n2r[3], n2i[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float n1r = r.nre[k], n1i = r.nim[k];
      n2r[k] = entering ? prm[k] : scene_nre[k];
      n2i[k] = entering ? prm[3 + k] : scene_nim[k];
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
    const float T[3] = {1.0f - Fr[0], 1.0f - Fr[1], 1.0f - Fr[2]};
    float rat[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) rat[k] = r.nre[k] / fmaxf(n2r[k], F(1e-9));
    float ratio_avg = (rat[0] + rat[1] + rat[2]) / 3.0f;
    // dispersion (pallas_trace.py:853-870): transmitted paths refract at
    // one uniformly chosen channel's IoR, that channel carrying 3x
    const int hu_g = rec[OBJ_HU1];
    int hero = -1;
    if (hu_g >= 0) {
      int a = 0;          // the group's place among this bounce's draws
      for (int j = 0; j < hu_g; ++j) a += r.bounce < p.hu_maxd[j];
      const float hu = hash_uniform(r.idx, seed0, cb_b + 7u + (uint32_t)a);
      hero = hu < F(1.0 / 3.0) ? 0 : (hu < F(2.0 / 3.0) ? 1 : 2);
      ratio_avg = rat[hero];
    }
    const float sin2t = ratio_avg * ratio_avg * (1.0f - cos_i * cos_i);
    const bool non_tir = sin2t <= 1.0f;
    const float croot = sqrtf(1.0f - clip01(sin2t));
    const float T_avg = (T[0] + T[1] + T[2]) / 3.0f;
    const float p_refr = non_tir ? clip01(T_avg) : 0.0f;
    const float ru0 = hash_uniform(r.idx, seed0, cb_b + 1);
    bool take = ru0 < p_refr && non_tir;
    // deterministic split (pallas_trace.py:902-926): for groups without mc
    // the bit of the sample index's pattern (mod 2^split_k) picks the
    // branch, weight 2F / 2T; a refraction the bit asks for under total
    // internal reflection ends the path
    const bool det = p.split_k && !rec[OBJ_MC] && r.scnt < p.split_k;
    if (det) {
      const int pattern = (r.idx / p.n_pix) & ((1 << p.split_k) - 1);
      const bool bit = ((pattern >> r.scnt) & 1) == 1;
      if (bit && !non_tir) return false;
      take = bit;
      ++r.scnt;
    }
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
    const float sgn = take ? -1.0f : 1.0f;
    // -4 pi / lambda * 1e9 per channel (utils/constants.py WAVELENGTHS_NM)
    const float absorb_c[3] = {F((-4.0 * PI / 630.0) * 1e9),
                               F((-4.0 * PI / 550.0) * 1e9),
                               F((-4.0 * PI / 475.0) * 1e9)};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float absorb = expf(r.nim[k] * (absorb_c[k] * t));
      float w_r = det ? 2.0f * T[k] : T[k] / fmaxf(p_refr, F(1e-9));
      const float w_l = det ? 2.0f * Fr[k] : Fr[k] / fmaxf(1.0f - p_refr, F(1e-9));
      if (hero >= 0) w_r = w_r * (k == hero ? 3.0f : 0.0f);
      beta[k] = beta[k] * (absorb * (take ? w_r : w_l));
    }
    if (take) {
#pragma unroll
      for (int k = 0; k < 3; ++k) { r.nre[k] = n2r[k]; r.nim[k] = n2i[k]; }
    }
    o[0] = px + n[0] * eps * sgn;
    o[1] = py + n[1] * eps * sgn;
    o[2] = pz + n[2] * eps * sgn;
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = nd[k];
  } else {
    return false;       // refractive past its depth cap: the path ends
  }
  return true;
}

__global__ void __launch_bounds__(K1_BLOCK, K1_MIN_BLOCKS)
solid_trace_kernel(Params p) {
  EXTERN_SHARED float smem[];
  // ---- scene tables -> shared memory, once per persistent block ----
  float* s_geom = smem;
  float* s_dif = s_geom + p.n_obj * GEOM_COLS;
  float* s_glo = s_dif + p.n_dif * 4;
  float* s_refr = s_glo + p.n_glo * 12;
  float* s_emi = s_refr + p.n_refr * 6;
  float* s_light = s_emi + p.n_emi * 3;
  float* s_is = s_light + p.n_lrow * 11;
  float* s_consts = s_is + (p.n_is > 0 ? p.n_is : 1) * 4;
  float* s_cam = s_consts + 16;
  int* s_obj = reinterpret_cast<int*>(s_cam + 17);
  int* s_seed = s_obj + p.n_obj * OBJ_COLS;
  __shared__ unsigned long long s_count;
  for (int i = threadIdx.x; i < p.n_obj * GEOM_COLS; i += K1_BLOCK) s_geom[i] = p.geom[i];
  for (int i = threadIdx.x; i < p.n_dif * 4; i += K1_BLOCK) s_dif[i] = p.dif[i];
  for (int i = threadIdx.x; i < p.n_glo * 12; i += K1_BLOCK) s_glo[i] = p.glo[i];
  for (int i = threadIdx.x; i < p.n_refr * 6; i += K1_BLOCK) s_refr[i] = p.refr[i];
  for (int i = threadIdx.x; i < p.n_emi * 3; i += K1_BLOCK) s_emi[i] = p.emi[i];
  for (int i = threadIdx.x; i < p.n_lrow * 11; i += K1_BLOCK) s_light[i] = p.lights[i];
  for (int i = threadIdx.x; i < p.n_is * 4; i += K1_BLOCK) s_is[i] = p.is_tab[i];
  for (int i = threadIdx.x; i < 16; i += K1_BLOCK) s_consts[i] = p.consts[i];
  for (int i = threadIdx.x; i < 17; i += K1_BLOCK) s_cam[i] = p.cam[i];
  for (int i = threadIdx.x; i < p.n_obj * OBJ_COLS; i += K1_BLOCK) s_obj[i] = p.obj[i];
  if (threadIdx.x < 3) s_seed[threadIdx.x] = p.seed[threadIdx.x];
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const Tables s = {s_geom, s_dif, s_glo, s_refr, s_emi, s_light, s_is,
                    s_consts, s_cam, s_obj, s_seed};

  // ---- the warp loop: refill free lanes; the nearest hit of every ray
  // whose last hit is shaded; then the shading of the hits, refractive ones
  // held back until K1_REFR_MIN of them can share the pass ----
  const unsigned lane = threadIdx.x & 31u;
  const unsigned long long n = (unsigned long long)p.n;
  unsigned long long my_count = 0, busy = 0, iters = 0;
  bool live = false;       // this lane holds a ray
  bool pending = false;    // ... whose hit (r.t, r.orient, r.hit) awaits shading
  bool more = true;        // the work counter may still hold rays (warp-uniform)
  Ray r;
  auto finish = [&]() {
    p.L[3 * (long long)r.idx + 0] = r.Lr[0];
    p.L[3 * (long long)r.idx + 1] = r.Lr[1];
    p.L[3 * (long long)r.idx + 2] = r.Lr[2];
    live = false;
  };
  for (;;) {
    if (more) {
      const unsigned need = __ballot_sync(FULL_MASK, !live);
      const int cnt = __popc(need);
      if (cnt >= K1_REFILL_MIN) {
        const int leader = __ffs(need) - 1;
        unsigned long long base = 0;
        if ((int)lane == leader) base = atomicAdd(p.next, (unsigned long long)cnt);
        base = __shfl_sync(FULL_MASK, base, leader);
        more = base + (unsigned long long)cnt < n;
        if (!live) {
          const unsigned long long mine = base + __popc(need & ((1u << lane) - 1u));
          if (mine < n) {
            start_ray(r, (int)mine, s, p);
            live = true;
            pending = false;
          }
        }
      }
    }
    const unsigned alive = __ballot_sync(FULL_MASK, live);
    if (alive == 0) break;                    // no ray left in this warp
    if (p.lane_stats) {
      busy += __popc(alive);
      ++iters;
    }
    if (live && !pending) {
      // ---- nearest hit (pallas_trace.py:594-604) ----
      ++my_count;                             // alive at the bounce's start
      nearest_hit(s.geom, s.obj, p.n_obj, r.o, r.d, r.t, r.orient, r.hit);
      pending = !(r.t >= MISS_THRESHOLD);
      if (!pending) finish();                 // a miss ends the path
    }
    const bool refr = pending && s.obj[r.hit * OBJ_COLS + OBJ_MAT_TYPE] == MAT_REFRACTIVE;
    const unsigned refr_mask = __ballot_sync(FULL_MASK, refr);
    const bool shade_refr = __popc(refr_mask) >= K1_REFR_MIN
                            || refr_mask == __ballot_sync(FULL_MASK, live);
    if (pending && (!refr || shade_refr)) {
      pending = false;
      if (!shade_hit(r, s, p) || ++r.bounce == p.max_bounces) finish();
    }
  }
  if (p.lane_stats && lane == 0) {
    atomicAdd(p.lane_stats, busy);
    atomicAdd(p.lane_stats + 1, 32ull * iters);
  }

  // ---- rays traced: warp sums, one shared add per warp, one global add ----
  for (int off = 16; off > 0; off >>= 1)
    my_count += __shfl_down_sync(FULL_MASK, my_count, off);
  if (lane == 0) atomicAdd(&s_count, my_count);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p.count, s_count);
}

}  // namespace

// The kernel as built and as the card holds it: out[0..8] = registers a
// thread, local memory bytes a thread (stack and spills), blocks per SM
// at `smem` bytes of dynamic shared memory (opted in past 48 KB), the SM
// count, K1_BLOCK, K1_MIN_BLOCKS, K1_REFILL_MIN, K1_REFR_MIN, and the
// card's opt-in maximum of dynamic shared memory a block.
extern "C" int solid_trace_info(int smem, int* out) {
  cudaFuncAttributes attr;
  int dev = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, solid_trace_kernel);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[8], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess) err = smem_opt_in(solid_trace_kernel, (size_t)smem, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], solid_trace_kernel,
                                                        K1_BLOCK, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[4] = K1_BLOCK;
  out[5] = K1_MIN_BLOCKS;
  out[6] = K1_REFILL_MIN;
  out[7] = K1_REFR_MIN;
  return 0;
}

// count: rays traced; next: the work counter; both zeroed by the caller
// on the launch's stream.  lane_stats: null, or (2,) zeroed counters.
extern "C" int solid_trace_launch(
    const int* seed, const float* cam, const float* geom, const int* obj,
    int n_obj, const float* dif, int n_dif, const float* glo, int n_glo,
    const float* refr, int n_refr, const float* emi, int n_emi,
    const float* lights, int n_lrow, int n_dir, int n_point, int n_spot,
    const float* is_tab, int n_is, const float* consts, int width, int height,
    int spp, int max_bounces, int iid, int split_k, int projection,
    const int* hu_maxd, int n_hu, float* L, long long* count, long long* next,
    long long* lane_stats, void* stream) {
  if (n_hu < 0 || n_hu > MAX_HU) return (int)cudaErrorInvalidValue;
  Params p;
  p.seed = seed; p.cam = cam; p.geom = geom; p.obj = obj;
  p.dif = dif; p.glo = glo; p.refr = refr; p.emi = emi; p.lights = lights;
  p.is_tab = is_tab; p.consts = consts;
  p.n_obj = n_obj; p.n_dif = n_dif; p.n_glo = n_glo; p.n_refr = n_refr;
  p.n_emi = n_emi; p.n_lrow = n_lrow; p.n_is = n_is;
  p.n_dir = n_dir; p.n_point = n_point; p.n_spot = n_spot;
  p.width = width; p.height = height; p.n_pix = width * height;
  p.n = spp * p.n_pix;
  p.max_bounces = max_bounces; p.iid = iid; p.split_k = split_k;
  p.projection = projection;
  p.n_hu = n_hu;
  for (int j = 0; j < MAX_HU; ++j) p.hu_maxd[j] = j < n_hu ? hu_maxd[j] : 0;
  p.L = L;
  p.count = reinterpret_cast<unsigned long long*>(count);
  p.next = reinterpret_cast<unsigned long long*>(next);
  p.lane_stats = reinterpret_cast<unsigned long long*>(lane_stats);
  const size_t smem = sizeof(float) * (
      (size_t)n_obj * (GEOM_COLS + OBJ_COLS) + (size_t)n_dif * 4
      + (size_t)n_glo * 12 + (size_t)n_refr * 6 + (size_t)n_emi * 3
      + (size_t)n_lrow * 11 + (size_t)(n_is > 0 ? n_is : 1) * 4 + 16 + 17 + 3);
  // the persistent grid: as many blocks as the card holds at once, no more
  // than the rays need
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = smem_opt_in(solid_trace_kernel, smem, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solid_trace_kernel,
                                                        K1_BLOCK, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long want = ((long long)p.n + K1_BLOCK - 1) / K1_BLOCK;
  long long grid = (long long)sms * per_sm;
  if (grid > want) grid = want;
  if (grid < 1) grid = 1;
  LAUNCH(solid_trace_kernel, (unsigned)grid, K1_BLOCK, smem,
         static_cast<cudaStream_t>(stream), p);
  return (int)cudaGetLastError();
}
