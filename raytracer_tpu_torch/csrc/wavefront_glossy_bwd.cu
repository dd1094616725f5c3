// W4's glossy backward for Hopper (sm_90a).
//
// The vector-Jacobian product of the glossy shading block (materials/
// shade.py `shade_glossy`, its shadow-ray geometry `light_rays`;
// raytracer_tpu/materials/shade.py:215 in the JAX package, whose gradient
// jax.grad takes through XLA's fused loops; no Pallas kernel) as `_Shade`'s
// backward takes it (ops/wavefront_shade.py `glossy_vjp`): the gradients of
// the block's ray inputs (D, N, P, eps, the medium, uv) and the per-ray
// rows that its tables' gathers and broadcasts hand their backward, from
// the gradients of the merged output's four fields the block writes (add,
// beta_mult, new_origin, new_dir), and those fields' pass-through
// gradients (the merge's where(m, 0, g)), in one launch.  Its plain
// version is ops/wavefront_shade.py `plain_shade_vjp` of the plain block
// merged under the mask, which it equals bit for bit.  The shadow rays'
// answers are inputs and take no gradient.
//
// One thread a ray, over every ray of the bounce (the rays outside the
// block's mask take +0 output gradients, which still pass through the
// block's backward).  Each ray's forward is recomputed in registers in the
// plain block's order (as csrc/wavefront_shade.cu's glossy entry computes
// it), then its backward node by node in the order autograd's engine runs
// the plain block's graph, the node created last first (csrc/
// wavefront_shade_bwd.cu sets out the rules, csrc/grad_acc.cuh keeps the
// buffers):
// - new_dir, the mirror direction r / sqrt(_sum3(r, r)), r = D - N (2
//   _sum3(D, N));
// - beta_mult, the mirror's Schlick-Fresnel term against the scene's
//   medium, F0 + (1 - F0) pow(1 - clamp(V.N), 5);
// - add, each light's term last light first (the add chain hands each the
//   same gradient): the specular lobe (masked by roughness != 0), whose
//   Blinn-Phong exponent a = 2 / clamp_min(roughness, 1e-6)^2 - 2 makes
//   pow(clamp(N.H), a) differentiate by base and exponent (ATen's
//   pow_backward_self and pow_backward_exponent, with their masks at
//   exponent 0 and base 0), its F0 against the ray's medium, the half
//   vector, the Lambert term, the light's irradiance (a point or spot
//   light's 1 / dist^2, a spot light's smoothstep cone), then the light's
//   own direction (light_rays: a directional light's expanded row, a point
//   or spot light's (pos - P) / safe_norm) into its tables' rows and P;
//   then the ambient term;
// - the nudged origin P + N eps, then the diffuse colour (`_slot_color`'s
//   wheres, a bilinear texture's into uv, every ref's texel taps' rows
//   where a colour texture takes a gradient) times glossy_diff.
// The tables' gradients are reductions in autograd's own order, in the
// wrapper: the gathered tables' per-ray rows and the textures' tap rows go
// to core/safemath.py `take_backward`, a broadcast row's (a light's colour, position and
// direction, the ambient colour, the scene's medium) to the engine's sum_to
// over the rays, then a select's full row of +0 pads a light.
//
// What bounds it: memory (a ray reads ~80 bytes and writes ~150, more with
// the light tables' rows); a light costs a few hundred operations.  The
// design keeps every intermediate of a ray in registers, recomputing a
// light's forward where its backward runs.
//
// Arithmetic: one rounding an op (built with --fmad=false, IEEE division
// and square root).  Built by the CPU tests with W4_TORCH_CPU (tests/
// test_torch_wavefront_glossy_bwd_emu.py), the source restates the CPU's
// torch instead (csrc/torch_math.cuh, csrc/grad_acc.cuh; pow, sqrt and
// their backward through float64, as the tests run the plain block).
//
// The entry returns cudaGetLastError() after its launch and reports the
// kernels it launched.

#include <cuda_runtime.h>

#include <math.h>

#include "grad_acc.cuh"
#include "texture_fetch.cuh"
#include "torch_math.cuh"

#ifndef CUDA_EMU
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace w4g {

using namespace grad_acc;
using namespace texture_fetch;
using namespace torch_math;

constexpr int GLOSSY_BWD_BLOCK = 128;   // threads a block, a ray each
constexpr int SLOT_SHIFT = 3;

struct Sum3 {
  __device__ __forceinline__ float operator()(float x0, float x1, float x2) const {
    return tsum3(x0, x1, x2);
  }
};

// The forward's inputs ((N, 3) float32 rows unless said), the output
// gradients (null: none comes), the pass-through gradients and the
// gradients to write (null: not wanted or not reached).
struct GlossBwd {
  const int* packed;          // (N,) the packed material word
  const unsigned char* m;     // (N,) bool: the block's rays
  const float* P;
  const float* N;
  const float* D;
  const float* eps;           // (N,)
  const float* uv;            // (N, 2)
  const float* n_re;          // the medium, rows re_step floats apart
  const float* n_im;
  long long re_step;          // 3, or 0 for one medium shared by every ray
  long long im_step;
  const float* color;         // (S, 3) glossy_color
  const float* diff;          // (S,) glossy_diff
  const float* rough;         // (S,) glossy_roughness
  const float* spec;          // (S,) glossy_spec
  const float* m_re;          // (S, 3) glossy_n_re
  const float* m_im;          // (S, 3) glossy_n_im
  int rows;
  int refs;                   // the colour's image textures (SceneStatic.glossy_tex)
  const int* ref_slot;        // (refs,) int32 each ref's slot
  Textures ref_tex;           // a row a ref
  const float* ambient;       // (3,)
  const float* scene_re;      // (3,)
  const float* scene_im;
  const float* dir_l;         // (Ld, 3)
  const float* dir_color;
  int n_dir;
  const float* point_pos;     // (Lp, 3)
  const float* point_color;
  int n_point;
  const float* spot_pos;      // (Ls, 3)
  const float* spot_dir;
  const float* spot_color;
  const float* spot_cos_in;   // (Ls,)
  const float* spot_cos_out;
  int n_spot;
  const unsigned char* occ;   // (lights, N) shadow answers, or null: all lit
  float five;                 // the Schlick exponent, 5
  long long n;
  // the gradients of add, beta_mult, new_origin, new_dir
  const float* g[4];
  // their pass-through gradients, where(m, 0, g)
  float* pass[4];
  // the inputs' gradients
  float* dD;
  float* dn_re;
  float* dn_im;
  float* dP;
  float* dN;
  float* duv;                 // (N, 2)
  float* deps;                // (N,)
  // the per-ray rows of the gathered tables' gradients: glossy_color's,
  // glossy_n_re's, glossy_n_im's (N, 3), glossy_diff's, glossy_roughness's,
  // glossy_spec's (N,)
  float* color_rows;
  float* m_re_rows;
  float* m_im_rows;
  float* diff_rows;
  float* rough_rows;
  float* spec_rows;
  // the broadcast rows' (N, 3): the ambient colour's, the scene medium's
  // of the mirror's F0 (its sum's and its difference's)
  float* amb_rows;
  float* sre_add;
  float* sre_sub;
  float* sim_add;
  float* sim_sub;
  // a light's (lights, N, 3): its colour's, and a directional light's
  // direction's or a point or spot light's position's
  float* lc_rows;
  float* lp_rows;
  // a spot light's: its direction's (spots, 3, N), a channel's rows
  // apart, and (spots, N) its cone's divisor's and -(its numerator's)
  float* sd_rows;
  float* cci_rows;
  float* nco_rows;
  // where a colour texture takes a gradient, every ref's taps' rows
  // (texture_fetch.cuh `tap_rows`), refs in order; else null
  TapRows taps;
};

// ---------------------------------------------------------------------------
// the ops the block's backward differentiates
// ---------------------------------------------------------------------------

#ifdef W4_TORCH_CPU
// pow(x, 5)'s backward, through float64: g (5 x^4)
__device__ __forceinline__ float pow5_bwd(float g, float x, float five) {
  return (float)((double)g * ((double)five * pow((double)x, (double)five - 1.0)));
}
// pow(b, a)'s backward for the base and for the exponent (ATen's
// pow_backward_self, pow_backward_exponent), through float64
__device__ __forceinline__ void powt_bwd(float g, float b, float a, float, float* gb,
                                         float* ga) {
  const double gd = g, bd = b, ad = a;
  *gb = (float)(ad == 0.0 ? 0.0 : gd * (ad * pow(bd, ad - 1.0)));
  *ga = (float)(gd * (bd == 0.0 && ad >= 0.0 ? 0.0 : pow(bd, ad) * log(bd)));
}
#else
__device__ __forceinline__ float pow5_bwd(float g, float x, float five) {
  return g * (five * powf(x, five - 1.0f));
}
__device__ __forceinline__ void powt_bwd(float g, float b, float a, float r, float* gb,
                                         float* ga) {
  *gb = a == 0.0f ? 0.0f : g * (a * powf(b, a - 1.0f));
  *ga = g * (b == 0.0f && a >= 0.0f ? 0.0f : r * logf(b));
}
#endif

// F0 = |n - m|^2 / clamp_min(|n + m|^2, 1e-20) (a channel) and its
// backward from its buffer g: n's share into nb_re / nb_im, m's into the
// rows mr / mi (the sum's, then the difference's)
struct Fresnel0 {
  float a, b, e, f, num, den2, den, F0;
};
__device__ __forceinline__ void f0(float nre, float nim, float mre, float mim, Fresnel0& q) {
  q.a = nre - mre;
  q.b = nim - mim;
  q.e = nre + mre;
  q.f = nim + mim;
  q.num = q.a * q.a + q.b * q.b;
  q.den2 = q.e * q.e + q.f * q.f;
  q.den = t_clamp_min(q.den2, F32(1e-20));
  q.F0 = q.num / q.den;
}
// the shares in the engine's order: the sum's imaginary and real parts,
// then the difference's (each a full gradient of its input)
struct F0Grad {
  float f, e, b, a;
};
__device__ __forceinline__ F0Grad f0_bwd(const Fresnel0& q, float g) {
  const float numb = g / q.den;
  const float denb = ge_or_zero(q.den2, F32(1e-20), div_other(g, q.num, q.den));
  F0Grad r;
  r.f = denb * q.f + denb * q.f;
  r.e = denb * q.e + denb * q.e;
  r.b = numb * q.b + numb * q.b;
  r.a = numb * q.a + numb * q.a;
  return r;
}

// ---------------------------------------------------------------------------
// one ray
// ---------------------------------------------------------------------------

__device__ void gloss_bwd_ray(const GlossBwd& B, long long i) {
  const bool mk = B.m[i] != 0;
  float G[4][3];
  bool gp[4];
  for (int f = 0; f < 4; ++f) {
    gp[f] = B.g[f] != nullptr;
    for (int c = 0; c < 3; ++c) {
      const float g = gp[f] ? B.g[f][3 * i + c] : 0.0f;
      G[f][c] = mk ? g : 0.0f;
      if (B.pass[f]) B.pass[f][3 * i + c] = mk ? 0.0f : g;
    }
  }

  // ---- the forward's per-ray values ----
  const int raw_slot = (B.packed[i] >> SLOT_SHIFT) & 0x3FF;
  const int slot = clip_slot(raw_slot, B.rows);
  float P[3], N[3], D[3], V[3], nre[3], nim[3], col[3], mre[3], mim[3];
  for (int c = 0; c < 3; ++c) {
    P[c] = B.P[3 * i + c];
    N[c] = B.N[3 * i + c];
    D[c] = B.D[3 * i + c];
    V[c] = -D[c];
    nre[c] = B.n_re[B.re_step * i + c];
    nim[c] = B.n_im[B.im_step * i + c];
    col[c] = B.color[3 * slot + c];
    mre[c] = B.m_re[3 * slot + c];
    mim[c] = B.m_im[3 * slot + c];
  }
  const float u = B.uv[2 * i], v = B.uv[2 * i + 1];
  for (int r = 0; r < B.refs; ++r)
    if (raw_slot == B.ref_slot[r]) fetch_texture(B.ref_tex, r, u, v, col);
  const float dcoef = B.diff[slot];
  float dc[3];
  for (int c = 0; c < 3; ++c) dc[c] = col[c] * dcoef;
  const float eps = B.eps[i];
  const float rough = B.rough[slot], sc = B.spec[slot];
  const bool r0 = rough != 0.0f;
  const float cr = t_clamp_min(rough, F32(1e-6));
  const float cr2 = cr * cr;
  const float a = 2.0f / cr2 - 2.0f;
  const float nv = sum3(N, V);

  Acc3 LD = {}, LN = {}, LP = {}, Lre = {}, Lim = {}, Vb = {};
  Acc3 mreb = {}, mimb = {}, dcb = {};
  Acc roughb = {}, specb = {};
  float t[3];

  // ---- new_dir = r / sqrt(_sum3(r, r)), r = D - N (2 _sum3(D, N)) ----
  if (gp[3]) {
    const float sdn = sum3(D, N);
    const float k = 2.0f * sdn;
    float r[3];
    for (int c = 0; c < 3; ++c) r[c] = D[c] - N[c] * k;
    const float rr = sum3(r, r);
    const float sq = sqrtf(rr);
    Acc3 rb = {};
    for (int c = 0; c < 3; ++c) t[c] = G[3][c] / sq;
    put3(rb, t);
    const float sqb = tsum3(div_other(G[3][0], r[0], sq), div_other(G[3][1], r[1], sq),
                            div_other(G[3][2], r[2], sq));
    const float g434 = sqrt_bwd(sqb, rr, sq);
    for (int c = 2; c >= 0; --c) {
      put_sel(rb, c, g434 * r[c]);
      put_sel(rb, c, g434 * r[c]);
    }
    put3(LD, rb.v);
    for (int c = 0; c < 3; ++c) t[c] = -rb.v[c] * k;
    put3(LN, t);
    const float g420 = tsum3(-rb.v[0] * N[0], -rb.v[1] * N[1], -rb.v[2] * N[2]) * 2.0f;
    for (int c = 2; c >= 0; --c) {
      put_sel(LN, c, g420 * D[c]);
      put_sel(LD, c, g420 * N[c]);
    }
  }

  // ---- beta_mult = F0 + (1 - F0) pow(1 - clamp(_sum3(V, N), 0, 1), 5) ----
  if (gp[1]) {
    const float cvn = t_clamp(nv, 0.0f, 1.0f);
    const float om = 1.0f - cvn;
    const float s5 = t_pow(om, B.five);
    Fresnel0 q[3];
    for (int c = 0; c < 3; ++c) f0(B.scene_re[c], B.scene_im[c], mre[c], mim[c], q[c]);
    const float s5b = tsum3(G[1][0] * (1.0f - q[0].F0), G[1][1] * (1.0f - q[1].F0),
                            G[1][2] * (1.0f - q[2].F0));
    const float g402 = in_or_zero(nv, 0.0f, 1.0f, -pow5_bwd(s5b, om, B.five));
    for (int c = 2; c >= 0; --c) {
      put_sel(LN, c, g402 * V[c]);
      put_sel(Vb, c, g402 * N[c]);
    }
    float sa[3], ss[3], ia[3], is[3];
    for (int c = 0; c < 3; ++c) {
      const F0Grad r = f0_bwd(q[c], G[1][c] + -(G[1][c] * s5));
      ia[c] = r.f;
      sa[c] = r.e;
      is[c] = r.b;
      ss[c] = r.a;
      t[c] = r.f;
    }
    put3(mimb, ia);
    put3(mreb, sa);
    for (int c = 0; c < 3; ++c) t[c] = -is[c];
    put3(mimb, t);
    for (int c = 0; c < 3; ++c) t[c] = -ss[c];
    put3(mreb, t);
    for (int c = 0; c < 3; ++c) {
      if (B.sim_add) B.sim_add[3 * i + c] = ia[c];
      if (B.sre_add) B.sre_add[3 * i + c] = sa[c];
      if (B.sim_sub) B.sim_sub[3 * i + c] = is[c];
      if (B.sre_sub) B.sre_sub[3 * i + c] = ss[c];
    }
  }

  // ---- add: each light's term, last light first, then the ambient ----
  const int lights = B.n_dir + B.n_point + B.n_spot;
  if (gp[0]) {
    const float* Gl = G[0];
    Fresnel0 q[3];
    for (int c = 0; c < 3; ++c) f0(nre[c], nim[c], mre[c], mim[c], q[c]);
#pragma unroll 1
    for (int l = lights - 1; l >= 0; --l) {
      const int kind = l < B.n_dir ? 0 : (l < B.n_dir + B.n_point ? 1 : 2);
      const int li = kind == 0 ? l : (kind == 1 ? l - B.n_dir : l - B.n_dir - B.n_point);
      // the light's direction (light_rays)
      float L[3], d[3], lc[3];
      float q2 = 0.0f, cq = 0.0f, sq = 0.0f, dist = 0.0f, cd = 0.0f;
      if (kind == 0) {
        for (int c = 0; c < 3; ++c) {
          L[c] = B.dir_l[3 * li + c];
          lc[c] = B.dir_color[3 * li + c];
        }
      } else {
        const float* pos = kind == 1 ? B.point_pos + 3 * li : B.spot_pos + 3 * li;
        for (int c = 0; c < 3; ++c) {
          d[c] = pos[c] - P[c];
          lc[c] = kind == 1 ? B.point_color[3 * li + c] : B.spot_color[3 * li + c];
        }
        q2 = tsum3(d[0] * d[0], d[1] * d[1], d[2] * d[2]);
        cq = t_clamp_min(q2, F32(1e-30));
        sq = sqrtf(cq);
        dist = q2 > 0.0f ? sq : 0.0f;
        cd = t_clamp_min(dist, F32(1e-20));
        for (int c = 0; c < 3; ++c) L[c] = d[c] / cd;
      }
      // light_term's values
      const float sdl = sum3(N, L);
      const float NdotL = t_clamp_min(sdl, 0.0f);
      const float see = B.occ != nullptr ? 1.0f - (float)B.occ[(long long)l * B.n + i] : 1.0f;
      float nL[3], sd[3];
      float cos_t = 0.0f, ci = 0.0f, co = 0.0f, num = 0.0f, cci = 0.0f, tq = 0.0f, tc = 0.0f;
      float cone = 0.0f, dd2 = 0.0f, Y = 0.0f, s = NdotL;
      if (kind == 2) {
        for (int c = 0; c < 3; ++c) {
          nL[c] = -L[c];
          sd[c] = B.spot_dir[3 * li + c];
        }
        cos_t = sum3(nL, sd);
        ci = B.spot_cos_in[li];
        co = B.spot_cos_out[li];
        num = cos_t - co;
        cci = t_clamp_min(ci - co, F32(1e-6));
        tq = num / cci;
        tc = t_clamp(tq, 0.0f, 1.0f);
        cone = (tc * tc) * (3.0f - 2.0f * tc);
      }
      if (kind == 1) {
        dd2 = dist * dist;
        s = (NdotL / dd2) * 100.0f;
      } else if (kind == 2) {
        dd2 = dist * dist;
        Y = NdotL * cone;
        s = (Y / dd2) * 100.0f;
      }
      float lv[3];
      for (int c = 0; c < 3; ++c) lv[c] = lc[c] * s;
      float H0[3], H[3];
      for (int c = 0; c < 3; ++c) H0[c] = L[c] + V[c];
      const float hq = tsum3(H0[0] * H0[0], H0[1] * H0[1], H0[2] * H0[2]);
      const float hcq = t_clamp_min(hq, F32(1e-30));
      const float hsq = sqrtf(hcq);
      const float hn0 = hq > 0.0f ? hsq : 0.0f;
      const float hn = t_clamp_min(hn0, F32(1e-20));
      for (int c = 0; c < 3; ++c) H[c] = H0[c] / hn;
      const float vh = sum3(V, H);
      const float omc = 1.0f - t_clamp(vh, 0.0f, 1.0f);
      const float s5 = t_pow(omc, B.five);
      float F[3];
      for (int c = 0; c < 3; ++c) F[c] = q[c].F0 + (1.0f - q[c].F0) * s5;
      const float nh = sum3(N, H);
      const float cnh = t_clamp(nh, 0.0f, 1.0f);
      const float Pw = t_pow(cnh, a);
      const float Dph = (Pw * (a + 2.0f)) / TWO_PI_F;
      const float nvl = nv * NdotL;
      const float den = 4.0f * t_clamp(nvl, F32(0.001), 1.0f);
      const float Q = Dph / den;
      const float Q2 = Q * see;
      const float coef = Q2 * sc;
      float X[3];
      for (int c = 0; c < 3; ++c) X[c] = F[c] * coef;

      // the specular lobe: where(roughness != 0, spec, 0), spec = (F coef) lv
      Acc3 lvb = {}, Fb = {}, Hb = {}, Lb = {};
      Acc NdotLb = {}, ab = {};
      float Xb[3];
      for (int c = 0; c < 3; ++c) {
        const float sb = r0 ? Gl[c] : 0.0f;
        Xb[c] = sb * lv[c];
        t[c] = sb * X[c];
      }
      put3(lvb, t);
      for (int c = 0; c < 3; ++c) t[c] = Xb[c] * coef;
      put3(Fb, t);
      const float coefb = tsum3(Xb[0] * F[0], Xb[1] * F[1], Xb[2] * F[2]);
      put(specb, coefb * Q2);
      const float Qb = (coefb * sc) * see;
      const float Dphb = Qb / den;
      const float g364 = in_or_zero(nvl, F32(0.001), 1.0f, div_other(Qb, Dph, den) * 4.0f);
      const float NVb = g364 * NdotL;
      put(NdotLb, g364 * nv);
      for (int c = 2; c >= 0; --c) {
        put_sel(Vb, c, NVb * N[c]);
        put_sel(LN, c, NVb * V[c]);
      }
      const float g351 = Dphb / TWO_PI_F;
      put(ab, g351 * Pw);
      float baseb, expb;
      powt_bwd(g351 * (a + 2.0f), cnh, a, Pw, &baseb, &expb);
      put(ab, expb);
      const float g347 = in_or_zero(nh, 0.0f, 1.0f, baseb);
      for (int c = 2; c >= 0; --c) {
        put_sel(Hb, c, g347 * N[c]);
        put_sel(LN, c, g347 * H[c]);
      }
      // a = 2 / clamp_min(roughness, 1e-6)^2 - 2
      put(roughb, ge_or_zero(rough, F32(1e-6), div_other(ab.v, 2.0f, cr2) * (2.0f * cr)));
      // F = F0 + (1 - F0) s5, s5 = pow(1 - clamp(_sum3(V, H), 0, 1), 5)
      const float s5b = tsum3(Fb.v[0] * (1.0f - q[0].F0), Fb.v[1] * (1.0f - q[1].F0),
                              Fb.v[2] * (1.0f - q[2].F0));
      const float g325 = in_or_zero(vh, 0.0f, 1.0f, -pow5_bwd(s5b, omc, B.five));
      for (int c = 2; c >= 0; --c) {
        put_sel(Hb, c, g325 * V[c]);
        put_sel(Vb, c, g325 * H[c]);
      }
      // F0 against the ray's medium
      float fi[3], fe[3], fb[3], fa[3];
      for (int c = 0; c < 3; ++c) {
        const F0Grad r = f0_bwd(q[c], Fb.v[c] + -(Fb.v[c] * s5));
        fi[c] = r.f;
        fe[c] = r.e;
        fb[c] = r.b;
        fa[c] = r.a;
      }
      put3(Lim, fi);
      put3(mimb, fi);
      put3(Lre, fe);
      put3(mreb, fe);
      put3(Lim, fb);
      for (int c = 0; c < 3; ++c) t[c] = -fb[c];
      put3(mimb, t);
      put3(Lre, fa);
      for (int c = 0; c < 3; ++c) t[c] = -fa[c];
      put3(mreb, t);
      // H = H0 / clamp_min(safe_norm(H0), 1e-20), H0 = L + V
      Acc3 H0b = {};
      for (int c = 0; c < 3; ++c) t[c] = Hb.v[c] / hn;
      put3(H0b, t);
      const float hnb = tsum3(div_other(Hb.v[0], H0[0], hn), div_other(Hb.v[1], H0[1], hn),
                              div_other(Hb.v[2], H0[2], hn));
      const float g299 = hq > 0.0f ? ge_or_zero(hn0, F32(1e-20), hnb) : 0.0f;
      const float g297 = ge_or_zero(hq, F32(1e-30), sqrt_bwd(g299, hcq, hsq));
      for (int c = 0; c < 3; ++c) t[c] = g297 * H0[c];
      put3(H0b, t);
      put3(H0b, t);
      put3(Lb, H0b.v);
      put3(Vb, H0b.v);
      // the Lambert term (dc lv) see
      for (int c = 0; c < 3; ++c) {
        const float g292 = Gl[c] * see;
        t[c] = g292 * lv[c];
        lv[c] = g292 * dc[c];
      }
      put3(dcb, t);
      put3(lvb, lv);
      // the light's irradiance lv = colour s
      float* lcr = B.lc_rows ? B.lc_rows + 3 * ((long long)l * B.n + i) : nullptr;
      if (lcr)
        for (int c = 0; c < 3; ++c) lcr[c] = lvb.v[c] * s;
      const float sb = tsum3(lvb.v[0] * lc[0], lvb.v[1] * lc[1], lvb.v[2] * lc[2]);
      Acc distb = {};
      float coneb = 0.0f;
      if (kind == 0) {
        put(NdotLb, sb);
      } else {
        const float g289 = sb * 100.0f;
        const float numv = kind == 1 ? NdotL : Y;
        put(distb, div_other(g289, numv, dd2) * (2.0f * dist));
        const float Yb = g289 / dd2;
        if (kind == 1) {
          put(NdotLb, Yb);
        } else {
          put(NdotLb, Yb * cone);
          coneb = Yb * NdotL;
        }
      }
      // NdotL = clamp_min(_sum3(N, L), 0)
      const float g284 = ge_or_zero(sdl, 0.0f, NdotLb.v);
      for (int c = 2; c >= 0; --c) {
        put_sel(Lb, c, g284 * N[c]);
        put_sel(LN, c, g284 * L[c]);
      }
      if (kind == 2) {
        // cone = t t (3 - 2 t), t = clamp((cos_t - co) / clamp_min(ci - co, 1e-6), 0, 1)
        Acc tb = {};
        put(tb, -(coneb * (tc * tc)) * 2.0f);
        const float g269 = coneb * (3.0f - 2.0f * tc);
        put(tb, g269 * tc);
        put(tb, g269 * tc);
        const float g268 = in_or_zero(tq, 0.0f, 1.0f, tb.v);
        const float numb = g268 / cci;
        const int sp = li;
        if (B.cci_rows) B.cci_rows[(long long)sp * B.n + i] = div_other(g268, num, cci);
        if (B.nco_rows) B.nco_rows[(long long)sp * B.n + i] = -numb;
        // cos_t = _sum3(-L, spot_dir[None, :])
        Acc3 nLb = {};
        for (int c = 2; c >= 0; --c) {
          if (B.sd_rows) B.sd_rows[((long long)sp * 3 + c) * B.n + i] = numb * nL[c];
          put_sel(nLb, c, numb * sd[c]);
        }
        for (int c = 0; c < 3; ++c) t[c] = -nLb.v[c];
        put3(Lb, t);
      }
      // the light's direction: a directional light's row; a point or spot
      // light's d / clamp_min(dist, 1e-20), d = pos - P
      float* lpr = B.lp_rows ? B.lp_rows + 3 * ((long long)l * B.n + i) : nullptr;
      if (kind == 0) {
        if (lpr)
          for (int c = 0; c < 3; ++c) lpr[c] = Lb.v[c];
      } else {
        Acc3 db = {};
        for (int c = 0; c < 3; ++c) t[c] = Lb.v[c] / cd;
        put3(db, t);
        const float cdb = tsum3(div_other(Lb.v[0], d[0], cd), div_other(Lb.v[1], d[1], cd),
                                div_other(Lb.v[2], d[2], cd));
        put(distb, ge_or_zero(dist, F32(1e-20), cdb));
        const float g38 = q2 > 0.0f ? distb.v : 0.0f;
        const float g35 = ge_or_zero(q2, F32(1e-30), sqrt_bwd(g38, cq, sq));
        for (int c = 0; c < 3; ++c) t[c] = g35 * d[c];
        put3(db, t);
        put3(db, t);
        if (lpr)
          for (int c = 0; c < 3; ++c) lpr[c] = db.v[c];
        for (int c = 0; c < 3; ++c) t[c] = -db.v[c];
        put3(LP, t);
      }
    }
    // the ambient term ambient[None, :] dc
    for (int c = 0; c < 3; ++c) {
      if (B.amb_rows) B.amb_rows[3 * i + c] = Gl[c] * dc[c];
      t[c] = Gl[c] * B.ambient[c];
    }
    put3(dcb, t);
  }

  // ---- the nudged origin P + N eps ----
  if (gp[2]) {
    put3(LP, G[2]);
    for (int c = 0; c < 3; ++c) t[c] = G[2][c] * eps;
    put3(LN, t);
  }
  // ---- V = -D ----
  if (Vb.has) {
    for (int c = 0; c < 3; ++c) t[c] = -Vb.v[c];
    put3(LD, t);
  }
  for (int c = 0; c < 3; ++c) {
    if (B.dD) B.dD[3 * i + c] = got(LD, c);
    if (B.dN) B.dN[3 * i + c] = got(LN, c);
    if (B.dP) B.dP[3 * i + c] = got(LP, c);
    if (B.dn_re) B.dn_re[3 * i + c] = got(Lre, c);
    if (B.dn_im) B.dn_im[3 * i + c] = got(Lim, c);
    if (B.m_re_rows) B.m_re_rows[3 * i + c] = got(mreb, c);
    if (B.m_im_rows) B.m_im_rows[3 * i + c] = got(mimb, c);
  }
  if (B.deps)
    B.deps[i] = gp[2] ? tsum3(G[2][0] * N[0], G[2][1] * N[1], G[2][2] * N[2]) : 0.0f;
  if (B.rough_rows) B.rough_rows[i] = got(roughb);
  if (B.spec_rows) B.spec_rows[i] = got(specb);
  // the diffuse colour dc = colour * glossy_diff[..., None]: the colour's
  // wheres, last ref first, each bilinear ref's fetch into uv
  float colb[3];
  for (int c = 0; c < 3; ++c) colb[c] = got(dcb, c) * dcoef;
  if (B.diff_rows)
    B.diff_rows[i] = dcb.has ? tsum3(dcb.v[0] * col[0], dcb.v[1] * col[1], dcb.v[2] * col[2])
                             : 0.0f;
  float a0 = 0.0f, a1 = 0.0f;
  bool has = false;
  int plane = B.taps.rows ? tap_planes_total(B.ref_tex, B.refs) : 0;
  for (int r = B.refs - 1; r >= 0; --r) {
    const bool at = raw_slot == B.ref_slot[r];
    float gc[3];
    for (int c = 0; c < 3; ++c) {
      gc[c] = at ? colb[c] : 0.0f;
      colb[c] = at ? 0.0f : colb[c];
    }
    if (B.taps.rows) {
      plane -= tap_planes(B.ref_tex, r);
      tap_rows(B.ref_tex, r, u, v, gc, B.taps, plane, B.n, i);
    }
    if (!(B.ref_tex.desc_i[4 * r + 3] & 2)) continue;
    float gu, gv;
    bilinear_bwd(B.ref_tex, r, u, v, gc, &gu, &gv, Sum3());
    a0 = has ? a0 + 0.0f : 0.0f;
    a1 = has ? a1 + gv : gv;
    a0 = a0 + gu;
    a1 = a1 + 0.0f;
    has = true;
  }
  if (B.duv) {
    B.duv[2 * i] = a0;
    B.duv[2 * i + 1] = a1;
  }
  if (B.color_rows)
    for (int c = 0; c < 3; ++c) B.color_rows[3 * i + c] = colb[c];
}

__global__ void __launch_bounds__(GLOSSY_BWD_BLOCK)
shade_glossy_bwd_kernel(GlossBwd B) {
  const long long stride = (long long)gridDim.x * GLOSSY_BWD_BLOCK;
  for (long long i = (long long)blockIdx.x * GLOSSY_BWD_BLOCK + threadIdx.x; i < B.n;
       i += stride)
    gloss_bwd_ray(B, i);
}

cudaError_t residency(int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, shade_glossy_bwd_kernel,
                                                        GLOSSY_BWD_BLOCK, 0);
  return err;
}

bool bwd_ok(const GlossBwd& B) {
  bool any = false;
  for (int f = 0; f < 4; ++f) {
    if (B.pass[f] && !B.g[f]) return false;
    any = any || B.g[f];
  }
  const bool ga = B.g[0], gb = B.g[1], go = B.g[2], gd = B.g[3];
  const bool pt = B.n_point + B.n_spot > 0;
  return B.n >= 1 && any && B.packed && B.m && B.P && B.N && B.D && B.eps && B.uv
         && B.n_re && B.n_im && (B.re_step == 0 || B.re_step == 3)
         && (B.im_step == 0 || B.im_step == 3) && B.color && B.diff && B.rough && B.spec
         && B.m_re && B.m_im && B.rows >= 1 && B.ambient && B.scene_re && B.scene_im
         && B.n_dir >= 0 && B.n_point >= 0 && B.n_spot >= 0
         && (B.n_dir == 0 || (B.dir_l && B.dir_color))
         && (B.n_point == 0 || (B.point_pos && B.point_color))
         && (B.n_spot == 0 || (B.spot_pos && B.spot_dir && B.spot_color && B.spot_cos_in
                               && B.spot_cos_out))
         && (B.refs == 0 || (B.ref_slot && B.ref_tex.texels && B.ref_tex.desc_i
                             && B.ref_tex.desc_f))
         && (!B.dD || ga || gb || gd) && (!B.dN || ga || gb || go || gd)
         && (!B.dP || go || (ga && pt)) && (!B.deps || go) && (!(B.dn_re || B.dn_im) || ga)
         && (!(B.duv || B.color_rows || B.diff_rows || B.amb_rows) || ga)
         && (!(B.rough_rows || B.spec_rows) || ga) && (!(B.m_re_rows || B.m_im_rows) || ga || gb)
         && (!(B.sre_add || B.sre_sub || B.sim_add || B.sim_sub) || gb)
         && (!(B.lc_rows || B.lp_rows || B.sd_rows || B.cci_rows || B.nco_rows) || ga)
         && (!B.taps.rows || (ga && B.refs >= 1 && B.taps.idx));
}

}  // namespace w4g

using namespace w4g;

// The glossy block's backward on the bounce B (ops/wavefront_shade.py
// builds it), one launch.  Returns 0 or a CUDA error, and sets *launched
// to the kernels launched.
extern "C" int shade_glossy_bwd(const GlossBwd* B, void* stream, int* launched) {
  *launched = 0;
  if (!bwd_ok(*B)) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = residency(&sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long need = (B->n + GLOSSY_BWD_BLOCK - 1) / GLOSSY_BWD_BLOCK;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < most ? need : most);
  LAUNCH(shade_glossy_bwd_kernel, grid, GLOSSY_BWD_BLOCK, 0,
         static_cast<cudaStream_t>(stream), *B);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// What the kernel was built to: out[0] registers a thread, out[1] local
// memory a thread (bytes: spills and stack), out[2] resident blocks an SM,
// out[3] the SMs, out[4] threads a block, out[5] the __launch_bounds__
// minimum of blocks an SM, out[6] rays a block a pass.
extern "C" int shade_glossy_bwd_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, shade_glossy_bwd_kernel);
  if (err == cudaSuccess) err = residency(&out[3], &out[2]);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[4] = GLOSSY_BWD_BLOCK;
  out[5] = 1;
  out[6] = GLOSSY_BWD_BLOCK;
  return 0;
}
