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
// block's backward).  Each ray's forward is recomputed in the
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
// Layout (redesigned for the H100): the rays in tiles of GLOSSY_BWD_TILE,
// a thread a ray.  A tile's (N, 3) inputs (P, N, D, the medium, the
// four output gradients, masked) are read into shared memory element by
// element, neighbouring threads on neighbouring floats, so that a warp
// touches whole sectors; the pass-through gradients leave in the same
// pass.  Each thread then runs its ray, reading its inputs from the tile
// where they are needed; its (N, 3) buffers accumulate in the tile's rows,
// their "has a gradient come yet" flags bits of one word (csrc/
// grad_acc.cuh `put3_at`), and each channel's Fresnel F0 stays in
// registers, the terms its backward reads in the tile.  The tile's
// (N, 3) gradients and rows leave element by element after its rays are
// done, and a light's (light, N, 3) rows after that light's terms.
//
// What bounds it: the FP32 issue slots of a ray's light terms (~1,000
// FP32 instructions a light off the SASS: IEEE divisions and square
// roots, powf and logf) against the ~80 bytes a ray reads and ~150 it
// writes (chip_smoke.py --backward counts both).  The design keeps the
// registers low enough for GLOSS_BWD_MIN_BLOCKS blocks an SM, which hide
// the chain's latency.
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

// the __launch_bounds__ minimum of resident blocks an SM: the most that
// builds with no spills (ptxas -v)
constexpr int GLOSS_BWD_MIN_BLOCKS = 4;

using namespace grad_acc;
using namespace texture_fetch;
using namespace torch_math;

constexpr int GLOSSY_BWD_TILE = 128;    // rays a tile, threads a block
constexpr int ROW = 3 * GLOSSY_BWD_TILE;  // floats of a tile's (N, 3) row
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

// The tile's rows in shared memory: the inputs (a medium every ray shares
// copied into each ray's row; the output gradients masked); the ray's buffers that leave as (N, 3) gradients; V's and the
// diffuse colour's buffers and the colour; the rows written once; one
// light's rows; the terms of each channel's F0 against the ray's medium
// that its backward reads (n - m, n + m, |n + m|^2), kept for the lights
// in the slots of beta_mult's and new_dir's gradients (read by then), of
// two rows written after the lights, and one of their own.
enum Slot {
  S_P, S_N, S_D, S_RE, S_IM, S_G0,
  S_LD = S_G0 + 4, S_LN, S_LP, S_LRE, S_LIM, S_MRE, S_MIM,
  S_VB, S_DCB, S_COL,
  S_CROWS, S_AMB, S_SRA, S_SRS, S_SIA, S_SIS,
  S_LC, S_LPR, S_QD, NSLOT
};
constexpr int S_QA = S_G0 + 1, S_QB = S_G0 + 3, S_QE = S_CROWS, S_QF = S_AMB;
// each buffer's flag, a bit of one word
enum : unsigned {
  F_LD = 1u, F_LN = 2u, F_LP = 4u, F_LRE = 8u, F_LIM = 16u, F_MRE = 32u, F_MIM = 64u,
  F_VB = 128u, F_DCB = 256u, F_ROUGH = 512u, F_SPEC = 1024u
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
// (den's share is -g ((num / den) / den): num / den is F0, the same op)
__device__ __forceinline__ F0Grad f0_bwd(const Fresnel0& q, float g) {
  const float numb = g / q.den;
  const float denb = ge_or_zero(q.den2, F32(1e-20), -g * (q.F0 / q.den));
  F0Grad r;
  r.f = denb * q.f + denb * q.f;
  r.e = denb * q.e + denb * q.e;
  r.b = numb * q.b + numb * q.b;
  r.a = numb * q.a + numb * q.a;
  return r;
}

// ---------------------------------------------------------------------------
// one tile
// ---------------------------------------------------------------------------

// The ray of thread tt of the tile at r0 (cnt rays; a thread past them
// only meets the light loop's barriers): its forward recomputed, then its
// backward node by node in the engine's order, its (N, 3) gradients into
// the tile's slots.  Every thread of the block calls it.
__device__ __forceinline__ void gloss_bwd_ray(const GlossBwd& B, long long r0, int cnt,
                                              float (*sh)[ROW]) {
  const int tt = (int)threadIdx.x;
  const bool act = tt < cnt;
  const long long i = r0 + tt;
  const int e0 = 3 * tt;
  const float* const P = sh[S_P] + e0;
  const float* const N = sh[S_N] + e0;
  const float* const D = sh[S_D] + e0;
  const float* const RE = sh[S_RE] + e0;
  const float* const IM = sh[S_IM] + e0;
  const float* const Gl = sh[S_G0] + e0;        // add's gradient, masked
  const float* const G1 = sh[S_G0 + 1] + e0;    // beta_mult's
  const float* const G2 = sh[S_G0 + 2] + e0;    // new_origin's
  const float* const G3 = sh[S_G0 + 3] + e0;    // new_dir's
  float* const LD = sh[S_LD] + e0;
  float* const LN = sh[S_LN] + e0;
  float* const LP = sh[S_LP] + e0;
  float* const Lre = sh[S_LRE] + e0;
  float* const Lim = sh[S_LIM] + e0;
  float* const mreb = sh[S_MRE] + e0;
  float* const mimb = sh[S_MIM] + e0;
  float* const Vb = sh[S_VB] + e0;
  float* const dcb = sh[S_DCB] + e0;
  float* const col = sh[S_COL] + e0;
  const bool gp0 = B.g[0] != nullptr, gp1 = B.g[1] != nullptr, gp2 = B.g[2] != nullptr,
             gp3 = B.g[3] != nullptr;
  unsigned fl = 0u;
  float roughb = 0.0f, specb = 0.0f;
  float t[3];

  // ---- the forward's per-ray values ----
  int raw_slot = 0, slot = 0;
  float u = 0.0f, v = 0.0f, dcoef = 0.0f, rough = 0.0f, sc = 0.0f, cr = 0.0f, cr2 = 0.0f;
  float a = 0.0f, nv = 0.0f;
  bool r0f = false;
  float F0r[3] = {};          // each channel's F0 against the ray's medium
  if (act) {
    raw_slot = (B.packed[i] >> SLOT_SHIFT) & 0x3FF;
    slot = clip_slot(raw_slot, B.rows);
    const float* const mre = B.m_re + 3 * slot;
    const float* const mim = B.m_im + 3 * slot;
    float cl[3];
    for (int c = 0; c < 3; ++c) cl[c] = B.color[3 * slot + c];
    u = B.uv[2 * i];
    v = B.uv[2 * i + 1];
    for (int r = 0; r < B.refs; ++r)
      if (raw_slot == B.ref_slot[r]) fetch_texture(B.ref_tex, r, u, v, cl);
    for (int c = 0; c < 3; ++c) col[c] = cl[c];
    dcoef = B.diff[slot];
    rough = B.rough[slot];
    sc = B.spec[slot];
    r0f = rough != 0.0f;
    cr = t_clamp_min(rough, F32(1e-6));
    cr2 = cr * cr;
    a = 2.0f / cr2 - 2.0f;
    const float V[3] = {-D[0], -D[1], -D[2]};
    nv = sum3(N, V);

    // ---- new_dir = r / sqrt(_sum3(r, r)), r = D - N (2 _sum3(D, N)) ----
    if (gp3) {
      const float sdn = sum3(D, N);
      const float k = 2.0f * sdn;
      float r[3];
      for (int c = 0; c < 3; ++c) r[c] = D[c] - N[c] * k;
      const float rr = sum3(r, r);
      const float sq = sqrtf(rr);
      Acc3 rb = {};
      for (int c = 0; c < 3; ++c) t[c] = G3[c] / sq;
      put3(rb, t);
      const float sqb = tsum3(div_other(G3[0], r[0], sq), div_other(G3[1], r[1], sq),
                              div_other(G3[2], r[2], sq));
      const float g434 = sqrt_bwd(sqb, rr, sq);
      for (int c = 2; c >= 0; --c) {
        put_sel(rb, c, g434 * r[c]);
        put_sel(rb, c, g434 * r[c]);
      }
      put3_at(LD, fl, F_LD, rb.v);
      for (int c = 0; c < 3; ++c) t[c] = -rb.v[c] * k;
      put3_at(LN, fl, F_LN, t);
      const float g420 = tsum3(-rb.v[0] * N[0], -rb.v[1] * N[1], -rb.v[2] * N[2]) * 2.0f;
      for (int c = 2; c >= 0; --c) {
        put_sel_at(LN, fl, F_LN, c, g420 * D[c]);
        put_sel_at(LD, fl, F_LD, c, g420 * N[c]);
      }
    }

    // ---- beta_mult = F0 + (1 - F0) pow(1 - clamp(_sum3(V, N), 0, 1), 5),
    // F0 against the scene's medium ----
    if (gp1) {
      const float cvn = t_clamp(nv, 0.0f, 1.0f);
      const float om = 1.0f - cvn;
      const float s5 = t_pow(om, B.five);
      for (int c = 0; c < 3; ++c) {
        Fresnel0 q;
        f0(B.scene_re[c], B.scene_im[c], mre[c], mim[c], q);
        t[c] = G1[c] * (1.0f - q.F0);
      }
      const float s5b = tsum3(t[0], t[1], t[2]);
      const float g402 = in_or_zero(nv, 0.0f, 1.0f, -pow5_bwd(s5b, om, B.five));
      for (int c = 2; c >= 0; --c) {
        put_sel_at(LN, fl, F_LN, c, g402 * V[c]);
        put_sel_at(Vb, fl, F_VB, c, g402 * N[c]);
      }
      // the shares of each channel, in the engine's order: m_im's and
      // m_re's of the sum, then of the difference (-)
      const bool hi = (fl & F_MIM) != 0u, hr = (fl & F_MRE) != 0u;
      for (int c = 0; c < 3; ++c) {
        Fresnel0 q;
        f0(B.scene_re[c], B.scene_im[c], mre[c], mim[c], q);
        const F0Grad r = f0_bwd(q, G1[c] + -(G1[c] * s5));
        mimb[c] = hi ? mimb[c] + r.f : r.f;
        mreb[c] = hr ? mreb[c] + r.e : r.e;
        mimb[c] = mimb[c] + -r.b;
        mreb[c] = mreb[c] + -r.a;
        sh[S_SIA][e0 + c] = r.f;
        sh[S_SRA][e0 + c] = r.e;
        sh[S_SIS][e0 + c] = r.b;
        sh[S_SRS][e0 + c] = r.a;
      }
      fl |= F_MIM | F_MRE;
    }
    // each channel's F0 against the ray's medium, and its terms the
    // lights' backward reads
    if (gp0)
      for (int c = 0; c < 3; ++c) {
        Fresnel0 q;
        f0(RE[c], IM[c], mre[c], mim[c], q);
        F0r[c] = q.F0;
        sh[S_QA][e0 + c] = q.a;
        sh[S_QB][e0 + c] = q.b;
        sh[S_QE][e0 + c] = q.e;
        sh[S_QF][e0 + c] = q.f;
        sh[S_QD][e0 + c] = q.den2;
      }
  }

  // ---- add: each light's term, last light first, then the ambient ----
  const int lights = B.n_dir + B.n_point + B.n_spot;
  const bool light_rows = B.lc_rows != nullptr || B.lp_rows != nullptr;
  if (gp0) {
#pragma unroll 1
    for (int l = lights - 1; l >= 0; --l) {
      if (act) {
        const int kind = l < B.n_dir ? 0 : (l < B.n_dir + B.n_point ? 1 : 2);
        const int li = kind == 0 ? l : (kind == 1 ? l - B.n_dir : l - B.n_dir - B.n_point);
        const float V[3] = {-D[0], -D[1], -D[2]};
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
        float ci = 0.0f, co = 0.0f, num = 0.0f, cci = 0.0f, tq = 0.0f, tc = 0.0f;
        float cone = 0.0f, dd2 = 0.0f, Y = 0.0f, s = NdotL;
        if (kind == 2) {
          for (int c = 0; c < 3; ++c) {
            nL[c] = -L[c];
            sd[c] = B.spot_dir[3 * li + c];
          }
          const float cos_t = sum3(nL, sd);
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
        // F = F0 + (1 - F0) s5, F0 against the ray's medium
        float F[3];
        for (int c = 0; c < 3; ++c) F[c] = F0r[c] + (1.0f - F0r[c]) * s5;
        const float nh = sum3(N, H);
        const float cnh = t_clamp(nh, 0.0f, 1.0f);
        const float Pw = t_pow(cnh, a);
        const float Dph = (Pw * (a + 2.0f)) / TWO_PI_F;
        const float nvl = nv * NdotL;
        const float den = 4.0f * t_clamp(nvl, F32(0.001), 1.0f);
        const float Q = Dph / den;
        const float Q2 = Q * see;
        const float coef = Q2 * sc;

        // the specular lobe: where(roughness != 0, spec, 0), spec = (F coef) lv
        Acc3 lvb = {}, Fb = {}, Hb = {}, Lb = {};
        Acc NdotLb = {}, ab = {};
        float Xb[3];
        for (int c = 0; c < 3; ++c) {
          const float sb = r0f ? Gl[c] : 0.0f;
          Xb[c] = sb * lv[c];
          t[c] = sb * (F[c] * coef);
        }
        put3(lvb, t);
        for (int c = 0; c < 3; ++c) t[c] = Xb[c] * coef;
        put3(Fb, t);
        const float coefb = tsum3(Xb[0] * F[0], Xb[1] * F[1], Xb[2] * F[2]);
        put_at(specb, fl, F_SPEC, coefb * Q2);
        const float Qb = (coefb * sc) * see;
        const float Dphb = Qb / den;
        const float g364 = in_or_zero(nvl, F32(0.001), 1.0f, div_other(Qb, Dph, den) * 4.0f);
        const float NVb = g364 * NdotL;
        put(NdotLb, g364 * nv);
        for (int c = 2; c >= 0; --c) {
          put_sel_at(Vb, fl, F_VB, c, NVb * N[c]);
          put_sel_at(LN, fl, F_LN, c, NVb * V[c]);
        }
        const float g351 = Dphb / TWO_PI_F;
        put(ab, g351 * Pw);
        float baseb, expb;
        powt_bwd(g351 * (a + 2.0f), cnh, a, Pw, &baseb, &expb);
        put(ab, expb);
        const float g347 = in_or_zero(nh, 0.0f, 1.0f, baseb);
        for (int c = 2; c >= 0; --c) {
          put_sel(Hb, c, g347 * N[c]);
          put_sel_at(LN, fl, F_LN, c, g347 * H[c]);
        }
        // a = 2 / clamp_min(roughness, 1e-6)^2 - 2
        put_at(roughb, fl, F_ROUGH,
               ge_or_zero(rough, F32(1e-6), div_other(ab.v, 2.0f, cr2) * (2.0f * cr)));
        // F = F0 + (1 - F0) s5, s5 = pow(1 - clamp(_sum3(V, H), 0, 1), 5)
        for (int c = 0; c < 3; ++c) t[c] = Fb.v[c] * (1.0f - F0r[c]);
        const float s5b = tsum3(t[0], t[1], t[2]);
        const float g325 = in_or_zero(vh, 0.0f, 1.0f, -pow5_bwd(s5b, omc, B.five));
        for (int c = 2; c >= 0; --c) {
          put_sel(Hb, c, g325 * V[c]);
          put_sel_at(Vb, fl, F_VB, c, g325 * H[c]);
        }
        // F0 against the ray's medium: each channel's shares in the
        // engine's order, the sum's (n_im's and m_im's, n_re's and m_re's),
        // then the difference's (m's -)
        {
          const bool hli = (fl & F_LIM) != 0u, hmi = (fl & F_MIM) != 0u;
          const bool hlr = (fl & F_LRE) != 0u, hmr = (fl & F_MRE) != 0u;
          for (int c = 0; c < 3; ++c) {
            Fresnel0 q;
            q.a = sh[S_QA][e0 + c];
            q.b = sh[S_QB][e0 + c];
            q.e = sh[S_QE][e0 + c];
            q.f = sh[S_QF][e0 + c];
            q.den2 = sh[S_QD][e0 + c];
            q.den = t_clamp_min(q.den2, F32(1e-20));
            q.F0 = F0r[c];
            const F0Grad r = f0_bwd(q, Fb.v[c] + -(Fb.v[c] * s5));
            Lim[c] = hli ? Lim[c] + r.f : r.f;
            mimb[c] = hmi ? mimb[c] + r.f : r.f;
            Lre[c] = hlr ? Lre[c] + r.e : r.e;
            mreb[c] = hmr ? mreb[c] + r.e : r.e;
            Lim[c] = Lim[c] + r.b;
            mimb[c] = mimb[c] + -r.b;
            Lre[c] = Lre[c] + r.a;
            mreb[c] = mreb[c] + -r.a;
          }
          fl |= F_LIM | F_MIM | F_LRE | F_MRE;
        }
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
        put3_at(Vb, fl, F_VB, H0b.v);
        // the Lambert term (dc lv) see
        for (int c = 0; c < 3; ++c) {
          const float g292 = Gl[c] * see;
          t[c] = g292 * lv[c];
          lv[c] = g292 * (col[c] * dcoef);
        }
        put3_at(dcb, fl, F_DCB, t);
        put3(lvb, lv);
        // the light's irradiance lv = colour s
        if (B.lc_rows)
          for (int c = 0; c < 3; ++c) sh[S_LC][e0 + c] = lvb.v[c] * s;
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
          put_sel_at(LN, fl, F_LN, c, g284 * L[c]);
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
        if (kind == 0) {
          if (B.lp_rows)
            for (int c = 0; c < 3; ++c) sh[S_LPR][e0 + c] = Lb.v[c];
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
          if (B.lp_rows)
            for (int c = 0; c < 3; ++c) sh[S_LPR][e0 + c] = db.v[c];
          for (int c = 0; c < 3; ++c) t[c] = -db.v[c];
          put3_at(LP, fl, F_LP, t);
        }
      }
      if (light_rows) {
        // the light's (N, 3) rows out, element by element
        __syncthreads();
        for (int k = 0; k < 3; ++k) {
          const int e = k * GLOSSY_BWD_TILE + (int)threadIdx.x;
          if (e >= 3 * cnt) continue;
          const long long o = 3 * ((long long)l * B.n + r0) + e;
          if (B.lc_rows) B.lc_rows[o] = sh[S_LC][e];
          if (B.lp_rows) B.lp_rows[o] = sh[S_LPR][e];
        }
        __syncthreads();
      }
    }
  }
  if (!act) return;
  if (gp0) {
    // the ambient term ambient[None, :] dc
    for (int c = 0; c < 3; ++c) {
      if (B.amb_rows) sh[S_AMB][e0 + c] = Gl[c] * (col[c] * dcoef);
      t[c] = Gl[c] * B.ambient[c];
    }
    put3_at(dcb, fl, F_DCB, t);
  }

  // ---- the nudged origin P + N eps ----
  const float eps = B.eps[i];
  if (gp2) {
    put3_at(LP, fl, F_LP, G2);
    for (int c = 0; c < 3; ++c) t[c] = G2[c] * eps;
    put3_at(LN, fl, F_LN, t);
  }
  // ---- V = -D ----
  if (fl & F_VB) {
    for (int c = 0; c < 3; ++c) t[c] = -Vb[c];
    put3_at(LD, fl, F_LD, t);
  }
  // the gradients that leave from the tile: +0 where none came
  for (int c = 0; c < 3; ++c) {
    if (B.dD) LD[c] = (fl & F_LD) ? LD[c] : 0.0f;
    if (B.dN) LN[c] = (fl & F_LN) ? LN[c] : 0.0f;
    if (B.dP) LP[c] = (fl & F_LP) ? LP[c] : 0.0f;
    if (B.dn_re) Lre[c] = (fl & F_LRE) ? Lre[c] : 0.0f;
    if (B.dn_im) Lim[c] = (fl & F_LIM) ? Lim[c] : 0.0f;
    if (B.m_re_rows) mreb[c] = (fl & F_MRE) ? mreb[c] : 0.0f;
    if (B.m_im_rows) mimb[c] = (fl & F_MIM) ? mimb[c] : 0.0f;
  }
  if (B.deps)
    B.deps[i] = gp2 ? tsum3(G2[0] * N[0], G2[1] * N[1], G2[2] * N[2]) : 0.0f;
  if (B.rough_rows) B.rough_rows[i] = got_at(roughb, fl, F_ROUGH);
  if (B.spec_rows) B.spec_rows[i] = got_at(specb, fl, F_SPEC);
  // the diffuse colour dc = colour * glossy_diff[..., None]: the colour's
  // wheres, last ref first, each bilinear ref's fetch into uv
  const bool hd = (fl & F_DCB) != 0u;
  float colb[3];
  for (int c = 0; c < 3; ++c) colb[c] = (hd ? dcb[c] : 0.0f) * dcoef;
  if (B.diff_rows)
    B.diff_rows[i] = hd ? tsum3(dcb[0] * col[0], dcb[1] * col[1], dcb[2] * col[2]) : 0.0f;
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
    for (int c = 0; c < 3; ++c) sh[S_CROWS][e0 + c] = colb[c];
}

__global__ void __launch_bounds__(GLOSSY_BWD_TILE, GLOSS_BWD_MIN_BLOCKS)
shade_glossy_bwd_kernel(GlossBwd B) {
  __shared__ float sh[NSLOT][ROW];
  const int tt = (int)threadIdx.x;
  const long long stride = (long long)gridDim.x * GLOSSY_BWD_TILE;
  for (long long r0 = (long long)blockIdx.x * GLOSSY_BWD_TILE; r0 < B.n; r0 += stride) {
    const long long rest = B.n - r0;
    const int cnt = (int)(rest < GLOSSY_BWD_TILE ? rest : GLOSSY_BWD_TILE);
    // the tile's rows in, element by element: the output gradients masked
    // (the merge's where(m, o, g): +0 to the rays outside the block), their
    // pass-through gradients out
    for (int k = 0; k < 3; ++k) {
      const int e = k * GLOSSY_BWD_TILE + tt;
      if (e >= 3 * cnt) continue;
      const long long j = 3 * r0 + e;
      sh[S_P][e] = B.P[j];
      sh[S_N][e] = B.N[j];
      sh[S_D][e] = B.D[j];
      sh[S_RE][e] = B.re_step ? B.n_re[j] : B.n_re[e % 3];
      sh[S_IM][e] = B.im_step ? B.n_im[j] : B.n_im[e % 3];
      const bool mk = B.m[r0 + e / 3] != 0;
      for (int f = 0; f < 4; ++f) {
        if (!B.g[f]) continue;
        const float g = B.g[f][j];
        sh[S_G0 + f][e] = mk ? g : 0.0f;
        if (B.pass[f]) B.pass[f][j] = mk ? 0.0f : g;
      }
    }
    __syncthreads();
    gloss_bwd_ray(B, r0, cnt, sh);
    __syncthreads();
    // the tile's gradients and rows out, element by element
    for (int k = 0; k < 3; ++k) {
      const int e = k * GLOSSY_BWD_TILE + tt;
      if (e >= 3 * cnt) continue;
      const long long o = 3 * r0 + e;
      if (B.dD) B.dD[o] = sh[S_LD][e];
      if (B.dN) B.dN[o] = sh[S_LN][e];
      if (B.dP) B.dP[o] = sh[S_LP][e];
      if (B.dn_re) B.dn_re[o] = sh[S_LRE][e];
      if (B.dn_im) B.dn_im[o] = sh[S_LIM][e];
      if (B.m_re_rows) B.m_re_rows[o] = sh[S_MRE][e];
      if (B.m_im_rows) B.m_im_rows[o] = sh[S_MIM][e];
      if (B.color_rows) B.color_rows[o] = sh[S_CROWS][e];
      if (B.amb_rows) B.amb_rows[o] = sh[S_AMB][e];
      if (B.sre_add) B.sre_add[o] = sh[S_SRA][e];
      if (B.sre_sub) B.sre_sub[o] = sh[S_SRS][e];
      if (B.sim_add) B.sim_add[o] = sh[S_SIA][e];
      if (B.sim_sub) B.sim_sub[o] = sh[S_SIS][e];
    }
    __syncthreads();
  }
}

cudaError_t residency(int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, shade_glossy_bwd_kernel,
                                                        GLOSSY_BWD_TILE, 0);
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
  const long long need = (B->n + GLOSSY_BWD_TILE - 1) / GLOSSY_BWD_TILE;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < most ? need : most);
  LAUNCH(shade_glossy_bwd_kernel, grid, GLOSSY_BWD_TILE, 0,
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
  out[4] = GLOSSY_BWD_TILE;
  out[5] = GLOSS_BWD_MIN_BLOCKS;
  out[6] = GLOSSY_BWD_TILE;
  return 0;
}
