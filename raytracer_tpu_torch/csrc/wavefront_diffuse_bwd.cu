// W4's diffuse backward for Hopper (sm_90a).
//
// The vector-Jacobian product of the diffuse shading block (materials/
// shade.py `shade_diffuse` and the samplers of core/rng.py it calls;
// raytracer_tpu/materials/shade.py:317 in the JAX package, whose gradient
// jax.grad takes through XLA's fused loops; no Pallas kernel) as `_Shade`'s
// backward takes it (ops/wavefront_shade.py `diffuse_vjp`): the gradients
// of the block's ray inputs (P, N, eps, uv) and the per-ray rows that its
// tables' gathers and broadcasts hand their backward, from the gradients
// of the merged output's three fields the block writes (beta_mult,
// new_origin, new_dir), and those fields' pass-through gradients (the
// merge's where(m, 0, g)), in one launch.  Its plain version is
// ops/wavefront_shade.py `plain_shade_vjp` of the plain block merged under
// the mask, which it equals bit for bit.
//
// One thread a ray, over every ray of the bounce: the plain VJP hands the
// rays outside the block's mask +0 output gradients, which still pass
// through the block's backward, where they come out as +0, -0 or NaN (a
// recompute over the block's own rays would also change the tables'
// gradients: core/safemath.py `take_backward` scans every ray's row).
// Each ray's forward is recomputed in registers in the plain block's
// order (as csrc/wavefront_shade.cu's diffuse entry computes it, except
// that the plain block makes both the cosine and the caps direction of
// every ray and selects one, and their backward runs on both), then its
// backward node by node in the order autograd's engine runs the plain
// block's graph: the node created last first (the graph's sequence
// numbers; csrc/wavefront_shade_bwd.cu sets out the rules, csrc/
// grad_acc.cuh keeps the buffers).  The parts, last made first:
// - beta_mult = colour * weight, weight = (N.d clamped / clamp_min(pdf,
//   1e-9)) / pi: the colour's gradient (`_slot_color`'s wheres, last ref
//   first, a bilinear texture's into uv, every ref's texel taps' rows
//   where a colour texture takes a gradient) and the weight's;
// - the pdf's sum, last term first: the environment's (env_is_pdf's
//   row), the caps' (torch.sum over the K caps of each cap's value, its
//   geometry's backward: core/rng.py caps_geometry at the nudged origin,
//   is_radius's and is_center's (ray, cap) rows and the origin's share,
//   the engine's sum_to of an (N, K, 3) gradient over K in ATen's order,
//   csrc/aten_sum.cuh `outer_sum`; past ~4,080 caps, where ATen splits
//   that sum across blocks, the (N, K, 3) terms as rows, which the wrapper
//   sums with ATen's own op before the nudged origin's backward), the
//   cosine term's; the mixture weights (w, seg = (1 - w) / components);
// - the direction's wheres, last first: the environment's alias sample
//   (env_is_prob's row through the jitter), the caps sample (the picked
//   cap's basis and height, the gather's 0 + g at the pick, then every
//   cap's geometry again), the cosine lobe (N's basis);
// - the nudged origin P + N eps.
// The caps pdf's value is recomputed by the plan ATen's torch.sum takes
// (csrc/aten_sum.cuh, the forward's code: the register tree, the general
// plan, or the blocks' sums of a row split across blocks, added here one
// block after another and then as global_reduce's last block adds them).
// The tables' gradients are reductions in autograd's own order, in the
// wrapper: the gathered tables' per-ray rows and the textures' tap rows go
// to core/safemath.py `take_backward`, the caps' (ray, cap) rows to the engine's sum_to over
// the rays.
//
// What bounds it: operations past a few caps (each cap's geometry three
// times a ray: the pdf's value, its backward and the sample's backward;
// the origin's sums over K take their three outputs in one pass,
// `outer_sum3`), else memory (a ray reads ~100 bytes and writes ~60).
// The design keeps every intermediate of a ray in registers and makes no
// second pass.
//
// Arithmetic: one rounding an op (built with --fmad=false, IEEE division
// and square root).  Built by the CPU tests with W4_TORCH_CPU (tests/
// test_torch_wavefront_diffuse_bwd_emu.py), the source restates the CPU's
// torch instead (csrc/torch_math.cuh, csrc/aten_sum.cuh, csrc/
// grad_acc.cuh).
//
// The entry returns cudaGetLastError() after its launch and reports the
// kernels it launched.

#include <cuda_runtime.h>

#include <math.h>

#include "aten_sum.cuh"
#include "grad_acc.cuh"
#include "texture_fetch.cuh"
#include "torch_math.cuh"

#ifndef CUDA_EMU
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace w4d {

using namespace grad_acc;
using namespace texture_fetch;
using namespace torch_math;
using namespace torch_sum;

constexpr int DIFF_BWD_BLOCK = 128;   // threads a block, a ray each
constexpr int SLOT_SHIFT = 3;

// torch.sum over three as a functor (the texture fetch's backward)
struct Sum3 {
  __device__ __forceinline__ float operator()(float x0, float x1, float x2) const {
    return tsum3(x0, x1, x2);
  }
};

// The forward's inputs ((N, 3) float32 rows unless said), the output
// gradients (null: none comes), the pass-through gradients and the
// gradients to write (null: not wanted or not reached).
struct DiffBwd {
  const int* packed;          // (N,) the packed material word
  const unsigned char* m;     // (N,) bool: the block's rays
  const float* P;
  const float* N;
  const float* eps;           // (N,)
  const float* uv;            // (N, 2)
  const int* diffuse_refl;    // (N,) int32
  const float* u_mix;         // (N,) the block's draws
  const float* u_phi;
  const float* u_r2;
  const float* s_mix;         // (N,) stratified first-bounce draws, or null
  const float* s_phi;
  const float* s_r2;
  const long long* pick;      // (N,) int64 target of the caps branch, or null
  const float* color;         // (S, 3) diffuse_color
  const float* ambient_w;     // (S,) diffuse_ambient_weight
  int rows;
  int refs;                   // the colour's image textures (SceneStatic.diffuse_tex)
  const int* ref_slot;        // (refs,) int32 each ref's slot
  Textures ref_tex;           // a row a ref
  const float* is_center;     // (K, 3)
  const float* is_radius;     // (K,)
  int K;
  const float* env_prob;      // (Hs Ws,) alias tables, or null
  const int* env_alias;
  const float* env_pdf;
  int Hs, Ws;
  long long n;
  // the gradients of beta_mult, new_origin, new_dir
  const float* g[3];
  // their pass-through gradients, where(m, 0, g)
  float* pass[3];
  // the inputs' gradients
  float* dP;
  float* dN;
  float* deps;                // (N,)
  float* duv;                 // (N, 2)
  // the per-ray rows of the tables' gradients: diffuse_color's (N, 3),
  // diffuse_ambient_weight's, env_is_prob's and env_is_pdf's (N,), and the
  // caps' geometry's (N, K, 3) is_center and (N, K) is_radius rows of the
  // pdf's and of the sample's
  float* color_rows;
  float* w_rows;
  float* prob_rows;
  float* pdf_rows;
  float* cen_pdf;
  float* rad_pdf;
  float* cen_smp;
  float* rad_smp;
  // the rows env_is_prob's and env_is_pdf's gathers read (N,) int64
  long long* prob_idx;
  long long* pdf_idx;
  // where the engine's sum_to over K splits each output across blocks
  // (`outer_rows`: `outer_plan` refuses the plan), the origin's shares are
  // left to the wrapper, which sums them with ATen's own op: the caps
  // pdf's and the caps sample's (N, K, 3) rows of -(the Sub's buffer); dN
  // is then N's gradient before the nudged origin's share, and dP, deps
  // are not written
  float* opdf_rows;
  float* osmp_rows;
  int outer_rows;
  // where a colour texture takes a gradient, every ref's taps' rows
  // (texture_fetch.cuh `tap_rows`), refs in order; else null
  TapRows taps;
};

// ---------------------------------------------------------------------------
// the forward's parts
// ---------------------------------------------------------------------------

// core/rng.py _orthonormal_basis about w: the helper axis a, v0 = w x a,
// its norm nv, v = v0 / nv, u = w x v
struct Basis {
  float a[3], v0[3], nv, v[3], u[3];
};
__device__ __forceinline__ void basis(const float* w, Basis& b) {
  const bool y = fabsf(w[0]) > F32(0.9);
  b.a[0] = y ? 0.0f : 1.0f;
  b.a[1] = y ? 1.0f : 0.0f;
  b.a[2] = 0.0f;
  tcross(w, b.a, b.v0);
  b.nv = tnorm3(b.v0);
  for (int c = 0; c < 3; ++c) b.v[c] = b.v0[c] / b.nv;
  tcross(w, b.v, b.u);
}

// The basis's backward: the gradients vb of v (its buffer, first given)
// and ub of u = w x v; w's share into wb (cross(v, ub), then the helper
// axis's cross(a, v0b)).  Nodes u = cross(w, v), v = v0 / nv, nv =
// |v0|, v0 = cross(w, a), in the engine's order.
__device__ __forceinline__ void basis_bwd(const float* w, const Basis& b, Acc3& vb,
                                          const float* ub, Acc3& wb) {
  float t[3];
  cross3(b.v, ub, t);
  put3(wb, t);
  cross3(ub, w, t);
  put3(vb, t);
  Acc3 v0b = {};
  for (int c = 0; c < 3; ++c) t[c] = vb.v[c] / b.nv;
  put3(v0b, t);
  const float gn = tsum3(div_other(vb.v[0], b.v0[0], b.nv), div_other(vb.v[1], b.v0[1], b.nv),
                         div_other(vb.v[2], b.v0[2], b.nv));
  // linalg_vector_norm's backward: g (v0 / nv), masked to 0 where nv == 0
  for (int c = 0; c < 3; ++c) t[c] = gn * (b.nv == 0.0f ? 0.0f : b.v0[c] / b.nv);
  put3(v0b, t);
  cross3(b.a, v0b.v, t);
  put3(wb, t);
}

// core/rng.py caps_geometry of cap k at the origin o, its values in the
// order the forward makes them
struct Cap {
  float d[3], q, cq, sq, dist, cd, axw[3], rr, sm, x, cx, sx, cm;
};
__device__ __forceinline__ void cap(const DiffBwd& B, int k, const float* o, Cap& g) {
  for (int c = 0; c < 3; ++c) g.d[c] = B.is_center[3 * k + c] - o[c];
  g.q = tsum3(g.d[0] * g.d[0], g.d[1] * g.d[1], g.d[2] * g.d[2]);
  g.cq = t_clamp_min(g.q, F32(1e-30));
  g.sq = sqrtf(g.cq);
  g.dist = g.q > 0.0f ? g.sq : 0.0f;
  g.cd = t_clamp_min(g.dist, F32(1e-20));
  for (int c = 0; c < 3; ++c) g.axw[c] = g.d[c] / g.cd;
  g.rr = B.is_radius[k] / g.cd;
  g.sm = t_clamp(g.rr, 0.0f, 1.0f);
  g.x = 1.0f - g.sm * g.sm;
  g.cx = t_clamp_min(g.x, F32(1e-30));
  g.sx = sqrtf(g.cx);
  g.cm = g.x > 0.0f ? g.sx : 0.0f;
}

// The caps pdf's per-cap value at direction d (1 / x is torch's
// reciprocal(x) * 1.0)
__device__ __forceinline__ float cap_value(const Cap& g, const float* d) {
  const bool inside = tsum3(d[0] * g.axw[0], d[1] * g.axw[1], d[2] * g.axw[2]) > g.cm;
  return inside ? 1.0f / (((1.0f - g.cm) * 2.0f) * PI_F) : 0.0f;
}

// Cap k's geometry backward from its cos_max's gradient cmb and, on the
// sample's path (axb non-null), its axis's: is_radius's (ray, cap) row
// into *rad, is_center's into cen (three), and the origin's share (minus
// the Sub node's buffer) into *o_b (three).
__device__ __forceinline__ void cap_bwd(const DiffBwd& B, int k, const Cap& g, float cmb,
                                        const float* axb, float* rad, float* cen,
                                        float* o_b) {
  // cos_max = safe_sqrt(1 - sm sm), sm = clamp(R / cd, 0, 1)
  const float g33 = g.x > 0.0f ? cmb : 0.0f;
  const float g31 = ge_or_zero(g.x, F32(1e-30), sqrt_bwd(g33, g.cx, g.sx));
  const float g30 = -g31;
  const float smb = g30 * g.sm + g30 * g.sm;
  const float g28 = in_or_zero(g.rr, 0.0f, 1.0f, smb);
  *rad = g28 / g.cd;
  Acc wd = {};
  put(wd, ge_or_zero(g.dist, F32(1e-20), div_other(g28, B.is_radius[k], g.cd)));
  // ax_w = d / cd (the sample's path only)
  Acc3 db = {};
  if (axb != nullptr) {
    float t[3];
    for (int c = 0; c < 3; ++c) t[c] = axb[c] / g.cd;
    put3(db, t);
    const float gc = tsum3(div_other(axb[0], g.d[0], g.cd), div_other(axb[1], g.d[1], g.cd),
                           div_other(axb[2], g.d[2], g.cd));
    put(wd, ge_or_zero(g.dist, F32(1e-20), gc));
  }
  // dist = safe_sqrt(torch.sum(d d, -1))
  const float g22 = g.q > 0.0f ? wd.v : 0.0f;
  const float g20 = ge_or_zero(g.q, F32(1e-30), sqrt_bwd(g22, g.cq, g.sq));
  float t[3];
  for (int c = 0; c < 3; ++c) t[c] = g20 * g.d[c];
  put3(db, t);
  put3(db, t);
  // d = is_center - origin[..., None, :]
  for (int c = 0; c < 3; ++c) {
    cen[c] = db.v[c];
    o_b[c] = -db.v[c];
  }
}

// core/rng.py env_alias_sample's values
struct Env {
  int k;
  float p, cq, cp, jv, s0, s1, sy, x, cx, sx, rho, ce, se;
  bool take;
};
__device__ __forceinline__ void env_dir(const DiffBwd& B, float u1, float u2, Env& e,
                                        float* d) {
  const int n = B.Hs * B.Ws;
  const float x = u1 * (float)n;
  int k = (int)x;
  k = k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
  const float ju = x - (float)k;
  e.k = k;
  e.p = B.env_prob[k];
  e.take = u2 < e.p;
  e.cp = t_clamp_min(e.p, F32(1e-12));
  e.cq = t_clamp_min(1.0f - e.p, F32(1e-12));
  e.jv = e.take ? u2 / e.cp : (u2 - e.p) / e.cq;
  if (!e.take) k = B.env_alias[k];
  const float i = (float)(k / B.Ws);
  const float j = (float)t_rem(k, B.Ws);
  const float uu = t_div_scalar(j + ju, (float)B.Ws);
  e.s0 = -t_cos(t_div_scalar(i * PI_F, (float)B.Hs));
  e.s1 = -t_cos(t_div_scalar((i + 1.0f) * PI_F, (float)B.Hs));
  e.sy = e.s0 + e.jv * (e.s1 - e.s0);
  e.x = 1.0f - e.sy * e.sy;
  e.cx = t_clamp_min(e.x, F32(1e-30));
  e.sx = sqrtf(e.cx);
  e.rho = e.x > 0.0f ? e.sx : 0.0f;
  const float phi = uu * TWO_PI_F - PI_F;
  t_sincos(phi, &e.se, &e.ce);
  d[0] = e.rho * e.ce;
  d[1] = e.sy;
  d[2] = e.rho * e.se;
}

// core/rng.py env_pdf_value
__device__ __forceinline__ int env_cell(const DiffBwd& B, const float* d) {
  const float u = t_div_scalar(t_atan2(d[2], d[0]) + PI_F, TWO_PI_F);
  const float v = t_div_scalar(t_asin(t_clamp(d[1], -1.0f, 1.0f)) + HALF_PI_F, PI_F);
  int i = (int)(v * (float)B.Hs);
  i = i < 0 ? 0 : (i > B.Hs - 1 ? B.Hs - 1 : i);
  const int j = t_rem((int)(u * (float)B.Ws), B.Ws);
  int idx = wrap_add((int)((unsigned)i * (unsigned)B.Ws), j);
  const int last = B.Hs * B.Ws - 1;
  return idx < 0 ? 0 : (idx > last ? last : idx);
}

// The blocks' sums of a row split across blocks, block c's made on demand
// (each once) by aten_sum, for staged_sum
template <class Term>
struct BlockSums {
  const SumPlan& S;
  long long row;
  int K;
  Term& term;
  __device__ __forceinline__ float operator[](int c) const {
    return aten_sum(S, row, K, term, c);
  }
};

// The origin's three shares of the caps' geometry summed over the K caps
// as the engine's sum_to adds each of the three outputs (csrc/aten_sum.cuh
// `outer_sum`; none where K is 1): term3(k, v) makes cap k's three terms
// into v, each cap once.  On the card below 256 terms (a thread an output,
// four accumulators: M.by 1) the three outputs take one pass over the caps,
// their accumulators rotating in registers as `lane_sum_reg`'s do; a plan
// that splits the terms over warps, and the CPU's, take an output at a
// time (each cap's terms made once an output).
template <class Term3>
__device__ __forceinline__ void outer_sum3(const SumPlan& M, int K, Term3& term3,
                                           float* out) {
  float v[3];
  if (K == 1) {
    term3(0, v);
    for (int c = 0; c < 3; ++c) out[c] = v[c];
    return;
  }
#ifndef W4_TORCH_CPU
  if (M.by == 1) {
    float a0[3] = {0.0f, 0.0f, 0.0f}, a1[3] = {0.0f, 0.0f, 0.0f};
    float a2[3] = {0.0f, 0.0f, 0.0f}, a3[3] = {0.0f, 0.0f, 0.0f};
    int q = 0;
    for (int k = 0; k < K; ++k, ++q) {
      term3(k, v);
      for (int c = 0; c < 3; ++c) {
        const float t = a0[c] + v[c];
        a0[c] = a1[c];
        a1[c] = a2[c];
        a2[c] = a3[c];
        a3[c] = t;
      }
    }
    for (; (q & 3) != 0; ++q)
      for (int c = 0; c < 3; ++c) {
        const float t = a0[c];
        a0[c] = a1[c];
        a1[c] = a2[c];
        a2[c] = a3[c];
        a3[c] = t;
      }
    for (int c = 0; c < 3; ++c) out[c] = ((a0[c] + a1[c]) + a2[c]) + a3[c];
    return;
  }
#endif
  for (int c = 0; c < 3; ++c) {
    auto term = [&](long long k) {
      term3((int)k, v);
      return v[c];
    };
    out[c] = outer_sum(M, K, term);
  }
}

// ---------------------------------------------------------------------------
// one ray
// ---------------------------------------------------------------------------

constexpr int SUM_REG = 0, SUM_WIDE = 1;

template <int MODE>
__device__ __forceinline__ void diff_bwd_ray(const DiffBwd& B, const SumPlan& S,
                                             const SumPlan& M, long long i) {
  const bool mk = B.m[i] != 0;
  float G[3][3];
  bool gp[3];
  for (int f = 0; f < 3; ++f) {
    gp[f] = B.g[f] != nullptr;
    for (int c = 0; c < 3; ++c) {
      const float g = gp[f] ? B.g[f][3 * i + c] : 0.0f;
      // the merge's where(m, o, g): +0 to the rays outside the block
      G[f][c] = mk ? g : 0.0f;
      if (B.pass[f]) B.pass[f][3 * i + c] = mk ? 0.0f : g;
    }
  }
  const bool caps = B.K > 0, env = B.Hs > 0;

  // ---- the forward, in the plain block's order ----
  const int raw_slot = (B.packed[i] >> SLOT_SHIFT) & 0x3FF;
  const int slot = clip_slot(raw_slot, B.rows);
  float P[3], N[3], col[3];
  for (int c = 0; c < 3; ++c) {
    P[c] = B.P[3 * i + c];
    N[c] = B.N[3 * i + c];
    col[c] = B.color[3 * slot + c];
  }
  const float u = B.uv[2 * i], v = B.uv[2 * i + 1];
  for (int r = 0; r < B.refs; ++r)
    if (raw_slot == B.ref_slot[r]) fetch_texture(B.ref_tex, r, u, v, col);
  const float eps = B.eps[i];
  float o[3];
  for (int c = 0; c < 3; ++c) o[c] = P[c] + N[c] * eps;
  float u_mix = B.u_mix[i], u_phi = B.u_phi[i], u_r2 = B.u_r2[i];
  if (B.s_mix != nullptr && B.diffuse_refl[i] == 0) {
    u_mix = B.s_mix[i];
    u_phi = B.s_phi[i];
    u_r2 = B.s_r2[i];
  }
  const float w = caps || env ? B.ambient_w[slot] : 0.0f;
  const float seg = t_div_scalar(1.0f - w, (float)((caps ? 1 : 0) + (env ? 1 : 0)));
  // the cosine lobe about N
  Basis bn;
  basis(N, bn);
  float sn, cs;
  t_sincos(u_phi * TWO_PI_F, &sn, &cs);
  const float zc = sqrtf(1.0f - u_r2), rc = sqrtf(u_r2);
  const float xc = cs * rc, yc = sn * rc;
  float d[3];
  for (int c = 0; c < 3; ++c) d[c] = (bn.u[c] * xc + bn.v[c] * yc) + N[c] * zc;
  // the caps sample about the picked cap's axis
  int pick = 0;
  bool take_caps = false;
  Cap cp = {};
  Basis bc = {};
  float z = 0.0f, xs = 0.0f, cxs = 0.0f, sqs = 0.0f, s = 0.0f;
  if (caps) {
    pick = (int)B.pick[i];
    pick = pick < 0 ? 0 : (pick > B.K - 1 ? B.K - 1 : pick);
    cap(B, pick, o, cp);
    basis(cp.axw, bc);
    z = 1.0f + u_r2 * (cp.cm - 1.0f);
    xs = 1.0f - z * z;
    cxs = t_clamp_min(xs, F32(1e-30));
    sqs = sqrtf(cxs);
    s = xs > 0.0f ? sqs : 0.0f;
    take_caps = env ? (u_mix >= w && u_mix < w + seg) : !(u_mix < w);
    if (take_caps)
      for (int c = 0; c < 3; ++c)
        d[c] = (bc.u[c] * (cs * s) + bc.v[c] * (sn * s)) + cp.axw[c] * z;
  }
  // the environment's alias sample
  Env ev = {};
  bool take_env = false;
  if (env) {
    float de[3];
    env_dir(B, u_phi, u_r2, ev, de);
    take_env = u_mix >= 1.0f - seg;
    if (take_env)
      for (int c = 0; c < 3; ++c) d[c] = de[c];
  }
  // the pdf
  const float sdn = tsum3(d[0] * N[0], d[1] * N[1], d[2] * N[2]);
  const float cosv = t_div_scalar(t_clamp(sdn, 0.0f, 1.0f), PI_F);
  float capsv = 0.0f, envv = 0.0f, pdf;
  int cell = 0;
  if (caps) {
    auto term = [&](long long k) {
      Cap g;
      cap(B, (int)k, o, g);
      return cap_value(g, d);
    };
#ifdef W4_TORCH_CPU
    (void)S;
    capsv = t_div_scalar(cpu_sum(B.K, term), (float)B.K);
#else
    if constexpr (MODE == SUM_REG) {
      capsv = t_div_scalar(reg_sum(S, B.K, term), (float)B.K);
    } else if (S.ctas == 1) {
      capsv = t_div_scalar(aten_sum(S, i, B.K, term), (float)B.K);
    } else {
      BlockSums<decltype(term)> p{S, i, B.K, term};
      capsv = t_div_scalar(staged_sum(S, p), (float)B.K);
    }
#endif
  }
  if (env) {
    cell = env_cell(B, d);
    envv = B.env_pdf[cell];
  }
  if (env) {
    pdf = w * cosv;
    if (caps) pdf = pdf + seg * capsv;
    pdf = pdf + seg * envv;
  } else if (caps) {
    pdf = w * cosv + (1.0f - w) * capsv;
  } else {
    pdf = cosv;
  }
  const float sd = sum3(d, N);
  const float NdotL = t_clamp(sd, 0.0f, 1.0f);
  const float cpdf = t_clamp_min(pdf, F32(1e-9));
  const float wq = NdotL / cpdf;
  const float weight = wq / PI_F;

  // ---- the backward, node by node in the engine's order ----
  Acc3 Bd = {}, Bo = {}, LN = {};
  Acc wb = {}, segb = {}, pb = {};
  float t[3];
  if (gp[2]) put3(Bd, G[2]);
  if (gp[1]) put3(Bo, G[1]);
  float colb[3] = {0.0f, 0.0f, 0.0f};
  float pdf_b = 0.0f;
  if (gp[0]) {
    // beta_mult = colour * weight[..., None]
    for (int c = 0; c < 3; ++c) colb[c] = G[0][c] * weight;
    const float wub = tsum3(G[0][0] * col[0], G[0][1] * col[1], G[0][2] * col[2]);
    const float g151 = wub / PI_F;
    const float ndb = g151 / cpdf;
    pdf_b = ge_or_zero(pdf, F32(1e-9), div_other(g151, NdotL, cpdf));
    // NdotL = clamp(_sum3(d, N), 0, 1): the products last first, each
    // select's full row
    const float g148 = in_or_zero(sd, 0.0f, 1.0f, ndb);
    for (int c = 2; c >= 0; --c) {
      put_sel(LN, c, g148 * d[c]);
      put_sel(Bd, c, g148 * N[c]);
    }
  }
  // the pdf's terms, last first
  float cos_b = 0.0f;
  const bool pdf_grad = gp[0];
  if (pdf_grad && env) {
    put(segb, pdf_b * envv);
    if (B.pdf_rows) {
      B.pdf_rows[i] = pdf_b * seg;
      B.pdf_idx[i] = cell;
    }
  }
  float o_pdf[3] = {0.0f, 0.0f, 0.0f};
  if (pdf_grad && caps) {
    float capsb;
    if (env) {
      put(segb, pdf_b * capsv);
      capsb = pdf_b * seg;
    } else {
      capsb = pdf_b * (1.0f - w);
    }
    const float gK = t_div_scalar(capsb, (float)B.K);
    // every cap's value and geometry backward; the origin's shares summed
    // over K as the engine's sum_to adds them (none where K is 1)
    float* cenp = B.cen_pdf ? B.cen_pdf + 3 * (long long)B.K * i : nullptr;
    float* radp = B.rad_pdf ? B.rad_pdf + (long long)B.K * i : nullptr;
    auto term3 = [&](int k, float* ob) {
      Cap g;
      cap(B, k, o, g);
      const bool inside = tsum3(d[0] * g.axw[0], d[1] * g.axw[1], d[2] * g.axw[2]) > g.cm;
      const float r = 1.0f / (((1.0f - g.cm) * 2.0f) * PI_F);
      const float g115 = -((inside ? gK : 0.0f) * 1.0f) * (r * r);
      const float cmb = -((g115 * PI_F) * 2.0f);
      float rad, cen[3];
      cap_bwd(B, k, g, cmb, nullptr, &rad, cen, ob);
      if (radp) radp[k] = rad;
      if (cenp)
        for (int e = 0; e < 3; ++e) cenp[3 * k + e] = cen[e];
    };
    if (B.outer_rows) {
      float ob[3];
      for (int k = 0; k < B.K; ++k) {
        term3(k, ob);
        for (int e = 0; e < 3; ++e) B.opdf_rows[3 * ((long long)B.K * i + k) + e] = ob[e];
      }
    } else {
      outer_sum3(M, B.K, term3, o_pdf);
    }
    if (!env) put(wb, -(pdf_b * capsv));
  } else {
    if (B.rad_pdf)
      for (int k = 0; k < B.K; ++k) B.rad_pdf[(long long)B.K * i + k] = 0.0f;
    if (B.cen_pdf)
      for (int k = 0; k < 3 * B.K; ++k) B.cen_pdf[3 * (long long)B.K * i + k] = 0.0f;
  }
  if (pdf_grad) {
    if (caps || env) {
      put(wb, pdf_b * cosv);
      cos_b = pdf_b * w;
    } else {
      cos_b = pdf_b;
    }
    // cosine_pdf_value = clamp(torch.sum(d N, -1), 0, 1) / pi
    const float g65 = in_or_zero(sdn, 0.0f, 1.0f, t_div_scalar(cos_b, PI_F));
    for (int c = 0; c < 3; ++c) t[c] = g65 * N[c];
    put3(Bd, t);
    for (int c = 0; c < 3; ++c) t[c] = g65 * d[c];
    put3(LN, t);
  }

  // the direction's wheres, last first
  float gcos[3], gcap[3], genv[3];
  for (int c = 0; c < 3; ++c) {
    float rest = Bd.v[c];
    genv[c] = env && take_env ? rest : 0.0f;
    if (env) rest = take_env ? 0.0f : rest;
    gcap[c] = caps && take_caps ? rest : 0.0f;
    if (caps) rest = take_caps ? 0.0f : rest;
    gcos[c] = rest;
  }
  const bool dir_grad = Bd.has;
  if (dir_grad && env) {
    // d_env = stack(rho cos(phi), sy, rho sin(phi))
    Acc rhob = {}, syb = {};
    put(syb, genv[1]);
    put(rhob, genv[2] * ev.se);
    put(rhob, genv[0] * ev.ce);
    const float g80 = ev.x > 0.0f ? rhob.v : 0.0f;
    const float g77 = -ge_or_zero(ev.x, F32(1e-30), sqrt_bwd(g80, ev.cx, ev.sx));
    put(syb, g77 * ev.sy);
    put(syb, g77 * ev.sy);
    // sy = s0 + jv (s1 - s0); jv = where(take, u2 / cp, (u2 - p) / cq)
    const float jvb = syb.v * (ev.s1 - ev.s0);
    const float ga = ev.take ? jvb : 0.0f, gb = ev.take ? 0.0f : jvb;
    const float num = u_r2 - ev.p;
    const float g71 = ge_or_zero(1.0f - ev.p, F32(1e-12), div_other(gb, num, ev.cq));
    put(pb, -g71);
    put(pb, -(gb / ev.cq));
    put(pb, ge_or_zero(ev.p, F32(1e-12), div_other(ga, u_r2, ev.cp)));
  }
  if (B.prob_rows) {
    B.prob_rows[i] = got(pb);
    B.prob_idx[i] = ev.k;
  }
  float o_smp[3] = {0.0f, 0.0f, 0.0f};
  const bool smp = dir_grad && caps;
  if (smp) {
    // d_caps = (ax_u (cos s) + ax_v (sin s)) + ax_w z about the picked cap
    Acc3 axb = {}, vb = {};
    Acc zb = {}, sb = {};
    for (int c = 0; c < 3; ++c) t[c] = gcap[c] * z;
    put3(axb, t);
    put(zb, tsum3(gcap[0] * cp.axw[0], gcap[1] * cp.axw[1], gcap[2] * cp.axw[2]));
    const float SB = sn * s, CA = cs * s;
    for (int c = 0; c < 3; ++c) t[c] = gcap[c] * SB;
    put3(vb, t);
    put(sb, tsum3(gcap[0] * bc.v[0], gcap[1] * bc.v[1], gcap[2] * bc.v[2]) * sn);
    float ub[3];
    for (int c = 0; c < 3; ++c) ub[c] = gcap[c] * CA;
    put(sb, tsum3(gcap[0] * bc.u[0], gcap[1] * bc.u[1], gcap[2] * bc.u[2]) * cs);
    // s = safe_sqrt(1 - z z), z = 1 + r2 (cos_max - 1)
    const float g51 = xs > 0.0f ? sb.v : 0.0f;
    const float g48 = -ge_or_zero(xs, F32(1e-30), sqrt_bwd(g51, cxs, sqs));
    put(zb, g48 * z);
    put(zb, g48 * z);
    const float cmsel = zb.v * u_r2;
    basis_bwd(cp.axw, bc, vb, ub, axb);
    // the gathers' 0 + g at the pick; every cap's geometry backward
    float* cens = B.cen_smp ? B.cen_smp + 3 * (long long)B.K * i : nullptr;
    float* rads = B.rad_smp ? B.rad_smp + (long long)B.K * i : nullptr;
    auto term3 = [&](int k, float* ob) {
      Cap g;
      cap(B, k, o, g);
      const bool at = k == pick;
      float ab[3];
      for (int e = 0; e < 3; ++e) ab[e] = at ? 0.0f + axb.v[e] : 0.0f;
      float rad, cen[3];
      cap_bwd(B, k, g, at ? 0.0f + cmsel : 0.0f, ab, &rad, cen, ob);
      if (rads) rads[k] = rad;
      if (cens)
        for (int e = 0; e < 3; ++e) cens[3 * k + e] = cen[e];
    };
    if (B.outer_rows) {
      float ob[3];
      for (int k = 0; k < B.K; ++k) {
        term3(k, ob);
        for (int e = 0; e < 3; ++e) B.osmp_rows[3 * ((long long)B.K * i + k) + e] = ob[e];
      }
    } else {
      outer_sum3(M, B.K, term3, o_smp);
    }
  } else {
    if (B.rad_smp)
      for (int k = 0; k < B.K; ++k) B.rad_smp[(long long)B.K * i + k] = 0.0f;
    if (B.cen_smp)
      for (int k = 0; k < 3 * B.K; ++k) B.cen_smp[3 * (long long)B.K * i + k] = 0.0f;
  }
  if (dir_grad) {
    // d_cos = (ax_u x + ax_v y) + N z about N
    for (int c = 0; c < 3; ++c) t[c] = gcos[c] * zc;
    put3(LN, t);
    Acc3 vb = {};
    for (int c = 0; c < 3; ++c) t[c] = gcos[c] * yc;
    put3(vb, t);
    float ub[3];
    for (int c = 0; c < 3; ++c) ub[c] = gcos[c] * xc;
    basis_bwd(N, bn, vb, ub, LN);
  }
  // seg = (1 - w) / components
  if (segb.has) put(wb, -t_div_scalar(segb.v, (float)((caps ? 1 : 0) + (env ? 1 : 0))));
  if (B.w_rows) B.w_rows[i] = got(wb);
  // nudged = P + N eps: its buffer (new_origin's, the caps pdf's share, the
  // sample's)
  if (!B.outer_rows) {
    if (pdf_grad && caps) put3(Bo, o_pdf);
    if (smp) put3(Bo, o_smp);
    if (Bo.has) {
      for (int c = 0; c < 3; ++c) t[c] = Bo.v[c] * eps;
      put3(LN, t);
    }
    for (int c = 0; c < 3; ++c)
      if (B.dP) B.dP[3 * i + c] = got(Bo, c);
    if (B.deps)
      B.deps[i] = Bo.has ? tsum3(Bo.v[0] * N[0], Bo.v[1] * N[1], Bo.v[2] * N[2]) : 0.0f;
  }
  for (int c = 0; c < 3; ++c)
    if (B.dN) B.dN[3 * i + c] = got(LN, c);
  // the colour: `_slot_color`'s wheres, last ref first; each bilinear
  // ref's fetch hands uv its two selects' full rows, v's then u's
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

template <int MODE>
__global__ void __launch_bounds__(DIFF_BWD_BLOCK)
shade_diffuse_bwd_kernel(DiffBwd B, SumPlan S, SumPlan M) {
  const long long stride = (long long)gridDim.x * DIFF_BWD_BLOCK;
  for (long long i = (long long)blockIdx.x * DIFF_BWD_BLOCK + threadIdx.x; i < B.n;
       i += stride)
    diff_bwd_ray<MODE>(B, S, M, i);
}

// The card's SMs and the kernel's resident blocks an SM.
template <class F>
cudaError_t residency(F kernel, int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, DIFF_BWD_BLOCK, 0);
  return err;
}

bool bwd_ok(const DiffBwd& B) {
  bool any = false;
  for (int f = 0; f < 3; ++f) {
    if (B.pass[f] && !B.g[f]) return false;
    any = any || B.g[f];
  }
  const bool gb = B.g[0], go = B.g[1], gd = B.g[2];
  const bool caps = B.K > 0, env = B.Hs > 0;
  // each wanted gradient has an output gradient that reaches it
  return B.n >= 1 && B.n <= 0x7FFFFFFFLL && any && B.packed && B.m && B.P && B.N
         && B.eps && B.uv && B.diffuse_refl && B.u_mix && B.u_phi && B.u_r2 && B.color
         && B.rows >= 1 && B.K >= 0 && (!caps || (B.pick && B.is_center && B.is_radius))
         && (!(caps || env) || B.ambient_w)
         && (!env || (B.Ws >= 1 && B.env_prob && B.env_alias && B.env_pdf))
         && (B.refs == 0 || (B.ref_slot && B.ref_tex.texels && B.ref_tex.desc_i
                             && B.ref_tex.desc_f))
         && (!B.dP || go || ((gb || gd) && caps)) && (!B.deps || go || ((gb || gd) && caps))
         && (!B.dN || gb || go || gd) && (!B.duv || gb) && (!B.color_rows || gb)
         && (!B.taps.rows || (gb && B.refs >= 1 && B.taps.idx))
         && (!B.w_rows || (gb && (caps || env)))
         && (!B.prob_rows || (env && (gb || gd) && B.prob_idx))
         && (!B.pdf_rows || (env && gb && B.pdf_idx))
         && (!(B.cen_pdf || B.rad_pdf) || (caps && gb))
         && (!(B.cen_smp || B.rad_smp) || (caps && (gb || gd)))
         && (!B.outer_rows || (caps && (gb || gd) && B.osmp_rows && (!gb || B.opdf_rows)
                               && !B.dP && !B.deps));
}

}  // namespace w4d

using namespace w4d;

// The diffuse block's backward on the bounce B (ops/wavefront_shade.py
// builds it), one launch.  Returns 0 or a CUDA error, and sets *launched
// to the kernels launched.
extern "C" int shade_diffuse_bwd(const DiffBwd* B, void* stream, int* launched) {
  *launched = 0;
  if (!bwd_ok(*B)) return (int)cudaErrorInvalidValue;
  SumPlan S = {1, 1, 1, 1, nullptr}, M = {1, 1, 1, 1, nullptr};
  bool wide = false;
  cudaError_t err = cudaSuccess;
#ifndef W4_TORCH_CPU
  if (B->K > 0) {
    // the caps pdf's torch.sum over the n rays' K terms, as the forward
    // adds it; the engine's sum_to over K of the geometry's (n, K, 3)
    err = sum_plan(B->K, B->n, &S);
    if (err == cudaSuccess && !B->outer_rows) err = outer_plan(B->K, B->n, &M);
    if (err != cudaSuccess) return (int)err;
    wide = !in_registers(S);
  }
#endif
  int sms = 0, per_sm = 0;
  err = wide ? residency(shade_diffuse_bwd_kernel<SUM_WIDE>, &sms, &per_sm)
             : residency(shade_diffuse_bwd_kernel<SUM_REG>, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long need = (B->n + DIFF_BWD_BLOCK - 1) / DIFF_BWD_BLOCK;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < most ? need : most);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) LAUNCH(shade_diffuse_bwd_kernel<SUM_WIDE>, grid, DIFF_BWD_BLOCK, 0, st, *B, S, M);
  else LAUNCH(shade_diffuse_bwd_kernel<SUM_REG>, grid, DIFF_BWD_BLOCK, 0, st, *B, S, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// Whether the engine's sum_to over K of an (n, K, 3) gradient splits each
// output across blocks (`outer_plan` refuses it) on the card: the wrapper
// then takes the origin's shares as rows (`outer_rows`).  Never on the CPU.
extern "C" int shade_diffuse_bwd_outer(long long K, long long n, int* rows) {
  *rows = 0;
#ifndef W4_TORCH_CPU
  SumPlan M;
  *rows = K > 1 && n > 0 && outer_plan(K, n, &M) != cudaSuccess;
#else
  (void)K, (void)n;
#endif
  return 0;
}

// What the kernel was built to (variant 0: the caps pdf's sum in
// registers, 1: by the general plan): out[0] registers a thread, out[1]
// local memory a thread (bytes: spills and stack), out[2] resident blocks
// an SM, out[3] the SMs, out[4] threads a block, out[5] the
// __launch_bounds__ minimum of blocks an SM, out[6] rays a block a pass.
extern "C" int shade_diffuse_bwd_info(int variant, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = variant ? cudaFuncGetAttributes(&attr, shade_diffuse_bwd_kernel<SUM_WIDE>)
                            : cudaFuncGetAttributes(&attr, shade_diffuse_bwd_kernel<SUM_REG>);
  if (err == cudaSuccess)
    err = variant ? residency(shade_diffuse_bwd_kernel<SUM_WIDE>, &out[3], &out[2])
                  : residency(shade_diffuse_bwd_kernel<SUM_REG>, &out[3], &out[2]);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[4] = DIFF_BWD_BLOCK;
  out[5] = 1;
  out[6] = DIFF_BWD_BLOCK;
  return 0;
}
