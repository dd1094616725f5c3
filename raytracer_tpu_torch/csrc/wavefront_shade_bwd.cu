// W4's refractive backward for Hopper (sm_90a).
//
// The vector-Jacobian product of the refractive shading block (materials/
// shade.py `shade_refractive`; raytracer_tpu/materials/shade.py:385 in the
// JAX package, whose gradient jax.grad takes through XLA's fused loops) as
// `_Shade`'s backward takes it (ops/wavefront_shade.py `refractive_vjp`):
// the gradients of the block's ray inputs (D, the medium, t, P, N, eps)
// and the per-ray rows that its tables' gathers and broadcasts hand their
// backward, from the gradients of the merged output's five fields the
// block writes (beta_mult, new_origin, new_dir, new_n_re, new_n_im), and
// those fields' pass-through gradients (the merge's where(m, 0, g)), in
// one launch.  Its plain version is ops/plain_grad.py `plain_vjp` of the
// plain block merged under the mask, which it equals bit for bit.
//
// One thread a ray, over every ray of the bounce: the plain VJP hands the
// rays outside the block's mask +0 output gradients (the merge's where),
// and those zeros still pass through the block's backward, where they come
// out as +0, -0 or NaN.  Each ray's forward is recomputed in the plain
// block's order (as csrc/wavefront_shade.cu's refractive entry
// computes it), then its backward runs node by node in the order
// autograd's engine runs the plain block's graph: the node created last
// first (the graph's sequence numbers; chip_smoke.py and the CPU tests
// hold the order).  Each node restates ATen's derivative formula:
// - mul: a takes g * b, b takes g * a; add passes g on; sub hands its
//   second operand -g; rsub (1 - x) and neg hand -g;
// - div: the numerator takes g / d, the divisor -g * ((a / d) / d);
//   a division by 2.0 or 3.0 (core/safemath.py `div`, a tensor) is a true
//   division, the product with a Python number a product;
// - sqrt: g / (2 r); exp: g * r; pow(x, 2): g * (2 x);
// - clamp_min(x, lo): g where x >= lo, else +0; clamp(x, 0, 1): g where
//   0 <= x <= 1; where(c, a, b): g to the branch taken, +0 to the other;
// - a select (x[..., k]) hands its tensor a full row of +0 pads around g;
//   gather's backward adds g to a zero row (0 + g) at the gathered channel;
// - a broadcast (N, 1) factor takes torch.sum of its (N, 3) gradient over
//   the channels (`tsum3`, ATen's order).
// A tensor that feeds several nodes takes their gradients in the order the
// engine runs them, the first stored as it is (not added to 0: -0 stays
// -0): a buffer here keeps whether it holds a gradient yet (csrc/
// grad_acc.cuh).
// A node no present output gradient reaches is not run, so a buffer it
// would add to takes nothing from it.  The table gradients are reductions
// in autograd's own order: the gathered tables' per-ray rows go to
// core/safemath.py `take_backward`, the scene medium's to torch.sum over
// the rays (the engine's sum_to), both in the wrapper.
//
// Layout (redesigned for the H100): the rays in tiles of BWD_TILE, a
// thread a ray; each tile's (N, 3) rows are read into shared memory element
// by element (neighbouring threads on neighbouring floats, whole sectors a
// warp; the output gradients masked there, their pass-through gradients
// written in the same pass), each thread then runs its ray, and the tile's
// (N, 3) gradients go out element by element the same way.  A ray's inputs
// stay in the tile and are read where they are needed, its (N, 3) buffers
// accumulate in the tile's rows (their flags bits of one word, a flag a
// channel: grad_acc.cuh `put_ch`), and each channel's Fresnel chain runs in a
// loop that indexes only shared memory and global tables, so that nothing
// is indexed at run time in registers: the kernel has no stack.
//
// What bounds it: the FP32 issue slots of a ray's ~2,700 FP32 instructions
// off the SASS (three Fresnel chains forward twice and backward once, IEEE
// divisions and square roots) against the ~190 bytes a ray moves
// (chip_smoke.py --backward counts both).  The design keeps the registers
// low enough for REFR_BWD_MIN_BLOCKS blocks an SM, which hide the chains'
// latency.
//
// Arithmetic: one rounding an op (built with --fmad=false, IEEE division
// and square root).  Built by the CPU tests with W4_TORCH_CPU (tests/
// test_torch_wavefront_shade_bwd_emu.py), the source restates the CPU's
// torch instead (csrc/torch_math.cuh, csrc/grad_acc.cuh): the sum of three
// in its order, x86's clamp of a NaN or a tie of zeros, and sqrt and exp
// (and their backward) through float64, as those tests run the plain block
// (`exact_math`).
//
// The entry returns cudaGetLastError() after its launch and reports the
// kernels it launched.

#include <cuda_runtime.h>

#include <math.h>

#include "grad_acc.cuh"
#include "torch_math.cuh"

#ifndef CUDA_EMU
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace w4b {

// the __launch_bounds__ minimum of resident blocks an SM: the most that
// builds with no spills (ptxas -v)
constexpr int REFR_BWD_MIN_BLOCKS = 7;

using namespace grad_acc;
using namespace torch_math;

constexpr int BWD_TILE = 128;         // rays a tile, threads a block
constexpr int ROW = 3 * BWD_TILE;     // floats of a tile's (N, 3) row
constexpr int SLOT_SHIFT = 3, DEPTH_SHIFT = 13, MC_SHIFT = 23;

// ---------------------------------------------------------------------------
// the launch's arguments
// ---------------------------------------------------------------------------

// The forward's inputs ((N, 3) float32 rows unless said), the output
// gradients (null: none comes), the pass-through gradients and the
// inputs' gradients to write (null: not wanted or not reached).
struct RefrBwd {
  const int* packed;          // (N,) the packed material word
  const unsigned char* m;     // (N,) bool: the block's rays
  const float* P;
  const float* N;
  const float* D;
  const float* eps;           // (N,)
  const float* t;             // (N,)
  const float* orient;        // (N,)
  const float* n_re;          // the medium, rows re_step floats apart
  const float* n_im;
  long long re_step;          // 3, or 0 for one medium shared by every ray
  long long im_step;
  const int* depth;           // (N,) int32
  const int* pattern;         // (N,) int32 split patterns (split_k > 0)
  const int* split_cnt;       // (N,) int32
  const float* u;             // (N,) the branch draw
  const long long* hero;      // (N,) int64 hero channel, or null: no dispersion
  const float* m_re;          // (S, 3) refr_n_re
  const float* m_im;          // (S, 3) refr_n_im
  const float* dispersive;    // (S,) refr_dispersive, or null
  int rows;
  int split_k;
  const float* scene_re;      // (3,)
  const float* scene_im;
  float k[3];                 // 2 pi / lambda, as the plain block computes it
  long long n;
  // the gradients of beta_mult, new_origin, new_dir, new_n_re, new_n_im
  const float* g[5];
  // their pass-through gradients, where(m, 0, g)
  float* pass[5];
  // the inputs' gradients
  float* dD;
  float* dn_re;
  float* dn_im;
  float* dt;                  // (N,)
  float* dP;
  float* dN;
  float* deps;                // (N,)
  // the per-ray rows of the gathered tables' and the scene medium's
  // gradients: where(entering, g, 0) and where(entering, 0, g)
  float* m_re_rows;
  float* m_im_rows;
  float* s_re_rows;
  float* s_im_rows;
};

// The tile's rows in shared memory: the inputs (P is not read: its
// gradient is new_origin's alone; a medium every ray shares copied into
// each ray's row) and the five output gradients, masked; the ray's n2 (its
// table's or the scene's medium); the ray's (N, 3) buffers; F of each
// channel, F's buffer and the Fresnel chains' last two products.  A slot whose input is read serves again:
// new_origin's gradient's slot takes P's gradient, and during the Fresnel
// chains the other four output gradients' slots take their products that
// cos_i sums (nodes 92, 91, 62, 61), then the tables' rows.
enum Slot {
  S_N, S_D, S_RE, S_IM, S_G0,
  S_N2R = S_G0 + 5, S_N2I,
  S_LN, S_LD, S_LRE, S_LIM, S_B4, S_B6,
  S_F, S_BF, S_P42, S_P39, NSLOT
};
constexpr int S_DP = S_G0 + 1, S_P92 = S_G0, S_P91 = S_G0 + 2, S_P62 = S_G0 + 3,
              S_P61 = S_G0 + 4, S_MRE = S_G0, S_MIM = S_G0 + 2, S_SRE = S_G0 + 3,
              S_SIM = S_G0 + 4;

// The flags of the ray's buffers that take a row a channel at a time, three
// bits each (grad_acc.cuh `put_ch`): one word, `fl`.
enum : unsigned {
  F_LN = 1u, F_LD = 1u << 3, F_LRE = 1u << 6, F_LIM = 1u << 9, F_B4 = 1u << 12,
  F_B6 = 1u << 15, F_BF = 1u << 18, F_BT = 1u << 21, F_RC = 1u << 24
};
// and of the buffers of one section, `fs`: the reflection's and the
// refraction's direction, V
enum : unsigned { F_B173 = 1u, F_B141 = 1u << 3, F_VB = 1u << 6 };

// ---------------------------------------------------------------------------
// the Fresnel terms of one channel (materials/shade.py :385-399)
// ---------------------------------------------------------------------------

// Each value of one channel's Fresnel chain, named by the plain block's
// operations (x<k> the operand of node k of its graph, in creation order):
// its first half, the ratio n1 / n2 and cos_t, and its second, the two
// reflectances from cos_t.
struct FresnelT {
  float d1, s25, re, s29, im;                     // ratio = n1 / n2
  float r2re, r2im, x41, A0, A1;                  // r2, the root's argument
  float x45, c46, sq47, mag, x50, c51, sq52, ctre, x55, c56, sq57, ctim;
};
struct FresnelR {
  float pa0, pa1, pb0, pb1, s75, d2, s79, rpre, s83, rpim;    // r_per
  float atre, atim, qa0, qa1, qb0, qb1, s99, d3, s103, rqre, s107, rqim;  // r_par
  float F;
};

__device__ __forceinline__ void fresnel_t(float n1re, float n1im, float n2r, float n2i,
                                          float s2, FresnelT& f) {
  // ratio = _c_div(n1, n2)
  f.d1 = t_clamp_min(n2r * n2r + n2i * n2i, F32(1e-30));
  f.s25 = n1re * n2r + n1im * n2i;
  f.re = f.s25 / f.d1;
  f.s29 = n1im * n2r - n1re * n2i;
  f.im = f.s29 / f.d1;
  // r2 = _c_mul(ratio, ratio); cos_t = _c_sqrt((1 - r2re s2, -r2im s2))
  f.r2re = f.re * f.re - f.im * f.im;
  f.r2im = f.re * f.im + f.im * f.re;
  f.A0 = 1.0f - f.r2re * s2;
  f.x41 = -f.r2im;
  f.A1 = f.x41 * s2;
  f.x45 = f.A0 * f.A0 + f.A1 * f.A1;
  f.c46 = t_clamp_min(f.x45, F32(1e-30));
  f.sq47 = t_sqrt(f.c46);
  f.mag = f.x45 > 0.0f ? f.sq47 : 0.0f;
  f.x50 = (f.mag + f.A0) * 0.5f;
  f.c51 = t_clamp_min(f.x50, F32(1e-30));
  f.sq52 = t_sqrt(f.c51);
  f.ctre = f.x50 > 0.0f ? f.sq52 : 0.0f;
  f.x55 = (f.mag - f.A0) * 0.5f;
  f.c56 = t_clamp_min(f.x55, F32(1e-30));
  f.sq57 = t_sqrt(f.c56);
  const float im58 = f.x55 > 0.0f ? f.sq57 : 0.0f;
  f.ctim = f.A1 < 0.0f ? -im58 : im58;
}

__device__ __forceinline__ void fresnel_r(float n1re, float n1im, float n2r, float n2i,
                                          float cos_i, float ctre, float ctim, FresnelR& f) {
  // r_per = _c_div(a - bt, a + bt), a = n1 cos_i, bt = _c_mul(n2, cos_t)
  const float a0 = n1re * cos_i, a1 = n1im * cos_i;
  const float btre = n2r * ctre - n2i * ctim;
  const float btim = n2r * ctim + n2i * ctre;
  f.pa0 = a0 - btre;
  f.pa1 = a1 - btim;
  f.pb0 = a0 + btre;
  f.pb1 = a1 + btim;
  f.s75 = f.pb0 * f.pb0 + f.pb1 * f.pb1;
  f.d2 = t_clamp_min(f.s75, F32(1e-30));
  f.s79 = f.pa0 * f.pb0 + f.pa1 * f.pb1;
  f.rpre = f.s79 / f.d2;
  f.s83 = f.pa1 * f.pb0 - f.pa0 * f.pb1;
  f.rpim = f.s83 / f.d2;
  // r_par = _c_div(bb - at, at + bb), at = _c_mul(n1, cos_t), bb = n2 cos_i
  f.atre = n1re * ctre - n1im * ctim;
  f.atim = n1re * ctim + n1im * ctre;
  const float bb0 = n2r * cos_i, bb1 = n2i * cos_i;
  f.qa0 = bb0 - f.atre;
  f.qa1 = bb1 - f.atim;
  f.qb0 = f.atre + bb0;
  f.qb1 = f.atim + bb1;
  f.s99 = f.qb0 * f.qb0 + f.qb1 * f.qb1;
  f.d3 = t_clamp_min(f.s99, F32(1e-30));
  f.s103 = f.qa0 * f.qb0 + f.qa1 * f.qb1;
  f.rqre = f.s103 / f.d3;
  f.s107 = f.qa1 * f.qb0 - f.qa0 * f.qb1;
  f.rqim = f.s107 / f.d3;
  f.F = ((f.rpre * f.rpre + f.rpim * f.rpim) + (f.rqre * f.rqre + f.rqim * f.rqim)) / 2.0f;
}

// The buffers one channel's Fresnel backward adds to, rows of the tile: the
// medium's leaves, n2's two wheres (nodes 4 and 6), and its channel's
// products that cos_i and s2 take as torch.sums over the channels (nodes
// 92, 91, 62, 61; 42, 39), each indexed by the channel.
struct Outer {
  float *nre, *nim, *b4, *b6;
  float *p92, *p91, *p62, *p61, *p42, *p39;
};

// F's gradient gF of channel c back through the reflectances, nodes 116 to
// 60 in the engine's order: into the outer buffers and cos_t's gradient
// (ctreb, ctimb).
__device__ __forceinline__ void fresnel_bwd_r(float n1re, float n1im, float n2r, float n2i,
                                              float cos_i, float ctre, float ctim,
                                              const FresnelR& f, float gF, int c,
                                              const Outer& o, unsigned& fl, float* ctreb_out,
                                              float* ctimb_out) {
  const float g115 = gF / 2.0f;
  // |r_par|^2 and |r_per|^2: each square hands its operand g x twice
  const float b108 = g115 * f.rqim + g115 * f.rqim;
  const float b104 = g115 * f.rqre + g115 * f.rqre;
  const float b84 = g115 * f.rpim + g115 * f.rpim;
  const float b80 = g115 * f.rpre + g115 * f.rpre;
  // r_par = (s103 / d3, s107 / d3)
  const float g107 = b108 / f.d3;
  float d3b = -b108 * ((f.s107 / f.d3) / f.d3);
  const float g106 = -g107;
  float qa0b = g106 * f.qb1, qb1b = g106 * f.qa0;
  float qa1b = g107 * f.qb0, qb0b = g107 * f.qa1;
  const float g103 = b104 / f.d3;
  d3b = d3b + -b104 * ((f.s103 / f.d3) / f.d3);
  qa1b = qa1b + g103 * f.qb1;
  qb1b = qb1b + g103 * f.qa1;
  qa0b = qa0b + g103 * f.qb0;
  qb0b = qb0b + g103 * f.qa0;
  const float g99 = ge_or_zero(f.s99, F32(1e-30), d3b);
  qb1b = qb1b + g99 * f.qb1;
  qb1b = qb1b + g99 * f.qb1;
  qb0b = qb0b + g99 * f.qb0;
  qb0b = qb0b + g99 * f.qb0;
  // qb = (at + bb), qa = (bb - at)
  float atimb = qb1b, bb1b = qb1b, atreb = qb0b, bb0b = qb0b;
  bb1b = bb1b + qa1b;
  atimb = atimb + -qa1b;
  bb0b = bb0b + qa0b;
  atreb = atreb + -qa0b;
  // bb = n2 cos_i
  put_ch(o.b6, fl, F_B6, c, bb1b * cos_i);
  o.p92[c] = bb1b * n2i;
  put_ch(o.b4, fl, F_B4, c, bb0b * cos_i);
  o.p91[c] = bb0b * n2r;
  // at = _c_mul(n1, cos_t)
  float ctreb, ctimb;
  put_ch(o.nim, fl, F_LIM, c, atimb * ctre);
  ctreb = atimb * n1im;
  put_ch(o.nre, fl, F_LRE, c, atimb * ctim);
  ctimb = atimb * n1re;
  const float g86 = -atreb;
  put_ch(o.nim, fl, F_LIM, c, g86 * ctim);
  ctimb = ctimb + g86 * n1im;
  put_ch(o.nre, fl, F_LRE, c, atreb * ctre);
  ctreb = ctreb + atreb * n1re;
  // r_per = (s79 / d2, s83 / d2)
  const float g83 = b84 / f.d2;
  float d2b = -b84 * ((f.s83 / f.d2) / f.d2);
  const float g82 = -g83;
  float pa0b = g82 * f.pb1, pb1b = g82 * f.pa0;
  float pa1b = g83 * f.pb0, pb0b = g83 * f.pa1;
  const float g79 = b80 / f.d2;
  d2b = d2b + -b80 * ((f.s79 / f.d2) / f.d2);
  pa1b = pa1b + g79 * f.pb1;
  pb1b = pb1b + g79 * f.pa1;
  pa0b = pa0b + g79 * f.pb0;
  pb0b = pb0b + g79 * f.pa0;
  const float g75 = ge_or_zero(f.s75, F32(1e-30), d2b);
  pb1b = pb1b + g75 * f.pb1;
  pb1b = pb1b + g75 * f.pb1;
  pb0b = pb0b + g75 * f.pb0;
  pb0b = pb0b + g75 * f.pb0;
  // pb = a + bt, pa = a - bt
  float a1b = pb1b, btimb = pb1b, a0b = pb0b, btreb = pb0b;
  a1b = a1b + pa1b;
  btimb = btimb + -pa1b;
  a0b = a0b + pa0b;
  btreb = btreb + -pa0b;
  // bt = _c_mul(n2, cos_t)
  put_ch(o.b6, fl, F_B6, c, btimb * ctre);
  ctreb = ctreb + btimb * n2i;
  put_ch(o.b4, fl, F_B4, c, btimb * ctim);
  ctimb = ctimb + btimb * n2r;
  const float g64 = -btreb;
  put_ch(o.b6, fl, F_B6, c, g64 * ctim);
  ctimb = ctimb + g64 * n2i;
  put_ch(o.b4, fl, F_B4, c, btreb * ctre);
  ctreb = ctreb + btreb * n2r;
  // a = n1 cos_i
  put_ch(o.nim, fl, F_LIM, c, a1b * cos_i);
  o.p62[c] = a1b * n1im;
  put_ch(o.nre, fl, F_LRE, c, a0b * cos_i);
  o.p61[c] = a0b * n1re;
  *ctreb_out = ctreb;
  *ctimb_out = ctimb;
}

// cos_t's gradient (ctreb, ctimb) of channel c back through the root and the
// ratio, nodes 59 to 19 in the engine's order.
__device__ __forceinline__ void fresnel_bwd_t(float n1re, float n1im, float n2r, float n2i,
                                              float s2, const FresnelT& f, float ctreb,
                                              float ctimb, int c, const Outer& o,
                                              unsigned& fl) {
  // cos_t = _c_sqrt(A): im's sign where A1 < 0, then the three safe_sqrts
  const bool neg = f.A1 < 0.0f;
  const float g59 = neg ? ctimb : 0.0f;
  float im58b = neg ? 0.0f : ctimb;
  im58b = im58b + -g59;
  const float g57 = f.x55 > 0.0f ? im58b : 0.0f;
  const float g56 = sqrt_bwd(g57, f.c56, f.sq57);
  const float g54 = ge_or_zero(f.x55, F32(1e-30), g56) * 0.5f;
  float magb = g54, A0b = -g54;
  const float g52 = f.x50 > 0.0f ? ctreb : 0.0f;
  const float g51 = sqrt_bwd(g52, f.c51, f.sq52);
  const float g49 = ge_or_zero(f.x50, F32(1e-30), g51) * 0.5f;
  magb = magb + g49;
  A0b = A0b + g49;
  const float g47 = f.x45 > 0.0f ? magb : 0.0f;
  const float g46 = sqrt_bwd(g47, f.c46, f.sq47);
  const float g45 = ge_or_zero(f.x45, F32(1e-30), g46);
  const float A1b = g45 * f.A1 + g45 * f.A1;
  A0b = A0b + g45 * f.A0;
  A0b = A0b + g45 * f.A0;
  // A1 = (-r2im) s2, A0 = 1 - r2re s2
  const float x41b = A1b * s2;
  o.p42[c] = A1b * f.x41;
  const float r2imb = -x41b;
  const float x39b = -A0b;
  const float r2reb = x39b * s2;
  o.p39[c] = x39b * f.r2re;
  // r2 = _c_mul(ratio, ratio)
  float imb = r2imb * f.re, reb = r2imb * f.im;
  reb = reb + r2imb * f.im;
  imb = imb + r2imb * f.re;
  const float g32 = -r2reb;
  imb = imb + g32 * f.im;
  imb = imb + g32 * f.im;
  reb = reb + r2reb * f.re;
  reb = reb + r2reb * f.re;
  // ratio = _c_div(n1, n2): (s25 / d1, s29 / d1)
  const float g29 = imb / f.d1;
  float d1b = -imb * ((f.s29 / f.d1) / f.d1);
  const float g28 = -g29;
  put_ch(o.nre, fl, F_LRE, c, g28 * n2i);
  put_ch(o.b6, fl, F_B6, c, g28 * n1re);
  put_ch(o.nim, fl, F_LIM, c, g29 * n2r);
  put_ch(o.b4, fl, F_B4, c, g29 * n1im);
  const float g25 = reb / f.d1;
  d1b = d1b + -reb * ((f.s25 / f.d1) / f.d1);
  put_ch(o.nim, fl, F_LIM, c, g25 * n2i);
  put_ch(o.b6, fl, F_B6, c, g25 * n1im);
  put_ch(o.nre, fl, F_LRE, c, g25 * n2r);
  put_ch(o.b4, fl, F_B4, c, g25 * n1re);
  const float g21 = ge_or_zero(n2r * n2r + n2i * n2i, F32(1e-30), d1b);
  put_ch(o.b6, fl, F_B6, c, g21 * n2i);
  put_ch(o.b6, fl, F_B6, c, g21 * n2i);
  put_ch(o.b4, fl, F_B4, c, g21 * n2r);
  put_ch(o.b4, fl, F_B4, c, g21 * n2r);
}

// a load from the tile the compiler may not take from an earlier one: the
// Fresnel chain's inputs read again for its first half's second run, so
// that the first run's values need not stay in registers across the
// reflectances' backward
__device__ __forceinline__ float reload(const float* p) {
  return *(const volatile float*)p;
}

// ---------------------------------------------------------------------------
// one ray
// ---------------------------------------------------------------------------

__device__ __forceinline__ void refr_bwd_ray(const RefrBwd& B, long long i, int tt,
                                             float (*sh)[ROW]) {
  // the ray's rows of the tile
  const int e0 = 3 * tt;
  const float* const N = sh[S_N] + e0;
  const float* const D = sh[S_D] + e0;
  const float* const RE = sh[S_RE] + e0;       // the medium n
  const float* const IM = sh[S_IM] + e0;
  float* const N2R = sh[S_N2R] + e0;            // n2, the medium past the surface
  float* const N2I = sh[S_N2I] + e0;
  const float* const G0 = sh[S_G0] + e0;     // beta_mult's gradient, masked
  const float* const G2 = sh[S_G0 + 2] + e0; // new_dir's
  float* const LN = sh[S_LN] + e0;
  float* const LD = sh[S_LD] + e0;
  float* const Fc = sh[S_F] + e0;
  float* const BF = sh[S_BF] + e0;
  const bool gp0 = B.g[0] != nullptr, gp1 = B.g[1] != nullptr, gp2 = B.g[2] != nullptr,
             gp3 = B.g[3] != nullptr, gp4 = B.g[4] != nullptr;

  // ---- the forward, in the plain block's order ----
  const int packed = B.packed[i];
  int slot = (packed >> SLOT_SHIFT) & 0x3FF;
  slot = slot < 0 ? 0 : (slot > B.rows - 1 ? B.rows - 1 : slot);
  const int max_depth = (packed >> DEPTH_SHIFT) & 0x3FF;
  const bool mc = (packed >> MC_SHIFT) & 1;
  const bool entering = B.orient[i] == 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    N2R[c] = entering ? B.m_re[3 * slot + c] : B.scene_re[c];
    N2I[c] = entering ? B.m_im[3 * slot + c] : B.scene_im[c];
  }
  const float V[3] = {-D[0], -D[1], -D[2]};
  const float cos_i = sum3(V, N);
  const float s2 = 1.0f - cos_i * cos_i;
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    const float nre = RE[c];
    const float nim = IM[c];
    FresnelT ft;
    fresnel_t(nre, nim, N2R[c], N2I[c], s2, ft);
    FresnelR fr;
    fresnel_r(nre, nim, N2R[c], N2I[c], cos_i, ft.ctre, ft.ctim, fr);
    Fc[c] = fr.F;
  }
  // the refraction direction from the channel-averaged real ratio
  float rc[3];
  #pragma unroll
  for (int c = 0; c < 3; ++c)
    rc[c] = RE[c] / t_clamp_min(N2R[c], F32(1e-9));
  const float avg = ((rc[0] + rc[1]) + rc[2]) / 3.0f;
  bool disp = false;
  int h = 0;
  if (B.hero != nullptr) {
    disp = B.dispersive[slot] > 0.5f;
    const long long hh = B.hero[i];
    h = hh < 0 ? 0 : (hh > 2 ? 2 : (int)hh);
  }
  // ratio_ch[hero]: a select over the three channels
  const float ra = disp ? (h == 0 ? rc[0] : (h == 1 ? rc[1] : rc[2])) : avg;
  const float ci1 = cos_i;
  const float p127 = ra * ra, x129 = 1.0f - ci1 * ci1;
  const float sin2t = p127 * x129;
  const bool non_tir = sin2t <= 1.0f;
  const float x134 = 1.0f - sin2t;
  const float c135 = t_clamp_min(x134, F32(1e-30));
  const float sq136 = t_sqrt(c135);
  const float kk = ra * ci1 - (x134 > 0.0f ? sq136 : 0.0f);
  // Beer-Lambert
  const float t = B.t[i], eps = B.eps[i];
  const float Tavg = (((1.0f - Fc[0]) + (1.0f - Fc[1])) + (1.0f - Fc[2])) / 3.0f;
  const float p = non_tir ? t_clamp_max(t_clamp_min(Tavg, 0.0f), 1.0f) : 0.0f;
  bool take = (B.u[i] < p) && non_tir;
  const bool cont = B.depth[i] < max_depth;
  bool det = false, bit = false;
  if (B.split_k > 0) {
    const int cnt = B.split_cnt[i];
    det = !mc && cnt < B.split_k && cont;
    bit = ((B.pattern[i] >> (cnt < 30 ? cnt : 30)) & 1) == 1;
  }
  if (det) take = bit && non_tir;
  const float c202 = t_clamp_min(p, F32(1e-9));
  const float x205 = 1.0f - p;
  const float c206 = t_clamp_min(x205, F32(1e-9));

  // ---- the backward, node by node in the engine's order ----
  unsigned fl = 0u;
  Acc Lt = {}, Leps = {};
  float v[3];
  // new_n_im, new_n_re = where(take, n2, n)
  if (gp4) {
    const float* const G4 = sh[S_G0 + 4] + e0;
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      put_ch(sh[S_B6] + e0, fl, F_B6, c, take ? G4[c] : 0.0f);
      put_ch(sh[S_LIM] + e0, fl, F_LIM, c, take ? 0.0f : G4[c]);
    }
  }
  if (gp3) {
    const float* const G3 = sh[S_G0 + 3] + e0;
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      put_ch(sh[S_B4] + e0, fl, F_B4, c, take ? G3[c] : 0.0f);
      put_ch(sh[S_LRE] + e0, fl, F_LRE, c, take ? 0.0f : G3[c]);
    }
  }
  // new_origin = where(take, P - N eps, P + N eps): P takes both branches'
  // gradients (the first stored, the second added), which leave from the
  // slot of new_origin's gradient
  if (gp1) {
    float* const G1 = sh[S_DP] + e0;
    float g218[3], g221[3];
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      g218[c] = take ? G1[c] : 0.0f;
      g221[c] = take ? 0.0f : G1[c];
    }
    #pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = g221[c] * eps;
    put3_ch(LN, fl, F_LN, v);
    put(Leps, tsum3(g221[0] * N[0], g221[1] * N[1], g221[2] * N[2]));
    #pragma unroll
    for (int c = 0; c < 3; ++c) G1[c] = g221[c] + g218[c];
    #pragma unroll
    for (int c = 0; c < 3; ++c) g218[c] = -g218[c];
    #pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = g218[c] * eps;
    put3_ch(LN, fl, F_LN, v);
    put(Leps, tsum3(g218[0] * N[0], g218[1] * N[1], g218[2] * N[2]));
  }
  if (B.deps) B.deps[i] = Leps.has ? Leps.v : 0.0f;
  // w = where(take, where(det, 2T, T / c202), where(det, 2F, F / c206)),
  // beta_mult = absorb * w (* where(take, hero_w, 1)); then p_refr's where
  // and clamp, and T_avg's selects
  Acc b201 = {};
  if (gp0) {
    float bT[3] = {};
    float g204[3], g208[3], g190[3];
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float F = Fc[c], T = 1.0f - F;
      const float w = take ? (det ? 2.0f * T : T / c202) : (det ? 2.0f * F : F / c206);
      const float hw = take && disp ? (c == h ? 3.0f : 0.0f) : 1.0f;
      const float g = B.hero != nullptr ? G0[c] * hw : G0[c];
      const float x190 = ((IM[c] * -2.0f) * B.k[c]) * 1e9f;
      const float x192 = x190 * t;
      const float g193 = g * w;
      const float g213 = g * t_exp(x192);
      const float g210 = take ? g213 : 0.0f, g212 = take ? 0.0f : g213;
      put_ch(BF, fl, F_BF, c, (det ? g212 : 0.0f) * 2.0f);
      put_ch(bT, fl, F_BT, c, (det ? g210 : 0.0f) * 2.0f);
      g204[c] = det ? 0.0f : g210;
      g208[c] = det ? 0.0f : g212;
      // absorb = exp(((-2 n_im) k) 1e9 t)
      const float g192 = exp_bwd(g193, x192, t_exp(x192));
      g190[c] = g192 * t;
      v[c] = g192 * x190;
    }
    #pragma unroll
    for (int c = 0; c < 3; ++c) put_ch(BF, fl, F_BF, c, g208[c] / c206);
    const float g207 = tsum3(-g208[0] * ((Fc[0] / c206) / c206),
                             -g208[1] * ((Fc[1] / c206) / c206),
                             -g208[2] * ((Fc[2] / c206) / c206));
    put(b201, -ge_or_zero(x205, F32(1e-9), g207));
    #pragma unroll
    for (int c = 0; c < 3; ++c) put_ch(bT, fl, F_BT, c, g204[c] / c202);
    const float g203 = tsum3(-g204[0] * (((1.0f - Fc[0]) / c202) / c202),
                             -g204[1] * (((1.0f - Fc[1]) / c202) / c202),
                             -g204[2] * (((1.0f - Fc[2]) / c202) / c202));
    put(b201, ge_or_zero(p, F32(1e-9), g203));
    const float g200 = non_tir ? b201.v : 0.0f;
    const float g199 = Tavg >= 0.0f && Tavg <= 1.0f ? g200 : 0.0f;
    const float Tavg_b = g199 / 3.0f;
    put_sel_ch(bT, fl, F_BT, 2, Tavg_b);
    put_sel_ch(bT, fl, F_BT, 1, Tavg_b);
    put_sel_ch(bT, fl, F_BT, 0, Tavg_b);
    put(Lt, tsum3(v[0], v[1], v[2]));
    if (B.dt) B.dt[i] = Lt.v;
    #pragma unroll
    for (int c = 0; c < 3; ++c)
      put_ch(sh[S_LIM] + e0, fl, F_LIM, c, ((g190[c] * 1e9f) * B.k[c]) * -2.0f);
    // F (T = 1 - F)
    #pragma unroll
    for (int c = 0; c < 3; ++c) put_ch(BF, fl, F_BF, c, -bT[c]);
  }
  // refl_dir = r / sqrt(_sum3(r, r)), r = D - N (2 _sum3(D, N)); new_dir =
  // where(take, refr_dir, refl_dir)
  if (gp2) {
    unsigned fs = 0u;
    const float k170 = 2.0f * sum3(D, N);
    float r[3], b173[3] = {}, g187[3];
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[c] = D[c] - N[c] * k170;
      g187[c] = take ? 0.0f : G2[c];
    }
    const float q184 = sum3(r, r);
    const float s185 = t_sqrt(q184);
    #pragma unroll
    for (int c = 0; c < 3; ++c) put_ch(b173, fs, F_B173, c, g187[c] / s185);
    const float g186 = tsum3(-g187[0] * ((r[0] / s185) / s185),
                             -g187[1] * ((r[1] / s185) / s185),
                             -g187[2] * ((r[2] / s185) / s185));
    const float g184 = sqrt_bwd(g186, q184, s185);
    #pragma unroll
    for (int c = 2; c >= 0; --c) {
      put_sel_ch(b173, fs, F_B173, c, g184 * r[c]);
      put_sel_ch(b173, fs, F_B173, c, g184 * r[c]);
    }
    put3_ch(LD, fl, F_LD, b173);
    float g172[3];
    #pragma unroll
    for (int c = 0; c < 3; ++c) g172[c] = -b173[c];
    #pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = g172[c] * k170;
    put3_ch(LN, fl, F_LN, v);
    const float g169 = tsum3(g172[0] * N[0], g172[1] * N[1], g172[2] * N[2]) * 2.0f;
    #pragma unroll
    for (int c = 2; c >= 0; --c) {
      put_sel_ch(LN, fl, F_LN, c, g169 * D[c]);
      put_sel_ch(LD, fl, F_LD, c, g169 * N[c]);
    }
  }
  // refr_dir = raw / clamp_min(safe_sqrt(_sum3(raw, raw)), 1e-20), raw = D ra
  // + N (ra cos_i1 - safe_sqrt(1 - sin2_t)), sin2_t = ra^2 (1 - cos_i1^2)
  Acc ra_b = {}, ci1_b = {};
  if (gp2) {
    unsigned fs = 0u;
    float raw[3], g158[3], b141[3] = {};
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      raw[c] = D[c] * ra + N[c] * kk;
      g158[c] = take ? G2[c] : 0.0f;
    }
    const float q152 = sum3(raw, raw);
    const float c153 = t_clamp_min(q152, F32(1e-30));
    const float sq154 = t_sqrt(c153);
    const float ss155 = q152 > 0.0f ? sq154 : 0.0f;
    const float c157 = t_clamp_min(ss155, F32(1e-20));
    #pragma unroll
    for (int c = 0; c < 3; ++c) put_ch(b141, fs, F_B141, c, g158[c] / c157);
    const float g157 = tsum3(-g158[0] * ((raw[0] / c157) / c157),
                             -g158[1] * ((raw[1] / c157) / c157),
                             -g158[2] * ((raw[2] / c157) / c157));
    const float g154 = q152 > 0.0f ? ge_or_zero(ss155, F32(1e-20), g157) : 0.0f;
    const float g152 = ge_or_zero(q152, F32(1e-30), sqrt_bwd(g154, c153, sq154));
    #pragma unroll
    for (int c = 2; c >= 0; --c) {
      put_sel_ch(b141, fs, F_B141, c, g152 * raw[c]);
      put_sel_ch(b141, fs, F_B141, c, g152 * raw[c]);
    }
    #pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = b141[c] * kk;
    put3_ch(LN, fl, F_LN, v);
    const float g139 = tsum3(b141[0] * N[0], b141[1] * N[1], b141[2] * N[2]);
    const float g136 = x134 > 0.0f ? -g139 : 0.0f;
    const float g134 = ge_or_zero(x134, F32(1e-30), sqrt_bwd(g136, c135, sq136));
    const float g130 = -g134;
    put(ra_b, g139 * ci1);
    put(ci1_b, g139 * ra);
    #pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = b141[c] * ra;
    put3_ch(LD, fl, F_LD, v);
    put(ra_b, tsum3(b141[0] * D[0], b141[1] * D[1], b141[2] * D[2]));
    const float g127 = g130 * x129;
    const float g128 = -(g130 * p127);
    put(ci1_b, g128 * (2.0f * ci1));
    put(ra_b, g127 * (2.0f * ra));
  }
  // ra = where(disp, ratio_ch[hero], avg) with dispersion; avg = the
  // channels' sum / 3; ratio_ch = n_re / clamp_min(n2_re, 1e-9)
  float rc_b[3] = {};
  Acc avg_b = {}, b18 = {};
  if (ra_b.has) {
    if (B.hero != nullptr) {
      const float gh = disp ? ra_b.v : 0.0f;
      #pragma unroll
      for (int c = 0; c < 3; ++c) put_ch(rc_b, fl, F_RC, c, c == h ? 0.0f + gh : 0.0f);
      put(avg_b, disp ? 0.0f : ra_b.v);
    } else {
      avg_b = ra_b;
    }
  }
  if (ci1_b.has) put(b18, ci1_b.v);
  if (avg_b.has) {
    const float g124 = avg_b.v / 3.0f;
    #pragma unroll
    for (int c = 2; c >= 0; --c) put_sel_ch(rc_b, fl, F_RC, c, g124);
  }
  if (fl & F_RC) {
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float nre = RE[c];
      const float c118 = t_clamp_min(N2R[c], F32(1e-9));
      put_ch(sh[S_LRE] + e0, fl, F_LRE, c, rc_b[c] / c118);
      const float g118 = -rc_b[c] * ((nre / c118) / c118);
      put_ch(sh[S_B4] + e0, fl, F_B4, c, ge_or_zero(N2R[c], F32(1e-9), g118));
    }
  }
  // each channel's Fresnel chain (the chains' products into the slots of
  // the output gradients, all read by now)
  if (fl & F_BF) {
    const Outer o = {sh[S_LRE] + e0, sh[S_LIM] + e0, sh[S_B4] + e0, sh[S_B6] + e0,
                     sh[S_P92] + e0, sh[S_P91] + e0, sh[S_P62] + e0, sh[S_P61] + e0,
                     sh[S_P42] + e0, sh[S_P39] + e0};
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
      float ctreb, ctimb;
      {
        const float nre = RE[c];
        const float nim = IM[c];
        FresnelT ft;
        fresnel_t(nre, nim, N2R[c], N2I[c], s2, ft);
        FresnelR fr;
        fresnel_r(nre, nim, N2R[c], N2I[c], cos_i, ft.ctre, ft.ctim, fr);
        fresnel_bwd_r(nre, nim, N2R[c], N2I[c], cos_i, ft.ctre, ft.ctim, fr, BF[c], c, o,
                      fl, &ctreb, &ctimb);
      }
      // the chain's first half again (the same ops on the same inputs, read
      // again), for the root's and the ratio's backward
      const float nre = reload(RE + c), nim = reload(IM + c);
      const float n2r = reload(N2R + c), n2i = reload(N2I + c);
      FresnelT ft;
      fresnel_t(nre, nim, n2r, n2i, s2, ft);
      fresnel_bwd_t(nre, nim, n2r, n2i, s2, ft, ctreb, ctimb, c, o, fl);
    }
    // cos_i (N, 1) takes its products' torch.sums over the channels, s2's
    put(b18, tsum3(o.p92[0], o.p92[1], o.p92[2]));
    put(b18, tsum3(o.p91[0], o.p91[1], o.p91[2]));
    put(b18, tsum3(o.p62[0], o.p62[1], o.p62[2]));
    put(b18, tsum3(o.p61[0], o.p61[1], o.p61[2]));
    const float g38 = tsum3(o.p42[0], o.p42[1], o.p42[2]) + tsum3(o.p39[0], o.p39[1], o.p39[2]);
    const float g37 = -g38;
    put(b18, g37 * cos_i);
    put(b18, g37 * cos_i);
  }
  // cos_i = _sum3(V, N), V = -D
  if (b18.has) {
    unsigned fs = 0u;
    float Vb[3] = {};
    #pragma unroll
    for (int c = 2; c >= 0; --c) {
      put_sel_ch(LN, fl, F_LN, c, b18.v * V[c]);
      put_sel_ch(Vb, fs, F_VB, c, b18.v * N[c]);
    }
    #pragma unroll
    for (int c = 0; c < 3; ++c) put_ch(LD, fl, F_LD, c, -Vb[c]);
  }

  // ---- the gradients, into the tile's slots ----
  #pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int e = e0 + c;
    if (B.dN) sh[S_LN][e] = got_ch(LN, fl, F_LN, c);
    if (B.dD) sh[S_LD][e] = got_ch(LD, fl, F_LD, c);
    if (B.dn_re) sh[S_LRE][e] = got_ch(sh[S_LRE] + e0, fl, F_LRE, c);
    if (B.dn_im) sh[S_LIM][e] = got_ch(sh[S_LIM] + e0, fl, F_LIM, c);
    const float b4 = got_ch(sh[S_B4] + e0, fl, F_B4, c);
    const float b6 = got_ch(sh[S_B6] + e0, fl, F_B6, c);
    if (B.m_re_rows) sh[S_MRE][e] = entering ? b4 : 0.0f;
    if (B.s_re_rows) sh[S_SRE][e] = entering ? 0.0f : b4;
    if (B.m_im_rows) sh[S_MIM][e] = entering ? b6 : 0.0f;
    if (B.s_im_rows) sh[S_SIM][e] = entering ? 0.0f : b6;
  }
}

__global__ void __launch_bounds__(BWD_TILE, REFR_BWD_MIN_BLOCKS)
shade_refractive_bwd_kernel(RefrBwd B) {
  __shared__ float sh[NSLOT][ROW];
  const int tt = (int)threadIdx.x;
  const long long stride = (long long)gridDim.x * BWD_TILE;
  for (long long r0 = (long long)blockIdx.x * BWD_TILE; r0 < B.n; r0 += stride) {
    const long long rest = B.n - r0;
    const int cnt = (int)(rest < BWD_TILE ? rest : BWD_TILE);
    // the tile's rows in, element by element: the output gradients masked
    // (the merge's where(m, o, g): +0 to the rays outside the block), their
    // pass-through gradients out
    for (int k = 0; k < 3; ++k) {
      const int e = k * BWD_TILE + tt;
      if (e >= 3 * cnt) continue;
      const long long j = 3 * r0 + e;
      sh[S_N][e] = B.N[j];
      sh[S_D][e] = B.D[j];
      sh[S_RE][e] = B.re_step ? B.n_re[j] : B.n_re[e % 3];
      sh[S_IM][e] = B.im_step ? B.n_im[j] : B.n_im[e % 3];
      const bool mk = B.m[r0 + e / 3] != 0;
      for (int f = 0; f < 5; ++f) {
        if (!B.g[f]) continue;
        const float g = B.g[f][j];
        sh[S_G0 + f][e] = mk ? g : 0.0f;
        if (B.pass[f]) B.pass[f][j] = mk ? 0.0f : g;
      }
    }
    __syncthreads();
    if (tt < cnt) refr_bwd_ray(B, r0 + tt, tt, sh);
    __syncthreads();
    // the tile's gradients out, element by element
    for (int k = 0; k < 3; ++k) {
      const int e = k * BWD_TILE + tt;
      if (e >= 3 * cnt) continue;
      const long long o = 3 * r0 + e;
      if (B.dP) B.dP[o] = sh[S_DP][e];
      if (B.dN) B.dN[o] = sh[S_LN][e];
      if (B.dD) B.dD[o] = sh[S_LD][e];
      if (B.dn_re) B.dn_re[o] = sh[S_LRE][e];
      if (B.dn_im) B.dn_im[o] = sh[S_LIM][e];
      if (B.m_re_rows) B.m_re_rows[o] = sh[S_MRE][e];
      if (B.m_im_rows) B.m_im_rows[o] = sh[S_MIM][e];
      if (B.s_re_rows) B.s_re_rows[o] = sh[S_SRE][e];
      if (B.s_im_rows) B.s_im_rows[o] = sh[S_SIM][e];
    }
    __syncthreads();
  }
}

// The card's SMs and the kernel's resident blocks an SM.
cudaError_t residency(int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, shade_refractive_bwd_kernel, BWD_TILE, 0);
  return err;
}

bool bwd_ok(const RefrBwd& B) {
  bool any = false;
  for (int f = 0; f < 5; ++f) {
    if (B.pass[f] && !B.g[f]) return false;
    any = any || B.g[f];
  }
  const bool gm = B.g[0], go = B.g[1], gd = B.g[2], gr = B.g[3], gi = B.g[4];
  // each wanted gradient has an output gradient that reaches it
  return B.n >= 1 && any && B.packed && B.m && B.P && B.N && B.D && B.eps && B.t
         && B.orient && B.n_re && B.n_im && (B.re_step == 0 || B.re_step == 3)
         && (B.im_step == 0 || B.im_step == 3) && B.depth && B.u && B.m_re && B.m_im
         && B.rows >= 1 && B.scene_re && B.scene_im
         && (B.split_k <= 0 || (B.pattern && B.split_cnt))
         && (!B.hero || B.dispersive)
         && (!B.dD || gm || gd) && (!B.dN || gm || go || gd) && (!B.dP || go)
         && (!B.deps || go) && (!B.dt || gm) && (!B.dn_re || gm || gd || gr)
         && (!B.dn_im || gm || gi) && (!(B.m_re_rows || B.s_re_rows) || gm || gd || gr)
         && (!(B.m_im_rows || B.s_im_rows) || gm || gi);
}

}  // namespace w4b

using namespace w4b;

// The refractive block's backward on the bounce B (ops/wavefront_shade.py
// builds it), one launch.  Returns 0 or a CUDA error, and sets *launched
// to the kernels launched.
extern "C" int shade_refractive_bwd(const RefrBwd* B, void* stream, int* launched) {
  *launched = 0;
  if (!bwd_ok(*B)) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = residency(&sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long need = (B->n + BWD_TILE - 1) / BWD_TILE;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < most ? need : most);
  LAUNCH(shade_refractive_bwd_kernel, grid, BWD_TILE, 0,
         static_cast<cudaStream_t>(stream), *B);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// What the kernel was built to: out[0] registers a thread, out[1] local
// memory a thread (bytes: spills and stack), out[2] resident blocks an SM,
// out[3] the SMs, out[4] threads a block, out[5] the __launch_bounds__
// minimum of blocks an SM, out[6] rays a block a pass.
extern "C" int shade_refractive_bwd_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, shade_refractive_bwd_kernel);
  if (err == cudaSuccess) err = residency(&out[3], &out[2]);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[4] = BWD_TILE;
  out[5] = REFR_BWD_MIN_BLOCKS;
  out[6] = BWD_TILE;
  return 0;
}
