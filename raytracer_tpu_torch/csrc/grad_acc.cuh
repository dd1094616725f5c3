// The gradient buffers of autograd's engine and the derivative formulas of
// ATen that W4's backward kernels restate (wavefront_diffuse_bwd.cu,
// wavefront_glossy_bwd.cu, wavefront_shade_bwd.cu).
//
// A tensor that feeds several nodes of a plain block's graph takes their
// gradients in the order the engine runs those nodes (the ready node
// created last first), the first stored as it is (not added to 0: -0 stays
// -0), each later one added to the sum; a node no present output gradient
// reaches is not run and adds nothing.  `Acc` keeps whether a gradient came
// yet.  A ray's buffers that live across its whole backward may instead
// keep their values in a tile's row of shared memory and their flags as
// bits of one word (`put3_at`, `put_ch`): a flag a buffer, or a flag a
// channel (bits bit, bit << 1, bit << 2) where a buffer takes its row one
// channel at a time (the refractive block's Fresnel chains), so that a
// first -0 in one channel is not turned +0 by another's.  Under
// W4_TORCH_CPU the formulas are the CPU's as the tests run the plain
// blocks (`exact_math`: sqrt, exp, pow through float64).

#pragma once

#include <cuda_runtime.h>

#include <math.h>

namespace grad_acc {

// A gradient buffer: whether a gradient has come yet and their sum
struct Acc {
  float v;
  bool has;
};
__device__ __forceinline__ void put(Acc& a, float x) {
  a.v = a.has ? a.v + x : x;
  a.has = true;
}
__device__ __forceinline__ float got(const Acc& a) { return a.has ? a.v : 0.0f; }

// (N, 3): a buffer a channel
struct Acc3 {
  float v[3];
  bool has;
};
__device__ __forceinline__ void put3(Acc3& a, const float* x) {
  for (int c = 0; c < 3; ++c) a.v[c] = a.has ? a.v[c] + x[c] : x[c];
  a.has = true;
}
// a select's backward: g in channel k, +0 pads in the others (a full row)
__device__ __forceinline__ void put_sel(Acc3& a, int k, float g) {
  for (int c = 0; c < 3; ++c) {
    const float x = c == k ? g : 0.0f;
    a.v[c] = a.has ? a.v[c] + x : x;
  }
  a.has = true;
}
__device__ __forceinline__ float got(const Acc3& a, int c) { return a.has ? a.v[c] : 0.0f; }

// A row buffer held at v (three floats), its flag bit `bit` of fl
__device__ __forceinline__ void put3_at(float* v, unsigned& fl, unsigned bit, const float* x) {
  const bool h = (fl & bit) != 0u;
  for (int c = 0; c < 3; ++c) v[c] = h ? v[c] + x[c] : x[c];
  fl |= bit;
}
__device__ __forceinline__ void put_sel_at(float* v, unsigned& fl, unsigned bit, int k,
                                           float g) {
  const bool h = (fl & bit) != 0u;
  for (int c = 0; c < 3; ++c) {
    const float x = c == k ? g : 0.0f;
    v[c] = h ? v[c] + x : x;
  }
  fl |= bit;
}
// a scalar buffer
__device__ __forceinline__ void put_at(float& v, unsigned& fl, unsigned bit, float x) {
  v = (fl & bit) != 0u ? v + x : x;
  fl |= bit;
}
__device__ __forceinline__ float got_at(float v, unsigned fl, unsigned bit) {
  return (fl & bit) != 0u ? v : 0.0f;
}

// A buffer with a flag a channel: channel c's flag is bit << c of fl.  v
// may be indexed at run time where it lies in shared memory.
__device__ __forceinline__ void put_ch(float* v, unsigned& fl, unsigned bit, int c, float x) {
  const unsigned b = bit << c;
  v[c] = (fl & b) ? v[c] + x : x;
  fl |= b;
}
__device__ __forceinline__ void put3_ch(float* v, unsigned& fl, unsigned bit, const float* x) {
  for (int c = 0; c < 3; ++c) put_ch(v, fl, bit, c, x[c]);
}
// a select's backward: g in channel k, +0 pads in the others
__device__ __forceinline__ void put_sel_ch(float* v, unsigned& fl, unsigned bit, int k,
                                         float g) {
  for (int c = 0; c < 3; ++c) put_ch(v, fl, bit, c, c == k ? g : 0.0f);
}
__device__ __forceinline__ float got_ch(const float* v, unsigned fl, unsigned bit, int c) {
  return (fl & (bit << c)) ? v[c] : 0.0f;
}

// clamp_min's backward mask: g where x >= lo (false for NaN), else +0
__device__ __forceinline__ float ge_or_zero(float x, float lo, float g) {
  return x >= lo ? g : 0.0f;
}
// clamp(x, lo, hi)'s: g where lo <= x <= hi
__device__ __forceinline__ float in_or_zero(float x, float lo, float hi, float g) {
  return x >= lo && x <= hi ? g : 0.0f;
}

// sqrt's backward at x (clamped, as safe_sqrt takes it; its result r):
// g / (2 r), or under W4_TORCH_CPU in float64 between the two casts
__device__ __forceinline__ float sqrt_bwd(float g, float x, float r) {
#ifdef W4_TORCH_CPU
  (void)r;
  return (float)((double)g / (2.0 * sqrt((double)x)));
#else
  (void)x;
  return g / (2.0f * r);
#endif
}

// exp's backward at x (its result r): g r, or under W4_TORCH_CPU g exp(x)
// in float64 between the two casts
__device__ __forceinline__ float exp_bwd(float g, float x, float r) {
#ifdef W4_TORCH_CPU
  (void)r;
  return (float)((double)g * exp((double)x));
#else
  (void)x;
  return g * r;
#endif
}

// a quotient a / b's gradient for its divisor: -g ((a / b) / b)
__device__ __forceinline__ float div_other(float g, float a, float b) {
  return -g * ((a / b) / b);
}

// torch.linalg.cross(a, b, dim=-1), fma(a1, b2, -(a2 b1)) a component
__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = fmaf(a[1], b[2], -(a[2] * b[1]));
  c[1] = fmaf(a[2], b[0], -(a[0] * b[2]));
  c[2] = fmaf(a[0], b[1], -(a[1] * b[0]));
}

}  // namespace grad_acc
