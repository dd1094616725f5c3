// The image-texture fetch of the wavefront's shading (materials/shade.py
// fetch_texture, _slot_color), shared by W4 (wavefront_shade.cu: the
// diffuse, refractive and glossy blocks' slot colours) and W6
// (bounce_tail.cu: the emissive slots' colours and the environments'
// texels), with the int32 ops it rounds by, and its bilinear branch's
// backward into uv (W6's start, W4's diffuse and glossy backward).  Each is torch's op as the
// plain version runs it: float -> int32 truncation, a floored modulo,
// int32 arithmetic that wraps, one rounding a product or a sum (the
// sources are built with --fmad=false, the CPU tests' g++ builds with
// -ffp-contract=off).

#pragma once

#include <cuda_runtime.h>

#include <math.h>

// A named namespace: the extern "C" entries of W4 and W6 take `Textures`
// in their structs.
namespace texture_fetch {

// torch.remainder of int32s: a floored modulo
__device__ __forceinline__ int t_rem(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// int32 arithmetic that wraps, as torch's
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_neg(int a) { return (int)(0u - (unsigned)a); }

// _g1: row `slot` of a table of `rows` rows, the slot clamped into it
__device__ __forceinline__ int clip_slot(int slot, int rows) {
  return slot < 0 ? 0 : (slot > rows - 1 ? rows - 1 : slot);
}

// A block's image textures: one flat (texels, 3) buffer and, a slot of the
// block's table, (offset in texels, H, W, flags) and (W * repeat,
// H * repeat); flags bit 0: the slot fetches a texture, bit 1: bilinear.
struct Textures {
  const float* texels;
  const int* desc_i;
  const float* desc_f;
};

// the texel row of (iu, iv) in an H x W texture, wrapped around
__device__ __forceinline__ long long texel_row(int H, int W, int iu, int iv) {
  return (long long)t_rem(wrap_neg(iv), H) * W + t_rem(iu, W);
}

__device__ __forceinline__ void tap(const float* tex, int H, int W, int iu,
                                    int iv, float* c) {
  const long long idx = texel_row(H, W, iu, iv);
  c[0] = tex[3 * idx];
  c[1] = tex[3 * idx + 1];
  c[2] = tex[3 * idx + 2];
}

__device__ __forceinline__ void fetch_texture(const Textures& T, int slot,
                                              float u, float v, float* c) {
  const int* d = T.desc_i + 4 * slot;
  const float* tex = T.texels + 3 * (long long)d[0];
  const int H = d[1], W = d[2];
  const float su = T.desc_f[2 * slot], sv = T.desc_f[2 * slot + 1];
  if (!(d[3] & 2)) {
    tap(tex, H, W, (int)(u * su), (int)(v * sv), c);
    return;
  }
  const float x = u * su - 0.5f, y = v * sv - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int ix = (int)x0, iy = (int)y0;
  const int ix1 = wrap_add(ix, 1), iy1 = wrap_add(iy, 1);
  float c00[3], c10[3], c01[3], c11[3];
  tap(tex, H, W, ix, iy, c00);
  tap(tex, H, W, ix1, iy, c10);
  tap(tex, H, W, ix, iy1, c01);
  tap(tex, H, W, ix1, iy1, c11);
  const float w00 = (1.0f - fx) * (1.0f - fy), w10 = fx * (1.0f - fy);
  const float w01 = (1.0f - fx) * fy, w11 = fx * fy;
  for (int k = 0; k < 3; ++k)
    c[k] = ((w00 * c00[k] + w10 * c10[k]) + w01 * c01[k]) + w11 * c11[k];
}

// the slot colour: the table's row, or the slot's image texture at uv
__device__ __forceinline__ void slot_color(const float* table, int rows,
                                           const Textures& T, int slot, float u,
                                           float v, float* c) {
  if (T.desc_i != nullptr && slot >= 0 && slot < rows && (T.desc_i[4 * slot + 3] & 1)) {
    fetch_texture(T, slot, u, v, c);
    return;
  }
  const int s = clip_slot(slot, rows);
  c[0] = table[3 * s];
  c[1] = table[3 * s + 1];
  c[2] = table[3 * s + 2];
}

// materials/shade.py fetch_texture's bilinear branch, backward of the
// colour's gradient G into (u, v), the texture taking none:
//   x = u su - 0.5, x0 = floor(x), fx = (x - x0)[..., None] (y likewise)
//   c = (((1 - fx) (1 - fy)) t00 + (fx (1 - fy)) t10)
//       + ((1 - fx) fy) t01 + (fx fy) t11
// Each weight's gradient is torch.sum of G times its texel; fx's buffer
// takes, as the engine runs the terms last to first, fx fy's, (1 - fx)
// fy's, fx (1 - fy)'s, then (1 - fx) (1 - fy)'s; the floor adds +0 to x.
// (gu, gv) are what uv[..., 0] * su and uv[..., 1] * sv hand their select.
// tsum3: the including source's torch.sum over three (a functor).
template <class Sum3>
__device__ __forceinline__ void bilinear_bwd(const Textures& T, int r, float u, float v,
                                             const float* G, float* gu, float* gv,
                                             Sum3 tsum3) {
  const int* d = T.desc_i + 4 * r;
  const float* tex = T.texels + 3 * (long long)d[0];
  const int H = d[1], W = d[2];
  const float su = T.desc_f[2 * r], sv = T.desc_f[2 * r + 1];
  const float x = u * su - 0.5f, y = v * sv - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int ix = (int)x0, iy = (int)y0;
  const int ix1 = wrap_add(ix, 1), iy1 = wrap_add(iy, 1);
  float c00[3], c10[3], c01[3], c11[3];
  tap(tex, H, W, ix, iy, c00);
  tap(tex, H, W, ix1, iy, c10);
  tap(tex, H, W, ix, iy1, c01);
  tap(tex, H, W, ix1, iy1, c11);
  const float g11 = tsum3(G[0] * c11[0], G[1] * c11[1], G[2] * c11[2]);
  const float g01 = tsum3(G[0] * c01[0], G[1] * c01[1], G[2] * c01[2]);
  const float g10 = tsum3(G[0] * c10[0], G[1] * c10[1], G[2] * c10[2]);
  const float g00 = tsum3(G[0] * c00[0], G[1] * c00[1], G[2] * c00[2]);
  const float ax = 1.0f - fx, ay = 1.0f - fy;
  // fx fy; ((1 - fx) fy): 1 - fx takes g01 fy; (fx (1 - fy)): 1 - fy takes
  // g10 fx; ((1 - fx)(1 - fy)): each takes g00 times the other
  float gfx = g11 * fy, gfy = g11 * fx;
  gfy = gfy + g01 * ax;
  gfx = gfx + -(g01 * fy);
  gfx = gfx + g10 * ay;
  gfy = gfy + -(g10 * fx);
  gfy = gfy + -(g00 * ax);
  gfx = gfx + -(g00 * ay);
  *gv = (gfy + 0.0f) * sv;
  *gu = (gfx + 0.0f) * su;
}

// The texture's side of ref r's fetch backward: each tap's gradient row and
// the texel row it reads, for the wrapper's core/safemath.py
// `take_backward` scans (ops/wavefront_shade.py `texture_grads`).  Planes
// of (planes, n, 3) rows and (planes, n) int64 rows: a bilinear ref takes
// four from `plane`, its taps in the forward's order (t00, t10, t01, t11),
// each G times its weight (mul's backward of w * tap, w as the forward
// rounds it); a nearest ref one, G itself.
struct TapRows {
  float* rows;
  long long* idx;
};

__device__ __forceinline__ int tap_planes(const Textures& T, int r) {
  return (T.desc_i[4 * r + 3] & 2) ? 4 : 1;
}

// the planes of refs 0 .. refs - 1
__device__ __forceinline__ int tap_planes_total(const Textures& T, int refs) {
  int p = 0;
  for (int r = 0; r < refs; ++r) p += tap_planes(T, r);
  return p;
}

__device__ __forceinline__ void tap_row(const TapRows& R, int plane, long long n,
                                        long long i, int H, int W, int iu, int iv,
                                        const float* G, float w, bool weighted) {
  const long long at = (long long)plane * n + i;
  R.idx[at] = texel_row(H, W, iu, iv);
  for (int c = 0; c < 3; ++c) R.rows[3 * at + c] = weighted ? G[c] * w : G[c];
}

__device__ __forceinline__ void tap_rows(const Textures& T, int r, float u, float v,
                                         const float* G, const TapRows& R, int plane,
                                         long long n, long long i) {
  const int* d = T.desc_i + 4 * r;
  const int H = d[1], W = d[2];
  const float su = T.desc_f[2 * r], sv = T.desc_f[2 * r + 1];
  if (tap_planes(T, r) == 1) {
    tap_row(R, plane, n, i, H, W, (int)(u * su), (int)(v * sv), G, 1.0f, false);
    return;
  }
  const float x = u * su - 0.5f, y = v * sv - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int ix = (int)x0, iy = (int)y0;
  const int ix1 = wrap_add(ix, 1), iy1 = wrap_add(iy, 1);
  tap_row(R, plane, n, i, H, W, ix, iy, G, (1.0f - fx) * (1.0f - fy), true);
  tap_row(R, plane + 1, n, i, H, W, ix1, iy, G, fx * (1.0f - fy), true);
  tap_row(R, plane + 2, n, i, H, W, ix, iy1, G, (1.0f - fx) * fy, true);
  tap_row(R, plane + 3, n, i, H, W, ix1, iy1, G, fx * fy, true);
}

}  // namespace texture_fetch
