// The image-texture fetch of the wavefront's shading (materials/shade.py
// fetch_texture, _slot_color), shared by W4 (wavefront_shade.cu: the
// diffuse, refractive and glossy blocks' slot colours) and W6
// (bounce_tail.cu: the emissive slots' colours and the environments'
// texels), with the int32 ops it rounds by.  Each is torch's op as the
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

__device__ __forceinline__ void tap(const float* tex, int H, int W, int iu,
                                    int iv, float* c) {
  const long long idx = (long long)t_rem(wrap_neg(iv), H) * W + t_rem(iu, W);
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

}  // namespace texture_fetch
