// Record-path kernel for Hopper (sm_90a): trace, fetch the textures,
// integrate.
//
// Replaces raytracer_tpu/ops/pallas_record.py:_make_record_kernel, the TPU
// kernel behind _record_call, together with the XLA replay that
// pallas_record_chunk runs after it (_replay :787, _decode_words :742):
// the function computed is the whole chunk.  One thread traces one ray,
// index idx = sample * n_pix + pixel, through camera ray generation and
// every bounce, exactly as the Pallas kernel does.  Where the TPU kernel
// writes a (bounce, ray) record, this one looks up the hit's shading group
// in the fetch table (core/compile.py fetch_table), gathers and decodes
// the group's texels from the atlas at the hit's uv (nearest or bilinear,
// the environment's lightmap table on later bounces, the composed or the
// two-round thin-film tables), forms
//   m_add = add_base + add_texcoef * tex,  m_beta = beta_base * beta_tex
// and folds them into the path in registers: L = m_add, beta = m_beta at
// bounce 0, then L = L + beta * m_add, beta = beta * m_beta.  It writes
// the radiance L (n, 3) and the count of rays traced, nothing else.  The
// TPU needs the records because a Pallas kernel cannot gather per lane
// from HBM; a CUDA thread can, so the records and their replay are gone.
// The plain version is ops/record_trace.py record_trace_chunk_reference
// followed by ops/replay.py replay, whose arithmetic this kernel repeats
// operation for operation (floored modulo for the uv wrap, the bilinear
// taps and weights in the replay's order, scale * (1 / 1023) and
// exp2(e - 24) in the decode), so that the two agree bit for bit.
//
// What bounds it on the card: FP32 work, dependent latency and warp
// divergence while tracing, as in the solid kernel; its traffic is the
// radiance (12 B a ray) and 1-5 atlas words per (ray, bounce) hit, which
// the 50 MB L2 holds for these scenes' atlases (__ldg).  The scene is
// data, as in the solid kernel: tables in shared memory once per block
// (the fetch table among them), run-time loops over bounces, objects,
// lights and shadow casters, and shading branches on the hit object's
// material.  K2_BLOCK and K2_MIN_BLOCKS set __launch_bounds__
// (scripts/torch_k1_tune.py --kernel k2 builds and times other values).
//
// K2 keeps the older formula forms, and this kernel follows them, not the
// solid kernel's: the diffuse lobe takes cosf / sinf of phi = u * 2 pi,
// Fresnel goes through a complex division and then |.|^2, Beer-Lambert is
// exp(((-2 nim) (2 pi / lambda)) 1e9 t), (1 - c)^5 is the multiply chain
// of lax.integer_pow, and six draws are numbered on every bounce, the last
// one included.  A lane whose path has ended runs its remaining bounces
// as misses (add 0, beta times 1), as the replay integrates them: an
// infinite beta then turns L into NaN, which Scene.render scrubs.
//
// Built by ops/cuda_build.py with nvcc into the shared library of the
// port; the host entry record_trace_launch takes device pointers and
// returns cudaGetLastError() after the launch.

#include "trace_common.cuh"

// K2's launch shape: K2_BLOCK threads a block, and at least K2_MIN_BLOCKS
// resident blocks an SM for __launch_bounds__, which caps the registers a
// thread at 65536 / (K2_BLOCK * K2_MIN_BLOCKS).  Chosen by timing on the
// H100 (PERF.md): 4 x 256 threads hold 32 warps an SM at 64 registers,
// spilling ~350 B a thread to L1, where the unbounded build holds 16 at
// 128; the kernel is bound by latency, so the warps pay
#ifndef K2_BLOCK
#define K2_BLOCK 256
#endif
#ifndef K2_MIN_BLOCKS
#define K2_MIN_BLOCKS 4
#endif

namespace {

// columns of the per-group fetch table (core/compile.py fetch_table)
constexpr int FT_USE_NONE = 0, FT_USE_ADD = 1, FT_USE_BETA = 2, FT_USE_FILM = 3;
constexpr int FT_MODE_UV = 1, FT_MODE_COMP = 2, FT_MODE_TWO = 3;
constexpr int FT_USE = 0, FT_MODE = 1, FT_OFF = 2, FT_W = 3, FT_H = 4,
              FT_E5 = 5, FT_BIL = 6, FT_SEC = 7, FT_OFF2 = 8, FT_W2 = 9,
              FT_H2 = 10, FT_E5_2 = 11, FT_LH = 12, FT_NH = 13, FT_NW = 14;
constexpr int FT_ICOLS = 16;
constexpr int FT_FREP = 0, FT_GREP = 1, FT_SCALE = 2, FT_FREP2 = 3,
              FT_GREP2 = 4, FT_SCALE2 = 5, FT_TF_THICK = 6, FT_TF_NOISE = 7;
constexpr int FT_FCOLS = 8;

struct RecParams {
  const int* seed;       // (3,) chunk seed, R2 rotation seed, first sample
  const float* cam;      // (17,)
  const float* geom;     // (n_obj, 24)
  const int* obj;        // (n_obj, OBJ_COLS)
  const float* dif;      // (n_dif, 4)
  const float* glo;      // (n_glo, 12)
  const float* refr;     // (n_refr, 6)
  const float* emi;      // (n_emi, 3)
  const float* tf;       // (n_tf, 6)
  const float* lights;   // (n_lrow, 11): directional, then point, then spot
  const float* is_tab;   // (n_is, 4)
  const float* consts;   // (16,)
  const int* fetch_i;    // (n_grp, FT_ICOLS): the fetch of each shading group
  const float* fetch_f;  // (n_grp, FT_FCOLS)
  const int* atlas;      // (n_atlas,) packed texels
  long long n_atlas;
  int n_obj, n_dif, n_glo, n_refr, n_emi, n_tf, n_lrow, n_is, n_grp;
  int n_dir, n_point, n_spot;
  int width, height, n_pix, n;
  int max_bounces, iid, split_k, projection;
  int n_hu;                      // dispersive (slot, depth, mc) groups
  float* L;                      // (n, 3) radiance
  unsigned long long* count;     // rays traced
};

// a mod m, floored as torch.remainder (m > 0)
__device__ __forceinline__ long long wrap(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

// the word at idx, clipped into the atlas, decoded (replay.py
// decode_words): 10-10-10 bits times scale / 1023, or RGB9E5; channel 0
// alone when rgb has one slot
template <int C>
__device__ __forceinline__ void texel(const int* atlas, long long n_atlas,
                                      long long idx, float scale, int e5,
                                      float rgb[C]) {
  idx = idx < 0 ? 0 : (idx > n_atlas - 1 ? n_atlas - 1 : idx);
  const int w = __ldg(atlas + idx);
  if (e5) {
    const float es = exp2f((float)((w >> 27) & 31) - 24.0f);
    rgb[0] = (float)((w >> 18) & 511) * es;
    if constexpr (C == 3) {
      rgb[1] = (float)((w >> 9) & 511) * es;
      rgb[2] = (float)(w & 511) * es;
    }
  } else {
    const float s1023 = scale * F(1.0 / 1023.0);
    rgb[0] = (float)((w >> 20) & 1023) * s1023;
    if constexpr (C == 3) {
      rgb[1] = (float)((w >> 10) & 1023) * s1023;
      rgb[2] = (float)(w & 1023) * s1023;
    }
  }
}

// texture-local index of uv, wrapped (replay.py _Round.uv_index)
__device__ __forceinline__ long long uv_index(float u, float v, float frep,
                                              float grep, long long W,
                                              long long H) {
  const long long iu = wrap((long long)(u * frep), W);
  const long long iv = wrap((long long)(v * grep), H);
  return wrap(-iv, H) * W + iu;
}

// the texels of one (ray, bounce) hit of group row (fi, ff) at uv and cos_i
// (replay.py replay's rounds: _Round.fetch, the composed thin-film index,
// the dependent thin-film LUT round)
__device__ __forceinline__ void group_texels(const int* fi, const float* ff,
                                             const int* atlas,
                                             long long n_atlas, float u,
                                             float v, float cos_i,
                                             int bounce, float rgb[3]) {
  const int mode = fi[FT_MODE];
  if (mode == FT_MODE_UV) {
    // an environment's lightmap table serves the bounces after the first
    const bool sec = fi[FT_SEC] && bounce > 0;
    const long long W = fi[sec ? FT_W2 : FT_W], H = fi[sec ? FT_H2 : FT_H];
    const long long off = fi[sec ? FT_OFF2 : FT_OFF];
    const int e5 = fi[sec ? FT_E5_2 : FT_E5];
    const float frep = ff[sec ? FT_FREP2 : FT_FREP];
    const float grep = ff[sec ? FT_GREP2 : FT_GREP];
    const float scale = ff[sec ? FT_SCALE2 : FT_SCALE];
    if (sec || !fi[FT_BIL]) {
      texel<3>(atlas, n_atlas, uv_index(u, v, frep, grep, W, H) + off, scale,
               e5, rgb);
      return;
    }
    // bilinear: four taps (0,0), (1,0), (0,1), (1,1), summed from 0
    const float x = u * frep - 0.5f, y = v * grep - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const long long ix = (long long)x0, iy = (long long)y0;
    const float wt[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                         (1.0f - fx) * fy, fx * fy};
    rgb[0] = rgb[1] = rgb[2] = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long col = wrap(ix + (t & 1), W);
      const long long row = wrap(-(iy + (t >> 1)), H);
      float tap[3];
      texel<3>(atlas, n_atlas, row * W + col + off, scale, e5, tap);
#pragma unroll
      for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] + wt[t] * tap[k];
    }
  } else if (mode == FT_MODE_COMP) {
    // the composed thin-film table: (cos row, noise texel), one round
    const long long nH = fi[FT_NH], nW = fi[FT_NW], LH = fi[FT_LH];
    const long long iu = wrap((long long)(u * ff[FT_FREP]), nW);
    const long long iv = wrap((long long)(v * ff[FT_GREP]), nH);
    long long row = (long long)(cos_i * (float)LH);
    row = row < 0 ? 0 : (row > LH - 1 ? LH - 1 : row);
    texel<3>(atlas, n_atlas, (row * nH + wrap(-iv, nH)) * nW + iu + fi[FT_OFF],
             ff[FT_SCALE], fi[FT_E5], rgb);
  } else {
    // past TF_COMP_LIMIT: the noise texel, then the LUT at (cos row,
    // thickness column)
    float noise[1];
    texel<1>(atlas, n_atlas,
             uv_index(u, v, ff[FT_FREP], ff[FT_GREP], fi[FT_W], fi[FT_H])
                 + fi[FT_OFF],
             ff[FT_SCALE], fi[FT_E5], noise);
    const float th = ff[FT_TF_THICK] + ff[FT_TF_NOISE] * (noise[0] - 0.5f);
    const long long W2 = fi[FT_W2], H2 = fi[FT_H2];
    long long row = (long long)(cos_i * (float)H2);
    long long col = (long long)th;
    row = row < 0 ? 0 : (row > H2 - 1 ? H2 - 1 : row);
    col = col < 0 ? 0 : (col > W2 - 1 ? W2 - 1 : col);
    texel<3>(atlas, n_atlas, row * W2 + col + fi[FT_OFF2], ff[FT_SCALE2],
             fi[FT_E5_2], rgb);
  }
}

// |a / b|^2 for complex a, b (pallas_trace.py _cdiv then _cabs2)
__device__ __forceinline__ float cdiv_abs2(float ar, float ai, float br,
                                           float bi) {
  const float d = fmaxf(br * br + bi * bi, F(1e-30));
  const float re = (ar * br + ai * bi) / d;
  const float im = (ai * br - ar * bi) / d;
  return re * re + im * im;
}

// texture uv per object kind from the hit point and the raw normal
// (pallas_record.py:76-148)
__device__ __forceinline__ void uv_of(int kind, const float* g, float px,
                                      float py, float pz, const float nr[3],
                                      float& u, float& v) {
  if (kind == KIND_SPHERE) {
    const float phi = atan2_poly(nr[2], nr[0]);
    const float th = asin_poly(nr[1]);
    u = (phi + F(PI)) / F(2.0 * PI);
    v = (th + F(PI / 2.0)) / F(PI);
  } else if (kind == KIND_PLANE) {
    const float mx = px - g[0], my = py - g[1], mz = pz - g[2];
    const float uu = (g[3] * mx + g[4] * my + g[5] * mz) / g[12];
    const float vv = (g[6] * mx + g[7] * my + g[8] * mz) / g[13];
    u = (uu + 1.0f) / 2.0f + g[14];
    v = (vv + 1.0f) / 2.0f + g[15];
  } else if (kind == KIND_DISC) {
    // planar over the bounding square
    const float mx = px - g[0], my = py - g[1], mz = pz - g[2];
    u = ((g[6] * mx + g[7] * my + g[8] * mz) / g[12] + 1.0f) / 2.0f;
    v = ((g[9] * mx + g[10] * my + g[11] * mz) / g[12] + 1.0f) / 2.0f;
  } else if (kind == KIND_CYL) {
    // side: (azimuth, height); caps: planar
    const float r = g[12], hh = g[13];
    float x, y, z;
    cyl_local(g, px, py, pz, x, y, z);
    const float rho = sqrtf(fmaxf(x * x + z * z, F(1e-20)));
    const bool is_cap = g[14] > 0.5f && fabsf(y) / hh >= rho / r;
    if (is_cap) {
      u = (x / r + 1.0f) / 2.0f;
      v = (z / r + 1.0f) / 2.0f;
    } else {
      u = (atan2_poly(z, x) + F(PI)) / F(2.0 * PI);
      v = (y / hh + 1.0f) / 2.0f;
    }
  } else if (kind == KIND_TRI) {
    // barycentric
    float e1[3], e2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) { e1[i] = g[3 + i] - g[i]; e2[i] = g[6 + i] - g[i]; }
    const float q[3] = {px - g[0], py - g[1], pz - g[2]};
    const float d11 = dot3(e1, e1), d12 = dot3(e1, e2), d22 = dot3(e2, e2);
    const float dp1 = dot3(q, e1), dp2 = dot3(q, e2);
    const float det = fmaxf(d11 * d22 - d12 * d12, F(1e-20));
    u = (d22 * dp1 - d12 * dp2) / det;
    v = (d11 * dp2 - d12 * dp1) / det;
  } else {
    // box: the max-|axis| face, then the cube-cross layout / 4, / 3
    const float mx = px - g[15], my = py - g[16], mz = pz - g[17];
    float pl[3], ap[3], nl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pl[i] = g[3 * i] * mx + g[3 * i + 1] * my + g[3 * i + 2] * mz;
      ap[i] = fabsf(pl[i]) / g[18 + i];
    }
    const float pmax = fmaxf(fmaxf(ap[0], ap[1]), ap[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) nl[i] = pmax == ap[i] ? signf(pl[i]) : 0.0f;
    const float s = F(2.0 * 0.985) / g[18];
    float uc, vc;
    if (nl[0] == 1.0f) uc = (pl[2] * s + 1.0f) / 2.0f + 2.0f;
    else if (nl[0] == -1.0f) uc = (-pl[2] * s + 1.0f) / 2.0f + 0.0f;
    else if (nl[2] == 1.0f) uc = (-pl[0] * s + 1.0f) / 2.0f + 3.0f;
    else uc = (pl[0] * s + 1.0f) / 2.0f + 1.0f;
    if (nl[1] == -1.0f) vc = (-pl[2] * s + 1.0f) / 2.0f + 0.0f;
    else if (nl[1] == 1.0f) vc = (pl[2] * s + 1.0f) / 2.0f + 2.0f;
    else vc = (pl[1] * s + 1.0f) / 2.0f + 1.0f;
    u = uc / 4.0f;
    v = vc / 3.0f;
  }
}

__global__ void __launch_bounds__(K2_BLOCK, K2_MIN_BLOCKS)
record_trace_kernel(RecParams p) {
  EXTERN_SHARED float smem[];
  // ---- scene tables -> shared memory, once per block ----
  float* s_geom = smem;
  float* s_dif = s_geom + p.n_obj * GEOM_COLS;
  float* s_glo = s_dif + p.n_dif * 4;
  float* s_refr = s_glo + p.n_glo * 12;
  float* s_emi = s_refr + p.n_refr * 6;
  float* s_tf = s_emi + p.n_emi * 3;
  float* s_light = s_tf + p.n_tf * 6;
  float* s_is = s_light + p.n_lrow * 11;
  float* s_consts = s_is + p.n_is * 4;
  float* s_cam = s_consts + 16;
  float* s_ff = s_cam + 17;
  int* s_obj = reinterpret_cast<int*>(s_ff + p.n_grp * FT_FCOLS);
  int* s_seed = s_obj + p.n_obj * OBJ_COLS;
  int* s_fi = s_seed + 3;
  __shared__ unsigned int s_count;
  for (int i = threadIdx.x; i < p.n_obj * GEOM_COLS; i += K2_BLOCK) s_geom[i] = p.geom[i];
  for (int i = threadIdx.x; i < p.n_dif * 4; i += K2_BLOCK) s_dif[i] = p.dif[i];
  for (int i = threadIdx.x; i < p.n_glo * 12; i += K2_BLOCK) s_glo[i] = p.glo[i];
  for (int i = threadIdx.x; i < p.n_refr * 6; i += K2_BLOCK) s_refr[i] = p.refr[i];
  for (int i = threadIdx.x; i < p.n_emi * 3; i += K2_BLOCK) s_emi[i] = p.emi[i];
  for (int i = threadIdx.x; i < p.n_tf * 6; i += K2_BLOCK) s_tf[i] = p.tf[i];
  for (int i = threadIdx.x; i < p.n_lrow * 11; i += K2_BLOCK) s_light[i] = p.lights[i];
  for (int i = threadIdx.x; i < p.n_is * 4; i += K2_BLOCK) s_is[i] = p.is_tab[i];
  for (int i = threadIdx.x; i < 16; i += K2_BLOCK) s_consts[i] = p.consts[i];
  for (int i = threadIdx.x; i < 17; i += K2_BLOCK) s_cam[i] = p.cam[i];
  for (int i = threadIdx.x; i < p.n_grp * FT_FCOLS; i += K2_BLOCK) s_ff[i] = p.fetch_f[i];
  for (int i = threadIdx.x; i < p.n_obj * OBJ_COLS; i += K2_BLOCK) s_obj[i] = p.obj[i];
  for (int i = threadIdx.x; i < p.n_grp * FT_ICOLS; i += K2_BLOCK) s_fi[i] = p.fetch_i[i];
  if (threadIdx.x < 3) s_seed[threadIdx.x] = p.seed[threadIdx.x];
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  const int idx = blockIdx.x * K2_BLOCK + threadIdx.x;
  unsigned int my_count = 0;
  if (idx < p.n) {
    const uint32_t seed0 = (uint32_t)s_seed[0];
    float o[3], d[3], sb[3];   // sb: first-bounce R2 draws mix, phi, r2
    const uint32_t counter0 = camera_ray(s_cam, s_seed, idx, p.width, p.height,
                                         p.iid, p.projection, o, d, sb);
    // deterministic Fresnel-split pattern of this sample (pallas_record.py:268)
    const int pattern = p.split_k ? (idx / p.n_pix) & ((1 << p.split_k) - 1) : 0;
    const float* amb = s_consts;
    const float* scene_nre = s_consts + 3;
    const float* scene_nim = s_consts + 6;
    float nre[3], nim[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) { nre[k] = scene_nre[k]; nim[k] = scene_nim[k]; }
    int dcnt = 0, scnt = 0;
    bool alive = true;
    float L[3], beta[3];                  // the path integral so far

    for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
      // this bounce's shading: group word gid | branch_flag << 16 (gid 0:
      // no hit) and [u, v, cos_i, add_base(3), add_texcoef(3),
      // beta_base(3)], what the TPU kernel records
      int word = 0;
      float rf[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) rf[j] = 0.0f;
      if (alive) {
        ++my_count;
        float t, orient;
        int hit_id;
        nearest_hit(s_geom, s_obj, p.n_obj, o, d, t, orient, hit_id);
        const bool hit = !(t >= MISS_THRESHOLD);
        const float px = o[0] + d[0] * t, py = o[1] + d[1] * t, pz = o[2] + d[2] * t;
        float n3[3] = {0.0f, 0.0f, 0.0f};
        if (hit_id >= 0) {
          const float* g = s_geom + hit_id * GEOM_COLS;
          const int* rec = s_obj + hit_id * OBJ_COLS;
          normal_of(rec[OBJ_KIND], g, px, py, pz, n3);
          if (rec[OBJ_UV]) uv_of(rec[OBJ_KIND], g, px, py, pz, n3, rf[0], rf[1]);
        }
        bool new_alive = false;
        if (hit) {
          const int* rec = s_obj + hit_id * OBJ_COLS;
          const int mt = rec[OBJ_MAT_TYPE], slot = rec[OBJ_MAT_SLOT];
          const bool img = rec[OBJ_IMG] != 0;
          const bool split = p.split_k && !rec[OBJ_MC];
          const bool cont_depth = bounce < rec[OBJ_MAX_DEPTH];
          word = rec[OBJ_GID];
          float nv[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) nv[k] = n3[k] * orient;
          const float eps = F(1e-6) * fmaxf(
              1.0f, fmaxf(fabsf(px), fmaxf(fabsf(py), fabsf(pz))));
          const float pp[3] = {px, py, pz};
          // ru(j): the draw j of this bounce, counter counter0 + (6 + n_hu) b
          // + j + 1; the hero-wavelength draw of dispersive group h follows
          // the six at counter0 + (6 + n_hu) b + 7 + h
          const uint32_t cb = counter0 + (6u + (uint32_t)p.n_hu) * (uint32_t)bounce;
#define RU(j) hash_uniform(idx, seed0, cb + (j) + 1u)
          float nd[3] = {d[0], d[1], d[2]};
          float no[3] = {px, py, pz};

          if (mt == MAT_EMISSIVE) {
            // ---- emissive: terminal (pallas_record.py:344) ----
            const float* col = s_emi + slot * 3;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              if (img) rf[6 + k] = 1.0f;
              else rf[3 + k] = col[k];
            }
          } else if (mt == MAT_ENV) {
#pragma unroll
            for (int k = 0; k < 3; ++k) rf[6 + k] = 1.0f;
          } else if (mt == MAT_DIFFUSE) {
            // ---- diffuse + cap importance sampling (pallas_record.py:359) ----
            const float* prm = s_dif + slot * 4;
            const float aw = prm[3];
            const float nu[3] = {px + nv[0] * eps, py + nv[1] * eps, pz + nv[2] * eps};
            float ax_u[3], ax_v[3];
            orthobasis(nv[0], nv[1], nv[2], ax_u, ax_v);
            const bool first = !p.iid && dcnt == 0;   // R2 draws replace the hash
            const float u_phi1 = first ? sb[1] : RU(0);
            const float u_r21 = first ? sb[2] : RU(1);
            const float phi = u_phi1 * F(2.0 * PI);
            const float r2 = u_r21;
            const float zc = sqrtf(fmaxf(1.0f - r2, 0.0f));
            const float xc = cosf(phi) * sqrtf(r2);
            const float yc = sinf(phi) * sqrtf(r2);
            float sd[3], ndl, pdf;
#pragma unroll
            for (int k = 0; k < 3; ++k) sd[k] = ax_u[k] * xc + ax_v[k] * yc + nv[k] * zc;
            const int K = p.n_is;
            if (K > 0) {
              const float u_phi2 = first ? sb[1] : RU(3);
              const float u_r22 = first ? sb[2] : RU(4);
              const float u_mixv = first ? sb[0] : RU(5);
              const int pick = min((int)(RU(2) * (float)K), K - 1);
              float sw[3], scm;
              cap_of(s_is + pick * 4, nu, sw, scm);
              float cu[3], cv[3];
              orthobasis(sw[0], sw[1], sw[2], cu, cv);
              const float phi2 = u_phi2 * F(2.0 * PI);
              const float zq = 1.0f + u_r22 * (scm - 1.0f);
              const float sq = sqrtf(fmaxf(1.0f - zq * zq, 0.0f));
              const float cq = cosf(phi2) * sq, sq2 = sinf(phi2) * sq;
              if (!(u_mixv < aw)) {
#pragma unroll
                for (int k = 0; k < 3; ++k) sd[k] = cu[k] * cq + cv[k] * sq2 + sw[k] * zq;
              }
              ndl = clip01(sd[0] * nv[0] + sd[1] * nv[1] + sd[2] * nv[2]);
              float pdf_cap = 0.0f;
              for (int kk = 0; kk < K; ++kk) {
                float w[3], cm;
                cap_of(s_is + kk * 4, nu, w, cm);
                const float cosk = sd[0] * w[0] + sd[1] * w[1] + sd[2] * w[2];
                pdf_cap = pdf_cap + (cosk > cm ? 1.0f / ((1.0f - cm) * 2.0f * F(PI))
                                               : 0.0f);
              }
              pdf = aw * (ndl / F(PI)) + (1.0f - aw) * pdf_cap / (float)K;
            } else {
              ndl = clip01(sd[0] * nv[0] + sd[1] * nv[1] + sd[2] * nv[2]);
              pdf = ndl / F(PI);
            }
            const float w = ndl / fmaxf(pdf, F(1e-9)) / F(PI);
            if (dcnt < 2) {
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                rf[9 + k] = img ? w : prm[k] * w;
                nd[k] = sd[k];
                no[k] = nu[k];
              }
              new_alive = true;
              ++dcnt;
            }
          } else if (mt == MAT_REFRACTIVE) {
            // ---- refractive (pallas_record.py:442-543) ----
            const float* prm = s_refr + slot * 6;
            const float cos_i = -(d[0] * nv[0] + d[1] * nv[1] + d[2] * nv[2]);
            const bool entering = orient > 0.0f;
            float Fr[3], T[3], n2r[3], n2i[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const float n1r = nre[k], n1i = nim[k];
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
              const float r_per = cdiv_abs2(ar - btr, ai - bti, ar + btr, ai + bti);
              const float r_par = cdiv_abs2(bbr - atr, bbi - ati, atr + bbr, ati + bbi);
              Fr[k] = (r_per + r_par) * 0.5f;
              T[k] = 1.0f - Fr[k];
            }
            float rat[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) rat[k] = nre[k] / fmaxf(n2r[k], F(1e-9));
            float ratio_avg = (rat[0] + rat[1] + rat[2]) / 3.0f;
            // dispersion (pallas_record.py:470-482): transmitted paths
            // refract at one uniformly chosen channel's IoR, that channel
            // carrying 3x
            const int hu_g = rec[OBJ_HU2];
            int hero = -1;
            if (hu_g >= 0) {
              const float hu = hash_uniform(idx, seed0, cb + 7u + (uint32_t)hu_g);
              hero = hu < F(1.0 / 3.0) ? 0 : (hu < F(2.0 / 3.0) ? 1 : 2);
              ratio_avg = rat[hero];
            }
            const float sin2t = ratio_avg * ratio_avg * (1.0f - cos_i * cos_i);
            const bool non_tir = sin2t <= 1.0f;
            const float croot = sqrtf(1.0f - clip01(sin2t));
            const float T_avg = (T[0] + T[1] + T[2]) / 3.0f;
            const float p_refr = non_tir ? clip01(T_avg) : 0.0f;
            bool take = RU(0) < p_refr && non_tir;
            bool cont = cont_depth;
            bool det = false;
            if (split) {
              // deterministic branch from the pattern bit, weight 2F / 2T
              det = scnt < p.split_k;
              const bool bit = ((pattern >> scnt) & 1) == 1;
              take = det ? (bit && non_tir) : take;
              cont = cont && !(det && bit && !non_tir);
            }
            if (cont) {
              if (det) ++scnt;
              const float lam_c[3] = {F(2.0 * PI / 630.0), F(2.0 * PI / 550.0),
                                      F(2.0 * PI / 475.0)};
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                const float absorb = expf(-2.0f * nim[k] * lam_c[k] * F(1e9) * t);
                float w_r = det ? 2.0f * T[k] : T[k] / fmaxf(p_refr, F(1e-9));
                if (hero >= 0) w_r = w_r * (k == hero ? 3.0f : 0.0f);
                const float w_l = det ? 2.0f * Fr[k]
                                      : Fr[k] / fmaxf(1.0f - p_refr, F(1e-9));
                rf[9 + k] = absorb * (take ? w_r : w_l);
              }
              if (take) {
#pragma unroll
                for (int k = 0; k < 3; ++k)
                  nd[k] = d[k] * ratio_avg + nv[k] * (ratio_avg * cos_i - croot);
                normalize3(nd[0], nd[1], nd[2]);
#pragma unroll
                for (int k = 0; k < 3; ++k) { nre[k] = n2r[k]; nim[k] = n2i[k]; }
              } else {
                reflect(d, nv, nd);
              }
              const float sgn = take ? -1.0f : 1.0f;
#pragma unroll
              for (int k = 0; k < 3; ++k) no[k] = pp[k] + nv[k] * eps * sgn;
              new_alive = true;
            }
          } else if (mt == MAT_THINFILM) {
            // ---- thin film: branch choice; F / T deferred to the replay
            // (pallas_record.py:545-589) ----
            const float* c = s_tf + slot * 6;
            const float cos_i = clip01(-(d[0] * nv[0] + d[1] * nv[1] + d[2] * nv[2]));
            const float q = fminf(fmaxf(((c[0] * cos_i + c[1]) * cos_i + c[2]) * cos_i
                                        + c[3], F(0.05)), F(0.95));
            bool refl = RU(0) < q;
            float w_sel = refl ? 1.0f / q : 1.0f / (1.0f - q);
            bool det = false;
            if (split) {
              det = scnt < p.split_k;
              const bool bit = ((pattern >> scnt) & 1) == 1;
              refl = det ? bit : refl;
              w_sel = det ? 2.0f : w_sel;
            }
            rf[2] = cos_i;
            word = word | (refl ? 1 << 16 : 0);
            if (cont_depth) {
              if (det) ++scnt;
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                rf[6 + k] = amb[k];
                rf[9 + k] = w_sel;
              }
              if (refl) reflect(d, nv, nd);
              const float sgn = refl ? 1.0f : -1.0f;
#pragma unroll
              for (int k = 0; k < 3; ++k) no[k] = pp[k] + nv[k] * eps * sgn;
              new_alive = true;
            }
          } else if (mt == MAT_GLOSSY) {
            // ---- glossy: ambient + Lambert + Blinn-Phong over the lights,
            // shadow rays, the Fresnel mirror continuation
            // (pallas_record.py:591-684) ----
            const float* prm = s_glo + slot * 12;
            const float rough = prm[9], spec_c = prm[10], diff_c = prm[11];
            const float vv[3] = {-d[0], -d[1], -d[2]};
            const float nu[3] = {px + nv[0] * eps, py + nv[1] * eps, pz + nv[2] * eps};
            float lam_acc[3], spec_acc[3] = {0.0f, 0.0f, 0.0f}, F0[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              lam_acc[k] = amb[k] * diff_c;
              const float dr = nre[k] - prm[3 + k], di = nim[k] - prm[6 + k];
              const float sr = nre[k] + prm[3 + k], si = nim[k] + prm[6 + k];
              F0[k] = (dr * dr + di * di) / fmaxf(sr * sr + si * si, F(1e-20));
            }
            const float rm = fmaxf(rough, F(1e-6));
            const float a_ph = 2.0f / (rm * rm) - 2.0f;
            const int n_lights = p.n_dir + p.n_point + p.n_spot;
            for (int li = 0; li < n_lights; ++li) {
              float lv[3], see, p5, sw;
              light_terms(s_light + li * 11, li >= p.n_dir, li >= p.n_dir + p.n_point,
                          pp, nu, nv, vv, rough, a_ph, spec_c, s_geom, s_obj,
                          p.n_obj, lv, see, p5, sw);
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                lam_acc[k] = lam_acc[k] + diff_c * lv[k] * see;
                spec_acc[k] = spec_acc[k] + (F0[k] + (1.0f - F0[k]) * p5) * sw * lv[k];
              }
            }
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              if (img) {
                rf[6 + k] = lam_acc[k];
                rf[3 + k] = spec_acc[k];
              } else {
                rf[3 + k] = prm[k] * lam_acc[k] + spec_acc[k];
              }
            }
            if (cont_depth) {
              const float p5r = pow5(1.0f - clip01(dot3(vv, nv)));
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                const float dr = scene_nre[k] - prm[3 + k], di = scene_nim[k] - prm[6 + k];
                const float sr = scene_nre[k] + prm[3 + k], si = scene_nim[k] + prm[6 + k];
                const float F0s = (dr * dr + di * di) / fmaxf(sr * sr + si * si, F(1e-20));
                rf[9 + k] = F0s + (1.0f - F0s) * p5r;
                no[k] = nu[k];
              }
              reflect(d, nv, nd);
              new_alive = true;
            }
          }
#undef RU
          if (new_alive) {
#pragma unroll
            for (int k = 0; k < 3; ++k) { o[k] = no[k]; d[k] = nd[k]; }
          }
        }
        if (!new_alive) alive = false;
      }
      // ---- the hit's texels, and this bounce's step of the integral
      // (replay.py:214-255): the group's gid selects the fetch wherever
      // the ray hit, its shading skipped or not ----
      const int gid = word & 0xFFFF;
      float m_add[3], m_beta[3];
      if (gid > 0) {
        float tex[3] = {1.0f, 1.0f, 1.0f}, btex[3] = {1.0f, 1.0f, 1.0f};
        const int* fi = s_fi + gid * FT_ICOLS;
        const int use = fi[FT_USE];
        if (use != FT_USE_NONE) {
          float rgb[3];
          group_texels(fi, s_ff + gid * FT_FCOLS, p.atlas, p.n_atlas, rf[0],
                       rf[1], rf[2], bounce, rgb);
          const bool refl = ((word >> 16) & 1) == 1;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            if (use == FT_USE_BETA) {
              btex[k] = rgb[k];
            } else {
              tex[k] = rgb[k];
              if (use == FT_USE_FILM) btex[k] = refl ? rgb[k] : 1.0f - rgb[k];
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          m_add[k] = rf[3 + k] + rf[6 + k] * tex[k];
          m_beta[k] = rf[9 + k] * btex[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) { m_add[k] = 0.0f; m_beta[k] = 1.0f; }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (bounce == 0) {
          L[k] = m_add[k];
          beta[k] = m_beta[k];
        } else {
          L[k] = L[k] + beta[k] * m_add[k];
          beta[k] = beta[k] * m_beta[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) p.L[3 * (size_t)idx + k] = L[k];
  }

  // ---- rays traced: warp sums, one shared add per warp, one global add ----
  for (int off = 16; off > 0; off >>= 1)
    my_count += __shfl_down_sync(0xffffffffu, my_count, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_count, my_count);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p.count, (unsigned long long)s_count);
}

}  // namespace

static size_t record_trace_smem(int n_obj, int n_dif, int n_glo, int n_refr,
                                int n_emi, int n_tf, int n_lrow, int n_is,
                                int n_grp) {
  return sizeof(float) * ((size_t)n_obj * (GEOM_COLS + OBJ_COLS)
                          + (size_t)n_dif * 4 + (size_t)n_glo * 12
                          + (size_t)n_refr * 6 + (size_t)n_emi * 3
                          + (size_t)n_tf * 6 + (size_t)n_lrow * 11
                          + (size_t)n_is * 4 + 16 + 17 + 3
                          + (size_t)n_grp * (FT_ICOLS + FT_FCOLS));
}

// The kernel as built and as the card holds it: out[0..6] = registers a
// thread, local memory bytes a thread (stack and spills), blocks per SM
// at `smem` bytes of dynamic shared memory (opted in past 48 KB), the SM
// count, K2_BLOCK, K2_MIN_BLOCKS, and the card's opt-in maximum of
// dynamic shared memory a block.
extern "C" int record_trace_info(int smem, int* out) {
  cudaFuncAttributes attr;
  int dev = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, record_trace_kernel);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[6], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess) err = smem_opt_in(record_trace_kernel, (size_t)smem, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], record_trace_kernel,
                                                        K2_BLOCK, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[4] = K2_BLOCK;
  out[5] = K2_MIN_BLOCKS;
  return 0;
}

// L: (spp * width * height, 3) radiance; count: rays traced, zeroed by the
// caller on the launch's stream.
extern "C" int record_trace_launch(
    const int* seed, const float* cam, const float* geom, const int* obj,
    int n_obj, const float* dif, int n_dif, const float* glo, int n_glo,
    const float* refr, int n_refr, const float* emi, int n_emi,
    const float* tf, int n_tf, const float* lights, int n_lrow, int n_dir,
    int n_point, int n_spot, const float* is_tab, int n_is,
    const float* consts, const int* fetch_i, const float* fetch_f, int n_grp,
    const int* atlas, long long n_atlas, int width, int height, int spp,
    int max_bounces, int iid, int split_k, int projection, int n_hu, float* L,
    long long* count, void* stream) {
  RecParams p;
  p.seed = seed; p.cam = cam; p.geom = geom; p.obj = obj;
  p.dif = dif; p.glo = glo; p.refr = refr; p.emi = emi; p.tf = tf;
  p.lights = lights; p.is_tab = is_tab; p.consts = consts;
  p.fetch_i = fetch_i; p.fetch_f = fetch_f; p.atlas = atlas;
  p.n_atlas = n_atlas;
  p.n_obj = n_obj; p.n_dif = n_dif; p.n_glo = n_glo; p.n_refr = n_refr;
  p.n_emi = n_emi; p.n_tf = n_tf; p.n_lrow = n_lrow; p.n_is = n_is;
  p.n_grp = n_grp;
  p.n_dir = n_dir; p.n_point = n_point; p.n_spot = n_spot;
  p.width = width; p.height = height; p.n_pix = width * height;
  p.n = spp * p.n_pix;
  p.max_bounces = max_bounces; p.iid = iid; p.split_k = split_k;
  p.projection = projection; p.n_hu = n_hu;
  p.L = L;
  p.count = reinterpret_cast<unsigned long long*>(count);
  const size_t smem = record_trace_smem(n_obj, n_dif, n_glo, n_refr, n_emi,
                                        n_tf, n_lrow, n_is, n_grp);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = smem_opt_in(record_trace_kernel, smem, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = (p.n + K2_BLOCK - 1) / K2_BLOCK;
  LAUNCH(record_trace_kernel, grid, K2_BLOCK, smem,
         static_cast<cudaStream_t>(stream), p);
  return (int)cudaGetLastError();
}
