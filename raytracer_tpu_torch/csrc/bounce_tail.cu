// W6: the wavefront's bounce tail for Hopper (sm_90a).
//
// Replaces two stages of the JAX package's wavefront bounce
// (raytracer_tpu/core/integrator.py `trace`, :239-310): the start of the
// merged shading output with the emissive and environment blocks merged
// into it (raytracer_tpu/materials/shade.py:51 `default_shade_out`, :130
// `_slot_color`, :176 `shade_emissive`, :190 `shade_env`, the merges at
// integrator.py:239-287), and the radiance, throughput and carry update
// (integrator.py:289-310).  Neither has a Pallas kernel: they are jnp,
// which XLA fuses into the bounce's loops on the TPU.  Eager torch cannot
// fuse them, so the port's plain versions (ops/bounce_tail.py
// `plain_start`, `plain_update`) make ~45 launches a bounce, each a pass
// over device memory: on Cornell rendered on the wavefront the update
// took ~185 ms and the emissive merges ~141 ms of a frame's 1.03 s of
// device time (PERF.md).  Here each stage is one launch, one thread a ray.
// The wrappers are in ops/bounce_tail.py.
//
// `bounce_start` writes every field of the bounce's merged output (ops/
// wavefront_shade.py `Merged`) into fresh tensors: no emission, unit
// throughput, the ray as it came (P, D and the medium copied; a medium
// every ray shares read as its one row), no continuation.  Those are also
// the emissive and environment blocks' own fields (materials/shade.py
// `default_shade_out`) and their rays are no other block's, so merging the
// two blocks changes `add` on their rays only: an emissive ray's is its
// slot's colour (the solid table, the slot clamped, or the slot's image
// texture), an environment ray's its texel, plus light_intensity x the
// lightmap's texel past the camera's ray (depth != 0).  The image
// textures come as W4 reads them (ops/wavefront_shade.py
// `texture_tables`): one flat texel buffer and a descriptor a slot, read
// by W4's own fetch (csrc/texture_fetch.cuh `fetch_texture`,
// `slot_color`).  Each ray's `add` is made once, by its own thread, and
// handed through shared memory to the threads that write its tile's rows.
// W4 then writes its blocks' rays into the output in place.
//
// `bounce_update` reads the carry (L, beta, alive, the ray, the medium,
// the path counters) and the merged output and writes the next carry out
// of place: shaded = alive & !miss; L + (shaded ? beta * add : 0);
// alive' = shaded & cont; where alive', beta * beta_mult, the new ray and
// medium, else the old; depth + alive', diffuse_refl + (alive' &
// is_diffuse), split_cnt + (shaded & did_split).  With a count it adds the
// bounce's alive rays to rays_traced: each block's count is added to a
// 64-bit sum in a scratch word, and the last block to finish (a ticket
// beside it) writes rays_traced + that sum and zeroes both for the next
// launch.  Integers add in any order to the same sum.
//
// Arithmetic is the plain versions', operation by operation, as torch
// computes each op (the library is built with --fmad=false): one rounding
// a product or a sum, the texture fetch's float -> int32 truncation,
// floored modulo and wrapping int32 arithmetic as csrc/texture_fetch.cuh
// restates them,
// where() as a select (NaN and -0 carried as they are), `c + 0.0f` kept
// where the plain block adds a where() of 0.0 (it turns -0 into +0).  The
// CPU's torch rounds these ops the same way, so the CPU stand-in build
// (csrc/emu) needs no variant but the backward's torch.sum over three,
// which it takes in the CPU's order under W6_TORCH_CPU.
//
// What bounds both: memory.  The start reads a ray's word, P, D (and its
// medium, unless shared) and writes 75 bytes; the update reads 86-125
// bytes a ray (more as the ray is shaded and goes on) and writes 85.
// Their arithmetic is a few tens of issue slots a ray.
//
// The backward passes (`bounce_update_bwd`, `bounce_start_bwd`, below):
// the vector-Jacobian products of the two stages, as the JAX package's
// jax.grad takes them (raytracer_tpu/diff.py) and XLA fuses them; each one
// launch, in the same tiles, bounded by memory (the update's a few where()s
// and products an element: it reads up to 6 gradients and 3 saved rows a
// ray and writes up to 12; the start's where() chains, plus a bilinear
// emissive texture's uv gradient and the light intensity's rows a ray).
//
// Every entry returns cudaGetLastError() after its launch and reports the
// kernels it launched.

#include <cuda_runtime.h>

#include <math.h>

#include "texture_fetch.cuh"

#ifndef CUDA_EMU
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace w6 {

using namespace texture_fetch;

constexpr int TAIL_BLOCK = 256;       // threads a block
constexpr int MAT_EMISSIVE = 1, MAT_ENV = 6;
constexpr int SLOT_SHIFT = 3;

// ---------------------------------------------------------------------------
// bounce_start: the merged output with the emissive and environment blocks
// ---------------------------------------------------------------------------

// The bounce's rays ((N, 3) float32 rows unless said) and the merged
// output's fields, each a contiguous tensor the wrapper made.
struct Start {
  const int* packed;          // (N,) the object's packed material word
  const float* P;             // hit points
  const float* D;             // directions
  const float* uv;            // (N, 2), read where a texture is fetched
  const float* n_re;          // current medium, rows re_step floats apart
  const float* n_im;          // rows im_step floats apart
  long long re_step;          // 3, or 0 for one medium shared by every ray
  long long im_step;
  const int* depth;           // (N,) int32, read where a lightmap is added
  long long n;
  // the emissive block, where present: its slots' colours (em_rows, 3) and
  // image textures
  int emissive;
  const float* em_color;
  int em_rows;
  Textures em_tex;
  // the environment block, where present: a descriptor an environment slot
  // (env_rows of them) of its display texture and of its lightmap (flags 0
  // where it has none), and its slots' light intensity (env_rows,)
  int env;
  Textures env_tex;
  Textures env_lm;
  const float* env_li;
  int env_rows;
  // the merged output
  float* add;
  float* beta_mult;
  float* new_origin;
  float* new_dir;
  float* new_n_re;
  float* new_n_im;
  unsigned char* cont;
  unsigned char* is_diffuse;
  unsigned char* did_split;
};

// materials/shade.py shade_env: the environment slot's texel (repeat 1,
// nearest), plus light_intensity x the lightmap's where depth != 0; zero
// for a slot no environment names
__device__ __forceinline__ void env_color(const Start& S, long long i, int slot,
                                          float* c) {
  c[0] = c[1] = c[2] = 0.0f;
  if (slot < 0 || slot >= S.env_rows || !(S.env_tex.desc_i[4 * slot + 3] & 1)) return;
  const float u = S.uv[2 * i], v = S.uv[2 * i + 1];
  fetch_texture(S.env_tex, slot, u, v, c);
  if (S.env_lm.desc_i == nullptr || !(S.env_lm.desc_i[4 * slot + 3] & 1)) return;
  // the lightmap's texel is read past the camera's bounce only: the
  // where() gives 0 at depth 0, whatever the texel
  const bool past = S.depth[i] != 0;
  float li = 0.0f, lm[3] = {0.0f, 0.0f, 0.0f};
  if (past) {
    li = S.env_li[slot];
    fetch_texture(S.env_lm, slot, u, v, lm);
  }
  for (int k = 0; k < 3; ++k) c[k] = c[k] + (past ? li * lm[k] : 0.0f);
}

// The rays in tiles of TAIL_BLOCK, grid-stride: in each tile each ray's
// own fields (ray(i, t): ray i, thread t of the block), then the (N, 3)
// rows' 3 x TAIL_BLOCK floats element by element, neighbouring threads on
// neighbouring floats (each warp's loads and stores then fill whole
// sectors, where a thread a ray strides them 12 bytes apart; element(i, k,
// t): component k of ray i, the ray of thread t).  With kHanded the block
// syncs between the two passes (a ray's pass hands its elements their
// values through shared memory) and after them (the next tile's rays
// overwrite them).
template <bool kHanded, class Ray, class Element>
__device__ __forceinline__ void by_tiles(long long n, Ray ray, Element element) {
  const long long stride = (long long)gridDim.x * TAIL_BLOCK;
  for (long long r0 = (long long)blockIdx.x * TAIL_BLOCK; r0 < n; r0 += stride) {
    const long long i = r0 + threadIdx.x;
    if (i < n) ray(i, (int)threadIdx.x);
    if (kHanded) __syncthreads();
    for (int c = 0; c < 3; ++c) {
      const int local = c * TAIL_BLOCK + (int)threadIdx.x;
      const long long j = r0 + local / 3;
      if (j < n) element(j, local % 3, local / 3);
    }
    if (kHanded) __syncthreads();
  }
}

// ray i's `add`: its emissive slot's colour or its environment's, else 0
__device__ __forceinline__ void start_add(const Start& S, long long i, float* a) {
  const int word = __ldg(S.packed + i);
  const int type = word & 0x7, slot = (word >> SLOT_SHIFT) & 0x3FF;
  a[0] = a[1] = a[2] = 0.0f;
  if (S.emissive && type == MAT_EMISSIVE) {
    slot_color(S.em_color, S.em_rows, S.em_tex, slot, S.uv[2 * i], S.uv[2 * i + 1], a);
  } else if (S.env && type == MAT_ENV) {
    env_color(S, i, slot, a);
  }
}

// component k of ray i's float fields, its `add` component given
__device__ __forceinline__ void start_element(const Start& S, long long i, int k,
                                              float add) {
  const long long j = 3 * i + k;
  S.add[j] = add;
  S.beta_mult[j] = 1.0f;
  S.new_origin[j] = __ldg(S.P + j);
  S.new_dir[j] = __ldg(S.D + j);
  S.new_n_re[j] = __ldg(S.n_re + S.re_step * i + k);
  S.new_n_im[j] = __ldg(S.n_im + S.im_step * i + k);
}

__global__ void __launch_bounds__(TAIL_BLOCK)
bounce_start_kernel(Start S) {
  __shared__ float adds[TAIL_BLOCK][3];
  by_tiles<true>(
      S.n,
      [&](long long i, int t) {
        start_add(S, i, adds[t]);
        S.cont[i] = 0;
        S.is_diffuse[i] = 0;
        S.did_split[i] = 0;
      },
      [&](long long i, int k, int t) { start_element(S, i, k, adds[t][k]); });
}

// ---------------------------------------------------------------------------
// bounce_update: the radiance, throughput and carry update
// ---------------------------------------------------------------------------

// The carry and the merged output ((N, 3) float32 rows, (N,) bool and
// int32 unless said), and the next carry, each a contiguous tensor the
// wrapper made.
struct Update {
  const float* L;
  const float* beta;
  const unsigned char* alive;
  const unsigned char* miss;
  const float* add;
  const float* beta_mult;
  const float* new_origin;
  const float* new_dir;
  const float* new_n_re;
  const float* new_n_im;
  const unsigned char* cont;
  const unsigned char* is_diffuse;
  const unsigned char* did_split;
  const float* O;
  const float* D;
  const float* n_re;          // the carried medium, rows re_step floats apart
  const float* n_im;
  long long re_step;          // 3, or 0 for one medium shared by every ray
  long long im_step;
  const int* depth;
  const int* diffuse_refl;
  const int* split_cnt;
  const long long* traced;    // () rays traced so far, or null: no count
  long long n;
  float* L_out;
  float* beta_out;
  unsigned char* alive_out;
  float* O_out;
  float* D_out;
  float* n_re_out;
  float* n_im_out;
  int* depth_out;
  int* diffuse_out;
  int* split_out;
  long long* traced_out;      // () rays_traced + the bounce's alive rays
  // with a count: (the blocks' 64-bit sum, their ticket), zero between
  // launches (the last block zeroes them)
  unsigned long long* scratch;
};

// ray i's fate this bounce: alive at its start, shaded (alive and a hit),
// going on (shaded and its block continues it)
struct Fate {
  bool alive, shaded, next;
};
__device__ __forceinline__ Fate fate(const Update& U, long long i) {
  const bool alive = __ldg(U.alive + i) != 0;
  const bool shaded = alive && __ldg(U.miss + i) == 0;
  return {alive, shaded, shaded && __ldg(U.cont + i) != 0};
}

// component k of ray i's float fields
__device__ __forceinline__ void update_element(const Update& U, long long i, int k) {
  const Fate f = fate(U, i);
  const bool shaded = f.shaded, next = f.next;
  const long long j = 3 * i + k;
  const float b = __ldg(U.beta + j);
  U.L_out[j] = __ldg(U.L + j) + (shaded ? b * __ldg(U.add + j) : 0.0f);
  U.beta_out[j] = next ? b * __ldg(U.beta_mult + j) : b;
  U.O_out[j] = next ? __ldg(U.new_origin + j) : __ldg(U.O + j);
  U.D_out[j] = next ? __ldg(U.new_dir + j) : __ldg(U.D + j);
  U.n_re_out[j] = next ? __ldg(U.new_n_re + j) : __ldg(U.n_re + U.re_step * i + k);
  U.n_im_out[j] = next ? __ldg(U.new_n_im + j) : __ldg(U.n_im + U.im_step * i + k);
}

// ray i's own fields; returns whether it was alive (counted in rays_traced)
__device__ __forceinline__ bool update_ray(const Update& U, long long i) {
  const Fate f = fate(U, i);
  const bool alive = f.alive, shaded = f.shaded, next = f.next;
  U.alive_out[i] = next;
  U.depth_out[i] = wrap_add(__ldg(U.depth + i), next ? 1 : 0);
  U.diffuse_out[i] = wrap_add(__ldg(U.diffuse_refl + i),
                              next && __ldg(U.is_diffuse + i) != 0 ? 1 : 0);
  U.split_out[i] = wrap_add(__ldg(U.split_cnt + i),
                            shaded && __ldg(U.did_split + i) != 0 ? 1 : 0);
  return alive;
}

__global__ void __launch_bounds__(TAIL_BLOCK)
bounce_update_kernel(Update U) {
  __shared__ unsigned long long block_alive;
  unsigned long long mine = 0;
  by_tiles<false>(
      U.n, [&](long long i, int) { mine += update_ray(U, i) ? 1ull : 0ull; },
      [&](long long i, int k, int) { update_element(U, i, k); });
  if (U.traced == nullptr) return;
  if (threadIdx.x == 0) block_alive = 0;
  __syncthreads();
  if (mine) atomicAdd(&block_alive, mine);
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long* sum = U.scratch;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(U.scratch + 1);
  atomicAdd(sum, block_alive);
  __threadfence();
  if (atomicAdd(ticket, 1u) != gridDim.x - 1) return;
  // the last block: every other block's sum is in
  const unsigned long long total = atomicAdd(sum, 0ull);
  *U.traced_out = *U.traced + (long long)total;
  *sum = 0;
  *ticket = 0;
}

// ---------------------------------------------------------------------------
// the backward passes: the vector-Jacobian products of the plain stages
// ---------------------------------------------------------------------------
//
// Each restates what autograd computes for `plain_update` / `plain_start`
// (ops/plain_grad.py `plain_vjp`), op by op with ATen's derivative
// formulas: a where() hands its gradient to the branch it took and +0 to
// the other; a product a * b gives g * b to a and g * a to b; a sum passes
// g on; a broadcast factor takes torch.sum of its products over the
// broadcast dimension.  Where a tensor feeds several ops, its gradient is
// the sum of their contributions in the order autograd's engine adds them
// into its input buffer: the engine runs the ready node created last
// first, so the contributions come in the reverse of the forward's order,
// the first one stored as it is (not added to 0: -0 stays -0).  That
// order is the graph's, the same on the CPU and on the card.  A gradient
// the plain VJP leaves undefined (no output gradient reaches the input)
// is a null pointer here and is written by no one.

// torch.sum over a last dimension of 3 (a (N, 1) factor's gradient from
// its (N, 3) product): ATen's order on the card, the CPU's with
// W6_TORCH_CPU (the CPU tests' build)
__device__ __forceinline__ float tsum3(float x0, float x1, float x2) {
#ifdef W6_TORCH_CPU
  return ((0.0f + x0) + x1) + x2;
#else
  return ((0.0f + x0) + (0.0f + x2)) + (0.0f + x1);
#endif
}
// tsum3 as a functor, for the texture fetch's bilinear backward
struct Sum3 {
  __device__ __forceinline__ float operator()(float x0, float x1, float x2) const {
    return tsum3(x0, x1, x2);
  }
};

// The update's backward: the gradients of the next carry's floats (null
// where none comes), the forward's throughput, add and beta_mult rows and
// its masks; the gradients of the update's float inputs (null where not
// wanted).
struct UpdateBwd {
  const float *gL, *gbeta, *gO, *gD, *gn_re, *gn_im;
  const float *beta, *add, *beta_mult;
  const unsigned char *alive, *miss, *cont;
  long long n;
  float *dL, *dbeta, *dadd, *dbeta_mult;
  float *dnew_origin, *dO, *dnew_dir, *dD, *dnew_n_re, *dn_re, *dnew_n_im, *dn_im;
};

// where(m, x, y)'s backward of g into its two branches
__device__ __forceinline__ void where_bwd(const float* g, long long j, bool m,
                                          float* then_, float* else_) {
  if (!g) return;
  const float x = g[j];
  if (then_) then_[j] = m ? x : 0.0f;
  if (else_) else_[j] = m ? 0.0f : x;
}

// component k of ray i: plain_update's
//   L' = L + where(shaded, beta * add, 0)        (nodes 1-3)
//   beta' = where(alive', beta * beta_mult, beta) (nodes 4-5)
//   O', D', n_re', n_im' = where(alive', new, old)
// backward.  beta's three contributions come as the engine runs nodes 5,
// 4 then 1: the where's else branch, then beta_mult's product, then add's.
__device__ __forceinline__ void update_bwd_element(const UpdateBwd& B, long long i,
                                                   int k) {
  const bool alive = B.alive[i] != 0;
  const bool shaded = alive && B.miss[i] == 0;
  const bool next = shaded && B.cont[i] != 0;
  const long long j = 3 * i + k;
  const float b = B.beta[j];
  float gp = 0.0f, gq = 0.0f, v = 0.0f;
  bool has = false;
  if (B.gL) {
    if (B.dL) B.dL[j] = B.gL[j];
    gp = shaded ? B.gL[j] : 0.0f;
    if (B.dadd) B.dadd[j] = gp * b;
  }
  if (B.gbeta) {
    const float g = B.gbeta[j];
    gq = next ? g : 0.0f;
    if (B.dbeta_mult) B.dbeta_mult[j] = gq * b;
    v = (next ? 0.0f : g) + gq * B.beta_mult[j];
    has = true;
  }
  if (B.dbeta) {
    if (B.gL) {
      const float t = gp * B.add[j];
      v = has ? v + t : t;
    }
    B.dbeta[j] = v;
  }
  where_bwd(B.gO, j, next, B.dnew_origin, B.dO);
  where_bwd(B.gD, j, next, B.dnew_dir, B.dD);
  where_bwd(B.gn_re, j, next, B.dnew_n_re, B.dn_re);
  where_bwd(B.gn_im, j, next, B.dnew_n_im, B.dn_im);
}

__global__ void __launch_bounds__(TAIL_BLOCK)
bounce_update_bwd_kernel(UpdateBwd B) {
  by_tiles<false>(
      B.n, [&](long long, int) {},
      [&](long long i, int k, int) { update_bwd_element(B, i, k); });
}

// The start's backward.  The gradients of the merged output's float
// fields that take one (add, new_origin, new_dir, new_n_re, new_n_im; null
// where none comes) and the forward's mat_type, mat_slot and depth (N,)
// int32 and uv (N, 2); which merges plain_start made (em: the emissive
// block's, env: the environment's); the emissive image textures, a
// descriptor row a ref of SceneStatic.emissive_tex in its order
// (em_ref_slot: each ref's slot) and the environment slots, a row each in
// SceneStatic.env_slots order (env_slot: each one's slot; env_lm: the
// lightmap descriptors, flags 0 where a slot has none; env_lm_row: the row
// of li_rows it writes, -1 without a lightmap).  Writes (null where not
// wanted) the gradients of P, D, the medium and uv, and the per-ray rows
// that the two tables' gathers (core/safemath.py `take`) hand their
// backward: em_rows (N, 3) of the emissive colours, li_rows (lightmaps, N)
// of the light intensity, one row a gather.  Where a texture the start
// reads takes a gradient, `taps` (texture_fetch.cuh `tap_rows`): every
// emissive ref's taps' planes in order, then an environment's display
// texture's tap (env_disp: its descriptor a row an environment, nearest,
// repeat 1) and its lightmap's (that tap's gradient where(depth != 0, g,
// 0) times the slot's light intensity, env_li (env_rows,)), environments
// in order.
struct StartBwd {
  const float *g_add, *g_origin, *g_dir, *g_n_re, *g_n_im;
  const int *mat_type, *mat_slot, *depth;
  const float* uv;
  long long n;
  int em, env;
  int em_refs;
  const int* em_ref_slot;
  Textures em_ref_tex;
  int env_slots;
  const int *env_slot, *env_lm_row;
  Textures env_lm;
  float *dP, *dD, *dn_re, *dn_im, *duv, *em_rows, *li_rows;
  Textures env_disp;
  const float* env_li;
  int env_rows;
  TapRows taps;
};

// The merges' backward of one field's gradient g into the ray as it came
// (P, D or the medium): plain_start takes `Merged.start`'s copy, merges
// the emissive block (whose field is the same input) where m_em, then the
// environment's where m_env; the engine runs the last where first, so the
// input takes where(m_env, g, 0), then where(m_em, g', 0) with g' the
// first where's else branch, then the copy's g'' (the second's).
__device__ __forceinline__ float merges_bwd(const StartBwd& S, bool m_em, bool m_env,
                                            float g) {
  float v = 0.0f, cur = g;
  bool has = false;
  if (S.env) {
    v = m_env ? cur : 0.0f;
    cur = m_env ? 0.0f : cur;
    has = true;
  }
  if (S.em) {
    const float t = m_em ? cur : 0.0f;
    v = has ? v + t : t;
    cur = m_em ? 0.0f : cur;
    has = true;
  }
  return has ? v + cur : cur;
}

// the add gradient's share the emissive block's colour takes: the
// environment merge's else branch, then the emissive merge's then branch
__device__ __forceinline__ float em_share(const StartBwd& S, bool m_em, bool m_env,
                                          float g) {
  const float a = S.env ? (m_env ? 0.0f : g) : g;
  return m_em ? a : 0.0f;
}

// component k of ray i's P, D, medium and emissive row
__device__ __forceinline__ void start_bwd_element(const StartBwd& S, long long i,
                                                  int k) {
  const long long j = 3 * i + k;
  const int type = S.mat_type[i];
  const bool m_em = S.em && type == MAT_EMISSIVE, m_env = S.env && type == MAT_ENV;
  if (S.dP) S.dP[j] = merges_bwd(S, m_em, m_env, S.g_origin[j]);
  if (S.dD) S.dD[j] = merges_bwd(S, m_em, m_env, S.g_dir[j]);
  if (S.dn_re) S.dn_re[j] = merges_bwd(S, m_em, m_env, S.g_n_re[j]);
  if (S.dn_im) S.dn_im[j] = merges_bwd(S, m_em, m_env, S.g_n_im[j]);
  if (S.em_rows) {
    // _slot_color: the table's row where no ref's slot is the ray's
    float cur = em_share(S, m_em, m_env, S.g_add[j]);
    const int slot = S.mat_slot[i];
    for (int r = S.em_refs - 1; r >= 0; --r)
      if (slot == S.em_ref_slot[r]) cur = 0.0f;
    S.em_rows[j] = cur;
  }
}

// ray i's uv gradient and light-intensity rows
// TAPS: where a texture takes a gradient (S.taps), its taps' rows too
template <bool TAPS>
__device__ __forceinline__ void start_bwd_ray(const StartBwd& S, long long i) {
  const int type = S.mat_type[i], slot = S.mat_slot[i];
  const bool m_em = S.em && type == MAT_EMISSIVE, m_env = S.env && type == MAT_ENV;
  const float u = S.uv[2 * i], v = S.uv[2 * i + 1];
  float g[3];
  for (int k = 0; k < 3; ++k) g[k] = S.g_add[3 * i + k];
  constexpr bool taps = TAPS;
  const int em_planes = taps && S.em ? tap_planes_total(S.em_ref_tex, S.em_refs) : 0;
  if (S.duv || (taps && S.em)) {
    // _slot_color's wheres, last ref first: a ref takes the gradient where
    // its slot is the ray's and no later ref's is; each bilinear ref's
    // fetch hands uv its two selects' full rows, v's then u's
    float cur[3], gc[3], gu = 0.0f, gv = 0.0f, a0 = 0.0f, a1 = 0.0f;
    bool has = false;
    int plane = em_planes;
    for (int k = 0; k < 3; ++k) cur[k] = em_share(S, m_em, m_env, g[k]);
    for (int r = S.em_refs - 1; r >= 0; --r) {
      const bool m = slot == S.em_ref_slot[r];
      for (int k = 0; k < 3; ++k) {
        gc[k] = m ? cur[k] : 0.0f;
        cur[k] = m ? 0.0f : cur[k];
      }
      if (taps) {
        plane -= tap_planes(S.em_ref_tex, r);
        tap_rows(S.em_ref_tex, r, u, v, gc, S.taps, plane, S.n, i);
      }
      if (!S.duv || !(S.em_ref_tex.desc_i[4 * r + 3] & 2)) continue;
      bilinear_bwd(S.em_ref_tex, r, u, v, gc, &gu, &gv, Sum3());
      a0 = has ? a0 + 0.0f : 0.0f;
      a1 = has ? a1 + gv : gv;
      a0 = a0 + gu;
      a1 = a1 + 0.0f;
      has = true;
    }
    if (S.duv) {
      S.duv[2 * i] = a0;
      S.duv[2 * i + 1] = a1;
    }
  }
  if (S.li_rows || (taps && S.env)) {
    // shade_env's wheres, last slot first; a lightmap's term
    // where(depth != 0, li[..., None] * lm, 0) hands li torch.sum of its
    // gradient times the texel, and the lightmap's tap that gradient times
    // li; the display texture's tap takes the slot's gradient
    float cur[3], gc[3];
    for (int k = 0; k < 3; ++k) cur[k] = m_env ? g[k] : 0.0f;
    const bool beyond = S.depth[i] != 0;    // past the camera's bounce
    int plane = em_planes;
    for (int e = 0; e < S.env_slots; ++e) plane += S.env_lm_row[e] < 0 ? 1 : 2;
    for (int e = S.env_slots - 1; e >= 0; --e) {
      const bool m = slot == S.env_slot[e];
      for (int k = 0; k < 3; ++k) {
        gc[k] = m ? cur[k] : 0.0f;
        cur[k] = m ? 0.0f : cur[k];
      }
      const int row = S.env_lm_row[e];
      if (taps) {
        plane -= row < 0 ? 1 : 2;
        tap_rows(S.env_disp, e, u, v, gc, S.taps, plane, S.n, i);
      }
      if (row < 0) continue;
      float gl[3];
      for (int k = 0; k < 3; ++k) gl[k] = beyond ? gc[k] : 0.0f;
      if (taps) {
        const float li = S.env_li[clip_slot(slot, S.env_rows)];
        float t[3];
        for (int k = 0; k < 3; ++k) t[k] = gl[k] * li;
        tap_rows(S.env_lm, e, u, v, t, S.taps, plane + 1, S.n, i);
      }
      if (!S.li_rows) continue;
      float lm[3];
      fetch_texture(S.env_lm, e, u, v, lm);
      S.li_rows[(long long)row * S.n + i] = tsum3(gl[0] * lm[0], gl[1] * lm[1],
                                                  gl[2] * lm[2]);
    }
  }
}

// TAPS: the instance that also writes the textures' taps' rows
template <bool TAPS>
__global__ void __launch_bounds__(TAIL_BLOCK)
bounce_start_bwd_kernel(StartBwd S) {
  by_tiles<false>(
      S.n,
      [&](long long i, int) {
        if (TAPS || S.duv || S.li_rows) start_bwd_ray<TAPS>(S, i);
      },
      [&](long long i, int k, int) { start_bwd_element(S, i, k); });
}

// The card's SMs and a kernel's resident blocks an SM.
template <class F>
cudaError_t residency(F kernel, int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, TAIL_BLOCK, 0);
  return err;
}

// A grid of at most the card's resident blocks (the threads loop over the
// rays), at least one block, no more than the rays need.
template <class F>
cudaError_t grid_for(F kernel, long long n, int* grid) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = residency(kernel, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const long long need = (n + TAIL_BLOCK - 1) / TAIL_BLOCK;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(need < 1 ? 1 : (need < most ? need : most));
  return cudaSuccess;
}

bool textures_ok(const Textures& T) {
  return T.desc_i == nullptr || (T.texels && T.desc_f);
}

bool start_ok(const Start& S) {
  return S.n >= 1 && S.packed && S.P && S.D && S.n_re && S.n_im
         && (S.re_step == 0 || S.re_step == 3) && (S.im_step == 0 || S.im_step == 3)
         && (!S.emissive || (S.em_color && S.em_rows >= 1 && S.uv && textures_ok(S.em_tex)))
         && (!S.env || (S.env_tex.desc_i && textures_ok(S.env_tex) && textures_ok(S.env_lm)
                        && S.env_li && S.env_rows >= 1 && S.uv && S.depth))
         && S.add && S.beta_mult && S.new_origin && S.new_dir && S.new_n_re && S.new_n_im
         && S.cont && S.is_diffuse && S.did_split;
}

bool update_ok(const Update& U) {
  return U.n >= 1 && U.L && U.beta && U.alive && U.miss && U.add && U.beta_mult
         && U.new_origin && U.new_dir && U.new_n_re && U.new_n_im && U.cont
         && U.is_diffuse && U.did_split && U.O && U.D && U.n_re && U.n_im
         && (U.re_step == 0 || U.re_step == 3) && (U.im_step == 0 || U.im_step == 3)
         && U.depth && U.diffuse_refl && U.split_cnt && U.L_out && U.beta_out
         && U.alive_out && U.O_out && U.D_out && U.n_re_out && U.n_im_out
         && U.depth_out && U.diffuse_out && U.split_out
         && (!U.traced || (U.traced_out && U.scratch));
}

bool update_bwd_ok(const UpdateBwd& B) {
  // each wanted gradient has the output gradient it comes from
  return B.n >= 1 && B.beta && B.add && B.beta_mult && B.alive && B.miss && B.cont
         && (!B.dL || B.gL) && (!B.dadd || B.gL) && (!B.dbeta_mult || B.gbeta)
         && (!B.dbeta || B.gL || B.gbeta) && (!(B.dnew_origin || B.dO) || B.gO)
         && (!(B.dnew_dir || B.dD) || B.gD) && (!(B.dnew_n_re || B.dn_re) || B.gn_re)
         && (!(B.dnew_n_im || B.dn_im) || B.gn_im);
}

bool start_bwd_ok(const StartBwd& S) {
  return S.n >= 1 && S.mat_type && S.mat_slot && (!S.dP || S.g_origin)
         && (!S.dD || S.g_dir) && (!S.dn_re || S.g_n_re) && (!S.dn_im || S.g_n_im)
         && (!(S.duv || S.em_rows || S.li_rows) || S.g_add)
         && (!S.duv || (S.em && S.uv && S.em_refs >= 1 && S.em_ref_slot
                        && S.em_ref_tex.desc_i && textures_ok(S.em_ref_tex)))
         && (!S.em_rows || S.em) && S.em_refs >= 0 && (!S.em_refs || S.em_ref_slot)
         && (!S.li_rows || (S.env && S.uv && S.depth && S.env_slots >= 1 && S.env_slot
                            && S.env_lm_row && S.env_lm.desc_i && textures_ok(S.env_lm)))
         && (!S.taps.rows
             || (S.g_add && S.taps.idx && S.uv && (S.em || S.env)
                 && (!S.em || !S.em_refs || (S.em_ref_tex.desc_i && textures_ok(S.em_ref_tex)))
                 && (!S.env || (S.depth && S.env_slots >= 1 && S.env_slot && S.env_lm_row
                                && S.env_disp.desc_i && textures_ok(S.env_disp)
                                && textures_ok(S.env_lm) && S.env_li && S.env_rows >= 1))));
}

template <class F>
int info_of(F kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = residency(kernel, &out[3], &out[2]);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[4] = TAIL_BLOCK;
  return 0;
}

}  // namespace w6

using namespace w6;

// The merged output of the bounce S (ops/bounce_tail.py builds it), one
// launch.  Returns 0 or a CUDA error, and sets *launched to the kernels
// launched.
extern "C" int bounce_start(const Start* S, void* stream, int* launched) {
  *launched = 0;
  if (!start_ok(*S)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_for(bounce_start_kernel, S->n, &grid);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(bounce_start_kernel, grid, TAIL_BLOCK, 0, static_cast<cudaStream_t>(stream),
         *S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// The next carry of the bounce U (ops/bounce_tail.py builds it), one
// launch.  Returns 0 or a CUDA error, and sets *launched to the kernels
// launched.
extern "C" int bounce_update(const Update* U, void* stream, int* launched) {
  *launched = 0;
  if (!update_ok(*U)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_for(bounce_update_kernel, U->n, &grid);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(bounce_update_kernel, grid, TAIL_BLOCK, 0, static_cast<cudaStream_t>(stream),
         *U);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// The gradients of the update's float inputs from those of its outputs
// (B; ops/bounce_tail.py builds it), one launch.  Returns 0 or a CUDA
// error, and sets *launched to the kernels launched.
extern "C" int bounce_update_bwd(const UpdateBwd* B, void* stream, int* launched) {
  *launched = 0;
  if (!update_bwd_ok(*B)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_for(bounce_update_bwd_kernel, B->n, &grid);
  if (err != cudaSuccess) return (int)err;
  LAUNCH(bounce_update_bwd_kernel, grid, TAIL_BLOCK, 0,
         static_cast<cudaStream_t>(stream), *B);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// The gradients of the start's ray inputs and its tables' per-ray rows
// from those of its merged output (S; ops/bounce_tail.py builds it), one
// launch.  Returns 0 or a CUDA error, and sets *launched likewise.
extern "C" int bounce_start_bwd(const StartBwd* S, void* stream, int* launched) {
  *launched = 0;
  if (!start_bwd_ok(*S)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool taps = S->taps.rows != nullptr;
  int grid = 0;
  cudaError_t err = taps ? grid_for(bounce_start_bwd_kernel<true>, S->n, &grid)
                         : grid_for(bounce_start_bwd_kernel<false>, S->n, &grid);
  if (err != cudaSuccess) return (int)err;
  if (taps) LAUNCH(bounce_start_bwd_kernel<true>, grid, TAIL_BLOCK, 0, st, *S);
  else LAUNCH(bounce_start_bwd_kernel<false>, grid, TAIL_BLOCK, 0, st, *S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// What a kernel was built to (which: 0 the start, 1 the update, 2 the
// start's backward, 3 the update's, 4 the start backward's TAPS
// instance): out[0]
// registers a thread, out[1] local memory a thread (bytes: spills and
// stack), out[2] resident blocks an SM, out[3] the SMs, out[4] TAIL_BLOCK.
extern "C" int bounce_tail_info(int which, int* out) {
  if (which == 0) return info_of(bounce_start_kernel, out);
  if (which == 1) return info_of(bounce_update_kernel, out);
  if (which == 2) return info_of(bounce_start_bwd_kernel<false>, out);
  if (which == 3) return info_of(bounce_update_bwd_kernel, out);
  if (which == 4) return info_of(bounce_start_bwd_kernel<true>, out);
  return (int)cudaErrorInvalidValue;
}
